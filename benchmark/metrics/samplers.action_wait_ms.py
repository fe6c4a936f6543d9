"""The host farm's wait for the agent's actions: the median, over
collection steps, of the program's ``collect.action_wait`` span (the
action's copy to the host and the event waited on,
``runners/host.py:_land``)."""
UNIT = "ms"
LAYER = "samplers: collector"
MOVES = "env_steps_per_s"
SOURCE = "program_span"
WORKLOADS = ["atari_r2d1_resnet.farm32"]


def read(ctx):
    spans = getattr(ctx, "program_spans", None)
    if not spans:
        return None
    import progtrace
    return progtrace.span_ms(spans, "collect.action_wait")
