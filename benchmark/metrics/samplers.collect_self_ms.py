"""The collector's own host milliseconds in a batch: the median, over
the recorded batches, of the program's ``collect`` span less its
children (the agent's and the env's steps, the farm step, the action's
wait, the records and the after-step on the host farm)."""
UNIT = "ms"
LAYER = "samplers: collector"
MOVES = "env_steps_per_s"
SOURCE = "program_span"


def read(ctx):
    spans = getattr(ctx, "program_spans", None)
    if not spans:
        return None
    import progtrace
    return progtrace.collect_self_ms(spans)
