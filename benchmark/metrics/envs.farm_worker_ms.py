"""The farm's workers stepping their envs: the median, over farm steps,
of the slowest worker's ``farm.worker`` record (its own stamps, on the
master's clock)."""
UNIT = "ms"
LAYER = "envs: host farm"
MOVES = "env_steps_per_s"
SOURCE = "program_span"
WORKLOADS = ["atari_r2d1_resnet.farm32"]


def read(ctx):
    spans = getattr(ctx, "program_spans", None)
    if not spans:
        return None
    import progtrace
    return progtrace.farm_worker_ms(spans)
