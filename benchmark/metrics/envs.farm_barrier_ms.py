"""The farm step beyond its slowest worker: the median, over farm steps,
of ``farm.step`` less that step's slowest ``farm.worker`` (the
barrier's signal, wake-ups and post, and the master's write of the
actions)."""
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
    return progtrace.farm_barrier_ms(spans)
