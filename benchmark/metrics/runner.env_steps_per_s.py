"""The env steps of the traced run's plain stretch over its wall time,
the device synchronized at both ends: ``env_steps_per_s`` as a per-layer
metric, in the cells where the host's noise leaves it too unsteady for
an end-to-end bound (PERF.md section 2)."""
UNIT = "env-steps/s"
LAYER = "runner"
MOVES = "learner_update_ms"
SOURCE = "host_clock"


def read(ctx):
    if ctx.plain_wall_s <= 0:
        return None
    return ctx.plain_iterations * ctx.steps_per_iteration / ctx.plain_wall_s
