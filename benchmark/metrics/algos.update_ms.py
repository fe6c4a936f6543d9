"""Host milliseconds of one R2D1 update: the median ``algos/r2d1.py:
R2D1.optimize`` of the spanned stretch (the batch's append and input
priorities included, the device synchronized at its end) over its
``updates_per_optimize``."""
UNIT = "ms"
LAYER = "algos: algorithm"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    s = ctx.median_s(ctx.spans.get("optimize", []))
    return None if s is None else 1e3 * s / ctx.updates_per_optimize
