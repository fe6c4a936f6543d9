"""Share of the profiled stretch's wall time in which no operation ran
on the device: 100 (1 - busy / wall), busy the union of the trace's
kernels, copies and sets."""
UNIT = "%"
LAYER = "device"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.busy_s <= 0:
        return None
    return 100 * (1 - ctx.busy_s / ctx.profiled_wall_s)
