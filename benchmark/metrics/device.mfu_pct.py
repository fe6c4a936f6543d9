"""The whole step's share of the chip's fp32 peak (67 TFLOP/s outside
the tensor cores, the precision the configurations state): the model
products an iteration requires (``work.iteration_flops``: the
collection's forward steps, the online and target forwards and the
online backward of each update, no recomputation) times the plain
stretch's iterations, over its wall time at that peak."""
UNIT = "%"
LAYER = "whole step"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.plain_wall_s <= 0 or ctx.busy_s <= 0:
        return None
    w = ctx.work
    flops = w.iteration_flops(ctx.geometry, ctx.iteration)
    return 100 * flops * ctx.plain_iterations / (ctx.plain_wall_s
                                                  * w.FP32_PEAK)
