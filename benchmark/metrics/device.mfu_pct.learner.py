"""The learner's share of the chip's fp32 peak (67 TFLOP/s outside the
tensor cores, the precision the configurations state): the model
products the updates of an iteration require (``work.iteration_flops``
without the collection: the online and target forwards and the online
backward of each update, no recomputation) times the plain stretch's
iterations, over the learner's seconds there (each optimize on the
device's clock, as ``learner_update_ms`` takes them) at that peak."""
import dataclasses

UNIT = "%"
LAYER = "whole step"
MOVES = "learner_update_ms"
SOURCE = "device_trace"


def read(ctx):
    if ctx.plain_learner_s <= 0 or ctx.busy_s <= 0:
        return None
    w = ctx.work
    updates = dataclasses.replace(ctx.iteration, T=0)
    flops = w.iteration_flops(ctx.geometry, updates)
    return 100 * flops * ctx.plain_iterations / (ctx.plain_learner_s
                                                  * w.FP32_PEAK)
