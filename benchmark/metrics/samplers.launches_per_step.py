"""Device operations (kernels, copies, sets) launched inside the
program's ``collect`` span, per collection step, in the profiled
stretch: what the host enqueues for one step of the collector, read from
the trace by ``progtrace.attribute``."""
UNIT = "ops"
LAYER = "samplers: collector"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    ops = getattr(ctx, "program_ops", None)
    if ops is None or not ops.by_root.get("collect"):
        return None
    return ops.by_root["collect"] / (ctx.profiled_iterations
                                     * ctx.iteration.T)
