"""Synchronizing runtime and driver calls (``progtrace.SYNC_CALLS``:
stream, event or device synchronize; blocking copies) made inside the
program's spans, per iteration of the profiled stretch: each one holds
the host until the device catches up."""
UNIT = "count"
LAYER = "device"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    ops = getattr(ctx, "program_ops", None)
    if ops is None or not ops.by_root.get("collect"):
        return None
    return sum(ops.syncs.values()) / ctx.profiled_iterations
