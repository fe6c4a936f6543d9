"""Device operations launched inside the program's ``optimize`` span,
per update, in the profiled stretch (the replay's append counted in with
the updates it feeds)."""
UNIT = "ops"
LAYER = "algos: algorithm"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    ops = getattr(ctx, "program_ops", None)
    if ops is None or not ops.by_root.get("optimize"):
        return None
    return ops.by_root["optimize"] / (ctx.profiled_iterations
                                      * ctx.updates_per_optimize)
