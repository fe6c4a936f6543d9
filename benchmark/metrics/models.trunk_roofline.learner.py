"""Share of its roofline that the conv trunk reaches in the updates
alone: the least time of the trunk's layers in the profiled stretch's
updates (per update the online and the target network's forwards over
the window and the burn-in and the online window's backward) over the
device time of every operation launched inside the program's
``model.trunk`` and ``model.trunk_bwd`` spans under the root
``optimize``; ``models.trunk_roofline`` counts the collection's too."""
import dataclasses

UNIT = "%"
LAYER = "models: trunk"
MOVES = "learner_update_ms"
SOURCE = "device_trace"
SPANS = ("model.trunk", "model.trunk_bwd")


def read(ctx):
    import progtrace
    import work
    import work_conv
    import work_resnet
    device_s = progtrace.device_s(getattr(ctx, "span_device_s", {}), SPANS,
                                  root="optimize")
    trunk_calls = {work.Geometry: work_conv.trunk_calls,
                   work_resnet.Geometry: work_resnet.trunk_calls}.get(
                       type(getattr(ctx, "geometry", None)))
    if device_s <= 0 or trunk_calls is None:
        return None
    updates = dataclasses.replace(ctx.iteration, T=0)
    bound_s = sum(work.bound_s(w) for call in trunk_calls(
        ctx.geometry, updates) for _, w in call)
    return 100 * ctx.profiled_iterations * bound_s / device_s
