"""Share of its roofline that the model's conv trunk reaches: the least
time of the trunk's layers in the profiled stretch's iterations (the
collection's forward a step; per update the online and the target
network's forwards over the window and the burn-in and the online
window's backward: ``work_conv.trunk_calls`` for the Nature CNN,
``work_resnet.trunk_calls`` for IMPALA's residual trunk) over the device
time of every operation launched inside the program's ``model.trunk``
and ``model.trunk_bwd`` spans, in collection and updates alike.  On a
graphed update those spans are replays of CUDA graph pieces that also
assemble the LSTM's input (PERF.md section 3 gives the share of their
device time that is not the trunk's)."""
UNIT = "%"
LAYER = "models: trunk"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
WORKLOADS = ["atari_r2d1_resnet.farm32"]
SPANS = ("model.trunk", "model.trunk_bwd")


def read(ctx):
    import progtrace
    import work
    import work_conv
    import work_resnet
    device_s = progtrace.device_s(getattr(ctx, "span_device_s", {}), SPANS)
    trunk_calls = {work.Geometry: work_conv.trunk_calls,
                   work_resnet.Geometry: work_resnet.trunk_calls}.get(
                       type(getattr(ctx, "geometry", None)))
    if device_s <= 0 or trunk_calls is None:
        return None
    bound_s = sum(work.bound_s(w) for call in trunk_calls(
        ctx.geometry, ctx.iteration) for _, w in call)
    return 100 * ctx.profiled_iterations * bound_s / device_s
