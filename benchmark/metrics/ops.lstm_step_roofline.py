"""Share of its roofline that the collection's one-step LSTM calls
reach: the least time of their work (``work.lstm_step`` at the
collection's (B, H, F), one call a collection step) over the device time
of every operation launched inside the program's ``ops.lstm_step`` spans
under the root ``collect``, in the profiled stretch."""
UNIT = "%"
LAYER = "ops: kernels"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    import progtrace
    device_s = progtrace.device_s(getattr(ctx, "span_device_s", {}),
                                  ["ops.lstm_step"], root="collect")
    if device_s <= 0:
        return None
    w = ctx.work
    calls = w.collect_lstm_calls(ctx.geometry, ctx.iteration)
    return 100 * ctx.profiled_iterations * w.calls_bound_s(calls) / device_s
