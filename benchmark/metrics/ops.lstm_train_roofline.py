"""Share of its roofline that the updates' LSTM work reaches: the least
time of each update's LSTM calls (``work.update_lstm_calls``: the
burn-in and window forwards of the online and the target network and
the online window's backward) over the device time of every operation
launched inside the program's ``ops.input_proj``, ``ops.lstm_fwd`` and
``ops.lstm_bwd`` spans under the root ``optimize``, in the profiled
stretch."""
UNIT = "%"
LAYER = "ops: kernels"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"
SPANS = ("ops.input_proj", "ops.lstm_fwd", "ops.lstm_bwd")


def read(ctx):
    import progtrace
    device_s = progtrace.device_s(getattr(ctx, "span_device_s", {}), SPANS,
                                  root="optimize")
    if device_s <= 0:
        return None
    w = ctx.work
    calls = w.update_lstm_calls(ctx.geometry, ctx.iteration)
    updates = ctx.profiled_iterations * ctx.updates_per_optimize
    return 100 * updates * w.calls_bound_s(calls) / device_s
