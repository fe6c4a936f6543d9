"""Share of its roofline that the updates' LSTM work reaches: the least
time of each update's LSTM calls (``work.update_lstm_calls``: the
burn-in and window forwards of the online and the target network and
the online window's backward) over the device time of every operation
launched inside those calls and inside that backward, in the profiled
stretch."""
UNIT = "%"
LAYER = "ops: kernels"
MOVES = "env_steps_per_s"
SOURCE = "device_trace"


def read(ctx):
    device_s = (ctx.range_device_s.get("bench.lstm_train", 0.0)
                + ctx.range_device_s.get("bench.lstm_bwd", 0.0))
    if device_s <= 0:
        return None
    w = ctx.work
    calls = w.update_lstm_calls(ctx.geometry, ctx.iteration)
    updates = ctx.profiled_iterations * ctx.updates_per_optimize
    return 100 * updates * w.calls_bound_s(calls) / device_s
