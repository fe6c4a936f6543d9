"""Host milliseconds of one collection batch (median of the spanned
stretch's batches, the device synchronized at each batch's end): the
collector, ``samplers/rollout.py:Collector.collect`` on the device path,
``runners/host.py:HostMinibatchRl._collect_batch`` on the host farm."""
UNIT = "ms"
LAYER = "samplers: collector"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    s = ctx.median_s(ctx.spans.get("collect", []))
    return None if s is None else 1e3 * s
