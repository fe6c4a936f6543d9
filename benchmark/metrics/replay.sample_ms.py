"""Host milliseconds of one draw from the sequence replay
(``replay/sequence.py``: the prioritized draw and the window's
extraction), median of the spanned stretch's draws, the device
synchronized at each draw's end."""
UNIT = "ms"
LAYER = "replay: sequence replay"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"


def read(ctx):
    s = ctx.median_s(ctx.spans.get("replay_sample", []))
    return None if s is None else 1e3 * s
