"""Host milliseconds of one step of the host farm
(``envs/host.py:SharedMemVecEnv.step``: the actions out, every worker's
envs stepped, the barrier), median of the spanned stretch's steps."""
UNIT = "ms"
LAYER = "envs: host farm"
MOVES = "env_steps_per_s"
SOURCE = "host_clock"
WORKLOADS = ["atari_r2d1_resnet.farm32"]


def read(ctx):
    s = ctx.median_s(ctx.spans.get("farm_step", []))
    return None if s is None else 1e3 * s
