"""The port's AtariEnv on FakeALE (rlpyt_tpu_torch/envs/atari.py,
envs/fake_ale.py) against the JAX package's: the twins of the twelve
tests of tests/test_atari.py that need no ale_py, each driving the port's
env and the JAX package's with the same seeds and actions and holding
every output bit for bit (observations, rewards, terminated, truncated,
info, the emulator's effective actions) before checking the property the
JAX test checks.  Tolerance: none; everything is equal."""
import functools

import numpy as np
import pytest

from rlpyt_tpu.envs.atari import AtariEnv as JaxAtariEnv
from rlpyt_tpu.envs.fake_ale import FakeALE as JaxFakeALE
from rlpyt_tpu.envs.host import SerialVecEnv as JaxSerialVecEnv
from rlpyt_tpu_torch.envs.atari import H, W, AtariEnv, make_atari_env
from rlpyt_tpu_torch.envs.fake_ale import FakeALE
from rlpyt_tpu_torch.envs.host import SerialVecEnv, SharedMemVecEnv

FAKE_KEYS = ("n_actions", "start_lives", "life_len", "reward_action",
             "reward_period")


def make_pair(seed=0, noops=0, rap=0.0, fake_cls=(FakeALE, JaxFakeALE),
              **kw):
    """(port env, JAX env) with the same settings and seeds."""
    fake_kw = {k: kw.pop(k) for k in list(kw) if k in FAKE_KEYS}
    return tuple(
        Env(ale_factory=lambda F=F: F(**fake_kw), seed=seed,
            max_start_noops=noops, repeat_action_probability=rap, **kw)
        for Env, F in ((AtariEnv, fake_cls[0]), (JaxAtariEnv, fake_cls[1])))


def assert_same(a, b):
    """Two outputs of reset or step equal, leaf by leaf, with the same
    types."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def reset_both(pair, **kw):
    out = [env.reset(**kw) for env in pair]
    assert_same(*out)
    return out[0]


def step_both(pair, action):
    out = [env.step(action) for env in pair]
    assert_same(*out)
    assert pair[0].ale.act_log == pair[1].ale.act_log
    return out[0]


@pytest.mark.parametrize("settings", [
    dict(seed=0, noops=30, rap=0.25),
    dict(seed=3, noops=4, rap=0.5, fire_on_reset=True),
    dict(seed=7, noops=0, rap=0.0, episodic_lives=False, clip_reward=False),
    dict(seed=11, noops=8, rap=0.25, horizon=17, start_lives=99,
         life_len=10_000),
], ids=["default", "fire", "no_lives_no_clip", "horizon"])
def test_env_matches_jax_over_hundreds_of_steps(settings):
    """Three hundred steps of random actions with a hard reset (reseeded)
    on every traj_done, as the farms do."""
    pair = make_pair(**settings)
    reset_both(pair)
    rng = np.random.RandomState(settings["seed"])
    n_traj = 0
    for i in range(300):
        _, _, _, _, info = step_both(pair, int(rng.randint(0, 4)))
        if info["traj_done"]:
            n_traj += 1
            reset_both(pair, seed=1000 + i)
    assert n_traj >= 5


def test_fake_ale_matches_jax():
    """The scripted emulator alone: screens, rewards, lives, game_over
    and sticky actions from one seed."""
    port, ref = FakeALE(life_len=5), JaxFakeALE(life_len=5)
    for ale in (port, ref):
        ale.setInt("random_seed", 9)
        ale.setFloat("repeat_action_probability", 0.3)
        ale.reset_game()
    rng = np.random.RandomState(2)
    screens = [np.zeros((210, 160), np.uint8) for _ in range(2)]
    for _ in range(60):
        a = int(rng.randint(0, 4))
        assert port.act(a) == ref.act(a)
        assert (port.lives(), port.game_over()) == (ref.lives(),
                                                    ref.game_over())
        port.getScreenGrayscale(screens[0])
        ref.getScreenGrayscale(screens[1])
        np.testing.assert_array_equal(*screens)
        if port.game_over():
            port.reset_game()
            ref.reset_game()
    assert port.act_log == ref.act_log


def test_obs_shape_dtype_and_reset_stack():
    pair = make_pair()
    obs = reset_both(pair)
    assert obs.shape == (4, H, W) and obs.dtype == np.uint8
    assert (obs[:3] == 0).all()
    assert pair[0].spaces.action.n == 4


def test_frame_skip_max_pool_ordering():
    """The max is over the screens after act frame_skip-1 and after act
    frame_skip."""

    def scripted(Base):
        class ScriptedScreens(Base):
            def getScreenGrayscale(self, out):
                out[:] = 200 if self._frame == 3 else 10
        return ScriptedScreens

    pair = make_pair(fake_cls=(scripted(FakeALE), scripted(JaxFakeALE)))
    reset_both(pair)
    obs, *_ = step_both(pair, 0)
    assert (obs[-1] == 200).all()
    assert (obs[-2] != 200).any()


def test_frame_stack_rolls():
    pair = make_pair()
    reset_both(pair)
    o1, *_ = step_both(pair, 1)
    o2, *_ = step_both(pair, 2)
    np.testing.assert_array_equal(o2[-2], o1[-1])
    assert (o2[-1] != o2[-2]).any()


def test_episodic_lives_done_vs_traj_done():
    """A life loss is done without traj_done, the emulator goes on and
    the stack is zeroed; game over is traj_done."""
    pair = make_pair(start_lives=3, life_len=12)
    reset_both(pair)
    seen_life_loss = False
    for step_i in range(1, 40):
        obs, rew, terminated, truncated, info = step_both(pair, 0)
        if (terminated or truncated) and not info["traj_done"]:
            seen_life_loss = True
            assert (obs[:3] == 0).all()
            assert pair[0].ale.lives() == 3 - (step_i // 3)
        if info["traj_done"]:
            assert terminated and pair[0].ale.game_over()
            break
    assert seen_life_loss and info["traj_done"]


def test_no_episodic_lives_flag():
    pair = make_pair(start_lives=2, life_len=8, episodic_lives=False)
    reset_both(pair)
    dones = []
    for _ in range(10):
        _, _, terminated, truncated, info = step_both(pair, 0)
        dones.append(terminated or truncated)
        if info["traj_done"]:
            break
    assert sum(dones) == 1 and info["traj_done"]


def test_horizon_truncation():
    pair = make_pair(start_lives=99, life_len=10_000, horizon=5)
    reset_both(pair)
    for t in range(5):
        _, _, terminated, truncated, info = step_both(pair, 0)
        if t < 4:
            assert not terminated and not truncated
    assert truncated and not terminated and info["traj_done"]


def test_clip_reward_and_game_score():
    pair = make_pair(reward_action=1, reward_period=1)
    reset_both(pair)
    _, rew, _, _, info = step_both(pair, 1)
    assert info["game_score"] == 4.0 and rew == 1.0
    pair = make_pair(reward_action=1, reward_period=1, clip_reward=False)
    reset_both(pair)
    _, rew, _, _, info = step_both(pair, 1)
    assert rew == 4.0 == info["game_score"]


def test_noop_starts_and_seed_determinism():
    a, b = make_pair(seed=123, noops=8), make_pair(seed=123, noops=8)
    np.testing.assert_array_equal(reset_both(a), reset_both(b))
    assert 0 <= a[0].ale._frame <= 8
    assert a[0].ale._frame == a[1].ale._frame
    c = make_pair(seed=7, noops=8)
    reset_both(c)
    assert c[0].ale._frame <= 8


def test_sticky_actions_deterministic_given_seed():
    acts = [0, 1, 2, 3, 1, 2, 0, 3] * 4
    logs = []
    for _ in range(2):
        pair = make_pair(seed=42, rap=0.5, start_lives=99, life_len=10_000)
        reset_both(pair)
        for a in acts:
            step_both(pair, a)
        logs.append(list(pair[0].ale.act_log))
    assert logs[0] == logs[1]
    requested = [a for a in acts for _ in range(4)]
    assert logs[0][-len(requested):] != requested


def _port_fake(seed=0):
    return functools.partial(
        make_atari_env, ale_factory="rlpyt_tpu_torch.envs.fake_ale:FakeALE",
        seed=seed, max_start_noops=4, repeat_action_probability=0.25)


def _jax_fake(seed=0):
    return JaxAtariEnv(ale_factory=JaxFakeALE, seed=seed, max_start_noops=4,
                       repeat_action_probability=0.25)


def farm_trace(farm, n_steps, rng_seed, n_actions=4):
    rng = np.random.RandomState(rng_seed)
    trace = [np.array(farm.reset())]
    for _ in range(n_steps):
        acts = rng.randint(0, n_actions, size=(farm.B,))
        obs, rew, done, to = farm.step(acts)
        trace.append((np.array(obs), np.array(rew), np.array(done),
                      np.array(to),
                      {k: np.array(v) for k, v in farm.info.items()}))
    farm.close()
    return trace


def assert_traces_equal(t1, t2):
    np.testing.assert_array_equal(t1[0], t2[0])
    for (o1, r1, d1, to1, i1), (o2, r2, d2, to2, i2) in zip(t1[1:], t2[1:]):
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(to1, to2)
        assert set(i1) == set(i2) == {"game_score", "traj_done"}
        for k in i1:
            np.testing.assert_array_equal(i1[k], i2[k])


def test_fixed_seed_trajectory_equality_serial_farm():
    """The same seed gives the same trajectories through SerialVecEnv,
    and they are the JAX package's."""
    runs = [farm_trace(SerialVecEnv([_port_fake()] * 3, seed=11), 30, 0)
            for _ in range(2)]
    assert_traces_equal(*runs)
    assert_traces_equal(runs[0], farm_trace(
        JaxSerialVecEnv([_jax_fake] * 3, seed=11), 30, 0))


def test_farm_no_hard_reset_on_life_loss():
    """The farm resets an env only on traj_done: across a life-loss done
    the emulator's frame counter keeps advancing."""
    farm = SerialVecEnv(
        [lambda: AtariEnv(ale_factory=lambda: FakeALE(life_len=12), seed=0,
                          max_start_noops=0, repeat_action_probability=0.0)],
        seed=0)
    farm.reset()
    env = farm.envs[0]
    frames = []
    for _ in range(6):
        farm.step(np.zeros(1, np.int64))
        frames.append(env.ale._frame)
    assert all(b > a for a, b in zip(frames, frames[1:]))
    farm.close()


def test_shared_mem_farm_matches_serial():
    """SharedMemVecEnv (spawned workers: the factories pickle) of
    AtariEnv(FakeALE) equals the serial farm, info channels included, and
    both equal the JAX package's serial farm."""
    serial = farm_trace(SerialVecEnv([_port_fake(b) for b in range(4)],
                                     seed=5), 25, 1)
    farm = SharedMemVecEnv([_port_fake(b) for b in range(4)], seed=5,
                           n_workers=2)
    assert farm.start_method == "spawn"
    assert_traces_equal(serial, farm_trace(farm, 25, 1))
    assert_traces_equal(serial, farm_trace(JaxSerialVecEnv(
        [functools.partial(_jax_fake, b) for b in range(4)], seed=5), 25, 1))
