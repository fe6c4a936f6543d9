"""The port's host farms (rlpyt_tpu_torch/envs/host.py, envs/hostfarm_c.py,
envs/gym_space.py, csrc/hostfarm.c) against the JAX package's: the twins
of tests/test_host_env.py:10-81 and :128, tests/test_hostfarm_c.py,
tests/test_host_spawn.py, tests/test_alternating.py:19-91 and
tests/test_dict_obs.py:81 (the twin of tests/test_host_env.py:128 is in
tests/test_torch_host_runner.py).

Tolerances: farm against serial farm, C barrier against Event barrier,
and the port's serial farm against the JAX package's are equal bit for
bit; alternating collection equals lock-step collection bit for bit, Q
values within 1e-5.
"""
import functools
import os

import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from rlpyt_tpu.envs.gym_space import convert_gym_space as jax_convert  # noqa: E402
from rlpyt_tpu.envs.host import SerialVecEnv as JaxSerialVecEnv  # noqa: E402
from rlpyt_tpu_torch.envs import hostfarm_c  # noqa: E402
from rlpyt_tpu_torch.envs.atari import make_atari_env  # noqa: E402
from rlpyt_tpu_torch.envs.gym_space import convert_gym_space  # noqa: E402
from rlpyt_tpu_torch.envs.host import (  # noqa: E402
    GymEnv,
    PairedVecEnv,
    SerialVecEnv,
    SharedMemVecEnv,
)
from rlpyt_tpu_torch.spaces import Composite, FloatBox, IntBox  # noqa: E402

torch.set_num_threads(2)

needs_c = pytest.mark.skipif(
    hostfarm_c.get_lib() is None,
    reason="hostfarm C library unavailable (no cc / not linux)")


def assert_equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_equal_trees(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal_trees(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def run(vec, n_steps, rng_seed=0, n_actions=2):
    """Reset and step ``vec`` with seeded random actions; the copied
    outputs of every step, info channels included.  Closes ``vec``."""
    rng = np.random.RandomState(rng_seed)
    try:
        trace = [tree_copy(vec.reset())]
        for _ in range(n_steps):
            a = rng.randint(0, n_actions, size=vec.B).astype(np.int64)
            out = vec.step(a)
            trace.append(tuple(tree_copy(x) for x in out)
                         + ({k: np.array(v) for k, v in
                             getattr(vec, "info", {}).items()},))
    finally:
        vec.close()
    return trace


def tree_copy(x):
    if isinstance(x, dict):
        return {k: tree_copy(v) for k, v in x.items()}
    return np.array(x)


def test_space_conversion():
    import gymnasium.spaces as gs
    cases = [gs.Discrete(4), gs.Box(low=-1.0, high=1.0, shape=(3,)),
             gs.Dict({"a": gs.Discrete(2), "b": gs.Box(-1, 1, (2,))}),
             gs.Box(0, 255, (2, 3), dtype=np.uint8),
             gs.Tuple((gs.Discrete(3), gs.Box(-2, 2, (1,)))),
             gs.MultiDiscrete([3, 5])]
    for space in cases:
        port, ref = convert_gym_space(space), jax_convert(space)
        assert type(port).__name__ == type(ref).__name__
        if isinstance(port, Composite):
            assert list(port.spaces) == list(ref.spaces)
        else:
            assert port.shape == tuple(ref.shape)
            if isinstance(port, IntBox):
                assert (port.low, port.high) == (ref.low, ref.high)
            else:
                np.testing.assert_array_equal(port.low, ref.low)
                np.testing.assert_array_equal(port.high, ref.high)
    s = convert_gym_space(gs.Discrete(4))
    assert isinstance(s, IntBox) and s.n == 4
    assert isinstance(convert_gym_space(cases[1]), FloatBox)
    assert convert_gym_space(cases[3]).dtype == torch.uint8


def test_gym_env_contract():
    env = GymEnv("CartPole-v1")
    obs = env.reset(seed=0)
    assert obs.shape == (4,)
    obs, rew, terminated, truncated = env.step(1)
    assert isinstance(rew, float) and isinstance(terminated, bool)
    env.close()


def test_serial_vec_env_matches_jax():
    port = run(SerialVecEnv(["CartPole-v1"] * 4, seed=0), 50)
    ref = run(JaxSerialVecEnv(["CartPole-v1"] * 4, seed=0), 50)
    assert port[0].shape == (4, 4) and port[-1][1].shape == (4,)
    for a, b in zip(port, ref):
        assert_equal_trees(a, b)


def test_shared_mem_vec_env_matches_serial():
    """A forked farm (the factories are closures of this module, so they
    are handed over by fork) equals the serial farm."""
    fns = [lambda: GymEnv("CartPole-v1") for _ in range(4)]
    farm = SharedMemVecEnv(fns, n_workers=2, seed=7)
    assert farm.start_method == "fork"
    for a, b in zip(run(SerialVecEnv(fns, seed=7), 100), run(farm, 100)):
        assert_equal_trees(a, b)


def test_timeout_flag():
    """A TimeLimit truncation is a timeout: Pendulum ends only by it."""
    vec = SerialVecEnv([lambda: GymEnv("Pendulum-v1")], seed=1)
    vec.reset()
    for i in range(200):
        obs, rew, done, timeout = vec.step(np.zeros((1, 1), np.float32))
        if done[0]:
            assert timeout[0]
            break
    assert done[0] and i == 199
    vec.close()


# -- the C barrier (tests/test_hostfarm_c.py) --------------------------


def make_farm(sync, B=4, W=2, seed=7):
    return SharedMemVecEnv(["CartPole-v1"] * B, n_workers=W, seed=seed,
                           sync=sync)


@needs_c
def test_c_sync_selected_and_steps():
    farm = make_farm("c")
    try:
        assert farm.sync_impl == "c" and farm.start_method == "spawn"
        obs = farm.reset()
        assert obs.shape == (4, 4)
        for _ in range(20):
            obs, rew, done, timeout = farm.step(np.zeros(4, np.int64))
        assert np.isfinite(obs).all()
    finally:
        farm.close()


@needs_c
def test_c_and_event_paths_identical():
    t_c = run(make_farm("c"), 50)
    t_e = run(make_farm("events"), 50)
    for a, b in zip(t_c, t_e):
        assert_equal_trees(a, b)


@needs_c
def test_barrier_many_rounds():
    """No lost wakeups over many rounds."""
    farm = make_farm("c", B=8, W=4)
    try:
        farm.reset()
        for i in range(300):
            farm.step(np.full(8, i % 2, dtype=np.int64))
    finally:
        farm.close()


@needs_c
def test_c_library_built_into_the_package():
    lib = hostfarm_c.build()
    assert lib.parent == hostfarm_c.BUILD_DIR and lib.exists()
    assert hostfarm_c.BUILD_DIR.parent.name == "csrc"


# -- spawn after the runtime is up (tests/test_host_spawn.py) ----------


def test_spawn_farm_matches_serial():
    """Gym ids pickle, so the farm spawns; spawned after torch ran."""
    _ = torch.zeros(3) + 1
    farm = SharedMemVecEnv(["CartPole-v1"] * 4, n_workers=2, seed=11)
    assert farm.start_method == "spawn"
    serial = run(SerialVecEnv(["CartPole-v1"] * 4, seed=11), 60, 5)
    for a, b in zip(serial, run(farm, 60, 5)):
        assert_equal_trees(a, b)


def test_atari_factories_spawn():
    """A functools.partial of envs/atari.py:make_atari_env pickles: the
    farm spawns its workers (safe with CUDA up)."""
    fns = [functools.partial(
        make_atari_env, ale_factory="rlpyt_tpu_torch.envs.fake_ale:FakeALE",
        seed=b) for b in range(2)]
    farm = SharedMemVecEnv(fns, n_workers=2, seed=0, sync="events")
    try:
        assert farm.start_method == "spawn"
        assert farm.reset().shape == (2, 4, 104, 80)
    finally:
        farm.close()


def test_dead_worker_raises_not_hangs():
    """A worker that dies during startup raises at construction instead
    of deadlocking the barrier."""
    parent = os.getpid()

    def bad_env():
        if os.getpid() != parent:
            raise RuntimeError("boom in worker init")
        return GymEnv("CartPole-v1")

    with pytest.raises(RuntimeError, match="died during startup"):
        SharedMemVecEnv([bad_env] * 2, n_workers=2, seed=0)


# -- dict observations (tests/test_dict_obs.py:81) ---------------------


def _make_dict_cartpole():
    from gymnasium import spaces as gs

    class DictObsWrapper(gym.ObservationWrapper):
        def __init__(self, env):
            super().__init__(env)
            lo, hi = env.observation_space.low, env.observation_space.high
            self.observation_space = gs.Dict({
                "position": gs.Box(lo[[0, 2]], hi[[0, 2]],
                                   dtype=np.float32),
                "velocity": gs.Box(lo[[1, 3]], hi[[1, 3]],
                                   dtype=np.float32)})

        def observation(self, obs):
            return {"position": obs[[0, 2]].astype(np.float32),
                    "velocity": obs[[1, 3]].astype(np.float32)}

    return DictObsWrapper(gym.make("CartPole-v1"))


def test_host_dict_obs_serial_vs_farm():
    """Dict observations through both farms (a shared block per leaf),
    bit for bit, and equal to the JAX package's serial farm."""
    fns = [_make_dict_cartpole for _ in range(4)]
    serial = run(SerialVecEnv(fns, seed=7), 60)
    farm = run(SharedMemVecEnv(fns, n_workers=2, seed=7), 60)
    ref = run(JaxSerialVecEnv(fns, seed=7), 60)
    assert set(serial[0]) == {"position", "velocity"}
    for a, b, c in zip(serial, farm, ref):
        assert_equal_trees(a, b)
        assert_equal_trees(a, c)


# -- alternating halves (tests/test_alternating.py:19-91) --------------


def _paired(env_id, b_half, seed=0):
    return PairedVecEnv(SerialVecEnv([env_id] * b_half, seed=seed),
                        SerialVecEnv([env_id] * b_half, seed=seed + 100))


def test_paired_vec_env_lockstep_fallback():
    farm = _paired("CartPole-v1", 2)
    try:
        obs = farm.reset()
        assert obs.shape[0] == 4
        obs, rew, done, to = farm.step(np.zeros((4,), np.int64))
        assert obs.shape[0] == rew.shape[0] == done.shape[0] == 4
    finally:
        farm.close()


def test_alternating_collection_schema_and_learning():
    from rlpyt_tpu_torch.agents.pg import GaussianPgAgent
    from rlpyt_tpu_torch.algos.pg import PPO
    from rlpyt_tpu_torch.runners.host import HostMinibatchRl

    farm = _paired("InvertedPendulum-v5", 2)
    try:
        agent = GaussianPgAgent(model_kwargs=dict(hidden_sizes=(32,)),
                                device="cpu")
        algo = PPO(minibatches=2, epochs=1)
        runner = HostMinibatchRl(algo=algo, agent=agent, vec_env=farm,
                                 batch_T=16, n_steps=128, seed=0,
                                 device="cpu")
        runner.startup()
        samples, rollout_state = runner._collect_batch()
        assert samples.observation.shape[:2] == (16, 4)
        assert samples.action.shape[:2] == (16, 4)
        assert samples.agent_info["dist_info"].mean.shape == (16, 4, 1)
        assert rollout_state.observation.shape[0] == 4
        last_rew = samples.reward[-1].numpy()
        last_done = samples.done[-1].numpy()
        pr = rollout_state.prev_reward.numpy()
        np.testing.assert_allclose(pr[~last_done], last_rew[~last_done])
        info = algo.optimize(samples, rollout_state)
        assert np.isfinite(float(info.loss))
    finally:
        farm.close()


def test_alternating_recurrent_two_carry_banks():
    """A recurrent agent under alternation keeps one carry bank per
    half, reset per lane on done; PPO optimizes the batch."""
    from rlpyt_tpu_torch.agents.pg import RecurrentGaussianPgAgent
    from rlpyt_tpu_torch.algos.pg import PPO
    from rlpyt_tpu_torch.runners.host import HostMinibatchRl

    farm = _paired("Pendulum-v1", 2)
    try:
        agent = RecurrentGaussianPgAgent(
            lstm_size=16, model_kwargs=dict(hidden_sizes=(32,)),
            device="cpu")
        algo = PPO(minibatches=2, epochs=1)
        runner = HostMinibatchRl(algo=algo, agent=agent, vec_env=farm,
                                 batch_T=8, n_steps=64, seed=0,
                                 device="cpu")
        runner.startup()
        assert len(runner._alt_carry) == 2
        samples, rollout_state = runner._collect_batch()
        for leaf in rollout_state.agent_carry:
            assert leaf.shape[0] == 4
        info = algo.optimize(samples, rollout_state)
        assert np.isfinite(float(info.loss))
    finally:
        farm.close()


def test_alternating_env_info_schema_matches_serial():
    """Alternating collection forwards every farm info key into
    Samples.env_info, as the lock-step path does."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.runners.host import HostMinibatchRl

    def fake_env(seed=0):
        return functools.partial(
            make_atari_env,
            ale_factory="rlpyt_tpu_torch.envs.fake_ale:FakeALE", seed=seed,
            max_start_noops=0, repeat_action_probability=0.0)

    tiny_model = dict(channels=(8,), kernel_sizes=(8,), strides=(8,),
                      paddings=(0,), fc_sizes=(32,))

    def collect(vec):
        agent = DqnAgent(model_kwargs=tiny_model, device="cpu")
        algo = DQN(min_steps_learn=10_000, replay_size=4_096,
                   batch_size=32, frame_buffer=True)
        runner = HostMinibatchRl(algo=algo, agent=agent, vec_env=vec,
                                 batch_T=8, n_steps=32, seed=0,
                                 device="cpu")
        runner.startup()
        return runner._collect_batch()[0]

    serial_vec = SerialVecEnv([fake_env(b) for b in range(4)], seed=0)
    paired_vec = PairedVecEnv(
        SerialVecEnv([fake_env(b) for b in range(2)], seed=0),
        SerialVecEnv([fake_env(2 + b) for b in range(2)], seed=100))
    try:
        s_serial = collect(serial_vec)
        s_alt = collect(paired_vec)
        assert set(s_serial.env_info) == set(s_alt.env_info)
        assert {"timeout", "game_score", "traj_done"} <= set(s_alt.env_info)
        for k in s_serial.env_info:
            assert s_alt.env_info[k].shape == s_serial.env_info[k].shape
            assert s_alt.env_info[k].dtype == s_serial.env_info[k].dtype
    finally:
        serial_vec.close()
        paired_vec.close()


def test_alternating_equals_lockstep_collection():
    """Under greedy actions, alternating collection over a paired farm
    gives the batches that lock-step collection over one serial farm of
    the same envs and seeds gives: observations, actions, rewards, dones,
    prev actions and rewards and every info equal, Q within 1e-5."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.runners.host import HostMinibatchRl

    fns = [functools.partial(
        make_atari_env, ale_factory="rlpyt_tpu_torch.envs.fake_ale:FakeALE",
        seed=b, max_start_noops=2, repeat_action_probability=0.25)
        for b in range(4)]

    def collect(vec):
        agent = DqnAgent(model_kwargs=dict(
            channels=(8,), kernel_sizes=(8,), strides=(8,), paddings=(0,),
            fc_sizes=(32,)), eps_init=0.0, eps_final=0.0, device="cpu")
        runner = HostMinibatchRl(
            algo=DQN(min_steps_learn=10_000, replay_size=4_096,
                     frame_buffer=True),
            agent=agent, vec_env=vec, batch_T=8, n_steps=32, seed=0,
            device="cpu")
        try:
            runner.startup()
            return [runner._collect_batch() for _ in range(3)]
        finally:
            vec.close()

    # Serial lane b resets with seed 0 + b; the halves with 0 + b, 2 + b.
    alt = collect(PairedVecEnv(SerialVecEnv(fns[:2], seed=0),
                               SerialVecEnv(fns[2:], seed=2)))
    lock = collect(SerialVecEnv(fns, seed=0))
    assert any(bool(s.done.any()) for s, _ in lock)
    for (a, ra), (b, rb) in zip(alt, lock):
        for f in ("observation", "action", "reward", "done", "prev_action",
                  "prev_reward"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert set(a.env_info) == set(b.env_info)
        for k in a.env_info:
            assert torch.equal(a.env_info[k], b.env_info[k]), k
        torch.testing.assert_close(a.agent_info["q"], b.agent_info["q"],
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(ra.observation, rb.observation)
        assert ra.cum_steps == rb.cum_steps
