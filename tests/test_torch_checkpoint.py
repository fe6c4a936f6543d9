"""Checkpoints and bitwise resume of the port (the twins of
tests/test_checkpoint.py), on the CPU at tiny sizes.

A run stopped after interval k and resumed from its checkpoint must end
equal, bit for bit, to the uninterrupted run: every tensor and number of
``runner.state_dict()`` (model, target, optimizer moments and count,
replay ring, cursors and priorities, the collector's state, the
generators) and every logged row apart from the time columns.  DQN runs
at the JAX test's settings; DQN with prioritized flat replay, CatDQN
with prioritized frame replay, R2D1
on sequence frame replay, recurrent PPO with its linear schedule and an
evaluation, and SAC with its log alpha are stopped by an exception at the
start of their third interval, as a killed run would be.

The ``cuda``-marked tests are the same checks on a card (the flagship
DQN's frame gather; example 5's R2D1 under AsyncRl), for a machine that
has one; chip_smoke.py phase 16 runs them at full width.  They import
nothing of JAX:

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python -m pytest --noconftest -m cuda \
        tests/test_torch_checkpoint.py
"""
import os

import pytest
import torch

from rlpyt_tpu_torch.agents.dqn import CatDqnAgent, DqnAgent, R2d1Agent
from rlpyt_tpu_torch.agents.qpg import SacAgent
from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.algos.qpg import SAC
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.classic import CartPole, Pendulum
from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
from rlpyt_tpu_torch.experiments.scripts import minatar_pg
from rlpyt_tpu_torch.models.dqn import DqnMlpModel
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.utils.checkpoint import load_checkpoint, \
    save_checkpoint
from rlpyt_tpu_torch.utils.logging import TabularLogger

torch.set_num_threads(2)

TIME_KEYS = ("CumTime (s)", "StepsPerSecond", "UpdatesPerSecond")


class RowLogger(TabularLogger):
    """Keeps each logged row instead of printing it."""

    def __init__(self):
        super().__init__(None)
        self.rows = []

    def dump_tabular(self, print_fn=print):
        self.rows.append(dict(self._tabular))
        super().dump_tabular(print_fn=None)


def leaves(tree, path=""):
    """(path, leaf) of every tensor and Python value in a state tree."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from leaves(x, f"{path}/{i}")
    else:
        yield path, tree


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                                b.reshape(-1).contiguous().view(torch.uint8)))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


def assert_states_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    bad = [k for k in want if not same_bits(got[k], want[k])]
    assert not bad, f"{len(bad)} of {len(want)} leaves differ: {bad[:8]}"


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k not in TIME_KEYS:
                assert same_bits(g[k], w[k]), (k, g[k], w[k])


def make_dqn(n_steps, checkpoint_dir=None, logger=None):
    """tests/test_checkpoint.py:14's runner."""
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(32,)),
                     eps_steps=2_000, device="cpu")
    algo = DQN(batch_size=32, min_steps_learn=128, replay_size=4_096,
               replay_ratio=1.0, target_update_interval=50,
               learning_rate=1e-3)
    return MinibatchRl(algo=algo, agent=agent, env=CartPole(device="cpu"),
                       batch_spec=BatchSpec(T=16, B=8), n_steps=n_steps,
                       seed=9, log_interval_steps=512,
                       max_decorrelation_steps=0, logger=logger,
                       checkpoint_dir=checkpoint_dir, device="cpu")


def test_save_load_roundtrip(tmp_path):
    """Every leaf of a trained runner's state survives save and load."""
    runner = make_dqn(512)
    state = runner.train()
    p = str(tmp_path / "ck.pkl")
    save_checkpoint(p, state, {"interval": 1})
    restored, meta = load_checkpoint(p, like=runner.state_dict())
    assert meta == {"interval": 1}
    assert_states_equal(restored, state)
    assert not list(tmp_path.glob("*.tmp"))


def test_bitwise_deterministic_resume(tmp_path):
    full_log = RowLogger()
    full = make_dqn(2_048, logger=full_log).train()
    ck_dir = str(tmp_path / "ck")
    first_log = RowLogger()
    make_dqn(1_024, checkpoint_dir=ck_dir, logger=first_log).train()
    resumed_log = RowLogger()
    resumed = make_dqn(2_048, logger=resumed_log).train(
        resume_from=os.path.join(ck_dir, "checkpoint.pkl"))
    assert_states_equal(resumed, full)
    assert_rows_equal(first_log.rows + resumed_log.rows, full_log.rows)


# --- the other algorithms, stopped at the start of their third interval --

def make_catdqn(n_steps, checkpoint_dir, logger):
    agent = CatDqnAgent(model_kwargs=dict(channels=(4, 4, 4), fc_sizes=(16,),
                                          dueling=True),
                        n_atoms=11, eps_steps=200, device="cpu")
    algo = CategoricalDQN(batch_size=8, min_steps_learn=24, replay_size=480,
                          frame_buffer=True, replay_ratio=1.0,
                          double_dqn=True, prioritized_replay=True,
                          pri_alpha=0.5, pri_beta=0.4, n_step_return=3,
                          target_update_interval=2)
    return MinibatchRl(algo, agent, SyntheticAtariEnv("cpu"),
                       BatchSpec(8, 3), n_steps=n_steps, seed=3,
                       log_interval_steps=24, max_decorrelation_steps=0,
                       logger=logger, checkpoint_dir=checkpoint_dir,
                       device="cpu")


def make_dqn_prioritized(n_steps, checkpoint_dir, logger):
    """Flat prioritized replay with n-step returns, whose |TD| errors pass
    1 early, so the largest priority (new rows' priority) moves."""
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(16,)),
                     eps_steps=500, device="cpu")
    algo = DQN(batch_size=16, min_steps_learn=32, replay_size=1_024,
               replay_ratio=1.0, target_update_interval=4,
               learning_rate=1e-3, prioritized_replay=True, n_step_return=3)
    return MinibatchRl(algo=algo, agent=agent, env=CartPole(device="cpu"),
                       batch_spec=BatchSpec(T=8, B=4), n_steps=n_steps,
                       seed=7, log_interval_steps=64,
                       max_decorrelation_steps=0, logger=logger,
                       checkpoint_dir=checkpoint_dir, device="cpu")


def make_r2d1(n_steps, checkpoint_dir, logger):
    agent = R2d1Agent(model_kwargs=dict(channels=(4, 4, 4), fc_sizes=(16,),
                                        lstm_size=8),
                      eps_steps=200, device="cpu")
    algo = R2D1(batch_b=4, batch_T=8, warmup_T=4, n_step_return=2,
                min_steps_learn=48, replay_size=192, frame_compress=True,
                target_update_interval=2)
    return MinibatchRl(algo, agent, SyntheticAtariEnv("cpu"),
                       BatchSpec(8, 3), n_steps=n_steps, seed=4,
                       log_interval_steps=48, max_decorrelation_steps=0,
                       logger=logger, checkpoint_dir=checkpoint_dir,
                       device="cpu")


def make_lstm_ppo(n_steps, checkpoint_dir, logger):
    runner, _ = minatar_pg.build_runner("lstm_ppo", seed=5, device="cpu",
                                        config_overrides={
        "model": {"channels": (4,), "fc_sizes": (16,), "lstm_size": 8},
        "runner": {"n_steps": n_steps, "log_interval_steps": 64},
        "sampler": {"batch_T": 8, "batch_B": 8, "eval_n_envs": 4,
                    "eval_max_steps": 64, "eval_max_trajectories": 3,
                    "max_decorrelation_steps": 10}})
    runner.logger, runner.checkpoint_dir = logger, checkpoint_dir
    assert runner.algo.linear_lr_schedule
    return runner


def make_sac(n_steps, checkpoint_dir, logger):
    agent = SacAgent(model_kwargs=dict(hidden_sizes=(16, 16)),
                     q_model_kwargs=dict(hidden_sizes=(16, 16)),
                     device="cpu")
    algo = SAC(batch_size=16, min_steps_learn=32, replay_size=512,
               replay_ratio=2.0)
    return MinibatchRl(algo, agent, Pendulum(device="cpu"), BatchSpec(8, 4),
                       n_steps=n_steps, seed=6, log_interval_steps=32,
                       max_decorrelation_steps=5, logger=logger,
                       checkpoint_dir=checkpoint_dir, device="cpu")


class Stop(Exception):
    pass


def stop_before_interval(runner, k):
    """Make ``runner`` raise at the start of its interval ``k`` (from 0),
    as a run killed there would stop."""
    run_interval, calls = runner.run_interval, []

    def wrapped():
        if len(calls) == k:
            raise Stop
        calls.append(1)
        return run_interval()

    runner.run_interval = wrapped


MAKERS = {"dqn_prioritized_flat": (make_dqn_prioritized, 4 * 64),
          "catdqn_prioritized_frames": (make_catdqn, 4 * 24),
          "r2d1_sequence_frames": (make_r2d1, 4 * 48),
          "lstm_ppo_linear_schedule": (make_lstm_ppo, 4 * 64),
          "sac": (make_sac, 4 * 32)}


@pytest.mark.parametrize("name", list(MAKERS))
def test_stopped_run_resumes_bit_for_bit(name, tmp_path):
    make, n_steps = MAKERS[name]
    full_log = RowLogger()
    full = make(n_steps, None, full_log).train()
    ck_dir = str(tmp_path / "ck")
    first_log = RowLogger()
    stopped = make(n_steps, ck_dir, first_log)
    stop_before_interval(stopped, 2)
    with pytest.raises(Stop):
        stopped.train()
    assert len(first_log.rows) == 2
    resumed_log = RowLogger()
    resumed = make(n_steps, None, resumed_log).train(
        resume_from=os.path.join(ck_dir, "checkpoint.pkl"))
    assert_states_equal(resumed, full)
    assert_rows_equal(first_log.rows + resumed_log.rows, full_log.rows)
    # The run learned: its update counter moved after the resume.
    assert full["algo"]["update_counter"] > 0
    if name == "dqn_prioritized_flat":
        assert float(full["algo"]["replay"]["max_priority"]) > 1.0


def test_checkpoint_places_tensors_on_like_devices(tmp_path):
    """Without ``like`` every tensor loads on the CPU; with ``like`` each
    goes to its counterpart's device (CPU to CPU here; the card's twin is
    below)."""
    runner = make_dqn(512)
    state = runner.train()
    p = str(tmp_path / "ck.pkl")
    save_checkpoint(p, state, {"interval": 1})
    plain, _ = load_checkpoint(p)
    placed, _ = load_checkpoint(p, like=state)
    for (_, a), (_, b), (_, ref) in zip(leaves(plain), leaves(placed),
                                        leaves(state)):
        if isinstance(ref, torch.Tensor):
            assert a.device.type == "cpu"
            assert b.device == ref.device


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def deterministic(card, monkeypatch):
    """Deterministic algorithms for one test; cuBLAS needs a fixed
    workspace for them (set before its first call in the process, as
    the README's command does)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield card
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_card_checkpoint_loads_on_the_cpu(card, tmp_path):
    """A checkpoint written from the card loads on the CPU, and back onto
    the card with ``like``."""
    state = {"x": torch.arange(6., device=card),
             "g": torch.Generator(device=card).manual_seed(1).get_state()}
    p = str(tmp_path / "ck.pkl")
    save_checkpoint(p, state)
    cpu, _ = load_checkpoint(p)
    assert cpu["x"].device.type == "cpu"
    back, _ = load_checkpoint(p, like=state)
    assert back["x"].device == state["x"].device
    assert torch.equal(back["x"], state["x"])


@pytest.mark.cuda
def test_flagship_dqn_resumes_on_the_card(deterministic, tmp_path):
    """Phase 16a's check at a small depth: the flagship DQN on the card,
    stopped after 2 of 4 intervals and resumed, bit for bit."""
    card = deterministic

    def make(n_itr, ck=None, logger=None):
        agent = DqnAgent(model_kwargs=dict(compute_dtype=torch.bfloat16),
                         eps_steps=250_000, eps_final=0.01, device=card)
        algo = DQN(batch_size=256, min_steps_learn=0, replay_size=20_000,
                   replay_ratio=8.0, target_update_interval=2_500,
                   learning_rate=2.5e-4, double_dqn=True, frame_buffer=True)
        return MinibatchRl(algo, agent, SyntheticAtariEnv(card),
                           BatchSpec(32, 128), n_steps=n_itr * 4096,
                           log_interval_steps=4096,
                           max_decorrelation_steps=0, logger=logger,
                           checkpoint_dir=ck, device=card)

    full_log, first_log, resumed_log = RowLogger(), RowLogger(), RowLogger()
    full = make(4, logger=full_log).train()
    make(2, str(tmp_path), first_log).train()
    resumed = make(4, logger=resumed_log).train(
        resume_from=str(tmp_path / "checkpoint.pkl"))
    assert_states_equal(resumed, full)
    assert_rows_equal(first_log.rows + resumed_log.rows, full_log.rows)


@pytest.mark.cuda
def test_example_5_async_resume_on_the_card(deterministic, tmp_path):
    """Phase 16b's check: example 5 (R2D1, K3a/K3/K4) under AsyncRl
    equals MinibatchRl bit for bit, and a resume from the mid-run
    checkpoint equals the uninterrupted run."""
    from rlpyt_tpu_torch.examples import example_5

    kw = dict(device=deterministic, log_interval_steps=2_560)
    sync = example_5.build_runner(10_240, runner_cls=MinibatchRl,
                                  **kw).train()
    full = example_5.build_runner(10_240, **kw).train()
    assert_states_equal(full, sync)
    example_5.build_runner(5_120, checkpoint_dir=str(tmp_path), **kw).train()
    resumed = example_5.build_runner(10_240, **kw).train(
        resume_from=str(tmp_path / "checkpoint.pkl"))
    assert_states_equal(resumed, full)
