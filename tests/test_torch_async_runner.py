"""The port's AsyncRl (the twins of tests/test_async_runner.py), on the
CPU: bitwise equality with MinibatchRl, the update throttle, dispatch of
interval k+1 before interval k is logged, evaluation against each
interval's own parameters, and the checkpoint cadence."""
import os

import pytest
import torch
from test_torch_checkpoint import RowLogger, assert_rows_equal, \
    assert_states_equal

import rlpyt_tpu_torch.runners.train as train_mod
from rlpyt_tpu_torch.agents.dqn import DqnAgent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.classic import CartPole
from rlpyt_tpu_torch.models.dqn import DqnMlpModel
from rlpyt_tpu_torch.runners.async_rl import AsyncRl, AsyncRlEval
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)


def make(runner_cls, **kw):
    """tests/test_async_runner.py:14's runner."""
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(32,)),
                     eps_steps=2_000, device="cpu")
    algo = DQN(batch_size=32, min_steps_learn=128, replay_size=4_096,
               replay_ratio=1.0, target_update_interval=50,
               learning_rate=1e-3)
    return runner_cls(algo=algo, agent=agent, env=CartPole(device="cpu"),
                      batch_spec=BatchSpec(T=16, B=8), n_steps=2_048,
                      seed=2, log_interval_steps=512,
                      max_decorrelation_steps=0, device="cpu", **kw)


@pytest.mark.parametrize("eval_env", [False, True])
def test_async_matches_sync_math(eval_env):
    """Pipelining changes scheduling, not semantics: the whole state and
    the logged rows (time columns aside) equal MinibatchRl's."""
    kw = (dict(eval_env=CartPole(device="cpu"), eval_n_envs=4,
               eval_max_steps=64, eval_max_trajectories=4)
          if eval_env else {})
    log1, log2 = RowLogger(), RowLogger()
    s1 = make(MinibatchRl, logger=log1, **kw).train()
    s2 = make(AsyncRl, pipeline_depth=2, logger=log2, **kw).train()
    assert_states_equal(s2, s1)
    assert_rows_equal(log2.rows, log1.rows)
    assert len(log1.rows) == 4


def test_async_update_throttle():
    """updates_per_interval overrides the replay-ratio arithmetic."""
    runner = make(AsyncRl, updates_per_interval=64)
    runner.train()
    assert runner.algo.updates_per_optimize == 64 // runner.itrs_per_interval
    # 16 iterations, the first (128 steps) already at min_steps_learn.
    assert runner.algo.update_counter == 16 * (64 // 4)


def test_async_pipeline_dispatch_before_drain():
    """With pipeline_depth=2 the runner dispatches interval k+1 before it
    reads interval k's diagnostics."""
    runner = make(AsyncRl, pipeline_depth=2)
    events = []
    run_interval, log = runner.run_interval, runner._log_diagnostics

    def spy_interval(_n=[0]):
        events.append(("dispatch", _n[0]))
        _n[0] += 1
        return run_interval()

    def spy_log(itr, *args):
        events.append(("log", itr // runner.itrs_per_interval - 1))
        return log(itr, *args)

    runner.run_interval, runner._log_diagnostics = spy_interval, spy_log
    runner.train()
    n = sum(1 for e in events if e[0] == "dispatch")
    assert n >= 4
    assert [k for (e, k) in events if e == "log"] == list(range(n))
    for k in range(n - 1):
        assert events.index(("dispatch", k + 1)) < events.index(("log", k))


def test_async_eval_param_attribution():
    """The evaluation logged with interval k ran on interval k's own
    parameters."""
    runner = make(AsyncRlEval, pipeline_depth=3,
                  eval_env=CartPole(device="cpu"), eval_n_envs=4,
                  eval_max_steps=64, eval_max_trajectories=4)
    interval_params, eval_params = [], []
    run_interval, run_eval = runner.run_interval, runner.run_eval

    def probe():
        return next(runner.agent.model.parameters()).detach().clone()

    def spy_interval():
        out = run_interval()
        interval_params.append(probe())
        return out

    def spy_eval():
        eval_params.append(probe())
        return run_eval()

    runner.run_interval, runner.run_eval = spy_interval, spy_eval
    runner.train()
    assert len(eval_params) == len(interval_params) >= 4
    for k, (ip, ep) in enumerate(zip(interval_params, eval_params)):
        assert torch.equal(ip, ep), f"eval {k} used another interval's"
    # ... and the parameters did move between intervals.
    assert not torch.equal(interval_params[0], interval_params[-1])


def test_async_eval_requires_env():
    with pytest.raises(ValueError):
        make(AsyncRlEval)


def test_async_checkpoint_cadence(tmp_path, monkeypatch):
    """A checkpoint every ``checkpoint_every`` intervals plus one at the
    end, not one per interval."""
    calls = []
    save = train_mod.save_checkpoint

    def spy_save(path, state, meta):
        calls.append(dict(meta))
        return save(path, state, meta)

    monkeypatch.setattr(train_mod, "save_checkpoint", spy_save)
    runner = make(AsyncRl, pipeline_depth=2, checkpoint_every=3,
                  checkpoint_dir=str(tmp_path))
    runner.train()
    assert [c["interval"] for c in calls] == [3, 4]
    state, meta = load_checkpoint(str(tmp_path / "checkpoint.pkl"))
    assert meta["interval"] == 4 and state is not None


def test_async_resume_matches_uninterrupted(tmp_path):
    """A resume from AsyncRl's mid-run checkpoint equals the
    uninterrupted AsyncRl run."""
    full_log, first_log, resumed_log = RowLogger(), RowLogger(), RowLogger()
    full = make(AsyncRl, logger=full_log).train()
    first = make(AsyncRl, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                 logger=first_log)
    first.n_steps = 1_024
    first.train()
    resumed = make(AsyncRl, logger=resumed_log).train(
        resume_from=os.path.join(str(tmp_path), "checkpoint.pkl"))
    assert_states_equal(resumed, full)
    assert_rows_equal(first_log.rows + resumed_log.rows, full_log.rows)
