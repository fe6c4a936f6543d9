"""The torch forms of examples 1-9 (the twins of tests/test_examples.py):
each imports and names its entry point; example 1 trains at a tiny
budget on the CPU, and example 4 at dp = 2 (two spawned ranks over
gloo); example 5's AsyncRl run equals its MinibatchRl run and resumes
bit for bit on the CPU at a small depth; example 6 points the launcher
at the port's script."""
import importlib
import os

import pytest
import torch
from test_torch_checkpoint import assert_states_equal

from rlpyt_tpu_torch.runners.train import MinibatchRl

torch.set_num_threads(2)
EXAMPLES = (1, 2, 3, 4, 5, 6, 7, 8, 9)


@pytest.mark.parametrize("n", EXAMPLES)
def test_example_imports(n):
    mod = importlib.import_module(f"rlpyt_tpu_torch.examples.example_{n}")
    assert hasattr(mod, "build_and_train") or hasattr(mod, "main")


def test_example_1_trains(tmp_path):
    from rlpyt_tpu_torch.examples import example_1

    runner, state = example_1.build_and_train(n_steps=4_096,
                                              log_dir=str(tmp_path),
                                              device="cpu")
    assert runner.algo.update_counter > 0
    assert state["algo"]["update_counter"] == runner.algo.update_counter
    assert (tmp_path / "run_0" / "progress.csv").exists()


def test_example_4_trains_at_dp2_on_the_cpu():
    """Example 4's DQN config at 64 lanes over two ranks: each collects
    32 lanes, learning starts in the second iteration."""
    from rlpyt_tpu_torch.examples import example_4
    from rlpyt_tpu_torch.parallel.mesh import MeshSpec
    from rlpyt_tpu_torch.runners.sync import SyncRl

    runner = example_4.build_and_train(
        n_steps=3 * 2_048, log_interval_steps=2_048, mesh=MeshSpec(dp=2),
        device="cpu", config_overrides=dict(
            algo=dict(min_steps_learn=4_096, replay_size=20_000),
            sampler=dict(eval_n_envs=0, max_decorrelation_steps=10)))
    assert isinstance(runner, SyncRl) and runner.dp == 2
    assert runner.rollout_state.observation.shape[0] == 32
    assert runner.rollout_state.cum_steps == 3 * 2_048
    assert runner.algo.update_counter == 2 * 64


def test_example_5_async_and_resume_on_the_cpu(tmp_path):
    """Example 5 at its widths for 4 intervals of one iteration (learning
    from the fourth): AsyncRl equals MinibatchRl, and a resume from the
    checkpoint of a 2-interval run equals the uninterrupted run."""
    from rlpyt_tpu_torch.examples import example_5

    kw = dict(device="cpu", log_interval_steps=1_280, min_steps_learn=3_840)
    sync = example_5.build_runner(5_120, runner_cls=MinibatchRl,
                                  max_decorrelation_steps=10, **kw)
    sync_state = sync.train()
    assert sync.algo.update_counter == 2
    full = example_5.build_runner(5_120, max_decorrelation_steps=10,
                                  **kw).train()
    assert_states_equal(full, sync_state)
    example_5.build_runner(2_560, checkpoint_dir=str(tmp_path),
                           max_decorrelation_steps=10, **kw).train()
    resumed = example_5.build_runner(5_120, max_decorrelation_steps=10,
                                     **kw).train(
        resume_from=str(tmp_path / "checkpoint.pkl"))
    assert_states_equal(resumed, full)


def test_example_6_points_at_the_port_script(monkeypatch):
    from rlpyt_tpu_torch.examples import example_6

    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return [0] * len(kw["variants"])

    monkeypatch.setattr(example_6, "run_experiments", fake_run)
    assert example_6.main() == [0] * 6
    script = os.path.realpath(seen["script"])
    assert script.endswith(os.path.join(
        "rlpyt_tpu_torch", "experiments", "scripts", "minatar_dqn.py"))
    assert os.path.exists(script)
    assert seen["common_args"] == ("dqn",)
