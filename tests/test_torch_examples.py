"""The torch forms of examples 1, 2, 3, 5, 6 and 8 (the twins of
tests/test_examples.py): each imports and names its entry point;
example 1 trains at a tiny budget on the CPU; example 5's AsyncRl run
equals its MinibatchRl run and resumes bit for bit on the CPU at a
small depth; example 6 points the launcher at the port's script."""
import importlib
import os

import pytest
import torch
from test_torch_checkpoint import assert_states_equal

from rlpyt_tpu_torch.runners.train import MinibatchRl

torch.set_num_threads(2)
EXAMPLES = (1, 2, 3, 5, 6, 8)


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
