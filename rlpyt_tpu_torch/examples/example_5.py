"""Example 5: pipelined training with checkpoints: R2D1 on MinAtar
Breakout under AsyncRl (torch form of examples/example_5.py).

    python -m rlpyt_tpu_torch.examples.example_5

The run's whole state is saved in a temporary directory, which is
printed; a fresh runner goes on from it, bit for bit, with
``build_runner(...).train(resume_from=<dir>/checkpoint.pkl)``.
"""
import tempfile

from rlpyt_tpu_torch.agents.dqn import R2d1Agent
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.minatar import Breakout
from rlpyt_tpu_torch.models.dqn import AtariR2d1Model
from rlpyt_tpu_torch.runners.async_rl import AsyncRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec


def build_runner(n_steps=1_000_000, seed=0, device="cuda",
                 checkpoint_dir=None, runner_cls=AsyncRl,
                 log_interval_steps=50_000, min_steps_learn=5_000,
                 **runner_kwargs):
    """The example's runner; ``runner_cls`` MinibatchRl runs the same
    training unpipelined, and ``runner_kwargs`` go to the runner."""
    agent = R2d1Agent(
        ModelCls=AtariR2d1Model,
        model_kwargs=dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                          paddings=(0,), obs_divisor=1.0, lstm_size=128),
        lstm_size=128, eps_steps=100_000, eps_final=0.1, device=device)
    algo = R2D1(discount=0.997, batch_b=32, batch_T=40, warmup_T=20,
                min_steps_learn=min_steps_learn, replay_size=200_000,
                replay_ratio=1.0, target_update_interval=1_000,
                n_step_return=5, learning_rate=1e-4)
    return runner_cls(algo=algo, agent=agent, env=Breakout(device=device),
                      batch_spec=BatchSpec(T=40, B=32), n_steps=n_steps,
                      seed=seed, log_interval_steps=log_interval_steps,
                      checkpoint_dir=checkpoint_dir, device=device,
                      **runner_kwargs)


def build_and_train(n_steps=1_000_000, seed=0, device="cuda"):
    """Train with a checkpoint in a new temporary directory; returns
    (runner, the run's final state_dict())."""
    ckpt = tempfile.mkdtemp(prefix="rlpyt_tpu_torch_ck_")
    runner = build_runner(n_steps, seed, device, checkpoint_dir=ckpt,
                          updates_per_interval=None, pipeline_depth=2)
    state = runner.train()
    print(f"checkpoint (the run's whole state, bitwise resume): {ckpt}")
    return runner, state


if __name__ == "__main__":
    build_and_train()
