"""Example 6: a variant sweep with the local launcher: three learning
rates by two MinAtar games of the DQN config, one run at a time (torch
form of examples/example_6.py).

    python -m rlpyt_tpu_torch.examples.example_6

Each run is ``rlpyt_tpu_torch/experiments/scripts/minatar_dqn.py`` in a
process of its own, on the card; logs go under
``data/minatar_dqn_lr_sweep/``.  With several cards, pass ``n_slots``
and one ``CUDA_VISIBLE_DEVICES`` a slot in ``slot_envs``.
"""
import os

from rlpyt_tpu_torch.utils.launching import run_experiments
from rlpyt_tpu_torch.utils.variant import VariantLevel, make_variants

SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      os.pardir, "experiments", "scripts", "minatar_dqn.py")


def main(n_slots=1, slot_envs=None):
    lr_level = VariantLevel(
        keys=[("algo", "learning_rate")],
        values=[[1e-4], [3e-4], [1e-3]],
        dir_names=["lr1e-4", "lr3e-4", "lr1e-3"])
    game_level = VariantLevel(
        keys=[("env", "game"), ("eval_env", "game")],
        values=[["breakout"] * 2, ["space_invaders"] * 2],
        dir_names=["breakout", "space_invaders"])
    variants, log_dirs = make_variants(lr_level, game_level)
    return run_experiments(
        script=os.path.abspath(SCRIPT),
        experiment_title="minatar_dqn_lr_sweep",
        variants=variants,
        log_dirs=log_dirs,
        runs_per_setting=1,
        common_args=("dqn",),
        n_slots=n_slots,
        slot_envs=slot_envs,
    )


if __name__ == "__main__":
    main()
