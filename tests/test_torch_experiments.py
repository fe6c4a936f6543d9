"""The port's experiment surface against the JAX package, on the CPU: the
MinAtar DQN configs, variants, the launcher, seeding, parameter snapshots,
and ``experiments/scripts/minatar_dqn.py:build_and_train`` for four of its
configs at small budgets.

Tolerances: configs, variants, file names and seeded draws equal; a
snapshot written by the port, loaded into the JAX model, gives the port
model's Q values (or C51 probabilities) to rtol 1e-5, atol 1e-5, and so
does a snapshot of a trained run the JAX package wrote, loaded into the
port's model.
"""
import copy
import json
import pickle
import random
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.experiments.configs.minatar_dqn import configs as jax_configs
from rlpyt_tpu.models.dqn import AtariCatDqnModel as JaxAtariCatDqnModel
from rlpyt_tpu.models.dqn import AtariDqnModel as JaxAtariDqnModel
from rlpyt_tpu.models.dqn import AtariR2d1Model as JaxAtariR2d1Model
from rlpyt_tpu.utils import seed as jax_seed
from rlpyt_tpu.utils.logging import TabularLogger as JaxTabularLogger
from rlpyt_tpu.utils.variant import VariantLevel as JaxVariantLevel
from rlpyt_tpu.utils.variant import make_variants as jax_make_variants
from rlpyt_tpu_torch.experiments.configs.minatar_dqn import configs
from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import (
    build_and_train,
    build_runner,
)
from rlpyt_tpu_torch.params import agent_params_to_jax, from_jax_params
from rlpyt_tpu_torch.utils import seed
from rlpyt_tpu_torch.utils.launching import run_experiments
from rlpyt_tpu_torch.utils.logging import TabularLogger
from rlpyt_tpu_torch.utils.variant import VariantLevel, make_variants

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CLOSE = dict(rtol=1e-5, atol=1e-5)


def test_configs_equal_jax():
    assert set(configs) == {"dqn", "dqn_pub", "ernbw", "ernbw_vec", "r2d1"}
    assert configs == jax_configs
    assert configs["dqn_pub"]["algo"]["optim_kwargs"] == dict(
        decay=0.95, eps=0.01, centered=True)
    # the r2d1 sampler's T is a multiple of the rnn-state store interval
    assert configs["r2d1"]["sampler"]["batch_T"] \
        % configs["r2d1"]["algo"]["warmup_T"] == 0


LEVELS = [
    [(("algo", "learning_rate"),), ((1e-3,), (5e-4,)), ("lr3", "lr5")],
    [(("env", "game"), ("eval_env", "game")),
     (("breakout", "breakout"), ("freeway", "freeway"),
      ("asterix", "asterix")), ("breakout", "freeway", "asterix")],
    [(("runner", "n_steps"),), ((100,),), ("short",)],
]


@pytest.mark.parametrize("n_levels", [1, 2, 3])
def test_make_variants_equals_jax(n_levels):
    levels = LEVELS[:n_levels]
    got = make_variants(*(VariantLevel(*lv) for lv in levels))
    want = jax_make_variants(*(JaxVariantLevel(*lv) for lv in levels))
    assert got == want
    assert len(got[0]) == int(np.prod([len(lv[2]) for lv in levels]))
    with pytest.raises(ValueError):
        make_variants(VariantLevel(levels[0][0], levels[0][1], ("one",)))


STUB = textwrap.dedent("""
    import json, os, sys
    log_dir, run_id = sys.argv[1], sys.argv[2]
    with open(os.path.join(log_dir, "variant.json")) as f:
        variant = json.load(f)
    with open(os.path.join(log_dir, f"done_{run_id}.json"), "w") as f:
        json.dump({"lr": variant["algo"]["lr"], "extra": sys.argv[3],
                   "cuda": os.environ.get("CUDA_VISIBLE_DEVICES")}, f)
""")


@pytest.mark.parametrize("pinned", [False, True])
def test_run_experiments_slots(tmp_path, pinned):
    """The twin of tests/test_launching.py:10 with a stub script: two
    variants, two runs each, over two slots; pinned, each run sees its
    slot's CUDA_VISIBLE_DEVICES."""
    script = tmp_path / "train_stub.py"
    script.write_text(STUB)
    variants, log_dirs = make_variants(VariantLevel(
        keys=[("algo", "lr")], values=[[1e-3], [1e-4]],
        dir_names=["lr3", "lr4"]))
    slot_envs = ([{"CUDA_VISIBLE_DEVICES": str(i)} for i in range(2)]
                 if pinned else None)
    results = run_experiments(
        script=str(script), experiment_title="stub", variants=variants,
        log_dirs=log_dirs, runs_per_setting=2, common_args=("argA",),
        n_slots=2, root_log_dir=str(tmp_path / "data"),
        slot_envs=slot_envs, poll_s=0.1)
    assert results == [0, 0, 0, 0]
    seen = set()
    for vdir, lr in [("lr3", 1e-3), ("lr4", 1e-4)]:
        d = tmp_path / "data" / "stub" / vdir
        for run_id in (0, 1):
            out = json.loads((d / f"done_{run_id}.json").read_text())
            assert out["lr"] == lr and out["extra"] == "argA"
            seen.add(out["cuda"])
        assert (d / "variant.json").exists()
        assert (d / "stdout_0.log").exists()
    if pinned:
        assert seen == {"0", "1"}


def test_seeding_equals_jax():
    seed.set_seed(2**33 + 5)
    got = (random.random(), np.random.random())
    jax_seed.set_seed(2**33 + 5)
    assert got == (random.random(), np.random.random())
    assert seed.worker_seed(2**31 + 3, 4) == jax_seed.worker_seed(
        2**31 + 3, 4) == 7
    assert 0 <= seed.make_seed() < 2**31


@pytest.mark.parametrize("mode, gap", [("last", 1), ("all", 1), ("gap", 2),
                                       ("none", 1)])
def test_snapshot_files_equal_jax(tmp_path, mode, gap):
    """The same save_itr_params calls write the same files with the same
    contents as the JAX logger's."""
    tree = {"params": {"Dense_0": {"kernel": np.ones((2, 3), np.float32),
                                   "bias": np.zeros(3, np.float32)}}}
    for name, Logger in (("port", TabularLogger), ("jax", JaxTabularLogger)):
        logger = Logger(str(tmp_path / name), snapshot_mode=mode,
                        snapshot_gap=gap)
        for itr in (2, 3, 4):
            logger.save_itr_params(itr, {"params": tree, "itr": itr,
                                         "cum_steps": 10 * itr})
        logger.close()
    files = sorted(p.name for p in (tmp_path / "port").glob("*.pkl"))
    assert files == sorted(p.name for p in (tmp_path / "jax").glob("*.pkl"))
    assert files == {"last": ["params.pkl"],
                     "all": ["itr_2.pkl", "itr_3.pkl", "itr_4.pkl"],
                     "gap": ["itr_2.pkl", "itr_4.pkl"], "none": []}[mode]
    for f in files:
        got, want = (pickle.loads((tmp_path / d / f).read_bytes())
                     for d in ("port", "jax"))
        assert int(got["itr"]) == int(want["itr"])
        assert int(got["cum_steps"]) == int(want["cum_steps"])
        jax.tree.map(np.testing.assert_array_equal, got["params"],
                     want["params"])


SMALL = dict(sampler=dict(batch_T=16, batch_B=8, eval_n_envs=8,
                          eval_max_steps=256, eval_max_trajectories=8),
             algo=dict(min_steps_learn=256, replay_size=8_192,
                       replay_ratio=1.0))
SMOKES = {
    "dqn": dict(runner=dict(n_steps=4_096, log_interval_steps=2_048)),
    "dqn_pub": dict(runner=dict(n_steps=2_048, log_interval_steps=1_024)),
    "ernbw": dict(runner=dict(n_steps=2_048, log_interval_steps=1_024)),
    "r2d1": dict(runner=dict(n_steps=2_048, log_interval_steps=1_024),
                 algo=dict(replay_ratio=0.5, batch_b=4, batch_T=8,
                           warmup_T=4)),
}


def jax_model(key, n_actions):
    cfg = configs[key]
    if key == "r2d1":
        return JaxAtariR2d1Model(n_actions, **cfg["model"])
    if key == "ernbw":
        return JaxAtariCatDqnModel(n_actions, n_atoms=51, **cfg["model"])
    return JaxAtariDqnModel(n_actions, **cfg["model"])


@pytest.mark.parametrize("key", list(SMOKES))
def test_script_smoke(tmp_path, key):
    """``build_and_train(key, log_dir=...)`` at the JAX script smoke's
    sizes (tests/test_experiments.py:56-107) on the CPU: the run's files,
    the Eval keys, updates that ran and finite losses; its params.pkl
    loads into the JAX model and gives the port's outputs."""
    overrides = {k: dict(SMALL.get(k, {}), **v) for k, v in
                 {**SMALL, **SMOKES[key]}.items()}
    runner = build_and_train(key, log_dir=str(tmp_path), run_id=3,
                             config_overrides=overrides, device="cpu")
    run_dir = tmp_path / "run_3"
    for name in ("progress.csv", "params.json", "debug.log", "params.pkl"):
        assert (run_dir / name).exists(), name
    rows = (run_dir / "progress.csv").read_text().strip().splitlines()
    header = rows[0].split(",")
    assert len(rows) == 3
    assert {"EvalReturnAverage", "EvalTrajs", "loss"} <= set(header)
    last = dict(zip(header, rows[-1].split(",")))
    assert np.isfinite(float(last["loss"])) and float(last["loss"]) > 0
    assert runner.algo.update_counter > 0
    cfg = json.loads((run_dir / "params.json").read_text())
    assert cfg["runner"]["n_steps"] == overrides["runner"]["n_steps"]

    snap = pickle.loads((run_dir / "params.pkl").read_bytes())
    assert int(snap["itr"]) == 2 * runner.itrs_per_interval
    assert int(snap["cum_steps"]) == overrides["runner"]["n_steps"]
    jax.tree.map(np.testing.assert_array_equal, snap["params"],
                 agent_params_to_jax(runner.agent))
    model = runner.agent.model
    obs = runner.rollout_state.observation
    n_actions = runner.agent.env_spaces.action.n
    B = obs.shape[0]
    pa = torch.arange(B) % n_actions
    pr = torch.linspace(-1, 1, B)
    jm = jax_model(key, n_actions)
    with torch.no_grad():
        if key == "r2d1":
            state = tuple(0.5 * torch.randn(B, 128) for _ in range(2))
            q, (h, c) = model(obs, pa, pr, state)
            jq, (jh, jc) = jm.apply(snap["params"], jnp.asarray(obs.numpy()),
                                    jnp.asarray(pa.numpy()),
                                    jnp.asarray(pr.numpy()),
                                    tuple(jnp.asarray(s.numpy())
                                          for s in state))
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), **CLOSE)
        else:
            q = model(obs, pa, pr)
            jq = jm.apply(snap["params"], jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **CLOSE)
    # and back: the snapshot loads into a zeroed copy of the port's model
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    fresh.load_state_dict({k: torch.tensor(v) for k, v in
                           from_jax_params(snap["params"]).items()})
    with torch.no_grad():
        again = (fresh(obs, pa, pr, state)[0] if key == "r2d1"
                 else fresh(obs, pa, pr))
    assert torch.equal(again, q)


# Trained runs of the JAX package's minatar_dqn script, kept in the repo
# with their snapshots: (run directory under curves/, config, game).
KEPT_RUNS = [("minatar_breakout_r2d1", "r2d1", "breakout"),
             ("minatar_freeway_dqn_pub", "dqn_pub", "freeway"),
             ("minatar_breakout_ernbw", "ernbw", "breakout")]


@pytest.mark.parametrize("run, key, game", KEPT_RUNS)
def test_jax_snapshot_loads_into_the_port(run, key, game):
    """The other direction: a params.pkl that the JAX script wrote for a
    trained run loads through params.py into the model that the port's
    ``build_runner`` builds for the same config, which then gives the JAX
    model's outputs on random planes."""
    snap = pickle.loads((ROOT / "curves" / run / "run_0" / "params.pkl")
                        .read_bytes())
    runner, _ = build_runner(key, device="cpu", config_overrides={
        "env": {"game": game}, "eval_env": {"game": game}})
    agent = runner.agent
    agent.initialize(runner.env.spaces)
    agent.model.load_state_dict({k: torch.tensor(v) for k, v in
                                 from_jax_params(snap["params"]).items()})
    rng = np.random.default_rng(3)
    B, n_actions = 16, agent.env_spaces.action.n
    obs = (rng.random((B,) + runner.env.observation_space.shape)
           < 0.2).astype(np.uint8)
    pa = rng.integers(0, n_actions, B).astype(np.int32)
    pr = rng.standard_normal(B).astype(np.float32)
    jm = jax_model(key, n_actions)
    with torch.no_grad():
        if key == "r2d1":
            state = tuple((0.5 * rng.standard_normal((B, 128)))
                          .astype(np.float32) for _ in range(2))
            q, (h, _) = agent.model(torch.tensor(obs), torch.tensor(pa),
                                    torch.tensor(pr),
                                    tuple(map(torch.tensor, state)))
            jq, (jh, _) = jm.apply(snap["params"], obs, pa, pr,
                                   tuple(map(jnp.asarray, state)))
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), **CLOSE)
        else:
            q = agent.model(torch.tensor(obs))
            jq = jm.apply(snap["params"], obs)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **CLOSE)


def test_script_refuses_a_mesh():
    """``mesh`` builds SyncRl (tests/test_torch_parallel.py), which takes
    a MeshSpec only."""
    with pytest.raises(TypeError, match="MeshSpec"):
        build_and_train("dqn", mesh=object(), device="cpu")
