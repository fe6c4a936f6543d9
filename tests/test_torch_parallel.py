"""The port's data- and tensor-parallel runner on the CPU (gloo over
localhost, ranks spawned): the twins of tests/test_parallel.py (:47, :54,
:73, :92, :103, :117), of tests/test_learning_coverage.py:80 and of
tests/test_collectors.py:225's SyncRlEval case.

The JAX SyncRl runs one program over a device mesh, so its whole run
equals MinibatchRl's.  The port's ranks collect from streams of their
own, so a whole dp = 2 run is no step-for-step twin of the single-process
run; what is held instead: dp = 1 equals MinibatchRl bit for bit, one
dp = 2 update from a common replay equals the single-process update
(rtol 2e-3, atol 2e-4, the JAX tolerance), ranks end with equal
parameters, and dp = 1, mp = 2 equals MinibatchRl over a whole run."""
import multiprocessing
import os
import socket

import pytest
import torch

import _torch_multihost_worker as worker
from rlpyt_tpu_torch.agents.dqn import DqnAgent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.classic import CartPole
from rlpyt_tpu_torch.models.dqn import DqnMlpModel
from rlpyt_tpu_torch.parallel.mesh import MeshSpec, is_sharded, make_mesh
from rlpyt_tpu_torch.runners.sync import SyncRl, SyncRlEval
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.utils.logging import TabularLogger

torch.set_num_threads(2)
RTOL, ATOL = 2e-3, 2e-4
TIME_KEYS = ("CumTime (s)", "StepsPerSecond", "UpdatesPerSecond")


class RowLogger(TabularLogger):
    def __init__(self):
        super().__init__(None)
        self.rows = []

    def dump_tabular(self, print_fn=print):
        self.rows.append(dict(self._tabular))
        super().dump_tabular(print_fn=None)


def make_dqn(runner_cls=SyncRl, hidden=(64, 64), B=16, n_steps=2_048,
             seed=3, prioritized=False, **kwargs):
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=hidden),
                     eps_steps=5_000, eps_final=0.1, device="cpu")
    algo = DQN(batch_size=64, min_steps_learn=256, replay_size=8_192,
               replay_ratio=2.0, target_update_interval=50,
               learning_rate=1e-3, prioritized_replay=prioritized)
    return runner_cls(algo=algo, agent=agent, env=CartPole(device="cpu"),
                      batch_spec=BatchSpec(T=16, B=B), n_steps=n_steps,
                      seed=seed, log_interval_steps=1_024,
                      max_decorrelation_steps=0, device="cpu", **kwargs)


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from leaves(x, f"{path}/{i}")
    else:
        yield path, tree


def assert_bitwise(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert torch.equal(g.reshape(-1).contiguous().view(torch.uint8),
                               w.reshape(-1).contiguous().view(torch.uint8)
                               ), k
        elif isinstance(w, float) and w != w:
            assert g != g, k
        else:
            assert g == w, k


def assert_close(got: dict, want: dict):
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{k}: {m}")


def moments(algo_state: dict) -> dict:
    """The optimizers' moments (Adam's exp_avg and exp_avg_sq) of an
    algorithm's state, by path."""
    return {k: v for k, v in leaves(algo_state)
            if "/inner/state/" in k and not k.endswith("/step")}


def load_rank(directory, rank: int) -> dict:
    name = "checkpoint.pkl" if rank == 0 else f"checkpoint_rank{rank}.pkl"
    return torch.load(os.path.join(directory, name),
                      weights_only=False)["state"]


def test_mesh_spec():
    assert MeshSpec(dp=4, mp=2).size("cpu") == (4, 2)
    with pytest.raises(ValueError):
        MeshSpec().size("cpu")   # dp=-1 counts cards
    if not torch.cuda.is_available():
        assert MeshSpec(mp=1).size("cuda") == (1, 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    from rlpyt_tpu_torch.parallel.mesh import host_env_slice, \
        init_distributed
    assert host_env_slice(16) == slice(0, 16)   # no group: all lanes
    assert init_distributed(address, 1, 0, "gloo", 30) == 0
    try:
        assert init_distributed(address, 1, 0, "gloo", 30) == 0  # again
        mesh = make_mesh(dp=1, mp=1, device_type="cpu")
        assert mesh.mesh_dim_names == ("dp", "mp")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(AssertionError):
            make_mesh(dp=2, mp=2, device_type="cpu")
        assert host_env_slice(16) == slice(0, 16)
    finally:
        torch.distributed.destroy_process_group()


def test_syncrl_dqn_runs_sharded(tmp_path):
    """dp = 2: each rank's env lanes and replay ring hold half of the 16
    lanes, cum_steps counts all of them, and the ranks end with equal
    parameters (rank 1's from its checkpoint)."""
    runner = make_dqn(mesh=MeshSpec(dp=2), checkpoint_dir=str(tmp_path),
                      prioritized=True)
    state = runner.train()
    assert state["rollout_state"].observation.shape == (8, 4)
    ring = state["algo"]["replay"]["data"]
    assert ring.reward.shape[1] == 8 and ring.observation.shape[1:] == (8, 4)
    # the priority table stays whole on every rank
    assert state["algo"]["replay"]["priorities"].shape[1] == 16
    assert state["rollout_state"].cum_steps >= 2_048
    assert runner.algo.update_counter > 0
    rank1 = load_rank(tmp_path, 1)
    assert_bitwise(rank1["model"], state["model"])
    assert_bitwise(rank1["algo"]["replay"]["priorities"],
                   state["algo"]["replay"]["priorities"])
    assert not torch.equal(rank1["algo"]["replay"]["data"].observation,
                           ring.observation)   # other lanes


def test_syncrl_dp1_equals_minibatchrl_bit_for_bit():
    """dp = 1 runs none of the shard's paths: every state leaf and every
    logged row (time columns aside) equal MinibatchRl's."""
    log_a, log_b = RowLogger(), RowLogger()
    a = make_dqn(MinibatchRl, prioritized=True, logger=log_a).train()
    b = make_dqn(mesh=MeshSpec(dp=1), prioritized=True, logger=log_b).train()
    assert_bitwise(b, a)
    assert len(log_a.rows) == len(log_b.rows) == 2
    for ra, rb in zip(log_a.rows, log_b.rows):
        assert list(ra) == list(rb)
        assert all(ra[k] == rb[k] for k in ra if k not in TIME_KEYS)


@pytest.mark.parametrize("case", ["dqn", "dqn_frame", "r2d1", "ppo",
                                  "lstm_ppo", "sac", "dqn_idle",
                                  "r2d1_idle"])
def test_dp2_update_equals_single_process(case, tmp_path):
    """Two ranks, each with its lanes of a common replay, draw over all
    lanes and all-reduce the gradients: their parameters (and priority
    tables) are equal bit for bit and equal the single-process update's
    to the JAX tolerance, as do the diagnostics (the loss, the norm
    before the clip) and the optimizers' moments, where a gradient off by
    a constant factor shows (Adam's step hides it from the parameters).
    In the "_idle" cases rank 1 holds no drawn row: its loss is over
    nothing, its gradient zero."""
    want = worker.dp_update(case)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.dp_update_rank,
                         args=(r, 2, address, case, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(180)
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    assert got[0]["updates"] == got[1]["updates"] == want["updates"] > 0
    assert_bitwise(got[1]["model"], got[0]["model"])
    assert_close(got[0]["model"], want["model"])
    for r in range(2):
        torch.testing.assert_close(torch.stack(got[r]["info"]),
                                   torch.stack(want["info"]), rtol=RTOL,
                                   atol=ATOL)
    want_moments = moments(want["algo"])
    assert want_moments
    assert_bitwise(moments(got[1]["algo"]), moments(got[0]["algo"]))
    assert_close(moments(got[0]["algo"]), want_moments)
    replay = want["algo"].get("replay", {})
    if "priorities" in replay:
        assert_bitwise(got[1]["algo"]["replay"]["priorities"],
                       got[0]["algo"]["replay"]["priorities"])
        torch.testing.assert_close(got[0]["algo"]["replay"]["priorities"],
                                   replay["priorities"], rtol=RTOL,
                                   atol=ATOL)
        ring = got[0]["algo"]["replay"]["data"].reward
        assert ring.shape[1] * 2 == replay["data"].reward.shape[1]


def test_syncrl_resume_dp2_bit_for_bit(tmp_path):
    """dp = 2, stopped after 2 of 4 intervals and resumed from every
    rank's checkpoint: each rank's state equals the uninterrupted run's
    bit for bit."""
    full_dir, part_dir = tmp_path / "full", tmp_path / "part"
    kw = dict(mesh=MeshSpec(dp=2), n_steps=4_096, prioritized=True)
    full = make_dqn(checkpoint_dir=str(full_dir), **kw).train()
    make_dqn(checkpoint_dir=str(part_dir),
             **dict(kw, n_steps=2_048)).train()
    resumed = make_dqn(checkpoint_dir=str(part_dir), **kw).train(
        resume_from=str(part_dir / "checkpoint.pkl"))
    assert_bitwise(resumed, full)
    assert_bitwise(load_rank(part_dir, 1), load_rank(full_dir, 1))


def test_syncrl_resume_mp2_bit_for_bit(tmp_path):
    """dp = 1, mp = 2: checkpoints hold whole tensors, and a resume cuts
    them to each rank's shards again (the model's, the target's and
    Adam's moments): the resumed run equals the uninterrupted one bit for
    bit."""
    full_dir, part_dir = tmp_path / "full", tmp_path / "part"
    kw = dict(mesh=MeshSpec(dp=1, mp=2), hidden=(512, 512), n_steps=2_048,
              seed=5)
    full = make_dqn(checkpoint_dir=str(full_dir), **kw).train()
    make_dqn(checkpoint_dir=str(part_dir),
             **dict(kw, n_steps=1_024)).train()
    runner = make_dqn(checkpoint_dir=str(part_dir), **kw)
    resumed = runner.train(resume_from=str(part_dir / "checkpoint.pkl"))
    assert is_sharded(runner.agent.model.head.layers[1].weight)
    assert is_sharded(runner.algo.target_model.head.layers[1].weight)
    assert_bitwise(resumed, full)
    assert_bitwise(load_rank(part_dir, 1), load_rank(full_dir, 1))


def test_syncrl_a2c_runs():
    """A2C (MinAtar Breakout) over dp = 2 through the script's ``mesh``."""
    from rlpyt_tpu_torch.experiments.scripts.minatar_pg import \
        build_and_train
    runner = build_and_train(
        "a2c", mesh=MeshSpec(dp=2), device="cpu", config_overrides={
            "model": {"channels": (4,), "fc_sizes": (16,)},
            "runner": {"n_steps": 256, "log_interval_steps": 128},
            "sampler": {"batch_T": 8, "batch_B": 8,
                        "max_decorrelation_steps": 10, "eval_n_envs": 0}})
    assert isinstance(runner, SyncRl)
    assert runner.algo.update_counter == 4
    assert runner.rollout_state.cum_steps == 256


def test_minatar_dqn_script_runs_syncrl():
    """``mesh=`` builds SyncRl, as the JAX script does (it raised
    before)."""
    from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import \
        build_runner
    runner, _ = build_runner("r2d1", device="cpu", mesh=MeshSpec(dp=2))
    assert isinstance(runner, SyncRl) and runner.dp == 2


def test_tensor_parallel_params(tmp_path):
    """shard_params over mp = 2 (min_size 1): every Linear and Conv2d
    with an even number of output units is split (DTensors on Shard(0))
    and the split model gives the whole one's outputs and gradients."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.shard_check_rank,
                         args=(r, 2, address, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        res = torch.load(tmp_path / f"shard{r}.pt", weights_only=False)
        assert res["split"] == ["conv.convs.0", "fc.layers.0", "pi"]
        assert res["local_shapes"]["fc.layers.0.weight"] == (8, 512)
        assert res["max_err"] <= 1e-6


def test_tensor_parallel_live_training():
    """dp = 1, mp = 2: the 512x512 kernel (262,144 entries >= 1 << 16) is
    split on the live model while it trains, and the run equals
    MinibatchRl to the JAX tolerance."""
    runner = make_dqn(hidden=(512, 512), n_steps=1_024, seed=5,
                      mesh=MeshSpec(dp=1, mp=2))
    state = runner.train()
    layers = runner.agent.model.head.layers
    big = layers[1].weight
    assert type(big).__name__ == "DTensor"
    assert big.to_local().shape == (256, 512)
    assert not is_sharded(layers[0].weight)   # 2048 entries < 1 << 16
    want = make_dqn(MinibatchRl, hidden=(512, 512), n_steps=1_024,
                    seed=5).train()
    assert state["model"]["head.layers.1.weight"].shape == (512, 512)
    assert_close(state["model"], want["model"])


def test_syncrl_eval_mp2_with_checkpoints(tmp_path):
    """dp = 1, mp = 2 with an evaluation and checkpoints: both mp ranks
    evaluate in step (their split layers' forward passes are
    collectives), so the run ends, equals MinibatchRlEval's to the JAX
    tolerance, and logs its Eval rows on rank 0."""
    from rlpyt_tpu_torch.runners.train import MinibatchRlEval
    kw = dict(hidden=(512, 512), n_steps=2_048, seed=5,
              eval_env=CartPole(device="cpu"), eval_n_envs=4,
              eval_max_steps=256)
    logger = RowLogger()
    runner = make_dqn(SyncRlEval, mesh=MeshSpec(dp=1, mp=2), timeout=120,
                      checkpoint_dir=str(tmp_path), logger=logger, **kw)
    state = runner.train()
    assert is_sharded(runner.agent.model.head.layers[1].weight)
    want_logger = RowLogger()
    want = make_dqn(MinibatchRlEval, logger=want_logger, **kw).train()
    assert_close(state["model"], want["model"])
    assert len(logger.rows) == len(want_logger.rows) == 2
    for row, want_row in zip(logger.rows, want_logger.rows):
        assert row["EvalTrajs"] == want_row["EvalTrajs"] > 0
        assert row["EvalReturnAverage"] == pytest.approx(
            want_row["EvalReturnAverage"], rel=RTOL, abs=ATOL, nan_ok=True)
    assert_bitwise(load_rank(tmp_path, 1)["model"], state["model"])


def test_syncrl_mp_sharding_is_live(tmp_path):
    """dp = 2, mp = 2 (four ranks): the 256x512 kernel (131,072 entries)
    is split over mp on the live model, and all four ranks end with equal
    parameters, whole in their checkpoints."""
    runner = make_dqn(hidden=(256, 512), n_steps=1_024,
                      mesh=MeshSpec(dp=2, mp=2),
                      checkpoint_dir=str(tmp_path))
    state = runner.train()
    big = runner.agent.model.head.layers[1].weight
    assert type(big).__name__ == "DTensor"
    assert big.to_local().shape == (256, 256)
    assert state["rollout_state"].cum_steps >= 1_024
    for r in (1, 2, 3):
        assert_bitwise(load_rank(tmp_path, r)["model"], state["model"])


def test_syncrl_rank_failure_raises(tmp_path):
    """Every rank fails (no checkpoint to resume from): train() raises
    with the ranks' exit codes instead of waiting."""
    with pytest.raises(RuntimeError, match="ranks failed"):
        make_dqn(mesh=MeshSpec(dp=2), timeout=60).train(
            resume_from=str(tmp_path / "checkpoint.pkl"))


def test_syncrl_eval_alias():
    """SyncRlEval rejects a missing eval_env and, with one, logs the
    Eval rows on rank 0 (tests/test_collectors.py:225)."""
    with pytest.raises(ValueError):
        make_dqn(SyncRlEval, mesh=MeshSpec(dp=2))
    logger = RowLogger()
    runner = make_dqn(SyncRlEval, mesh=MeshSpec(dp=2), n_steps=1_024,
                      eval_env=CartPole(device="cpu"), eval_n_envs=4,
                      eval_max_steps=64, eval_max_trajectories=2,
                      logger=logger)
    runner.train()
    assert len(logger.rows) == 1
    row = logger.rows[0]
    assert row["CumSteps"] == 1_024 and "EvalTrajs" in row
    # Trajectory stats cover both ranks' lanes.
    assert row["Trajs"] > 0 and row["ReturnMax"] >= row["ReturnMin"]
