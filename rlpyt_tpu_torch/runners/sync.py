"""Synchronous data-parallel training over ranks (port of
rlpyt_tpu/runners/sync.py; reference: rlpyt/runners/sync_rl.py:SyncRl,
SyncRlEval ~L15-250).

The JAX ``SyncRl`` runs MinibatchRl's program laid out over a device mesh.
Here, as in rlpyt, each rank is a process with its own collector, joined
by ``torch.distributed``:

- **Launch.**  ``train()`` is one call.  Without a process group, the
  calling process becomes rank 0 and spawns ranks 1..W-1 (never forks),
  each with a pickled copy of the unstarted runner (algorithm, agent,
  env, settings), bound to card ``rank % device_count``, after it has
  built the CUDA sources once; a group of one is made for a world of
  one.  With a group already up (``parallel/mesh.py:init_distributed``
  in each process), nothing is spawned.  A rank that fails makes
  ``train()`` raise; a rank that hangs does so once ``timeout`` seconds
  pass in a collective.
- **Collection.**  dp rank r collects its B / dp lanes from a generator
  seeded ``seed + RANK_SEED_STRIDE * r``; ``cum_steps`` and env-steps/s
  count all B lanes, and the replay ratio is reckoned from the global
  batch.
- **The update.**  Replay draws (and PPO's minibatch permutations, TD3's
  and SAC's noise) are made over all lanes from the algorithm's
  generator, in the same state on every rank; each rank takes its loss
  over the drawn rows it holds, its means over every rank's rows
  (``parallel/mesh.py:DpShard``), and ``Optimizer.step`` sums the
  gradients over ``dp`` in one flat bucket before the clip.  The priority
  tables stay whole on each rank, every rank's new priorities gathered
  into each.  At dp = 1 nothing of this runs, and the run equals
  MinibatchRl's bit for bit.
- **mp.**  With ``mp > 1``, ``parallel/mesh.py:shard_params`` splits the
  model's large layers over the ``mp`` ranks of each dp group, which hold
  the same lanes and draw the same numbers.
- **Logging and state.**  The trajectory stats are reduced over ranks
  (the algorithms' diagnostics come whole from each update), then rank 0
  logs them and writes the snapshots.  The ranks of dp group 0 evaluate
  together, since under ``mp`` their forward passes are collectives;
  rank 0 logs the result.  Each rank saves its own checkpoint (rank 0
  ``checkpoint.pkl``, rank r ``checkpoint_rank{r}.pkl``), and
  ``train(resume_from=<rank 0's>)`` resumes every rank from its own.
  ``state_dict()`` holds whole tensors (split ones are cut again at
  load); ``train()`` returns it.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import socket
from typing import Optional

import torch
import torch.distributed as dist

from rlpyt_tpu_torch.params import agent_params_to_jax
from rlpyt_tpu_torch.parallel.mesh import (DpShard, MeshSpec,
                                           default_backend, full_state_dict,
                                           full_tensor, init_distributed,
                                           is_sharded, shard_like,
                                           shard_params)
from rlpyt_tpu_torch.runners.train import CHECKPOINT_NAME, MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, TrajStats
from rlpyt_tpu_torch.struct import tree_map
from rlpyt_tpu_torch.utils.checkpoint import save_checkpoint
from rlpyt_tpu_torch.utils.logging import TabularLogger

RANK_SEED_STRIDE = 100   # rank r collects from seed + 100 r (rlpyt's way)


class _SilentLogger(TabularLogger):
    """The logger of ranks other than 0: records and writes nothing."""

    def record_tabular(self, key, value):
        pass

    def dump_tabular(self, print_fn=print):
        pass

    def log(self, message, echo=True):
        pass

    def snapshot_path(self, itr):
        return None


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _build_kernels():
    """Build the trainers' CUDA sources (frame_gather.cu, lstm.cu) once,
    in parallel, so that the spawned ranks load them instead of each
    compiling them."""
    from concurrent.futures import ThreadPoolExecutor

    from rlpyt_tpu_torch.ops import frame_gather, lstm
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(m.build) for m in (frame_gather, lstm)]:
            f.result()


def _rank_main(rank: int, world: int, address: str, backend: str,
               timeout: float, payload: bytes, resume_from, n_threads: int):
    """A spawned rank: rebuild the runner, join the group, train."""
    torch.set_num_threads(n_threads)
    runner = pickle.loads(payload)
    if runner.device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    runner.logger = _SilentLogger(None)
    init_distributed(address, world, rank, backend, timeout)
    try:
        runner._train_rank(resume_from)
    finally:
        dist.destroy_process_group()


def _cut_like(saved, live):
    """``saved`` with each whole tensor whose counterpart in ``live`` is
    split replaced by this rank's shard of it."""
    if is_sharded(live):
        return shard_like(saved, live)
    if isinstance(saved, dict) and isinstance(live, dict):
        return {k: _cut_like(v, live.get(k)) for k, v in saved.items()}
    return saved


class SyncRl(MinibatchRl):
    """MinibatchRl over a ``MeshSpec`` of ranks (default ``dp=-1``: one
    rank a card).  ``backend``: NCCL for the card and gloo for the CPU
    unless named ("gloo" shares one card between ranks); ``timeout``:
    seconds a collective or the rendezvous may wait."""

    def __init__(self, *args, mesh: Optional[MeshSpec] = None,
                 backend: Optional[str] = None, timeout: float = 600.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if mesh is not None and not isinstance(mesh, MeshSpec):
            raise TypeError(f"SyncRl takes a MeshSpec, not {mesh!r}")
        self.mesh_spec = mesh if mesh is not None else MeshSpec(dp=-1, mp=1)
        self.dp, self.mp = self.mesh_spec.size(self.device.type)
        assert self.batch_spec.B % self.dp == 0, (
            f"batch_B={self.batch_spec.B} must divide over dp={self.dp}")
        self.backend = backend
        self.timeout = timeout
        self.rank = 0
        self.dp_rank = 0
        self.shard = None

    # -- launch ----------------------------------------------------------

    def train(self, resume_from: Optional[str] = None) -> dict:
        """Run every rank to ``n_steps``; returns this rank's
        ``state_dict()`` (rank 0's in the calling process)."""
        if dist.is_initialized():
            return self._train_rank(resume_from)
        world = self.dp * self.mp
        backend = self.backend or default_backend(self.device.type)
        if world > 1 and self.device.type == "cuda":
            _build_kernels()
        address = _free_address()
        payload = self._payload() if world > 1 else None
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, world, address, backend, self.timeout, payload,
                  resume_from, torch.get_num_threads()))
            for r in range(1, world)]
        for p in procs:
            p.start()
        error = None
        try:
            init_distributed(address, world, 0, backend, self.timeout)
            try:
                state = self._train_rank(resume_from)
            finally:
                dist.destroy_process_group()
            for p in procs:
                p.join(self.timeout)
        except BaseException as e:
            error = e
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        bad = {r: p.exitcode for r, p in enumerate(procs, 1)
               if p.exitcode != 0}
        if bad:
            raise RuntimeError(
                f"SyncRl: ranks failed (rank: exit code) {bad}") from error
        if error is not None:
            raise error
        return state

    def _payload(self) -> bytes:
        """The unstarted runner, pickled for the other ranks (its logger
        is not sent: they log nothing)."""
        logger, self.logger = self.logger, None
        try:
            return pickle.dumps(self)
        finally:
            self.logger = logger

    def _train_rank(self, resume_from: Optional[str]) -> dict:
        self.rank = dist.get_rank()
        self.mesh = self.mesh_spec.make(self.device.type)
        self.dp_rank = self.mesh.get_local_rank("dp")
        self.shard = (DpShard(self.dp_rank, self.dp,
                              self.mesh.get_group("dp"))
                      if self.dp > 1 else None)
        self.algo.shard = self.shard
        if self.rank > 0:
            self.logger = _SilentLogger(None)
        if self.dp_rank > 0:
            # dp group 0 evaluates: all of its mp ranks, in step, for
            # the split layers gather their outputs over 'mp'.
            self.eval_env = None
        return super().train(resume_from)

    # -- MinibatchRl's hooks ---------------------------------------------

    def _collection_seed(self) -> int:
        return self.seed + RANK_SEED_STRIDE * self.dp_rank

    def _collection_spec(self) -> BatchSpec:
        return BatchSpec(self.batch_spec.T, self.batch_spec.B // self.dp)

    def _initialize_agent(self):
        """Build the model, split it over 'mp', give dp rank 0's weights
        to every dp rank, and bind the agent to this rank's lanes."""
        super()._initialize_agent()
        model = self.agent.model
        shard_params(model, self.mesh)
        if self.shard is not None:
            self.shard.broadcast_(list(model.parameters())
                                  + list(model.buffers()))
            if hasattr(self.agent, "bind_lanes"):
                self.agent.bind_lanes(self.batch_spec.B,
                                      self.shard.lanes(self.batch_spec.B))

    def _log_diagnostics(self, itr, cum_steps, opt_infos, traj_stats,
                         dt_interval, dt_total):
        if self.shard is not None:
            traj_stats = self._reduce_traj_stats(traj_stats)
        super()._log_diagnostics(itr, cum_steps, opt_infos, traj_stats,
                                 dt_interval, dt_total)

    def _reduce_traj_stats(self, ts: TrajStats) -> TrajStats:
        """Sums and counts summed over ranks, max and min over ranks (the
        pooled moments follow from the sums)."""
        sums = self.shard.all_reduce_(torch.stack(
            [ts.completed.to(torch.float64)]
            + [x.to(torch.float64) for x in ts[1:6]]))
        extremes = self.shard.all_reduce_(
            torch.stack([ts.max_return, -ts.min_return]),
            op=dist.ReduceOp.MAX)
        return TrajStats(sums[0].to(ts.completed.dtype),
                         *(s.to(ts.sum_return.dtype) for s in sums[1:]),
                         extremes[0], -extremes[1])

    def _save_snapshot(self, itr: int, cum_steps: int):
        if self.mp == 1:
            return super()._save_snapshot(itr, cum_steps)
        full = full_state_dict(self.agent.model)   # a collective
        if self.logger.snapshot_path(itr) is not None:
            self.logger.save_itr_params(itr, {
                "params": agent_params_to_jax(self.agent, full),
                "itr": itr, "cum_steps": cum_steps})

    # -- state -----------------------------------------------------------

    def state_dict(self) -> dict:
        """This rank's state, split tensors gathered whole (a collective
        over 'mp' when the model is split)."""
        state = super().state_dict()
        if self.mp == 1:
            return state
        return tree_map(full_tensor, state)

    def load_state_dict(self, state: dict):
        """Load a ``state_dict()``: whole tensors are cut to this rank's
        shards where the live ones are split (the optimizers' moments by
        ``Optimizer.load_state_dict``)."""
        if self.mp > 1:
            state = _cut_like(state, super().state_dict())
        super().load_state_dict(state)

    def _checkpoint_name(self) -> str:
        return (CHECKPOINT_NAME if self.rank == 0
                else f"checkpoint_rank{self.rank}.pkl")

    def save_checkpoint(self, interval: int, cum_steps: int, itr: int):
        save_checkpoint(
            os.path.join(self.checkpoint_dir, self._checkpoint_name()),
            self.state_dict(),
            {"interval": interval, "cum_steps": cum_steps, "itr": itr,
             "rank": self.rank})

    def _resume(self, path: str) -> int:
        """Resume each rank from its own file beside rank 0's ``path``."""
        return super()._resume(os.path.join(os.path.dirname(path),
                                            self._checkpoint_name()))


class SyncRlEval(SyncRl):
    """(rlpyt/runners/sync_rl.py:SyncRlEval) SyncRl with evaluation (by
    dp group 0, logged by rank 0); ``eval_env`` is required."""

    def __init__(self, *args, eval_env=None, **kwargs):
        if eval_env is None:
            raise ValueError("SyncRlEval requires eval_env")
        super().__init__(*args, eval_env=eval_env, **kwargs)
