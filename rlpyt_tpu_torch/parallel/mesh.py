"""Process groups for data- and tensor-parallel training (port of
rlpyt_tpu/parallel/mesh.py; reference: rlpyt/runners/sync_rl.py with
rlpyt/utils/synchronize.py).

The JAX package lays one program over a ``jax.sharding.Mesh`` and lets
GSPMD place the collectives.  Here each rank is a process, as in rlpyt,
joined by ``torch.distributed``; the mesh is a ``DeviceMesh`` over those
ranks with the JAX axis names:

- ``dp``: data parallel.  Rank r of ``dp`` owns lanes [r B / dp,
  (r + 1) B / dp) of every lane-shaped tensor outright: its env lanes,
  the collector's ``RolloutState`` and every replay ring's lane axis
  (the frame ring [size_T, B / dp, F] too).  ``DpShard`` holds what the
  algorithms need for that: the rank's lanes, the local rows of a draw
  over all lanes, the means over all ranks' rows and the gradient
  all-reduce.
- ``mp``: tensor parallel (beyond rlpyt).  ``shard_params`` splits large
  Linear and Conv2d layers over it by output units.

The JAX module's sharding constructors (``replicated``,
``batch_sharding``, ``shard_batch_tree``, ``rollout_sharding``,
``replay_sharding``, ``carry_sharding``) and ``put_global`` have no
counterpart: nothing is laid out after the fact, since each rank builds
only its own lanes, and rank 0's parameters are broadcast to the others
at startup.
"""
from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


@dataclass
class MeshSpec:
    """Declarative rank layout (replaces rlpyt's affinity codes).

    ``dp``: data-parallel size (-1 = every rank that ``mp`` leaves over:
    ``torch.cuda.device_count() // mp`` on the card; on the CPU it must
    be given).  ``mp``: tensor-parallel size."""

    dp: int = -1
    mp: int = 1

    def size(self, device_type: str = "cuda") -> Tuple[int, int]:
        """(dp, mp) with ``dp=-1`` resolved."""
        if self.dp > 0:
            return self.dp, self.mp
        if device_type != "cuda":
            raise ValueError("MeshSpec(dp=-1) counts cards; give dp on the "
                             "CPU")
        return max(1, torch.cuda.device_count() // self.mp), self.mp

    def make(self, device_type: str = "cuda"):
        """A ``DeviceMesh`` with dims ("dp", "mp") over the ranks of the
        process group, which must be up."""
        from torch.distributed.device_mesh import DeviceMesh

        dp, mp = self.size(device_type)
        n = dist.get_world_size()
        assert dp * mp <= n, (
            f"mesh {dp}x{mp} needs {dp * mp} ranks, have {n}")
        ranks = torch.arange(dp * mp).reshape(dp, mp)
        return DeviceMesh(device_type, ranks, mesh_dim_names=("dp", "mp"))


def make_mesh(dp: int = -1, mp: int = 1, device_type: str = "cuda"):
    return MeshSpec(dp=dp, mp=mp).make(device_type)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[float] = None) -> int:
    """Join the process group at ``tcp://coordinator_address`` (host:port)
    as rank ``process_id`` of ``num_processes``; without an address, from
    the ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``
    environment.  ``backend``: NCCL for the card, gloo for the CPU, unless
    named.  ``timeout``: seconds that a collective or the rendezvous may
    wait.  Idempotent when the group is up; every other error
    propagates.  Returns this process's rank."""
    if dist.is_initialized():
        return dist.get_rank()
    if backend is None:
        backend = default_backend(
            "cuda" if torch.cuda.is_available() else "cpu")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{coordinator_address}" if coordinator_address
                     else "env://"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)
    return dist.get_rank()


def lane_slice(B: int, rank: int, size: int) -> slice:
    """Lanes [rank B / size, (rank + 1) B / size) of B."""
    assert B % size == 0, f"global B={B} must divide over {size} ranks"
    per = B // size
    return slice(rank * per, (rank + 1) * per)


def host_env_slice(B: int) -> slice:
    """This process's lanes of a B-lane batch split over the process
    group (the analogue of rlpyt's n_envs_list worker split,
    samplers/parallel/base.py ~L60): process i owns [i B / W,
    (i + 1) B / W).  The whole batch without a group."""
    if not dist.is_initialized():
        return slice(0, B)
    return lane_slice(B, dist.get_rank(), dist.get_world_size())


class DpShard:
    """Rank ``rank`` of ``size`` on the data-parallel axis, over
    ``group`` (None: the whole process group).

    Replay draws are made over all B lanes from a generator that every
    rank holds in the same state; each rank keeps the drawn rows of its
    own lanes (``local_rows``) and computes its loss on them with the
    means taken over every rank's rows (``mean``), so that the gradients
    summed over ranks (``all_reduce_``, one flat bucket) are those of the
    single-process update."""

    def __init__(self, rank: int, size: int, group=None):
        self.rank = rank
        self.size = size
        self.group = group

    def lanes(self, B: int) -> slice:
        return lane_slice(B, self.rank, self.size)

    def all_reduce_(self, t: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ranks, in place."""
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_reduce_grads_(self, grads) -> None:
        """Sum the tensors ``grads`` over the ranks in place, as one flat
        bucket (split ones by their local shards)."""
        local = [g.to_local() if is_sharded(g) else g for g in grads]
        if not local:
            return
        flat = self.all_reduce_(torch.cat([g.reshape(-1) for g in local]))
        i = 0
        for g in local:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()

    def broadcast_(self, tensors) -> None:
        """Rank 0's values of ``tensors`` on every rank, in place."""
        src = (dist.get_global_rank(self.group, 0)
               if self.group is not None else 0)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast((t.to_local() if is_sharded(t) else t)
                               .detach(), src, group=self.group)

    def local_rows(self, b_idx: torch.Tensor, lanes: slice):
        """(positions in the draw of the rows whose lane is this rank's,
        those rows' lanes on this rank), int64; syncs the host."""
        pos = torch.nonzero((b_idx >= lanes.start) & (b_idx < lanes.stop)
                            ).squeeze(1)
        return pos, b_idx[pos] - lanes.start

    def gather_rows(self, values: torch.Tensor, pos: torch.Tensor,
                    n: int) -> torch.Tensor:
        """The [n, ...] values of a whole draw on every rank, from each
        rank's ``values`` at its positions ``pos`` (rows no rank holds
        are 0)."""
        full = torch.zeros((n,) + tuple(values.shape[1:]),
                           dtype=values.dtype, device=values.device)
        full[pos] = values
        return self.all_reduce_(full)

    def gather_lanes(self, x: torch.Tensor, B: int) -> torch.Tensor:
        """``x`` [n, this rank's lanes] with every rank's: the [n, B]
        tensor on every rank."""
        full = torch.zeros((x.shape[0], B), dtype=x.dtype, device=x.device)
        full[:, self.lanes(B)] = x
        return self.all_reduce_(full)

    def mean(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
             n: Optional[int] = None) -> torch.Tensor:
        """This rank's share of the mean of ``x`` over every rank's
        entries (``valid``-weighted): its sum over the count of all
        ranks.  The shares sum to the mean.  Without ``valid`` the count
        is ``n``, the entries of every rank's ``x`` together (the draw's
        size, which each rank knows); with it, a collective."""
        if valid is None:
            assert n is not None, "a mean over all ranks needs valid or n"
            return x.sum() / n
        valid = valid.to(x.dtype)
        count = self.all_reduce_(valid.sum().detach().clone())
        return (x * valid).sum() / torch.clamp(count, min=1e-8)


# ---------------------------------------------------------------------------
# Tensor parallelism (beyond reference parity): column-shard large Linear
# and Conv2d layers over 'mp'.
#
# The split weights are DTensors (Shard(0): output units), but no DTensor
# collective runs: the layers compute on their local shards and move
# activations with plain ``torch.distributed`` calls.  DTensor's own
# collectives (what ``ColwiseParallel`` would run) crash on CUDA tensors
# over gloo, the only backend that two ranks sharing one card can use
# (torch 2.11 on the H100).

class _CopyToMp(torch.autograd.Function):
    """Identity forward; backward sums the input's gradient over 'mp',
    where each rank holds the part from its own output units."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherUnits(torch.autograd.Function):
    """All-gather on ``dim`` (the output units) over 'mp'; backward keeps
    this rank's chunk."""

    @staticmethod
    def forward(ctx, y, group, rank, size, dim):
        ctx.rank, ctx.size, ctx.dim = rank, size, dim
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        chunk = grad.chunk(ctx.size, dim=ctx.dim)[ctx.rank].contiguous()
        return chunk, None, None, None, None


def _colwise(layer, fn, x, dim: int):
    """``fn(x, weight, bias)`` on this rank's output units, gathered."""
    mesh = layer.weight.device_mesh
    group = mesh.get_group()
    x = _CopyToMp.apply(x, group)
    bias = layer.bias.to_local() if layer.bias is not None else None
    y = fn(x, layer.weight.to_local(), bias)
    return _GatherUnits.apply(y, group, mesh.get_local_rank(), mesh.size(),
                              dim)


class ColwiseLinear(nn.Linear):
    """nn.Linear whose output units are split over 'mp'."""

    def forward(self, x):
        return _colwise(self, F.linear, x, -1)


class ColwiseConv2d(nn.Conv2d):
    """nn.Conv2d whose output channels are split over 'mp'."""

    def forward(self, x):
        return _colwise(self, lambda x, w, b: F.conv2d(
            x, w, b, self.stride, self.padding, self.dilation, self.groups),
            x, 1)


def layer_apply(layer, fn, x):
    """``fn(x, layer.weight, layer.bias)``: what a model that casts the
    weights itself calls; a layer split over 'mp' computes its own output
    units and gathers them."""
    if isinstance(layer, (ColwiseLinear, ColwiseConv2d)):
        return _colwise(layer, fn, x, -1 if isinstance(layer, nn.Linear)
                        else 1)
    return fn(x, layer.weight, layer.bias)


def shard_params(module: nn.Module, mesh, min_size: int = 1 << 16
                 ) -> nn.Module:
    """Column-shard, in place, every Linear and Conv2d of ``module`` whose
    output units divide by the mesh's 'mp' size and whose weight has at
    least ``min_size`` entries (rlpyt_tpu/parallel/mesh.py:185's rule):
    the weight and bias become DTensors on Shard(0) of the 'mp' sub-mesh,
    and the layer's output is all-gathered, so it computes what it did.
    The LSTM's W_x and W_h stay whole: the hand-written K3a, K3 and K4
    read them whole.  With mp = 1 nothing changes.  Returns ``module``."""
    mp_mesh = mesh["mp"]
    mp = mp_mesh.size()
    if mp == 1:
        return module
    from torch.distributed.tensor import Shard, distribute_tensor

    for sub in module.modules():
        if type(sub) not in (nn.Linear, nn.Conv2d):
            continue
        w = sub.weight
        if w.shape[0] % mp or w.numel() < min_size:
            continue
        for name in ("weight", "bias"):
            p = getattr(sub, name)
            if p is not None:
                setattr(sub, name, nn.Parameter(
                    distribute_tensor(p.data, mp_mesh, [Shard(0)],
                                      src_data_rank=None),
                    requires_grad=p.requires_grad))
        sub.__class__ = (ColwiseLinear if isinstance(sub, nn.Linear)
                         else ColwiseConv2d)
    return module


def is_sharded(t) -> bool:
    """True for a DTensor (a tensor that ``shard_params`` split)."""
    return hasattr(t, "device_mesh")


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A split tensor gathered whole over its 'mp' group (a collective);
    any other as it is."""
    if not is_sharded(t):
        return t
    local = t.to_local().contiguous()
    mesh = t.device_mesh
    parts = [torch.empty_like(local) for _ in range(mesh.size())]
    dist.all_gather(parts, local, group=mesh.get_group())
    return torch.cat(parts, dim=0)


def shard_like(whole: torch.Tensor, ref) -> torch.Tensor:
    """``whole`` cut to this rank's shard of the split tensor ``ref``, as a
    DTensor like it (no collective)."""
    from torch.distributed.tensor import DTensor

    mesh = ref.device_mesh
    local = whole.chunk(mesh.size(), dim=0)[mesh.get_local_rank()]
    return DTensor.from_local(local.to(ref.device, ref.dtype).contiguous(),
                              mesh, ref.placements, run_check=False)


def vector_norm(t: torch.Tensor) -> torch.Tensor:
    """The float32 2-norm of ``t`` whole (a collective for a split one)."""
    if not is_sharded(t):
        return torch.linalg.vector_norm(t.float())
    sq = torch.linalg.vector_norm(t.to_local().float()) ** 2
    dist.all_reduce(sq, group=t.device_mesh.get_group())
    return sq.sqrt()


def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with each split tensor gathered whole."""
    return {k: full_tensor(v) for k, v in module.state_dict().items()}
