#!/usr/bin/env python3
"""Smoke test of the PyTorch port (rlpyt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA frame-gather kernel from rlpyt_tpu_torch/csrc;
  2. hold it against its plain PyTorch version on the card, bit-exact, at
     the flagship replay shapes (ring [1568, 128, 8320] u8, batch 256,
     K=4, n=1, wrap-around starts) and on ragged / unaligned rows;
  3. time the kernel, the plain version and one indexed PyTorch call
     with CUDA events;
  4. train the flagship Nature-CNN DQN (bench_atari.py:157-175 settings,
     bf16, full width) for a few iterations through MinibatchRl, check
     the losses are finite, that every replay sample went through the
     kernel, and that the card's replay batches equal the CPU path's.

The last lines are the card's name and power limit, one JSON line with
the kernels' numbers and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
N_ITR = 4                    # trainer iterations; the first one warms up
B, T = 128, 32               # flagship env lanes and steps per iteration


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def random_case(g, size_T, B, F, batch, K, n, dev, mask_dtype=torch.uint8):
    """Ring, starts (some wrapping past the ring's end), lanes, masks."""
    ring = torch.randint(0, 256, (size_T, B, F), generator=g, device=dev,
                         dtype=torch.uint8)
    start = torch.randint(0, size_T, (batch,), generator=g, device=dev,
                          dtype=torch.int32)
    start[:8] = torch.arange(size_T - 8, size_T, device=dev,
                             dtype=torch.int32)
    b_idx = torch.randint(0, B, (batch,), generator=g, device=dev,
                          dtype=torch.int32)
    masks = torch.randint(0, 2, (2, batch, K), generator=g, device=dev,
                          dtype=torch.uint8).to(mask_dtype)
    return ring, start, b_idx, masks[0].contiguous(), masks[1].contiguous()


def check_gather(fg, g, dev):
    """Phase 2: kernel vs plain, bit-exact.  Returns the flagship case's
    max abs error."""
    K, n = 4, 1
    cases = [
        ("flagship", (1568, 128, 8320, 256, K, n), torch.uint8),
        ("bool masks, n=3", (64, 16, 8320, 64, K, 3), torch.bool),
        ("ragged F=8321", (64, 16, 8321, 64, K, n), torch.uint8),
        ("F=100", (40, 8, 100, 33, 2, 2), torch.uint8),
    ]
    worst = None
    for name, (size_T, B, F, batch, k, nn), mdt in cases:
        ring, start, b_idx, ma, mt = random_case(g, size_T, B, F, batch, k,
                                                 nn, dev, mdt)
        out = fg.gather_frame_stacks(ring, start, b_idx, ma, mt, k, nn)
        ref = fg.gather_frame_stacks_plain(ring, start, b_idx, ma, mt, k, nn)
        torch.cuda.synchronize()
        err = max(int((o.int() - r.int()).abs().max()) for o, r in
                  zip(out, ref))
        if err != 0 or any(o.shape != r.shape for o, r in zip(out, ref)):
            fail(f"frame gather differs from plain ({name}): max err {err}")
        if worst is None:
            worst = err
        print(f"gather check {name}: bit-exact")
    # Rows that are not 16-byte aligned take the byte path.
    size_T, B, F, batch = 32, 8, 8320, 64
    flat = torch.randint(0, 256, (size_T * B * F + 1,), generator=g,
                         device=dev, dtype=torch.uint8)
    ring = flat[1:].view(size_T, B, F)
    _, start, b_idx, ma, mt = random_case(g, size_T, B, 16, batch, K, n, dev)
    out = fg.gather_frame_stacks(ring, start, b_idx, ma, mt, K, n)
    ref = fg.gather_frame_stacks_plain(ring, start, b_idx, ma, mt, K, n)
    if not all(torch.equal(o, r) for o, r in zip(out, ref)):
        fail("frame gather differs from plain (unaligned ring)")
    print("gather check unaligned ring: bit-exact")
    return worst


def time_gather(fg, g, dev):
    """Phase 3 at the flagship shapes.  Index sets rotate so the union
    rows are not left in L2 from the previous call."""
    size_T, B, F, batch, K, n = 1568, 128, 8320, 256, 4, 1
    U = K + n
    ring = torch.randint(0, 256, (size_T, B, F), generator=g, device=dev,
                         dtype=torch.uint8)
    sets = []
    for _ in range(16):
        _, start, b_idx, ma, mt = random_case(g, size_T, B, 16, batch, K, n,
                                              dev)
        rows = (start.long()[:, None]
                + torch.arange(U, device=dev)) % size_T
        flat = rows * B + b_idx.long()[:, None]                  # [batch, U]
        both = torch.cat([flat[:, :K], flat[:, n:n + K]], 1).reshape(-1)
        sets.append((start, b_idx, ma, mt, both))
    ring2d = ring.view(size_T * B, F)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    def kernel():
        s, b, ma, mt, _ = nxt()
        fg.gather_frame_stacks(ring, s, b, ma, mt, K, n)

    def plain():
        s, b, ma, mt, _ = nxt()
        fg.gather_frame_stacks_plain(ring, s, b, ma, mt, K, n)

    def library():   # one indexed call, same output bytes, no masking
        torch.index_select(ring2d, 0, nxt()[4])

    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    n_bytes = batch * (U + 2 * K) * F + batch * (4 + 4 + 2 * K)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bytes": n_bytes}


def build_flagship_runner(dev, n_itr: int, logger=None):
    """The flagship Nature-CNN DQN trainer of bench_atari.py:139-176
    (B=128, T=32, update batch 256, replay ratio 8, replay 200k, bf16,
    double DQN, frame replay) on the port, one iteration per log row."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    agent = DqnAgent(model_kwargs=dict(compute_dtype=torch.bfloat16),
                     eps_steps=250_000, eps_final=0.01, device=dev)
    algo = DQN(discount=0.99, batch_size=256, min_steps_learn=0,
               replay_size=200_000, replay_ratio=8.0,
               target_update_interval=2_500, learning_rate=2.5e-4,
               double_dqn=True, n_step_return=1, frames_per_obs=4)
    return MinibatchRl(algo, agent, SyntheticAtariEnv(dev),
                       BatchSpec(T=T, B=B), n_steps=n_itr * T * B, seed=0,
                       log_interval_steps=T * B, logger=logger, device=dev)


def run_trainer(dev):
    """Phase 4: the flagship trainer through MinibatchRl."""
    from rlpyt_tpu_torch.ops import frame_gather as fg
    from rlpyt_tpu_torch.utils.logging import TabularLogger

    class RowLogger(TabularLogger):
        def __init__(self):
            super().__init__(None)
            self.rows = []

        def dump_tabular(self, print_fn=print):
            self.rows.append(dict(self._tabular))
            super().dump_tabular(print_fn=None)

    logger = RowLogger()
    runner = build_flagship_runner(dev, N_ITR, logger)
    algo = runner.algo
    fg.gather_frame_stacks.launches = 0
    runner.train()
    torch.cuda.synchronize()
    launches = fg.gather_frame_stacks.launches
    updates = algo.update_counter
    if updates != N_ITR * algo.updates_per_optimize:
        fail(f"ran {updates} updates, expected "
             f"{N_ITR * algo.updates_per_optimize}")
    if launches != updates:
        fail(f"frame gather launched {launches} times for {updates} updates")
    for row in logger.rows:
        for key in ("loss", "grad_norm", "td_abs_err", "StepsPerSecond"):
            if not math.isfinite(row[key]):
                fail(f"non-finite {key} in iteration {row['Iteration']}")
    sps = [r["StepsPerSecond"] for r in logger.rows]
    for r in logger.rows:
        print(f"trainer itr {r['Iteration']}: loss {r['loss']:.6g} "
              f"grad_norm {r['grad_norm']:.6g} "
              f"env-steps/s {r['StepsPerSecond']:.1f} "
              f"updates/s {r['UpdatesPerSecond']:.1f}")
    return runner, launches, sps


def check_replay_against_cpu(runner, dev):
    """The card's replay batches (kernel path) must equal the CPU path's
    (plain version) on the trained ring."""
    replay = runner.algo.replay
    g = torch.Generator(device=dev).manual_seed(123)
    t_idx, b_idx = replay.sample_idxs(256, g)
    gpu = replay.extract_batch(t_idx, b_idx)
    cpu_replay = copy.copy(replay)
    cpu_replay.data = type(replay.data)(*(x.cpu() for x in replay.data))
    cpu_replay.device = torch.device("cpu")
    cpu = cpu_replay.extract_batch(t_idx.cpu(), b_idx.cpu())
    for name in ("action", "return_", "done", "done_n", "timeout_n"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            fail(f"replay {name} differs between card and CPU")
    for which in ("agent_inputs", "target_inputs"):
        if not torch.equal(getattr(gpu, which).observation.cpu(),
                           getattr(cpu, which).observation):
            fail(f"replay {which} observation differs between card and CPU")
    print("replay batch on the card equals the CPU path: bit-exact")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from rlpyt_tpu_torch.ops import frame_gather as fg

    dev = torch.device("cuda")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))

    t0 = time.time()
    fg.load()
    print(f"phase 1: built {fg.build().name} in {time.time() - t0:.1f} s")

    g = torch.Generator(device=dev).manual_seed(0)
    max_err = check_gather(fg, g, dev)
    print("phase 2: kernel bit-exact against its plain version")

    timing = time_gather(fg, g, dev)
    print(f"phase 3: gather {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, index_select "
          f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['bytes']} bytes at {HBM_BYTES_PER_S:.3g} B/s)")
    torch.cuda.empty_cache()

    runner, launches, sps = run_trainer(dev)
    steady = sorted(sps[1:])[len(sps[1:]) // 2]
    print(f"phase 4: flagship trainer {N_ITR} iterations, "
          f"{launches} gather launches, median steady env-steps/s "
          f"{steady:.1f} (per iteration: {[round(s, 1) for s in sps]})")
    check_replay_against_cpu(runner, dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": [{
        "name": "frame_gather",
        "route": "cuda",
        "source": "rlpyt_tpu_torch/csrc/frame_gather.cu",
        "replaces": "rlpyt_tpu/ops/pallas/window_gather.py:79",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
