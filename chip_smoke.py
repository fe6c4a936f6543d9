#!/usr/bin/env python3
"""Smoke test of the PyTorch port (rlpyt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from rlpyt_tpu_torch/csrc (frame_gather.cu,
     lstm.cu and union_gather.cu, one nvcc each, in parallel);
  2. hold the frame gather against its plain PyTorch version on the card,
     bit-exact, at the flagship replay shapes (ring [1568, 128, 8320] u8,
     batch 256, K=4, n=1, wrap-around starts) and on ragged / unaligned
     rows, each case with int64 indices (what the replay buffers pass)
     and with int32 ones;
  3. time it, its plain version and one indexed PyTorch call at n=1 (the
     flagship's union of 5 rows) and at n=3 (the "ernbw" configuration's
     union of 7), two ways: the time of one Python call in a back-to-back
     loop, by CUDA events (what a trainer pays), and the device time of
     one launch with the host taken out, by replaying a captured CUDA
     graph of 32 launches; on int64 indices, the int32 kernel's device
     time beside it;
  4. train the flagship Nature-CNN DQN (bench_atari.py:157-175 settings,
     bf16, full width) for a few iterations through MinibatchRl, check
     the losses are finite, that every replay sample went through the
     kernel, and that the card's replay batches equal the CPU path's;
  5. hold the LSTM kernels (K3a input projection, K3 forward, K4
     backward) and the autograd Function against their plain versions,
     TF32 off, at R2D1's shapes (F=6919, H=512; (T, B) = (45, 32),
     (20, 32), (1, 64)), at B=128, three ragged cases and a W_x that is
     not 16-byte aligned, with random dones; K3 and K4 run twice on the
     same inputs and must give the same bits;
  6. time each LSTM kernel at the update's shapes beside its plain
     version, its bound and one library call (addmm; cuDNN's LSTM), call
     time and device time as in phase 3; K3a also at the collection's
     shape (M = 64 rows, where it streams W_x), K3 also at the
     collection's (T=1, B=64) and the burn-in's (T=20, B=32); K3a's bound
     is that of three TF32 tensor-core products, the fp32 pipes' figure
     beside it;
  7. train the Atari R2D1 configuration (bench_r2d1.py:68-104, first
     geometry) for 6 iterations through MinibatchRl, check finite
     losses and priorities, the LSTM launch counts (K3's one-step
     launches among them), and that the card's sequence windows equal
     the CPU path's;
  8. hold the two unmasked union gathers (K5 row gather, K6 window gather
     on the lane-major ghost ring) against their plain versions,
     bit-exact, at the shapes of bench_torch_gather_formulations.py (ring
     [390, 512, 8320] u8, U=7, batch 1024, wrap-around starts) and on
     ragged / unaligned cases;
  9. run that harness: its own match lines and the times of every gather
     formulation beside its bound;
 10. train the Atari "ernbw" configuration (categorical 51 atoms,
     dueling, double, prioritized frame replay alpha 0.5 beta 0.4,
     n-step 3, lr 6.25e-5: rlpyt_tpu/experiments/configs/atari_dqn.py:52
     at the flagship's geometry) for a few iterations through
     MinibatchRl, check finite losses and priorities, priorities > 0 on
     every written row, importance weights in (0, 1], one frame-gather
     launch per update, and a prioritized batch against the CPU path;
 11. the MinAtar-Breakout flagship of bench.py:44-58, on flat replay:
     (a) each of the five MinAtar games steps 8192 lanes for 64 steps on
     the card and on the CPU from the same draws and actions (made once on
     a CPU generator; resets after every done, sticky actions, spawns, a
     time limit of 40 so that truncations happen) and must give equal
     observations, rewards, dones and timeouts, bit for bit; (b) trains
     the flagship (full width, B=8192, T=32, update batch 8192, replay 4M,
     replay ratio 1, n-step 3, double DQN) for 3 iterations through
     MinibatchRl after its 100 decorrelation steps: finite losses, replay
     ratio 1, no frame-gather launch; (c) a flat uniform batch of the
     trained ring and a flat prioritized batch (its rows refilled from
     that ring, priorities scattered) equal the CPU path's bit for bit;
 12. the MinAtar policy-gradient configs of
     rlpyt_tpu_torch/experiments/configs/minatar_pg.py: (a) one recurrent
     PPO and one recurrent A2C optimize on the card (K3a, K3, K4) against
     the same calls on the CPU (plain versions), TF32 off, from the same
     weights, batch and permutations; (b) lstm_ppo through build_and_train
     at the config's widths (B=128, T=16, LSTM 128, PPO 4 x 4, evaluation
     on 32 lanes) for 4 iterations: finite losses, completed evaluation
     episodes, and exactly the path's K3a, K3 and K4 launches; (c) a2c,
     ppo and lstm_a2c for 2 iterations each, the feedforward two with no
     LSTM launch; (d) K3a, K3 and K4 against their plain versions and
     timed at the PG shapes (F=135, H=128).
 13. continuous control: (a) Pendulum, ContinuousMountainCar, Reacher,
     Hopper2D and Cheetah2D each step 1024 lanes for 64 steps on the card
     and on the CPU from the same draws and actions, the card from the
     CPU's state each step, to float32 rounding (the locomotion envs to
     a stated tolerance); (b) SAC trains Hopper2D at full width
     (tests/test_locomotion.py:59-72: MLPs of 256, 256, B=32, T=32,
     batch 256, 256 updates an iteration from 2000 steps on) for 4
     iterations after 100 decorrelation steps through MinibatchRl:
     finite losses and alpha, the update count of each iteration, alpha
     moved; env-steps/s and host ms an env step and an update; (c) one
     update of DDPG and SAC and two of TD3 on the card against the CPU;
     (d) one recurrent Gaussian PPO optimize (MujocoLstmModel, LSTM 256,
     a [256, 8] Hopper2D batch) on the card against the CPU, with its
     exact K3a, K3 and K4 launches; (e) K3a, K3 and K4 against their
     plain versions and timed at MujocoLstmModel's shapes (F=260,
     H=256).
 14. the DQN family as users launch it, through
     rlpyt_tpu_torch/experiments/scripts/minatar_dqn.py:build_and_train:
     (a) each of its five configs (dqn, dqn_pub, ernbw, ernbw_vec, r2d1)
     at the config's widths, batch, replay ratio, optimizer and epsilon
     schedule on MinAtar Breakout (conv 16, fc 128 or LSTM 128; B=64,
     T=32 or 40) for a few iterations past min_steps_learn, evaluating
     after each: finite losses, the update count, the Eval keys, and for
     ernbw and ernbw_vec priorities finite and above 0; env-steps/s for
     each iteration; (b) for r2d1 the K3a, K3 (with its one-step launches)
     and K4 launches of every iteration, and its sequence windows on the
     card against the CPU path's; (c) one dqn_pub update (centered
     RMSprop) and one dqn update (Adam), through make_optimizer, on the
     card against the CPU; (d) K3a, K3 and K4 against their plain versions
     and timed at the r2d1 config's shapes (F=1031, H=128); (e) the r2d1
     run's params.pkl snapshot loaded back into a model on the card gives
     the live model's Q values.
 15. the host-env path, through
     rlpyt_tpu_torch/experiments/scripts/atari_dqn.py's build_runner (what
     build_and_train trains) on FakeALE (env.fake=True), its farms
     required to have spawned with the C barrier: (a) a 32-env
     SharedMemVecEnv of AtariEnv(FakeALE), sync="c", steps
     200 times beside a SerialVecEnv from the same seeds and actions,
     bit for bit (observations, rewards, dones, timeouts, game_score,
     traj_done); host ms a farm step; (b) dqn, (c) ernbw, (d) r2d1 at the
     configs' widths (Nature CNN, 32 lanes; dqn/ernbw T=4, batch 32, 32
     updates an iteration, 1M-frame replay; r2d1 LSTM 512, T=40, one
     update of 32 windows of 125 rows) for three learning iterations,
     evaluating on 4 lanes after each (cuts: n_steps, the log interval,
     min_steps_learn, the evaluation caps): finite losses, the update
     count, the Eval and GameScore columns, one frame gather an update
     (dqn, ernbw), the K3a, K3 (with its one-step launches) and K4
     launches of every r2d1 iteration, ernbw's priorities and importance
     weights, r2d1's priorities; env-steps/s of each iteration, host ms
     a farm step, the rest of a collection step and an update; (e) dqn
     under AsyncHostRl (learner thread and stream) for 12 iterations:
     finite losses, one gather an update, the actor's parameters at most
     2 batches behind, env-steps/s up to the learner's last optimize;
     (f) the frame gather at batch 32 on the filled 1M-frame ring (U=5,
     U=7) bit for bit against its plain version at offsets past 2^32, and
     K3a, K3, K4 at the r2d1 config's shapes (F=6917, H=512), checked and
     timed as in phases 5 and 6.
 16. the rest of the single-device runner: (a) in a child process with
     CUBLAS_WORKSPACE_CONFIG=:4096:8 and deterministic algorithms, the
     flagship DQN of phase 4 (replay cut to 100,000 so that a checkpoint
     stays under 1 GB) for 4 intervals, then 2 with checkpoint_dir and a
     fresh runner resumed to 4: every tensor of state_dict() and every
     logged row (time columns aside) equal bit for bit, the frame gather
     launched in the resumed part, the checkpoint's size and its save and
     load times; (b) in the same child, the torch form of example 5 (R2D1,
     LSTM 128, under AsyncRl(pipeline_depth=2); cuts: n_steps, the log
     interval) equal bit for bit to MinibatchRl, a resume from its
     interval-2 checkpoint equal to the uninterrupted run, exact K3a, K3
     (T=1 and windows) and K4 launches, and every host sync of the AsyncRl
     run (torch's sync debug mode) by source line and part of the run; (c)
     AsyncRlEval(pipeline_depth=3): each evaluation ran on its own
     interval's parameters; (d) one wait-reset batch of the lstm_ppo agent
     on MinAtar Breakout: frozen lanes stay done with reward 0 and their
     observation, none waits after the batch, and
     process_returns(mid_batch_reset=False) card against CPU to 1e-4;
     (e) utils/profiling.py: trace names lstm_fwd_kernel and the frame
     gather, time_fn within 20 % of time_ms on one K3 call,
     device_memory_stats not empty; (f) example 5's env-steps/s under
     MinibatchRl and AsyncRl in turns (M, A, A, M).
 17. data-parallel SyncRl (rlpyt_tpu_torch/runners/sync.py), ranks
     spawned: (a) in a deterministic child, the r2d1 config of
     minatar_dqn.py with 14a's cuts under SyncRl(MeshSpec(dp=1)), a
     world of one on NCCL, equal bit for bit to MinibatchRl in every
     state leaf and logged row, with 14b's K3a/K3/K4 launches, and
     resumed after 2 of 4 intervals equal to the whole run; (b) the
     flagship DQN over two gloo ranks sharing the card for 4 iterations:
     each rank's frame ring [size_T, 64, 8320], parameters equal over
     ranks, one gather an update on each; and one flagship update by two
     ranks, each with its lanes of a common replay, against one process
     in parameters, diagnostics and Adam moments (rtol 2e-3, atol 2e-4,
     TF32 off); (c) r2d1 over two gloo ranks:
     parameters and priority tables equal over ranks, finite losses and
     priorities; (d) minatar_pg.py's ppo over two gloo ranks, and one ppo
     optimize by two ranks against one process to the same tolerance; (e)
     the torch example 4 (NCCL, a world of one) at a cut n_steps; (f)
     DqnMlpModel(256, 512) on CartPole under MeshSpec(dp=1, mp=2) over
     gloo, evaluating and writing checkpoints: the 512 x 256 weight a
     DTensor split on mp, the run equal to MinibatchRl to that
     tolerance; a line of the kernels' launches per
     rank; (g) readings: r2d1 env-steps/s under SyncRl(dp=1) and
     MinibatchRl in turns (S, M, M, S), the host ms of one gradient
     all-reduce, and the dp = 2 rates (two ranks on one card).
 18. the last gaps against the JAX package: (a) Conv2dHeadModel at
     MinAtar widths (conv 16 3x3 on [4, 10, 10], head 128, 6 outputs),
     ReLU and tanh, forward and backward on the card against the CPU from
     the same weights and inputs, TF32 off; (b) the R2D1 twin of
     tests/test_learning_coverage.py:54 (LSTM 128, B=32, T=40, 32 windows
     of 10 + 20 + 3 rows, prioritized sequence replay, replay ratio 1)
     through MinibatchRl for 4 iterations, the last 3 learning (cuts:
     n_steps, the log interval): finite losses and priorities, the update count, and K3a,
     K3 (with its one-step launches) and K4 launches equal to the count
     the config predicts; (c) K3a, K3 and K4 against their plain versions
     and timed at the twin's shapes (F=1031, H=128; burn-in T=10,
     training T=23, collection T=1 at B=32, evaluation T=1 at B=8).

The last lines are the card's name and power limit, one JSON line with
the kernels' numbers and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.

    python3 chip_smoke.py --kernels-only

runs phases 1, 2, 3, 5 and 6 alone (no trainer) and prints the same
``kernels`` line for their seven kernels, with null launch counts and no
result line: the quick loop while a kernel is being worked on, and the way
to compare two trees on one card.

    python3 chip_smoke.py --phase16

builds the kernels and runs phase 16 alone (about 90 s), with no result
line.

    python3 chip_smoke.py --phase17

builds the kernels and runs phase 17 alone, with no result line.

    python3 chip_smoke.py --phase18

builds the kernels and runs phase 18 alone (its ``kernels`` line, no
result line).
"""
from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import torch

import bench_torch_gather_formulations as harness
from rlpyt_tpu_torch.runners.sync import SyncRl
from rlpyt_tpu_torch.utils.cuda_timing import graph_ms, time_ms

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12       # H100 SXM fp32 rate outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM dense TF32 tensor-core rate
N_ITR = 4                    # trainer iterations; the first one warms up
B, T = 128, 32               # flagship env lanes and steps per iteration
LSTM_F, LSTM_H = 6919, 512   # R2D1's LSTM input (conv 6912 + 6 + 1), size
R2D1_ITR = 6                 # R2D1 iterations; updates start in the third
R2D1_B, R2D1_T = 64, 40      # R2D1 env lanes and steps per iteration
ERNBW_ITR = 3                # "ernbw" iterations, 128 updates each
MINATAR_ITR = 3              # MinAtar iterations, 32 updates each
MINATAR_B, MINATAR_T = 8192, 32   # bench.py's MinAtar lanes and steps
MINATAR_MODEL = dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                     paddings=(0,), fc_sizes=(128,))
# minatar_pg.py: lanes, steps, evaluation lanes, LSTM size and its input
# (fc 128 + one-hot of 6 actions + the reward)
PG_B, PG_T, PG_EVAL_B, PG_H, PG_F = 128, 16, 32, 128, 135
PG_ITR = 4                   # lstm_ppo iterations in phase 12b
CONT_B, CONT_STEPS = 1024, 64    # phase 13a: lanes and steps of each env
SAC_ITR = 4                  # SAC Hopper2D iterations in phase 13b
SAC_B, SAC_T = 32, 32        # its env lanes and steps per iteration
# mujoco_pg.py's "ppo" sampler (T=256, B=8) and MujocoLstmModel's LSTM:
# 256 units on [mlp 256, Hopper2D's 3 actions, the reward]
MJ_T, MJ_B, MJ_H, MJ_F = 256, 8, 256, 260
MJ_MINIBATCHES = 2           # recurrent PPO splits the 8 lanes in two


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def random_case(g, size_T, B, F, batch, K, n, dev, mask_dtype=torch.uint8):
    """Ring, starts (some wrapping past the ring's end), lanes, masks.
    The indices are int64, the type the replay buffers pass."""
    ring = torch.randint(0, 256, (size_T, B, F), generator=g, device=dev,
                         dtype=torch.uint8)
    start = torch.randint(0, size_T, (batch,), generator=g, device=dev)
    start[:8] = torch.arange(size_T - 8, size_T, device=dev)
    b_idx = torch.randint(0, B, (batch,), generator=g, device=dev)
    masks = torch.randint(0, 2, (2, batch, K), generator=g, device=dev,
                          dtype=torch.uint8).to(mask_dtype)
    return ring, start, b_idx, masks[0].contiguous(), masks[1].contiguous()


def hold_gather(fg, name, ring, start, b_idx, ma, mt, k, nn):
    """The gather against its plain version, bit-exact, with int64
    indices (the trainers' type) and with int32 ones (the kernel has an
    instantiation for each).  Returns the max abs error."""
    ref = fg.gather_frame_stacks_plain(ring, start, b_idx, ma, mt, k, nn)
    worst = 0
    for cast in (torch.Tensor.long, torch.Tensor.int):
        out = fg.gather_frame_stacks(ring, cast(start), cast(b_idx), ma,
                                     mt, k, nn)
        torch.cuda.synchronize()
        err = max(int((o.int() - r.int()).abs().max()) for o, r in
                  zip(out, ref))
        if err != 0 or any(o.shape != r.shape for o, r in zip(out, ref)):
            fail(f"frame gather differs from plain ({name}, "
                 f"{cast(start).dtype} indices): max err {err}")
        worst = max(worst, err)
    print(f"gather check {name}: bit-exact (int64 and int32 indices)")
    return worst


def check_gather(fg, g, dev):
    """Phase 2: kernel vs plain, bit-exact, every case with int64 and
    int32 indices.  Returns the flagship case's max abs error."""
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
        err = hold_gather(fg, name, ring, start, b_idx, ma, mt, k, nn)
        if worst is None:
            worst = err
    # Rows that are not 16-byte aligned take the byte path.
    size_T, B, F, batch = 32, 8, 8320, 64
    flat = torch.randint(0, 256, (size_T * B * F + 1,), generator=g,
                         device=dev, dtype=torch.uint8)
    ring = flat[1:].view(size_T, B, F)
    _, start, b_idx, ma, mt = random_case(g, size_T, B, 16, batch, K, n, dev)
    hold_gather(fg, "unaligned ring", ring, start, b_idx, ma, mt, K, n)
    return worst


def time_gather(fg, g, dev, n: int, size_T=1568, B=128, batch=256,
                ring=None):
    """Phase 3 at the flagship replay's shapes (by default) with n-step
    ``n``, on int64 indices as the trainers pass them (the int32
    instantiation's device time beside it).  Index sets rotate so the
    union rows are not left in L2 from the previous call.  ``ring``: the
    caller's [size_T, B, 8320] ring; else one is made, and one of more
    than 2 GB is left unfilled: the times do not depend on its bytes."""
    F, K = 8320, 4
    U = K + n
    if ring is None:
        ring = (torch.randint(0, 256, (size_T, B, F), generator=g,
                              device=dev, dtype=torch.uint8)
                if size_T * B * F <= 2 << 30 else
                torch.empty((size_T, B, F), dtype=torch.uint8, device=dev))
    sets = []
    for _ in range(16):
        _, start, b_idx, ma, mt = random_case(g, size_T, B, 16, batch, K, n,
                                              dev)
        rows = (start[:, None] + torch.arange(U, device=dev)) % size_T
        flat = rows * B + b_idx[:, None]                         # [batch, U]
        both = torch.cat([flat[:, :K], flat[:, n:n + K]], 1).reshape(-1)
        sets.append((start, b_idx, ma, mt, both, start.int(), b_idx.int()))
    ring2d = ring.view(size_T * B, F)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    def kernel():
        s, b, ma, mt = nxt()[:4]
        fg.gather_frame_stacks(ring, s, b, ma, mt, K, n)

    def kernel_int32():
        _, _, ma, mt, _, s, b = nxt()
        fg.gather_frame_stacks(ring, s, b, ma, mt, K, n)

    def plain():
        s, b, ma, mt = nxt()[:4]
        fg.gather_frame_stacks_plain(ring, s, b, ma, mt, K, n)

    def library():   # one indexed call, same output bytes, no masking
        torch.index_select(ring2d, 0, nxt()[4])

    time_ms(kernel)   # the first timed loop of a process reads slow
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    # Two passes over the index sets in one graph: 32 launches.
    device_ms = graph_ms([kernel] * (2 * len(sets)))
    device_int32_ms = graph_ms([kernel_int32] * (2 * len(sets)))
    library_device_ms = graph_ms([library] * (2 * len(sets)))
    n_bytes = batch * (U + 2 * K) * F + batch * (8 + 8 + 2 * K)
    return {"ms": ms, "device_ms": device_ms,
            "device_int32_ms": device_int32_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": n_bytes}


def lstm_case(g, T, B, F, H, dev):
    """Random LSTM inputs with random dones; weights scaled so the gate
    pre-activations are O(1)."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    return dict(
        wx=randn(F, 4 * H, scale=F ** -0.5), wh=randn(H, 4 * H,
                                                     scale=H ** -0.5),
        b=randn(4 * H, scale=0.1), x=randn(T, B, F),
        done=torch.rand((T, B), generator=g, device=dev) < 0.1,
        h0=randn(B, H, scale=0.5), c0=randn(B, H, scale=0.5))


def rel_err(out, ref) -> tuple:
    """(max |out - ref|, that over max |ref|)."""
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


# R2D1's shapes (update window, burn-in, collection step), B = 128 (more
# rows than one stage of staged h holds), then ragged ones: H = 102 leaves
# the last CTA two live units; B = 37 spans two row blocks, the second
# ragged.
R2D1_CASES = [(45, 32, LSTM_F, LSTM_H), (20, 32, LSTM_F, LSTM_H),
              (1, 64, LSTM_F, LSTM_H), (5, 128, 33, LSTM_H),
              (7, 3, 130, 100), (3, 37, 33, 102), (1, 5, 33, 102)]
# minatar_pg.py's LSTM shapes: the recurrent PPO minibatch window, the
# A2C window, a collection step, an evaluation step.
PG_CASES = [(PG_T, PG_B // 4, PG_F, PG_H), (PG_T, PG_B, PG_F, PG_H),
            (1, PG_B, PG_F, PG_H), (1, PG_EVAL_B, PG_F, PG_H)]
# MujocoLstmModel's shapes: a recurrent PPO minibatch window, the whole
# batch, a collection step.
MUJOCO_CASES = [(MJ_T, MJ_B // MJ_MINIBATCHES, MJ_F, MJ_H),
                (MJ_T, MJ_B, MJ_F, MJ_H), (1, MJ_B, MJ_F, MJ_H)]


def check_lstm(L, g, dev, cases=R2D1_CASES, suffix=""):
    """Phase 5 (and 12d at the PG shapes): K3a, K3 and K4 against their
    plain versions on the card, and the autograd Function's grads against
    autograd through the plain forward.  fp32 with TF32 off on both sides;
    the kernels sum in another order than cuBLAS, so forward results must
    agree to 1e-4 of the largest reference value and backward results (a
    reverse recurrence) to 1e-3.  K3 and K4 run twice on the same inputs
    and must give the same bits.  Returns the max abs error of each kernel
    (K3's one-step shape, T=1, as ``lstm_fwd_t1``), each name followed by
    ``suffix``."""
    worst = {name + suffix: 0.0 for name in
             ("lstm_input_proj", "lstm_fwd", "lstm_fwd_t1", "lstm_bwd")}

    def hold(kernel, what, out, ref, tol):
        kernel += suffix
        err, rel = rel_err(out, ref)
        if not (rel <= tol) or out.shape != ref.shape:
            fail(f"{kernel} differs from plain ({what}): max err {err:.3g}"
                 f" = {rel:.3g} of max|ref|, tolerance {tol:g}")
        worst[kernel] = max(worst[kernel], err)

    for T, B, F, H in cases:
        name = f"T={T} B={B} F={F} H={H}"
        a = lstm_case(g, T, B, F, H, dev)
        mask = (~a["done"]).float()
        x2 = a["x"].view(T * B, F)
        xg = L.input_proj_plain(x2, a["wx"], a["b"])
        hold("lstm_input_proj", name, L.input_proj(x2, a["wx"], a["b"]),
             xg, 1e-4)
        xg = xg.view(T, B, 4 * H)
        ref = L.lstm_fwd_plain(xg, a["wh"], mask, a["h0"], a["c0"])
        out = L.lstm_fwd(xg, a["wh"], mask, a["h0"], a["c0"])
        fwd = "lstm_fwd_t1" if T == 1 else "lstm_fwd"
        for what, o, r in zip(("y", "gates", "c", "hT", "cT"), out, ref):
            hold(fwd, f"{name} {what}", o, r, 1e-4)
        again = L.lstm_fwd(xg, a["wh"], mask, a["h0"], a["c0"])
        if not all(torch.equal(o, r) for o, r in zip(out, again)):
            fail(f"lstm_fwd gives other bits on a second run ({name})")
        _, gates, cs, _, _ = ref
        dy = torch.randn((T, B, H), generator=g, device=dev)
        dcT = torch.randn((B, H), generator=g, device=dev)
        ref = L.lstm_bwd_plain(gates, cs, a["c0"], mask, a["wh"], dy, dcT)
        out = L.lstm_bwd(gates, cs, a["c0"], mask, a["wh"], dy, dcT)
        for what, o, r in zip(("dgates", "dh0", "dc0"), out, ref):
            hold("lstm_bwd", f"{name} {what}", o, r, 1e-3)
        again = L.lstm_bwd(gates, cs, a["c0"], mask, a["wh"], dy, dcT)
        if not all(torch.equal(o, r) for o, r in zip(out, again)):
            fail(f"lstm_bwd gives other bits on a second run ({name})")

        # The autograd Function (kernels) against autograd through the
        # plain forward.
        names = ("wx", "wh", "b", "x", "h0", "c0")
        leaves = {k: a[k].clone().requires_grad_(True) for k in names}
        cot = [torch.randn(s, generator=g, device=dev)
               for s in ((T, B, H), (B, H), (B, H))]

        def objective(y, hT, cT):
            return sum((o * c).sum() for o, c in zip((y, hT, cT), cot))

        y, (hT, cT) = L.lstm(leaves["wx"], leaves["wh"], leaves["b"],
                             leaves["x"], a["done"], leaves["h0"],
                             leaves["c0"])
        got = torch.autograd.grad(objective(y, hT, cT),
                                  [leaves[k] for k in names])
        xg = L.input_proj_plain(leaves["x"].view(T * B, F), leaves["wx"],
                                leaves["b"]).view(T, B, 4 * H)
        y, _, _, hT, cT = L.lstm_fwd_plain(xg, leaves["wh"], mask,
                                           leaves["h0"], leaves["c0"])
        want = torch.autograd.grad(objective(y, hT, cT),
                                   [leaves[k] for k in names])
        for k, o, r in zip(names, got, want):
            hold("lstm_bwd", f"{name} d{k} (autograd)", o, r, 1e-3)
        print(f"lstm check {name}: kernels agree with plain, K3 and K4 "
              "bit-identical over two runs")
    # A W_x that is not 16-byte aligned (a view one float into a buffer)
    # takes K3a's generic kernel.
    M, F, N = 70, 130, 400
    x = torch.randn((M, F), generator=g, device=dev)
    flat = torch.randn((F * N + 1,), generator=g, device=dev) * F ** -0.5
    wx, b = flat[1:].view(F, N), torch.randn((N,), generator=g, device=dev)
    hold("lstm_input_proj", "unaligned W_x", L.input_proj(x, wx, b),
         L.input_proj_plain(x, wx, b), 1e-4)
    print("lstm check unaligned W_x: K3a agrees with plain")
    return worst


def cudnn_lstm(c, dev):
    """cuDNN's LSTM with the weights of case ``c`` (gate order i, f, g, o),
    no dones.  It also computes the input projection (forward) and the
    weight and input gradients (backward): more work than K3 and K4
    alone."""
    F, H = c["wx"].shape[0], c["wh"].shape[0]
    cudnn = torch.nn.LSTM(F, H).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(c["wx"].T)
        cudnn.weight_hh_l0.copy_(c["wh"].T)
        cudnn.bias_ih_l0.copy_(c["b"])
        cudnn.bias_hh_l0.zero_()
    return cudnn, (c["h0"][None], c["c0"][None])


def fwd_times(L, c, dev, iters, graph_len):
    """K3 on case ``c`` beside its plain version and cuDNN's forward."""
    Tc, Bc = c["done"].shape
    F, H = c["wx"].shape[0], c["wh"].shape[0]
    m = (~c["done"]).float()
    xgc = L.input_proj_plain(c["x"].view(Tc * Bc, F), c["wx"],
                             c["b"]).view(Tc, Bc, 4 * H)
    args = (xgc, c["wh"], m, c["h0"], c["c0"])
    cudnn, state = cudnn_lstm(c, dev)

    def library():
        with torch.no_grad():
            cudnn(c["x"], state)

    return dict(
        ms=time_ms(lambda: L.lstm_fwd(*args), iters),
        device_ms=graph_ms([lambda: L.lstm_fwd(*args)] * graph_len),
        plain_ms=time_ms(lambda: L.lstm_fwd_plain(*args), 10),
        library_ms=time_ms(library, 10),
        library_device_ms=graph_ms([library] * graph_len),
        # h @ W_h, plus ~10 operations per cell for the gates
        ops=2 * Tc * Bc * H * 4 * H + 10 * Tc * Bc * H,
        # xg, W_h, mask, h0, c0 in; y, gates, c, hT, cT out
        bytes=4 * (Tc * Bc * 4 * H + H * 4 * H + Tc * Bc + 2 * Bc * H
                   + Tc * Bc * (H + 4 * H + H) + 2 * Bc * H))


def bwd_times(L, c, g, dev, iters, graph_len):
    """K4 on case ``c`` beside its plain version and cuDNN's backward."""
    Tc, Bc = c["done"].shape
    F, H = c["wx"].shape[0], c["wh"].shape[0]
    mask = (~c["done"]).float()
    xg = L.input_proj_plain(c["x"].view(Tc * Bc, F), c["wx"],
                            c["b"]).view(Tc, Bc, 4 * H)
    _, gates, cs, _, _ = L.lstm_fwd_plain(xg, c["wh"], mask, c["h0"],
                                          c["c0"])
    dy = torch.randn((Tc, Bc, H), generator=g, device=dev)
    dcT = torch.randn((Bc, H), generator=g, device=dev)
    args = (gates, cs, c["c0"], mask, c["wh"], dy, dcT)
    cudnn, state = cudnn_lstm(c, dev)
    x_leaf = c["x"].clone().requires_grad_(True)
    out, _ = cudnn(x_leaf, state)
    cudnn_params = [x_leaf] + list(cudnn.parameters())

    def library():
        torch.autograd.grad(out, cudnn_params, dy, retain_graph=True)

    return dict(
        ms=time_ms(lambda: L.lstm_bwd(*args), iters),
        device_ms=graph_ms([lambda: L.lstm_bwd(*args)] * graph_len),
        plain_ms=time_ms(lambda: L.lstm_bwd_plain(*args), 10),
        library_ms=time_ms(library, 10),
        # dgates @ W_h^T, plus ~20 operations per cell
        ops=2 * Tc * Bc * 4 * H * H + 20 * Tc * Bc * H,
        # gates, c, c0, mask, W_h, dy, dcT in; dgates, dh0, dc0 out
        bytes=4 * (Tc * Bc * 4 * H + Tc * Bc * H + Bc * H + Tc * Bc
                   + H * 4 * H + Tc * Bc * H + Bc * H
                   + Tc * Bc * 4 * H + 2 * Bc * H))


def proj_times(L, x, weights, b, iters):
    """K3a on ``x`` beside its plain version and ``torch.addmm``: call
    times by events and device times by graph replay.  ``weights``
    rotate, so that a W_x that is too large for L2 is read cold."""
    ws = itertools.cycle(weights)
    M, F = x.shape
    N = weights[0].shape[1]

    def kernel():
        L.input_proj(x, next(ws), b)

    def library():
        torch.addmm(b, x, next(ws))

    return dict(
        ms=time_ms(kernel, iters),
        plain_ms=time_ms(lambda: L.input_proj_plain(x, next(ws), b), iters),
        library_ms=time_ms(library, iters),
        device_ms=graph_ms([kernel] * 10),
        library_device_ms=graph_ms([library] * 10),
        ops=2 * M * F * N, bytes=4 * (M * F + F * N + N + M * N))


def add_bounds(res: dict):
    """Each entry's bound: its operations at the fp32 pipes' rate or its
    bytes at HBM's, the larger time.  K3a (``lstm_input_proj*``) runs on
    the tensor cores, three TF32 products for each fp32 one: that is its
    bound, with what the fp32 pipes could do at best (the bound of the
    kernel before the redesign) kept beside it."""
    for name, r in res.items():
        t_ops = r["ops"] / FP32_OPS_PER_S * 1e3
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        if name.startswith("lstm_input_proj"):
            r["bound_ffma_ms"] = max(t_ops, t_bytes)
            t_ops = 3 * r["ops"] / TF32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


def time_lstm(L, g, dev):
    """Phase 6: each LSTM kernel at the update's shapes (T=45, B=32,
    F=6919, H=512) beside its plain version, its bound and one library
    call, by CUDA events; K3 also at the collection's shape (T=1,
    B=R2D1_B) as its own entry, and at the burn-in's (T=20, B=32) in a
    printed line."""
    T, B, F, H = 45, 32, LSTM_F, LSTM_H
    a = lstm_case(g, T, B, F, H, dev)
    x2 = a["x"].view(T * B, F)
    # The collection's shape: one step of R2D1_B lanes, M = 64.  There the
    # product streams W_x (56.7 MB; two copies exceed the 50 MB L2).
    x64 = torch.randn((R2D1_B, F), generator=g, device=dev)
    res = add_bounds({
        "lstm_input_proj": proj_times(L, x2, [a["wx"]], a["b"], 20),
        "lstm_input_proj_m64": proj_times(
            L, x64, [a["wx"], a["wx"].clone()], a["b"], 50),
        "lstm_fwd": fwd_times(L, a, dev, 20, 5),
        # One collection step (T=1, B=R2D1_B): 40 of K3's 48 launches in
        # an R2D1 iteration.  cuDNN's call also does the projection.
        "lstm_fwd_t1": fwd_times(L, lstm_case(g, 1, R2D1_B, F, H, dev), dev,
                                 50, 20),
        "lstm_bwd": bwd_times(L, a, g, dev, 20, 5),
    })
    # The burn-in's shape (T=20, B=32): printed, not an entry of its own.
    t20 = add_bounds({"t20": fwd_times(L, lstm_case(g, 20, 32, F, H, dev),
                                       dev, 20, 5)})["t20"]
    print(f"phase 6: lstm_fwd T=20 B=32 call {t20['ms']:.4f} ms, device "
          f"{t20['device_ms']:.4f} ms; cuDNN call {t20['library_ms']:.4f} "
          f"ms, device {t20['library_device_ms']:.4f} ms; plain "
          f"{t20['plain_ms']:.4f} ms; bound {t20['bound_ms']:.4f} ms by "
          f"{t20['bound_by']}")
    return res


def zero_launches():
    """Set every kernel wrapper's launch count to 0."""
    from rlpyt_tpu_torch.ops import frame_gather as fg
    from rlpyt_tpu_torch.ops import lstm as L
    from rlpyt_tpu_torch.ops import union_gather as ug

    for fn in (fg.gather_frame_stacks, L.input_proj, L.lstm_fwd, L.lstm_bwd,
               ug.gather_union_rows, ug.gather_union_window):
        fn.launches = 0
    L.input_proj.split_launches = 0
    L.lstm_fwd.step_launches = 0


def flagship_agent_algo(dev):
    """The flagship's agent and algorithm (bench_atari.py:139-176: bf16
    Nature CNN, update batch 256, replay ratio 8, replay 200k, double
    DQN, frame replay)."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN

    agent = DqnAgent(model_kwargs=dict(compute_dtype=torch.bfloat16),
                     eps_steps=250_000, eps_final=0.01, device=dev)
    algo = DQN(discount=0.99, batch_size=256, min_steps_learn=0,
               replay_size=200_000, replay_ratio=8.0,
               target_update_interval=2_500, learning_rate=2.5e-4,
               double_dqn=True, n_step_return=1, frame_buffer=True,
               frames_per_obs=4)
    return agent, algo


def build_flagship_runner(dev, n_itr: int, logger=None, runner_cls=None,
                          **runner_kwargs):
    """The flagship Nature-CNN DQN trainer of bench_atari.py:139-176
    (B=128, T=32) on the port, one iteration per log row; MinibatchRl
    unless ``runner_cls`` is given."""
    from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    agent, algo = flagship_agent_algo(dev)
    return (runner_cls or MinibatchRl)(
        algo, agent, SyntheticAtariEnv(dev), BatchSpec(T=T, B=B),
        n_steps=n_itr * T * B, seed=0, log_interval_steps=T * B,
        max_decorrelation_steps=0, logger=logger, device=dev,
        **runner_kwargs)


def row_logger():
    """A TabularLogger that keeps each logged row instead of printing it."""
    from rlpyt_tpu_torch.utils.logging import TabularLogger

    class RowLogger(TabularLogger):
        def __init__(self):
            super().__init__(None)
            self.rows = []

        def dump_tabular(self, print_fn=print):
            self.rows.append(dict(self._tabular))
            super().dump_tabular(print_fn=None)

    return RowLogger()


def run_trainer(dev):
    """Phase 4: the flagship trainer through MinibatchRl."""
    from rlpyt_tpu_torch.ops import frame_gather as fg

    logger = row_logger()
    runner = build_flagship_runner(dev, N_ITR, logger)
    algo = runner.algo
    zero_launches()
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


def build_r2d1_runner(dev, n_itr: int, logger=None):
    """The Atari-geometry R2D1 trainer of bench_r2d1.py:68-104 at its first
    geometry (:136): Nature-CNN 104x80x4 -> LSTM 512 -> dueling Q, bf16
    convs and heads, B=64, T=40, 32 windows of 20 burn-in + 40 training
    + 5 n-step rows, prioritized frame-compressed sequence replay of 100k,
    replay ratio 1 (2 updates per iteration).  One cut: learning starts
    at 3*T*B env steps instead of 0, when the first whole windows exist."""
    from rlpyt_tpu_torch.agents.dqn import R2d1Agent
    from rlpyt_tpu_torch.algos.r2d1 import R2D1
    from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    agent = R2d1Agent(model_kwargs=dict(compute_dtype=torch.bfloat16),
                      eps_steps=250_000, eps_final=0.1, eps_final_min=0.0005,
                      lstm_size=LSTM_H, device=dev)
    algo = R2D1(discount=0.997, batch_b=32, batch_T=R2D1_T, warmup_T=20,
                min_steps_learn=3 * R2D1_T * R2D1_B, replay_size=100_000,
                replay_ratio=1.0, target_update_interval=1_000,
                learning_rate=1e-4, double_dqn=True, prioritized_replay=True,
                frame_compress=True, frames_per_obs=4, input_priorities=True)
    return MinibatchRl(algo, agent, SyntheticAtariEnv(dev),
                       BatchSpec(T=R2D1_T, B=R2D1_B),
                       n_steps=n_itr * R2D1_T * R2D1_B, seed=0,
                       log_interval_steps=R2D1_T * R2D1_B,
                       max_decorrelation_steps=0, logger=logger, device=dev)


def run_r2d1(L, dev):
    """Phase 7: the R2D1 trainer through MinibatchRl.  Checks finite
    losses and priorities and that every LSTM call of the run went
    through the kernels: per iteration T collection steps (one K3a and
    one K3 launch each, K3 at T=1), per update 4 forward calls (online
    and target, burn-in and training window) and one backward (K4)."""
    from rlpyt_tpu_torch.ops import frame_gather as fg

    logger = row_logger()
    runner = build_r2d1_runner(dev, R2D1_ITR, logger)
    algo = runner.algo
    zero_launches()
    runner.train()
    torch.cuda.synchronize()
    launches = {"lstm_input_proj": L.input_proj.launches,
                "lstm_input_proj_split": L.input_proj.split_launches,
                "lstm_fwd": L.lstm_fwd.launches,
                "lstm_fwd_step": L.lstm_fwd.step_launches,
                "lstm_bwd": L.lstm_bwd.launches}
    updates = algo.update_counter
    learning_itrs = sum(1 for i in range(1, R2D1_ITR + 1)
                        if i * R2D1_T * R2D1_B >= algo.min_steps_learn)
    if updates != learning_itrs * algo.updates_per_optimize or updates == 0:
        fail(f"R2D1 ran {updates} updates, expected "
             f"{learning_itrs * algo.updates_per_optimize}")
    want = {"lstm_input_proj": R2D1_ITR * R2D1_T + 4 * updates,
            "lstm_input_proj_split": R2D1_ITR * R2D1_T,
            "lstm_fwd": R2D1_ITR * R2D1_T + 4 * updates,
            "lstm_fwd_step": R2D1_ITR * R2D1_T,
            "lstm_bwd": updates}
    if launches != want:
        fail(f"LSTM launches {launches}, expected {want}")
    if fg.gather_frame_stacks.launches != 0:
        fail("R2D1's sequence replay launched the frame-gather kernel")
    for row in logger.rows[-(learning_itrs):]:
        for key in ("loss", "grad_norm", "td_abs_err"):
            if not (math.isfinite(row[key]) and row[key] > 0):
                fail(f"R2D1 {key} = {row[key]} in iteration "
                     f"{row['Iteration']}")
    replay = algo.replay
    if not (torch.isfinite(replay.priorities).all()
            and torch.isfinite(replay.max_priority)):
        fail("non-finite priority in R2D1's replay")
    for r in logger.rows:
        print(f"r2d1 itr {r['Iteration']}: loss {r['loss']:.6g} "
              f"grad_norm {r['grad_norm']:.6g} "
              f"td_abs_err {r['td_abs_err']:.6g} "
              f"env-steps/s {r['StepsPerSecond']:.1f}")
    return runner, launches, [r["StepsPerSecond"] for r in logger.rows]


def check_windows_against_cpu(runner, dev):
    """The card's sequence windows must equal the CPU path's, bit for
    bit, for the same (slot_idx, b_idx)."""
    replay = runner.algo.replay
    g = torch.Generator(device=dev).manual_seed(321)
    slot_idx, b_idx, w = replay.sample_idxs(32, g)
    gpu = replay.extract_window(slot_idx, b_idx, w)
    cpu_replay = copy.copy(replay)
    cpu_replay.data = type(replay.data)(*(x.cpu() for x in replay.data))
    cpu_replay.rnn_state = tuple(x.cpu() for x in replay.rnn_state)
    cpu_replay.device = torch.device("cpu")
    cpu = cpu_replay.extract_window(slot_idx.cpu(), b_idx.cpu(), w.cpu())
    for name in ("observation", "action", "reward", "done", "prev_action",
                 "prev_reward", "init_rnn_state"):
        got, want = getattr(gpu, name), getattr(cpu, name)
        if name == "init_rnn_state":    # (h, c)
            same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        else:
            same = torch.equal(got.cpu(), want)
        if not same:
            fail(f"sequence window {name} differs between card and CPU")
    print("sequence windows on the card equal the CPU path: bit-exact")


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


def check_union(ug, g, dev):
    """Phase 8: K5 and K6 against their plain versions on the card, bit
    for bit.  Returns the largest abs error of each at the harness's
    shapes (the ragged cases fail on any difference)."""
    def hold(what, ring, ring_lm, start, b_idx, U):
        errs = []
        for name, out, ref in (
                ("union row gather",
                 ug.gather_union_rows(ring, start, b_idx, U),
                 ug.gather_union_rows_plain(ring, start, b_idx, U)),
                ("union window gather",
                 ug.gather_union_window(ring_lm, start, b_idx, U),
                 ug.gather_union_window_plain(ring_lm, start, b_idx, U))):
            torch.cuda.synchronize()
            err = int((out.int() - ref.int()).abs().max()) \
                if out.shape == ref.shape else -1
            if err != 0:
                fail(f"{name} differs from plain ({what}): max err {err}")
            errs.append(err)
        print(f"union gather check {what}: both bit-exact")
        return errs

    ring, ring_lm, sets = harness.make_case(g, dev, n_sets=2)
    for start, b_idx in sets:
        worst = hold("harness shapes, wrap-around starts", ring, ring_lm,
                     start, b_idx, harness.U)
    del ring, ring_lm, sets
    torch.cuda.empty_cache()
    # Ragged rows take the byte path (F = 8321: a window of many chunks);
    # U = 1 has no ghost rows; F = 1040 is 65 vectors, a ragged span.
    for size_T, B, F, U, batch in ((9, 5, 130, 1, 3), (9, 5, 130, 7, 3),
                                   (33, 3, 8321, 5, 17), (20, 4, 1040, 11, 9)):
        ring, ring_lm, sets = harness.make_case(g, dev, size_T, B, F, U,
                                                batch, n_sets=1)
        hold(f"size_T={size_T} B={B} F={F} U={U} batch={batch}", ring,
             ring_lm, *sets[0], U)
    # Rings that are not 16-byte aligned take the byte path too.
    size_T, B, F, U = 12, 4, 8320, 7
    _, _, sets = harness.make_case(g, dev, size_T, B, 16, U, 32, n_sets=1)
    flat = torch.randint(0, 256, (size_T * B * F + 1,), generator=g,
                         device=dev, dtype=torch.uint8)
    ring = flat[1:].view(size_T, B, F)
    lm = ug.lane_major_ring(ring, U)
    flat_lm = torch.empty((lm.numel() + 1,), dtype=torch.uint8, device=dev)
    flat_lm[1:] = lm.reshape(-1)
    hold("unaligned rings", ring, flat_lm[1:].view(lm.shape), *sets[0], U)
    return worst


def run_harness(ug, dev):
    """Phase 9: bench_torch_gather_formulations.py's own run (match lines
    and times), with the union kernels' launches counted over it."""
    zero_launches()
    row, window, res = harness.run(dev)
    if not (row and window):
        fail(f"harness: row match {row}, window match {window}")
    launches = {"union_rows": ug.gather_union_rows.launches,
                "union_window": ug.gather_union_window.launches}
    if min(launches.values()) == 0:
        fail(f"the harness did not launch the union kernels: {launches}")

    def entry(kernel, plain, indexed):
        return {"ms": res[kernel]["ms"],
                "device_ms": res[kernel]["device_ms"],
                "plain_ms": res[plain]["ms"],
                "library_ms": res[indexed]["ms"],
                "bound_ms": res[kernel]["bound_ms"], "bound_by": "bytes"}

    times = {"union_rows": entry(harness.ROW_KERNEL, harness.ROW_PLAIN,
                                 harness.ROW_INDEXED),
             "union_window": entry(harness.WINDOW_KERNEL,
                                   harness.WINDOW_PLAIN,
                                   harness.WINDOW_INDEXED)}
    return launches, times


def build_ernbw_runner(dev, n_itr: int, logger=None):
    """The Atari "ernbw" trainer: the algorithm and model settings of
    rlpyt_tpu/experiments/configs/atari_dqn.py:52-59 (categorical 51 atoms
    on [-10, 10], dueling, double, prioritized replay alpha 0.5 beta 0.4,
    n-step 3, lr 6.25e-5) at the flagship's geometry and env
    (bench_atari.py:139-176: B=128, T=32, update batch 256, replay ratio
    8, replay 200k, min_steps_learn 0, bf16, synthetic frames)."""
    from rlpyt_tpu_torch.agents.dqn import CatDqnAgent
    from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
    from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    agent = CatDqnAgent(
        model_kwargs=dict(dueling=True, compute_dtype=torch.bfloat16),
        n_atoms=51, v_min=-10.0, v_max=10.0, eps_steps=250_000,
        eps_final=0.01, device=dev)
    algo = CategoricalDQN(
        discount=0.99, batch_size=256, min_steps_learn=0,
        replay_size=200_000, replay_ratio=8.0, target_update_interval=2_500,
        learning_rate=6.25e-5, double_dqn=True, prioritized_replay=True,
        pri_alpha=0.5, pri_beta=0.4, n_step_return=3, frame_buffer=True,
        frames_per_obs=4)
    return MinibatchRl(algo, agent, SyntheticAtariEnv(dev),
                       BatchSpec(T=T, B=B), n_steps=n_itr * T * B, seed=0,
                       log_interval_steps=T * B, max_decorrelation_steps=0,
                       logger=logger, device=dev)


def run_ernbw(fg, dev):
    """Phase 10: the ernbw trainer through MinibatchRl.  Every update
    draws one prioritized batch through the frame-gather kernel at
    U = K + n = 7."""
    logger = row_logger()
    runner = build_ernbw_runner(dev, ERNBW_ITR, logger)
    algo = runner.algo
    zero_launches()
    runner.train()
    torch.cuda.synchronize()
    launches = fg.gather_frame_stacks.launches
    updates = algo.update_counter
    if updates != ERNBW_ITR * algo.updates_per_optimize:
        fail(f"ernbw ran {updates} updates, expected "
             f"{ERNBW_ITR * algo.updates_per_optimize}")
    if launches != updates:
        fail(f"ernbw: frame gather launched {launches} times for {updates} "
             "updates")
    for row in logger.rows:
        for key in ("loss", "grad_norm", "td_abs_err"):
            if not (math.isfinite(row[key]) and row[key] > 0):
                fail(f"ernbw {key} = {row[key]} in iteration "
                     f"{row['Iteration']}")
    replay = algo.replay
    written = replay.priorities[:replay.filled_t]
    if not (torch.isfinite(written).all() and (written > 0).all()
            and torch.isfinite(replay.max_priority)):
        fail("ernbw: a written row's priority is not finite and positive")
    if replay.filled_t < replay.size_T \
            and (replay.priorities[replay.filled_t:] != 0).any():
        fail("ernbw: an unwritten row has a priority")
    if not (written != 1.0).any():
        fail("ernbw: no priority was written back")
    for r in logger.rows:
        print(f"ernbw itr {r['Iteration']}: loss {r['loss']:.6g} "
              f"grad_norm {r['grad_norm']:.6g} kl {r['td_abs_err']:.6g} "
              f"env-steps/s {r['StepsPerSecond']:.1f} "
              f"updates/s {r['UpdatesPerSecond']:.1f}")
    return runner, launches, [r["StepsPerSecond"] for r in logger.rows]


def check_prioritized_against_cpu(runner, dev):
    """One prioritized batch drawn on the card from injected uniforms,
    against the CPU path on a copy of the trained buffer.

    The batch (kernel path) must equal the CPU path's (plain version) bit
    for bit at the card's indices.  The indices themselves come from a
    float32 prefix sum over 200k priorities, which the card and the CPU
    take in different orders, so they are held against a float64 prefix
    sum on the CPU instead: every drawn row must be sampleable and its
    stratum's target must lie in the row's share of the mass, within
    1e-5 of the total.  The importance weights must lie in (0, 1] and
    agree with the CPU's formula within 1e-5."""
    from rlpyt_tpu_torch.replay.prioritized import importance_weights

    replay = runner.algo.replay
    batch = 256
    g = torch.Generator(device=dev).manual_seed(123)
    u = torch.rand((batch,), generator=g, device=dev)
    t_idx, b_idx, w = replay.idxs_from_uniforms(u)
    gpu = replay.extract_batch(t_idx, b_idx, w)
    cpu_replay = copy.copy(replay)
    cpu_replay.data = type(replay.data)(*(x.cpu() for x in replay.data))
    cpu_replay.priorities = replay.priorities.cpu()
    cpu_replay.max_priority = replay.max_priority.cpu()
    cpu_replay.device = torch.device("cpu")
    t_cpu, b_cpu = t_idx.cpu(), b_idx.cpu()
    cpu = cpu_replay.extract_batch(t_cpu, b_cpu, w.cpu())
    for name in ("action", "return_", "done", "done_n", "timeout_n",
                 "is_weights"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            fail(f"prioritized replay {name} differs between card and CPU")
    for which in ("agent_inputs", "target_inputs"):
        if not torch.equal(getattr(gpu, which).observation.cpu(),
                           getattr(cpu, which).observation):
            fail(f"prioritized replay {which} observation differs between "
                 "card and CPU")

    flat = cpu_replay._masked_priorities().reshape(-1)
    idx = t_cpu * replay.B + b_cpu
    cdf = torch.cumsum(flat.double(), 0)
    total = cdf[-1]
    targets = (torch.arange(batch) + u.cpu().double()) * (total / batch)
    tol = 1e-5 * total
    if not ((flat[idx] > 0).all()
            and (targets >= cdf[idx] - flat[idx].double() - tol).all()
            and (targets <= cdf[idx] + tol).all()):
        fail("a prioritized draw on the card lies outside its stratum")
    w_cpu = importance_weights(flat, idx, total.float(), replay.beta)
    if not ((w > 0).all() and (w <= 1).all()
            and torch.allclose(w.cpu(), w_cpu, rtol=1e-5, atol=0)):
        fail("importance weights on the card are outside (0, 1] or differ "
             "from the CPU's")
    same = int((torch.stack(cpu_replay.idxs_from_uniforms(u.cpu())[:2])
                == torch.stack((t_cpu, b_cpu))).all(0).sum())
    print(f"prioritized batch on the card equals the CPU path: bit-exact; "
          f"draws inside their strata; weights in [{float(w.min()):.4f}, "
          f"{float(w.max()):.4f}]; {same} of {batch} indices equal the CPU's "
          "float32 draws")


def check_minatar_envs(dev):
    """Phase 11a: every MinAtar game, card against CPU, bit for bit, from
    one set of draws and actions made on a CPU generator.  Lanes reset
    after every done, as the collector does; a time limit of 40 makes
    truncations happen within the 64 steps."""
    from rlpyt_tpu_torch.envs.minatar import MINATAR_ENVS
    from rlpyt_tpu_torch.struct import tree_select

    B, n_steps, max_steps = MINATAR_B, 64, 40
    for name, cls in MINATAR_ENVS.items():
        envs = [cls(max_steps=max_steps, device=d) for d in ("cpu", dev)]
        g = torch.Generator().manual_seed(11)
        resets = [envs[0].draw_reset(B, g) for _ in range(n_steps + 1)]
        steps = [envs[0].draw_step(B, g) for _ in range(n_steps)]
        actions = torch.randint(0, 6, (n_steps, B), generator=g)
        states = [env.reset_batch(B, draws=resets[0])[0] for env in envs]
        totals = torch.zeros(3, dtype=torch.float64)
        for i in range(n_steps):
            outs = []
            for k, env in enumerate(envs):
                s, st = env.step_batch(states[k], actions[i].to(env.device),
                                       draws=steps[i])
                reset_state, _ = env.reset_batch(B, draws=resets[i + 1])
                states[k] = tree_select(st.done, reset_state, s)
                outs.append((st.observation, st.reward, st.done,
                             st.info["timeout"]))
            for field, want, got in zip(
                    ("observation", "reward", "done", "timeout"), *outs):
                if not torch.equal(got.cpu(), want):
                    fail(f"minatar {name}: {field} differs between card "
                         f"and CPU at step {i}")
            totals += torch.stack([outs[0][2].sum(), outs[0][3].sum(),
                                   outs[0][1].sum()]).double()
        done, timeout, reward = totals.tolist()
        print(f"phase 11a: minatar {name} B={B} {n_steps} steps equal on "
              f"card and CPU: {done:.0f} dones ({timeout:.0f} time limits), "
              f"reward {reward:.0f}")


def build_minatar_runner(dev, n_itr: int, logger=None):
    """The MinAtar-Breakout DQN flagship of bench.py:44-58: one 3x3 conv
    of 16 and fc 128, fp32, eps to 0.1 over 250k steps; B=8192, T=32,
    update batch 8192, flat uniform replay of 4M, replay ratio 1 (32
    updates an iteration), target update every 500, lr 3e-4, double DQN,
    n-step 3; 100 decorrelation steps.  One iteration per log row."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    agent = DqnAgent(model_kwargs=MINATAR_MODEL, eps_steps=250_000,
                     eps_final=0.1, device=dev)
    algo = DQN(discount=0.99, batch_size=8192, min_steps_learn=0,
               replay_size=4_000_000, replay_ratio=1.0,
               target_update_interval=500, learning_rate=3e-4,
               double_dqn=True, n_step_return=3)
    steps = MINATAR_T * MINATAR_B
    return MinibatchRl(algo, agent, Breakout(device=dev),
                       BatchSpec(T=MINATAR_T, B=MINATAR_B),
                       n_steps=n_itr * steps, seed=0,
                       log_interval_steps=steps, max_decorrelation_steps=100,
                       logger=logger, device=dev)


def run_minatar(fg, dev):
    """Phase 11b: the MinAtar flagship through MinibatchRl, on flat
    replay: the frame gather must not run."""
    from rlpyt_tpu_torch.replay.uniform import UniformReplayBuffer

    logger = row_logger()
    runner = build_minatar_runner(dev, MINATAR_ITR, logger)
    algo = runner.algo
    zero_launches()
    runner.train()
    torch.cuda.synchronize()
    if type(algo.replay) is not UniformReplayBuffer:
        fail(f"minatar: replay is {type(algo.replay).__name__}, not flat")
    if fg.gather_frame_stacks.launches != 0:
        fail("minatar: flat replay launched the frame-gather kernel")
    updates = algo.update_counter
    if updates != MINATAR_ITR * algo.updates_per_optimize:
        fail(f"minatar ran {updates} updates, expected "
             f"{MINATAR_ITR * algo.updates_per_optimize}")
    for row in logger.rows:
        for key in ("loss", "grad_norm", "td_abs_err", "StepsPerSecond"):
            if not math.isfinite(row[key]):
                fail(f"minatar: non-finite {key} in iteration "
                     f"{row['Iteration']}")
        if row["ReplayRatio"] != 1.0:
            fail(f"minatar: replay ratio {row['ReplayRatio']}, not 1")
    for r in logger.rows:
        print(f"minatar itr {r['Iteration']}: loss {r['loss']:.6g} "
              f"grad_norm {r['grad_norm']:.6g} "
              f"td_abs_err {r['td_abs_err']:.6g} "
              f"StepsPerSecond {r['StepsPerSecond']:.1f} "
              f"UpdatesPerSecond {r['UpdatesPerSecond']:.1f} "
              f"ReplayRatio {r['ReplayRatio']}")
    return runner, [r["StepsPerSecond"] for r in logger.rows]


def check_flat_prioritized_against_cpu(runner, dev):
    """Phase 11c, prioritized: a flat prioritized ring of 4 iterations'
    rows, filled with 5 of the trained ring's blocks (so its cursor has
    wrapped) and with priorities written back at random rows, against
    the CPU path as in phase 10."""
    from types import SimpleNamespace

    from rlpyt_tpu_torch.replay.base import SamplesToBuffer
    from rlpyt_tpu_torch.replay.prioritized import PrioritizedReplayBuffer

    src = runner.algo.replay
    T_, B_ = src.sample_T, src.B
    pri = PrioritizedReplayBuffer(size=4 * T_ * B_, B=B_, sample_T=T_,
                                  discount=src.discount,
                                  n_step_return=src.n_step, alpha=0.6,
                                  beta=0.4, device=dev)
    pri.init(SamplesToBuffer(*(x[0, 0] for x in src.data))._replace(
        observation=src.data.observation[0, 0].view(
            src._obs_shapes)))
    n_blocks = src.filled_t // T_
    for k in range(5):
        t0 = (k % n_blocks) * T_
        pri.append(SamplesToBuffer(*(x[t0:t0 + T_] for x in src.data)))
    g = torch.Generator(device=dev).manual_seed(5)
    n = 4 * B_
    rows = (torch.randint(0, pri.size_T, (n,), generator=g, device=dev),
            torch.randint(0, B_, (n,), generator=g, device=dev))
    pri.update_priorities(rows, 4 * torch.rand((n,), generator=g,
                                               device=dev))
    check_prioritized_against_cpu(
        SimpleNamespace(algo=SimpleNamespace(replay=pri)), dev)


def pg_batch(dev):
    """A recurrent PG batch at minatar_pg.py's widths (T=16, B=128,
    [4, 10, 10] planes, 6 actions, H=128) and the collector's state after
    it, drawn on a CPU generator and moved to ``dev``."""
    from types import SimpleNamespace

    from rlpyt_tpu_torch.distributions.categorical import DistInfo
    from rlpyt_tpu_torch.samplers.rollout import Samples
    from rlpyt_tpu_torch.struct import tree_map

    cg = torch.Generator().manual_seed(12)
    T_, B_, H, A = PG_T, PG_B, PG_H, 6
    obs = (torch.rand((T_ + 1, B_, 4, 10, 10), generator=cg) < 0.1).to(
        torch.uint8)
    pa = torch.randint(0, A, (T_ + 1, B_), generator=cg)
    pr = (torch.rand((T_ + 1, B_), generator=cg) < 0.2).float()

    def rnn(*lead):
        return tuple(0.5 * torch.randn(lead + (H,), generator=cg)
                     for _ in range(2))

    info = {"dist_info": DistInfo(torch.softmax(
                torch.randn((T_, B_, A), generator=cg), -1)),
            "value": torch.randn((T_, B_), generator=cg),
            "prev_rnn_state": rnn(T_, B_)}
    samples = Samples(obs[:T_], torch.randint(0, A, (T_, B_), generator=cg),
                      pr[1:], torch.rand((T_, B_), generator=cg) < 0.05,
                      pa[:T_], pr[:T_], info, {})
    perms = torch.stack([torch.randperm(B_, generator=cg)
                         for _ in range(4)])

    def move(x):
        return x.to(dev)

    last = SimpleNamespace(observation=obs[T_].to(dev),
                           prev_action=pa[T_].to(dev),
                           prev_reward=pr[T_].to(dev),
                           agent_carry=tree_map(move, rnn(B_)),
                           cum_steps=T_ * B_)
    return tree_map(move, samples), last, perms


def check_pg_against_cpu(L, dev):
    """Phase 12a: one recurrent PPO optimize (lstm_ppo: 4 epochs x 4
    minibatches of 32 lanes, Adam, clip 1.0, the linear schedule) and one
    recurrent A2C optimize (lstm_a2c: RMSprop) on the card, through
    K3a/K3/K4, against the same calls on the CPU through the plain
    versions, from the same weights, batch and permutations; TF32 off.
    Loss, grad norm, entropy and perplexity must agree to 1e-4 (relative,
    or absolute below 1); every parameter after the step to 1e-3 of the
    largest change any parameter made."""
    from rlpyt_tpu_torch.agents.pg import RecurrentCategoricalPgAgent
    from rlpyt_tpu_torch.algos.pg import A2C, PPO
    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.experiments.configs.minatar_pg import configs
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    spaces = Breakout(device="cpu").spaces
    for key, Cls, k4 in (("lstm_ppo", PPO, 16), ("lstm_a2c", A2C, 1)):
        cfg = configs[key]
        out = {}
        for d in ("cpu", dev):
            agent = RecurrentCategoricalPgAgent(model_kwargs=cfg["model"],
                                                device=d)
            torch.manual_seed(0)    # the same weights on both sides
            agent.initialize(spaces)
            before = {k: v.detach().clone().cpu()
                      for k, v in agent.model.state_dict().items()}
            algo = Cls(**cfg["algo"])
            algo.initialize(agent, BatchSpec(PG_T, PG_B), None,
                            torch.Generator(device=d), n_itr=10)
            samples, last, perms = pg_batch(d)
            kw = {"permutations": perms} if Cls is PPO else {}
            zero_launches()
            info = algo.optimize(samples, last, **kw)
            after = {k: v.detach().cpu()
                     for k, v in agent.model.state_dict().items()}
            out[d] = (info, before, after, L.lstm_bwd.launches)
        (info_c, before, after_c, _), (info_g, _, after_g, k4_g) = \
            out["cpu"], out[dev]
        if k4_g != k4:
            fail(f"phase 12a {key}: K4 launched {k4_g} times, not {k4}")
        for field in info_c._fields:
            want, got = (float(getattr(i, field)) for i in (info_c, info_g))
            if not abs(got - want) <= 1e-4 * max(1.0, abs(want)):
                fail(f"phase 12a {key}: {field} {got!r} on the card, "
                     f"{want!r} on the CPU")
        change = max(float((after_c[k] - before[k]).abs().max())
                     for k in before)
        diff = max(float((after_g[k] - after_c[k]).abs().max())
                   for k in before)
        if not diff <= 1e-3 * change:
            fail(f"phase 12a {key}: params differ by {diff:.3g} after the "
                 f"step; the largest change is {change:.3g}")
        print(f"phase 12a: {key} optimize card against CPU: loss "
              f"{float(info_g.loss):.6g} / {float(info_c.loss):.6g}, "
              f"grad_norm {float(info_g.grad_norm):.6g} / "
              f"{float(info_c.grad_norm):.6g}; params differ by "
              f"{diff:.3g} = {diff / change:.3g} of the largest change; "
              f"{k4_g} K4 launches")


def run_minatar_pg(L, key: str, n_itr: int, pg_stats: dict):
    """Phases 12b and 12c: ``build_and_train(key)`` at the config's widths
    for ``n_itr`` iterations (only n_steps and log_interval_steps
    overridden), evaluating after each.  Checks finite losses, completed
    evaluation episodes, and the LSTM launches of the path: per iteration
    T collection steps and one bootstrap (K3a and K3 at T=1 each), then
    lstm_ppo's 16 minibatch windows (K3a, K3, K4 each) or lstm_a2c's one
    window; each evaluation step one K3a and one K3 at T=1; none for the
    feedforward configs.  Evaluation steps are counted at the env (its
    lanes are 32, the trainer's 128).  Returns the LSTM launch counts."""
    import contextlib
    import csv
    import io
    import tempfile

    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.experiments.configs.minatar_pg import configs
    from rlpyt_tpu_torch.experiments.scripts.minatar_pg import \
        build_and_train

    cfg = configs[key]
    steps = cfg["sampler"]["batch_T"] * cfg["sampler"]["batch_B"]
    eval_steps = [0]
    step_batch = Breakout.step_batch

    def counted(env, state, action, *args, **kwargs):
        eval_steps[0] += action.shape[0] == cfg["sampler"]["eval_n_envs"]
        return step_batch(env, state, action, *args, **kwargs)

    Breakout.step_batch = counted
    zero_launches()
    try:
        with tempfile.TemporaryDirectory() as log_dir, \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.time()
            runner = build_and_train(key, log_dir=log_dir, config_overrides={
                "runner": {"n_steps": n_itr * steps,
                           "log_interval_steps": steps}})
            torch.cuda.synchronize()
            seconds = time.time() - t0
            with open(Path(log_dir) / "run_0" / "progress.csv") as f:
                rows = list(csv.DictReader(f))
    finally:
        Breakout.step_batch = step_batch
    launches = {"lstm_input_proj": L.input_proj.launches,
                "lstm_fwd": L.lstm_fwd.launches,
                "lstm_fwd_t1": L.lstm_fwd.step_launches,
                "lstm_bwd": L.lstm_bwd.launches}
    algo, n_eval = runner.algo, eval_steps[0]
    if not key.startswith("lstm"):
        want = dict.fromkeys(launches, 0)
    else:
        windows = algo.updates_per_optimize    # 16 for PPO, 1 for A2C
        t1 = n_itr * (cfg["sampler"]["batch_T"] + 1) + n_eval
        want = {"lstm_input_proj": t1 + n_itr * windows,
                "lstm_fwd": t1 + n_itr * windows, "lstm_fwd_t1": t1,
                "lstm_bwd": n_itr * windows}
    if launches != want:
        fail(f"{key}: LSTM launches {launches}, expected {want} "
             f"({n_eval} evaluation steps)")
    if algo.update_counter != n_itr * algo.updates_per_optimize \
            or len(rows) != n_itr:
        fail(f"{key}: {algo.update_counter} updates in {len(rows)} rows")
    for row in rows:
        for field in ("loss", "grad_norm", "entropy", "perplexity",
                      "StepsPerSecond", "EvalReturnAverage"):
            if not math.isfinite(float(row[field])):
                fail(f"{key}: {field} = {row[field]} in iteration "
                     f"{row['Iteration']}")
        if int(row["EvalTrajs"]) < 1:
            fail(f"{key}: no evaluation episode completed")
        print(f"{key} itr {row['Iteration']}: loss {float(row['loss']):.6g} "
              f"grad_norm {float(row['grad_norm']):.6g} entropy "
              f"{float(row['entropy']):.6g} StepsPerSecond "
              f"{float(row['StepsPerSecond']):.1f} EvalTrajs "
              f"{row['EvalTrajs']} EvalReturnAverage "
              f"{float(row['EvalReturnAverage']):.4f} EvalLengthAverage "
              f"{float(row['EvalLengthAverage']):.2f}")
    pg_stats[key] = dict(seconds=seconds, eval_steps=n_eval,
                         sps=[float(r["StepsPerSecond"]) for r in rows])
    return launches


def time_lstm_pg(L, g, dev):
    """Phase 12d: K3a, K3 and K4 at minatar_pg.py's shapes (F=135, H=128)
    beside their plain versions, bounds and library calls.  Entries: K3a
    at the PPO minibatch's 512 rows, K3 and K4 at its window (T=16, B=32)
    and K3 at a collection step (T=1, B=128).  Printed: K3a at 128, 32
    and 2048 rows (collection, evaluation, the A2C window), K3 at an
    evaluation step (T=1, B=32), K3 and K4 at the A2C window (T=16,
    B=128)."""
    F, H = PG_F, PG_H
    mb = lstm_case(g, PG_T, PG_B // 4, F, H, dev)
    win = lstm_case(g, PG_T, PG_B, F, H, dev)
    wx, b = mb["wx"], mb["b"]
    entries = add_bounds({
        "lstm_input_proj_pg": proj_times(
            L, mb["x"].view(-1, F), [wx], b, 50),
        "lstm_fwd_pg": fwd_times(L, mb, dev, 50, 10),
        "lstm_fwd_t1_pg": fwd_times(L, lstm_case(g, 1, PG_B, F, H, dev),
                                    dev, 50, 20),
        "lstm_bwd_pg": bwd_times(L, mb, g, dev, 50, 10),
    })
    printed = add_bounds({
        f"lstm_input_proj M={M}": proj_times(
            L, torch.randn((M, F), generator=g, device=dev), [wx], b, 50)
        for M in (PG_B, PG_EVAL_B)})
    printed.update(add_bounds({
        f"lstm_input_proj M={PG_T * PG_B}": proj_times(
            L, win["x"].view(-1, F), [wx], b, 50),
        f"lstm_fwd T=1 B={PG_EVAL_B}": fwd_times(
            L, lstm_case(g, 1, PG_EVAL_B, F, H, dev), dev, 50, 20),
        f"lstm_fwd T={PG_T} B={PG_B}": fwd_times(L, win, dev, 50, 10),
        f"lstm_bwd T={PG_T} B={PG_B}": bwd_times(L, win, g, dev, 50, 10),
    }))
    for name, t in list(entries.items()) + list(printed.items()):
        print(f"phase 12d: {name} call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms; library call "
              f"{t['library_ms']:.4f} ms"
              + (f", device {t['library_device_ms']:.4f} ms"
                 if t.get("library_device_ms") else "")
              + f"; plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['ops']} "
              f"operations, {t['bytes']} bytes)")
    return entries


def near_health_bound(cls, state) -> torch.Tensor:
    """Lanes of a locomotion state within 1e-3 of a health bound, where
    rounding may decide termination: a speed in (100 - 1e-3, 100) (a
    speed clipped to exactly 100 ends the episode on either side), and
    for Hopper2D a torso height within 1e-3 of 0.8 or a pitch of 0.6."""
    speed = state.qd.abs()
    near = ((speed > 100.0 - 1e-3) & (speed < 100.0)).any(-1)
    if cls.__name__ == "Hopper2D":
        near |= ((state.q[:, 1] - 0.8).abs() < 1e-3) | (
            (state.q[:, 2].abs() - 0.6).abs() < 1e-3)
    return near


def check_continuous_envs(dev):
    """Phase 13a: the five continuous-control envs, card against CPU,
    CONT_B lanes for CONT_STEPS steps from one set of reset draws and
    actions (1.2 times the bounds, so the envs clip) made on a CPU
    generator, lanes reset after every done, a time limit of 40.  Each
    step starts the card from the CPU's state.  Pendulum,
    ContinuousMountainCar and Reacher must agree to float32 rounding
    (rtol 1e-5, atol 1e-5); Hopper2D and Cheetah2D (stiff contact
    springs, 16 substeps, batched solves) to rtol 1e-4, atol 1e-3 in
    state, observation and reward, with equal dones except on a lane
    that either side puts within 1e-3 of a health bound
    (``near_health_bound``; counted and printed)."""
    from rlpyt_tpu_torch.envs.classic import ContinuousMountainCar, \
        Pendulum
    from rlpyt_tpu_torch.envs.locomotion import Cheetah2D, Hopper2D
    from rlpyt_tpu_torch.envs.reacher import Reacher
    from rlpyt_tpu_torch.struct import tree_map, tree_select

    B, n_steps = CONT_B, CONT_STEPS
    for cls in (Pendulum, ContinuousMountainCar, Reacher, Hopper2D,
                Cheetah2D):
        loco = cls in (Hopper2D, Cheetah2D)
        rtol, atol = (1e-4, 1e-3) if loco else (1e-5, 1e-5)
        cpu, card = (cls(max_steps=40, device=d) for d in ("cpu", dev))
        g = torch.Generator().manual_seed(13)
        resets = [cpu.draw_reset(B, g) for _ in range(n_steps + 1)]
        actions = [1.2 * cpu.action_space.sample(g, (B,))
                   for _ in range(n_steps)]
        state = cpu.reset_batch(B, draws=resets[0])[0]
        worst, flips, dones = 0.0, 0, 0
        for i in range(n_steps):
            s_c, st_c = cpu.step_batch(state, actions[i])
            s_g, st_g = card.step_batch(
                tree_map(lambda x: x.to(dev), state), actions[i].to(dev))
            pairs = [("observation", st_c.observation, st_g.observation),
                     ("reward", st_c.reward, st_g.reward)]
            pairs += [(f, a, b) for f, a, b in zip(s_c._fields, s_c, s_g)
                      if a.is_floating_point()]
            for field, want, got in pairs:
                err = (got.cpu() - want).abs()
                if not bool((err <= atol + rtol * want.abs()).all()):
                    fail(f"{cls.__name__}: {field} differs between card "
                         f"and CPU at step {i} by {float(err.max()):.3g}")
                worst = max(worst, float(err.max()))
            differ = (st_g.done.cpu() != st_c.done) | (
                st_g.info["timeout"].cpu() != st_c.info["timeout"])
            if loco:
                near = near_health_bound(cls, s_c) | near_health_bound(
                    cls, tree_map(lambda x: x.cpu(), s_g))
                differ &= ~near
                flips += int(near.sum())
            if bool(differ.any()) or not torch.equal(s_g.t.cpu(), s_c.t):
                fail(f"{cls.__name__}: dones differ between card and CPU "
                     f"at step {i}")
            dones += int(st_c.done.sum())
            state = tree_select(st_c.done,
                                cpu.reset_batch(B, draws=resets[i + 1])[0],
                                s_c)
        print(f"phase 13a: {cls.__name__} B={B} {n_steps} steps, card "
              f"against CPU: max abs err {worst:.3g} (tolerance rtol "
              f"{rtol:g} atol {atol:g}), {dones} dones, {flips} lanes near "
              f"a health bound")


def build_sac_hopper_runner(dev, n_itr: int, logger=None):
    """SAC on Hopper2D at full width (tests/test_locomotion.py:59-72):
    pi and twin Q MLPs of (256, 256), B=32, T=32, batch 256, replay 200k,
    replay ratio 64 (256 updates an iteration), lr 3e-4, tau 0.005,
    learning from 2000 steps, 100 decorrelation steps.  One iteration
    per log row."""
    from rlpyt_tpu_torch.agents.qpg import SacAgent
    from rlpyt_tpu_torch.algos.qpg import SAC
    from rlpyt_tpu_torch.envs.locomotion import Hopper2D
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    agent = SacAgent(device=dev)
    algo = SAC(batch_size=256, min_steps_learn=2_000, replay_size=200_000,
               replay_ratio=64.0, learning_rate=3e-4,
               target_update_tau=0.005)
    steps = SAC_T * SAC_B
    return MinibatchRl(algo, agent, Hopper2D(device=dev),
                       BatchSpec(SAC_T, SAC_B), n_steps=n_itr * steps,
                       seed=0, log_interval_steps=steps,
                       max_decorrelation_steps=100, logger=logger,
                       device=dev)


def run_sac_hopper(dev):
    """Phase 13b: SAC_ITR iterations of the SAC Hopper2D trainer through
    MinibatchRl.  Checks finite losses and alpha, 256 updates in every
    iteration from 2000 env steps on and none before, and that alpha
    moved from 1.  Collect and optimize are timed with a device sync
    after each; an env step alone is timed at B=32 (host issue time, then
    wall time with the sync)."""
    logger = row_logger()
    runner = build_sac_hopper_runner(dev, SAC_ITR, logger)
    runner.startup()
    runner.startup = lambda: None    # train() below must not redo it
    algo, coll = runner.algo, runner.collector
    log = []
    collect, optimize = coll.collect, algo.optimize

    def timed_collect(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect(*args, **kwargs)
        torch.cuda.synchronize()
        log.append({"collect_s": time.perf_counter() - t0})
        return out

    def timed_optimize(samples, rollout_state):
        before = algo.update_counter
        t0 = time.perf_counter()
        out = optimize(samples, rollout_state)
        torch.cuda.synchronize()
        log[-1].update(optimize_s=time.perf_counter() - t0,
                       updates=algo.update_counter - before,
                       cum_steps=rollout_state.cum_steps)
        return out

    coll.collect, algo.optimize = timed_collect, timed_optimize
    zero_launches()
    runner.train()
    torch.cuda.synchronize()
    for entry, row in zip(log, logger.rows):
        want = (algo.updates_per_optimize
                if entry["cum_steps"] >= algo.min_steps_learn else 0)
        if entry["updates"] != want or want not in (0, 256):
            fail(f"SAC ran {entry['updates']} updates at "
                 f"{entry['cum_steps']} steps, expected {want}")
        for key in ("q_loss", "pi_loss", "q_grad_norm", "pi_grad_norm",
                    "alpha", "StepsPerSecond"):
            if not math.isfinite(row[key]):
                fail(f"SAC: non-finite {key} in iteration "
                     f"{row['Iteration']}")
        per_update = (1e3 * entry["optimize_s"] / entry["updates"]
                      if entry["updates"] else float("nan"))
        print(f"sac hopper itr {row['Iteration']}: q_loss "
              f"{row['q_loss']:.6g} pi_loss {row['pi_loss']:.6g} alpha "
              f"{row['alpha']:.6g} env-steps/s {row['StepsPerSecond']:.1f};"
              f" collect {1e3 * entry['collect_s']:.1f} ms "
              f"({1e3 * entry['collect_s'] / SAC_T:.3f} ms an env step), "
              f"optimize {1e3 * entry['optimize_s']:.1f} ms, "
              f"{entry['updates']} updates ({per_update:.3f} ms each)")
    if len(log) != SAC_ITR or sum(e["updates"] for e in log) != \
            algo.update_counter or algo.update_counter == 0:
        fail(f"SAC: {algo.update_counter} updates over {len(log)} "
             "iterations")
    if not logger.rows[-1]["alpha"] < 1.0:
        fail(f"SAC: alpha {logger.rows[-1]['alpha']} did not move from 1")
    env, state = runner.env, runner.rollout_state.env_state
    action = torch.zeros((SAC_B, env.na), device=dev)
    env.step_batch(state, action)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        env.step_batch(state, action)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    env_ms = dict(issue=1e3 * (t1 - t0) / 20, wall=1e3 * (t2 - t0) / 20)
    return runner, log, env_ms


def qpg_batch(dev, obs_size, action_size, batch, seed):
    """A replay batch of ``batch`` transitions drawn on a CPU generator,
    some done and some timed out, and moved to ``dev``."""
    from rlpyt_tpu_torch.replay.base import AgentInputs, SamplesFromReplay
    from rlpyt_tpu_torch.struct import tree_map

    g = torch.Generator().manual_seed(seed)
    obs, next_obs = (torch.randn((batch, obs_size), generator=g)
                     for _ in range(2))
    action = 2 * torch.rand((batch, action_size), generator=g) - 1
    ret = torch.randn((batch,), generator=g)
    done = torch.rand((batch,), generator=g) < 0.1
    timeout = (torch.rand((batch,), generator=g) < 0.1) & ~done
    zeros = torch.zeros((batch,))
    b = SamplesFromReplay(
        AgentInputs(obs, torch.zeros_like(action), zeros), action, ret,
        done, done, timeout, AgentInputs(next_obs, action, ret),
        torch.ones((batch,)), (zeros.long(), zeros.long()))
    return tree_map(lambda x: x.to(dev), b)


# An Adam step moves each element by lr m / (sqrt(v) + 1e-8), v the
# bias-corrected running mean of g^2 (at the first step m / sqrt(v) is
# g / |g|), so a relative error e in g moves the step by up to
# lr e 1e-8 / sqrt(v).  Where sqrt(v) is below 1e-6, a gradient whose sum
# cancels to 10 % rounding moves it by more than 1e-3 of lr, and that
# error stays in the element (dead ReLU units give exact zeros).  Phases
# 13c and 13d hold the parameters to 1e-3 of the largest change on the
# other elements only; the excluded ones are counted and printed.
ADAM_TINY_GRAD = 1e-6
ADAM_B2 = 0.999


def spy_grads(optimizers: dict, names: dict) -> dict:
    """Record the gradients each Adam sees (after any clipping) at each of
    its steps, on the CPU: {optimizer key: [{param name: grad}, ...]}.
    ``names``: the optimizer key -> the state_dict names of its params, in
    order."""
    seen = {key: [] for key in optimizers}
    for key, opt in optimizers.items():
        real = opt.inner.step

        def step(key=key, opt=opt, real=real):
            seen[key].append({n: p.grad.detach().cpu().clone() for n, p in
                              zip(names[key], opt.params)})
            return real()

        opt.inner.step = step
    return seen


def hold_update(tag: str, before, after_c, after_g, grads_c, grads_g):
    """The card's update against the CPU's: each optimizer's first-step
    gradients to 1e-4 of their largest magnitude; every parameter (and
    each target, through its online network's mask) to 1e-3 of the
    largest change any parameter made, except elements whose Adam RMS
    sqrt(v), from the CPU's gradients, fell below ADAM_TINY_GRAD at some
    step.  Returns (diff, change,
    number of elements excluded, their largest diff)."""
    tiny = {}
    for key, steps in grads_c.items():
        if not steps:
            continue
        for name in steps[0]:
            v = torch.zeros_like(steps[0][name])
            tiny[name] = torch.zeros_like(v, dtype=torch.bool)
            for t, st in enumerate(steps, 1):
                v = ADAM_B2 * v + (1 - ADAM_B2) * st[name] ** 2
                tiny[name] |= (v / (1 - ADAM_B2 ** t)).sqrt() \
                    < ADAM_TINY_GRAD
            want, got = steps[0][name], grads_g[key][0][name]
            err = float((got - want).abs().max())
            scale = max(float(want.abs().max()) for want in
                        steps[0].values())
            if not err <= 1e-4 * scale:
                fail(f"{tag}: gradient of {name} differs by {err:.3g}, the "
                     f"largest gradient is {scale:.3g}")
    change = max(float((after_c[k] - before[k]).abs().max())
                 for k in before)
    diff, n_tiny, tiny_diff = 0.0, 0, 0.0
    for k in before:
        d = (after_g[k] - after_c[k]).abs()
        mask = tiny.get(k[len("target_"):] if k.startswith("target_") else k)
        if mask is not None:
            n_tiny += int(mask.sum())
            if bool(mask.any()):
                tiny_diff = max(tiny_diff, float(d[mask].max()))
            d = d[~mask]
        if d.numel():
            diff = max(diff, float(d.max()))
    if not (change > 0 and diff <= 1e-3 * change):
        fail(f"{tag}: params differ by {diff:.3g}; the largest change is "
             f"{change:.3g}")
    return diff, change, n_tiny, tiny_diff


def check_qpg_against_cpu(dev):
    """Phase 13c: one update of DDPG and SAC and two of TD3 (the second
    steps mu) at the main path's widths (Hopper2D's spaces, MLPs of
    (256, 256), batch 256) on the card against the same calls on the CPU,
    from the same weights, batch and noise; TF32 off.  Losses, grad norms
    and alpha to 1e-4 (relative, or absolute below 1); the gradients and
    parameters as ``hold_update`` says."""
    from rlpyt_tpu_torch.agents.qpg import DdpgAgent, SacAgent, Td3Agent
    from rlpyt_tpu_torch.algos.qpg import DDPG, SAC, TD3
    from rlpyt_tpu_torch.envs.locomotion import Hopper2D
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    spaces = Hopper2D(device="cpu").spaces
    n_obs, n_act = spaces.observation.shape[0], spaces.action.shape[0]
    kinds = (("ddpg", DdpgAgent, DDPG, 1), ("td3", Td3Agent, TD3, 2),
             ("sac", SacAgent, SAC, 1))
    for key, Agent, Algo, n_updates in kinds:
        out = {}
        for d in ("cpu", dev):
            agent = Agent(device=d)
            torch.manual_seed(0)    # the same weights on both sides
            agent.initialize(spaces)
            before = {k: v.detach().clone().cpu()
                      for k, v in agent.nets.state_dict().items()}
            algo = Algo(batch_size=256, min_steps_learn=0, replay_size=4096)
            algo.initialize(agent, BatchSpec(SAC_T, SAC_B),
                            torch.zeros((SAC_B, n_obs), device=d),
                            torch.Generator(device=d))
            grads = spy_grads(algo.optimizers, {
                name: [f"{name}.{n}" for n, _ in
                       agent.nets[name].named_parameters()]
                for name in algo.optimizers})
            g = torch.Generator().manual_seed(21)
            infos = []
            for i in range(n_updates):
                noise = tuple(torch.randn((256, n_act), generator=g)
                              .to(d) for _ in range(2))
                noise = {"ddpg": None, "td3": noise[0], "sac": noise}[key]
                infos.append(algo.update(qpg_batch(d, n_obs, n_act, 256,
                                                   30 + i), noise))
            after = {k: v.detach().cpu()
                     for k, v in agent.nets.state_dict().items()}
            out[d] = (infos[-1], before, after, grads)
        (info_c, before, after_c, grads_c), (info_g, _, after_g, grads_g) \
            = out["cpu"], out[dev]
        for field in info_c._fields:
            want, got = (float(getattr(i, field)) for i in (info_c, info_g))
            if not abs(got - want) <= 1e-4 * max(1.0, abs(want)):
                fail(f"phase 13c {key}: {field} {got!r} on the card, "
                     f"{want!r} on the CPU")
        diff, change, n_tiny, tiny_diff = hold_update(
            f"phase 13c {key}", before, after_c, after_g, grads_c, grads_g)
        print(f"phase 13c: {key} {n_updates} update(s) card against CPU: "
              f"q_loss {float(info_g.q_loss):.6g} / "
              f"{float(info_c.q_loss):.6g}, pi_loss "
              f"{float(info_g.pi_loss):.6g} / {float(info_c.pi_loss):.6g}, "
              f"alpha {float(info_g.alpha):.6g}; first-step gradients "
              f"within 1e-4; params differ by {diff:.3g} = "
              f"{diff / change:.3g} of the largest change ({n_tiny} "
              f"elements with an Adam RMS below {ADAM_TINY_GRAD:g} "
              f"excluded, their largest diff {tiny_diff:.3g})")


# mujoco_pg.py's "ppo" algo settings, with 2 minibatches of 4 lanes.
MJ_PPO = dict(discount=0.99, learning_rate=3e-4, value_loss_coeff=1.0,
              entropy_loss_coeff=0.0, clip_grad_norm=1.0, gae_lambda=0.95,
              minibatches=MJ_MINIBATCHES, epochs=10, ratio_clip=0.2,
              normalize_advantage=True, linear_lr_schedule=True)


def check_gaussian_ppo_against_cpu(L, dev):
    """Phase 13d: one recurrent Gaussian PPO optimize (MujocoLstmModel at
    its defaults: mlp 256, LSTM 256) on a [256, 8] Hopper2D batch that
    the CPU agent collected, on the card (K3a, K3, K4) against the same
    call on the CPU (plain versions), from the same weights and
    permutations; TF32 off.  Infos to 1e-4, the gradients and parameters
    as ``hold_update`` says.  The card's launches must be exactly the
    path's:
    one K3a and one one-step K3 for the bootstrap value, then a K3a, a
    K3 and a K4 for each of the 10 x 2 minibatch windows.  Returns the
    launch counts."""
    from rlpyt_tpu_torch.agents.pg import RecurrentGaussianPgAgent
    from rlpyt_tpu_torch.algos.pg import PPO
    from rlpyt_tpu_torch.envs.locomotion import Hopper2D
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector
    from rlpyt_tpu_torch.struct import tree_map

    env = Hopper2D(device="cpu")
    spec = BatchSpec(MJ_T, MJ_B)
    torch.manual_seed(0)
    collector_agent = RecurrentGaussianPgAgent(device="cpu")
    collector_agent.initialize(env.spaces)
    collector = Collector(env, collector_agent, spec, discount=0.99)
    g = torch.Generator().manual_seed(5)
    last, samples = collector.collect(collector.init_state(g), g)
    perms = torch.stack([torch.randperm(MJ_B, generator=g)
                         for _ in range(MJ_PPO["epochs"])])
    out = {}
    for d in ("cpu", dev):
        agent = RecurrentGaussianPgAgent(device=d)
        torch.manual_seed(1)
        agent.initialize(env.spaces)
        before = {k: v.detach().clone().cpu()
                  for k, v in agent.model.state_dict().items()}
        algo = PPO(**MJ_PPO)
        algo.initialize(agent, spec, None, torch.Generator(device=d),
                        n_itr=10)
        move = (lambda x: x.to(d)) if d != "cpu" else (lambda x: x)
        state = last._replace(**{
            f: tree_map(move, getattr(last, f)) for f in
            ("observation", "prev_action", "prev_reward", "agent_carry")})
        grads = spy_grads({"model": algo.optimizer}, {"model": [
            n for n, _ in agent.model.named_parameters()]})
        zero_launches()
        info = algo.optimize(tree_map(move, samples), state,
                             permutations=perms)
        after = {k: v.detach().cpu()
                 for k, v in agent.model.state_dict().items()}
        out[d] = (info, before, after, grads, {
            "lstm_input_proj": L.input_proj.launches,
            "lstm_fwd": L.lstm_fwd.launches,
            "lstm_fwd_t1": L.lstm_fwd.step_launches,
            "lstm_bwd": L.lstm_bwd.launches})
    (info_c, before, after_c, grads_c, _), \
        (info_g, _, after_g, grads_g, launches) = out["cpu"], out[dev]
    windows = MJ_PPO["epochs"] * MJ_MINIBATCHES
    want = {"lstm_input_proj": windows + 1, "lstm_fwd": windows + 1,
            "lstm_fwd_t1": 1, "lstm_bwd": windows}
    if launches != want:
        fail(f"phase 13d: LSTM launches {launches}, expected {want}")
    for field in info_c._fields:
        w, got = (float(getattr(i, field)) for i in (info_c, info_g))
        if not abs(got - w) <= 1e-4 * max(1.0, abs(w)):
            fail(f"phase 13d: {field} {got!r} on the card, {w!r} on the CPU")
    diff, change, n_tiny, tiny_diff = hold_update(
        "phase 13d", before, after_c, after_g, grads_c, grads_g)
    print(f"phase 13d: recurrent Gaussian PPO optimize card against CPU: "
          f"loss {float(info_g.loss):.6g} / {float(info_c.loss):.6g}, "
          f"grad_norm {float(info_g.grad_norm):.6g} / "
          f"{float(info_c.grad_norm):.6g}; first-step gradients within "
          f"1e-4; params differ by {diff:.3g} = {diff / change:.3g} of the "
          f"largest change ({n_tiny} elements with an Adam RMS below "
          f"{ADAM_TINY_GRAD:g} excluded, their largest diff "
          f"{tiny_diff:.3g}); LSTM launches {launches}")
    return launches


def time_lstm_mujoco(L, g, dev):
    """Phase 13e: K3a, K3 and K4 at MujocoLstmModel's shapes (F=260,
    H=256) beside their plain versions, bounds and library calls.
    Entries: K3a at a PPO minibatch window's 1024 rows, K3 and K4 at
    that window (T=256, B=4), K3 at a collection step (T=1, B=8).
    Printed: K3a at 8 rows (a collection step) and 2048 (the whole
    batch), K3 and K4 at the whole batch (T=256, B=8)."""
    F, H = MJ_F, MJ_H
    mb = lstm_case(g, MJ_T, MJ_B // MJ_MINIBATCHES, F, H, dev)
    win = lstm_case(g, MJ_T, MJ_B, F, H, dev)
    wx, b = mb["wx"], mb["b"]
    entries = add_bounds({
        "lstm_input_proj_mujoco": proj_times(L, mb["x"].view(-1, F), [wx],
                                             b, 50),
        "lstm_fwd_mujoco": fwd_times(L, mb, dev, 10, 3),
        "lstm_fwd_t1_mujoco": fwd_times(
            L, lstm_case(g, 1, MJ_B, F, H, dev), dev, 50, 20),
        "lstm_bwd_mujoco": bwd_times(L, mb, g, dev, 10, 3),
    })
    printed = add_bounds({
        f"lstm_input_proj M={MJ_B}": proj_times(
            L, torch.randn((MJ_B, F), generator=g, device=dev), [wx], b,
            50),
        f"lstm_input_proj M={MJ_T * MJ_B}": proj_times(
            L, win["x"].view(-1, F), [wx], b, 50),
        f"lstm_fwd T={MJ_T} B={MJ_B}": fwd_times(L, win, dev, 10, 3),
        f"lstm_bwd T={MJ_T} B={MJ_B}": bwd_times(L, win, g, dev, 10, 3),
    })
    for name, t in list(entries.items()) + list(printed.items()):
        print(f"phase 13e: {name} call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms; library call "
              f"{t['library_ms']:.4f} ms"
              + (f", device {t['library_device_ms']:.4f} ms"
                 if t.get("library_device_ms") else "")
              + f"; plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['ops']} "
              f"operations, {t['bytes']} bytes)")
    return entries


# Phase 14: the DQN family as users launch it,
# rlpyt_tpu_torch/experiments/scripts/minatar_dqn.py with its five
# configs.  r2d1's LSTM: 128 units on [conv 16 x 8 x 8, Breakout's 6
# actions, the reward]; its sampler (T=40, B=64), window (burn-in 20,
# training 40, n-step 5) and batch of 32 windows; evaluation on 32 lanes.
MD_T, MD_B, MD_EVAL_B, MD_H, MD_F = 40, 64, 32, 128, 16 * 8 * 8 + 6 + 1
MD_BATCH_B, MD_WARMUP, MD_WINDOW = 32, 20, 20 + 40 + 5
MD_CONFIGS = ("dqn", "dqn_pub", "ernbw", "ernbw_vec", "r2d1")
# Iterations of each config in 14a, and its cut of min_steps_learn (None:
# the config's 5000 steps, learning from the third iteration of 2048
# steps, the second of r2d1's 2560).  dqn_pub's 2048 updates an iteration
# take seconds, so it learns in one iteration only.
MD_ITR = {"dqn": 4, "dqn_pub": 2, "ernbw": 4, "ernbw_vec": 4, "r2d1": 4}
MD_LEARN = {"dqn_pub": 4096}
# Evaluation caps of 14a: 500 steps a lane, 32 episodes (the configs'
# 3000 and 100).
MD_EVAL_CUT = {"eval_max_steps": MD_EVAL_B * 500,
               "eval_max_trajectories": 32}
# r2d1's LSTM shapes: the training window (45, 32), the burn-in (20, 32),
# a collection step (1, 64) and an evaluation step (1, 32).
MD_CASES = [(MD_WINDOW - MD_WARMUP, MD_BATCH_B, MD_F, MD_H),
            (MD_WARMUP, MD_BATCH_B, MD_F, MD_H), (1, MD_B, MD_F, MD_H),
            (1, MD_EVAL_B, MD_F, MD_H)]


def md_launches(L) -> dict:
    return {"lstm_input_proj": L.input_proj.launches,
            "lstm_input_proj_split": L.input_proj.split_launches,
            "lstm_fwd": L.lstm_fwd.launches,
            "lstm_fwd_t1": L.lstm_fwd.step_launches,
            "lstm_bwd": L.lstm_bwd.launches}


def run_minatar_dqn(L, key: str, log_root: Path):
    """Phase 14a (and 14b for r2d1): ``build_and_train(key)`` at the
    config's widths, batch, replay ratio, optimizer and epsilon schedule
    for MD_ITR[key] iterations, evaluating after each; only n_steps,
    log_interval_steps, min_steps_learn (MD_LEARN) and the evaluation caps
    are cut.  Checks finite losses once learning has started, the update
    count, the Eval keys and a completed evaluation episode; for ernbw and
    ernbw_vec finite priorities above 0 on every written row; for r2d1 the
    LSTM launches of every iteration: T collection steps (one K3a and one
    one-step K3 each), per update four forward windows (K3a, K3) and one
    backward (K4), and one K3a and one-step K3 per evaluation step
    (counted at the env: 32 lanes); for the others no LSTM launch.
    Returns (runner, rows, per-iteration launch counts)."""
    import contextlib
    import csv
    import io

    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.experiments.configs.minatar_dqn import configs
    from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import \
        build_and_train
    from rlpyt_tpu_torch.utils.logging import TabularLogger

    cfg = configs[key]
    steps = cfg["sampler"]["batch_T"] * cfg["sampler"]["batch_B"]
    n_itr = MD_ITR[key]
    overrides = {"runner": {"n_steps": n_itr * steps,
                            "log_interval_steps": steps},
                 "sampler": dict(MD_EVAL_CUT)}
    if key in MD_LEARN:
        overrides["algo"] = {"min_steps_learn": MD_LEARN[key]}
    min_learn = MD_LEARN.get(key, cfg["algo"]["min_steps_learn"])
    eval_steps = [0]
    marks = []      # (launch counts, evaluation steps) at each dump
    step_batch, dump = Breakout.step_batch, TabularLogger.dump_tabular

    def counted(env, state, action, *args, **kwargs):
        eval_steps[0] += action.shape[0] == MD_EVAL_B
        return step_batch(env, state, action, *args, **kwargs)

    def marked(logger, *args, **kwargs):
        marks.append((md_launches(L), eval_steps[0]))
        return dump(logger, *args, **kwargs)

    Breakout.step_batch, TabularLogger.dump_tabular = counted, marked
    zero_launches()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runner = build_and_train(key, log_dir=str(log_root / key),
                                     config_overrides=overrides)
            torch.cuda.synchronize()
    finally:
        Breakout.step_batch, TabularLogger.dump_tabular = step_batch, dump
    with open(log_root / key / "run_0" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    algo = runner.algo
    learning = [(i + 1) * steps >= min_learn for i in range(n_itr)]
    if len(rows) != n_itr or algo.update_counter != \
            sum(learning) * algo.updates_per_optimize:
        fail(f"14a {key}: {algo.update_counter} updates in {len(rows)} "
             f"rows, expected {sum(learning)} x "
             f"{algo.updates_per_optimize}")
    per_itr, prev = [], (dict.fromkeys(md_launches(L), 0), 0)
    for i, (row, mark) in enumerate(zip(rows, marks)):
        got = {k: mark[0][k] - prev[0][k] for k in mark[0]}
        n_eval = mark[1] - prev[1]
        prev = mark
        per_itr.append(dict(got, eval_steps=n_eval))
        if key == "r2d1":
            win = 4 * algo.updates_per_optimize * learning[i]
            t1 = MD_T + n_eval
            want = {"lstm_input_proj": t1 + win, "lstm_fwd": t1 + win,
                    "lstm_fwd_t1": t1,
                    "lstm_bwd": algo.updates_per_optimize * learning[i]}
            got = {k: got[k] for k in want}
        else:
            want = dict.fromkeys(got, 0)
        if got != want:
            fail(f"14b {key} iteration {i + 1}: LSTM launches {got}, "
                 f"expected {want} ({n_eval} evaluation steps)")
        fields = ["StepsPerSecond", "EvalReturnAverage"] + (
            ["loss", "grad_norm", "td_abs_err"] if learning[i] else [])
        for field in fields:
            if not math.isfinite(float(row[field])):
                fail(f"14a {key}: {field} = {row[field]} in iteration "
                     f"{row['Iteration']}")
        if learning[i] and not float(row["loss"]) > 0:
            fail(f"14a {key}: loss {row['loss']} in iteration "
                 f"{row['Iteration']}")
        if int(row["EvalTrajs"]) < 1:
            fail(f"14a {key}: no evaluation episode completed")
        print(f"{key} itr {row['Iteration']}: loss {float(row['loss']):.6g}"
              f" grad_norm {float(row['grad_norm']):.6g} td_abs_err "
              f"{float(row['td_abs_err']):.6g} StepsPerSecond "
              f"{float(row['StepsPerSecond']):.1f} UpdatesPerSecond "
              f"{float(row['UpdatesPerSecond']):.1f} EvalTrajs "
              f"{row['EvalTrajs']} EvalReturnAverage "
              f"{float(row['EvalReturnAverage']):.4f}"
              + (f"; LSTM launches {per_itr[-1]}" if key == "r2d1" else ""))
    if key.startswith("ernbw"):
        replay = algo.replay
        written = replay.priorities[:replay.filled_t]
        if not (torch.isfinite(written).all() and (written > 0).all()
                and torch.isfinite(replay.max_priority)):
            fail(f"14a {key}: a written row's priority is not finite "
                 "and above 0")
    return runner, rows, per_itr


def md_dqn_batch(key: str, dev):
    """A replay batch at the config's batch size on [4, 10, 10] planes,
    drawn on a CPU generator and moved to ``dev``."""
    from rlpyt_tpu_torch.experiments.configs.minatar_dqn import configs
    from rlpyt_tpu_torch.replay.base import AgentInputs, SamplesFromReplay
    from rlpyt_tpu_torch.struct import tree_map

    n = configs[key]["algo"]["batch_size"]
    g = torch.Generator().manual_seed(40)

    def planes():
        return (torch.rand((n, 4, 10, 10), generator=g) < 0.1).to(
            torch.uint8)

    def actions():
        return torch.randint(0, 6, (n,), generator=g)

    zeros = torch.zeros((n,))
    done = torch.rand((n,), generator=g) < 0.1
    b = SamplesFromReplay(
        AgentInputs(planes(), actions(), zeros), actions(),
        torch.randn((n,), generator=g), done, done,
        (torch.rand((n,), generator=g) < 0.1) & ~done,
        AgentInputs(planes(), actions(), zeros), torch.ones((n,)),
        (zeros.long(), zeros.long()))
    return tree_map(lambda x: x.to(dev), b)


def check_minatar_dqn_against_cpu(dev):
    """Phase 14c: one update of dqn_pub (centered RMSprop, decay 0.95,
    eps 0.01) and one of dqn (Adam at eps 0.01 / 128), each through
    ``make_optimizer`` with clip 10, at the config's model (conv 16, fc
    128) and batch size, on the card against the CPU from the same
    weights and batch; TF32 off.  Infos to 1e-4, the gradients and
    parameters as ``hold_update`` says."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.experiments.configs.minatar_dqn import configs
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    spaces = Breakout(device="cpu").spaces
    for key in ("dqn_pub", "dqn"):
        cfg = configs[key]
        out = {}
        for d in ("cpu", dev):
            agent = DqnAgent(model_kwargs=cfg["model"], device=d)
            torch.manual_seed(0)
            agent.initialize(spaces)
            before = {k: v.detach().clone().cpu()
                      for k, v in agent.model.state_dict().items()}
            algo = DQN(**dict(cfg["algo"], replay_size=4096))
            algo.initialize(agent, BatchSpec(MD_T, MD_B),
                            torch.zeros((MD_B, 4, 10, 10), dtype=torch.uint8,
                                        device=d), torch.Generator(device=d))
            grads = spy_grads({"model": algo.optimizer}, {"model": [
                n for n, _ in agent.model.named_parameters()]})
            info = algo.update(md_dqn_batch(key, d))
            after = {k: v.detach().cpu()
                     for k, v in agent.model.state_dict().items()}
            out[d] = (info, before, after, grads, algo.optimizer)
        (info_c, before, after_c, grads_c, opt), \
            (info_g, _, after_g, grads_g, _) = out["cpu"], out[dev]
        for field in info_c._fields:
            w, got = (float(getattr(i, field)) for i in (info_c, info_g))
            if not abs(got - w) <= 1e-4 * max(1.0, abs(w)):
                fail(f"phase 14c {key}: {field} {got!r} on the card, {w!r} "
                     "on the CPU")
        diff, change, n_tiny, tiny_diff = hold_update(
            f"phase 14c {key}", before, after_c, after_g, grads_c, grads_g)
        group = opt.inner.param_groups[0]
        print(f"phase 14c: {key} update ({type(opt.inner).__name__}, "
              f"eps {group['eps']:g}, lr {group['lr']:g}) card against "
              f"CPU: loss {float(info_g.loss):.6g} / "
              f"{float(info_c.loss):.6g}, grad_norm "
              f"{float(info_g.grad_norm):.6g} / {float(info_c.grad_norm):.6g}"
              f"; first-step gradients within 1e-4; params differ by "
              f"{diff:.3g} = {diff / change:.3g} of the largest change "
              f"({n_tiny} elements with a gradient RMS below "
              f"{ADAM_TINY_GRAD:g} excluded, their largest diff "
              f"{tiny_diff:.3g})")


def time_lstm_h128(L, g, dev, tag: str, suffix: str, win_T: int,
                   burn_T: int, batch_b: int, collect_B: int, eval_B: int):
    """K3a, K3 and K4 at an R2D1 config's shapes on MinAtar Breakout
    (F=1031, H=128) beside their plain versions, bounds and library
    calls.  Entries (each name followed by ``suffix``): K3a at the
    training window's win_T * batch_b rows, K3 and K4 at that window, K3
    at a collection step (T=1, collect_B lanes).  Printed: K3a at the
    burn-in's rows, a collection step's and an evaluation step's, K3 at
    the burn-in (burn_T) and an evaluation step (T=1, eval_B lanes)."""
    F, H = MD_F, MD_H
    win = lstm_case(g, win_T, batch_b, F, H, dev)
    burn = lstm_case(g, burn_T, batch_b, F, H, dev)
    wx, b = win["wx"], win["b"]
    entries = add_bounds({
        "lstm_input_proj" + suffix: proj_times(
            L, win["x"].view(-1, F), [wx], b, 50),
        "lstm_fwd" + suffix: fwd_times(L, win, dev, 50, 10),
        "lstm_fwd_t1" + suffix: fwd_times(
            L, lstm_case(g, 1, collect_B, F, H, dev), dev, 50, 20),
        "lstm_bwd" + suffix: bwd_times(L, win, g, dev, 50, 10),
    })
    printed = add_bounds({
        f"lstm_input_proj M={burn_T * batch_b}": proj_times(
            L, burn["x"].view(-1, F), [wx], b, 50),
        **{f"lstm_input_proj M={M}": proj_times(
            L, torch.randn((M, F), generator=g, device=dev), [wx], b, 50)
           for M in (collect_B, eval_B)},
        f"lstm_fwd T={burn_T} B={batch_b}": fwd_times(L, burn, dev, 50, 10),
        f"lstm_fwd T=1 B={eval_B}": fwd_times(
            L, lstm_case(g, 1, eval_B, F, H, dev), dev, 50, 20),
    })
    for name, t in list(entries.items()) + list(printed.items()):
        print(f"{tag}: {name} call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms; library call "
              f"{t['library_ms']:.4f} ms"
              + (f", device {t['library_device_ms']:.4f} ms"
                 if t.get("library_device_ms") else "")
              + f"; plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['ops']} "
              f"operations, {t['bytes']} bytes)")
    return entries


def time_lstm_minatar_r2d1(L, g, dev):
    """Phase 14d: the r2d1 config's shapes: the training window (T=45,
    B=32, 1440 rows), the burn-in (T=20), a collection step (T=1, B=64)
    and an evaluation step (T=1, B=32)."""
    return time_lstm_h128(L, g, dev, "phase 14d", "_minatar_r2d1",
                          MD_WINDOW - MD_WARMUP, MD_WARMUP, MD_BATCH_B, MD_B,
                          MD_EVAL_B)


def check_snapshot(runner, log_dir: Path, dev):
    """Phase 14e: the params.pkl that build_and_train wrote (the flax
    tree of the last iteration's weights, numpy) loads through params.py
    into a fresh model on the card, which gives the live model's Q values
    and next state on a batch of the run's observations to 1e-6."""
    import pickle

    from rlpyt_tpu_torch.params import from_jax_params

    snap = pickle.loads((log_dir / "run_0" / "params.pkl").read_bytes())
    live = runner.agent.model
    fresh = copy.deepcopy(live)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in
                           from_jax_params(snap["params"]).items()})
    st = runner.rollout_state
    with torch.no_grad():
        q, (h, _) = live(st.observation, st.prev_action, st.prev_reward,
                         st.agent_carry)
        q2, (h2, _) = fresh(st.observation, st.prev_action, st.prev_reward,
                            st.agent_carry)
    err = max(float((q2 - q).abs().max()), float((h2 - h).abs().max()))
    if not err <= 1e-6 * max(1.0, float(q.abs().max())):
        fail(f"phase 14e: the snapshot's model differs from the live one "
             f"by {err:.3g}")
    print(f"phase 14e: params.pkl (itr {int(snap['itr'])}, cum_steps "
          f"{int(snap['cum_steps'])}, {len(from_jax_params(snap['params']))}"
          f" tensors) gives the live model's Q and h on the card: max diff "
          f"{err:.3g}")


# Phase 15: the host-env path, rlpyt_tpu_torch/experiments/scripts/
# atari_dqn.py with its dqn, ernbw and r2d1 configs on FakeALE, the farms
# spawned with the C barrier.  The configs' widths: Nature CNN on 32 env
# lanes; dqn and ernbw T=4, batch 32, 32 updates an iteration, frame
# replay of 1M frames; r2d1 LSTM 512 (F = conv 6912 + FakeALE's 4 actions
# + the reward) on T=40, one update an iteration of 32 windows of 40 + 80
# + 5 rows, sequence replay of 1M; evaluation on 4 lanes.
AT_B, AT_EVAL_B, AT_FARM_STEPS = 32, 4, 200
AT_F, AT_H = 64 * 12 * 9 + 4 + 1, 512
AT_WARMUP, AT_BATCH_T, AT_NSTEP, AT_R2D1_T = 40, 80, 5, 40
# Iterations of each run and its cut of min_steps_learn (the configs'
# 50,000 and 20,000 steps): three learning iterations each.  r2d1's
# first window start with 125 rows after it (slot 1, row 40) is written
# after five iterations of 40 rows.
AT_ITR = {"dqn": 4, "ernbw": 4, "r2d1": 7}
# The AsyncHostRl run (dqn): long enough past the actor's head start of
# two batches for a steady rate, logged and evaluated once at its end.
AT_ASYNC_ITR = 12
AT_LEARN = {"dqn": 2 * 4 * AT_B, "ernbw": 2 * 4 * AT_B,
            "r2d1": 5 * AT_R2D1_T * AT_B}
# Evaluation caps: 100 steps a lane and 8 episodes (the configs' 125,000
# steps and 100 episodes).
AT_EVAL_CUT = {"eval_max_steps": AT_EVAL_B * 100, "eval_max_trajectories": 8}
# r2d1's LSTM shapes: the training window (85, 32), the burn-in (40, 32),
# a collection step (1, 32) and an evaluation step (1, 4).
AT_WINDOW = AT_BATCH_T + AT_NSTEP
AT_CASES = [(AT_WINDOW, AT_B, AT_F, AT_H), (AT_WARMUP, AT_B, AT_F, AT_H),
            (1, AT_B, AT_F, AT_H), (1, AT_EVAL_B, AT_F, AT_H)]


def at_launches(fg, L) -> dict:
    return {"frame_gather": fg.gather_frame_stacks.launches,
            **md_launches(L)}


def check_atari_farm():
    """Phase 15a: a 32-env SharedMemVecEnv of AtariEnv(FakeALE) (the dqn
    config's env: sticky actions 0.25, up to 30 no-ops, episodic lives),
    spawned, with the C barrier, steps AT_FARM_STEPS times beside a
    SerialVecEnv of the same factories and seeds under the same actions;
    observations, rewards, dones, timeouts, game_score and traj_done must
    be equal bit for bit.  Returns (sync_impl, host ms of a farm step)."""
    import numpy as np

    from rlpyt_tpu_torch.envs.host import SerialVecEnv, SharedMemVecEnv
    from rlpyt_tpu_torch.experiments.configs.atari_dqn import configs
    from rlpyt_tpu_torch.experiments.scripts.atari_dqn import make_env_fn

    fns = [make_env_fn(dict(configs["dqn"]["env"], fake=True), b)
           for b in range(AT_B)]
    serial = SerialVecEnv(fns, seed=0)
    farm = SharedMemVecEnv(fns, seed=0, sync="c")
    try:
        if farm.start_method != "spawn" or farm.sync_impl != "c":
            fail(f"15a: farm started by {farm.start_method} with "
                 f"{farm.sync_impl}, not spawn with c")
        rng = np.random.RandomState(0)
        if not np.array_equal(farm.reset(), serial.reset()):
            fail("15a: reset observations differ")
        farm_s, n_done, n_traj = 0.0, 0, 0
        for i in range(AT_FARM_STEPS):
            acts = rng.randint(0, 4, size=AT_B)
            t0 = time.perf_counter()
            out = farm.step(acts)
            farm_s += time.perf_counter() - t0
            ref = serial.step(acts)
            for what, x, y in zip(("obs", "reward", "done", "timeout"),
                                  out, ref):
                if not np.array_equal(x, y):
                    fail(f"15a: {what} differs at step {i}")
            for k in ("game_score", "traj_done"):
                if not np.array_equal(farm.info[k], serial.info[k]):
                    fail(f"15a: {k} differs at step {i}")
            n_done += int(ref[2].sum())
            n_traj += int(serial.info["traj_done"].sum())
    finally:
        farm.close()
        serial.close()
    ms = 1e3 * farm_s / AT_FARM_STEPS
    print(f"phase 15a: {AT_B}-env farm ({len(farm._procs)} spawned workers,"
          f" sync {farm.sync_impl}) equals the serial farm bit for bit over "
          f"{AT_FARM_STEPS} steps ({n_done} dones, {n_traj} ended games); "
          f"host ms a farm step {ms:.4f}")
    return farm.sync_impl, ms


def run_atari(fg, L, key: str, log_root: Path, asynchronous=False):
    """Phases 15b-e: the script's ``build_runner(key)`` (what
    ``build_and_train`` trains) with ``env.fake=True`` at the config's
    widths, batch, replay size, replay ratio and schedules for
    AT_ITR[key] iterations, evaluating after each; only n_steps,
    log_interval_steps, min_steps_learn (AT_LEARN) and the evaluation caps
    are cut.  The farms must have spawned with the C barrier.  Checks the
    update count, finite losses once learning, the Eval keys with
    GameScore and a completed evaluation episode, and the launches of
    every iteration: dqn and ernbw one frame gather an update and no LSTM
    launch; r2d1 no gather, T collection steps and every evaluation step
    one K3a and one one-step K3 each, per update four forward windows
    (K3a, K3) and one backward (K4).  Synchronous runs also time each
    collection (host ms a farm step and the rest of a step) and each
    optimize (device synced).  ``asynchronous``: an AsyncHostRl on the
    same farms, agent and algorithm, AT_ASYNC_ITR iterations in one
    logged interval; its rate is timed from the first collection to the
    evaluation, which starts after the learner's last optimize.  Returns
    (runner, rows, per-iteration counts, timings)."""
    import contextlib
    import csv
    import io

    from rlpyt_tpu_torch.envs.host import SharedMemVecEnv
    from rlpyt_tpu_torch.experiments.configs.atari_dqn import configs
    from rlpyt_tpu_torch.experiments.scripts.atari_dqn import build_runner
    from rlpyt_tpu_torch.runners.host import AsyncHostRl, HostMinibatchRl
    from rlpyt_tpu_torch.utils.logging import logger_context

    cfg = configs[key]
    T = cfg["sampler"]["batch_T"]
    steps = T * AT_B
    n_itr = AT_ASYNC_ITR if asynchronous else AT_ITR[key]
    overrides = {"env": {"fake": True}, "eval_env": {"fake": True},
                 "runner": {"n_steps": n_itr * steps,
                            "log_interval_steps": (n_itr if asynchronous
                                                   else 1) * steps},
                 "algo": {"min_steps_learn": AT_LEARN[key]},
                 "sampler": dict(AT_EVAL_CUT)}
    runner, config = build_runner(key, config_overrides=overrides)
    farms = (runner.vec, runner.eval_vec)
    if any(f.start_method != "spawn" or f.sync_impl != "c" for f in farms):
        for f in farms:
            f.close()
        fail(f"15 {key}: farms started by "
             f"{[(f.start_method, f.sync_impl) for f in farms]}, not "
             "spawn with c")
    if asynchronous:
        r = runner
        runner = AsyncHostRl(
            algo=r.algo, agent=r.agent, vec_env=r.vec,
            batch_T=r.batch_spec.T, n_steps=r.n_steps, seed=r.seed,
            log_interval_steps=r.log_interval_steps, eval_vec_env=r.eval_vec,
            eval_max_steps=r.eval_max_steps,
            eval_max_trajectories=r.eval_max_trajectories, device=r.device)
    tm = {"eval_steps": 0, "farm_s": 0.0, "collect_s": [], "optimize_s": [],
          "first_collect": None, "eval_start": []}
    marks = []      # (launch counts, evaluation steps) at each dump
    agent_step = HostMinibatchRl._agent_step
    evaluate = HostMinibatchRl._evaluate
    farm_step = SharedMemVecEnv.step

    def counted(self, *args, is_eval=False, **kwargs):
        tm["eval_steps"] += is_eval
        return agent_step(self, *args, is_eval=is_eval, **kwargs)

    def timed_step(self, actions):
        t0 = time.perf_counter()
        out = farm_step(self, actions)
        if self.B == AT_B:
            tm["farm_s"] += time.perf_counter() - t0
        return out

    def marked_evaluate(self):
        tm["eval_start"].append(time.perf_counter())
        return evaluate(self)

    HostMinibatchRl._agent_step = counted
    HostMinibatchRl._evaluate = marked_evaluate
    SharedMemVecEnv.step = timed_step
    if asynchronous:
        collect = runner._collect_batch

        def first_timed_collect():
            if tm["first_collect"] is None:
                tm["first_collect"] = time.perf_counter()
            return collect()

        runner._collect_batch = first_timed_collect
    else:
        collect, optimize = runner._collect_batch, runner.algo.optimize

        def timed_collect():
            t0 = time.perf_counter()
            out = collect()
            torch.cuda.synchronize()
            tm["collect_s"].append(time.perf_counter() - t0)
            return out

        def timed_optimize(samples, rollout_state):
            t0 = time.perf_counter()
            out = optimize(samples, rollout_state)
            torch.cuda.synchronize()
            tm["optimize_s"].append(time.perf_counter() - t0)
            return out

        runner._collect_batch = timed_collect
        runner.algo.optimize = timed_optimize
    zero_launches()
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                logger_context(str(log_root / key), 0, key,
                               config=config) as logger:
            dump = logger.dump_tabular

            def marked(*args, **kwargs):
                marks.append((at_launches(fg, L), tm["eval_steps"]))
                return dump(*args, **kwargs)

            logger.dump_tabular = marked
            runner.logger = logger
            runner.train()
            torch.cuda.synchronize()
    finally:
        HostMinibatchRl._agent_step = agent_step
        HostMinibatchRl._evaluate = evaluate
        SharedMemVecEnv.step = farm_step
        runner.vec.close()
        runner.eval_vec.close()
    with open(log_root / key / "run_0" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    algo = runner.algo
    name = key + (" (AsyncHostRl)" if asynchronous else "")
    learning = [(i + 1) * steps >= AT_LEARN[key] for i in range(n_itr)]
    upd = algo.updates_per_optimize
    # AsyncHostRl writes no row before the learner's first optimize ends
    # (as the JAX package's): its rows are its dumps.
    n_rows = len(marks) if asynchronous else n_itr
    if len(rows) != n_rows or len(marks) != len(rows) \
            or algo.update_counter != sum(learning) * upd:
        fail(f"15 {name}: {algo.update_counter} updates in {len(rows)} "
             f"rows, expected {sum(learning)} x {upd} in {n_rows}")
    per_itr, prev = [], (dict.fromkeys(at_launches(fg, L), 0), 0)
    for i, (row, mark) in enumerate(zip(rows, marks)):
        got = {k: mark[0][k] - prev[0][k] for k in mark[0]}
        n_eval = mark[1] - prev[1]
        prev = mark
        per_itr.append(dict(got, eval_steps=n_eval))
        n_upd = upd * learning[i]
        if key == "r2d1":
            t1 = T + n_eval
            want = {"frame_gather": 0, "lstm_input_proj": t1 + 4 * n_upd,
                    "lstm_fwd": t1 + 4 * n_upd, "lstm_fwd_t1": t1,
                    "lstm_bwd": n_upd}
            got = {k: got[k] for k in want}
        else:
            want = dict.fromkeys(got, 0)
            want.pop("lstm_input_proj_split")
            got = {k: got[k] for k in want}
            want["frame_gather"] = n_upd
        # The learner thread may finish an optimize after the actor's
        # dump: an async run is held to its total below.
        if got != want and not asynchronous:
            fail(f"15 {name} iteration {i + 1}: launches {got}, expected "
                 f"{want} ({n_eval} evaluation steps)")
        fields = ["StepsPerSecond", "EvalReturnAverage",
                  "EvalGameScoreAverage", "GameScoreAverage"] + (
            ["loss", "grad_norm", "td_abs_err"] if learning[i]
            or asynchronous else [])
        for field in fields:
            if not math.isfinite(float(row[field])):
                fail(f"15 {name}: {field} = {row[field]} in iteration "
                     f"{row['Iteration']}")
        if learning[i] and not asynchronous and not float(row["loss"]) > 0:
            fail(f"15 {name}: loss {row['loss']} in iteration "
                 f"{row['Iteration']}")
        if int(row["EvalTrajs"]) < 1:
            fail(f"15 {name}: no evaluation episode completed")
        print(f"atari {name} itr {row['Iteration']}: loss "
              f"{float(row['loss']):.6g} td_abs_err "
              f"{float(row['td_abs_err']):.6g} StepsPerSecond "
              f"{float(row['StepsPerSecond']):.1f} EvalTrajs "
              f"{row['EvalTrajs']} EvalGameScoreAverage "
              f"{float(row['EvalGameScoreAverage']):.4f}; launches "
              f"{per_itr[-1]}")
    total = {k: sum(it[k] for it in per_itr) for k in per_itr[0]}
    if asynchronous:
        if total["frame_gather"] != algo.update_counter or any(
                total[k] for k in ("lstm_input_proj", "lstm_fwd",
                                   "lstm_bwd")):
            fail(f"15e: launches {total} for {algo.update_counter} updates")
        if not float(rows[-1]["loss"]) > 0:
            fail(f"15e: loss {rows[-1]['loss']} in the last iteration")
        lags = runner.actor_lags
        if not all(0 <= lag <= 2 for lag in lags):
            fail(f"15e: actor parameter lags {lags}, not within 2 batches")
    return runner, rows, per_itr, tm


def check_atari_replay(runner, key: str, dev):
    """Phase 15c (ernbw): priorities finite and above 0 on every written
    row; a prioritized batch's importance weights in (0, 1]."""
    replay = runner.algo.replay
    written = replay.priorities[:replay.filled_t]
    if not (torch.isfinite(written).all() and (written > 0).all()
            and torch.isfinite(replay.max_priority)):
        fail(f"15c {key}: a written row's priority is not finite and "
             "above 0")
    g = torch.Generator(device=dev).manual_seed(15)
    w = replay.sample(runner.algo.batch_size, g).is_weights
    if not bool(((w > 0) & (w <= 1)).all()):
        fail(f"15c {key}: importance weights outside (0, 1]: "
             f"{w.min().item()} .. {w.max().item()}")
    print(f"phase 15c: {key} priorities finite and > 0 on "
          f"{written.numel()} written entries; importance weights in "
          f"[{w.min().item():.4g}, {w.max().item():.4g}]")


def check_atari_sequence_replay(runner, key: str):
    """Phase 15d (r2d1): every written slot's priority finite and above
    0."""
    replay = runner.algo.replay
    n = replay.filled_t // replay.interval
    written = replay.priorities[:n]
    if not (torch.isfinite(written).all() and (written > 0).all()):
        fail(f"15d {key}: a written slot's priority is not finite and "
             "above 0")
    print(f"phase 15d: {key} priorities finite and > 0 on {written.numel()}"
          " written slots")


def time_atari_kernels(fg, L, g, dev, errs):
    """Phase 15f: the frame gather at the configs' batch of 32 on the
    configs' ring of 1M frames (31,250 rows of 32 lanes, 8.3 GB, filled),
    U = 5 (dqn) and U = 7 (ernbw), held bit for bit against its plain
    version first (starts spread over every row, the last lanes of the
    last rows and starts that wrap: byte offsets past 2^32) and then
    timed; K3a, K3 and K4 at the r2d1 config's shapes (F, H = AT_F, 512)
    beside their plain versions, bounds and library calls.  LSTM entries:
    K3a at the training window's 2720 rows, K3 and K4 at that window
    (T=85, B=32), K3 at a collection step (T=1, B=32).  Printed: K3a at
    1280 (burn-in), 32 (collection) and 4 rows (evaluation), K3 at the
    burn-in (T=40, B=32) and an evaluation step (T=1, B=4).  The gather's
    errors go into ``errs``."""
    size_T, F = 1_000_000 // AT_B, 8320
    ring = torch.randint(0, 256, (size_T, AT_B, F), generator=g, device=dev,
                         dtype=torch.uint8)
    gathers = {}
    for name, n in (("frame_gather_atari_cfg", 1),
                    ("frame_gather_u7_atari_cfg", 3)):
        _, start, b_idx, ma, mt = random_case(g, size_T, AT_B, 16, AT_B, 4,
                                              n, dev)
        # random_case puts starts 0-7 on the last 8 rows (they wrap);
        # their lanes are the last 8, the rest spread over every row.
        b_idx[:8] = torch.arange(AT_B - 8, AT_B, device=dev)
        start[8:] = torch.linspace(0, size_T - 9, AT_B - 8,
                                   device=dev).long()
        errs[name] = hold_gather(fg, f"{name} (1M-frame ring, n={n})", ring,
                                 start, b_idx, ma, mt, 4, n)
        gathers[name] = time_gather(fg, g, dev, n, size_T, AT_B, AT_B, ring)
    del ring
    torch.cuda.empty_cache()
    F, H = AT_F, AT_H
    win = lstm_case(g, AT_WINDOW, AT_B, F, H, dev)
    burn = lstm_case(g, AT_WARMUP, AT_B, F, H, dev)
    wx, b = win["wx"], win["b"]
    entries = add_bounds({
        "lstm_input_proj_atari_r2d1": proj_times(
            L, win["x"].view(-1, F), [wx], b, 20),
        "lstm_fwd_atari_r2d1": fwd_times(L, win, dev, 20, 5),
        "lstm_fwd_t1_atari_r2d1": fwd_times(
            L, lstm_case(g, 1, AT_B, F, H, dev), dev, 50, 20),
        "lstm_bwd_atari_r2d1": bwd_times(L, win, g, dev, 20, 5),
    })
    printed = add_bounds({
        f"lstm_input_proj M={AT_WARMUP * AT_B}": proj_times(
            L, burn["x"].view(-1, F), [wx], b, 20),
        **{f"lstm_input_proj M={M}": proj_times(
            L, torch.randn((M, F), generator=g, device=dev),
            [wx, wx.clone()], b, 50) for M in (AT_B, AT_EVAL_B)},
        f"lstm_fwd T={AT_WARMUP} B={AT_B}": fwd_times(L, burn, dev, 20, 5),
        f"lstm_fwd T=1 B={AT_EVAL_B}": fwd_times(
            L, lstm_case(g, 1, AT_EVAL_B, F, H, dev), dev, 50, 20),
    })
    for name, t in gathers.items():
        print(f"phase 15f: {name} call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms (int32 indices "
              f"{t['device_int32_ms']:.4f}); index_select call "
              f"{t['library_ms']:.4f} ms, device "
              f"{t['library_device_ms']:.4f} ms; plain {t['plain_ms']:.4f}"
              f" ms; bound {t['bound_ms']:.5f} ms ({t['bytes']} bytes)")
    for name, t in list(entries.items()) + list(printed.items()):
        print(f"phase 15f: {name} call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms; library call "
              f"{t['library_ms']:.4f} ms"
              + (f", device {t['library_device_ms']:.4f} ms"
                 if t.get("library_device_ms") else "")
              + f"; plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['ops']} "
              f"operations, {t['bytes']} bytes)")
    return {**gathers, **entries}


def run_host_path(fg, L, g, dev, errs, times, launches, tf32):
    """Phase 15, the host path: (a) the farm, (b) dqn, (c) ernbw, (d)
    r2d1, (e) dqn under AsyncHostRl, (f) the kernels at the configs'
    shapes."""
    import statistics

    t0 = time.time()
    check_atari_farm()
    counts = {}
    with tempfile.TemporaryDirectory() as log_root:
        for key, phase in (("dqn", "b"), ("ernbw", "c"), ("r2d1", "d")):
            t1 = time.time()
            runner, rows, per_itr, tm = run_atari(fg, L, key, Path(log_root))
            algo = runner.algo
            T = runner.batch_spec.T
            farm_ms = 1e3 * tm["farm_s"] / (T * len(tm["collect_s"]))
            rest_ms = [round(1e3 * c / T - farm_ms, 3)
                       for c in tm["collect_s"]]
            upd_ms = [round(1e3 * o / algo.updates_per_optimize, 3)
                      for o, r in zip(tm["optimize_s"], rows)
                      if float(r["loss"]) > 0]
            counts[key] = {k: sum(it[k] for it in per_itr)
                           for k in per_itr[0]}
            if key == "dqn":
                dqn_sps = [float(r["StepsPerSecond"]) for r in rows
                           if float(r["loss"]) > 0]
            print(f"phase 15{phase}: {key} {AT_ITR[key]} iterations at the "
                  f"config's widths in {time.time() - t1:.1f} s (cuts "
                  f"n_steps {runner.n_steps}, log_interval_steps "
                  f"{runner.log_interval_steps}, min_steps_learn "
                  f"{AT_LEARN[key]}, {AT_EVAL_CUT}), "
                  f"{algo.update_counter} updates "
                  f"({algo.updates_per_optimize} an iteration once "
                  f"learning); env-steps/s per iteration "
                  f"{[round(float(r['StepsPerSecond']), 1) for r in rows]};"
                  f" host ms a farm step {farm_ms:.3f}, the rest of a "
                  f"collection step (agent step, copies) {rest_ms}, an "
                  f"update (device synced) {upd_ms} (median "
                  f"{statistics.median(upd_ms):.3f}); launches in all "
                  f"{counts[key]}")
            if key == "ernbw":
                check_atari_replay(runner, key, dev)
            if key == "r2d1":
                check_atari_sequence_replay(runner, key)
            del runner, algo
            torch.cuda.empty_cache()
        t1 = time.time()
        runner, rows, per_itr, tm = run_atari(fg, L, "dqn", Path(log_root)
                                              / "async", asynchronous=True)
        steps = AT_ASYNC_ITR * runner.batch_spec.size
        span = tm["eval_start"][-1] - tm["first_collect"]
        print(f"phase 15e: dqn under AsyncHostRl {AT_ASYNC_ITR} iterations"
              f" in {time.time() - t1:.1f} s, {runner.algo.update_counter} "
              f"updates, actor parameter lag per batch {runner.actor_lags}"
              f"; {steps} env-steps from the first collection to the end "
              f"of the learner's last optimize in {span:.3f} s: "
              f"{steps / span:.1f} env-steps/s (the logged actor's rate "
              f"{float(rows[-1]['StepsPerSecond']):.1f}; HostMinibatchRl's "
              f"learning iterations in 15b {dqn_sps}), last loss "
              f"{float(rows[-1]['loss']):.6g}")
        del runner
        torch.cuda.empty_cache()
    launches.update({
        "frame_gather_atari_cfg": counts["dqn"]["frame_gather"],
        "frame_gather_u7_atari_cfg": counts["ernbw"]["frame_gather"],
        "lstm_input_proj_atari_r2d1": counts["r2d1"]["lstm_input_proj"],
        "lstm_fwd_atari_r2d1": (counts["r2d1"]["lstm_fwd"]
                                - counts["r2d1"]["lstm_fwd_t1"]),
        "lstm_fwd_t1_atari_r2d1": counts["r2d1"]["lstm_fwd_t1"],
        "lstm_bwd_atari_r2d1": counts["r2d1"]["lstm_bwd"]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs.update(check_lstm(L, g, dev, AT_CASES, "_atari_r2d1"))
    times.update(time_atari_kernels(fg, L, g, dev, errs))
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 15: {time.time() - t0:.1f} s")


# Phase 16: the rest of the single-device runner.  16a and 16b run in a
# child process with deterministic cuBLAS (CUBLAS_WORKSPACE_CONFIG) and
# torch.use_deterministic_algorithms(True); the rest in this process.
# 16a: the flagship DQN of phase 4 with its replay cut from 200,000 to
# P16_REPLAY transitions, so that a checkpoint stays under 1 GB (800 rows
# x 128 lanes x 8320 bytes of frames).
P16_REPLAY = 100_000
P16_ITR = 4                  # 16a: iterations (one a log interval)
# 16b-16d: rlpyt_tpu_torch/examples/example_5.py (R2D1, LSTM 128, B=32,
# T=40, batch 32 windows of 20 + 40 + 5 rows) at its widths.  Cuts: the
# log interval (50,000) to two iterations of 1280 steps, n_steps (1M) to
# four intervals; min_steps_learn stays the example's 5000 (learning from
# the fourth iteration).
EX5_LOG = 2_560
EX5_N_STEPS = 4 * EX5_LOG
EX5_RATE_N_STEPS = 6 * EX5_LOG   # 16f: each timed run, 12 iterations
EX5_EVAL = dict(eval_n_envs=8, eval_max_steps=800, eval_max_trajectories=4)
WAIT_T = 128                 # 16d: the wait-reset batch's steps
TIME_KEYS = ("CumTime (s)", "StepsPerSecond", "UpdatesPerSecond")


def state_leaves(tree, path=""):
    """(path, leaf) of every tensor and Python value of a state tree."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from state_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from state_leaves(x, f"{path}/{i}")
    else:
        yield path, tree


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(
                    a.reshape(-1).contiguous().view(torch.uint8),
                    b.reshape(-1).contiguous().view(torch.uint8)))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


def hold_states(tag: str, got: dict, want: dict) -> int:
    """Every leaf of two runners' state_dict() equal bit for bit; returns
    the number of leaves."""
    got, want = dict(state_leaves(got)), dict(state_leaves(want))
    if sorted(got) != sorted(want):
        fail(f"{tag}: the states have other leaves")
    bad = [k for k in want if not same_bits(got[k], want[k])]
    if bad:
        fail(f"{tag}: {len(bad)} of {len(want)} state leaves differ, "
             f"first {bad[:6]}")
    return len(want)


def hold_rows(tag: str, got: list, want: list):
    """The logged rows equal apart from the time columns."""
    if len(got) != len(want):
        fail(f"{tag}: {len(got)} logged rows against {len(want)}")
    for g, w in zip(got, want):
        diff = [k for k in w if k not in TIME_KEYS
                and not same_bits(g.get(k), w[k])]
        if list(g) != list(w) or diff:
            fail(f"{tag}: row {w.get('Iteration')} differs in {diff}")


def checkpoint_io(runner, path: Path) -> dict:
    """Size of the checkpoint at ``path``, and the seconds of one more
    save of the runner's state and of one load of ``path`` onto the
    card."""
    from rlpyt_tpu_torch.utils.checkpoint import load_checkpoint, \
        save_checkpoint

    like = runner.state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(path.with_name("timed.pkl")), like, {"interval": 0})
    t1 = time.perf_counter()
    state, _ = load_checkpoint(str(path), like=like)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del state
    return {"bytes": path.stat().st_size, "save_s": t1 - t0,
            "load_s": t2 - t1}


def resume_flagship(fg, dev, tmp: Path) -> dict:
    """16a: the flagship DQN, 4 intervals uninterrupted; 2 with a
    checkpoint; a fresh runner resumed to 4: every tensor of state_dict()
    and every logged row (time columns aside) equal, bit for bit."""
    def make(n_itr, logger, checkpoint_dir=None):
        runner = build_flagship_runner(dev, n_itr, logger)
        runner.algo.replay_size = P16_REPLAY
        runner.checkpoint_dir = checkpoint_dir
        return runner

    full_log, first_log, resumed_log = row_logger(), row_logger(), \
        row_logger()
    full = make(P16_ITR, full_log).train()
    first = make(P16_ITR // 2, first_log, str(tmp))
    first.train()
    path = tmp / "checkpoint.pkl"
    io = checkpoint_io(first, path)
    del first
    resumed_runner = make(P16_ITR, resumed_log)
    zero_launches()
    resumed = resumed_runner.train(resume_from=str(path))
    torch.cuda.synchronize()
    launches = fg.gather_frame_stacks.launches
    if launches <= 0:
        fail("16a: no frame-gather launch in the resumed run")
    n = hold_states("16a", resumed, full)
    hold_rows("16a", first_log.rows + resumed_log.rows, full_log.rows)
    print(f"phase 16a: flagship DQN (replay cut to {P16_REPLAY}) stopped "
          f"after {P16_ITR // 2} of {P16_ITR} intervals and resumed: "
          f"{n} state leaves and {len(full_log.rows)} rows equal bit for "
          f"bit; frame-gather launches in the resumed part {launches}; "
          f"checkpoint {io['bytes']} bytes, save {io['save_s']:.3f} s, "
          f"load {io['load_s']:.3f} s")
    return {"gather_launches": launches, "checkpoint": io}


@contextmanager
def count_syncs(counts: dict, where: list):
    """Count the host syncs that torch's sync debug mode reports, by the
    port's source line that caused each (the innermost frame under
    rlpyt_tpu_torch/), and by the part of the run in ``where[0]`` at the
    time (startup, interval, drain, loop)."""
    import traceback
    import warnings

    root = str(Path(__file__).resolve().parent) + "/"

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = next((f for f in reversed(traceback.extract_stack()[:-1])
                     if "rlpyt_tpu_torch" in f.filename), None)
        key = (f"{site.filename.replace(root, '')}:{site.lineno}" if site
               else f"{filename}:{lineno}")
        key = f"{where[0]} {key}"
        counts[key] = counts.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)


def example5_equal_and_resume(L, dev, tmp: Path) -> dict:
    """16b: example 5 under AsyncRl(pipeline_depth=2) equal bit for bit
    to MinibatchRl; a resume from its mid-run checkpoint equal to the
    uninterrupted run; K3a/K3/K4 launches and host syncs of the AsyncRl
    run."""
    from rlpyt_tpu_torch.examples import example_5
    from rlpyt_tpu_torch.runners.train import MinibatchRl

    kw = dict(device=dev, log_interval_steps=EX5_LOG)
    sync_log, async_log, first_log, resumed_log = (row_logger()
                                                  for _ in range(4))
    sync = example_5.build_runner(EX5_N_STEPS, runner_cls=MinibatchRl,
                                  logger=sync_log, **kw).train()
    runner = example_5.build_runner(EX5_N_STEPS, logger=async_log, **kw)
    counts, where = {}, ["startup"]

    def marked(part, fn):
        def call(*args):
            where[0] = part
            try:
                return fn(*args)
            finally:
                where[0] = "loop"
        return call

    runner.run_interval = marked("interval", runner.run_interval)
    runner._drain = marked("drain", runner._drain)
    zero_launches()
    with count_syncs(counts, where):
        full = runner.train()
    torch.cuda.synchronize()
    launches = {"lstm_input_proj": L.input_proj.launches,
                "lstm_fwd_t1": L.lstm_fwd.step_launches,
                "lstm_fwd_window": L.lstm_fwd.launches
                - L.lstm_fwd.step_launches,
                "lstm_bwd": L.lstm_bwd.launches}
    n_intervals = len(async_log.rows)
    updates = runner.algo.update_counter
    steps = EX5_N_STEPS // runner.batch_spec.B   # collection steps
    want = {"lstm_input_proj": steps + 4 * updates, "lstm_fwd_t1": steps,
            "lstm_fwd_window": 4 * updates, "lstm_bwd": updates}
    if updates <= 0 or launches != want:
        fail(f"16b: LSTM launches {launches} with {updates} updates, "
             f"expected {want}")
    n = hold_states("16b AsyncRl against MinibatchRl", full, sync)
    hold_rows("16b AsyncRl against MinibatchRl", async_log.rows,
              sync_log.rows)
    example_5.build_runner(EX5_N_STEPS // 2, logger=first_log,
                           checkpoint_dir=str(tmp), **kw).train()
    path = tmp / "checkpoint.pkl"
    io = checkpoint_io(runner, path)
    resumed = example_5.build_runner(EX5_N_STEPS, logger=resumed_log,
                                     **kw).train(resume_from=str(path))
    hold_states("16b resume", resumed, full)
    hold_rows("16b resume", first_log.rows + resumed_log.rows,
              async_log.rows)
    print(f"phase 16b: example 5 (cuts: n_steps {EX5_N_STEPS}, "
          f"log_interval_steps {EX5_LOG}; min_steps_learn the example's "
          f"5000) under AsyncRl(pipeline_depth=2) equals MinibatchRl bit for "
          f"bit ({n} state leaves, {n_intervals} rows), and resumed from "
          f"its interval-2 checkpoint equals the uninterrupted run; "
          f"{updates} updates; launches {launches}; checkpoint "
          f"{io['bytes']} bytes, save {io['save_s']:.3f} s, load "
          f"{io['load_s']:.3f} s")
    per_itv = {part: sum(v for k, v in counts.items()
                         if k.startswith(part + " ")) / n_intervals
               for part in ("interval", "drain")}
    print(f"phase 16b: host syncs of the AsyncRl run (torch's sync debug "
          f"mode), by part and site, in all over {n_intervals} intervals: "
          f"{dict(sorted(counts.items()))}; per interval: in "
          f"collect + optimize {per_itv['interval']}, at drain "
          f"{per_itv['drain']}")
    syncs = {"sites": counts, "per_interval": per_itv}
    return {"launches": launches, "updates": updates, "checkpoint": io,
            "syncs": syncs, "intervals": n_intervals}


def phase16_child(out: Path) -> int:
    """16a and 16b, deterministic; their numbers go to ``out`` as JSON."""
    torch.use_deterministic_algorithms(True)
    from rlpyt_tpu_torch.ops import frame_gather as fg
    from rlpyt_tpu_torch.ops import lstm as L

    for m in (fg, L):
        m.build()
        m.load()
    dev = torch.device("cuda")
    res = {}
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "a").mkdir()
        (Path(d) / "b").mkdir()
        res["16a"] = resume_flagship(fg, dev, Path(d) / "a")
        torch.cuda.empty_cache()
        res["16b"] = example5_equal_and_resume(L, dev, Path(d) / "b")
    out.write_text(json.dumps(res))
    return 0


def run_deterministic_child() -> dict:
    """Run 16a and 16b in a child process with deterministic cuBLAS; its
    failure fails the phase."""
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "phase16.json"
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--phase16-child", str(out)],
            env=env, capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-8000:], file=sys.stderr)
            fail(f"16a/16b: the deterministic child exited "
                 f"{proc.returncode}")
        return json.loads(out.read_text())


def check_eval_attribution(dev):
    """16c: AsyncRlEval(pipeline_depth=3) on example 5: each evaluation
    ran on its own interval's parameters (a copy of the first parameter
    tensor, enqueued after the interval and at the evaluation's start)."""
    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.examples import example_5
    from rlpyt_tpu_torch.runners.async_rl import AsyncRlEval

    logger = row_logger()
    runner = example_5.build_runner(
        EX5_N_STEPS, device=dev, runner_cls=AsyncRlEval, pipeline_depth=3,
        log_interval_steps=EX5_LOG, eval_env=Breakout(device=dev),
        logger=logger, **EX5_EVAL)
    after_interval, at_eval = [], []
    run_interval, run_eval = runner.run_interval, runner.run_eval

    def probe():
        return next(runner.agent.model.parameters()).detach().clone()

    def spy_interval():
        out = run_interval()
        after_interval.append(probe())
        return out

    def spy_eval():
        at_eval.append(probe())
        return run_eval()

    runner.run_interval, runner.run_eval = spy_interval, spy_eval
    runner.train()
    torch.cuda.synchronize()
    if not len(at_eval) == len(after_interval) == len(logger.rows) >= 4:
        fail(f"16c: {len(at_eval)} evaluations, {len(after_interval)} "
             f"intervals, {len(logger.rows)} rows")
    for k, (a, e) in enumerate(zip(after_interval, at_eval)):
        if not torch.equal(a, e):
            fail(f"16c: the evaluation of interval {k} ran on other "
                 f"parameters")
    if torch.equal(after_interval[0], after_interval[-1]):
        fail("16c: the parameters never changed")
    print(f"phase 16c: AsyncRlEval(pipeline_depth=3) {len(at_eval)} "
          f"evaluations, each on its own interval's parameters; Eval "
          f"trajectories {[r['EvalTrajs'] for r in logger.rows]}")


def check_wait_reset(dev):
    """16d: one wait-reset batch of the lstm_ppo agent on MinAtar
    Breakout (B=128, T=WAIT_T): a lane done at t stays done, with reward
    0 and its observation unchanged, to the batch's end; no lane waits
    after the batch; process_returns(mid_batch_reset=False) on the card
    against the CPU on the same tensors, to phase 12a's 1e-4."""
    from rlpyt_tpu_torch.algos.pg import PPO
    from rlpyt_tpu_torch.experiments.scripts import minatar_pg
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector

    runner, config = minatar_pg.build_runner("lstm_ppo", device=dev)
    agent, env = runner.agent, runner.env
    torch.manual_seed(0)
    agent.initialize(env.spaces)
    col = Collector(env, agent, BatchSpec(WAIT_T, PG_B),
                    mid_batch_reset=False)
    g = torch.Generator(device=dev).manual_seed(0)
    state = col.init_state(g)
    state, s = col.collect(state, g)
    done = s.done
    seen = torch.cummax(done.to(torch.int32), 0).values.bool()
    frozen = seen[:-1]                  # done at an earlier step
    lanes = int(seen[-1].sum())
    obs = s.observation.reshape(WAIT_T, PG_B, -1)
    if not torch.equal(done, seen):
        fail("16d: a lane's done went back to False before the batch end")
    if lanes == 0:
        fail("16d: no lane finished an episode in the batch")
    if bool((s.reward[1:][frozen] != 0).any()):
        fail("16d: a frozen lane recorded a reward")
    if not torch.equal(obs[1:][frozen], obs[:-1][frozen]):
        fail("16d: a frozen lane's observation changed")
    if bool(state.needs_reset.any()):
        fail("16d: a lane still waits after the batch")
    algo = PPO(**config["algo"])
    with torch.no_grad():
        boot = agent.value(state.observation, state.prev_action,
                           state.prev_reward, state.agent_carry)
    out = {}
    for d in ("cpu", dev):
        sd = s._replace(reward=s.reward.to(d), done=done.to(d),
                        agent_info={"value": s.agent_info["value"].to(d)})
        out[d] = algo.process_returns(sd, boot.to(d), mid_batch_reset=False)
    worst = 0.0
    for name, c, gpu in zip(("return", "advantage"), out["cpu"][:2],
                            out[dev][:2]):
        err = float(((gpu.cpu() - c).abs() / c.abs().clamp(min=1.0)).max())
        if not err <= 1e-4:
            fail(f"16d: process_returns {name} differs by {err:.3g}")
        worst = max(worst, err)
    if not torch.equal(out[dev][2].cpu(), out["cpu"][2]):
        fail("16d: process_returns valid differs card against CPU")
    print(f"phase 16d: wait-reset batch of {WAIT_T} x {PG_B}: {lanes} lanes "
          f"finished and froze ({int(frozen.sum())} frozen steps), none "
          f"waits after the batch; process_returns(mid_batch_reset=False) "
          f"card against CPU max relative err {worst:.3g}, valid equal "
          f"({int(out[dev][2].sum())} of {out[dev][2].numel()} valid)")


def check_profiling(fg, L, g, dev) -> dict:
    """16e: ``trace`` names the port's kernels, ``time_fn`` agrees with
    ``time_ms`` within 20 % on one K3 call, ``device_memory_stats`` is
    not empty."""
    from rlpyt_tpu_torch.utils.profiling import device_memory_stats, \
        time_fn, trace

    T, B, F, H = 45, 32, 1031, 128     # example 5's training window
    c = lstm_case(g, T, B, F, H, dev)
    xg = L.input_proj_plain(c["x"].view(T * B, F), c["wx"],
                            c["b"]).view(T, B, 4 * H)
    args = (xg, c["wh"], (~c["done"]).float(), c["h0"], c["c0"])
    ring, start, b_idx, ma, mt = random_case(g, 1568, 128, 8320, 256, 4, 1,
                                             dev)
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            L.lstm_fwd(*args)
            fg.gather_frame_stacks(ring, start, b_idx, ma, mt, 4, 1)
            torch.cuda.synchronize()
        files = list(Path(d).glob("trace_*.json"))
        text = files[0].read_text() if len(files) == 1 else ""
    names = [n for n in ("lstm_fwd_kernel", "gather_bulk_kernel",
                         "gather_bytes_kernel") if n in text]
    if "lstm_fwd_kernel" not in names or len(names) < 2:
        fail(f"16e: the trace names {names} of the port's kernels")
    fn_ms = 1e3 * time_fn(lambda: L.lstm_fwd(*args), iters=50,
                          warmup=3)["mean_s"]
    ev_ms = time_ms(lambda: L.lstm_fwd(*args), 50)
    if not abs(fn_ms - ev_ms) <= 0.2 * ev_ms:
        fail(f"16e: time_fn {fn_ms:.4f} ms against time_ms {ev_ms:.4f} ms")
    mem = device_memory_stats()
    if not mem or any(v is None or not v for v in mem.values()):
        fail(f"16e: device_memory_stats {list(mem)} has an empty entry")
    print(f"phase 16e: trace names {names}; K3 (T={T}, B={B}, H={H}) "
          f"time_fn {fn_ms:.4f} ms, time_ms {ev_ms:.4f} ms; "
          f"device_memory_stats {list(mem)}, allocated.all.peak "
          f"{mem['cuda:0'].get('allocated_bytes.all.peak')} bytes")
    return {"time_fn_ms": fn_ms, "time_ms": ev_ms}


def example5_rates(dev) -> dict:
    """16f: example 5's env-steps/s under MinibatchRl and AsyncRl in
    turns (M, A, A, M), each EX5_RATE_N_STEPS steps from the end of
    startup to the end of training (the card synced), in this process
    (not deterministic)."""
    from rlpyt_tpu_torch.examples import example_5
    from rlpyt_tpu_torch.runners.async_rl import AsyncRl
    from rlpyt_tpu_torch.runners.train import MinibatchRl

    rates = {"MinibatchRl": [], "AsyncRl": []}
    for cls in (MinibatchRl, AsyncRl, AsyncRl, MinibatchRl):
        runner = example_5.build_runner(
            EX5_RATE_N_STEPS, device=dev, runner_cls=cls,
            log_interval_steps=EX5_LOG, logger=row_logger())
        stamp, startup = {}, runner.startup

        def timed_startup():
            startup()
            torch.cuda.synchronize()
            stamp["t0"] = time.perf_counter()

        runner.startup = timed_startup
        runner.train()
        torch.cuda.synchronize()
        rates[cls.__name__].append(
            EX5_RATE_N_STEPS / (time.perf_counter() - stamp["t0"]))
    print(f"phase 16f: example 5 env-steps/s over {EX5_RATE_N_STEPS} steps "
          f"({runner.algo.update_counter} updates), turns M, A, A, M: "
          f"MinibatchRl {[round(r, 1) for r in rates['MinibatchRl']]}, "
          f"AsyncRl {[round(r, 1) for r in rates['AsyncRl']]}")
    return rates


def run_phase16(fg, L, g, dev):
    t0 = time.time()
    res = run_deterministic_child()
    check_eval_attribution(dev)
    torch.cuda.empty_cache()
    check_wait_reset(dev)
    check_profiling(fg, L, g, dev)
    example5_rates(dev)
    print(f"phase 16: checkpoint sizes {res['16a']['checkpoint']['bytes']}"
          f" / {res['16b']['checkpoint']['bytes']} bytes (16a / 16b); "
          f"{time.time() - t0:.1f} s")
    torch.cuda.empty_cache()


# Phase 17: data-parallel SyncRl (rlpyt_tpu_torch/runners/sync.py) and
# the mp axis.  17a runs in a deterministic child, as 16a/16b do; the
# worlds of 2 share this one card over gloo (NCCL takes one rank a card).
P17_ITR = 4                  # 17b: flagship DQN iterations at dp = 2
P17_PG_ITR = 2               # 17d: ppo iterations at dp = 2
P17_EX4_ITR = 3              # 17e: example 4 iterations (2048 steps each)
P17_MP_STEPS = 2_048         # 17f: CartPole steps of the mp = 2 run
P17_RATE_ITR = 6             # 17g: r2d1 iterations of each timed run
P17_KEYS = ("frame_gather", "lstm_input_proj", "lstm_fwd", "lstm_fwd_t1",
            "lstm_bwd", "updates", "all_reduce_s", "all_reduces")
P17_TOL = dict(rtol=2e-3, atol=2e-4)   # tests/test_parallel.py:86


class CheckedSyncRl(SyncRl):
    """SyncRl that, before its process group goes down, gathers from
    every rank what phase 17 holds: its kernel launches and updates, the
    host seconds of its gradient all-reduces, and whether the ranks'
    parameters and priority tables agree bit for bit (``report``)."""

    def _train_rank(self, resume_from):
        import torch.distributed as dist

        from rlpyt_tpu_torch.ops import frame_gather as fg
        from rlpyt_tpu_torch.ops import lstm as L
        from rlpyt_tpu_torch.parallel.mesh import DpShard, full_tensor

        spent = [0.0, 0]
        reduce = DpShard.all_reduce_grads_

        def timed(shard, grads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reduce(shard, grads)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1

        zero_launches()
        DpShard.all_reduce_grads_ = timed
        try:
            state = super()._train_rank(resume_from)
        finally:
            DpShard.all_reduce_grads_ = reduce
        tables = [full_tensor(p).detach().reshape(-1).float()
                  for p in self.agent.model.parameters()]
        replay = getattr(self.algo, "replay", None)
        if hasattr(replay, "priorities"):
            tables.append(replay.priorities.reshape(-1))
        lo = torch.cat(tables)
        hi = lo.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        mine = torch.tensor(
            [fg.gather_frame_stacks.launches, L.input_proj.launches,
             L.lstm_fwd.launches, L.lstm_fwd.step_launches,
             L.lstm_bwd.launches, self.algo.update_counter, spent[0],
             spent[1]], dtype=torch.float64, device=self.device)
        every = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        self.report = {"ranks_equal": torch.equal(lo, hi), "per_rank": [
            dict(zip(P17_KEYS, e.tolist())) for e in every]}
        return state


def p17_reduce_ms(report) -> list:
    """Host ms of one gradient all-reduce, per rank."""
    return [round(1e3 * r["all_reduce_s"] / max(r["all_reduces"], 1), 3)
            for r in report["per_rank"]]


def p17_r2d1_runner(runner_cls, n_itr: int, logger=None, eval_cut=True,
                    **kwargs):
    """The r2d1 config of minatar_dqn.py through its build_runner, with
    14a's cuts (n_steps, the log interval, the evaluation caps); with
    ``runner_cls`` SyncRl (or a subclass) over ``kwargs``' mesh."""
    from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import \
        build_runner

    steps = MD_T * MD_B
    overrides = {"runner": {"n_steps": n_itr * steps,
                            "log_interval_steps": steps},
                 "sampler": dict(MD_EVAL_CUT) if eval_cut
                 else {"eval_n_envs": 0}}
    mesh = kwargs.pop("mesh", None)
    runner, _ = build_runner("r2d1", config_overrides=overrides, mesh=mesh,
                             backend=kwargs.pop("backend", None))
    if runner_cls is not None:
        runner.__class__ = runner_cls
    runner.logger = logger or row_logger()
    for k, v in kwargs.items():
        setattr(runner, k, v)
    return runner


def p17_r2d1_equal_and_resume(L, tmp: Path) -> dict:
    """17a: r2d1 under SyncRl(MeshSpec(dp=1)), a world of one on NCCL,
    against MinibatchRl: every state leaf and logged row bit for bit, and
    the same K3a/K3/K4 launches; then 2 of its 4 intervals with a
    checkpoint and a fresh SyncRl resumed to 4: equal to the whole run."""
    from rlpyt_tpu_torch.parallel.mesh import MeshSpec

    def run(runner_cls, n_itr, resume_from=None, **kwargs):
        runner = p17_r2d1_runner(runner_cls, n_itr, **kwargs)
        zero_launches()
        state = runner.train(resume_from=resume_from)
        torch.cuda.synchronize()
        return runner, state, md_launches(L)

    n = MD_ITR["r2d1"]
    m_run, m_state, m_launch = run(None, n)
    s_run, s_state, s_launch = run(SyncRl, n, mesh=MeshSpec(dp=1))
    leaves = hold_states("17a SyncRl(dp=1) against MinibatchRl", s_state,
                         m_state)
    hold_rows("17a", s_run.logger.rows, m_run.logger.rows)
    if s_launch != m_launch:
        fail(f"17a: SyncRl's LSTM launches {s_launch}, MinibatchRl's "
             f"{m_launch}")
    run(SyncRl, n // 2, mesh=MeshSpec(dp=1), checkpoint_dir=str(tmp))
    r_run, r_state, _ = run(SyncRl, n, mesh=MeshSpec(dp=1),
                            checkpoint_dir=str(tmp),
                            resume_from=str(tmp / "checkpoint.pkl"))
    hold_states("17a resumed", r_state, s_state)
    hold_rows("17a resumed", r_run.logger.rows, s_run.logger.rows[n // 2:])
    return {"leaves": leaves, "launches": s_launch,
            "backend": "nccl", "rows": len(s_run.logger.rows)}


def phase17_child(out: Path) -> int:
    """17a, deterministic; its numbers go to ``out`` as JSON."""
    torch.use_deterministic_algorithms(True)
    from rlpyt_tpu_torch.ops import lstm as L

    L.build()
    L.load()
    with tempfile.TemporaryDirectory() as d:
        res = p17_r2d1_equal_and_resume(L, Path(d))
    out.write_text(json.dumps(res))
    return 0


def p17_case(name: str, dev):
    """(agent, algo, env, batch_spec, batches) of a 17b/17d update check:
    the flagship DQN on 2 collected [32, 128] batches, or the ppo config
    of minatar_pg.py on one [16, 128] batch, each collected with the
    weights drawn from seed 0."""
    from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
    from rlpyt_tpu_torch.experiments.scripts.minatar_pg import \
        build_runner
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector

    torch.manual_seed(0)
    if name == "flagship":
        agent, algo = flagship_agent_algo(dev)
        env, spec, n_batches = SyntheticAtariEnv(dev), BatchSpec(T, B), 2
    else:
        runner, _ = build_runner("ppo")
        agent, algo, env = runner.agent, runner.algo, runner.env
        spec, n_batches = runner.batch_spec, 1
    agent.initialize(env.spaces)
    gen = torch.Generator(device=dev).manual_seed(1)
    collector = Collector(env, agent, spec, discount=float(algo.discount))
    state = collector.init_state(gen)
    batches = []
    for _ in range(n_batches):
        state, samples = collector.collect(state, gen)
        batches.append((samples, state))
    return agent, algo, spec, batches


def p17_update(name: str, dev, shard=None) -> dict:
    """The case's update on this process's lanes (all without ``shard``):
    the flagship's appends then one DQN update; ppo's one optimize (4
    epochs of 4 minibatches).  Returns, on the CPU, the model's state,
    the update's diagnostics (loss, the norm before the clip, ...) and
    Adam's moments: a gradient off by a constant factor shows in the
    last two, where Adam's step hides it from the parameters."""
    from rlpyt_tpu_torch.struct import tree_map

    agent, algo, spec, batches = p17_case(name, dev)
    lanes = slice(0, spec.B) if shard is None else shard.lanes(spec.B)

    def local(tree, dim):
        return tree_map(lambda x: x.narrow(dim, lanes.start,
                                           lanes.stop - lanes.start)
                        if isinstance(x, torch.Tensor) and x.dim() > dim
                        else x, tree)

    samples, state = batches[-1]
    algo.shard = shard
    algo.initialize(agent, spec, local(state.observation, 0),
                    torch.Generator(device=dev).manual_seed(2), n_itr=1)
    if name == "flagship":
        for samples, _ in batches:
            algo.replay.append(algo.samples_to_buffer(local(samples, 1)))
        info = algo.update(algo.replay.sample(algo.batch_size,
                                              algo.generator))
    else:
        info = algo.optimize(local(samples, 1), state._replace(
            observation=local(state.observation, 0),
            prev_action=local(state.prev_action, 0),
            prev_reward=local(state.prev_reward, 0)))
    torch.cuda.synchronize()
    moments = algo.optimizer.state_dict()["inner"]["state"]
    return {"model": {k: v.cpu() for k, v in agent.model.state_dict().items()},
            "info": {k: v.cpu() for k, v in info._asdict().items()},
            "moments": {f"{i}.{k}": v.cpu() for i, m in moments.items()
                        for k, v in m.items() if k != "step"}}


def p17_update_rank(rank: int, world: int, address: str, out: str):
    """A gloo rank of the 17b/17d update checks on the shared card."""
    import torch.distributed as dist

    from rlpyt_tpu_torch.parallel.mesh import DpShard, init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    init_distributed(address, world, rank, "gloo", 300)
    try:
        result = {name: p17_update(name, dev, DpShard(rank, world))
                  for name in ("flagship", "ppo")}
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def p17_updates_against_single(dev) -> dict:
    """17b/17d: one flagship DQN update and one ppo optimize by two gloo
    ranks, each with its half of the lanes of a common replay (or batch),
    against the same on one process: the ranks agree bit for bit and hold
    the single-process parameters, diagnostics and Adam moments to
    P17_TOL.  Returns the largest absolute differences."""
    import multiprocessing
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    errs = {}
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=p17_update_rank,
                             args=(r, 2, address, d)) for r in range(2)]
        for p in procs:
            p.start()
        want = {name: p17_update(name, dev) for name in ("flagship", "ppo")}
        for p in procs:
            p.join(300)
            if p.is_alive():
                p.kill()
                p.join()
        if [p.exitcode for p in procs] != [0, 0]:
            fail(f"17b/17d: update ranks exited {[p.exitcode for p in procs]}")
        got = [torch.load(Path(d) / f"rank{r}.pt", weights_only=False)
               for r in range(2)]
    for name, w in want.items():
        hold_states(f"17 {name}: rank 1 against rank 0", got[1][name],
                    got[0][name])
        err = 0.0
        for part, leaves in w.items():
            for k, v in leaves.items():
                g = got[0][name][part][k]
                if not torch.allclose(g, v, **P17_TOL):
                    fail(f"17 {name}: {part} {k} off the single-process "
                         f"update by {(g - v).abs().max().item():.3g}")
                err = max(err, (g - v).abs().max().item())
        errs[name] = err
    return errs


def p17_flagship_dp2(dev) -> dict:
    """17b: the flagship DQN over two gloo ranks sharing the card, frame
    replay split by lanes ([size_T, 64, 8320] each), for P17_ITR
    iterations: parameters equal over ranks, one gather an update on each
    rank, finite losses."""
    from rlpyt_tpu_torch.parallel.mesh import MeshSpec

    logger = row_logger()
    runner = build_flagship_runner(dev, P17_ITR, logger, CheckedSyncRl,
                                   mesh=MeshSpec(dp=2), backend="gloo")
    with contextlib.redirect_stdout(io.StringIO()):
        state = runner.train()
    ring = state["algo"]["replay"]["data"].observation
    if tuple(ring.shape) != (runner.algo.replay.size_T, B // 2, 8320):
        fail(f"17b: rank 0's ring is {tuple(ring.shape)}")
    rep = runner.report
    if not rep["ranks_equal"]:
        fail("17b: the ranks' parameters differ")
    want = P17_ITR * runner.algo.updates_per_optimize
    for r, c in enumerate(rep["per_rank"]):
        if c["updates"] != want or c["frame_gather"] != want:
            fail(f"17b rank {r}: {c['frame_gather']} gathers for "
                 f"{c['updates']} updates, expected {want} each")
    for row in logger.rows:
        if not all(math.isfinite(row[k]) for k in ("loss", "grad_norm")):
            fail(f"17b: non-finite loss in iteration {row['Iteration']}")
    return {"ring": list(ring.shape), "per_rank": rep["per_rank"],
            "sps": [r["StepsPerSecond"] for r in logger.rows],
            "reduce_ms": p17_reduce_ms(rep)}


def p17_r2d1_dp2() -> dict:
    """17c: r2d1 (prioritized sequence replay, the global draw, K3a/K3/K4)
    over two gloo ranks with 14a's cuts: parameters and priority tables
    equal over ranks, finite losses and priorities, LSTM launches on both
    ranks."""
    from rlpyt_tpu_torch.parallel.mesh import MeshSpec

    runner = p17_r2d1_runner(CheckedSyncRl, MD_ITR["r2d1"],
                             mesh=MeshSpec(dp=2), backend="gloo")
    runner.train()
    rep = runner.report
    if not rep["ranks_equal"]:
        fail("17c: the ranks' parameters or priority tables differ")
    replay = runner.algo.replay
    if not (torch.isfinite(replay.priorities).all()
            and (replay.priorities[:replay.filled_t
                                   // replay.interval] > 0).all()):
        fail("17c: a written priority is not finite and above 0")
    # A rank whose lanes hold none of an update's windows launches
    # nothing for it (before a whole window exists, the draw on an
    # all-zero mass takes the last lane: ROADMAP Queue 3, item 3).
    per_rank = rep["per_rank"]
    updates = per_rank[0]["updates"]
    if not (updates > 0 and sum(c["lstm_bwd"] for c in per_rank) >= updates
            and all(0 < c["lstm_bwd"] <= updates and c["lstm_fwd"] > 0
                    and c["lstm_input_proj"] > 0 for c in per_rank)):
        fail(f"17c: LSTM launches per rank {per_rank}")
    for row in runner.logger.rows[1:]:
        if not all(math.isfinite(row[k]) for k in ("loss", "td_abs_err")):
            fail(f"17c: non-finite loss in iteration {row['Iteration']}")
    return {"per_rank": rep["per_rank"], "reduce_ms": p17_reduce_ms(rep),
            "sps": [r["StepsPerSecond"] for r in runner.logger.rows]}


def p17_ppo_dp2() -> dict:
    """17d (the run): minatar_pg.py's ppo over two gloo ranks for
    P17_PG_ITR iterations (the global permutation, all-reduced advantage
    moments): parameters equal over ranks, finite losses."""
    from rlpyt_tpu_torch.experiments.configs.minatar_pg import configs
    from rlpyt_tpu_torch.experiments.scripts.minatar_pg import \
        build_runner
    from rlpyt_tpu_torch.parallel.mesh import MeshSpec

    steps = PG_T * PG_B
    runner, _ = build_runner("ppo", mesh=MeshSpec(dp=2), backend="gloo",
                             config_overrides={
                                 "runner": {"n_steps": P17_PG_ITR * steps,
                                            "log_interval_steps": steps},
                                 "sampler": {"eval_max_steps": 100 * 32}})
    runner.__class__ = CheckedSyncRl
    runner.logger = row_logger()
    runner.train()
    rep = runner.report
    if not rep["ranks_equal"]:
        fail("17d: the ranks' parameters differ")
    for row in runner.logger.rows:
        if not all(math.isfinite(row[k]) for k in ("loss", "entropy")):
            fail(f"17d: non-finite loss in iteration {row['Iteration']}")
    cfg = configs["ppo"]["algo"]
    if any(c["updates"] != P17_PG_ITR * cfg["epochs"] * cfg["minibatches"]
           for c in rep["per_rank"]):
        fail(f"17d: updates {[c['updates'] for c in rep['per_rank']]}")
    return {"reduce_ms": p17_reduce_ms(rep),
            "sps": [r["StepsPerSecond"] for r in runner.logger.rows]}


def p17_example4() -> dict:
    """17e: the torch example 4 (dqn at 64 lanes, MeshSpec(dp=-1): a world
    of one on NCCL on this card) cut to P17_EX4_ITR iterations and its
    evaluation to 100 steps a lane."""
    from rlpyt_tpu_torch.examples import example_4

    with contextlib.redirect_stdout(io.StringIO()):
        runner = example_4.build_and_train(
            n_steps=P17_EX4_ITR * 2_048, log_interval_steps=2_048,
            config_overrides={"sampler": {"eval_max_steps": 32 * 100}})
    if runner.dp != 1 or runner.rollout_state.cum_steps \
            != P17_EX4_ITR * 2_048:
        fail(f"17e: dp {runner.dp}, {runner.rollout_state.cum_steps} steps")
    learning = sum((i + 1) * 2_048 >= 5_000 for i in range(P17_EX4_ITR))
    if runner.algo.update_counter != \
            learning * runner.algo.updates_per_optimize:
        fail(f"17e: {runner.algo.update_counter} updates")
    if not all(torch.isfinite(p).all()
               for p in runner.agent.model.parameters()):
        fail("17e: non-finite parameters")
    return {"updates": runner.algo.update_counter}


def p17_mp() -> dict:
    """17f: DqnMlpModel(256, 512) on CartPole under MeshSpec(dp=1, mp=2)
    over gloo (tests/test_learning_coverage.py:95): the live 512 x 256
    weight (JAX's 256 x 512 kernel) is a DTensor split on mp by output
    units, the ranks agree, and the run equals MinibatchRl to P17_TOL
    (TF32 off).  Both evaluate after each interval (under mp, both ranks
    of dp group 0 together) and the mp run writes checkpoints."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.envs.classic import CartPole
    from rlpyt_tpu_torch.models.dqn import DqnMlpModel
    from rlpyt_tpu_torch.parallel.mesh import MeshSpec
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    def make(runner_cls, **kwargs):
        agent = DqnAgent(ModelCls=DqnMlpModel,
                         model_kwargs={"hidden_sizes": (256, 512)},
                         eps_steps=2_000)
        algo = DQN(batch_size=64, min_steps_learn=256, replay_size=8_192,
                   replay_ratio=1.0, learning_rate=1e-3)
        return runner_cls(algo=algo, agent=agent, env=CartPole(),
                          batch_spec=BatchSpec(T=16, B=16),
                          n_steps=P17_MP_STEPS, seed=3,
                          log_interval_steps=1_024,
                          max_decorrelation_steps=0, logger=row_logger(),
                          eval_env=CartPole(), eval_n_envs=4,
                          eval_max_steps=256, **kwargs)

    with tempfile.TemporaryDirectory() as d:
        runner = make(CheckedSyncRl, mesh=MeshSpec(dp=1, mp=2),
                      backend="gloo", checkpoint_dir=d)
        state = runner.train()
    big = runner.agent.model.head.layers[1].weight
    if type(big).__name__ != "DTensor" or \
            tuple(big.to_local().shape) != (256, 256):
        fail(f"17f: the 512 x 256 weight is a {type(big).__name__} of "
             f"local shape {tuple(big.to_local().shape)}")
    if not runner.report["ranks_equal"]:
        fail("17f: the mp ranks' whole parameters differ")
    want = make(MinibatchRl).train()
    if not all("EvalTrajs" in row for row in runner.logger.rows):
        fail("17f: an interval without its evaluation row")
    err = 0.0
    for k, v in want["model"].items():
        if not torch.allclose(state["model"][k], v, **P17_TOL):
            fail(f"17f: {k} off MinibatchRl")
        err = max(err, (state["model"][k] - v).abs().max().item())
    return {"max_abs_err": err, "local": list(big.to_local().shape)}


def p17_rates() -> dict:
    """17g: r2d1's env-steps/s (no evaluation) under SyncRl(dp=1) and
    MinibatchRl in turns S, M, M, S: each run's median of its iterations
    after the first."""
    from rlpyt_tpu_torch.parallel.mesh import MeshSpec

    out = []
    for kind in "SMMS":
        kwargs = dict(mesh=MeshSpec(dp=1)) if kind == "S" else {}
        runner = p17_r2d1_runner(SyncRl if kind == "S" else None,
                                 P17_RATE_ITR, eval_cut=False, **kwargs)
        runner.train()
        sps = sorted(r["StepsPerSecond"] for r in runner.logger.rows[1:])
        out.append((kind, round(sps[len(sps) // 2], 1)))
    return out


def run_phase17(dev, launches14=None):
    t0 = t1 = time.time()

    def took() -> str:
        nonlocal t1
        t1, t = time.time(), t1
        return f" ({t1 - t:.1f} s)"

    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "phase17.json"
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--phase17-child", str(out)],
            env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-8000:], file=sys.stderr)
            fail(f"17a: the deterministic child exited {proc.returncode}")
        a = json.loads(out.read_text())
    if launches14 is not None and a["launches"] != {
            k: launches14[k] for k in a["launches"]}:
        fail(f"17a: SyncRl's LSTM launches {a['launches']}, 14b's "
             f"{launches14}")
    print(f"phase 17a: r2d1 under SyncRl(dp=1) on NCCL equals MinibatchRl "
          f"bit for bit ({a['leaves']} state leaves, {a['rows']} rows), "
          f"resumed after 2 of 4 intervals likewise; LSTM launches "
          f"{a['launches']}" + (" = 14b's" if launches14 else "") + took())
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = p17_updates_against_single(dev)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 17b/17d: one flagship update and one ppo optimize by two "
          f"gloo ranks, each with its lanes of a common replay, against "
          f"one process: ranks bit for bit, max abs err "
          f"{errs['flagship']:.3g} / {errs['ppo']:.3g}" + took())
    b = p17_flagship_dp2(dev)
    torch.cuda.empty_cache()
    print(f"phase 17b: flagship DQN at dp = 2 (gloo, two ranks on one "
          f"card) {P17_ITR} iterations: ring per rank {b['ring']}, "
          f"parameters equal over ranks" + took())
    c = p17_r2d1_dp2()
    print("phase 17c: r2d1 at dp = 2 (gloo): parameters and priority "
          "tables equal over ranks, losses and priorities finite" + took())
    d = p17_ppo_dp2()
    print(f"phase 17d: ppo at dp = 2 (gloo) {P17_PG_ITR} iterations, "
          f"parameters equal over ranks" + took())
    e = p17_example4()
    print(f"phase 17e: example 4 (NCCL, a world of one), "
          f"{P17_EX4_ITR} iterations, {e['updates']} updates" + took())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f = p17_mp()
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 17f: MeshSpec(dp=1, mp=2) over gloo: the 512 x 256 "
          f"weight is a DTensor on mp (local {f['local']}); the run "
          f"against MinibatchRl: max abs err {f['max_abs_err']:.3g}"
          + took())
    print("phase 17: launches per rank under SyncRl: "
          + json.dumps({"17b": [{k: int(r[k]) for k in
                                 ("frame_gather", "updates")}
                                for r in b["per_rank"]],
                        "17c": [{k: int(r[k]) for k in P17_KEYS[1:6]}
                                for r in c["per_rank"]]}))
    g = p17_rates()
    print(f"phase 17g (readings): r2d1 env-steps/s, turns {g}; host ms of "
          f"one gradient all-reduce per rank: 17b {b['reduce_ms']}, 17c "
          f"{c['reduce_ms']}, 17d {d['reduce_ms']}; env-steps/s at dp = 2 "
          f"(two ranks on one card, not scaling): 17b {b['sps']}, 17c "
          f"{c['sps']}, 17d {d['sps']}" + took())
    print(f"phase 17: {time.time() - t0:.1f} s")

# Phase 18: the R2D1 twin of tests/test_learning_coverage.py:54 (the
# port's tests/test_torch_learning_coverage.py): MinAtar Breakout, conv
# 16, LSTM 128 on [conv 16 x 8 x 8, 6 actions, the reward]; sampler
# T=40, B=32; 32 windows of burn-in 10 + training 20 + n-step 3 rows;
# evaluation (the test's, after training) on 8 lanes.  Cuts: n_steps and
# the log interval (the runner runs whole intervals), to 4 iterations of
# 1280 steps, learning from the second (min_steps_learn 2000).
TW_T, TW_B, TW_EVAL_B, TW_ITR = 40, 32, 8, 4
TW_BATCH_B, TW_WARMUP, TW_BATCH_T, TW_NSTEP = 32, 10, 20, 3
TW_CASES = [(TW_BATCH_T + TW_NSTEP, TW_BATCH_B, MD_F, MD_H),
            (TW_WARMUP, TW_BATCH_B, MD_F, MD_H), (1, TW_B, MD_F, MD_H),
            (1, TW_EVAL_B, MD_F, MD_H)]


def check_conv_head(dev):
    """Phase 18a: Conv2dHeadModel at MinAtar widths, ReLU and tanh,
    forward and backward (grads of the input and every weight) on the
    card against the CPU from the same weights and 0/1 frames, TF32 off,
    each to 1e-4 of the largest reference value.  Returns the largest
    abs error."""
    from rlpyt_tpu_torch.models import Conv2dHeadModel

    g = torch.Generator().manual_seed(18)
    x = torch.randint(0, 2, (256, 4, 10, 10), generator=g).float()
    cot = torch.randn((256, 6), generator=g)
    worst = 0.0
    for act_name, act in (("relu", torch.relu), ("tanh", torch.tanh)):
        torch.manual_seed(18)
        cpu = Conv2dHeadModel(4, (10, 10), channels=(16,),
                              kernel_sizes=(3,), strides=(1,), paddings=(0,),
                              hidden_sizes=(128,), output_size=6,
                              nonlinearity=act)
        card = copy.deepcopy(cpu).to(dev)
        results = []
        for model, d in ((cpu, "cpu"), (card, dev)):
            xi = x.to(d).requires_grad_(True)
            y = model(xi)
            grads = torch.autograd.grad((y * cot.to(d)).sum(),
                                        [xi] + list(model.parameters()))
            results.append([y.detach().cpu()] + [t.cpu() for t in grads])
        names = ["y", "dx"] + [f"d{n}" for n, _ in cpu.named_parameters()]
        for what, ref, out in zip(names, *results):
            err, rel = rel_err(out, ref)
            if not rel <= 1e-4 or out.shape != ref.shape:
                fail(f"phase 18a: Conv2dHeadModel ({act_name}) {what} on "
                     f"the card differs from the CPU: max err {err:.3g} = "
                     f"{rel:.3g} of max|ref|")
            worst = max(worst, err)
        print(f"phase 18a: Conv2dHeadModel {act_name} forward and backward "
              f"on the card agree with the CPU ({len(names)} tensors)")
    print(f"phase 18a: max abs err {worst:.3g}")
    return worst


def twin_r2d1_runner(dev):
    """tests/test_torch_learning_coverage.py's R2D1 twin at its settings
    and seed, cut to TW_ITR iterations in one log interval."""
    from rlpyt_tpu_torch.agents.dqn import R2d1Agent
    from rlpyt_tpu_torch.algos.r2d1 import R2D1
    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.models.dqn import AtariR2d1Model
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    agent = R2d1Agent(
        ModelCls=AtariR2d1Model,
        model_kwargs=dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                          paddings=(0,), lstm_size=MD_H),
        lstm_size=MD_H, eps_steps=100_000, eps_final=0.1, device=dev)
    algo = R2D1(discount=0.99, batch_b=TW_BATCH_B, batch_T=TW_BATCH_T,
                warmup_T=TW_WARMUP, min_steps_learn=2_000,
                replay_size=100_000, replay_ratio=1.0,
                target_update_interval=500, n_step_return=TW_NSTEP,
                learning_rate=3e-4, double_dqn=True,
                prioritized_replay=True, pri_alpha=0.6, pri_beta=0.9)
    return MinibatchRl(algo, agent, Breakout(device=dev),
                       BatchSpec(T=TW_T, B=TW_B),
                       n_steps=TW_ITR * TW_T * TW_B, seed=6,
                       log_interval_steps=TW_ITR * TW_T * TW_B,
                       logger=row_logger(),
                       device=dev)


def run_twin_r2d1(L, dev) -> dict:
    """Phase 18b: the twin's R2D1 for TW_ITR iterations; fails unless
    the losses and priorities are finite, the updates are those of the
    learning iterations, and the LSTM launches are those the config
    predicts: per collection step one K3a and one K3 at T=1; per update
    four of each (online and target burn-in at T=10, online and target
    training window at T=23) and one K4 (the online window's backward).
    Returns the launches."""
    runner = twin_r2d1_runner(dev)
    zero_launches()
    t0 = time.time()
    runner.train()
    seconds = time.time() - t0
    got = md_launches(L)
    algo = runner.algo
    steps = TW_T * TW_B
    first = -(-algo.min_steps_learn // steps)   # first learning iteration
    updates = (TW_ITR - first + 1) * algo.updates_per_optimize
    want = {"lstm_input_proj": TW_ITR * TW_T + 4 * updates,
            "lstm_fwd": TW_ITR * TW_T + 4 * updates,
            "lstm_fwd_t1": TW_ITR * TW_T, "lstm_bwd": updates}
    if algo.update_counter != updates:
        fail(f"phase 18b: {algo.update_counter} updates, predicted "
             f"{updates}")
    for name, n in want.items():
        if got[name] != n:
            fail(f"phase 18b: {name} launched {got[name]} times, predicted "
                 f"{n} ({got})")
    rows = runner.logger.rows
    for key in ("loss", "td_abs_err"):
        vals = [float(r[key]) for r in rows]
        if not all(math.isfinite(v) for v in vals):
            fail(f"phase 18b: {key} not finite: {vals}")
    pri = algo.replay.priorities
    if not bool(torch.isfinite(pri).all()):
        fail("phase 18b: priorities not finite")
    print(f"phase 18b: R2D1 twin {TW_ITR} iterations in {seconds:.1f} s, "
          f"{algo.update_counter} updates ({algo.updates_per_optimize} an "
          f"iteration from iteration {first}), LSTM launches {got} as "
          f"predicted; last row loss {float(rows[-1]['loss']):.4f}, "
          f"StepsPerSecond {float(rows[-1]['StepsPerSecond']):.1f}")
    return got


def time_lstm_twin(L, g, dev):
    """Phase 18c: the R2D1 twin's shapes: the training window (T=23,
    B=32, 736 rows), the burn-in (T=10), a collection step (T=1, B=32)
    and an evaluation step (T=1, B=8)."""
    return time_lstm_h128(L, g, dev, "phase 18c", "_minatar_twin",
                          TW_BATCH_T + TW_NSTEP, TW_WARMUP, TW_BATCH_B, TW_B,
                          TW_EVAL_B)


def run_phase18(L, g, dev):
    """Phase 18; returns (times, errors, launches) of its kernels-line
    entries."""
    t0 = time.time()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_conv_head(dev)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    got = run_twin_r2d1(L, dev)
    launches = {
        "lstm_input_proj_minatar_twin": got["lstm_input_proj"],
        "lstm_fwd_minatar_twin": got["lstm_fwd"] - got["lstm_fwd_t1"],
        "lstm_fwd_t1_minatar_twin": got["lstm_fwd_t1"],
        "lstm_bwd_minatar_twin": got["lstm_bwd"]}
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = check_lstm(L, g, dev, TW_CASES, "_minatar_twin")
    print(f"phase 18c: K3a, K3, K4 agree with their plain versions at the "
          f"twin's shapes (max abs err {errs})")
    times = time_lstm_twin(L, g, dev)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 18: {time.time() - t0:.1f} s")
    return times, errs, launches


def build_kernels():
    """Phase 1: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from rlpyt_tpu_torch.ops import frame_gather as fg
    from rlpyt_tpu_torch.ops import lstm as L
    from rlpyt_tpu_torch.ops import union_gather as ug

    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:
        libs = [f.result() for f in
                [pool.submit(m.build) for m in (fg, L, ug)]]
    for m in (fg, L, ug):
        m.load()
    print(f"phase 1: built {[p.name for p in libs]} in "
          f"{time.time() - t0:.1f} s")
    for line in libs[1].with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  lstm.cu ptxas:", line.strip())
    return fg, L, ug


_PALLAS = "rlpyt_tpu/ops/pallas/"
_GATHER = ("rlpyt_tpu_torch/csrc/frame_gather.cu",
           f"{_PALLAS}frame_gather.py:111 and {_PALLAS}window_gather.py:79")
_LSTM_SRC = "rlpyt_tpu_torch/csrc/lstm.cu"
_UNION_SRC = "rlpyt_tpu_torch/csrc/union_gather.cu"
# name -> (source, the TPU kernel it replaces).  The flagship DQN path
# (n=1) and the ernbw path (n=3) run the frame gather at two union
# widths, one entry for each; K3a has one entry at the update's shape
# (M = 1440: all of the path's launches) and one at the collection's
# (M = 64: those of them that took the few-row path, one per env step);
# K3 likewise (T=45: all launches; T=1: the one-step launches).  The
# "_pg" entries are the same kernels at minatar_pg.py's shapes (H=128),
# with the launches of phase 12b's lstm_ppo run: K3a all of them (timed
# at the minibatch's 512 rows), K3 those at T=16 and at T=1, K4 all.
# The "_mujoco" entries: MujocoLstmModel's shapes (F=260, H=256), with
# the launches of phase 13d's recurrent Gaussian PPO optimize.  The
# "_minatar_r2d1" entries: the r2d1 config of minatar_dqn.py (F=1031,
# H=128), with the launches of phase 14b's run: K3a all of them (timed at
# the training window's 1440 rows), K3 those at T>1 and at T=1, K4 all.
# The "_atari_r2d1" entries: the r2d1 config of atari_dqn.py (F=6917,
# H=512) with the launches of phase 15d's run, K3a timed at the training
# window's 2720 rows; the "_atari_cfg" gathers: batch 32 on the 1M-frame
# ring of the dqn (U=5) and ernbw (U=7) configs, with their runs'
# launches.  The "_minatar_twin" entries: the R2D1 learning twin of
# phase 18 (F=1031, H=128, batch 32 windows of 10 + 20 + 3 rows), with
# the launches of 18b's run, K3a timed at the training window's 736 rows.
KERNELS = {
    "frame_gather": _GATHER,
    "frame_gather_u7": _GATHER,
    "lstm_input_proj": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_input_proj_m64": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_t1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_bwd": (_LSTM_SRC, f"{_PALLAS}lstm.py:214"),
    "lstm_input_proj_pg": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_pg": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_t1_pg": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_bwd_pg": (_LSTM_SRC, f"{_PALLAS}lstm.py:214"),
    "lstm_input_proj_mujoco": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_mujoco": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_t1_mujoco": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_bwd_mujoco": (_LSTM_SRC, f"{_PALLAS}lstm.py:214"),
    "lstm_input_proj_minatar_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_minatar_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_t1_minatar_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_bwd_minatar_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:214"),
    "lstm_input_proj_atari_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_atari_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_t1_atari_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_bwd_atari_r2d1": (_LSTM_SRC, f"{_PALLAS}lstm.py:214"),
    "lstm_input_proj_minatar_twin": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_minatar_twin": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_t1_minatar_twin": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_bwd_minatar_twin": (_LSTM_SRC, f"{_PALLAS}lstm.py:214"),
    "frame_gather_atari_cfg": _GATHER,
    "frame_gather_u7_atari_cfg": _GATHER,
    "union_rows": (_UNION_SRC, "bench_gather_formulations.py:106"),
    "union_window": (_UNION_SRC, "bench_gather_formulations.py:138"),
}


def kernels_line(times: dict, errs: dict, launches: dict) -> str:
    """The ``kernels`` JSON line: one entry for each kernel in ``times``.
    ``launches`` are the main paths' counts (null for a kernel whose path
    was not driven)."""
    entries = []
    for name, t in times.items():
        source, replaces = KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches.get(name),
                 "max_abs_err": errs[name], "ms": t["ms"],
                 "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"],
                 "library_device_ms": t.get("library_device_ms")}
        for extra in ("device_int32_ms", "bound_ffma_ms"):
            if extra in t:
                entry[extra] = t[extra]
        entries.append(entry)
    return json.dumps({"kernels": entries})


def nvidia_smi_line() -> str:
    """The card's name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    if sys.argv[1:2] == ["--phase16-child"]:
        return phase16_child(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--phase17-child"]:
        return phase17_child(Path(sys.argv[2]))
    kernels_only = "--kernels-only" in sys.argv[1:]
    dev = torch.device("cuda")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    fg, L, ug = build_kernels()
    if "--phase16" in sys.argv[1:]:
        run_phase16(fg, L, torch.Generator(device=dev).manual_seed(0), dev)
        print(nvidia_smi_line())
        return 0
    if "--phase17" in sys.argv[1:]:
        run_phase17(dev)
        print(nvidia_smi_line())
        return 0
    if "--phase18" in sys.argv[1:]:
        times, errs, launches = run_phase18(
            L, torch.Generator(device=dev).manual_seed(0), dev)
        print(nvidia_smi_line())
        print(kernels_line(times, errs, launches))
        return 0

    g = torch.Generator(device=dev).manual_seed(0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    errs = {"frame_gather": check_gather(fg, g, dev)}
    errs["frame_gather_u7"] = errs["frame_gather"]
    print("phase 2: kernel bit-exact against its plain version")

    times = {"frame_gather": time_gather(fg, g, dev, 1),
             "frame_gather_u7": time_gather(fg, g, dev, 3)}
    launches = {}
    for n, t in zip((1, 3), times.values()):
        print(f"phase 3: gather n={n} call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms (int32 indices: "
              f"{t['device_int32_ms']:.4f} ms); index_select call "
              f"{t['library_ms']:.4f} ms, device "
              f"{t['library_device_ms']:.4f} ms; plain {t['plain_ms']:.4f} "
              f"ms; bound {t['bound_ms']:.4f} ms ({t['bytes']} bytes at "
              f"{HBM_BYTES_PER_S:.3g} B/s)")
    torch.cuda.empty_cache()

    if not kernels_only:
        runner, launches["frame_gather"], sps = run_trainer(dev)
        steady = sorted(sps[1:])[len(sps[1:]) // 2]
        print(f"phase 4: flagship trainer {N_ITR} iterations, "
              f"{launches['frame_gather']} gather launches, median steady "
              f"env-steps/s {steady:.1f} (per iteration: "
              f"{[round(s, 1) for s in sps]})")
        check_replay_against_cpu(runner, dev)
        del runner
        torch.cuda.empty_cache()

    # The LSTM checks compare fp32 kernels with fp32 cuBLAS and cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lstm_err = check_lstm(L, g, dev)
    print("phase 5: K3a, K3, K4 and the autograd Function agree with their "
          f"plain versions (max abs err {lstm_err})")
    errs.update(lstm_err, lstm_input_proj_m64=lstm_err["lstm_input_proj"])
    lstm_t = time_lstm(L, g, dev)
    times.update(lstm_t)
    for name, t in lstm_t.items():
        library_device = t.get("library_device_ms")
        print(f"phase 6: {name} call {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms; library call "
              f"{t['library_ms']:.4f} ms"
              + (f", device {library_device:.4f} ms" if library_device
                 else "")
              + f"; plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']}"
              + (f" (three TF32 products at {TF32_OPS_PER_S:.3g} /s; on "
                 f"the fp32 pipes: {t['bound_ffma_ms']:.4f} ms)"
                 if "bound_ffma_ms" in t else "")
              + f" ({t['ops']} operations, {t['bytes']} bytes)")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    if kernels_only:
        print(nvidia_smi_line())
        print(kernels_line(times, errs, launches))
        return 0

    runner, lstm_launches, sps = run_r2d1(L, dev)
    launches.update(lstm_launches)
    launches["lstm_input_proj_m64"] = launches.pop("lstm_input_proj_split")
    launches["lstm_fwd_t1"] = launches.pop("lstm_fwd_step")
    print(f"phase 7: R2D1 trainer {R2D1_ITR} iterations, "
          f"{runner.algo.update_counter} updates, LSTM launches "
          f"{lstm_launches}, env-steps/s per iteration "
          f"{[round(s, 1) for s in sps]}")
    check_windows_against_cpu(runner, dev)
    del runner
    torch.cuda.empty_cache()

    errs["union_rows"], errs["union_window"] = check_union(ug, g, dev)
    print("phase 8: K5 and K6 bit-exact against their plain versions")
    union_launches, union_t = run_harness(ug, dev)
    print(f"phase 9: harness ran, union kernel launches {union_launches}")
    launches.update(union_launches)
    times.update(union_t)

    runner, ernbw_launches, sps = run_ernbw(fg, dev)
    launches["frame_gather_u7"] = ernbw_launches
    steady = sorted(sps[1:])[len(sps[1:]) // 2]
    print(f"phase 10: ernbw trainer {ERNBW_ITR} iterations, "
          f"{ernbw_launches} gather launches, median steady env-steps/s "
          f"{steady:.1f} (per iteration: {[round(s, 1) for s in sps]})")
    check_prioritized_against_cpu(runner, dev)
    del runner
    torch.cuda.empty_cache()

    t0 = time.time()
    check_minatar_envs(dev)
    runner, sps = run_minatar(fg, dev)
    print(f"phase 11b: minatar trainer {MINATAR_ITR} iterations after 100 "
          f"decorrelation steps, {runner.algo.update_counter} updates, 0 "
          f"gather launches, env-steps/s per iteration "
          f"{[round(s, 1) for s in sps]}")
    check_replay_against_cpu(runner, dev)
    check_flat_prioritized_against_cpu(runner, dev)
    print(f"phase 11: {time.time() - t0:.1f} s")
    del runner
    torch.cuda.empty_cache()

    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_pg_against_cpu(L, dev)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    pg_stats = {}
    pg_launches = run_minatar_pg(L, "lstm_ppo", PG_ITR, pg_stats)
    print(f"phase 12b: lstm_ppo {PG_ITR} iterations at full width in "
          f"{pg_stats['lstm_ppo']['seconds']:.1f} s, "
          f"{pg_stats['lstm_ppo']['eval_steps']} evaluation steps, LSTM "
          f"launches {pg_launches}")
    launches.update({name + "_pg": n for name, n in pg_launches.items()})
    launches["lstm_fwd_pg"] -= launches["lstm_fwd_t1_pg"]
    for key in ("a2c", "ppo", "lstm_a2c"):
        n = run_minatar_pg(L, key, 2, pg_stats)
        print(f"phase 12c: {key} 2 iterations in "
              f"{pg_stats[key]['seconds']:.1f} s, LSTM launches {n}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs.update(check_lstm(L, g, dev, PG_CASES, "_pg"))
    times.update(time_lstm_pg(L, g, dev))
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 12: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.time()
    check_continuous_envs(dev)
    runner, sac_log, env_ms = run_sac_hopper(dev)
    steady = [e for e in sac_log if e["updates"]]
    print(f"phase 13b: SAC Hopper2D {SAC_ITR} iterations at full width "
          f"after 100 decorrelation steps, {runner.algo.update_counter} "
          f"updates; host ms an update "
          f"{[round(1e3 * e['optimize_s'] / e['updates'], 3) for e in steady]}"
          f", an env step in collection "
          f"{[round(1e3 * e['collect_s'] / SAC_T, 3) for e in sac_log]}; "
          f"Hopper2D step_batch alone at B={SAC_B}: host issue "
          f"{env_ms['issue']:.3f} ms, wall {env_ms['wall']:.3f} ms")
    del runner
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_qpg_against_cpu(dev)
    mj_launches = check_gaussian_ppo_against_cpu(L, dev)
    launches.update({name + "_mujoco": n for name, n in mj_launches.items()})
    launches["lstm_fwd_mujoco"] -= launches["lstm_fwd_t1_mujoco"]
    errs.update(check_lstm(L, g, dev, MUJOCO_CASES, "_mujoco"))
    times.update(time_lstm_mujoco(L, g, dev))
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 13: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.time()
    with tempfile.TemporaryDirectory() as log_root:
        for key in MD_CONFIGS:
            t1 = time.time()
            runner, rows, per_itr = run_minatar_dqn(L, key, Path(log_root))
            cuts = dict(MD_EVAL_CUT, n_steps=runner.n_steps,
                        log_interval_steps=runner.log_interval_steps)
            if key in MD_LEARN:
                cuts["min_steps_learn"] = MD_LEARN[key]
            print(f"phase 14a: {key} {MD_ITR[key]} iterations at the "
                  f"config's widths in {time.time() - t1:.1f} s (cuts "
                  f"{cuts}), {runner.algo.update_counter} updates "
                  f"({runner.algo.updates_per_optimize} an iteration once "
                  f"learning), {type(runner.algo.optimizer.inner).__name__}"
                  f", env-steps/s per iteration "
                  f"{[round(float(r['StepsPerSecond']), 1) for r in rows]}")
            if key == "r2d1":
                md = {k: sum(it[k] for it in per_itr) for k in per_itr[0]}
                print(f"phase 14b: r2d1 LSTM launches per iteration "
                      f"{per_itr}; in all {md}")
                check_windows_against_cpu(runner, dev)
                check_snapshot(runner, Path(log_root) / key, dev)
                md14 = md
                launches.update({
                    "lstm_input_proj_minatar_r2d1": md["lstm_input_proj"],
                    "lstm_fwd_minatar_r2d1":
                        md["lstm_fwd"] - md["lstm_fwd_t1"],
                    "lstm_fwd_t1_minatar_r2d1": md["lstm_fwd_t1"],
                    "lstm_bwd_minatar_r2d1": md["lstm_bwd"]})
            del runner
            torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_minatar_dqn_against_cpu(dev)
    errs.update(check_lstm(L, g, dev, MD_CASES, "_minatar_r2d1"))
    times.update(time_lstm_minatar_r2d1(L, g, dev))
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 14: {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    run_host_path(fg, L, g, dev, errs, times, launches, tf32)
    run_phase16(fg, L, g, dev)
    run_phase17(dev, md14)
    for part, new in zip((times, errs, launches), run_phase18(L, g, dev)):
        part.update(new)

    print(nvidia_smi_line())
    print(kernels_line(times, errs, launches))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
