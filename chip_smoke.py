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
     launch per update, and a prioritized batch against the CPU path.

The last lines are the card's name and power limit, one JSON line with
the kernels' numbers and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.

    python3 chip_smoke.py --kernels-only

runs phases 1, 2, 3, 5 and 6 alone (no trainer) and prints the same
``kernels`` line for their seven kernels, with null launch counts and no
result line: the quick loop while a kernel is being worked on, and the way
to compare two trees on one card.
"""
from __future__ import annotations

import copy
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

import bench_torch_gather_formulations as harness
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


def check_gather(fg, g, dev):
    """Phase 2: kernel vs plain, bit-exact, every case with int64 indices
    (the trainers' type) and with int32 ones (the kernel has an
    instantiation for each).  Returns the flagship case's max abs error."""
    def hold(name, ring, start, b_idx, ma, mt, k, nn):
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
        err = hold(name, ring, start, b_idx, ma, mt, k, nn)
        if worst is None:
            worst = err
    # Rows that are not 16-byte aligned take the byte path.
    size_T, B, F, batch = 32, 8, 8320, 64
    flat = torch.randint(0, 256, (size_T * B * F + 1,), generator=g,
                         device=dev, dtype=torch.uint8)
    ring = flat[1:].view(size_T, B, F)
    _, start, b_idx, ma, mt = random_case(g, size_T, B, 16, batch, K, n, dev)
    hold("unaligned ring", ring, start, b_idx, ma, mt, K, n)
    return worst


def time_gather(fg, g, dev, n: int):
    """Phase 3 at the flagship replay's shapes with n-step ``n``, on int64
    indices as the trainers pass them (the int32 instantiation's device
    time beside it).  Index sets rotate so the union rows are not left in
    L2 from the previous call."""
    size_T, B, F, batch, K = 1568, 128, 8320, 256, 4
    U = K + n
    ring = torch.randint(0, 256, (size_T, B, F), generator=g, device=dev,
                         dtype=torch.uint8)
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


def check_lstm(L, g, dev):
    """Phase 5: K3a, K3 and K4 against their plain versions on the card,
    and the autograd Function's grads against autograd through the plain
    forward.  fp32 with TF32 off on both sides; the kernels sum in
    another order than cuBLAS, so forward results must agree to 1e-4 of
    the largest reference value and backward results (a 45-step reverse
    recurrence) to 1e-3.  K3 and K4 run twice on the same inputs and
    must give the same bits.  Returns the max abs error of each kernel
    (K3's one-step shape, T=1, as ``lstm_fwd_t1``)."""
    worst = {"lstm_input_proj": 0.0, "lstm_fwd": 0.0, "lstm_fwd_t1": 0.0,
             "lstm_bwd": 0.0}

    def hold(kernel, what, out, ref, tol):
        err, rel = rel_err(out, ref)
        if not (rel <= tol) or out.shape != ref.shape:
            fail(f"{kernel} differs from plain ({what}): max err {err:.3g}"
                 f" = {rel:.3g} of max|ref|, tolerance {tol:g}")
        worst[kernel] = max(worst[kernel], err)

    # R2D1's shapes (update window, burn-in, collection step), B = 128
    # (more rows than one stage of staged h holds), then ragged ones:
    # H = 102 leaves the last CTA two live units; B = 37 spans two row
    # blocks, the second ragged.
    cases = [(45, 32, LSTM_F, LSTM_H), (20, 32, LSTM_F, LSTM_H),
             (1, 64, LSTM_F, LSTM_H), (5, 128, 33, LSTM_H), (7, 3, 130, 100),
             (3, 37, 33, 102), (1, 5, 33, 102)]
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


def time_lstm(L, g, dev):
    """Phase 6: each LSTM kernel at the update's shapes (T=45, B=32,
    F=6919, H=512) beside its plain version, its bound and one library
    call, by CUDA events; K3 also at the collection's shape (T=1,
    B=R2D1_B) as its own entry, and at the burn-in's (T=20, B=32) in a
    printed line."""
    T, B, F, H = 45, 32, LSTM_F, LSTM_H
    a = lstm_case(g, T, B, F, H, dev)
    mask = (~a["done"]).float()
    x2 = a["x"].view(T * B, F)
    xg = L.input_proj_plain(x2, a["wx"], a["b"]).view(T, B, 4 * H)
    _, gates, cs, _, _ = L.lstm_fwd_plain(xg, a["wh"], mask, a["h0"],
                                          a["c0"])
    dy = torch.randn((T, B, H), generator=g, device=dev)
    dcT = torch.randn((B, H), generator=g, device=dev)
    bwd_args = (gates, cs, a["c0"], mask, a["wh"], dy, dcT)

    def cudnn_lstm(c):
        """cuDNN's LSTM with the weights of case ``c`` (gate order i, f, g,
        o), no dones.  It also computes the input projection (forward)
        and the weight and input gradients (backward): more work than K3
        and K4 alone."""
        cudnn = torch.nn.LSTM(F, H).to(dev)
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(c["wx"].T)
            cudnn.weight_hh_l0.copy_(c["wh"].T)
            cudnn.bias_ih_l0.copy_(c["b"])
            cudnn.bias_hh_l0.zero_()
        return cudnn, (c["h0"][None], c["c0"][None])

    def fwd_times(c, iters, graph_len):
        """K3 on case ``c`` beside its plain version and cuDNN's forward."""
        Tc, Bc = c["done"].shape
        m = (~c["done"]).float()
        xgc = L.input_proj_plain(c["x"].view(Tc * Bc, F), c["wx"],
                                 c["b"]).view(Tc, Bc, 4 * H)
        args = (xgc, c["wh"], m, c["h0"], c["c0"])
        cudnn, state = cudnn_lstm(c)

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

    cudnn, state = cudnn_lstm(a)
    x_leaf = a["x"].clone().requires_grad_(True)
    out, _ = cudnn(x_leaf, state)
    cudnn_params = [x_leaf] + list(cudnn.parameters())

    def cudnn_bwd():
        torch.autograd.grad(out, cudnn_params, dy, retain_graph=True)

    def proj_times(x, weights, iters):
        """K3a on ``x`` beside its plain version and ``torch.addmm``: call
        times by events and device times by graph replay.  ``weights``
        rotate, so that more than one copy of W_x does not fit in L2."""
        ws = itertools.cycle(weights)

        def kernel():
            L.input_proj(x, next(ws), a["b"])

        def library():
            torch.addmm(a["b"], x, next(ws))

        M = x.shape[0]
        return dict(
            ms=time_ms(kernel, iters),
            plain_ms=time_ms(
                lambda: L.input_proj_plain(x, next(ws), a["b"]), iters),
            library_ms=time_ms(library, iters),
            device_ms=graph_ms([kernel] * 10),
            library_device_ms=graph_ms([library] * 10),
            ops=2 * M * F * 4 * H,
            bytes=4 * (M * F + F * 4 * H + 4 * H + M * 4 * H))

    # The collection's shape: one step of R2D1_B lanes, M = 64.  There the
    # product streams W_x (56.7 MB; two copies exceed the 50 MB L2).
    x64 = torch.randn((R2D1_B, F), generator=g, device=dev)
    res = {
        "lstm_input_proj": proj_times(x2, [a["wx"]], 20),
        "lstm_input_proj_m64": proj_times(x64, [a["wx"], a["wx"].clone()],
                                          50),
        "lstm_fwd": fwd_times(a, 20, 5),
        # One collection step (T=1, B=R2D1_B): 40 of K3's 48 launches in
        # an R2D1 iteration.  cuDNN's call also does the projection.
        "lstm_fwd_t1": fwd_times(lstm_case(g, 1, R2D1_B, F, H, dev), 50,
                                 20),
        "lstm_bwd": dict(
            ms=time_ms(lambda: L.lstm_bwd(*bwd_args), 20),
            device_ms=graph_ms([lambda: L.lstm_bwd(*bwd_args)] * 5),
            plain_ms=time_ms(lambda: L.lstm_bwd_plain(*bwd_args), 10),
            library_ms=time_ms(cudnn_bwd, 10),
            # dgates @ W_h^T, plus ~20 operations per cell
            ops=2 * T * B * 4 * H * H + 20 * T * B * H,
            # gates, c, c0, mask, W_h, dy, dcT in; dgates, dh0, dc0 out
            bytes=4 * (T * B * 4 * H + T * B * H + B * H + T * B
                       + H * 4 * H + T * B * H + B * H
                       + T * B * 4 * H + 2 * B * H)),
    }
    # The burn-in's shape (T=20, B=32): printed, not an entry of its own.
    t20 = fwd_times(lstm_case(g, 20, 32, F, H, dev), 20, 5)
    for name, r in list(res.items()) + [("lstm_fwd T=20 B=32", t20)]:
        t_ops = r["ops"] / FP32_OPS_PER_S * 1e3
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        if name.startswith("lstm_input_proj"):
            # K3a runs on the tensor cores, three TF32 products for each
            # fp32 one: that is its bound.  What the fp32 pipes could do
            # at best (the bound of the kernel before the redesign) is
            # kept beside it.
            r["bound_ffma_ms"] = max(t_ops, t_bytes)
            t_ops = 3 * r["ops"] / TF32_OPS_PER_S * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
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
                       log_interval_steps=R2D1_T * R2D1_B, logger=logger,
                       device=dev)


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
        pri_alpha=0.5, pri_beta=0.4, n_step_return=3, frames_per_obs=4)
    return MinibatchRl(algo, agent, SyntheticAtariEnv(dev),
                       BatchSpec(T=T, B=B), n_steps=n_itr * T * B, seed=0,
                       log_interval_steps=T * B, logger=logger, device=dev)


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
# K3 likewise (T=45: all launches; T=1: the one-step launches).
KERNELS = {
    "frame_gather": _GATHER,
    "frame_gather_u7": _GATHER,
    "lstm_input_proj": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_input_proj_m64": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_fwd_t1": (_LSTM_SRC, f"{_PALLAS}lstm.py:109"),
    "lstm_bwd": (_LSTM_SRC, f"{_PALLAS}lstm.py:214"),
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

    kernels_only = "--kernels-only" in sys.argv[1:]
    dev = torch.device("cuda")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    fg, L, ug = build_kernels()

    g = torch.Generator(device=dev).manual_seed(0)
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
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
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

    print(nvidia_smi_line())
    print(kernels_line(times, errs, launches))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
