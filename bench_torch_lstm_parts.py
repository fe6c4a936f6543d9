#!/usr/bin/env python3
"""Where a step of the LSTM recurrences (K3 forward, K4 backward) goes,
on the GPU.

    python3 bench_torch_lstm_parts.py

Builds ``rlpyt_tpu_torch/csrc/lstm.cu`` as it is and in variants that
each leave one part of a step out, keeping everything else, barriers
included (the results of a variant are wrong; only its time is read):

- ``no wait``: no CTA waits at the step barrier (K3 and K4);
- ``no stage``: K3 stages h only at t = 0 (no bulk copies after);
- ``no fma``: K3 skips the contraction h @ W_h;
- ``no cell``: no cell update and no stores of it (K3 and K4);
- ``no gather``: K4 reads no partial carries;
- ``no partial``: K4 forms and stores no partial carry;
- ``barrier only``: all of the above left out;

and for the cluster path (K3 at T > 1 and K4 where W_h fits one
cluster, H = 128 and 256):

- ``cl no fma``: no contraction (K3 h @ W_h, K4 the partial carry);
- ``cl no reduce``: the lanes that split a tile's depth are not added
  up (no shuffles);
- ``cl no cell``: no cell update (K3 the gates and the state; K4 the sum
  of the peers' partials and dgates);
- ``cl no store``: no stores of y, c, gates (K3) or dgates (K4) to device
  memory;
- ``cl exchange only``: all four left out: what is left is the exchange
  of h (K3) or of the partial carries (K4) and the wait for the peers'.

Each variant is the source with one or more lines rewritten; a rewrite
that does not find its line stops the script, so an edit of those lines
of ``lstm.cu`` brings ``CUTS`` in step with it.  The variants go to
``rlpyt_tpu_torch/csrc/build/parts/`` (git-ignored) and are built in
parallel.  For each it prints the device times (launches captured in a
CUDA graph and replayed) of K3 at H = 512, (T, B) = (45, 32), (20, 32),
(1, 64), of K4 at (45, 32), (20, 32), and of both at the cluster path's
CLUSTER_SHAPES, the card's name and power limit, and one JSON line.  A
part's cost per step is (whole - variant) / T.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from rlpyt_tpu_torch.ops import lstm as L
from rlpyt_tpu_torch.ops.cuda_build import BUILD_DIR, build_library
from rlpyt_tpu_torch.utils.cuda_timing import graph_ms

# (H, T, B): R2D1's LSTM (the step-barrier kernels), then the cluster
# path's: the MinAtar r2d1 window, the lstm_a2c window, a Gaussian PPO
# minibatch.
SHAPES = ((512, 45, 32), (512, 20, 32), (512, 1, 64))
CLUSTER_SHAPES = ((128, 45, 32), (128, 16, 128), (256, 256, 4))

# part -> (line as in lstm.cu, the line that leaves the part out, count)
CUTS = {
    "no wait": [
        ("if (s0 == 0 && t > 0) step_wait(counter, t * n_cta);",
         "if (false) step_wait(counter, t * n_cta);", 1),
        ("if (rb == 0) step_wait(counter, (T - 1 - s) * n_cta);",
         "if (false) step_wait(counter, (T - 1 - s) * n_cta);", 1)],
    "no stage": [
        ("        if (tid == 0) {\n          asm volatile(\"fence.proxy.async"
         ".global;",
         "        if (tid == 0 && t == 0) {\n          asm volatile(\"fence."
         "proxy.async.global;", 1),
        ("        mbar_wait(&hbar, phase);\n        phase ^= 1;",
         "        if (t == 0) mbar_wait(&hbar, phase);\n"
         "        if (t == 0) phase ^= 1;", 1)],
    "no fma": [
        ("for (int k = 4 * warp; k < hp; k += 4 * kRecWarps) {",
         "for (int k = 4 * warp; k < 0; k += 4 * kRecWarps) {", 1)],
    "no cell": [("if (cell && b < B) {", "if (false) {", 2)],
    "no gather": [
        ("for (int c0 = warp; c0 < n_grp; c0 += kGather * kRecWarps) {",
         "for (int c0 = warp; c0 < 0; c0 += kGather * kRecWarps) {", 1)],
    "no partial": [
        ("if (kg_threads > 0 && tid < kRecThreads / kg_threads * kg_threads)",
         "if (false)", 1)],
    "cl no reduce": [
        ("    reduce_rows(acc, ks, KS, gate);",
         "    for (int g = 0; g < 4; ++g) gate[g] = acc[0][g];", 1),
        # K4 keeps each lane's row, so that each row is sent once and
        # the peers' mbarriers count the bytes they expect.
        ("const int r = rg * 4 + reduce_rows(acc, ks, KS, v);",
         "const int rr = 2 * ((ks & (KS / 2)) != 0) + "
         "((ks & (KS / 4)) != 0);\n      const int r = rg * 4 + rr;\n"
         "      for (int j = 0; j < 4; ++j) v[j] = acc[rr][j];", 1)],
    "cl no cell": [
        ("    if (cell) {\n      const float4 x = xs[",
         "    if (false) {\n      const float4 x = xs[", 1),
        ("    if (cell) {\n      const float* d =\n",
         "    if (false) {\n      const float* d =\n", 1)],
    "cl no fma": [
        ("for (int k = ks; k < hk; k += KS) {",
         "for (int k = ks; k < 0; k += KS) {", 1),
        ("for (int q = ks; q < Q; q += KS) {",
         "for (int q = ks; q < 0; q += KS) {", 1)],
    "cl no store": [
        ("      y[row * H + col] = h;\n      cs[row * H + col] = c;", "", 1),
        ("for (int g = 0; g < 4; ++g) grow[g * H] = gate[g];", "", 1),
        ("for (int g = 0; g < 4; ++g) drow[g * H] = dg[g];", "", 1)],
}
CL_CUTS = [name for name in CUTS if name.startswith("cl ")]
VARIANTS = {"whole": []}
VARIANTS.update({name: [name] for name in CUTS})
VARIANTS["barrier only"] = [n for n in CUTS if n not in CL_CUTS]
VARIANTS["cl exchange only"] = CL_CUTS


def variant_source(src: str, parts) -> str:
    for part in parts:
        for line, cut, count in CUTS[part]:
            # "if (cell && b < B) {" also opens load_cell's body, with
            # other indentation: count the indented forms.
            found = src.count("      " + line) if part == "no cell" \
                else src.count(line)
            if found != count:
                raise RuntimeError(f"{part}: {line!r} found {found} times, "
                                   f"expected {count}")
            src = src.replace("      " + line, "      " + cut) \
                if part == "no cell" else src.replace(line, cut)
    return src


def main():
    if not torch.cuda.is_available():
        print("bench_torch_lstm_parts: needs a CUDA device", file=sys.stderr)
        return 1
    src = L._SRC.read_text()
    out_dir = BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, parts in VARIANTS.items():
        path = out_dir / f"lstm_{name.replace(' ', '_')}.cu"
        path.write_text(variant_source(src, parts))
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(build_library, paths.values())))

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    whs = {H: torch.randn((H, 4 * H), generator=g, device=dev) * H ** -0.5
           for H in {s[0] for s in SHAPES + CLUSTER_SHAPES}}
    cases = []
    for H, T, B in SHAPES + CLUSTER_SHAPES:
        wh = whs[H]
        xg = torch.randn((T, B, 4 * H), generator=g, device=dev)
        mask = (torch.rand((T, B), generator=g, device=dev) > 0.1).float()
        h0, c0, dcT = (torch.randn((B, H), generator=g, device=dev) * 0.5
                       for _ in range(3))
        dy = torch.randn((T, B, H), generator=g, device=dev)
        cases.append((H, T, B, wh, xg, mask, h0, c0, dy, dcT))
    warm = torch.randn((4096, 4096), generator=g, device=dev)
    t0 = time.time()
    while time.time() - t0 < 2.0:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()

    res = {}
    for name, lib in libs.items():
        # Load this variant in place of the wrappers' library.
        L._lib = None
        L.build = lambda lib=lib: lib
        L.load()
        row = {}
        # A variant of one path's kernels is timed at that path's shapes.
        cl = {p.startswith("cl ") for p in VARIANTS[name]}
        for H, T, B, wh, xg, mask, h0, c0, dy, dcT in cases:
            if cl and ((H, T, B) in CLUSTER_SHAPES) not in cl:
                continue
            n = 10 if T > 1 else 40
            _, gates, cs, _, _ = L.lstm_fwd(xg, wh, mask, h0, c0)
            row[f"K3 H={H} T={T} B={B}"] = graph_ms(
                [lambda: L.lstm_fwd(xg, wh, mask, h0, c0)] * n)
            if T > 1:
                row[f"K4 H={H} T={T} B={B}"] = graph_ms(
                    [lambda: L.lstm_bwd(gates, cs, c0, mask, wh, dy, dcT)]
                    * n)
        res[name] = row
        print(f"{name:13s} " + "  ".join(f"{k} {v:.4f}"
                                          for k, v in row.items()),
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"device_ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
