#!/usr/bin/env python3
"""The benchmark of rlpyt_tpu_torch's trainers on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once, from the root of a checkout,
on the GPUs of this machine, and prints one JSON line as the last line
of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with the reference, beside its
limit.  The same numbers end its standard error.  It exits with another
code than 0, and prints no result, where CUDA or the cell's GPUs are
missing, or where JAX or the JAX package has been imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rlpyt_tpu")
CACHE = HERE / ".cache"


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``rlpyt_tpu_torch`` is not
    ``rlpyt_tpu``)."""
    names = {m.split(".")[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def prepare_environment():
    """Build and kernel caches in fixed directories inside the checkout;
    the host farm's shared-memory arenas under ``TMPDIR`` rather than
    ``/dev/shm``; the root of the checkout on the import path."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    import multiprocessing.heap
    multiprocessing.heap.Arena._dir_candidates = []
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def stop_resource_tracker():
    """Stop multiprocessing's resource tracker, which spawned workers
    start, and wait for it."""
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


def result_line(res: dict, kind: str, chips: int, trace: bool,
                power: str) -> dict:
    """The result's JSON object from ``harness.run_cell``'s fields, with
    ``checks`` last."""
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res["peak"], "power_limit": power}
    if trace:
        device.update(res["trace"])
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()

    import torch
    from harness import run_cell
    from registry import Registry

    reg = Registry()
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on GPUs",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START, "cuda", reg)
    finally:
        stop_resource_tracker()
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was imported: {found}",
              file=sys.stderr)
        return 3

    out = result_line(res, torch.cuda.get_device_name(0), chips,
                      bool(args.trace), power_limit())
    print("setup parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["setup_parts"].items()),
        file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
