#!/usr/bin/env python3
"""Readings from which the check's limits are set, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--witness-seeds 1 2 3] \
        [--out calibrate_<cell>.json]

For each seed, in one process: the cell's set-up (the trainer driven
from the seed through its first learning iteration, the first updates
captured), then the check's numbers of

- the program against the reference (the lower readings), with where
  each worst gap lies;
- for the control seeds, each other form of the reference in the
  program's place (the check module's ``VARIANTS``: the controls, the
  upper readings, and the planted faults);
- for the witness seeds, the float64 reference against the program and
  against the float32 reference: where float32's own round-off reads as
  much as the program's gap, the cause lies in the number compared.

A step that leaves the state unchanged reads 1 on ``change`` by
construction and needs no run.  Prints one JSON line a seed (with
``argmax_margin``, the reference's closest double-Q call) and a summary
line: the largest program reading and the smallest reading of each
variant, and whether each variant fails the configuration's limits.
Not run by the benchmark's own runs.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

import run as bench_run

SKIP = ("reference", "fp64")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench_run.prepare_environment()
    import check
    from harness import Prepared
    from registry import Registry

    reg = Registry()
    rows = []
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            prep = Prepared(reg, args.workload, seed, "cuda")
            dev = prep.release()
            c = prep.check
            prog, refr = c.program(), c.reference(dev)
            row = {"seed": seed,
                   "program": c.compare(prog, refr, dev, detail=True),
                   "argmax_margin": min(refr.margins)}
            if seed in args.control_seeds:
                for v in prep.family.VARIANTS:
                    if v not in SKIP:
                        row[v] = c.compare(c.reference(dev, v), refr, dev)
            if seed in args.witness_seeds:
                r64 = c.reference(dev, "fp64")
                row["program_vs_fp64"] = c.compare(prog, r64, dev,
                                                   detail=True)
                row["fp32_vs_fp64"] = c.compare(refr, r64, dev,
                                                detail=True)
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
            rows.append(row)
            limits = prep.limits
            del prep, c, prog, refr
            gc.collect()
    finally:
        bench_run.stop_resource_tracker()
    keys = [k for k in rows[0]["program"] if k != "where"]
    summary = {"lower": {k: max(r["program"][k] for r in rows)
                         for k in keys}}
    sides = sorted({k for r in rows for k in r} - {
        "seed", "program", "argmax_margin", "seconds"})
    for side in sides:
        got = [r[side] for r in rows if side in r]
        agg = max if side.endswith("fp64") else min
        summary[side] = {k: agg(g[k] for g in got) for k in keys}
        if not side.endswith("fp64"):
            summary[side]["fails_every_seed"] = all(
                not check.judge({k: g[k] for k in keys}, limits)
                for g in got)
    print(json.dumps({"summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
