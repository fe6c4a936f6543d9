#!/usr/bin/env python3
"""What the traced run does not measure of the program's own spans and
counters (``rlpyt_tpu_torch/utils/profiling.py``), for one cell.

    python3 benchmark/spanned.py --workload <cell> --seed <n> \
        --seconds <s>

In one process: the cell's set-up as ``run.py`` makes it, then its
traced window as ``run.py --trace 1`` runs it (every per-layer metric of
the cell, the program's spans and their device time among them), then
stretches of plain iterations with the program's recorder off and on in
turns (the recorder's cost), then a stretch with the benchmark's
synchronized wrappers and the recorder both on (each program span beside
the wrapper around it).  Prints one JSON line: ``metrics``, the traced
window's; ``nested``, the program's spans beside the wrappers around
them in one stretch; ``cost``, the recorder's off and on cost per
iteration.  Needs a card, like ``run.py``.  Not run by the benchmark's
own runs.
"""
import argparse
import json
import statistics
import sys
import time

import run as bench_run

ROUNDS = 4          # turns of recorder off and on


def _null_cost_ns(profiling, n: int = 200_000) -> dict:
    """Host ns of one ``with span(...)`` block and one ``count`` call with
    the recorder off, and of one span with it on (no profiler running)."""
    span, count = profiling.span, profiling.count
    out = {}
    for state in ("off", "on"):
        rec = profiling.start() if state == "on" else None
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("cost"):
                pass
        out[f"span_{state}_ns"] = (time.perf_counter_ns() - t0) / n
        t0 = time.perf_counter_ns()
        for _ in range(n):
            count("cost", (1, 2))
        out[f"count_{state}_ns"] = (time.perf_counter_ns() - t0) / n
        if rec is not None:
            profiling.stop()
    return out


def _turns(window, profiling, seconds: float):
    """Plain iterations in ``ROUNDS`` turns of recorder off, then on, one
    recorder for every on turn: (seconds an iteration of each off turn,
    of each on turn, the recorder, the on turns' iterations)."""
    off, on, n_on = [], [], 0
    rec = profiling.Recorder()
    for _ in range(ROUNDS):
        n, wall = window.run(seconds / (2 * ROUNDS))
        off.append(wall / n)
        profiling.start(rec)
        try:
            n, wall = window.run(seconds / (2 * ROUNDS))
        finally:
            profiling.stop()
        on.append(wall / n)
        n_on += n
    return off, on, rec, n_on


def _nested(window, profiling, seconds: float) -> dict:
    """A stretch with the benchmark's synchronized wrappers
    (``devtrace.Spans`` on ``harness._layer_calls``) and the recorder both
    on: for each wrapped call, the program's median span and the
    wrapper's median, in ms.  The spans of ``collect``, ``farm.step`` and
    ``optimize`` lie inside the methods wrapped; R2D1's ``replay.sample``
    span holds the wrapped ``replay.sample`` call."""
    import devtrace
    import harness
    import progtrace
    trainer = window.trainer
    spans = devtrace.Spans(sync=trainer.device.type == "cuda")
    for obj, attr, name in harness._layer_calls(trainer):
        spans.wrap(obj, attr, name)
    try:
        with profiling.recording() as rec:
            window.run(seconds)
    finally:
        spans.restore()
    records = rec.spans()
    out = {}
    for wrapper, name in (("collect", "collect"), ("farm_step", "farm.step"),
                          ("optimize", "optimize"),
                          ("replay_sample", "replay.sample")):
        if spans.times.get(wrapper):
            out[name] = {
                "program_ms": progtrace.span_ms(records, name),
                "wrapper_ms": 1e3 * statistics.median(spans.times[wrapper])}
    return out


def measure(name: str, seed: int, seconds: float, device: str = "cuda",
            reg=None, overrides=None) -> dict:
    import harness
    from registry import Registry

    from rlpyt_tpu_torch.utils import profiling

    reg = reg or Registry()
    prep = harness.Prepared(reg, name, seed, device, overrides)
    trainer, window = prep.trainer, None
    try:
        window = harness.Window(trainer)
        traced = harness._traced_window(window, trainer, prep.work_shapes,
                                        seconds, reg, name)
        off, on, turns, n_on = _turns(window, profiling, seconds)
        nested = _nested(window, profiling, seconds / 4)
        attempted, failed = window.attempted, int(window.bad)
    finally:
        del window, trainer
        prep.release()

    records = turns.spans()
    spans_per_itr = sum(r.name != "farm.worker" for r in records) / n_on
    counts_per_itr = sum(sum(c.values())
                         for c in turns.counts.values()) / n_on
    cost = _null_cost_ns(profiling)
    itr_off, itr_on = statistics.median(off), statistics.median(on)
    cost.update(
        spans_per_iteration=spans_per_itr,
        counts_per_iteration=counts_per_itr,
        iteration_off_s=itr_off, iteration_on_s=itr_on,
        iterations_off_s=off, iterations_on_s=on,
        off_share=(spans_per_itr * cost["span_off_ns"] + counts_per_itr
                   * cost["count_off_ns"]) * 1e-9 / itr_off,
        on_estimate_s=(spans_per_itr * cost["span_on_ns"] + counts_per_itr
                       * cost["count_on_ns"]) * 1e-9)
    return {
        "workload": name, "seed": seed, "metrics": traced["metrics"],
        "nested": nested, "cost": cost, "device": traced["device"],
        "attempted": attempted, "failed": failed,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    bench_run.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on GPUs",
              file=sys.stderr)
        return 2
    try:
        out = measure(args.workload, args.seed, args.seconds)
    finally:
        bench_run.stop_resource_tracker()
    out["device"].update(kind=torch.cuda.get_device_name(0),
                         power_limit=bench_run.power_limit())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
