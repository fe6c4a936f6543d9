#!/usr/bin/env python3
"""The per-layer metrics read from the program's own spans and counters
(``rlpyt_tpu_torch/utils/profiling.py``), for one cell.

    python3 benchmark/spanned.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file>]

In one process: the cell's set-up as ``run.py`` makes it, then its
traced window as ``run.py --trace 1`` runs it (the accepted per-layer
metrics, from the benchmark's own wrappers), then stretches of plain
iterations with the program's recorder off and on in turns (the
recorder's cost on), then a stretch with the benchmark's synchronized
wrappers and the recorder both on (each program span beside the wrapper
around it), then one profiled stretch with the recorder on (the
program's spans are profiler ranges there).  The readers of
``metrics/`` that read ``ctx.program_spans`` (the records of the
recorder's turns) and ``ctx.program_ops`` (``progtrace.attribute``
of the profiled stretch) give the new metrics.  Prints one JSON line:
both sets of metrics; ``consistency``, the share of the profiled
stretch's device operations that ``collect`` and ``optimize`` hold;
``farm_step_ms``, the program's median ``farm.step`` beside
``envs.farm_step_ms``; ``nested``, the program's spans beside the
wrappers around them in one stretch; ``cost``, the recorder's off and on cost per
iteration; the idle gaps labelled by the program's spans; the device
operations and syncs by innermost span; the runtime calls made inside
the spans by name.  ``--out`` also writes the records as Chrome trace
events.  Needs a card, like ``run.py``.  Not run by the benchmark's own
runs.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from collections import Counter
from types import SimpleNamespace

import run as bench_run

PROGRAM_METRICS = ("samplers.launches_per_step", "algos.launches_per_update",
                   "device.syncs_per_iteration", "samplers.collect_self_ms",
                   "samplers.action_wait_ms", "envs.farm_worker_ms",
                   "envs.farm_barrier_ms")
ROUNDS = 4          # turns of recorder off and on
PROFILE_SECONDS = 1.0


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


def _profiled(window, profiling, seconds: float, tmpdir: str):
    """A profiled stretch with the recorder on: (iterations, wall, trace
    path, recorder)."""
    from torch.profiler import ProfilerActivity, profile
    dev = window.trainer.device
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profiling.recording() as rec:
        with profile(activities=acts) as prof:
            n, wall = window.run(seconds)
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    prof.export_chrome_trace(path)
    rec.align(path)
    return n, wall, path, rec


def _runtime_calls(path, names) -> dict:
    """The runtime and driver calls made inside program ranges, by name
    (the names ``progtrace.SYNC_CALLS`` is read against)."""
    import progtrace
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in names)
    out = Counter()
    for e in events:
        if e.get("cat") in progtrace.LAUNCH_CATS and any(
                s <= e["ts"] <= t for s, t in ranges):
            out[e["name"]] += 1
    return dict(out.most_common(40))


def measure(name: str, seed: int, seconds: float, device: str = "cuda",
            reg=None, overrides=None) -> dict:
    import devtrace
    import harness
    import progtrace
    from registry import Registry

    from rlpyt_tpu_torch.utils import profiling

    reg = reg or Registry()
    prep = harness.Prepared(reg, name, seed, device, overrides)
    trainer, window = prep.trainer, None
    try:
        window = harness.Window(trainer)
        accepted = harness._traced_window(window, trainer, prep.work_shapes,
                                          seconds, reg, name)
        off, on, turns, n_on = _turns(window, profiling, seconds)
        nested = _nested(window, profiling, seconds / 4)
        records = turns.spans()
        n_prof, wall_prof, path, rec = _profiled(
            window, profiling, min(seconds, PROFILE_SECONDS),
            tempfile.gettempdir())
        try:
            prof_records = rec.spans()
            names = {r.name for r in prof_records}
            ops = progtrace.attribute(path, names)
            gaps = devtrace.summarize(path)["idle_gaps"]
            calls = _runtime_calls(path, names)
        finally:
            os.remove(path)
        attempted, failed = window.attempted, int(window.bad)
        updates = getattr(trainer.algo, "updates_per_optimize", 1)
    finally:
        del window, trainer
        prep.release()

    ctx = SimpleNamespace(
        program_spans=records, program_ops=ops,
        profiled_iterations=n_prof, iteration=prep.work_shapes.iteration,
        updates_per_optimize=updates)
    metrics = {}
    for m in PROGRAM_METRICS:
        reader = reg.metric(m)
        if name in getattr(reader, "WORKLOADS", [name]):
            value = reader.read(ctx)
            if value is not None:
                metrics[m] = {"value": value, "unit": reader.UNIT}
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
    held = ops.by_root.get("collect", 0) + ops.by_root.get("optimize", 0)
    per_itr = 1.0 / n_prof
    return {
        "workload": name, "seed": seed,
        "accepted": accepted["metrics"], "metrics": metrics,
        "consistency": {
            "device_ops_per_iteration": ops.device_ops * per_itr,
            "held_per_iteration": held * per_itr,
            "share": held / ops.device_ops if ops.device_ops else None},
        "farm_step_ms": {
            "program": progtrace.span_ms(records, "farm.step"),
            "envs.farm_step_ms": accepted["metrics"].get(
                "envs.farm_step_ms", {}).get("value")},
        "nested": nested,
        "cost": cost,
        "idle_gaps": gaps,
        "device": {"busy_s": accepted["device"]["busy_s"],
                   "window_s": accepted["device"]["window_s"],
                   "profiled_iterations": n_prof,
                   "profiled_wall_s": wall_prof,
                   "offset_ns": rec.offset_ns},
        "ops_by_span": {k or "(none)": v * per_itr
                        for k, v in ops.by_span.most_common(25)},
        "ops_by_root": {k or "(none)": v * per_itr
                        for k, v in ops.by_root.items()},
        "syncs": dict(ops.syncs),
        "syncs_by_span": dict(ops.syncs_by_span),
        "runtime_calls": calls,
        "attempted": attempted, "failed": failed,
        "chrome_events": rec.chrome_events(untraced_only=False),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", help="also write the profiled stretch's "
                    "records here, as Chrome trace events")
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
    events = out.pop("chrome_events")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"traceEvents": events}, f)
    out["device"].update(kind=torch.cuda.get_device_name(0),
                         power_limit=bench_run.power_limit())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
