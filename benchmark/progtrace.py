"""The program's own spans, read for the per-layer metrics: its records
(``rlpyt_tpu_torch/utils/profiling.py``'s ``SpanRecord``s) and the
Chrome trace of a profiled stretch in which the recorder was on, where
each span is also a profiler range of its name.

``attribute`` gives each device operation of the trace (kernel, copy,
set) the innermost program span whose host range holds the runtime or
driver call that launched it, found through the correlation id, and the
outermost span open at that moment on any thread (its root: ``collect``,
``optimize``).  A launch on a thread that holds no program span (the
autograd engine's thread of a card's backward) takes the innermost span
of the other threads.  Roots are found by time, which suits runners
whose threads do not overlap their roots (not ``AsyncHostRl``).  It
sums each operation's device seconds into every span that holds its
launch: the launching thread's open spans, and those of other threads
opened before them (``update.backward`` on the main thread holds
``ops.lstm_bwd`` on the autograd engine's), each span name once.  It
also counts the synchronizing runtime and driver calls made inside
program spans.  The span helpers read the records alone, and import
the program only where it handed some: a checkout whose program records
no spans reads nothing here and raises nothing.
"""
from __future__ import annotations

import json
import statistics
from collections import Counter
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# The runtime and driver calls that block the host until the device (a
# stream, an event, the whole device) has caught up, and the copies that
# do so by their contract.
SYNC_CALLS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D", "cudaMemset",
    "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
    "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpyHtoD", "cuMemcpyHtoD_v2",
    "cuMemcpy", "cuMemcpyDtoD_v2"})


class Attribution(NamedTuple):
    """A profiled stretch's device operations and syncs by program span:
    ``device_ops`` (all of them), ``by_root`` and ``by_span`` (Counters
    of the operations by outermost and by innermost program span; None
    for those launched outside every span), ``syncs`` (Counter of the
    synchronizing calls inside program spans, by call name) and
    ``syncs_by_span`` (by innermost span); ``span_device_s`` (Counter
    of device seconds by (root, span name): the operations launched
    inside each span, its nested spans and the spans of other threads
    it holds included)."""

    device_ops: int
    by_root: Counter
    by_span: Counter
    syncs: Counter
    syncs_by_span: Counter
    span_device_s: Counter


def _events(trace):
    if isinstance(trace, (list, tuple)):
        return trace
    with open(trace) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def attribute(trace, span_names) -> Attribution:
    """Read ``trace`` (a Chrome trace's path, or its complete events)
    whose user ranges named in ``span_names`` are the program's spans."""
    events = _events(trace)
    names = set(span_names)
    # A sweep over time: each range opens before, and closes after, the
    # launches at its own start and end.
    sweep = []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name") in names:
            sweep.append((e["ts"], 0, e))
            sweep.append((e["ts"] + e["dur"], 2, e))
        elif cat in LAUNCH_CATS:
            sweep.append((e["ts"], 1, e))
    sweep.sort(key=lambda x: (x[0], x[1]))
    stacks = {}      # thread -> its open program ranges, outermost first
    owner = {}       # correlation id -> (innermost span, root, held by)
    syncs, syncs_by_span = Counter(), Counter()
    for _, kind, e in sweep:
        tid = e.get("tid")
        if kind == 0:
            stacks.setdefault(tid, []).append(e)
        elif kind == 2:
            stack = stacks[tid]
            del stack[next(i for i in range(len(stack) - 1, -1, -1)
                           if stack[i] is e)]
        else:
            own = stacks.get(tid) or []
            others = [r for t, s in stacks.items() if t != tid for r in s]
            if not own and not others:
                continue
            inner = own[-1] if own else max(
                (s[-1] for t, s in stacks.items() if t != tid and s),
                key=lambda r: r["ts"])
            if own:
                others = [r for r in others if r["ts"] <= own[0]["ts"]]
            held = own + others
            root = min(held, key=lambda r: r["ts"])
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                owner[corr] = (inner["name"], root["name"],
                               {r["name"] for r in held})
            if e["name"] in SYNC_CALLS:
                syncs[e["name"]] += 1
                syncs_by_span[inner["name"]] += 1
    by_root, by_span, span_s = Counter(), Counter(), Counter()
    n = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        n += 1
        inner, root, held = owner.get(
            e.get("args", {}).get("correlation"), (None, None, ()))
        by_root[root] += 1
        by_span[inner] += 1
        for name in held:
            span_s[root, name] += e["dur"] * 1e-6
    return Attribution(n, by_root, by_span, syncs, syncs_by_span, span_s)


def device_s(span_device_s, names, root=None) -> float:
    """The device seconds inside the spans ``names`` (which do not nest
    one another), under ``root`` (under any root without it)."""
    names = set(names)
    return sum(v for (r, name), v in span_device_s.items()
               if name in names and (root is None or r == root))


# ---------------------------------------------------------------------------
# The records.

def _median_ms(ns):
    return 1e-6 * statistics.median(ns) if ns else None


def collect_self_ms(records):
    """The median over collection batches of ``collect``'s self time."""
    from rlpyt_tpu_torch.utils.profiling import self_times
    own = self_times(records)
    return _median_ms([own[i] for i, r in enumerate(records)
                       if r.name == "collect" and r.parent is None])


def span_ms(records, name):
    """The median duration of the spans ``name``."""
    return _median_ms([r.end - r.start for r in records
                       if r.name == name and r.end is not None])


def farm_steps(records):
    """(``farm.step``'s duration, its slowest ``farm.worker``'s) for each
    farm step that has worker records."""
    slowest = {}
    for r in records:
        if r.name == "farm.worker" and r.parent is not None:
            slowest[r.parent] = max(slowest.get(r.parent, 0),
                                    r.end - r.start)
    return [(records[i].end - records[i].start, w)
            for i, w in slowest.items()]


def farm_worker_ms(records):
    """The median over farm steps of the slowest worker's stepping."""
    return _median_ms([w for _, w in farm_steps(records)])


def farm_barrier_ms(records):
    """The median over farm steps of ``farm.step`` less its slowest
    worker: the barrier's wake-up and post, and the master's own work."""
    return _median_ms([s - w for s, w in farm_steps(records)])
