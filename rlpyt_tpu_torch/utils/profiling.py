"""Profiling helpers (port of rlpyt_tpu/utils/profiling.py), and the
port's span-and-counter recorder.

- ``span(name)``, ``count(name, key, n)``: the program's own spans and
  counters, recorded only while a ``Recorder`` is on (``recording()``,
  ``start()``/``stop()``, or ``trace``); while it is off ``span``
  returns one shared null context and ``count`` returns at once;
  ``backward_span(y, leaves, name)``: a span around the backward
  from ``y`` to ``leaves``, likewise only while a recorder is on;
  ``paused()``: none of them inside a block;
- ``trace(log_dir)``: ``torch.profiler`` over the host and the card,
  written as a Chrome trace (open in Perfetto or chrome://tracing), the
  recorder on, its spans in the trace under their own names and the
  records no profiler range holds (the farm workers') on tracks of
  their own;
- ``self_times``: each span's duration less what its child spans cover;
- ``time_fn``: wall time of a callable after warm-up, synchronized with
  the card when one is in use;
- ``device_memory_stats``: the caching allocator's statistics of each
  visible card;
- ``enable_persistent_compilation_cache``: where the CUDA kernels'
  builds are kept, so later launches of the program reuse them.

Span times are ``time.perf_counter_ns()``, which is CLOCK_MONOTONIC: one
clock for every process of the machine, so a farm worker's stamps and
the master's spans compare directly.  Only while a ``torch.profiler``
is recording does a span also open ``record_function(name)``; the
recorder then measures the offset between its clock and the trace's
(``Recorder.align``), which places any of its records on the device
timeline.  This module imports torch only when it needs it: the farm's
workers, which import it, are numpy only.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

# The span whose opening at the root of its thread starts a collection
# batch: every record keeps the number of the batch it belongs to.
BATCH_ROOT = "collect"

_NULL = contextlib.nullcontext()
_recorder: Optional["Recorder"] = None


class SpanRecord:
    """One span: ``name``; ``start``, ``end`` (``perf_counter_ns``; end
    None while open); ``parent`` (the index of the enclosing span of the
    same thread, None at a root); ``thread`` (the native thread id, or
    the pid of the farm worker it stands for); ``batch`` (the collection
    batch); ``traced`` (a profiler range was opened with it)."""

    __slots__ = ("name", "start", "end", "parent", "thread", "batch",
                 "traced")

    def __init__(self, name, start, end, parent, thread, batch, traced):
        self.name, self.start, self.end = name, start, end
        self.parent, self.thread, self.batch = parent, thread, batch
        self.traced = traced

    @property
    def duration(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, {self.start}, {self.end}, "
                f"parent={self.parent}, thread={self.thread}, "
                f"batch={self.batch})")


class _Span:
    """The context of one open span of a recorder."""

    __slots__ = ("rec", "name", "index", "range")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        local = rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.thread = threading.get_native_id()
        traced = rec._profiler_enabled()
        with rec._lock:
            if not stack and self.name == BATCH_ROOT:
                rec.batch += 1
            self.index = len(rec._records)
            rec._records.append(SpanRecord(
                self.name, time.perf_counter_ns(), None,
                stack[-1] if stack else None, local.thread, rec.batch,
                traced))
        stack.append(self.index)
        self.range = None
        if traced:
            self.range = rec._record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        rec._records[self.index].end = time.perf_counter_ns()
        rec._local.stack.pop()
        return False


class Recorder:
    """Spans and counters of one recording, kept in memory.

    ``spans()``: the records in the order they opened; ``counts[name]``:
    a counter's counts by key; ``offset_ns``: the trace's clock less the
    recorder's (set by ``align``); ``batch``: the collection batches
    begun so far."""

    def __init__(self):
        import torch
        from torch.autograd.profiler import record_function

        self._profiler_enabled = torch._C._autograd._profiler_enabled
        self._record_function = record_function
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: List[SpanRecord] = []
        self.counts: Dict[str, Dict[Any, int]] = {}
        self.batch = 0
        self.offset_ns: Optional[int] = None

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, start: int, end: int, thread) -> int:
        """A record made elsewhere (a farm worker's stamps), as a child of
        this thread's innermost open span; returns its index."""
        stack = getattr(self._local, "stack", None)
        with self._lock:
            self._records.append(SpanRecord(
                name, start, end, stack[-1] if stack else None, thread,
                self.batch, False))
            return len(self._records) - 1

    def count(self, name: str, key=None, n: int = 1):
        with self._lock:
            by_key = self.counts.setdefault(name, {})
            by_key[key] = by_key.get(key, 0) + n

    def total(self, name: str, match: Optional[Callable] = None) -> int:
        """The sum of counter ``name`` over the keys that ``match``
        accepts (every key without it)."""
        return sum(n for k, n in self.counts.get(name, {}).items()
                   if match is None or match(k))

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)

    def align(self, trace_path) -> Optional[int]:
        """Measure ``offset_ns`` from a Chrome trace of ``torch.profiler``,
        over the spans recorded both here and as profiler ranges (the
        k-th traced span of a name paired with the trace's k-th range of
        that name, for names whose counts agree).  Each range opened
        after its span and closed before it, so each pair bounds the
        offset from both sides: the middle of the bounds that every pair
        keeps, or where clock noise leaves none, the median difference
        of the pairs' middles.  None where no span pairs."""
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        ours: Dict[str, list] = {}
        for r in self.spans():
            if r.traced and r.end is not None:
                ours.setdefault(r.name, []).append(r)
        theirs: Dict[str, list] = {}
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") in ours):
                theirs.setdefault(e["name"], []).append(e)
        lo, hi, mids = [], [], []
        for name, recs in ours.items():
            evs = sorted(theirs.get(name, []), key=lambda e: e["ts"])
            if len(evs) != len(recs):
                continue
            for r, e in zip(recs, evs):
                start, end = 1e3 * e["ts"], 1e3 * (e["ts"] + e["dur"])
                lo.append(end - r.end)
                hi.append(start - r.start)
                mids.append((start + end - r.start - r.end) / 2)
        if not mids:
            self.offset_ns = None
        elif max(lo) <= min(hi):
            self.offset_ns = round((max(lo) + min(hi)) / 2)
        else:
            self.offset_ns = round(statistics.median(mids))
        return self.offset_ns

    def chrome_events(self, untraced_only: bool = True) -> list:
        """The records as Chrome trace events on the trace's clock (after
        ``align``): those no profiler range holds (``untraced_only``), each
        thread on a track of its own, ``args`` holding the batch."""
        if self.offset_ns is None:
            return []
        out = []
        for r in self.spans():
            if r.end is None or (untraced_only and r.traced):
                continue
            out.append({"ph": "X", "cat": "program_span", "name": r.name,
                        "pid": f"program spans {os.getpid()}",
                        "tid": r.thread,
                        "ts": (r.start + self.offset_ns) / 1e3,
                        "dur": r.duration / 1e3,
                        "args": {"batch": r.batch}})
        return out


def span(name: str):
    """``with span(name):`` records the block as a span of the live
    recorder; nothing (one shared null context) while none is on."""
    rec = _recorder
    if rec is None:
        return _NULL
    return rec.span(name)


def spanned(name: str):
    """A decorator: each call of the function in ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def backward_span(y, leaves, name: str):
    """``y``, or while a recorder is on a view of it whose backward runs in
    span ``name``: from the moment the gradient reaches ``y`` to the
    moment the gradients of every tensor of ``leaves`` that the backward
    reaches through ``y`` are computed.  Like ``ops.lstm_bwd``, the span
    is on the thread of the autograd engine that runs the backward."""
    if _recorder is None or not y.requires_grad:
        return y
    import torch

    box = {}

    def close(_grads):
        handle.remove()
        opened = box.pop("span", None)
        if opened is not None:
            opened.__exit__(None, None, None)

    handle = torch.autograd.graph.register_multi_grad_hook(
        [t for t in leaves if t.requires_grad], close, mode="all")
    return _backward_opener().apply(y, box, name)


@functools.lru_cache(maxsize=None)
def _backward_opener():
    """The autograd function that opens ``backward_span``'s span (made at
    first use: this module imports torch only when it needs it)."""
    import torch

    class OpenBackwardSpan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, box, name):
            ctx.box, ctx.name = box, name
            return y.view_as(y)

        @staticmethod
        def backward(ctx, dy):
            opened = span(ctx.name)
            opened.__enter__()
            ctx.box["span"] = opened
            return dy, None, None

    return OpenBackwardSpan


def count(name: str, key=None, n: int = 1):
    """Add ``n`` to counter ``name`` under ``key`` while a recorder is
    on."""
    rec = _recorder
    if rec is not None:
        rec.count(name, key, n)


def active() -> Optional[Recorder]:
    """The live recorder, or None."""
    return _recorder


def start(rec: Optional[Recorder] = None) -> Recorder:
    """Turn ``rec`` (without it, a fresh recorder) on in place of any live
    one; returns it."""
    global _recorder
    _recorder = rec if rec is not None else Recorder()
    return _recorder


def stop() -> Optional[Recorder]:
    """Turn the recorder off; returns the one that was on."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec


@contextmanager
def recording():
    """``with recording() as rec:`` records the block's spans and counts
    into a fresh recorder, and restores whatever was on before."""
    global _recorder
    before = _recorder
    rec = start()
    try:
        yield rec
    finally:
        _recorder = before


@contextmanager
def paused():
    """No span or count inside the block, from any thread; whatever
    recorder was on is on again after it.  Around a CUDA graph's body,
    whose Python runs at its capture alone."""
    global _recorder
    before, _recorder = _recorder, None
    try:
        yield
    finally:
        _recorder = before


def self_times(records: List[SpanRecord]) -> List[int]:
    """Each record's self time in ns: its duration less the union of its
    children's ranges inside it (children may overlap, as the farm's
    workers do)."""
    kids: Dict[int, list] = {}
    for r in records:
        if r.parent is not None and r.end is not None:
            kids.setdefault(r.parent, []).append((r.start, r.end))
    out = []
    for i, r in enumerate(records):
        if r.end is None:
            out.append(0)
            continue
        covered, last = 0, r.start
        for s, e in sorted(kids.get(i, [])):
            s, e = max(s, last), min(e, r.end)
            if e > s:
                covered += e - s
                last = e
        out.append(r.end - r.start - covered)
    return out


@contextmanager
def trace(log_dir: str):
    """Profile a region, ``with trace(d): run()``; the trace goes to
    ``d/trace_<pid>_<time>.json``.  Yields the profiler.  The recorder
    is on inside (the live one, else a fresh one): its spans are in the
    trace as ranges of their names, and its records that no range holds
    (the farm workers') are added on tracks of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with contextlib.ExitStack() as stack:
        rec = _recorder or stack.enter_context(recording())
        with profile(activities=activities) as prof:
            yield prof
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if rec.align(path) is not None:
        extra = rec.chrome_events()
        if extra:
            with open(path) as f:
                doc = json.load(f)
            doc["traceEvents"].extend(extra)
            with open(path, "w") as f:
                json.dump(doc, f)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Mean wall seconds of ``fn(*args, **kwargs)`` over ``iters`` calls
    after ``warmup`` ones.  Once the process uses a card, the card is
    synchronized before the clock starts and before it stops; otherwise
    ``perf_counter`` alone measures."""
    import torch

    for _ in range(warmup):
        fn(*args, **kwargs)
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters_per_s": 1.0 / dt}


def device_memory_stats() -> Dict[str, Any]:
    """``torch.cuda.memory_stats`` of each visible card, by name
    ("cuda:0", ...); None for a card that reports none.  Empty without a
    card."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for d in range(torch.cuda.device_count()):
        try:
            out[f"cuda:{d}"] = torch.cuda.memory_stats(d) or None
        except RuntimeError:
            out[f"cuda:{d}"] = None
    return out


def enable_persistent_compilation_cache(cache_dir: str) -> None:
    """Keep the kernels' builds in ``cache_dir`` instead of the package's
    ``csrc/build/``, so that repeated launches (sweeps, benches, resumed
    runs) reuse them.  Call it before the first kernel is built: a
    library already loaded stays where it was built."""
    from rlpyt_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR = Path(cache_dir)
