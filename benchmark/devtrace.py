"""Spans and the profiler's trace, recorded from the benchmark's own files.

``Spans`` wraps the calls into each layer of the program (on the object,
for the traced run only) and records their host time, with the device
synchronized at each span's end.  ``Ranges`` marks the same calls, and
the LSTM's forward and backward, as profiler ranges.  ``summarize``
reads a Chrome trace exported by ``torch.profiler``: the device's busy
time, its top operations, the idle gaps by what the host was doing, and
the device time of the kernels each named range launched.
"""
from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Patches:
    """Instance attributes that shadow methods, taken out again by
    ``restore``."""

    def __init__(self):
        self._set = []

    def put(self, obj, attr: str, fn):
        self._set.append((obj, attr, attr in vars(obj), vars(obj).get(attr)))
        setattr(obj, attr, fn)

    def restore(self):
        for obj, attr, had, old in reversed(self._set):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._set = []


class Spans(Patches):
    """Host seconds of each call of the wrapped methods, by span name;
    ``sync``: the device synchronized before each span ends."""

    def __init__(self, sync: bool):
        super().__init__()
        self.sync = sync
        self.times = defaultdict(list)

    def wrap(self, obj, attr: str, name: str):
        orig = getattr(obj, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            self.times[name].append(time.perf_counter() - t0)
            return out

        self.put(obj, attr, timed)


class Ranges(Patches):
    """Profiler ranges around the wrapped methods."""

    def wrap(self, obj, attr: str, name: str):
        orig = getattr(obj, attr)

        def ranged(*args, **kwargs):
            with record_function(name):
                return orig(*args, **kwargs)

        self.put(obj, attr, ranged)

    def wrap_lstm(self, core):
        """Ranges around an LSTM module's calls: ``bench.lstm_step`` at
        T = 1, ``bench.lstm_train`` at T > 1, and ``bench.lstm_bwd`` from
        the moment the gradient reaches the LSTM's output to the moment
        it leaves through its input."""
        orig = core.forward

        def forward(x, done, state):
            T = x.shape[0]
            if T == 1:
                with record_function("bench.lstm_step"):
                    return orig(x, done, state)
            box = {}
            backward = torch.is_grad_enabled() and x.requires_grad
            if backward:
                x = _BackwardEnd.apply(x, box)
            with record_function("bench.lstm_train"):
                y, state = orig(x, done, state)
            if backward:
                y = _BackwardStart.apply(y, box)
            return y, state

        self.put(core, "forward", forward)


class _BackwardStart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, box):
        ctx.box = box
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        ctx.box["range"] = record_function("bench.lstm_bwd")
        ctx.box["range"].__enter__()
        return dy, None


class _BackwardEnd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, box):
        ctx.box = box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        rng = ctx.box.pop("range", None)
        if rng is not None:
            rng.__exit__(None, None, None)
        return dx, None


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top(by_name: dict, n: int = 10):
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])
            [:n]]


def _host_label(stack) -> str:
    """What the host was doing: the innermost benchmark range and the
    innermost operation inside it."""
    if not stack:
        return "host: no traced operation"
    bench = [e["name"] for e in stack if e["name"].startswith("bench.")]
    inner = stack[-1]["name"]
    if bench and bench[-1] != inner:
        return f"{bench[-1]} > {inner}"[:120]
    return inner[:120]


def summarize(trace_path, ranges=()) -> dict:
    """Read a Chrome trace of ``torch.profiler``.  Returns ``busy_s`` (the
    union of device operations), ``device_ops`` and ``idle_gaps`` (top
    10 [name, seconds]: device operations by total time, idle time by
    what the host's main thread was doing), ``range_device_s`` (device
    seconds of the operations launched inside each range of ``ranges``)
    and ``n_device_ops``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
    ops = defaultdict(float)
    for e in dev:
        ops[e["name"][:120]] += e["dur"] * 1e-6

    # The host's main thread: the one that holds the benchmark's
    # collection ranges (else the busiest).
    host = [e for e in events if e.get("cat") in HOST_CATS]
    tids = defaultdict(int)
    for e in host:
        tids[e["tid"]] += 2 if e["name"].startswith("bench.collect") else 0
        tids[e["tid"]] += 1e-9
    gaps = defaultdict(float)
    if tids and len(busy) > 1:
        main = max(tids, key=tids.get)
        thread = sorted((e for e in host if e["tid"] == main),
                        key=lambda e: (e["ts"], -e["dur"]))
        holes = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                        for a, b in zip(busy, busy[1:])),
                       key=lambda g: g[1])
        stack, i = [], 0
        for length, mid in holes:
            while i < len(thread) and thread[i]["ts"] <= mid:
                e = thread[i]
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                    stack.pop()
                stack.append(e)
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
                stack.pop()
            live = [e for e in stack if e["ts"] + e["dur"] >= mid]
            gaps[_host_label(live)] += length * 1e-6

    range_s = {name: 0.0 for name in ranges}
    if ranges:
        spans = defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation" and e["name"] in range_s:
                spans[e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                        e["name"]))
        for v in spans.values():
            v.sort()
        starts = {t: [s for s, _, _ in v] for t, v in spans.items()}
        owner = {}
        for e in events:
            if e.get("cat") not in LAUNCH_CATS or e["tid"] not in spans:
                continue
            corr = e.get("args", {}).get("correlation")
            v = spans[e["tid"]]
            # The named ranges of one thread follow each other.
            k = bisect.bisect_right(starts[e["tid"]], e["ts"]) - 1
            if k >= 0 and corr is not None and e["ts"] <= v[k][1]:
                owner[corr] = v[k][2]
        for e in dev:
            name = owner.get(e.get("args", {}).get("correlation"))
            if name is not None:
                range_s[name] += e["dur"] * 1e-6
    return {"busy_s": sum(e - s for s, e in busy) * 1e-6,
            "device_ops": _top(ops), "idle_gaps": _top(gaps),
            "range_device_s": range_s, "n_device_ops": len(dev)}
