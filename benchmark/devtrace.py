"""The benchmark's own wrappers, and the profiler's trace.

``Spans`` wraps the calls into each layer of the program (on the object,
for the traced run only) and records their host time, with the device
synchronized at each span's end.  ``summarize`` reads a Chrome trace
exported by ``torch.profiler``: the device's busy time, its top
operations and the idle gaps by what the host was doing, read from the
program's spans where the recorder had them in the trace
(``progtrace.py`` attributes device time to those spans).
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import torch

from progtrace import DEVICE_CATS

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


def _host_label(stack, spans) -> str:
    """What the host was doing: the innermost program span and the
    innermost operation inside it."""
    if not stack:
        return "host: no traced operation"
    program = [e["name"] for e in stack if e["name"] in spans]
    inner = stack[-1]["name"]
    if program and program[-1] != inner:
        return f"{program[-1]} > {inner}"[:120]
    return inner[:120]


def summarize(trace_path, spans=()) -> dict:
    """Read a Chrome trace of ``torch.profiler`` whose user ranges named
    in ``spans`` are the program's spans.  Returns ``busy_s`` (the union
    of device operations), ``device_ops`` and ``idle_gaps`` (top 10
    [name, seconds]: device operations by total time, idle time by what
    the host's main thread was doing) and ``n_device_ops``."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = set(spans)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
    ops = defaultdict(float)
    for e in dev:
        ops[e["name"][:120]] += e["dur"] * 1e-6

    # The host's main thread: the one that holds the program's collection
    # spans (else the busiest).
    host = [e for e in events if e.get("cat") in HOST_CATS]
    tids = defaultdict(int)
    for e in host:
        tids[e["tid"]] += 2 if e["name"] == "collect" else 0
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
            gaps[_host_label(live, spans)] += length * 1e-6
    return {"busy_s": sum(e - s for s, e in busy) * 1e-6,
            "device_ops": _top(ops), "idle_gaps": _top(gaps),
            "n_device_ops": len(dev)}
