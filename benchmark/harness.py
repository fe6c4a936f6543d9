"""One run of one cell: set-up, the measured window, the check.

``run_cell`` builds the cell's trainer, fills the replay to the first
learning iteration, runs that iteration with the check's capture, runs
the warm iterations, then measures for ``seconds``: the env steps over
the window's wall time, and the learner's time, each optimize between
two marks on the device's clock.  With ``trace`` it splits the window
into four stretches: plain iterations (the MFU), the same with
synchronized spans at each layer (the layers' times), the program's
recorder on, and a profiled stretch (the idle share, the device's top
operations and idle gaps, the rooflines).  After the window it reads the
memory peak, frees the trainer and runs the reference.
"""
from __future__ import annotations

import os
import statistics
import tempfile
import time
from types import SimpleNamespace

import torch

import check
import progtrace
import work
from devtrace import Spans, summarize
from registry import Registry
from trainer import Trainer

WARM_ITERATIONS = 1     # after the checked ones, before the window
# The traced window: shares of plain, of spanned and of recorded
# iterations, then at most PROFILE_SECONDS (at least one iteration) under
# the profiler, whose trace of a rr32 iteration alone holds some 10^5
# events.
PLAIN_SHARE, SPANS_SHARE, RECORDED_SHARE = 0.4, 0.2, 0.2
PROFILE_SECONDS = 1.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LearnerClock:
    """The learner's time: each optimize between two marks, on the
    device's clock on a card (CUDA events, read once the device has been
    synchronized after them: from the device reaching the optimize's
    first operation to its finishing the last), on the host's clock off
    it, where an optimize has ended when it returns."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(self):
        self.marks.append(self._mark())

    def stop(self):
        self.marks.append(self._mark())

    def seconds(self, first: int = 0) -> float:
        """Seconds of the optimizes from the ``first``-th on."""
        m = self.marks[2 * first:]
        pairs = zip(m[0::2], m[1::2])
        if self.cuda:
            return sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        return sum(b - a for a, b in pairs)


class Window:
    """Iterations of the trainer, each adding one to ``attempted`` and
    counting, on the device, those whose loss, gradient norm or mean
    written priority is not finite; each optimize timed by ``learner``."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.attempted = 0
        self.bad = torch.zeros((), dtype=torch.int64,
                               device=trainer.device)
        self.learner = LearnerClock(trainer.device)
        self.learner_s = 0.0

    def iterate(self):
        info = self.trainer.iteration(self.learner)
        self.bad += (~torch.isfinite(torch.stack(list(info)))).any()
        self.attempted += 1

    def run(self, seconds: float, at_least: int = 1):
        """Iterations until ``seconds`` have passed (at least
        ``at_least``), the device synchronized at both ends: (iterations,
        wall seconds).  ``learner_s``: the seconds of their optimizes."""
        dev = self.trainer.device
        first = self.attempted
        _sync(dev)
        t0 = time.perf_counter()
        n = 0
        while n < at_least or time.perf_counter() - t0 < seconds:
            self.iterate()
            n += 1
        _sync(dev)
        wall = time.perf_counter() - t0
        self.learner_s = self.learner.seconds(first)
        return n, wall


def _median_s(xs):
    return statistics.median(xs) if xs else None


def _profile(window: Window, seconds: float, tmpdir: str):
    """A stretch of the window under torch.profiler (host and device) with
    the program's recorder on: (iterations, wall seconds, trace summary,
    attribution by program span, the recorder aligned to the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from rlpyt_tpu_torch.utils import profiling
    dev = window.trainer.device
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profiling.recording() as rec:
        with profile(activities=acts) as prof:
            n, wall = window.run(seconds)
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        rec.align(path)
        names = {r.name for r in rec.spans() if r.traced}
        summary = summarize(path, names)
        ops = progtrace.attribute(path, names)
    finally:
        os.remove(path)
    return n, wall, summary, ops, rec


class Prepared:
    """A cell's trainer after set-up: started, the replay filled, the
    checked updates captured, the warm iterations run.  ``family``: the
    configuration's check module; ``check``: its ``Check`` of this run."""

    def __init__(self, reg: Registry, name: str, seed: int, device: str,
                 overrides: dict | None = None):
        cell = reg.cell(name)
        self.config_file = reg.config(cell["config"])
        self.traffic = reg.traffic(cell["traffic"])
        self.seed = seed
        self.family = family = reg.check(self.config_file["check"])
        marks = [time.perf_counter()]
        self.trainer = Trainer(self.config_file, self.traffic, seed, device,
                               overrides)
        trainer, dev = self.trainer, self.trainer.device
        try:
            if dev.type == "cuda":
                # The configuration states float32: no TF32 in cuBLAS or
                # cuDNN.
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                torch.cuda.reset_peak_memory_stats(dev)
            marks.append(time.perf_counter())
            trainer.startup()
            marks.append(time.perf_counter())
            self.work_shapes = family.work_shapes(trainer)
            while not trainer.learning():
                trainer.iteration()
            _sync(dev)
            marks.append(time.perf_counter())
            self.check = family.Check(trainer, seed)
            with self.check.capture:
                while not self.check.complete:
                    trainer.iteration()
            marks.append(time.perf_counter())
            for _ in range(WARM_ITERATIONS):
                trainer.iteration()
            _sync(dev)
            marks.append(time.perf_counter())
        except BaseException:
            trainer.close()
            raise
        # Where set-up's seconds went (printed, not a metric).
        self.setup_parts = dict(zip(
            ("build", "startup", "fill", "checked", "warm"),
            (b - a for a, b in zip(marks, marks[1:]))))
        self.limits = self.config_file["limits"]

    def release(self):
        """Stop the farm and free the trainer (replay, model, optimizer)."""
        dev = self.trainer.device
        self.trainer.close()
        self.trainer = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return dev

    def numbers(self, dev) -> dict:
        """The check's numbers: the program against the reference."""
        c = self.check
        return c.compare(c.program(), c.reference(dev), dev)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             registry: Registry | None = None,
             overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result's fields (with
    ``checks``: each number compared, with its limit).  ``t_start``: the
    process's start on ``time.perf_counter``'s clock.  ``overrides``:
    config changes for a run at a size a test can hold."""
    reg = registry or Registry()
    prep = Prepared(reg, name, seed, device, overrides)
    trainer, window = prep.trainer, None
    try:
        window = Window(trainer)
        setup_s = time.perf_counter() - t_start
        if not trace:
            n, wall = window.run(seconds)
            updates = n * getattr(trainer.algo, "updates_per_optimize", 1)
            values = {"env_steps_per_s":
                      n * trainer.steps_per_iteration / wall,
                      "learner_update_ms": 1e3 * window.learner_s / updates,
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in reg.end_to_end(name)}
            extra = {}
        else:
            extra = _traced_window(window, trainer, prep.work_shapes,
                                   seconds, reg, name)
            metrics = extra["metrics"]
        attempted, failed = window.attempted, int(window.bad)
        peak = (torch.cuda.max_memory_allocated(trainer.device)
                if trainer.device.type == "cuda" else 0)
    finally:
        del window, trainer
        dev = prep.release()
    numbers = prep.numbers(dev)
    correct = (attempted > 0 and failed == 0
               and check.judge(numbers, prep.limits))
    return {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics, "peak": peak, "trace": extra.get("device"),
        "breakdown": extra.get("breakdown"),
        "setup_parts": prep.setup_parts,
        "checks": {k: {"value": v, "limit": prep.limits[k]}
                   for k, v in numbers.items()},
    }


def _layer_calls(trainer):
    """(object, method, span name) of each layer's calls that the
    trainer has: the collection, the farm's step, the algorithm's
    optimize and the replay's draw."""
    r, algo = trainer.runner, trainer.algo
    calls = ([(r, "_collect_batch", "collect"), (r.vec, "step", "farm_step")]
             if trainer.host else [(r.collector, "collect", "collect")])
    calls.append((algo, "optimize", "optimize"))
    if hasattr(algo, "replay"):
        calls.append((algo.replay, "sample", "replay_sample"))
    return calls


def _traced_window(window, trainer, shapes, seconds, reg, name):
    """The traced run's window: plain, spanned, recorded and profiled
    stretches; the per-layer metrics of the cell (each reader's
    ``read``; those that find nothing are left out)."""
    from rlpyt_tpu_torch.utils import profiling
    algo = trainer.algo
    n_plain, wall_plain = window.run(seconds * PLAIN_SHARE)
    learner_plain = window.learner_s

    spans = Spans(sync=trainer.device.type == "cuda")
    for obj, attr, span in _layer_calls(trainer):
        spans.wrap(obj, attr, span)
    try:
        window.run(seconds * SPANS_SHARE)
    finally:
        spans.restore()

    # The wrappers synchronize inside the program's spans (at each farm
    # step of a collection), so the recorder has a stretch of its own.
    with profiling.recording() as recorded:
        window.run(seconds * RECORDED_SHARE)

    rest = seconds * (1 - PLAIN_SHARE - SPANS_SHARE - RECORDED_SHARE)
    n_prof, wall_prof, summary, ops, profiled = _profile(
        window, min(rest, PROFILE_SECONDS), tempfile.gettempdir())

    ctx = SimpleNamespace(
        spans={k: list(v) for k, v in spans.times.items()},
        median_s=_median_s,
        updates_per_optimize=getattr(algo, "updates_per_optimize", 1),
        geometry=shapes.geometry, iteration=shapes.iteration, work=work,
        plain_iterations=n_plain, plain_wall_s=wall_plain,
        plain_learner_s=learner_plain,
        steps_per_iteration=trainer.steps_per_iteration,
        program_spans=recorded.spans(),
        profiled_iterations=n_prof, profiled_wall_s=wall_prof,
        busy_s=summary["busy_s"], program_ops=ops,
        span_device_s=ops.span_device_s, profiled_recorder=profiled,
        host=trainer.host)
    metrics = {}
    for m in reg.per_layer(name):
        reader = reg.metric(m["name"])
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": reader.UNIT}
    return {
        "metrics": metrics,
        "device": {"busy_s": summary["busy_s"], "window_s": wall_prof},
        "breakdown": {"device_ops": summary["device_ops"],
                      "idle_gaps": summary["idle_gaps"]},
    }
