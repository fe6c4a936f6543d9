"""The readers of the program's own spans: device operations and syncs
attributed to the innermost program span of a made-up Chrome trace (the
launching thread's own spans first, else another thread's), device
seconds summed into every span that holds a launch, the span metrics on
made-up records, the rooflines on made-up device seconds, the readers
silent where the program records nothing, and the tiny cells on the CPU
through ``spanned.py``."""
import json
from types import SimpleNamespace

import pytest

import progtrace
import work
import work_conv
import work_resnet
from conftest import TINY_ATARI, TINY_MINATAR, TinyRegistry
from registry import Registry
from test_resnet_cell import NARROW
from trainer import merge

REG = Registry()
NEW = ("samplers.launches_per_step", "algos.launches_per_update",
       "device.syncs_per_iteration", "samplers.collect_self_ms",
       "samplers.action_wait_ms", "envs.farm_worker_ms",
       "envs.farm_barrier_ms")


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def _launch(ts, tid, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 1, tid, correlation=corr)


SPANS = ("collect", "collect.agent", "ops.lstm_step", "optimize", "update",
         "update.backward", "ops.lstm_bwd")


def _trace():
    ev = [
        _x("user_annotation", "bench.collect", 0, 100, 1),
        _x("user_annotation", "collect", 0, 100, 1),
        _x("user_annotation", "collect.agent", 10, 40, 1),
        _x("user_annotation", "ops.lstm_step", 20, 10, 1),
        _launch(22, 1, 1),                      # ops.lstm_step
        _launch(35, 1, 2, "cudaMemcpyAsync"),   # collect.agent
        _x("cuda_runtime", "cudaStreamSynchronize", 40, 5, 1),
        _launch(70, 1, 3),                      # collect
        _launch(150, 1, 4),                     # no span
        _x("cuda_runtime", "cudaStreamSynchronize", 160, 5, 1),
        _x("user_annotation", "optimize", 200, 300, 1),
        _x("user_annotation", "update", 210, 280, 1),
        _x("user_annotation", "update.backward", 250, 100, 1),
        # The autograd engine's thread: a launch inside its own span, and
        # one outside, held by the main thread's update.backward.
        _x("user_annotation", "ops.lstm_bwd", 260, 20, 7),
        _launch(265, 7, 5),
        _launch(300, 7, 6),
        _x("cuda_driver", "cuEventSynchronize", 320, 2, 1),
        _launch(400, 1, 7),                     # update
    ]
    ev += [_x("kernel", f"k{c}", 1000 + 10 * c, 5, 0, correlation=c)
           for c in (1, 3, 4, 5, 6, 7)]
    ev.append(_x("gpu_memcpy", "Memcpy DtoH", 1025, 5, 0, correlation=2))
    return ev


def test_attribution_to_the_innermost_span(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    a = progtrace.attribute(str(path), SPANS)
    assert a.device_ops == 7
    assert a.by_span == {"ops.lstm_step": 1, "collect.agent": 1,
                         "collect": 1, None: 1, "ops.lstm_bwd": 1,
                         "update.backward": 1, "update": 1}
    assert a.by_root == {"collect": 3, None: 1, "optimize": 3}
    # Syncs inside program spans only, by call and by innermost span.
    assert a.syncs == {"cudaStreamSynchronize": 1, "cuEventSynchronize": 1}
    assert a.syncs_by_span == {"collect.agent": 1, "update.backward": 1}
    assert progtrace.attribute(_trace(), SPANS) == a


def test_device_seconds_in_every_span_that_holds_a_launch():
    """Each device operation counts once in its innermost span and in
    every span that holds it: the launching thread's open spans, and
    those of other threads opened before them (the main thread's
    ``update.backward`` holds the autograd thread's launches), never a
    span another thread opened later (``ops.lstm_bwd`` does not hold the
    main thread's launch at 270)."""
    ev = _trace() + [_launch(270, 1, 8),
                     _x("kernel", "k8", 1080, 5, 0, correlation=8)]
    for e in ev:
        if e["cat"] == "kernel":
            e["dur"] = e["args"]["correlation"]     # c microseconds
    us = 1e-6
    a = progtrace.attribute(ev, SPANS)
    assert a.span_device_s == pytest.approx({
        ("collect", "collect"): (1 + 3) * us + 5 * us,   # k1, k3, memcpy
        ("collect", "collect.agent"): 1 * us + 5 * us,
        ("collect", "ops.lstm_step"): 1 * us,
        ("optimize", "optimize"): (5 + 6 + 7 + 8) * us,
        ("optimize", "update"): (5 + 6 + 7 + 8) * us,
        ("optimize", "update.backward"): (5 + 6 + 8) * us,
        ("optimize", "ops.lstm_bwd"): 5 * us})
    assert a.by_span["update.backward"] == 2        # k6 and k8
    assert progtrace.device_s(a.span_device_s, ["ops.lstm_bwd", "update"]
                              ) == pytest.approx((5 + 6 + 7 + 8 + 5) * us)
    assert progtrace.device_s(a.span_device_s, ["collect.agent"],
                              root="optimize") == 0


def test_device_trace_readers():
    a = progtrace.attribute(_trace(), SPANS)
    ctx = SimpleNamespace(program_ops=a, profiled_iterations=2,
                          iteration=SimpleNamespace(T=3),
                          updates_per_optimize=4)
    read = {m: REG.metric(m).read(ctx) for m in NEW[:3]}
    assert read == {"samplers.launches_per_step": 3 / 6,
                    "algos.launches_per_update": 3 / 8,
                    "device.syncs_per_iteration": 2 / 2}


ATARI = work.Geometry((4, 104, 80), 4, (32, 64, 64), (8, 4, 3), (4, 2, 1),
                      (0, 1, 1), 512, (512,), True)
RESNET = work_resnet.Geometry((4, 104, 80), 4, (16, 32, 32), 2, 256, 256,
                              (512,), True)
ITERATION = work.Iteration(T=40, B=32, batch_b=64, warmup_T=40, batch_T=80,
                           n_step=5, updates=1)


@pytest.mark.parametrize("geometry,trunk", [(ATARI, work_conv),
                                            (RESNET, work_resnet)])
def test_roofline_readers(geometry, trunk):
    """The rooflines: the least time of their work over the profiled
    iterations, over the device seconds inside their program spans under
    their roots (the collection's one-step calls, the updates' LSTM
    calls) or under any root (the trunk)."""
    ms = 1e-3
    ctx = SimpleNamespace(
        profiled_iterations=3, updates_per_optimize=1, work=work,
        geometry=geometry, iteration=ITERATION, span_device_s={
            ("collect", "ops.lstm_step"): 2 * ms,
            ("optimize", "ops.lstm_step"): 50 * ms,     # not the step's
            ("optimize", "ops.input_proj"): 3 * ms,
            ("optimize", "ops.lstm_fwd"): 4 * ms,
            ("optimize", "ops.lstm_bwd"): 5 * ms,
            ("collect", "ops.lstm_fwd"): 70 * ms,       # not the update's
            ("collect", "model.trunk"): 6 * ms,
            ("optimize", "model.trunk"): 7 * ms,
            ("optimize", "model.trunk_bwd"): 8 * ms,
            ("optimize", "update"): 90 * ms})
    read = {m: REG.metric(m).read(ctx) for m in (
        "ops.lstm_step_roofline", "ops.lstm_train_roofline",
        "models.trunk_roofline")}
    step = work.calls_bound_s(work.collect_lstm_calls(geometry, ITERATION))
    train = work.calls_bound_s(work.update_lstm_calls(geometry, ITERATION))
    calls = trunk.trunk_calls(geometry, ITERATION)
    bound = sum(work.bound_s(w) for c in calls for _, w in c)
    assert read == pytest.approx({
        "ops.lstm_step_roofline": 100 * 3 * step / (2 * ms),
        "ops.lstm_train_roofline": 100 * 3 * train / (12 * ms),
        "models.trunk_roofline": 100 * 3 * bound / (21 * ms)})
    ctx.geometry = "a trunk no work file counts"
    assert REG.metric("models.trunk_roofline").read(ctx) is None


def _rec(name, start, end, parent=None, thread=1):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           thread=thread, batch=1, traced=False)


def test_span_readers():
    ms = 1_000_000
    records = [
        _rec("collect", 0, 10 * ms),
        _rec("collect.agent", 1 * ms, 3 * ms, 0),
        _rec("collect.action_wait", 3 * ms, 4 * ms, 0),
        _rec("farm.step", 4 * ms, 8 * ms, 0),
        _rec("farm.worker", 4 * ms, 6 * ms, 3, thread=11),
        _rec("farm.worker", 5 * ms, 7 * ms, 3, thread=12),
        _rec("collect.action_wait", 8 * ms, 9 * ms, 0),
        _rec("farm.step", 9 * ms, 10 * ms, 0),
        _rec("farm.worker", 9 * ms, 9 * ms + ms // 2, 7, thread=11),
    ]
    ctx = SimpleNamespace(program_spans=records)
    read = {m: REG.metric(m).read(ctx) for m in NEW[3:]}
    # collect: 10 ms less agent 2, waits 1 + 1, farm steps 4 + 1.
    assert read["samplers.collect_self_ms"] == pytest.approx(1.0)
    assert read["samplers.action_wait_ms"] == pytest.approx(1.0)
    assert read["envs.farm_worker_ms"] == pytest.approx((2 + 0.5) / 2)
    assert read["envs.farm_barrier_ms"] == pytest.approx((2 + 0.5) / 2)


def test_silent_where_the_program_records_nothing():
    """The traced run's context of a program without the recorder: every
    reader of its spans returns None and raises nothing."""
    ctx = SimpleNamespace(spans={}, profiled_iterations=3,
                          updates_per_optimize=1, geometry=ATARI,
                          iteration=ITERATION, work=work)
    readers = NEW + ("ops.lstm_step_roofline", "ops.lstm_train_roofline",
                     "models.trunk_roofline")
    assert [REG.metric(m).read(ctx) for m in readers] == [None] * len(
        readers)


# The wrappers' metrics of the cells whose end-to-end metric is the
# env steps' rate, and of the learner's cell.
WRAPPED = {"samplers.collect_ms", "algos.update_ms", "replay.sample_ms"}
LEARNER = {"runner.env_steps_per_s", "algos.update_ms.learner",
           "replay.sample_ms.learner"}
FARM = {"samplers.action_wait_ms", "envs.farm_worker_ms",
        "envs.farm_barrier_ms", "envs.farm_step_ms"}


@pytest.mark.parametrize("cell,tiny,want", [
    ("minatar_r2d1.lanes256", TINY_MINATAR,
     WRAPPED | {"samplers.collect_self_ms"}),
    ("atari_r2d1.farm32", TINY_ATARI, LEARNER),
    ("atari_r2d1_resnet.farm32", merge(TINY_ATARI, NARROW),
     WRAPPED | FARM | {"samplers.collect_self_ms"})])
def test_tiny_cells_report_the_span_metrics(cell, tiny, want):
    """``spanned.py`` on the CPU: the traced window's metrics that need
    no card (the host clock's and the program spans'), the recorder's
    cost, and each program span inside the wrapper around it."""
    import spanned
    out = spanned.measure(cell, 2**31 + 11, 1.0, "cpu", TinyRegistry(),
                          tiny)
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["failed"] == 0 and out["cost"]["spans_per_iteration"] > 0
    # The spans inside the methods the benchmark wraps lie inside the
    # wrappers; R2D1's replay.sample span holds the wrapped call.
    n = out["nested"]
    assert {"collect", "optimize", "replay.sample"} <= set(n)
    for name, m in n.items():
        inner, outer = m["program_ms"], m["wrapper_ms"]
        if name == "replay.sample":
            inner, outer = outer, inner
        assert 0 < inner <= outer
    assert ("farm.step" in n) == cell.startswith("atari")
