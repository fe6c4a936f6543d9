"""The port's profiling helpers on the CPU: ``trace`` writes a Chrome
trace naming the profiled ops, ``time_fn`` returns the JAX helper's keys,
``device_memory_stats`` has one entry a visible card (none here), and the kernels'
build directory moves where the cache is pointed.  The recorder: off it
records nothing; spans nest by thread, close on exceptions, and carry
their batch and self time; counters by key; the spans in ``trace``'s
Chrome trace on one offset; the farm workers' records inside their
``farm.step``; the tiny R2D1 trainer's span tree."""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rlpyt_tpu_torch.ops import cuda_build
from rlpyt_tpu_torch.utils.profiling import (
    device_memory_stats,
    enable_persistent_compilation_cache,
    time_fn,
    trace,
)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(64, 64)
    with trace(str(tmp_path)):
        (a @ a).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::mm" in names


def test_time_fn_keys_and_consistency():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    out = time_fn(fn, torch.ones(8), iters=5, warmup=3)
    assert sorted(out) == ["iters_per_s", "mean_s"]
    assert len(calls) == 8
    assert out["mean_s"] > 0
    assert out["iters_per_s"] == pytest.approx(1.0 / out["mean_s"])


def test_device_memory_stats():
    """One entry a visible card; none without a card."""
    stats = device_memory_stats()
    assert sorted(stats) == [f"cuda:{d}"
                             for d in range(torch.cuda.device_count())]


def test_compilation_cache_points_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    default = cuda_build.BUILD_DIR
    assert default == cuda_build.CSRC / "build"
    enable_persistent_compilation_cache(str(tmp_path / "cache"))
    assert cuda_build.BUILD_DIR == tmp_path / "cache"


# ---------------------------------------------------------------------------
# The span-and-counter recorder.

from rlpyt_tpu_torch.utils import profiling  # noqa: E402

TINY_R2D1 = {
    "model": {"channels": (4,), "lstm_size": 16, "fc_sizes": (32,)},
    "agent": {"lstm_size": 16},
    "algo": {"batch_b": 4, "batch_T": 8, "warmup_T": 4, "n_step_return": 2,
             "replay_size": 4000, "min_steps_learn": 192,
             "replay_ratio": 4.0},
    "sampler": {"batch_T": 8, "batch_B": 8, "max_decorrelation_steps": 10},
}


def _tree(records):
    """(name, parent name) of each record."""
    return [(r.name, None if r.parent is None else records[r.parent].name)
            for r in records]


def test_off_records_nothing_and_shares_one_null_context():
    assert profiling.active() is None
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", (1, 2))
    with profiling.recording() as rec:
        pass
    with profiling.span("a"):
        profiling.count("c")
    assert rec.spans() == [] and rec.counts == {}
    assert profiling.active() is None


def test_nesting_parents_batches_and_self_time():
    with profiling.recording() as rec:
        assert profiling.active() is rec
        for _ in range(2):
            with profiling.span("collect"):
                with profiling.span("collect.agent"):
                    time.sleep(0.002)
                with profiling.span("collect.env"):
                    pass
            with profiling.span("optimize"):
                with profiling.span("update"):
                    time.sleep(0.002)
    s = rec.spans()
    assert _tree(s[:5]) == [("collect", None), ("collect.agent", "collect"),
                            ("collect.env", "collect"), ("optimize", None),
                            ("update", "optimize")]
    assert [r.batch for r in s] == [1] * 5 + [2] * 5
    for r in s:
        assert r.start <= r.end
        if r.parent is not None:
            p = s[r.parent]
            assert p.start <= r.start and r.end <= p.end
    own = profiling.self_times(s)
    assert own[0] == s[0].duration - s[1].duration - s[2].duration
    assert own[1] == s[1].duration >= 2_000_000
    assert own[3] == s[3].duration - s[4].duration


def test_self_time_counts_overlapping_children_once():
    R = profiling.SpanRecord
    recs = [R("farm.step", 0, 100, None, 1, 0, False),
            R("farm.worker", 10, 60, 0, 2, 0, False),
            R("farm.worker", 30, 80, 0, 3, 0, False)]
    assert profiling.self_times(recs) == [30, 50, 50]


def test_one_stack_per_thread():
    box = {}

    def other():
        with profiling.span("optimize"):
            box["go"].wait()
            with profiling.span("update"):
                pass

    with profiling.recording() as rec:
        box["go"] = threading.Event()
        th = threading.Thread(target=other)
        with profiling.span("collect"):
            th.start()
            with profiling.span("collect.agent"):
                box["go"].set()
                th.join()
    by = {r.name: r for r in rec.spans()}
    s = rec.spans()
    assert s[by["update"].parent].name == "optimize"
    assert by["optimize"].parent is None
    assert s[by["collect.agent"].parent].name == "collect"
    assert by["optimize"].thread != by["collect"].thread


def test_span_closed_by_an_exception():
    with profiling.recording() as rec:
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("x")
        with profiling.span("after"):
            pass
    s = rec.spans()
    assert [r.name for r in s] == ["outer", "inner", "after"]
    assert all(r.end is not None for r in s)
    assert s[2].parent is None


def test_counters_keyed_by_shape():
    with profiling.recording() as rec:
        for key in [("cluster", 45, 64, 128)] * 3 + [("barrier", 1, 64,
                                                      128)]:
            profiling.count("ops.lstm_fwd", key)
        profiling.count("ops.gather_frame_stacks", (32, 4, 7056), n=2)
    assert rec.counts["ops.lstm_fwd"] == {("cluster", 45, 64, 128): 3,
                                          ("barrier", 1, 64, 128): 1}
    assert rec.total("ops.lstm_fwd") == 4
    assert rec.total("ops.lstm_fwd", lambda k: k[1] == 1) == 1
    assert rec.total("ops.gather_frame_stacks") == 2
    assert rec.total("ops.lstm_bwd") == 0


def test_no_launch_counter_left_on_a_function():
    from rlpyt_tpu_torch.ops import frame_gather, lstm, union_gather
    for fn in (lstm.input_proj, lstm.lstm_fwd, lstm.lstm_bwd,
               lstm.lstm_step, frame_gather.gather_frame_stacks,
               union_gather.gather_union_rows,
               union_gather.gather_union_window):
        assert not [a for a in vars(fn) if a.endswith("launches")], fn


def test_trace_holds_the_spans_on_one_offset(tmp_path):
    a = torch.ones(64, 64)
    with profiling.recording() as rec:
        with trace(str(tmp_path)):
            for _ in range(3):
                with profiling.span("collect"):
                    with profiling.span("collect.agent"):
                        (a @ a).sum()
        outside = rec.spans()
    assert profiling.active() is None
    assert rec.offset_ns is not None
    (path,) = tmp_path.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("collect")]
    assert sorted(e["name"] for e in events) == \
        ["collect"] * 3 + ["collect.agent"] * 3
    events.sort(key=lambda e: e["ts"])
    for r, e in zip(sorted(outside, key=lambda r: r.start), events):
        assert r.name == e["name"]
        # Mapped onto the trace's clock, each span holds its range (to
        # the trace's rounding of a microsecond).
        assert (r.start + rec.offset_ns) / 1e3 <= e["ts"] + 1
        assert e["ts"] + e["dur"] <= (r.end + rec.offset_ns) / 1e3 + 1


def test_trace_turns_a_recorder_on(tmp_path):
    with trace(str(tmp_path)):
        assert profiling.active() is not None
        with profiling.span("optimize"):
            pass
    assert profiling.active() is None
    (path,) = tmp_path.glob("trace_*.json")
    assert "optimize" in {e.get("name") for e in json.loads(
        path.read_text())["traceEvents"]}


def test_farm_workers_on_the_masters_clock():
    from rlpyt_tpu_torch.envs.host import SharedMemVecEnv
    farm = SharedMemVecEnv(["CartPole-v1"] * 4, n_workers=2, seed=3)
    try:
        farm.reset()
        act = np.zeros((4,), np.int64)
        farm.step(act)
        with profiling.recording() as rec:
            for _ in range(3):
                farm.step(act)
        farm.step(act)
        assert farm._stamps[0] == 0
        pids = sorted(p.pid for p in farm._procs)
    finally:
        farm.close()
    s = rec.spans()
    steps = [i for i, r in enumerate(s) if r.name == "farm.step"]
    assert len(steps) == 3
    for i in steps:
        kids = [r for r in s if r.parent == i]
        assert [r.name for r in kids] == ["farm.worker"] * 2
        assert sorted(r.thread for r in kids) == pids
        for k in kids:
            assert s[i].start <= k.start <= k.end <= s[i].end


def test_r2d1_iteration_span_tree():
    """One iteration of the tiny MinAtar R2D1 trainer once it learns: one
    ``collect`` with T ``collect.agent`` (holding the trunk's forward and
    the one-step LSTM) and ``collect.env``, then ``optimize`` with
    ``replay.append`` and each update's ``replay.sample`` and ``update``,
    whose children are the loss, the backward (holding the LSTM's
    backward, then the trunk's), the step and the priorities."""
    from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import build_runner
    r, _ = build_runner("r2d1", seed=1, config_overrides=TINY_R2D1,
                        device="cpu")
    r.startup()

    def iteration():
        r.rollout_state, samples = r.collector.collect(r.rollout_state,
                                                       r.env_generator)
        r.algo.optimize(samples, r.rollout_state)

    while r.rollout_state.cum_steps + 64 < r.algo.min_steps_learn:
        iteration()
    with profiling.recording() as rec:
        iteration()
    s = rec.spans()
    roots = [r_.name for r_ in s if r_.parent is None]
    assert roots == ["collect", "optimize"]

    def children(name):
        (i,) = [k for k, r_ in enumerate(s) if r_.name == name]
        return [r_.name for r_ in s if r_.parent == i]

    T, U = 8, r.algo.updates_per_optimize
    assert children("collect") == ["collect.agent", "collect.env"] * T
    assert children("optimize") == ["replay.append"] + [
        "replay.sample", "update"] * U
    updates = [k for k, r_ in enumerate(s) if r_.name == "update"]
    for k in updates:
        assert [r_.name for r_ in s if r_.parent == k] == [
            "update.loss", "update.backward", "update.step",
            "replay.update_priorities"]
    agent = [k for k, r_ in enumerate(s) if r_.name == "collect.agent"]
    assert all([r_.name for r_ in s if r_.parent == k]
               == ["model.trunk", "ops.lstm_step"] for k in agent)
    bwd = [k for k, r_ in enumerate(s) if r_.name == "update.backward"]
    assert all([r_.name for r_ in s if r_.parent == k]
               == ["ops.lstm_bwd", "model.trunk_bwd"] for k in bwd)
    assert {r_.batch for r_ in s} == {1}


def test_host_collection_span_tree():
    """One batch of the host path over a spawned two-worker farm: T steps
    of ``collect.record``, ``collect.agent``, ``collect.action_wait``,
    ``farm.step`` (one ``farm.worker`` a worker) and
    ``collect.after_step``."""
    from rlpyt_tpu_torch.experiments.scripts.atari_dqn import build_runner
    over = {"env": {"fake": True},
            "model": {"channels": (4, 4, 4), "lstm_size": 16,
                      "fc_sizes": (32,)},
            "agent": {"lstm_size": 16},
            "algo": {"batch_b": 2, "batch_T": 8, "warmup_T": 4,
                     "n_step_return": 2, "replay_size": 2000,
                     "min_steps_learn": 48, "replay_ratio": 1.0},
            "sampler": {"batch_T": 4, "batch_B": 2, "n_workers": 2,
                        "eval_n_envs": 0}}
    r, _ = build_runner("r2d1", seed=2, config_overrides=over,
                        device="cpu")
    try:
        r.startup()
        r._collect_batch()
        with profiling.recording() as rec:
            r._collect_batch()
    finally:
        r.vec.close()
    s = rec.spans()
    assert [x.name for x in s if x.parent is None] == ["collect"]
    step = ["collect.record", "collect.agent", "collect.action_wait",
            "farm.step", "collect.after_step"]
    assert [x.name for x in s if x.parent == 0] == step * 4
    for i, x in enumerate(s):
        if x.name == "farm.step":
            assert [k.name for k in s if k.parent == i] == \
                ["farm.worker"] * 2


def test_paired_host_collection_span_tree():
    """One batch of the host path over a paired farm, two spawned halves
    of one worker each: under ``collect`` the halves' steps alternate,
    each launched (``collect.record``, ``collect.agent``) before the
    other half's step lands (``collect.action_wait``, the half's
    ``farm.step`` with its worker's ``farm.worker``,
    ``collect.after_step``), T steps of each half."""
    from rlpyt_tpu_torch.envs.host import PairedVecEnv, SharedMemVecEnv
    from rlpyt_tpu_torch.experiments.scripts.atari_dqn import (
        build_runner,
        make_env_fn,
    )
    over = {"env": {"fake": True},
            "model": {"channels": (4, 4, 4), "lstm_size": 16,
                      "fc_sizes": (32,)},
            "agent": {"lstm_size": 16},
            "algo": {"batch_b": 2, "batch_T": 8, "warmup_T": 4,
                     "n_step_return": 2, "replay_size": 2000,
                     "min_steps_learn": 48, "replay_ratio": 1.0},
            "sampler": {"batch_T": 4, "batch_B": 4, "eval_n_envs": 0}}
    r, config = build_runner("r2d1", seed=2, config_overrides=over,
                             serial=True, device="cpu")
    r.vec.close()
    fns = [make_env_fn(config["env"], 2 + b) for b in range(4)]
    r.vec = PairedVecEnv(SharedMemVecEnv(fns[:2], n_workers=1),
                         SharedMemVecEnv(fns[2:], n_workers=1))
    try:
        r.startup()
        r._collect_batch()
        with profiling.recording() as rec:
            r._collect_batch()
    finally:
        r.vec.close()
    s = rec.spans()
    assert [x.name for x in s if x.parent is None] == ["collect"]
    T = 4
    launch = ["collect.record", "collect.agent"]
    land = ["collect.action_wait", "farm.step", "collect.after_step"]
    assert [x.name for x in s if x.parent == 0] == (
        launch * 2 + land + (launch + land) * (2 * T - 2) + land)
    workers = []
    for i, x in enumerate(s):
        if x.name == "farm.step":
            (worker,) = [k for k in s if k.parent == i]
            assert worker.name == "farm.worker"
            workers.append(worker.thread)
    # The halves' farms step in turn, each by its own worker.
    assert len(set(workers)) == 2
    assert all(a != b for a, b in zip(workers, workers[1:]))


RESNET_R2D1 = {
    "env": {"fake": True},
    "model": {"channels": (4, 4, 4), "feature_size": 16, "lstm_size": 16,
              "fc_sizes": (32,)},
    "algo": {"batch_b": 2, "batch_T": 8, "warmup_T": 4, "n_step_return": 2,
             "replay_size": 2000, "min_steps_learn": 48,
             "replay_ratio": 1.0},
    "sampler": {"batch_T": 8, "batch_B": 2, "eval_n_envs": 0},
}


def _resnet_runner():
    from rlpyt_tpu_torch.experiments.scripts.atari_dqn import build_runner
    r, _ = build_runner("r2d1_resnet", seed=4, serial=True, device="cpu",
                        config_overrides=RESNET_R2D1)
    r.startup()
    while r._cum_steps + 16 < r.algo.min_steps_learn:
        r.algo.optimize(*r._collect_batch())
    return r


def _children(s, name):
    return [[x.name for x in s if x.parent == k]
            for k, r_ in enumerate(s) if r_.name == name]


def test_trunk_spans_in_a_host_collection_batch():
    """A host collection batch of ``r2d1_resnet`` opens one
    ``model.trunk`` in each ``collect.agent``, before the one-step LSTM,
    and counts each as B frames without a gradient; with the recorder off
    nothing is recorded."""
    r = _resnet_runner()
    try:
        with profiling.recording() as rec:
            r._collect_batch()
        s = rec.spans()
        r._collect_batch()
    finally:
        r.vec.close()
    assert _children(s, "collect.agent") == [
        ["model.trunk", "ops.lstm_step"]] * 8
    assert rec.counts == {"model.trunk": {(False, 2): 8}}
    assert profiling.active() is None and rec.spans() == s


def test_trunk_spans_and_counters_in_an_update():
    """One update of ``r2d1_resnet``: ``update.loss`` holds a
    ``model.trunk`` before each forward's LSTM (the online and the target
    network's burn-in, the online window, the target's window),
    ``update.backward``
    the LSTM's backward and then ``model.trunk_bwd``, on the thread that
    runs the backward and inside the backward's span; counter
    ``model.trunk`` keys the calls by (gradient on, frames)."""
    r = _resnet_runner()
    algo = r.algo
    try:
        samples, state = r._collect_batch()
        with profiling.recording() as rec:
            algo.optimize(samples, state)
    finally:
        r.vec.close()
    s = rec.spans()
    assert _children(s, "update.loss") == [
        ["model.trunk", "ops.input_proj", "ops.lstm_fwd"] * 4]
    assert _children(s, "update.backward") == [
        ["ops.lstm_bwd", "model.trunk_bwd"]]
    (k,) = [i for i, x in enumerate(s) if x.name == "model.trunk_bwd"]
    assert s[s[k].parent].start <= s[k].start <= s[k].end \
        <= s[s[k].parent].end
    b, window = algo.batch_b, algo.batch_T + algo.n_step
    assert rec.counts["model.trunk"] == {
        (False, algo.warmup_T * b): 2, (True, window * b): 1,
        (False, window * b): 1}


def test_threads_share_one_recorder_without_losing_records():
    """More threads than cores, switching as often as the interpreter
    allows: every count and every span kept, each span's parent on its
    own thread."""
    n_threads, n = 2 * (os.cpu_count() or 4), 300
    switch = sys.getswitchinterval()

    def work():
        for _ in range(n):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    profiling.count("calls", "k")

    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    s = rec.spans()
    assert rec.counts == {"calls": {"k": n_threads * n}}
    assert len(s) == 2 * n_threads * n
    for r in s:
        if r.name == "inner":
            assert s[r.parent].name == "outer"
            assert s[r.parent].thread == r.thread
        else:
            assert r.parent is None
