"""Each configuration, traffic mix and per-layer metric is a file of its
own that the harness finds by the name in BENCHMARK.json; a cell, a
traffic mix and a metric dropped into a copy of the benchmark are found
without an edit of any file that is there."""
import contextlib
import json
import shutil
import time

import pytest

import harness
from registry import ROOT, Registry
from trainer import merge

REG = Registry()


def _get(d, dotted):
    for k in dotted.split("."):
        d = d[k]
    return d


def test_every_piece_loads_by_name():
    spec = REG.spec
    for cell in spec["workloads"]:
        REG.cell(cell["name"])
        REG.config(cell["config"])
        REG.traffic(cell["traffic"])
    for m in spec["per_layer"]:
        reader = REG.metric(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])
        assert getattr(reader, "WORKLOADS", None) == m.get("workloads")
        assert callable(reader.read)


def _plain(x):
    return json.loads(json.dumps(x))


def test_configs_follow_their_source_but_for_their_cuts():
    """A configuration file holds the config as it is run: every value
    its source states (``published``) but for the keys its ``reduced``
    lists, which BENCHMARK.json lists too; and every key of the port's
    config it is built on, so that nothing of the port's own choice is
    run unseen."""
    import importlib
    for entry in REG.spec["configs"]:
        cfg = REG.config(entry["name"])
        assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
        assert cfg["source"] == entry["source"]
        run = _plain(cfg["config"])
        for dotted, value in _plain(cfg["published"]).items():
            cut = cfg["reduced"].get(dotted)
            if cut is None:
                assert _get(run, dotted) == value, dotted
            else:
                assert cut["published"] == value, dotted
                assert _get(run, dotted) == cut["run"] != value, dotted
        assert set(cfg["reduced"]) <= set(cfg["published"])
        port = cfg["port"]
        module = port["script"].replace(".scripts.", ".configs.")
        base = importlib.import_module(module).configs[port["config_key"]]
        assert _plain(merge(base, cfg["config"])) == run


@contextlib.contextmanager
def stand_in_device_ops():
    """The profiler's traces on the CPU with a stand-in device operation
    for each operator the host ran: a launch on the operator's thread at
    its start, and a kernel of its duration that the launch's
    correlation id names.  So a CPU run drives the readers of the device
    trace through the program's spans (their values mean nothing)."""
    from torch.profiler import profile
    export = profile.export_chrome_trace

    def stand_in(self, path):
        export(self, path)
        with open(path) as f:
            doc = json.load(f)
        ops = [e for e in doc["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
        for i, e in enumerate(ops, start=1 << 30):
            doc["traceEvents"] += [
                dict(e, cat="cuda_runtime", name="cudaLaunchKernel",
                     dur=0, args={"correlation": i}),
                {"ph": "X", "cat": "kernel", "name": e["name"],
                 "ts": e["ts"], "dur": max(e["dur"], 1), "pid": 0,
                 "tid": 7, "args": {"correlation": i}}]
        with open(path, "w") as f:
            json.dump(doc, f)

    profile.export_chrome_trace = stand_in
    try:
        yield
    finally:
        profile.export_chrome_trace = export


def test_new_cell_traffic_config_check_and_metric_found_without_edits(
        tmp_path, tiny_minatar):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "rr8.json").write_text(json.dumps(
        {"config_overrides": {"algo": {"replay_ratio": 8.0}}}))
    (root / "benchmark" / "metrics" / "samplers.collect_count.py"
     ).write_text(
        'UNIT = "count"\nLAYER = "samplers: collector"\n'
        'MOVES = "env_steps_per_s"\nSOURCE = "program_span"\n'
        'WORKLOADS = ["minatar_r2d1.rr8"]\n\n\n'
        'def read(ctx):\n    return len(ctx.spans.get("collect", []))\n')
    spec["workloads"].append({"name": "minatar_r2d1.rr8",
                              "config": "minatar_r2d1", "traffic": "rr8",
                              "chips": 1, "why": "a throwaway cell"})
    spec["per_layer"].append({
        "name": "samplers.collect_count", "unit": "count",
        "better": "higher", "source": "program_span",
        "layer": "samplers: collector", "moves": "env_steps_per_s",
        "workloads": ["minatar_r2d1.rr8"]})
    # A configuration of its own, whose check is a module of its own:
    # the R2D1 check's text, marking the runs it checks.
    checks = root / "benchmark" / "checks"
    (checks / "marked.py").write_text(
        (checks / "r2d1.py").read_text()
        + "\n\nCHECKED = []\n_init = Check.__init__\n\n\n"
        "def _marked(self, trainer, seed):\n"
        "    CHECKED.append(seed)\n    _init(self, trainer, seed)\n\n\n"
        "Check.__init__ = _marked\n")
    cfg = json.loads((root / "benchmark" / "configs" / "minatar_r2d1.json"
                      ).read_text())
    cfg["check"] = "marked"
    (root / "benchmark" / "configs" / "minatar_marked.json").write_text(
        json.dumps(cfg))
    spec["configs"].append(dict(spec["configs"][0], name="minatar_marked",
                                file="benchmark/configs/minatar_marked.json"))
    spec["workloads"].append({"name": "minatar_marked.rr8",
                              "config": "minatar_marked", "traffic": "rr8",
                              "chips": 1, "why": "a throwaway cell"})
    # The new cells report the env steps' rate, which lists its cells.
    rate = next(m for m in spec["end_to_end"]
                if m["name"] == "env_steps_per_s")
    rate["workloads"] += ["minatar_r2d1.rr8", "minatar_marked.rr8"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    from conftest import TinyRegistry
    reg = TinyRegistry(root)
    assert reg.traffic("rr8")["config_overrides"]["algo"][
        "replay_ratio"] == 8.0
    names = [m["name"] for m in reg.per_layer("minatar_r2d1.rr8")]
    assert "samplers.collect_count" in names
    assert "samplers.collect_count" not in [
        m["name"] for m in reg.per_layer("minatar_r2d1.lanes256")]
    over = merge(tiny_minatar, {"algo": {"replay_ratio": 8.0}})
    over["algo"].pop("replay_ratio")
    with stand_in_device_ops():
        res = harness.run_cell("minatar_r2d1.rr8", 5, 0.5, True,
                               time.perf_counter(), "cpu", reg, over)
    assert res["metrics"]["samplers.collect_count"]["value"] >= 1
    # Every reader listed for the MinAtar cells finds something to read.
    assert set(res["metrics"]) == {
        m["name"] for m in reg.per_layer("minatar_r2d1.rr8")}
    assert res["correct"]

    prep = harness.Prepared(reg, "minatar_marked.rr8", 6, "cpu", over)
    prep.release()
    assert prep.family.CHECKED == [6]
    assert prep.config_file["check"] == "marked"


EVERY_CELL = ["samplers.collect_ms", "samplers.launches_per_step",
              "samplers.collect_self_ms", "algos.update_ms",
              "algos.launches_per_update", "replay.sample_ms",
              "ops.lstm_step_roofline", "ops.lstm_train_roofline",
              "device.idle_pct", "device.syncs_per_iteration",
              "device.mfu_pct"]
FARM = ["samplers.action_wait_ms", "envs.farm_step_ms",
        "envs.farm_worker_ms", "envs.farm_barrier_ms",
        "models.trunk_roofline"]
# The cell whose end-to-end metric is the learner's time: the learner's
# metrics, and the iteration's rate as a per-layer metric.
LEARNER = ["runner.env_steps_per_s", "algos.update_ms.learner",
           "algos.launches_per_update.learner", "replay.sample_ms.learner",
           "models.trunk_roofline.learner", "ops.lstm_train_roofline.learner",
           "device.mfu_pct.learner"]


@pytest.mark.parametrize("name,end_to_end,per_layer", [
    ("minatar_r2d1.lanes256", ["env_steps_per_s", "setup_s"], EVERY_CELL),
    ("atari_r2d1.farm32", ["learner_update_ms", "setup_s"], LEARNER),
    ("atari_r2d1_resnet.farm32", ["env_steps_per_s", "setup_s"],
     EVERY_CELL + FARM)])
def test_cell_reports_its_metrics(name, end_to_end, per_layer):
    assert [m["name"] for m in REG.end_to_end(name)] == end_to_end
    reported = [m["name"] for m in REG.per_layer(name)]
    assert sorted(reported) == sorted(per_layer)
    # The cells on the host farm that report the farm's metrics, as the
    # farm step's metric lists them.
    farm_cells = next(m for m in REG.spec["per_layer"]
                      if m["name"] == "envs.farm_step_ms")["workloads"]
    assert ("envs.farm_step_ms" in reported) == (name in farm_cells)


def test_listed_cells_report_what_their_metrics_move():
    """A per-layer metric's cells, listed or not, each report the
    end-to-end metric it moves; every cell reports setup_s, another
    end-to-end metric and a per-layer metric."""
    cells = [w["name"] for w in REG.spec["workloads"]]
    for m in REG.spec["per_layer"]:
        for cell in m.get("workloads", []):
            assert m["moves"] in [e["name"] for e in REG.end_to_end(cell)]
    for cell in cells:
        e2e = [e["name"] for e in REG.end_to_end(cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert REG.per_layer(cell)
