"""The port's TabularLogger extras against the JAX logger, on the CPU:
TensorBoard events (read back with tensorboard's EventAccumulator),
``record_tabular_misc_stat``, and that the port imports where
``torch.utils.tensorboard`` cannot be imported."""
import os
import subprocess
import sys

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from rlpyt_tpu.utils.logging import TabularLogger as JaxTabularLogger
from rlpyt_tpu_torch.utils.logging import TabularLogger, logger_context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = [{"Iteration": 4, "CumSteps": 512, "loss": 0.25, "ReturnAverage": 9.5,
         "Note": "text"},
        {"Iteration": 8, "CumSteps": 1024, "loss": 0.125,
         "ReturnAverage": 12.0, "Note": "text"}]


def write_rows(logger):
    for row in ROWS:
        for k, v in row.items():
            logger.record_tabular(k, v)
        logger.dump_tabular(print_fn=None)
    logger.close()


def scalars(log_dir):
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_summary_writer_events_match_jax_logger(tmp_path):
    """Every numeric key of each row lands at step CumSteps, as the JAX
    logger writes it; text keys are left out."""
    write_rows(TabularLogger(str(tmp_path / "port"),
                             use_summary_writer=True))
    write_rows(JaxTabularLogger(str(tmp_path / "jax"),
                                use_summary_writer=True))
    got, want = scalars(tmp_path / "port"), scalars(tmp_path / "jax")
    assert got == want
    assert sorted(got) == ["CumSteps", "Iteration", "ReturnAverage", "loss"]
    assert got["loss"] == [(512, 0.25), (1024, 0.125)]
    # The CSV is written as before.
    assert (tmp_path / "port" / "progress.csv").read_text().count("\n") == 3


def test_logger_context_summary_writer(tmp_path):
    with logger_context(str(tmp_path), 3, "run", config={"a": 1},
                        use_summary_writer=True) as logger:
        logger.record_tabular("CumSteps", 7)
        logger.record_tabular("x", 1.5)
        logger.dump_tabular(print_fn=None)
    assert scalars(tmp_path / "run_3")["x"] == [(7, 1.5)]


def test_no_writer_without_log_dir_or_flag(tmp_path):
    assert TabularLogger(None, use_summary_writer=True)._tb is None
    TabularLogger(str(tmp_path)).close()
    assert not list(tmp_path.glob("events.*"))


@pytest.mark.parametrize("values", [[3.0, -1.5, 2.25, 8.0], [4], []])
def test_record_tabular_misc_stat_matches_jax(values):
    port, jax_logger = TabularLogger(None), JaxTabularLogger(None)
    port.record_tabular_misc_stat("Return", values)
    jax_logger.record_tabular_misc_stat("Return", np.asarray(values))
    assert list(port._tabular) == list(jax_logger._tabular) == [
        "ReturnAverage", "ReturnStd", "ReturnMin", "ReturnMax"]
    np.testing.assert_array_equal(list(port._tabular.values()),
                                  list(jax_logger._tabular.values()))


def test_port_imports_without_tensorboard(tmp_path):
    """With ``torch.utils.tensorboard`` blocked, the port's modules import
    and log; only asking for a writer fails."""
    code = (
        "import sys\n"
        "sys.modules['torch.utils.tensorboard'] = None\n"
        "from rlpyt_tpu_torch.utils.logging import TabularLogger\n"
        "import rlpyt_tpu_torch.runners.async_rl\n"
        "import rlpyt_tpu_torch.utils.profiling\n"
        "import rlpyt_tpu_torch.utils.checkpoint\n"
        "from rlpyt_tpu_torch.examples import example_1, example_5\n"
        f"lg = TabularLogger({str(tmp_path)!r})\n"
        "lg.record_tabular('CumSteps', 1); lg.dump_tabular(print_fn=None)\n"
        "try:\n"
        f"    TabularLogger({str(tmp_path)!r}, use_summary_writer=True)\n"
        "except ImportError:\n"
        "    print('writer refused')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "writer refused" in out.stdout
