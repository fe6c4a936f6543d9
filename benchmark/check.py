"""What decides ``correct``: the trainer's first steps against a plain
reference, by the check of the configuration's family.

A configuration file names its check (``"check": "r2d1"``), and the
registry loads ``benchmark/checks/<check>.py`` by that name.  Such a
module gives

- ``Check(trainer, seed)``: made before the first learning iteration;
  ``capture`` is a context manager under which set-up drives the trainer
  until ``complete``; once the window has closed and the trainer is
  freed, ``reference(dev, variant)`` gives the reference's readings
  (``variant`` one of ``VARIANTS``), ``program()`` the program's, and
  ``compare(prog, refr, dev)`` the numbers, each held to the limit of
  the same name in the configuration file;
- ``VARIANTS``: the reference's forms (``"reference"``, the controls and
  faults that set the limits' upper readings);
- ``work_shapes(trainer)``: what the metric readers count the work from.
"""
from __future__ import annotations

from typing import Dict


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit."""
    return all(n == n and n <= limits[k] for k, n in numbers.items())
