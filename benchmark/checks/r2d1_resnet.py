"""The check of an R2D1 trainer on IMPALA's deep residual trunk, and the
shapes of its work.

The R2D1 check (``r2d1.py``: the capture during set-up, the six numbers
and their comparison, the reference's forms) bound to the reference of
this model (``reference/r2d1_resnet.py``), and the work counted over the
trunk's geometry (``work_resnet.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import work
import work_resnet
from checks import r2d1 as base
from reference import r2d1_resnet as ref
from trainer import make_weights

Capture, Readings, VARIANTS, compare = (base.Capture, base.Readings,
                                        base.VARIANTS, base.compare)
_host = base._host


class Check(base.Check):
    """``r2d1.py``'s check with this model's reference."""

    def __init__(self, trainer, seed: int):
        super().__init__(trainer, seed)
        self.spec = ref.Spec.from_config(trainer.config)

    def reference(self, dev, variant: str = "reference") -> Readings:
        """The reference's readings on the captured inputs, from the
        seed's weights made anew, in the form ``VARIANTS[variant]``."""
        tf32_learn, tf32_collect, half, dtype = VARIANTS[variant]
        rows = slice(0, self.batch_b // 2) if half else slice(None)
        P0 = make_weights(self.shapes, self.seed, dev)
        batches = [ref.Batch(*(x.to(dev) for x in b))
                   for b in self.capture.batches]
        steps = ref.train_steps(P0, self.spec, batches, tf32=tf32_learn,
                                rows=rows, dtype=dtype)
        inputs = [tuple(x.to(dev) for x in s)
                  for s in self.capture.steps_in]
        collect = ref.one_steps(P0, self.spec, inputs, tf32=tf32_collect,
                                dtype=dtype)
        host = lambda d: {k: _host(v) for k, v in d.items()}  # noqa: E731
        return Readings(steps.losses, [_host(p) for p in steps.priorities],
                        host(steps.first_grad), host(steps.params),
                        [tuple(_host(x) for x in s) for s in collect],
                        _host(steps.window_q[0]), tuple(steps.margins))


def work_shapes(trainer) -> SimpleNamespace:
    """What the metric readers count the work from: the model's
    ``geometry`` (the trunk's) and one ``iteration`` of the traffic."""
    spaces = trainer.agent.env_spaces
    geometry = work_resnet.Geometry.from_config(
        trainer.config["model"], tuple(spaces.observation.shape),
        int(spaces.action.n))
    iteration = work.Iteration.from_config(
        trainer.config, trainer.algo.updates_per_optimize)
    return SimpleNamespace(geometry=geometry, iteration=iteration)
