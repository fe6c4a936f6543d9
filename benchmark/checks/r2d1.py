"""The check of an R2D1 trainer, and the shapes of its work.

Set-up drives the trainer from the seed into its first learning
iteration through the window's own calls, and ``Capture`` records what
the reference needs and what it judges, on the host:

- the collection's forward steps of that iteration (the agent's inputs
  and its Q-values and next recurrent state), taken while the online
  network still holds the seed's weights;
- the first three updates: each window batch the replay drew, the loss,
  the priorities written back, the first gradient as Adam holds it after
  one step (its first moment over 1 - beta1), and the parameters after
  the third step; and the first update's Q-values of the online network
  over the window after the burn-in, as the loss took them.

Once the window has closed, ``Check.compare`` reads six numbers, each
held to a limit of the configuration's.  ``VARIANTS`` name the
reference's other forms, which ``calibrate.py`` reads to set the limits:
the controls, a planted fault and a float64 witness.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, NamedTuple

import torch

import work
from devtrace import Patches
from reference import r2d1 as ref
from trainer import make_weights

N_UPDATES = 3

# The reference's forms: (TF32 in the updates, TF32 in the collection,
# half of the batch in the loss, dtype).
VARIANTS = {
    "reference": (False, False, False, torch.float32),
    # The controls: the step below float32 (TF32 products), everywhere
    # or in the learner alone.
    "control": (True, True, False, torch.float32),
    "control_learner": (True, False, False, torch.float32),
    # A planted fault: half of the batch left out, the loss averaged
    # over the rest.
    "half_batch": (False, False, True, torch.float32),
    # The witness of the look at the tail: float64 throughout.
    "fp64": (False, False, False, torch.float64),
}


class Readings(NamedTuple):
    """One side's results of the checked steps."""
    losses: List[float]
    priorities: List[torch.Tensor]
    first_grad: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]          # after the third step
    collect: List[tuple]                     # (q, h, c) a step
    window_q: torch.Tensor                   # the first update's window
    margins: tuple = ()                      # the reference's, a step


def _host(x):
    return x.detach().to("cpu", copy=True)


class Capture(Patches):
    """Records the collection of the first learning iteration and the
    first ``N_UPDATES`` updates (over as many iterations as that takes),
    by wrapping the agent's ``step``, the algorithm's ``update`` and the
    replay's ``update_priorities`` on the objects, for those iterations
    only."""

    def __init__(self, trainer):
        super().__init__()
        self.trainer = trainer
        self.steps_in, self.steps_out = [], []
        self.batches, self.losses, self.priorities = [], [], []
        self.first_grad, self.params = {}, {}
        self.window_q, self._in_first = None, False

    def __enter__(self):
        agent, algo = self.trainer.agent, self.trainer.algo
        step, update = agent.step, algo.update
        write = algo.replay.update_priorities
        forward = algo.model.forward
        names = [n for n, _ in algo.model.named_parameters()]

        def model_forward(*args, **kwargs):
            out = forward(*args, **kwargs)
            # The first update's one call with a gradient: the window.
            if (self._in_first and torch.is_grad_enabled()
                    and self.window_q is None):
                self.window_q = _host(out[0])
            return out

        def agent_step(obs, prev_a, prev_r, carry, *args, **kwargs):
            out, nxt = step(obs, prev_a, prev_r, carry, *args, **kwargs)
            if self.batches:     # the weights have moved
                return out, nxt
            self.steps_in.append(tuple(_host(x) for x in (
                obs, prev_a, prev_r, carry[0], carry[1])))
            self.steps_out.append(tuple(_host(x) for x in (
                out.agent_info["q"], nxt[0], nxt[1])))
            return out, nxt

        def algo_update(batch):
            k = len(self.batches)
            if k < N_UPDATES:
                self.batches.append(_batch(batch))
            self._in_first = k == 0
            try:
                info = update(batch)
            finally:
                self._in_first = False
            if k < N_UPDATES:
                self.losses.append(float(info.loss))
            if k == 0:
                inner = algo.optimizer.inner
                beta1 = inner.param_groups[0]["betas"][0]
                # A step that never reached Adam left no moment: zero.
                self.first_grad = {
                    n: _host(inner.state[p].get("exp_avg",
                                                torch.zeros_like(p)))
                    / (1 - beta1)
                    for n, p in zip(names, algo.model.parameters())}
            if k == N_UPDATES - 1:
                self.params = {n: _host(p) for n, p in
                               algo.model.named_parameters()}
            return info

        def write_priorities(slots, priorities):
            if len(self.priorities) < N_UPDATES:
                self.priorities.append(_host(priorities))
            return write(slots, priorities)

        self.put(agent, "step", agent_step)
        self.put(algo, "update", algo_update)
        self.put(algo.model, "forward", model_forward)
        self.put(algo.replay, "update_priorities", write_priorities)
        return self

    def __exit__(self, *exc):
        self.restore()

    @property
    def complete(self) -> bool:
        return len(self.batches) >= N_UPDATES

    def readings(self) -> Readings:
        if len(self.batches) < N_UPDATES:
            raise RuntimeError(
                f"the checked iteration made {len(self.batches)} updates; "
                f"the check needs {N_UPDATES}")
        return Readings(self.losses, self.priorities, self.first_grad,
                        self.params, self.steps_out, self.window_q)


def _batch(b) -> ref.Batch:
    """The replay's SequenceSamples as the reference's Batch, on the
    host."""
    h, c = b.init_rnn_state
    return ref.Batch(*(_host(x) for x in (
        b.observation, b.action, b.reward, b.done, b.prev_action,
        b.prev_reward, h, c, b.is_weights)))


def compare(prog: Readings, refr: Readings, P0: Dict[str, torch.Tensor],
            detail: bool = False) -> Dict[str, float]:
    """The six numbers, ``prog`` against ``refr``: ``loss``, the widest
    relative gap of the three steps' losses; ``grad``, the worst leaf's gap
    of the first gradient's norm; ``change``, the worst leaf's gap of the
    norm of the parameters' change after three steps, leaving out leaves
    whose reference gradient is under a thousandth of the median leaf's
    (they move by round-off alone); ``priority``, the widest gap of the
    written priorities over the largest; ``collect``, the widest gap of
    the collection's Q-values and recurrent state over the largest;
    ``window_q``, the widest gap of the first update's online Q-values
    over the window over the largest.  ``detail``: also where each worst
    gap lies (the step, the leaf), and the median leaf's change gap."""
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog.losses, refr.losses)]
    g_ref = ref.leaf_norms(refr.first_grad)
    g_prog = ref.leaf_norms(prog.first_grad)
    floor = 1e-3 * ref.median(list(g_ref.values()))
    moved = [k for k, v in g_ref.items() if v >= floor]
    c_prog = ref.leaf_norms({k: prog.params[k] - P0[k] for k in P0})
    c_ref = ref.leaf_norms({k: refr.params[k] - P0[k] for k in P0})
    pri = [ref.rel_gap(a, b)
           for a, b in zip(prog.priorities, refr.priorities)]
    collect = max(ref.rel_gap(a, b) for s, r in zip(prog.collect,
                                                    refr.collect)
                  for a, b in zip(s, r))
    out = {"loss": max(gaps),
           "grad": ref.worst_leaf_gap(g_prog, g_ref),
           "change": ref.worst_leaf_gap(c_prog, c_ref, moved),
           "priority": max(pri), "collect": collect,
           "window_q": ref.rel_gap(prog.window_q, refr.window_q)}
    if detail:
        out["where"] = {
            "loss_step": gaps.index(max(gaps)) + 1,
            "grad_leaf": ref.worst_leaf(g_prog, g_ref),
            "change_leaf": ref.worst_leaf(c_prog, c_ref, moved),
            "priority_step": pri.index(max(pri)) + 1,
            "change_median": ref.median([
                abs(c_prog[k] - c_ref[k]) / max(c_ref[k], 1e-30)
                for k in moved])}
    return out


class Check:
    """The check of one run: the capture during set-up, then the
    reference's readings and the numbers once the window has closed.
    It keeps what it needs of the trainer, which is freed before the
    reference runs."""

    def __init__(self, trainer, seed: int):
        self.seed = seed
        self.spec = ref.Spec.from_config(trainer.config)
        self.shapes = {k: tuple(v.shape)
                       for k, v in trainer.agent.model.named_parameters()}
        self.batch_b = trainer.config["algo"]["batch_b"]
        self.capture = Capture(trainer)

    @property
    def complete(self) -> bool:
        return self.capture.complete

    def initial(self, dev) -> dict:
        """The seed's weights, made anew, on the host."""
        return {k: v.cpu() for k, v in
                make_weights(self.shapes, self.seed, dev).items()}

    def program(self) -> Readings:
        return self.capture.readings()

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

    def compare(self, prog: Readings, refr: Readings, dev,
                detail: bool = False) -> Dict[str, float]:
        return compare(prog, refr, self.initial(dev), detail)


def work_shapes(trainer) -> SimpleNamespace:
    """What the metric readers count the work from: the model's
    ``geometry`` and one ``iteration`` of the traffic."""
    spaces = trainer.agent.env_spaces
    geometry = work.Geometry.from_config(
        trainer.config["model"], tuple(spaces.observation.shape),
        int(spaces.action.n))
    iteration = work.Iteration.from_config(
        trainer.config, trainer.algo.updates_per_optimize)
    return SimpleNamespace(geometry=geometry, iteration=iteration)
