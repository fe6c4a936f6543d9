"""The system under test: a trainer of the port, built through the
configuration's training script, driven one iteration at a time.

An iteration is what the runner's own loop runs: on the device path
(``MinibatchRl``) ``collector.collect`` then ``algo.optimize``; on the
host farm (``HostMinibatchRl``) ``_collect_batch`` then
``algo.optimize``.  The weights are made here from the seed, on the
device, in one draw, and loaded into the online and the target network
before the first step, so that the reference can make the same ones.
"""
from __future__ import annotations

import copy
import importlib
import math

import torch


def lstm_fan_in(name: str, shape) -> int:
    """The fan-in of a weight: the LSTM keeps [in, 4H] matrices, every
    other layer [out, in, ...]."""
    if name.endswith(("lstm.wx", "lstm.wh")):
        return shape[0]
    return math.prod(shape[1:])


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Parameters named and shaped as ``shapes`` (name -> shape), from one
    normal draw of a generator seeded with ``seed`` on ``device``: weights
    at a standard deviation of 1/sqrt(fan-in), biases at 0.1."""
    g = torch.Generator(device=device).manual_seed(seed)
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    flat = torch.randn((sum(sizes),), generator=g, device=device)
    out = {}
    for name, piece in zip(names, torch.split(flat, sizes)):
        shape = tuple(shapes[name])
        scale = (1.0 / math.sqrt(lstm_fan_in(name, shape))
                 if len(shape) > 1 else 0.1)
        out[name] = (piece * scale).reshape(shape)
    return out


def merge(base: dict, over: dict) -> dict:
    """``over`` deep-merged into a copy of ``base``."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


def program_seed(seed: int) -> int:
    """The seed handed to the port: every derived seed (seed + lane,
    seed + 10,000 + lane) stays inside 32 bits for numpy's generators."""
    return seed % (1 << 30)


class Trainer:
    """The cell's trainer, not yet started.  ``config_file``: the
    configuration file's contents; ``traffic``: the traffic file's;
    ``overrides``: further config changes (the CPU tests' small sizes)."""

    def __init__(self, config_file: dict, traffic: dict, seed: int,
                 device: str = "cuda", overrides: dict | None = None):
        self.seed = seed
        self.device = torch.device(device)
        port = config_file["port"]
        self.config = merge(config_file["config"],
                            traffic.get("config_overrides", {}))
        if overrides:
            self.config = merge(self.config, overrides)
        script = importlib.import_module(port["script"])
        self.runner, _ = script.build_runner(
            port["config_key"], seed=program_seed(seed),
            config_overrides=self.config, device=device,
            **port.get("build_kwargs", {}))
        self.host = hasattr(self.runner, "_collect_batch")

    # ------------------------------------------------------------------

    @property
    def algo(self):
        return self.runner.algo

    @property
    def agent(self):
        return self.runner.agent

    @property
    def steps_per_iteration(self) -> int:
        return self.runner.batch_spec.size

    def param_shapes(self) -> dict:
        return {k: tuple(v.shape)
                for k, v in self.agent.model.named_parameters()}

    def startup(self):
        """The runner's start-up (model, replay, farm or decorrelation),
        then the benchmark's weights in both networks."""
        self.runner.startup()
        weights = make_weights(self.param_shapes(), self.seed, self.device)
        with torch.no_grad():
            for model in (self.agent.model, self.algo.target_model):
                for name, p in model.named_parameters():
                    p.copy_(weights[name])
        del weights

    def learning(self) -> bool:
        """Whether the next iteration's optimize updates."""
        cum = self._cum_steps() + self.steps_per_iteration
        return cum >= getattr(self.algo, "min_steps_learn", 0)

    def _cum_steps(self) -> int:
        if self.host:
            return self.runner._cum_steps
        return self.runner.rollout_state.cum_steps

    def iteration(self, learner=None):
        """Collect one [T, B] batch, then optimize, between ``learner``'s
        ``start`` and ``stop`` where it is given; the optimize's mean
        OptInfo."""
        r = self.runner
        if self.host:
            samples, state = r._collect_batch()
        else:
            r.rollout_state, samples = r.collector.collect(r.rollout_state,
                                                           r.env_generator)
            state = r.rollout_state
        if learner is None:
            return self.algo.optimize(samples, state)
        learner.start()
        info = self.algo.optimize(samples, state)
        learner.stop()
        return info

    def close(self):
        """Stop the farm's workers (host path)."""
        if self.host:
            self.runner.vec.close()
