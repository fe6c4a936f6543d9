"""The device collector's CUDA graph (``samplers/rollout.py:_StepGraph``):
each collection step is the agent's step, eagerly, then one replay of a
graph of everything after it.

On the CPU (tier 1):
- the rule that engages the graph, on stand-in envs and generators;
- a CPU collection counts its steps as eager and replays nothing;
- the graphed path with the graph's capture and replay swapped for
  eager runs of what they capture (warm-ups, static carry, step index,
  copies in and out, the generator's save and restore) equals the eager
  collection bit for bit over three batches, under both reset rules;
- the list of device env classes below is every one in ``envs/``.

On the card (``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_collector_graph.py``): the graphed collection equals
the eager one bit for bit (samples, state, trajectory stats, the
generator's state) over three batches for MinAtar Breakout with R2D1
and with a feedforward DQN agent, under both reset rules; a batch's
returned tensors outlive the next batch; ``reset_traj_stats`` between
batches takes effect; every device env class captures and matches
eager over one batch.  The file imports no JAX, so it runs where JAX
is not installed.
"""
import importlib
import inspect
from types import SimpleNamespace

import pytest
import torch
from _torch_graph_standin import eager_graphs

from rlpyt_tpu_torch.agents.base import AgentStep, BaseAgent
from rlpyt_tpu_torch.agents.dqn import DqnAgent, R2d1Agent
from rlpyt_tpu_torch.envs.base import Env
from rlpyt_tpu_torch.envs.classic import Acrobot, CartPole, \
    ContinuousMountainCar, DictObsCartPole, MountainCar, Pendulum
from rlpyt_tpu_torch.envs.locomotion import Cheetah2D, Hopper2D
from rlpyt_tpu_torch.envs.minatar import Asterix, Breakout, Freeway, \
    Seaquest, SpaceInvaders
from rlpyt_tpu_torch.envs.reacher import Reacher
from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
from rlpyt_tpu_torch.models.dqn import AtariDqnModel, AtariR2d1Model
from rlpyt_tpu_torch.samplers import rollout
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector
from rlpyt_tpu_torch.struct import tree_leaves, tree_map
from rlpyt_tpu_torch.utils import profiling

DEVICE_ENVS = (Breakout, SpaceInvaders, Asterix, Freeway, Seaquest,
               CartPole, DictObsCartPole, Pendulum, Acrobot, MountainCar,
               ContinuousMountainCar, Hopper2D, Cheetah2D, Reacher,
               SyntheticAtariEnv)
ENV_MODULES = ("minatar", "classic", "locomotion", "reacher",
               "synthetic_atari")
MINATAR_NET = dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                   paddings=(0,), fc_sizes=(128,), obs_divisor=1.0)
SEED = 2718281828


# -- stand-ins and helpers ----------------------------------------------


class RandomAgent(BaseAgent):
    """Uniform actions from the collection's generator; no model, no
    carry: what a device env's capture needs from an agent."""

    def initialize(self, env_spaces):
        self.env_spaces = env_spaces

    def step(self, observation, prev_action, prev_reward, carry,
             cum_steps, generator, is_eval=False):
        n = prev_reward.shape[0]
        return AgentStep(self.env_spaces.action.sample(generator, (n,)),
                         {}), carry


def minatar_agent(kind: str, device, env) -> BaseAgent:
    """An R2D1 agent (LSTM 128) or a feedforward DQN agent at MinAtar's
    network, weights from a fixed seed."""
    torch.manual_seed(0)
    if kind == "r2d1":
        agent = R2d1Agent(ModelCls=AtariR2d1Model, lstm_size=128,
                          model_kwargs=dict(MINATAR_NET, lstm_size=128,
                                            dueling=True),
                          eps_steps=1000, eps_final=0.1, device=device)
    else:
        agent = DqnAgent(ModelCls=AtariDqnModel, model_kwargs=MINATAR_NET,
                         eps_steps=1000, eps_final=0.1, device=device)
    agent.initialize(env.spaces)
    return agent


class Run:
    """One collector and its generator, from ``SEED``."""

    def __init__(self, env, agent, spec: BatchSpec, mid_batch_reset: bool):
        self.collector = Collector(env, agent, spec, discount=0.99,
                                   mid_batch_reset=mid_batch_reset)
        self.gen = torch.Generator(device=env.device).manual_seed(SEED)
        self.state = self.collector.init_state(self.gen)

    def batch(self):
        self.state, samples = self.collector.collect(self.state, self.gen)
        return self.state, samples


def assert_trees_equal(a, b, what: str):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(x, y), (what, i)


def assert_same_batch(graphed, eager, g_run, e_run, what: str):
    (gs, gb), (es, eb) = graphed, eager
    assert_trees_equal(gb, eb, f"{what}: samples")
    assert gs.cum_steps == es.cum_steps, what
    assert_trees_equal(gs._replace(cum_steps=None),
                       es._replace(cum_steps=None), f"{what}: state")
    assert_trees_equal(gs.traj_stats, es.traj_stats, f"{what}: traj stats")
    assert torch.equal(g_run.gen.get_state(), e_run.gen.get_state()), \
        f"{what}: generator"


def collect_both(make_run, n_batches: int, reset_after=None):
    """``n_batches`` batches of a graphed run and of an eager run (the
    engagement rule patched to say no), compared batch by batch;
    ``reset_after``: the batch after which both reset their trajectory
    stats.  Returns the graphed run's batches, each cloned when it was
    returned, and the batches as returned."""
    g_run = make_run()
    e_run = make_run()
    kept, returned = [], []
    for k in range(n_batches):
        graphed = g_run.batch()
        returned.append(graphed)
        kept.append(tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            graphed))
        capturable = rollout.graph_capturable
        rollout.graph_capturable = lambda env, gen: False
        try:
            eager = e_run.batch()
        finally:
            rollout.graph_capturable = capturable
        assert_same_batch(graphed, eager, g_run, e_run, f"batch {k}")
        if k == reset_after:
            for run in (g_run, e_run):
                run.state = run.collector.reset_traj_stats(run.state)
    return g_run, kept, returned


@pytest.fixture
def on_cpu_graph(monkeypatch):
    """The graphed path on the CPU: the engagement rule says yes, and
    the graph's capture (its warm-up, then a stand-in for the graph) and
    each replay are eager runs of ``_body`` (``eager_graphs``)."""
    monkeypatch.setattr(rollout, "graph_capturable", lambda env, gen: True)
    eager_graphs(monkeypatch)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- CPU ------------------------------------------------------------------


@pytest.mark.parametrize("env_device, gen_device, engaged", [
    ("cpu", "cpu", False),            # a CPU env
    ("cuda:0", "cpu", False),         # a CPU generator, a card's env
    ("cpu", "cuda:0", False),         # the generator on a card alone
    ("cuda:0", "cuda:1", False),      # two cards
    ("cuda:0", "cuda:0", True),
    ("cuda:1", "cuda:1", True),       # both on a card other than the first
])
def test_engagement_rule(env_device, gen_device, engaged):
    env = Env.__new__(Env)
    env.device = torch.device(env_device)
    gen = SimpleNamespace(device=torch.device(gen_device))
    assert rollout.graph_capturable(env, gen) is engaged


@pytest.mark.parametrize("mid_batch_reset", [True, False])
def test_cpu_collect_steps_eagerly(mid_batch_reset):
    env = Breakout(device="cpu")
    agent = RandomAgent(device="cpu")
    agent.initialize(env.spaces)
    run = Run(env, agent, BatchSpec(6, 4), mid_batch_reset)
    with profiling.recording() as rec:
        run.batch()
        run.batch()
    assert rec.total("collect.eager_steps") == 12
    assert "collect.graph_replays" not in rec.counts
    assert run.collector._graph is None
    names = {r.name for r in rec.spans()}
    assert "collect.env" in names and "collect.graph" not in names


@pytest.mark.parametrize("kind", ["r2d1", "dqn"])
@pytest.mark.parametrize("mid_batch_reset", [True, False])
def test_graph_path_equals_eager_on_the_cpu(on_cpu_graph, kind,
                                            mid_batch_reset):
    """The graphed path's bookkeeping, its capture and replay run
    eagerly: three batches equal the eager path's bit for bit, a batch's
    returned tensors outlive the next batch, and a ``reset_traj_stats``
    between batches takes effect."""
    env = Breakout(device="cpu")
    agent = minatar_agent(kind, "cpu", env)

    def make_run():
        return Run(env, agent, BatchSpec(8, 6), mid_batch_reset)

    with profiling.recording() as rec:
        g_run, kept, returned = collect_both(make_run, 3, reset_after=1)
    assert rec.total("collect.graph_replays") == 24
    assert rec.total("collect.eager_steps") == 24   # the eager twin's
    assert sum(r.name == "collect.capture" for r in rec.spans()) == 1
    for k, (a, b) in enumerate(zip(kept, returned)):
        assert_trees_equal(a[1], b[1], f"batch {k} samples kept")
        assert_trees_equal(a[0]._replace(cum_steps=None),
                           b[0]._replace(cum_steps=None),
                           f"batch {k} state kept")
    # Episodes ended before the reset, so the reset changed the stats.
    assert int(returned[1][0].traj_stats.completed) > 0


def test_graph_is_captured_again_for_another_generator(on_cpu_graph):
    env = Breakout(device="cpu")
    agent = RandomAgent(device="cpu")
    agent.initialize(env.spaces)
    run = Run(env, agent, BatchSpec(4, 3), True)
    run.batch()
    first = run.collector._graph
    run.batch()
    assert run.collector._graph is first
    run.gen = torch.Generator().manual_seed(1)
    run.batch()
    assert run.collector._graph is not first
    assert run.collector._graph.generator is run.gen


def test_device_env_list_is_complete():
    """``DEVICE_ENVS`` holds every concrete env class of ``envs/`` that
    steps on tensors, so the card's test below captures each."""
    found = set()
    for name in ENV_MODULES:
        module = importlib.import_module(f"rlpyt_tpu_torch.envs.{name}")
        for _, obj in inspect.getmembers(module, inspect.isclass):
            if (issubclass(obj, Env) and obj.__module__ == module.__name__
                    and obj.__name__ not in ("MinAtarEnv", "PlanarChainEnv")):
                found.add(obj)
    assert found == set(DEVICE_ENVS)


# -- the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["r2d1", "dqn"])
@pytest.mark.parametrize("mid_batch_reset", [True, False])
def test_graphed_collect_equals_eager(card, kind, mid_batch_reset):
    """Three batches of MinAtar Breakout, B = 32: samples, state,
    trajectory stats and the generator's state equal bit for bit; the
    graph replays every step."""
    env = Breakout(device=card)
    agent = minatar_agent(kind, card, env)

    def make_run():
        return Run(env, agent, BatchSpec(16, 32), mid_batch_reset)

    assert rollout.graph_capturable(env, make_run().gen)
    with profiling.recording() as rec:
        collect_both(make_run, 3)
    assert rec.total("collect.graph_replays") == 48


@pytest.mark.cuda
@pytest.mark.parametrize("mid_batch_reset", [True, False])
def test_returned_batch_outlives_the_next(card, mid_batch_reset):
    env = Breakout(device=card)
    agent = minatar_agent("r2d1", card, env)
    _, kept, returned = collect_both(
        lambda: Run(env, agent, BatchSpec(16, 32), mid_batch_reset), 3)
    for k, (a, b) in enumerate(zip(kept, returned)):
        assert_trees_equal(a[1], b[1], f"batch {k} samples kept")
        assert_trees_equal(a[0]._replace(cum_steps=None),
                           b[0]._replace(cum_steps=None),
                           f"batch {k} state kept")


@pytest.mark.cuda
def test_reset_traj_stats_takes_effect(card):
    """The runners' reset between batches: the eager twin resets too, so
    a graph that kept its own stats would count the episodes before the
    reset, which exist."""
    env = Breakout(device=card)
    agent = minatar_agent("dqn", card, env)
    _, _, returned = collect_both(
        lambda: Run(env, agent, BatchSpec(32, 32), True), 3, reset_after=1)
    assert int(returned[1][0].traj_stats.completed) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mid_batch_reset", [True, False])
@pytest.mark.parametrize("cls", DEVICE_ENVS, ids=lambda c: c.__name__)
def test_every_device_env_captures(card, cls, mid_batch_reset):
    env = cls(device=card)
    agent = RandomAgent(device=card)
    agent.initialize(env.spaces)
    with profiling.recording() as rec:
        collect_both(lambda: Run(env, agent, BatchSpec(24, 16),
                                 mid_batch_reset), 1)
    assert rec.total("collect.graph_replays") == 24
