"""R2D1's update as CUDA graph pieces around the eager LSTM core
(``algos/r2d1_graph.py``).

On the CPU (tier 1):
- the rule that engages the graphs: a card, no data-parallel shard, no
  parameter split over 'mp';
- a CPU update runs eagerly and counts as such;
- the graphed path with each capture and replay swapped for eager runs
  of what they capture (the warm-up, static batch and inputs, the
  pieces' autograd nodes, the copies out) equals the eager path bit for
  bit over six updates with a target copy inside: losses, gradient
  norms, mean and written priorities, parameters, target parameters and
  Adam's moments; the first update runs eagerly and the counters say so;
- the graphed path counts the trunk's calls as the eager path does and
  records its spans around the replays that run it, as the pieces learn
  them at the warm-up (``heard``), from their own thread alone;
- each graphed update calls the LSTM module four times through its
  ``forward`` (wrapped as the benchmark wraps it) and runs its backward
  once;
- a run resumed from ``state_dict()`` after three graphed updates
  continues bit for bit;
- a state saved by Adam of other kernel settings loads without changing
  this Adam's;
- a capture (``utils/cuda_graphs.py:Capturer``, stood in for by
  ``_torch_graph_standin.py``) runs with Python's cyclic garbage
  collector off.

On the card (``cuda``; ``CUBLAS_WORKSPACE_CONFIG=:4096:8 python -m
pytest --noconftest -m cuda tests/test_torch_r2d1_graph.py``): the same,
with real graphs, at the MinAtar and the residual-trunk configs' widths
and windows, under deterministic algorithms (cuDNN's convolution
backward is not deterministic otherwise), the trunk's counts and spans
(its backward's from the autograd engine's threads), a state saved on
the CPU resumed on the card through a capture, and no collection inside
a capture.  The file imports no JAX.
"""
import copy
import gc
from contextlib import contextmanager
from types import SimpleNamespace

import pytest
import torch
from _torch_graph_standin import eager_graphs

from rlpyt_tpu_torch.agents.dqn import R2d1Agent
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.algos.r2d1_graph import update_graphable
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.models.dqn import AtariR2d1Model
from rlpyt_tpu_torch.replay.sequence import SequenceSamples
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.spaces import IntBox
from rlpyt_tpu_torch.utils import cuda_graphs, profiling

SEED = 2718281828
N_UPDATES = 6

# Model, observations (shape, values, dtype), actions, windows
# (warmup_T, batch_T, n_step, batch_b).
TINY = dict(model=dict(channels=(8,), kernel_sizes=(3,), strides=(1,),
                       paddings=(0,), fc_sizes=(32,), obs_divisor=1.0,
                       lstm_size=16, dueling=True),
            obs=((4, 10, 10), 2, torch.int64), actions=6,
            windows=(4, 6, 2, 4))
MINATAR = dict(model=dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                          paddings=(0,), fc_sizes=(128,), obs_divisor=1.0,
                          lstm_size=128, dueling=True),
               obs=((4, 10, 10), 2, torch.int64), actions=6,
               windows=(40, 80, 5, 64))
RESNET = dict(model=dict(trunk="resnet", channels=(16, 32, 32), blocks=2,
                         feature_size=256, lstm_size=256),
              obs=((4, 104, 80), 256, torch.uint8), actions=4,
              windows=(40, 80, 5, 32))
CONFIGS = {
    "default": dict(),
    "variants": dict(double_dqn=False, mask_after_done=True,
                     delta_clip=1.0, zero_state_init=True,
                     use_value_rescale=False),
    "no_burn_in": dict(warmup_T=0),
}


# -- helpers --------------------------------------------------------------


@pytest.fixture
def on_cpu_graph(monkeypatch):
    eager_graphs(monkeypatch)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def deterministic(card, monkeypatch):
    """Deterministic algorithms for one test; cuBLAS needs a fixed
    workspace for them (set before its first call in the process, as
    the module's command does)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield card
    torch.use_deterministic_algorithms(False)


def make_algo(spec: dict, device, cfg: dict = None,
              target_update_interval: int = 2) -> R2D1:
    """An initialized R2D1 at ``spec``, its weights from a fixed seed."""
    cfg = dict(cfg or {})
    wT, T, n, b = spec["windows"]
    wT = cfg.pop("warmup_T", wT)
    shape, high, dtype = spec["obs"]
    torch.manual_seed(0)
    agent = R2d1Agent(ModelCls=AtariR2d1Model,
                      model_kwargs=dict(spec["model"]), device=device)
    agent.initialize(EnvSpaces(IntBox(0, high, shape, dtype),
                               IntBox(0, spec["actions"])))
    algo = R2D1(batch_b=b, batch_T=T, warmup_T=wT, n_step_return=n,
                replay_size=8 * (wT or T),
                target_update_interval=target_update_interval, **cfg)
    algo.initialize(agent, BatchSpec(T=wT or T, B=2),
                    torch.zeros((2,) + shape, dtype=dtype),
                    torch.Generator(device=device).manual_seed(0))
    return algo


def windows(algo: R2D1, spec: dict, k: int) -> SequenceSamples:
    """The k-th window batch of fixed draws, at ``algo``'s windows."""
    g = torch.Generator().manual_seed(SEED + k)
    b, A = algo.batch_b, spec["actions"]
    W = algo.warmup_T + algo.batch_T + algo.n_step
    shape, high, dtype = spec["obs"]
    H = algo.model.lstm.hidden_size
    rows = torch.arange(b)
    batch = SequenceSamples(
        observation=torch.randint(0, high, (W, b) + shape, generator=g
                                  ).to(dtype),
        action=torch.randint(0, A, (W, b), generator=g),
        reward=torch.randn((W, b), generator=g) * 3,
        done=torch.rand((W, b), generator=g) < 0.05,
        prev_action=torch.randint(0, A, (W, b), generator=g),
        prev_reward=torch.randn((W, b), generator=g),
        init_rnn_state=tuple(torch.randn((b, H), generator=g) * 0.5
                             for _ in range(2)),
        is_weights=torch.rand((b,), generator=g) * 0.8 + 0.2,
        slots=(rows % algo.replay.n_slots, rows % algo.replay.B))
    dev = algo.agent.device
    return SequenceSamples(*(
        tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev)
        for v in batch))


def run(algo: R2D1, spec: dict, updates: range, engage: bool) -> list:
    """``algo``'s updates on the batches ``updates`` with the engagement
    rule saying ``engage``: each update's diagnostics and the replay's
    priorities after it, cloned."""
    out = []
    algo._graphable = engage
    for k in updates:
        info = algo.update(windows(algo, spec, k))
        out.append([x.clone() for x in info]
                   + [algo.replay.priorities.clone(),
                      algo.replay.max_priority.clone()])
    return out


def state(algo: R2D1) -> list:
    """Parameters, target parameters and Adam's moments."""
    inner = algo.optimizer.inner
    return ([p.detach().clone() for p in algo.model.parameters()]
            + [p.detach().clone() for p in algo.target_model.parameters()]
            + [v.clone() for p in algo.optimizer.params
               for v in inner.state[p].values()])


def assert_equal(a: list, b: list, what: str):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, list):
            assert_equal(x, y, f"{what} [{i}]")
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
            assert torch.equal(x, y), (what, i)


def graphed_against_eager(spec, device, cfg):
    """Six updates graphed and six eager from the same weights and
    batches, compared bit for bit; the graphed run's recording and the
    eager run's."""
    graphed, eager = (make_algo(spec, device, cfg) for _ in range(2))
    with profiling.recording() as rec:
        g = run(graphed, spec, range(N_UPDATES), True)
    with profiling.recording() as eager_rec:
        e = run(eager, spec, range(N_UPDATES), False)
    assert_equal(g, e, "updates")
    assert_equal(state(graphed), state(eager), "state")
    assert graphed.update_counter == N_UPDATES
    # The target copy at update 2, 4, 6: the target is the online net.
    for t, p in zip(graphed.target_model.parameters(),
                    graphed.model.parameters()):
        assert torch.equal(t, p)
    return rec, eager_rec


class LstmCalls:
    """Counts a core's calls and backwards through a wrapper on its
    ``forward``, installed as the benchmark's ``Ranges.wrap_lstm`` is."""

    def __init__(self, core):
        self.calls = self.backwards = 0
        orig = core.forward
        counter = self

        class Backward(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, dx):
                counter.backwards += 1
                return dx

        def forward(x, done, state):
            self.calls += 1
            if torch.is_grad_enabled() and x.requires_grad:
                x = Backward.apply(x)
            return orig(x, done, state)

        core.forward = forward


def lstm_calls_per_update(spec, device):
    algo = make_algo(spec, device)
    run(algo, spec, range(1), True)    # eager, then capture
    online, target = LstmCalls(algo.model.lstm), LstmCalls(
        algo.target_model.lstm)
    with profiling.recording() as rec:
        run(algo, spec, range(1, 4), True)
    assert rec.total("update.graph_replays") == 3
    assert (online.calls, target.calls) == (6, 6)
    assert (online.backwards, target.backwards) == (3, 0)


def resume(spec, device):
    """Three graphed updates, ``state_dict()``, a fresh algorithm loads
    it and makes three more: equal to six without the stop."""
    whole = make_algo(spec, device)
    w = run(whole, spec, range(N_UPDATES), True)
    first = make_algo(spec, device)
    run(first, spec, range(3), True)
    assert first._graphs is not None
    saved = copy.deepcopy((first.model.state_dict(), first.state_dict()))
    second = make_algo(spec, device)
    second.model.load_state_dict(saved[0])
    second.load_state_dict(saved[1])
    with profiling.recording() as rec:
        s = run(second, spec, range(3, N_UPDATES), True)
    # After the load, one eager update, then the graphs.
    assert rec.total("update.eager") == 1
    assert rec.total("update.graph_replays") == 2
    assert_equal(s, w[3:], "updates after the resume")
    assert_equal(state(second), state(whole), "state")


# -- CPU ------------------------------------------------------------------


@pytest.mark.parametrize("device, shard, split, engaged", [
    ("cpu", None, False, False),
    ("cuda:0", None, False, True),
    ("cuda", None, False, True),
    ("cuda:0", object(), False, False),     # a data-parallel rank
    ("cuda:0", None, True, False),          # a parameter split over 'mp'
    ("cpu", object(), False, False),
])
def test_engagement_rule(device, shard, split, engaged):
    params = [torch.zeros(2)] + ([SimpleNamespace(device_mesh=None)]
                                 if split else [])
    assert update_graphable(torch.device(device), shard, params) is engaged


def test_cpu_updates_run_eagerly():
    algo = make_algo(TINY, "cpu")
    with profiling.recording() as rec:
        for k in range(3):
            algo.update(windows(algo, TINY, k))
    assert rec.total("update.eager") == 3
    assert "update.graph_replays" not in rec.counts
    assert algo._graphs is None
    assert not any(r.name == "update.capture" for r in rec.spans())


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_graph_path_equals_eager_on_the_cpu(on_cpu_graph, cfg):
    rec, _ = graphed_against_eager(TINY, "cpu", CONFIGS[cfg])
    assert rec.total("update.eager") == 1
    assert rec.total("update.graph_replays") == N_UPDATES - 1
    assert sum(r.name == "update.capture" for r in rec.spans()) == 1


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_graphed_updates_record_the_trunk(on_cpu_graph, cfg):
    """The graphed path counts the trunk's calls as the eager path does,
    and records a ``model.trunk`` span around each replay that runs it
    (``burn_in``'s, if there is a burn-in, and ``window``'s) and a
    ``model.trunk_bwd`` span around ``window``'s backward."""
    rec, eager = graphed_against_eager(TINY, "cpu", CONFIGS[cfg])
    assert rec.counts["model.trunk"] == eager.counts["model.trunk"]

    def spans(r, name):
        return sum(x.name == name for x in r.spans())

    per_update = spans(eager, "model.trunk") // N_UPDATES
    assert per_update == (2 if cfg == "no_burn_in" else 4)
    assert spans(rec, "model.trunk") == (
        per_update + (N_UPDATES - 1) * per_update // 2)
    assert spans(rec, "model.trunk_bwd") == N_UPDATES
    assert spans(eager, "model.trunk_bwd") == N_UPDATES


def test_warm_up_hears_its_own_thread_alone():
    """A piece's warm-up learns what its own thread records (and the
    autograd engine's threads, which Python did not start), not what
    another thread of the program records meanwhile (an asynchronous
    runner's actor), and opens no profiler range."""
    import threading

    from rlpyt_tpu_torch.algos.r2d1_graph import _Listener

    rec = _Listener()

    def other():
        rec.count("other", 1)
        with rec.span("other"):
            pass

    thread = threading.Thread(target=other)
    thread.start()
    thread.join()
    rec.count("own", 1)
    with rec.span("own"):
        pass
    assert rec.counts == {"own": {1: 1}}
    assert [(r.name, r.traced) for r in rec.spans()] == [("own", False)]


def test_lstm_calls_per_graphed_update_on_the_cpu(on_cpu_graph):
    lstm_calls_per_update(TINY, "cpu")


def test_resume_continues_bit_for_bit_on_the_cpu(on_cpu_graph):
    resume(TINY, "cpu")


def test_load_state_dict_drops_the_graphs(on_cpu_graph):
    """Adam's moments are new tensors after a load: the graphs that held
    the old ones go, and the next update runs eagerly."""
    algo = make_algo(TINY, "cpu")
    run(algo, TINY, range(2), True)
    assert algo._graphs is not None
    algo.load_state_dict(copy.deepcopy(algo.state_dict()))
    assert algo._graphs is None
    with profiling.recording() as rec:
        run(algo, TINY, range(2, 4), True)
    assert rec.total("update.eager") == 1
    assert rec.total("update.graph_replays") == 1


def test_load_keeps_this_optimizers_kernel_settings():
    """A state saved by Adam of other kernel settings (a card's fused,
    capturable one) loads into the CPU's Adam, which keeps its own
    settings and continues as from a state of its own."""
    saver = make_algo(TINY, "cpu")
    run(saver, TINY, range(2), False)
    saved = copy.deepcopy((saver.model.state_dict(), saver.state_dict()))
    card_made = copy.deepcopy(saved[1])
    for group in card_made["optimizer"]["inner"]["param_groups"]:
        group.update(fused=True, capturable=True, foreach=None)
    runs = []
    for state_ in (saved[1], card_made):
        algo = make_algo(TINY, "cpu")
        before = copy.deepcopy(algo.optimizer.inner.param_groups[0])
        algo.model.load_state_dict(saved[0])
        algo.load_state_dict(state_)
        group = algo.optimizer.inner.param_groups[0]
        for k in ("fused", "capturable", "foreach"):
            assert group[k] == before[k], k
        runs.append(run(algo, TINY, range(2, 5), False) + [state(algo)])
    assert_equal(runs[1], runs[0], "updates after the load")


def test_capture_keeps_the_collector_off(monkeypatch):
    """``cuda_graphs.Capturer.capture`` turns the cyclic garbage collector
    off for the capture alone (a dead graph freed inside a capture breaks
    it), and leaves it as it found it, after an error too; it captures on
    its side stream, into its pool, thread-locally, with the generators
    it is given registered, and returns the graph's replay."""
    seen = []

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def __init__(self):
            self.generators = []

        def register_generator_state(self, generator):
            self.generators.append(generator)

        def replay(self):
            pass

    @contextmanager
    def graph(g, **kwargs):
        seen.append((g, kwargs, gc.isenabled()))
        yield

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    was = gc.isenabled()
    gc.enable()
    try:
        cap = cuda_graphs.Capturer("cuda")
        inside = []
        replay = cap.capture(lambda: inside.append(gc.isenabled()),
                             generators=("generator",))
        assert inside == [False] and gc.isenabled()
        ((g, kwargs, enabled),) = seen
        assert replay == g.replay and g.generators == ["generator"]
        assert kwargs == {"pool": "pool", "stream": cap.side,
                          "capture_error_mode": "thread_local"}
        assert not enabled

        def fails():
            raise RuntimeError("in the body")

        with pytest.raises(RuntimeError):
            cap.capture(fails)
        assert gc.isenabled()
        gc.disable()
        cap.capture(lambda: None)
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()


# -- the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [MINATAR, RESNET],
                         ids=["minatar", "resnet"])
def test_graphed_updates_equal_eager_on_the_card(deterministic, spec):
    rec, _ = graphed_against_eager(spec, deterministic, {})
    assert rec.total("update.eager") == 1
    assert rec.total("update.graph_replays") == N_UPDATES - 1


@pytest.mark.cuda
def test_graphed_updates_record_the_trunk_on_the_card(deterministic):
    """On a card, where the backward runs on the autograd engine's
    threads: the graphed path counts the trunk's calls as the eager path
    does, with a ``model.trunk`` span around each replay of ``burn_in``
    and ``window`` and a ``model.trunk_bwd`` span around ``window``'s
    backward."""
    rec, eager = graphed_against_eager(MINATAR, deterministic, {})
    assert rec.counts["model.trunk"] == eager.counts["model.trunk"]
    names = [r.name for r in rec.spans()]
    assert names.count("model.trunk") == 4 + (N_UPDATES - 1) * 2
    assert names.count("model.trunk_bwd") == N_UPDATES


@pytest.mark.cuda
def test_card_engages_the_graphs(card):
    """On a card the rule holds and Adam is the fused, capturable one."""
    algo = make_algo(TINY, card)
    assert update_graphable(card, algo.shard, algo.optimizer.params)
    assert algo._graphable
    group = algo.optimizer.inner.param_groups[0]
    assert group["fused"] and group["capturable"]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [MINATAR, RESNET],
                         ids=["minatar", "resnet"])
def test_lstm_calls_per_graphed_update_on_the_card(card, spec):
    lstm_calls_per_update(spec, card)


@pytest.mark.cuda
def test_resume_continues_bit_for_bit_on_the_card(deterministic):
    resume(MINATAR, deterministic)


@pytest.mark.cuda
def test_card_resumes_a_state_made_on_the_cpu(deterministic):
    """A state saved on the CPU (Adam neither fused nor capturable, its
    step counts on the host) loads into a card's algorithm, which keeps
    its fused, capturable Adam and captures its graphs: three updates
    (one eager, two graphed) equal three eager ones bit for bit."""
    saver = make_algo(MINATAR, "cpu")
    run(saver, MINATAR, range(2), False)
    saved = (saver.model.state_dict(), saver.state_dict())
    runs = []
    for engage in (True, False):
        algo = make_algo(MINATAR, deterministic)
        algo.model.load_state_dict(saved[0])
        algo.load_state_dict(copy.deepcopy(saved[1]))
        inner = algo.optimizer.inner
        group = inner.param_groups[0]
        assert group["fused"] and group["capturable"]
        assert all(inner.state[p]["step"].device.type == "cuda"
                   for p in algo.optimizer.params)
        with profiling.recording() as rec:
            runs.append(run(algo, MINATAR, range(2, 5), engage)
                        + [state(algo)])
        assert rec.total("update.graph_replays") == (2 if engage else 0)
    assert algo._graphs is None
    assert_equal(runs[0], runs[1], "graphed against eager after the load")


@pytest.mark.cuda
def test_no_collection_inside_a_capture(card):
    """With the collector set off by nearly every allocation and an
    algorithm's graphs left dead in a reference cycle (the algorithm and
    its graphs hold each other), a new algorithm captures its graphs,
    and no collection runs while a stream captures."""
    dead = make_algo(TINY, card)
    run(dead, TINY, range(2), True)
    assert dead._graphs is not None
    del dead
    capturing = []

    def seen(phase, info):
        if phase == "start":
            capturing.append(torch.cuda.is_current_stream_capturing())

    thresholds = gc.get_threshold()
    gc.callbacks.append(seen)
    gc.set_threshold(1, 10 ** 6, 10 ** 6)
    try:
        algo = make_algo(TINY, card)
        run(algo, TINY, range(3), True)
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(seen)
    assert algo._graphs is not None
    assert capturing and not any(capturing)
