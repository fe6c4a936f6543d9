"""The Q-value policy-gradient slice of the port (DDPG, TD3, SAC) against
the JAX package, on the CPU: the four QPG models through the weight
bridge, one step of each agent, then the losses, gradients and one and
two updates of each algorithm on one replay batch, the update count and
the ``min_steps_learn`` gate, and a short SAC run on Pendulum.

The RNG streams differ, so JAX's draws are injected: the exploration
noise of a step, the normals of SAC's two policy samples and TD3's target
smoothing.  Replay sampling is the port's own (tested with the DQN
slice); the JAX update is handed the same batch.  Tolerances, float32:
- models and agent steps: rtol 1e-5, atol 1e-6 (other summation orders);
- losses, grad norms, alpha: rtol 1e-5, atol 1e-6;
- gradients: rtol 1e-4, atol 1e-6 (the gradient of the policy loss goes
  through the critics just stepped, which carry the first step's
  rounding);
- params, targets, log alpha and Adam moments after each update: rtol
  1e-5, atol 1e-6 (``torch.optim.Adam`` computes its bias corrections in
  double, optax in float32; at t = 1 they differ by about 1e-5 of the
  update).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.agents.base import StepCtx
from rlpyt_tpu.agents.qpg import DdpgAgent as JaxDdpgAgent
from rlpyt_tpu.agents.qpg import SacAgent as JaxSacAgent
from rlpyt_tpu.agents.qpg import Td3Agent as JaxTd3Agent
from rlpyt_tpu.algos.qpg import DDPG as JaxDDPG
from rlpyt_tpu.algos.qpg import SAC as JaxSAC
from rlpyt_tpu.algos.qpg import TD3 as JaxTD3
from rlpyt_tpu.envs.base import EnvSpaces as JaxEnvSpaces
from rlpyt_tpu.models import qpg as jax_models
from rlpyt_tpu.replay.base import AgentInputs as JaxAgentInputs
from rlpyt_tpu.replay.base import SamplesFromReplay as JaxSamplesFromReplay
from rlpyt_tpu.samplers.rollout import BatchSpec as JaxBatchSpec
from rlpyt_tpu.spaces import FloatBox as JaxFloatBox
from rlpyt_tpu_torch.agents.qpg import DdpgAgent, SacAgent, Td3Agent
from rlpyt_tpu_torch.algos.qpg import DDPG, SAC, TD3
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.envs.classic import Pendulum
from rlpyt_tpu_torch.models import qpg as models
from rlpyt_tpu_torch.params import from_jax_qpg_params, to_jax_qpg_params
from rlpyt_tpu_torch.replay.base import AgentInputs, SamplesFromReplay
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.spaces import FloatBox

torch.set_num_threads(2)

OBS, A, HIGH, N = 5, 2, 2.0, 32
HIDDEN = dict(hidden_sizes=(16, 16))
CLOSE = dict(rtol=1e-5, atol=1e-6)
GRAD_CLOSE = dict(rtol=1e-4, atol=1e-6)
KINDS = {
    "ddpg": (JaxDdpgAgent, DdpgAgent, JaxDDPG, DDPG,
             dict(initial_std=0.3)),
    "td3": (JaxTd3Agent, Td3Agent, JaxTD3, TD3, dict(initial_std=0.3)),
    "sac": (JaxSacAgent, SacAgent, JaxSAC, SAC, {}),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.tensor(np.asarray(x))


def spaces():
    obs = dict(low=[-10.0] * OBS, high=[10.0] * OBS, shape=(OBS,))
    act = dict(low=[-HIGH] * A, high=[HIGH] * A, shape=(A,))
    return (JaxEnvSpaces(JaxFloatBox(**obs), JaxFloatBox(**act)),
            EnvSpaces(FloatBox(**obs), FloatBox(**act)))


def load_nets(agent, params):
    agent.nets.load_state_dict({k: torch.tensor(v) for k, v in
                                from_jax_qpg_params(np_tree(params)).items()})


def assert_nets_close(agent, params, **tol):
    want = from_jax_qpg_params(np_tree(params))
    got = agent.nets.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **tol)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

MODELS = {
    "mu": (lambda: jax_models.MuMlpModel(A, (16, 16), output_max=HIGH),
           lambda: models.MuMlpModel((OBS,), A, (16, 16), output_max=HIGH),
           False),
    "q": (lambda: jax_models.QofMuMlpModel((16, 16)),
          lambda: models.QofMuMlpModel((OBS,), A, (16, 16)), True),
    "pi": (lambda: jax_models.PiMlpModel(A, (16, 16)),
           lambda: models.PiMlpModel((OBS,), A, (16, 16)), False),
    "v": (lambda: jax_models.VMlpModel((16, 16)),
          lambda: models.VMlpModel((OBS,), (16, 16)), False),
}


@pytest.mark.parametrize("lead", [(), (7,), (3, 4)])
@pytest.mark.parametrize("name", MODELS)
def test_qpg_model_matches_jax(name, lead):
    jax_cls, cls, takes_action = MODELS[name]
    rng = np.random.default_rng(0)
    obs = rng.standard_normal(lead + (OBS,)).astype(np.float32)
    act = rng.uniform(-HIGH, HIGH, lead + (A,)).astype(np.float32)
    args = (obs, act) if takes_action else (obs,)
    jmodel, model = jax_cls(), cls()
    params = jmodel.init(jax.random.key(1), *args)
    sd = {k.split(".", 1)[1]: torch.tensor(v) for k, v in
          from_jax_qpg_params({"m": np_tree(params)}).items()}
    model.load_state_dict(sd)
    want = jmodel.apply(params, *args)
    got = model(*(torch.tensor(a) for a in args))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **CLOSE)


def test_qpg_bridge_round_trips():
    jspaces, tspaces = spaces()
    jagent = JaxSacAgent(model_kwargs=HIDDEN, q_model_kwargs=HIDDEN)
    jagent.initialize(jspaces)
    params = np_tree(jagent.init(jax.random.key(0),
                                 jnp.zeros((2, OBS), jnp.float32)))
    back = to_jax_qpg_params(from_jax_qpg_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Agents
# ---------------------------------------------------------------------------

def make_agents(kind):
    JaxAgent, Agent, _, _, kw = KINDS[kind]
    jspaces, tspaces = spaces()
    jagent = JaxAgent(model_kwargs=HIDDEN, q_model_kwargs=HIDDEN, **kw)
    agent = Agent(model_kwargs=HIDDEN, q_model_kwargs=HIDDEN, device="cpu",
                  **kw)
    jagent.initialize(jspaces)
    agent.initialize(tspaces)
    return jagent, agent


@pytest.mark.parametrize("is_eval", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_agent_step_matches_jax(kind, is_eval):
    jagent, agent = make_agents(kind)
    params = jagent.init(jax.random.key(0), jnp.zeros((4, OBS)))
    load_nets(agent, params)
    assert sorted(agent.nets) == sorted(params)
    obs = np.random.default_rng(1).standard_normal((N, OBS)).astype(
        np.float32) * 3.0
    key = jax.random.key(2)
    jstep, _ = jagent.step(params, key, jnp.asarray(obs), None, None, None,
                           StepCtx(jnp.int32(0), is_eval))
    noise = t(jax.random.normal(key, (N, A)))
    step, carry = agent.step(t(obs), None, None, None, 0, None,
                             is_eval=is_eval, noise=noise)
    assert carry is None and step.agent_info == {}
    np.testing.assert_allclose(step.action.numpy(),
                               np.asarray(jstep.action), **CLOSE)
    assert float(step.action.abs().max()) <= HIGH
    if not is_eval and kind != "sac":
        assert (step.action.abs() == HIGH).any()   # the clip binds


def test_targets_start_as_copies_and_take_no_grad():
    _, agent = make_agents("td3")
    for name in ("mu", "q1", "q2"):
        online = agent.nets[name].state_dict()
        target = agent.nets["target_" + name]
        for k, v in target.state_dict().items():
            assert torch.equal(v, online[k])
            assert v.data_ptr() != online[k].data_ptr()
        assert not any(p.requires_grad for p in target.parameters())


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------

def make_batch(seed=3):
    """A replay batch of N transitions for both packages (some done, some
    timed out)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((N, OBS)).astype(np.float32)
    next_obs = rng.standard_normal((N, OBS)).astype(np.float32)
    action = rng.uniform(-HIGH, HIGH, (N, A)).astype(np.float32)
    ret = rng.standard_normal(N).astype(np.float32)
    done = rng.random(N) < 0.2
    timeout = (rng.random(N) < 0.2) & ~done
    zeros_a = np.zeros((N, A), np.float32)
    zeros = np.zeros(N, np.float32)
    fields = dict(action=action, return_=ret, done=done, done_n=done,
                  timeout_n=timeout, is_weights=np.ones(N, np.float32))
    jb = JaxSamplesFromReplay(
        agent_inputs=JaxAgentInputs(jnp.asarray(obs), jnp.asarray(zeros_a),
                                    jnp.asarray(zeros)),
        target_inputs=JaxAgentInputs(jnp.asarray(next_obs),
                                     jnp.asarray(action),
                                     jnp.asarray(ret)),
        indices=(jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.int32)),
        **{k: jnp.asarray(v) for k, v in fields.items()})
    tb = SamplesFromReplay(
        agent_inputs=AgentInputs(t(obs), t(zeros_a), t(zeros)),
        target_inputs=AgentInputs(t(next_obs), t(action), t(ret)),
        indices=(torch.zeros(N, dtype=torch.long),) * 2,
        **{k: t(v) for k, v in fields.items()})
    return jb, tb


ALGO_KW = dict(batch_size=N, min_steps_learn=0, replay_size=256,
               replay_ratio=8.0, learning_rate=3e-3, discount=0.97)


def make_algos(kind, **kw):
    jagent, agent = make_agents(kind)
    _, _, JaxAlgo, Algo, _ = KINDS[kind]
    kw = {**ALGO_KW, **kw}
    if kind != "sac":
        kw["q_learning_rate"] = 2e-3
    jalgo, algo = JaxAlgo(**kw), Algo(**kw)
    example = jnp.zeros((4, OBS), jnp.float32)
    train_state, _ = jalgo.initialize(jagent, JaxBatchSpec(8, 4), example,
                                      jax.random.key(4))
    algo.initialize(agent, BatchSpec(8, 4), torch.zeros((4, OBS)),
                    torch.Generator().manual_seed(0))
    load_nets(agent, train_state.params)
    return jalgo, algo, train_state


def update_noise(kind, key):
    """The normals JAX's ``_one_update`` draws from ``key``, as the port's
    ``noise``."""
    if kind == "sac":
        _, k_next, k_pi = jax.random.split(key, 3)
        return tuple(t(jax.random.normal(k, (N, A))) for k in (k_next, k_pi))
    if kind == "td3":
        _, k_noise = jax.random.split(key)
        return t(jax.random.normal(k_noise, (N, A)))
    return None


def spy_grads(algo):
    """Record each optimizer's gradients at every step."""
    seen = []
    for name, opt in algo.optimizers.items():
        real = opt.step

        def step(name=name, opt=opt, real=real):
            seen.append((name, [p.grad.clone() for p in opt.params]))
            return real()

        opt.step = step
    return seen


def jax_grads(kind, jalgo, params, alpha, jb, key):
    """(critic grads at ``params``, policy grads after JAX's critic step)
    as {net: state_dict of grads}."""
    if kind == "sac":
        _, k_next, k_pi = jax.random.split(key, 3)
        qg = jax.grad(jalgo.q_loss)((params["q1"], params["q2"]), params,
                                    alpha, jb, k_next)
        q_names = ("q1", "q2")
    elif kind == "td3":
        _, k_noise = jax.random.split(key)
        qg = jax.grad(jalgo.q_loss)((params["q1"], params["q2"]), params,
                                    jb, k_noise)
        q_names = ("q1", "q2")
    else:
        qg = (jax.grad(jalgo.q_loss)(params["q"], params, jb),)
        q_names = ("q",)
    return dict(zip(q_names, qg)), q_names


def grads_as_state(name, tree):
    return {k.split(".", 1)[1]: v for k, v in
            from_jax_qpg_params({name: np_tree(tree)}).items()}


def assert_grads_close(got, want_tree, name, agent):
    want = grads_as_state(name, want_tree)
    keys = [k for k, _ in agent.nets[name].named_parameters()]
    assert sorted(keys) == sorted(want)
    for k, g in zip(keys, got):
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=f"{name} {k}",
                                   **GRAD_CLOSE)


def adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) of an unclipped adam."""
    return opt_state[0]


def assert_adam_close(algo, name, jstate):
    adam = adam_state(jstate.opt_states[name])
    params = list(algo.agent.nets[name].named_parameters())
    mu = grads_as_state(name, adam.mu)
    nu = grads_as_state(name, adam.nu)
    for k, p in params:
        st = algo.optimizers[name].inner.state[p]
        assert int(st["step"]) == int(adam.count)
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[k], **CLOSE)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[k],
                                   rtol=1e-5, atol=1e-9)


def assert_info_close(info, jinfo):
    for field in jinfo._fields:
        np.testing.assert_allclose(float(getattr(info, field)),
                                   float(getattr(jinfo, field)),
                                   err_msg=field, **CLOSE)


@pytest.mark.parametrize("kind", KINDS)
def test_two_updates_match_jax(kind):
    """Two updates on one batch: the critics' grads (against jax.grad of
    the JAX loss), the policy's grads (against jax.grad at JAX's stepped
    critics), the infos, every network and target, log alpha and the
    Adam moments and counts after each.  TD3 steps mu on the second
    update only, and reports mu's loss and grad norm on both."""
    jalgo, algo, state = make_algos(kind)
    agent = algo.agent
    jb, tb = make_batch()
    jalgo.replay.sample = lambda *args, **kwargs: jb
    seen = spy_grads(algo)
    policy = "pi" if kind == "sac" else "mu"
    for i, key in enumerate(jax.random.split(jax.random.key(11), 2)):
        params = state.params
        alpha = jnp.exp(state.log_alpha)
        jq_grads, q_names = jax_grads(kind, jalgo, params, alpha, jb, key)
        new_state, jinfo = jalgo._one_update(state, None, key)
        del seen[:]
        info = algo.update(tb, noise=update_noise(kind, key))
        steps = dict(seen)
        for name in q_names:
            assert_grads_close(steps[name], jq_grads[name], name, agent)
        stepped_q = {**params, **{n: new_state.params[n] for n in q_names}}
        if kind == "sac":
            _, _, k_pi = jax.random.split(key, 3)
            pg = jax.grad(lambda p: jalgo.pi_loss(
                p, stepped_q, alpha, jb, k_pi)[0])(params["pi"])
        else:
            pg = jax.grad(jalgo.mu_loss)(params["mu"], stepped_q, jb)
        if kind == "td3" and i == 0:
            assert policy not in steps
        else:
            assert_grads_close(steps[policy], pg, policy, agent)
        assert_info_close(info, jinfo)
        assert_nets_close(agent, new_state.params, **CLOSE)
        for name in q_names + ((policy,) if policy in steps else ()):
            assert_adam_close(algo, name, new_state)
        if kind == "sac":
            np.testing.assert_allclose(float(algo.log_alpha.detach()),
                                       float(new_state.log_alpha), **CLOSE)
            assert float(algo.log_alpha.detach()) != 0.0
        assert algo.update_counter == int(new_state.update_counter) == i + 1
        state = new_state
    if kind == "td3":
        mu_count = int(adam_state(state.opt_states["mu"]).count)
        assert mu_count == 1
        assert_adam_close(algo, "mu", state)


@pytest.mark.parametrize("kind", KINDS)
def test_policy_loss_leaves_critics_untouched(kind):
    """The policy's step puts no gradient on the critics and the targets'
    inputs carry no graph: after an update, every critic's .grad is
    exactly the critic loss's gradient, and no target has one."""
    _, algo, _ = make_algos(kind)
    agent = algo.agent
    _, tb = make_batch(5)
    seen = spy_grads(algo)
    algo.update(tb, noise=update_noise(kind, jax.random.key(1)))
    steps = dict(seen)
    for name in agent.q_names:
        for p, g in zip(agent.nets[name].parameters(), steps[name]):
            assert torch.equal(p.grad, g)
    for name, net in agent.nets.items():
        if name.startswith("target_"):
            assert all(p.grad is None for p in net.parameters())


@pytest.mark.parametrize("kind", KINDS)
def test_updates_per_optimize_and_the_learning_gate(kind):
    """updates_per_optimize is JAX's max(1, int(ratio T B / batch)); no
    update runs while cum_steps < min_steps_learn (zeros reported, and
    alpha = 1 for SAC); from there each optimize runs that many updates,
    each on its own batch."""
    from types import SimpleNamespace

    from rlpyt_tpu_torch.samplers.rollout import Samples

    for ratio, want in ((8.0, 8), (0.5, 1), (3.0, 3)):
        jalgo, algo, _ = make_algos(kind, replay_ratio=ratio,
                                    min_steps_learn=64)
        assert algo.updates_per_optimize == jalgo.updates_per_optimize \
            == want
    rng = np.random.default_rng(0)

    def samples():
        return Samples(
            observation=t(rng.standard_normal((8, 4, OBS)).astype(
                np.float32)),
            action=t(rng.uniform(-HIGH, HIGH, (8, 4, A)).astype(np.float32)),
            reward=t(rng.standard_normal((8, 4)).astype(np.float32)),
            done=torch.zeros((8, 4), dtype=torch.bool),
            prev_action=torch.zeros((8, 4, A)), prev_reward=torch.zeros(8, 4),
            agent_info={}, env_info={"timeout": torch.zeros(
                (8, 4), dtype=torch.bool)})

    batches = []
    real = algo.replay.sample

    def spy(*args, **kwargs):
        batches.append(real(*args, **kwargs))
        return batches[-1]

    algo.replay.sample = spy
    for cum_steps in (32, 63):
        info = algo.optimize(samples(), SimpleNamespace(cum_steps=cum_steps))
        assert algo.update_counter == 0 and not batches
        assert float(info.q_loss) == 0.0
        assert float(info.alpha) == (1.0 if kind == "sac" else 0.0)
    info = algo.optimize(samples(), SimpleNamespace(cum_steps=64))
    assert algo.update_counter == len(batches) == 3
    assert not torch.equal(batches[0].indices[0], batches[1].indices[0])
    for field in info:
        assert field.dim() == 0 and torch.isfinite(field)


def test_sac_trains_pendulum_briefly():
    """MinibatchRl: SAC on Pendulum at narrow widths for 8 iterations of
    [8, 4]: learning starts after 64 steps, losses stay finite, alpha
    moves."""
    agent = SacAgent(model_kwargs=HIDDEN, q_model_kwargs=HIDDEN,
                     device="cpu")
    algo = SAC(batch_size=32, min_steps_learn=64, replay_size=1000,
               replay_ratio=4.0, learning_rate=1e-3)
    rows = []
    runner = MinibatchRl(algo, agent, Pendulum(device="cpu"),
                         BatchSpec(8, 4), n_steps=256,
                         log_interval_steps=32, max_decorrelation_steps=10,
                         device="cpu")
    real = runner.logger.record_tabular

    def record(key, value):
        rows.append((key, value))
        real(key, value)

    runner.logger.record_tabular = record
    runner.train()
    assert algo.update_counter == 7 * 4
    alphas = [v for k, v in rows if k == "alpha"]
    losses = [v for k, v in rows if k in ("q_loss", "pi_loss")]
    assert len(alphas) == 8 and alphas[0] == 1.0 and alphas[-1] < 1.0
    assert all(np.isfinite(losses))


def test_sac_fixed_alpha_matches_jax():
    """SAC with a fixed alpha of 0.2: one update against JAX's (log alpha
    stays 0 and the reported alpha 1, as the JAX package reports it)."""
    jalgo, algo, state = make_algos("sac", fixed_alpha=0.2)
    jb, tb = make_batch(9)
    jalgo.replay.sample = lambda *args, **kwargs: jb
    key = jax.random.key(12)
    new_state, jinfo = jalgo._one_update(state, None, key)
    info = algo.update(tb, noise=update_noise("sac", key))
    assert_info_close(info, jinfo)
    assert float(info.alpha) == 1.0
    assert_nets_close(algo.agent, new_state.params, **CLOSE)


@pytest.mark.parametrize("kind", KINDS)
def test_q_loss_matches_jax(kind):
    """``q_loss`` at the JAX targets equals the JAX ``q_loss`` at the
    same weights, batch and target noise."""
    jalgo, algo, state = make_algos(kind)
    jb, tb = make_batch()
    params, key = state.params, jax.random.key(11)
    noise = update_noise(kind, key)
    nets = algo.agent.nets
    with torch.no_grad():
        if kind == "sac":
            _, k_next, _ = jax.random.split(key, 3)
            alpha = jnp.exp(state.log_alpha)
            want = jalgo.q_loss((params["q1"], params["q2"]), params, alpha,
                                jb, k_next)
            obs = tb.target_inputs.observation
            a, logp = algo.agent.pi(obs, algo.generator, noise[0])
            next_q = torch.minimum(nets["target_q1"](obs, a),
                                   nets["target_q2"](obs, a))
            y = algo._targets(tb, next_q - float(alpha) * logp)
        elif kind == "td3":
            _, k_noise = jax.random.split(key)
            want = jalgo.q_loss((params["q1"], params["q2"]), params, jb,
                                k_noise)
            y = algo._targets(tb, algo._next_q(tb, noise))
        else:
            want = jalgo.q_loss(params["q"], params, jb)
            y = algo._targets(tb, algo._next_q(tb, None))
        got = algo.q_loss(tb, y)
    np.testing.assert_allclose(float(got), float(want), **CLOSE)
