"""The policy-gradient slice of the port against the JAX package, on the
CPU: returns and GAE, the categorical distribution, the optimizers, both
PG models through the weight bridge, one step of each agent, A2C and PPO
(feedforward and recurrent), evaluation, and the four MinAtar PG configs
through ``build_and_train``; then the Gaussian half: MujocoFfModel (with
the never-updated observation statistics), MujocoLstmModel, one step of
each Gaussian agent, and Gaussian A2C and PPO updates.

The RNG streams differ, so the JAX draws are injected: Gumbel noise and
standard normals for sampling, permutations for PPO's minibatches, reset
values for CartPole.
Tolerances, float32 throughout:
- returns and GAE: rtol 1e-6, atol 1e-7 (JAX sums by an associative
  scan, the port by a reverse loop);
- the optimizers: params after each step to rtol 1e-6, atol 1e-7
  (RMSprop, written here to optax's formula), or 1e-5, 1e-6 (Adam:
  ``torch.optim.Adam`` computes the bias corrections 1 - b^t in double,
  optax in float32, which at t = 1 puts 1 - 0.999 1.3e-5 off; so the
  updates differ by about that much relative to the update);
- models, agents, losses, grads and params after an update: rtol 1e-5,
  atol 1e-6 (other summation orders; the LSTM sums its gate products in
  another order than the scan);
- sampled actions, and evaluation's counts, returns and lengths: equal.
"""
import csv
import math
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from rlpyt_tpu.agents.base import StepCtx
from rlpyt_tpu.agents.pg import CategoricalPgAgent as JaxPgAgent
from rlpyt_tpu.agents.pg import GaussianPgAgent as JaxGaussianPgAgent
from rlpyt_tpu.agents.pg import RecurrentCategoricalPgAgent as JaxRecPgAgent
from rlpyt_tpu.agents.pg import \
    RecurrentGaussianPgAgent as JaxRecGaussianPgAgent
from rlpyt_tpu.algos.base import make_optimizer as jax_make_optimizer
from rlpyt_tpu.algos.pg import A2C as JaxA2C
from rlpyt_tpu.algos.pg import PPO as JaxPPO
from rlpyt_tpu.distributions.categorical import Categorical as JaxCategorical
from rlpyt_tpu.distributions.categorical import DistInfo as JaxDistInfo
from rlpyt_tpu.distributions.gaussian import DistInfoStd as JaxDistInfoStd
from rlpyt_tpu.envs.base import EnvSpaces as JaxEnvSpaces
from rlpyt_tpu.envs.classic import CartPole as JaxCartPole
from rlpyt_tpu.models.mlp import MlpModel as JaxMlpModel
from rlpyt_tpu.models.pg import AtariFfModel as JaxAtariFfModel
from rlpyt_tpu.models.pg import AtariLstmModel as JaxAtariLstmModel
from rlpyt_tpu.ops import returns as jax_returns
from rlpyt_tpu.samplers.rollout import BatchSpec as JaxBatchSpec
from rlpyt_tpu.samplers.rollout import Collector as JaxCollector
from rlpyt_tpu.samplers.rollout import Samples as JaxSamples
from rlpyt_tpu.spaces import FloatBox as JaxFloatBox
from rlpyt_tpu.spaces import IntBox as JaxIntBox
from rlpyt_tpu.struct import infer_leading_dims as jax_lead_dims
from rlpyt_tpu.struct import restore_leading_dims as jax_restore_dims
from rlpyt_tpu_torch.agents.pg import (
    CategoricalPgAgent,
    GaussianPgAgent,
    RecurrentCategoricalPgAgent,
    RecurrentGaussianPgAgent,
)
from rlpyt_tpu_torch.algos.base import make_optimizer
from rlpyt_tpu_torch.algos.pg import A2C, PPO
from rlpyt_tpu_torch.distributions.categorical import Categorical, DistInfo
from rlpyt_tpu_torch.distributions.gaussian import DistInfoStd
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.envs.classic import CartPole, CartPoleResetDraws
from rlpyt_tpu_torch.experiments.configs.minatar_pg import configs
from rlpyt_tpu_torch.experiments.scripts.minatar_pg import build_and_train
from rlpyt_tpu_torch.models.mlp import MlpModel
from rlpyt_tpu_torch.models.pg import AtariFfModel, AtariLstmModel, dense
from rlpyt_tpu_torch.ops import returns
from rlpyt_tpu_torch.params import from_jax_params, to_jax_params
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector, Samples
from rlpyt_tpu_torch.spaces import FloatBox, IntBox
from rlpyt_tpu_torch.struct import infer_leading_dims, restore_leading_dims
from rlpyt_tpu_torch.utils.variant import load_variant, save_variant, \
    update_config

torch.set_num_threads(2)

IMG, A, T, B, H = (2, 5, 5), 3, 6, 4, 8
MODEL = dict(channels=(4,), kernel_sizes=(3,), strides=(1,), paddings=(0,),
             fc_sizes=(16,), obs_divisor=1.0)
CLOSE = dict(rtol=1e-5, atol=1e-6)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def load(model, params):
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           from_jax_params(np_tree(params)).items()})


def assert_state_close(model, params, **tol):
    want = from_jax_params(np_tree(params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **tol)


def t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# Returns
# ---------------------------------------------------------------------------

def return_inputs(seed=0, T_=9, B_=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T_, B_)).astype(np.float32),
            rng.standard_normal((T_, B_)).astype(np.float32),
            rng.random((T_, B_)) < 0.25,
            rng.standard_normal(B_).astype(np.float32))


def test_discount_return_matches_jax():
    reward, _, done, boot = return_inputs(0)
    want = jax_returns.discount_return(jnp.asarray(reward), jnp.asarray(done),
                                       jnp.asarray(boot), 0.97)
    got = returns.discount_return(t(reward), t(done), t(boot), 0.97)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_gae_matches_jax():
    reward, value, done, boot = return_inputs(1)
    adv, ret = jax_returns.generalized_advantage_estimation(
        *map(jnp.asarray, (reward, value, done, boot)), 0.99, 0.95)
    got_adv, got_ret = returns.generalized_advantage_estimation(
        *map(t, (reward, value, done, boot)), 0.99, 0.95)
    np.testing.assert_allclose(got_adv.numpy(), np.asarray(adv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got_ret.numpy(), np.asarray(ret), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Categorical
# ---------------------------------------------------------------------------

def dist_inputs(seed=2):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((7, 5, 6)).astype(np.float32) * 3
    logits[0, 0, 2] = -40.0          # a probability below EPS
    p = np.asarray(jax.nn.softmax(logits, axis=-1))
    q = np.asarray(jax.nn.softmax(np.roll(logits, 1, axis=-1), axis=-1))
    x = rng.integers(0, 6, (7, 5)).astype(np.int32)
    x[0, 0] = 2
    return p, q, x


def test_categorical_matches_jax():
    p, q, x = dist_inputs()
    jd, d = JaxCategorical(6), Categorical(6)
    jp, jq = JaxDistInfo(jnp.asarray(p)), JaxDistInfo(jnp.asarray(q))
    tp, tq = DistInfo(t(p)), DistInfo(t(q))
    pairs = [(d.log_likelihood(t(x), tp), jd.log_likelihood(x, jp)),
             (d.likelihood_ratio(t(x), tp, tq),
              jd.likelihood_ratio(x, jp, jq)),
             (d.kl(tp, tq), jd.kl(jp, jq)),
             (d.entropy(tp), jd.entropy(jp)),
             (d.perplexity(tp), jd.perplexity(jp)),
             (d.mean_kl(tp, tq), jd.mean_kl(jp, jq)),
             (d.mean_entropy(tp), jd.mean_entropy(jp))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)


def test_categorical_sample_with_jax_noise_gives_jax_actions():
    p, _, _ = dist_inputs(3)
    key = jax.random.key(11)
    want = JaxCategorical(6).sample(key, JaxDistInfo(jnp.asarray(p)))
    noise = jax.random.gumbel(key, p.shape)
    got = Categorical(6).sample(DistInfo(t(p)), gumbel_noise=t(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Without injected noise the generator draws it: a valid action.
    drawn = Categorical(6).sample(DistInfo(t(p)),
                                  torch.Generator().manual_seed(0))
    assert drawn.shape == (7, 5) and int(drawn.max()) < 6


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

OPTIMS = {"adam": dict(optim="adam"),
          "adam_linear_schedule": dict(optim="adam", schedule=True),
          "rmsprop": dict(optim="rmsprop"),
          "rmsprop_centered": dict(optim="rmsprop", centered=True)}


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_optimizer_matches_optax(name, clip):
    """Six steps on fixed grads, some above the clip norm and some below;
    the schedule reaches 0 after four updates and stays there."""
    kw = dict(OPTIMS[name])
    schedule = kw.pop("schedule", False)
    tol = (dict(rtol=1e-5, atol=1e-6) if kw["optim"] == "adam"
           else dict(rtol=1e-6, atol=1e-7))
    lr, total = 0.01, 4
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(x) for x in init]
    jopt = jax_make_optimizer(
        lr, clip, schedule=(optax.linear_schedule(lr, 0.0, total)
                            if schedule else None), **kw)
    jstate = jopt.init(jparams)
    params = [nn.Parameter(torch.tensor(x)) for x in init]
    opt = make_optimizer(params, lr, clip,
                         schedule_steps=total if schedule else None, **kw)
    for k in range(6):
        scale = (0.05, 0.6, 0.2, 1.0, 0.1, 0.8)[k]
        grads = [(rng.standard_normal(s) * scale).astype(np.float32)
                 for s in shapes]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads],
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        norm = opt.step()
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm([jnp.asarray(g)
                                                  for g in grads])),
            rtol=1e-6)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       err_msg=f"step {k}", **tol)
    if schedule:
        want = optax.linear_schedule(lr, 0.0, total)
        assert [opt.lr(k) for k in range(7)] == [float(want(k))
                                                 for k in range(7)]


# ---------------------------------------------------------------------------
# Models, agents
# ---------------------------------------------------------------------------

def make_agents(recurrent, jax_lstm_impl="scan", seed=0):
    """A JAX agent and its port twin on the same weights, bound to [2, 5, 5]
    binary planes and 3 actions."""
    jspaces = JaxEnvSpaces(JaxIntBox(0, 2, IMG, jnp.uint8), JaxIntBox(0, A))
    spaces = EnvSpaces(IntBox(0, 2, IMG, torch.uint8), IntBox(0, A))
    if recurrent:
        jagent = JaxRecPgAgent(
            ModelCls=JaxAtariLstmModel,
            model_kwargs=dict(MODEL, lstm_size=H, lstm_impl=jax_lstm_impl))
        agent = RecurrentCategoricalPgAgent(
            model_kwargs=dict(MODEL, lstm_size=H), device="cpu")
    else:
        jagent = JaxPgAgent(ModelCls=JaxAtariFfModel, model_kwargs=MODEL)
        agent = CategoricalPgAgent(model_kwargs=MODEL, device="cpu")
    jagent.initialize(jspaces)
    agent.initialize(spaces)
    return jagent, agent


def init_params(jagent, agent, seed=0):
    obs = jnp.zeros((B,) + IMG, jnp.uint8)
    params = jagent.init(jax.random.key(seed), obs)
    load(agent.model, params)
    return params


def rnn_state(rng, *lead):
    return tuple((0.5 * rng.standard_normal(lead + (H,))).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("impl", ["ff", "scan", "pallas_interpret"])
def test_pg_model_matches_jax(impl):
    """Both models over a [T, B] window with dones, through params.py; the
    LSTM model against the JAX scan and the Pallas kernel (interpret)."""
    recurrent = impl != "ff"
    jagent, agent = make_agents(recurrent, impl if recurrent else "scan")
    params = init_params(jagent, agent)
    rng = np.random.default_rng(5)
    obs = rng.integers(0, 2, (T, B) + IMG).astype(np.uint8)
    pa = rng.integers(0, A, (T, B)).astype(np.int32)
    pr = rng.standard_normal((T, B)).astype(np.float32)
    if recurrent:
        done = rng.random((T, B)) < 0.3
        state = rnn_state(rng, B)
        jpi, jv, (jh, jc) = jagent.model.apply(
            params, obs, pa, pr, tuple(map(jnp.asarray, state)),
            jnp.asarray(done))
        with torch.no_grad():
            pi, v, (h, c) = agent.model(t(obs), t(pa), t(pr),
                                        tuple(map(t, state)), t(done))
        pairs = [(pi, jpi), (v, jv), (h, jh), (c, jc)]
    else:
        jpi, jv = jagent.model.apply(params, obs, pa, pr)
        with torch.no_grad():
            pi, v = agent.model(t(obs), t(pa), t(pr))
        pairs = [(pi, jpi), (v, jv)]
    assert pi.shape == (T, B, A) and v.shape == (T, B)
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    back = to_jax_params(agent.model.state_dict(), None)
    jax.tree.map(np.testing.assert_array_equal, back, np_tree(params))


@pytest.mark.parametrize("is_eval", [False, True])
@pytest.mark.parametrize("recurrent", [False, True])
def test_agent_step_matches_jax(recurrent, is_eval):
    """One collection step: JAX's Gumbel noise gives JAX's actions;
    evaluation takes the argmax of the logits."""
    jagent, agent = make_agents(recurrent)
    params = init_params(jagent, agent, seed=1)
    rng = np.random.default_rng(6)
    obs = rng.integers(0, 2, (B,) + IMG).astype(np.uint8)
    pa = rng.integers(0, A, B).astype(np.int32)
    pr = rng.standard_normal(B).astype(np.float32)
    carry = rnn_state(rng, B) if recurrent else None
    key = jax.random.key(2)
    jstep, jcarry = jagent.step(
        params, key, obs, pa, pr,
        None if carry is None else tuple(map(jnp.asarray, carry)),
        StepCtx(jnp.zeros((), jnp.int32), is_eval))
    step, next_carry = agent.step(
        t(obs), t(pa), t(pr), None if carry is None else tuple(map(t, carry)),
        0, None, is_eval=is_eval,
        gumbel=t(jax.random.gumbel(key, (B, A))))
    np.testing.assert_array_equal(step.action.numpy(),
                                  np.asarray(jstep.action))
    info, jinfo = step.agent_info, jstep.agent_info
    np.testing.assert_allclose(info["dist_info"].prob.numpy(),
                               np.asarray(jinfo["dist_info"].prob), **CLOSE)
    np.testing.assert_allclose(info["value"].numpy(),
                               np.asarray(jinfo["value"]), **CLOSE)
    if recurrent:
        for got, want, before in zip(next_carry, jcarry, carry):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **CLOSE)
        for got, before in zip(info["prev_rnn_state"], carry):
            np.testing.assert_array_equal(got.numpy(), before)
        value = agent.value(t(obs), t(pa), t(pr), tuple(map(t, carry)))
        jvalue = jagent.value(params, obs, pa, pr,
                              tuple(map(jnp.asarray, carry)))
    else:
        assert next_carry is None
        value, jvalue = (agent.value(t(obs), t(pa), t(pr)),
                         jagent.value(params, obs, pa, pr))
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), **CLOSE)


# ---------------------------------------------------------------------------
# A2C and PPO
# ---------------------------------------------------------------------------

def make_batch(recurrent, seed=7):
    """A [T, B] batch as the collector gives it, and the collector's state
    after it, for both packages."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 2, (T + 1, B) + IMG).astype(np.uint8)
    pa = rng.integers(0, A, (T + 1, B)).astype(np.int32)
    pr = (rng.random((T + 1, B)) < 0.3).astype(np.float32)
    logits = rng.standard_normal((T, B, A)).astype(np.float32)
    prob = np.asarray(jax.nn.softmax(logits, axis=-1))
    info = dict(value=rng.standard_normal((T, B)).astype(np.float32))
    last = dict(observation=obs[T], prev_action=pa[T], prev_reward=pr[T],
                agent_carry=rnn_state(rng, B) if recurrent else None)
    if recurrent:
        info["prev_rnn_state"] = rnn_state(rng, T, B)
    fields = dict(observation=obs[:T],
                  action=rng.integers(0, A, (T, B)).astype(np.int32),
                  reward=pr[1:], done=rng.random((T, B)) < 0.2,
                  prev_action=pa[:T], prev_reward=pr[:T], env_info={})
    jax_s = JaxSamples(agent_info=dict(
        jax.tree.map(jnp.asarray, info),
        dist_info=JaxDistInfo(jnp.asarray(prob))),
        **jax.tree.map(jnp.asarray, fields))
    torch_s = Samples(agent_info=dict(
        jax.tree.map(t, info), dist_info=DistInfo(t(prob))),
        **{k: (t(v) if k != "env_info" else {}) for k, v in fields.items()})
    torch_s = torch_s._replace(action=torch_s.action.long())
    jax_rs = SimpleNamespace(**jax.tree.map(jnp.asarray, last))
    torch_rs = SimpleNamespace(**jax.tree.map(t, last), cum_steps=T * B)
    return jax_s, torch_s, jax_rs, torch_rs


def make_algos(JaxCls, Cls, recurrent, n_itr=1, **algo_kw):
    jagent, agent = make_agents(recurrent)
    jalgo, algo = JaxCls(**algo_kw), Cls(**algo_kw)
    obs = jnp.zeros((B,) + IMG, jnp.uint8)
    train_state, _ = jalgo.initialize(jagent, JaxBatchSpec(T, B), obs,
                                      jax.random.key(3), n_itr=n_itr)
    load(agent.model, train_state.params)
    algo.initialize(agent, BatchSpec(T, B), torch.zeros((B,) + IMG),
                    torch.Generator().manual_seed(0), n_itr=n_itr)
    return jalgo, algo, train_state


def grads_of(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def assert_grads_close(got, jax_grads):
    want = from_jax_params(np_tree(jax_grads))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **CLOSE)


def assert_info_close(info, jinfo):
    for field in ("loss", "grad_norm", "entropy", "perplexity"):
        np.testing.assert_allclose(float(getattr(info, field)),
                                   float(getattr(jinfo, field)),
                                   err_msg=field, **CLOSE)


@pytest.mark.parametrize("gae_lambda", [1.0, 0.95])
@pytest.mark.parametrize("recurrent", [False, True])
def test_a2c_matches_jax(recurrent, gae_lambda):
    """A2C's loss and grads, then one optimize (clip, RMSprop) against
    the JAX A2C: loss, grad norm, entropy, perplexity and the params."""
    kw = dict(discount=0.99, learning_rate=3e-3, gae_lambda=gae_lambda,
              entropy_loss_coeff=0.01, clip_grad_norm=0.5)
    jalgo, algo, train_state = make_algos(JaxA2C, A2C, recurrent, **kw)
    jax_s, torch_s, jax_rs, torch_rs = make_batch(recurrent)
    params = train_state.params
    boot = jalgo.bootstrap(params, jax_rs)
    init = (jax.tree.map(lambda x: x[0], jax_s.agent_info["prev_rnn_state"])
            if recurrent else None)
    (jloss, (jent, _)), jgrads = jax.value_and_grad(
        jalgo.loss, has_aux=True)(params, jax_s, boot, init)
    tinit = (tuple(x[0] for x in torch_s.agent_info["prev_rnn_state"])
             if recurrent else None)
    loss, entropy, _ = algo.loss(torch_s, algo.bootstrap(torch_rs), tinit)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), **CLOSE)
    np.testing.assert_allclose(float(entropy), float(jent), **CLOSE)
    assert_grads_close(grads_of(algo.agent.model), jgrads)

    new_state, _, jinfo = jalgo.optimize(train_state, None, jax_s,
                                         jax.random.key(0), jax_rs)
    info = algo.optimize(torch_s, torch_rs)
    assert_info_close(info, jinfo)
    assert algo.update_counter == 1 and algo.updates_per_optimize == 1
    assert_state_close(algo.agent.model, new_state.params, **CLOSE)


def jax_first_minibatch_grads(jalgo, params, jax_s, jax_rs, idxs,
                              recurrent):
    """The grads of JAX PPO's first minibatch, built as its optimize
    builds it."""
    ret, adv, _ = jalgo.process_returns(jax_s,
                                        jalgo.bootstrap(params, jax_rs))
    data = {"observation": jax_s.observation,
            "prev_action": jax_s.prev_action,
            "prev_reward": jax_s.prev_reward, "action": jax_s.action,
            "old_dist_info": jax_s.agent_info["dist_info"],
            "return_": ret, "advantage": adv}
    if recurrent:
        data["done_shifted"] = jalgo.shifted_done(jax_s.done)
        mb = jax.tree.map(lambda x: jnp.take(x, idxs, axis=1), data)
        mb["init_rnn_state"] = jax.tree.map(
            lambda x: jnp.take(x[0], idxs, axis=0),
            jax_s.agent_info["prev_rnn_state"])
        valid = jnp.ones((T, len(idxs)), jnp.float32)
    else:
        data = jax.tree.map(lambda x: x.reshape((T * B,) + x.shape[2:]),
                            data)
        mb = jax.tree.map(lambda x: jnp.take(x, idxs, axis=0), data)
        valid = jnp.ones((len(idxs),), jnp.float32)
    return jax.grad(lambda p: jalgo._surrogate_loss(p, mb, valid)[0])(
        params)


@pytest.mark.parametrize("recurrent", [False, True])
def test_ppo_matches_jax(recurrent):
    """PPO.optimize with JAX's permutations: 2 epochs x 2 minibatches
    (over lanes if recurrent, over T*B samples if not), GAE, normalized
    advantages, clip, Adam and the linear schedule over 3 iterations:
    the first minibatch's grads, the averaged infos and the params."""
    kw = dict(discount=0.99, learning_rate=3e-3, epochs=2, minibatches=2,
              ratio_clip=0.1, gae_lambda=0.95, normalize_advantage=True,
              clip_grad_norm=1.0)
    jalgo, algo, train_state = make_algos(JaxPPO, PPO, recurrent, n_itr=3,
                                          **kw)
    jax_s, torch_s, jax_rs, torch_rs = make_batch(recurrent, seed=8)
    key = jax.random.key(9)
    n_items = B if recurrent else T * B
    perms = np.stack([np.asarray(jax.random.permutation(k, n_items))
                      for k in jax.random.split(key, 2)])
    jgrads = jax_first_minibatch_grads(jalgo, train_state.params, jax_s,
                                       jax_rs, perms[0][:n_items // 2],
                                       recurrent)
    first = []
    step = algo.optimizer.step

    def spy():
        if not first:
            first.append(grads_of(algo.agent.model))
        return step()

    algo.optimizer.step = spy
    new_state, _, jinfo = jalgo.optimize(train_state, None, jax_s, key,
                                         jax_rs)
    info = algo.optimize(torch_s, torch_rs, permutations=t(perms))
    assert_grads_close(first[0], jgrads)
    assert_info_close(info, jinfo)
    assert algo.update_counter == int(new_state.update_counter) == 4
    assert algo.updates_per_optimize == 4
    assert_state_close(algo.agent.model, new_state.params, **CLOSE)


def test_ppo_draws_its_own_permutations():
    """Without injected permutations, PPO draws one per epoch from its
    generator: every lane (or sample) once per epoch."""
    _, algo, _ = make_algos(JaxPPO, PPO, True, epochs=3, minibatches=2)
    _, torch_s, _, torch_rs = make_batch(True)
    seen = []
    real = torch.randperm

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    torch.randperm = spy
    try:
        info = algo.optimize(torch_s, torch_rs)
    finally:
        torch.randperm = real
    assert len(seen) == 3 and all(sorted(p.tolist()) == list(range(B))
                                  for p in seen)
    assert all(math.isfinite(float(x)) for x in info)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

class JaxCartPoleModel(fnn.Module):
    n_actions: int

    @fnn.compact
    def __call__(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T_, B_, shape = jax_lead_dims(observation, 1)
        x = observation.reshape((T_ * B_,) + shape).astype(jnp.float32)
        x = JaxMlpModel((16,))(x)
        pi, v = fnn.Dense(self.n_actions)(x), fnn.Dense(1)(x)[..., 0]
        return jax_restore_dims((pi, v), lead_dim, T_, B_)


class CartPoleModel(nn.Module):
    """The twin of JaxCartPoleModel; ``image_shape`` is the observation's
    shape, as the PG agents pass it."""

    def __init__(self, image_shape, n_actions):
        super().__init__()
        self.fc = MlpModel(image_shape[0], (16,))
        self.pi, self.value = dense(16, n_actions), dense(16, 1)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T_, B_, shape = infer_leading_dims(observation, 1)
        x = self.fc(observation.reshape((T_ * B_,) + shape))
        return restore_leading_dims((self.pi(x), self.value(x)[..., 0]),
                                    lead_dim, T_, B_)


def jax_reset_values(key, n):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (4,), minval=-0.05, maxval=0.05))(jax.random.split(key, n)))


@pytest.mark.parametrize("max_trajectories", [None, 5])
def test_evaluate_matches_jax(max_trajectories):
    """Collector.evaluate on CartPole (time limit 30) over 4 lanes and at
    most 60 steps, eval-mode actions, the resets JAX's keys draw: the
    same completed trajectories, returns and lengths; with a cap of 5 the
    port runs on to its next check and must count nothing more."""
    nB, max_T, seed = 4, 60, 13
    jenv, env = JaxCartPole(max_steps=30), CartPole(max_steps=30,
                                                    device="cpu")
    jagent = JaxPgAgent(ModelCls=JaxCartPoleModel)
    agent = CategoricalPgAgent(ModelCls=CartPoleModel, device="cpu")
    jagent.initialize(jenv.spaces)
    agent.initialize(env.spaces)
    params = jagent.init(jax.random.key(1), jnp.zeros((nB, 4)))
    load(agent.model, params)
    key = jax.random.key(seed)
    jstats = JaxCollector(jenv, jagent, JaxBatchSpec(max_T, nB),
                          discount=0.99).evaluate(params, key, max_T,
                                                  max_trajectories)
    # The reset values of init_state, then of every step.
    k_env, k = jax.random.split(key)
    draws = [jax_reset_values(k_env, nB)]
    for _ in range(max_T):
        k, _, _, k_reset = jax.random.split(k, 4)
        draws.append(jax_reset_values(k_reset, nB))
    env.draw_reset = lambda n, g: CartPoleResetDraws(
        torch.tensor(draws.pop(0)))
    stats = Collector(env, agent, BatchSpec(max_T, nB),
                      discount=0.99).evaluate(torch.Generator(), max_T,
                                              max_trajectories)
    assert int(stats.completed) == int(jstats.completed) > 0
    if max_trajectories is not None:
        assert int(stats.completed) >= max_trajectories
        assert len(draws) > 0   # it stopped before max_T
    for field in ("sum_return", "sum_sq_return", "sum_length",
                  "sum_nonzero_rewards", "max_return", "min_return"):
        assert float(getattr(stats, field)) == float(getattr(jstats, field))
    np.testing.assert_allclose(float(stats.sum_discounted_return),
                               float(jstats.sum_discounted_return),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# The four MinAtar configs through build_and_train
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_configs():
    from rlpyt_tpu.experiments.configs.minatar_pg import configs as jconfigs
    assert configs == jconfigs


@pytest.mark.parametrize("config_key", ["a2c", "ppo", "lstm_a2c", "lstm_ppo"])
def test_build_and_train_smoke(config_key, tmp_path):
    """Two iterations of each config on the CPU at small widths, with
    evaluation and a log directory; ``variant.json`` is merged in."""
    save_variant({"algo": {"entropy_loss_coeff": 0.02}}, str(tmp_path))
    overrides = {
        "model": {"channels": (4,), "fc_sizes": (16,),
                  **({"lstm_size": 8} if config_key.startswith("lstm")
                     else {})},
        "runner": {"n_steps": 2 * 8 * 8, "log_interval_steps": 8 * 8},
        "sampler": {"batch_T": 8, "batch_B": 8, "max_decorrelation_steps": 5,
                    "eval_n_envs": 4, "eval_max_steps": 200,
                    "eval_max_trajectories": 3}}
    runner = build_and_train(config_key, str(tmp_path), run_id=1,
                             variant=load_variant(str(tmp_path)),
                             config_overrides=overrides, device="cpu")
    algo = runner.algo
    assert type(algo) is (PPO if config_key.endswith("ppo") else A2C)
    assert algo.entropy_loss_coeff == 0.02
    assert runner.agent.recurrent == config_key.startswith("lstm")
    assert algo.update_counter == 2 * algo.updates_per_optimize
    with open(tmp_path / "run_1" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    for row in rows:
        for key in ("loss", "grad_norm", "entropy", "perplexity"):
            assert math.isfinite(float(row[key]))
        assert int(row["EvalTrajs"]) >= 3
    assert (tmp_path / "run_1" / "params.json").exists()


def test_build_and_train_refuses_a_mesh():
    """``mesh`` builds SyncRl (tests/test_torch_parallel.py), which takes
    a MeshSpec only."""
    with pytest.raises(TypeError, match="SyncRl takes a MeshSpec"):
        build_and_train("ppo", mesh=object(), device="cpu")


def test_update_config_merges_deep():
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    out = update_config(base, {"a": {"c": 5, "e": 6}})
    assert out == {"a": {"b": 1, "c": 5, "e": 6}, "d": 3}
    assert base == {"a": {"b": 1, "c": 2}, "d": 3}


# ---------------------------------------------------------------------------
# The Gaussian half: MuJoCo-style models, agents, A2C and PPO
# ---------------------------------------------------------------------------

OBS_G, A_G = 6, 2
GAUSS_FF = dict(hidden_sizes=(16, 16), normalize_observation=True,
                init_log_std=-0.5)
GAUSS_LSTM = dict(hidden_sizes=(16,), lstm_size=H)


def make_gaussian_agents(recurrent, jax_lstm_impl="scan", seed=0):
    """A JAX Gaussian agent and its port twin on the same weights, bound
    to 6 observations and 2 actions in [-1, 1]."""
    obs = dict(low=[-1e3] * OBS_G, high=[1e3] * OBS_G, shape=(OBS_G,))
    act = dict(low=[-1.0] * A_G, high=[1.0] * A_G, shape=(A_G,))
    jspaces = JaxEnvSpaces(JaxFloatBox(**obs), JaxFloatBox(**act))
    spaces = EnvSpaces(FloatBox(**obs), FloatBox(**act))
    if recurrent:
        jagent = JaxRecGaussianPgAgent(model_kwargs=dict(
            GAUSS_LSTM, lstm_impl=jax_lstm_impl))
        agent = RecurrentGaussianPgAgent(model_kwargs=GAUSS_LSTM,
                                         device="cpu")
    else:
        jagent = JaxGaussianPgAgent(model_kwargs=GAUSS_FF)
        agent = GaussianPgAgent(model_kwargs=GAUSS_FF, device="cpu")
    jagent.initialize(jspaces)
    agent.initialize(spaces)
    params = jagent.init(jax.random.key(seed), jnp.zeros((B, OBS_G)))
    load(agent.model, params)
    return jagent, agent, params


def gaussian_obs(rng, *lead):
    """Observations up to +-20, so that the normalizer's clip at +-10
    binds."""
    return (8.0 * rng.standard_normal(lead + (OBS_G,))).astype(np.float32)


@pytest.mark.parametrize("impl", ["ff", "scan", "pallas_interpret"])
def test_gaussian_model_matches_jax(impl):
    """MujocoFfModel (normalized observations: the statistics stay at
    mean 0, var 1, count 1e-4, so the model only clips at +-10) and
    MujocoLstmModel over a [T, B] window with dones, against the JAX scan
    and the Pallas kernel (interpret); the bridge round-trips the tree,
    the norm_stats collection included."""
    recurrent = impl != "ff"
    jagent, agent, params = make_gaussian_agents(
        recurrent, impl if recurrent else "scan")
    rng = np.random.default_rng(5)
    obs = gaussian_obs(rng, T, B)
    pa = rng.uniform(-1, 1, (T, B, A_G)).astype(np.float32)
    pr = rng.standard_normal((T, B)).astype(np.float32)
    if recurrent:
        done = rng.random((T, B)) < 0.3
        state = rnn_state(rng, B)
        want = jagent.model.apply(params, obs, pa, pr,
                                  tuple(map(jnp.asarray, state)),
                                  jnp.asarray(done))
        with torch.no_grad():
            got = agent.model(t(obs), t(pa), t(pr), tuple(map(t, state)),
                              t(done))
    else:
        norm = params["norm_stats"]["RunningMeanStd_0"]
        np.testing.assert_array_equal(np.asarray(norm["mean"]), 0.0)
        np.testing.assert_array_equal(np.asarray(norm["var"]), 1.0)
        assert float(norm["count"]) == np.float32(1e-4)
        assert np.abs(obs).max() > 10.0
        want = jagent.model.apply(params, obs, pa, pr)
        with torch.no_grad():
            got = agent.model(t(obs), t(pa), t(pr))
        assert torch.equal(agent.model.obs_norm.count,
                           torch.tensor(np.float32(1e-4)))
    assert got[0].shape == (T, B, A_G) and got[2].shape == (T, B)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CLOSE)
    back = to_jax_params(agent.model.state_dict(), None)
    jax.tree.map(np.testing.assert_array_equal, back, np_tree(params))


def test_running_mean_std_update_matches_jax():
    """RunningMeanStd with update=True (which no model of either package
    calls): Chan's update of the statistics, then the clip."""
    from rlpyt_tpu.models.running_norm import RunningMeanStd as JaxRms
    from rlpyt_tpu_torch.models.running_norm import RunningMeanStd

    rng = np.random.default_rng(8)
    xs = [(3.0 * rng.standard_normal((20, OBS_G)) + 2.0).astype(np.float32)
          for _ in range(3)]
    jrms, rms = JaxRms(), RunningMeanStd(OBS_G)
    variables = jrms.init(jax.random.key(0), xs[0])
    for x in xs:
        want, mutated = jrms.apply(variables, x, update=True,
                                   mutable=["norm_stats"])
        variables = mutated
        got = rms(t(x), update=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **CLOSE)
    for name in ("mean", "var", "count"):
        np.testing.assert_allclose(
            getattr(rms, name).detach().numpy(),
            np.asarray(variables["norm_stats"][name]), **CLOSE)


@pytest.mark.parametrize("is_eval", [False, True])
@pytest.mark.parametrize("recurrent", [False, True])
def test_gaussian_agent_step_matches_jax(recurrent, is_eval):
    """One collection step: JAX's normals give JAX's actions; evaluation
    acts with the mean; the recurrent agent stores the carry before the
    step."""
    jagent, agent, params = make_gaussian_agents(recurrent, seed=1)
    rng = np.random.default_rng(6)
    obs = gaussian_obs(rng, B)
    pa = rng.uniform(-1, 1, (B, A_G)).astype(np.float32)
    pr = rng.standard_normal(B).astype(np.float32)
    carry = rnn_state(rng, B) if recurrent else None
    key = jax.random.key(2)
    jstep, jcarry = jagent.step(
        params, key, obs, pa, pr,
        None if carry is None else tuple(map(jnp.asarray, carry)),
        StepCtx(jnp.zeros((), jnp.int32), is_eval))
    step, next_carry = agent.step(
        t(obs), t(pa), t(pr), None if carry is None else tuple(map(t, carry)),
        0, None, is_eval=is_eval, noise=t(jax.random.normal(key, (B, A_G))))
    np.testing.assert_allclose(step.action.numpy(), np.asarray(jstep.action),
                               **CLOSE)
    info, jinfo = step.agent_info, jstep.agent_info
    for got, want in zip(info["dist_info"], jinfo["dist_info"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    np.testing.assert_allclose(info["value"].numpy(),
                               np.asarray(jinfo["value"]), **CLOSE)
    if recurrent:
        for got, want in zip(next_carry, jcarry):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **CLOSE)
        for got, before in zip(info["prev_rnn_state"], carry):
            np.testing.assert_array_equal(got.numpy(), before)
    else:
        assert next_carry is None


def make_gaussian_batch(recurrent, seed=7):
    """A [T, B] Gaussian batch as the collector gives it, and the
    collector's state after it, for both packages."""
    rng = np.random.default_rng(seed)
    obs = gaussian_obs(rng, T + 1, B)
    pa = rng.uniform(-1, 1, (T + 1, B, A_G)).astype(np.float32)
    pr = rng.standard_normal((T + 1, B)).astype(np.float32)
    mean = (0.5 * rng.standard_normal((T, B, A_G))).astype(np.float32)
    log_std = rng.uniform(-1.0, 0.0, (T, B, A_G)).astype(np.float32)
    info = dict(value=rng.standard_normal((T, B)).astype(np.float32))
    last = dict(observation=obs[T], prev_action=pa[T], prev_reward=pr[T],
                agent_carry=rnn_state(rng, B) if recurrent else None)
    if recurrent:
        info["prev_rnn_state"] = rnn_state(rng, T, B)
    fields = dict(observation=obs[:T],
                  action=rng.uniform(-1, 1, (T, B, A_G)).astype(np.float32),
                  reward=pr[1:], done=rng.random((T, B)) < 0.2,
                  prev_action=pa[:T], prev_reward=pr[:T], env_info={})
    jax_s = JaxSamples(agent_info=dict(
        jax.tree.map(jnp.asarray, info),
        dist_info=JaxDistInfoStd(jnp.asarray(mean), jnp.asarray(log_std))),
        **jax.tree.map(jnp.asarray, fields))
    torch_s = Samples(agent_info=dict(
        jax.tree.map(t, info), dist_info=DistInfoStd(t(mean), t(log_std))),
        **{k: (t(v) if k != "env_info" else {}) for k, v in fields.items()})
    jax_rs = SimpleNamespace(**jax.tree.map(jnp.asarray, last))
    torch_rs = SimpleNamespace(**jax.tree.map(t, last), cum_steps=T * B)
    return jax_s, torch_s, jax_rs, torch_rs


def without_count(jax_grads):
    """A JAX gradient tree without norm_stats' count, which the forward
    pass never reads (its gradient is 0, so the optimizer leaves it); the
    port keeps it as a buffer, not a parameter."""
    stats = jax_grads.get("norm_stats")
    if stats is None:
        return jax_grads
    stats = dict(stats["RunningMeanStd_0"])
    assert float(stats.pop("count")) == 0.0
    return {**jax_grads, "norm_stats": {"RunningMeanStd_0": stats}}


def make_gaussian_algos(JaxCls, Cls, recurrent, n_itr=1, **algo_kw):
    jagent, agent, _ = make_gaussian_agents(recurrent)
    jalgo, algo = JaxCls(**algo_kw), Cls(**algo_kw)
    obs = jnp.zeros((B, OBS_G), jnp.float32)
    train_state, _ = jalgo.initialize(jagent, JaxBatchSpec(T, B), obs,
                                      jax.random.key(3), n_itr=n_itr)
    load(agent.model, train_state.params)
    algo.initialize(agent, BatchSpec(T, B), torch.zeros((B, OBS_G)),
                    torch.Generator().manual_seed(0), n_itr=n_itr)
    return jalgo, algo, train_state


@pytest.mark.parametrize("recurrent", [False, True])
def test_gaussian_a2c_matches_jax(recurrent):
    """Gaussian A2C (GAE 0.95, RMSprop, clip): loss, entropy and grads,
    then one optimize: infos and params."""
    kw = dict(discount=0.99, learning_rate=3e-3, gae_lambda=0.95,
              entropy_loss_coeff=0.01, clip_grad_norm=0.5)
    jalgo, algo, train_state = make_gaussian_algos(JaxA2C, A2C, recurrent,
                                                   **kw)
    jax_s, torch_s, jax_rs, torch_rs = make_gaussian_batch(recurrent)
    params = train_state.params
    boot = jalgo.bootstrap(params, jax_rs)
    init = (jax.tree.map(lambda x: x[0], jax_s.agent_info["prev_rnn_state"])
            if recurrent else None)
    (jloss, (jent, _)), jgrads = jax.value_and_grad(
        jalgo.loss, has_aux=True)(params, jax_s, boot, init)
    tinit = (tuple(x[0] for x in torch_s.agent_info["prev_rnn_state"])
             if recurrent else None)
    loss, entropy, _ = algo.loss(torch_s, algo.bootstrap(torch_rs), tinit)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **CLOSE)
    np.testing.assert_allclose(float(entropy.detach()), float(jent), **CLOSE)
    assert_grads_close(grads_of(algo.agent.model), without_count(jgrads))

    new_state, _, jinfo = jalgo.optimize(train_state, None, jax_s,
                                         jax.random.key(0), jax_rs)
    info = algo.optimize(torch_s, torch_rs)
    assert_info_close(info, jinfo)
    assert_state_close(algo.agent.model, new_state.params, **CLOSE)


@pytest.mark.parametrize("recurrent", [False, True])
def test_gaussian_ppo_matches_jax(recurrent):
    """Gaussian PPO with JAX's permutations (2 epochs x 2 minibatches,
    GAE, normalized advantages, clip, Adam, the linear schedule): the
    first minibatch's grads, the infos and the params (to atol 1e-5,
    see below)."""
    kw = dict(discount=0.99, learning_rate=3e-3, epochs=2, minibatches=2,
              ratio_clip=0.2, gae_lambda=0.95, normalize_advantage=True,
              clip_grad_norm=1.0)
    jalgo, algo, train_state = make_gaussian_algos(JaxPPO, PPO, recurrent,
                                                   n_itr=3, **kw)
    jax_s, torch_s, jax_rs, torch_rs = make_gaussian_batch(recurrent, 8)
    key = jax.random.key(9)
    n_items = B if recurrent else T * B
    perms = np.stack([np.asarray(jax.random.permutation(k, n_items))
                      for k in jax.random.split(key, 2)])
    jgrads = jax_first_minibatch_grads(jalgo, train_state.params, jax_s,
                                       jax_rs, perms[0][:n_items // 2],
                                       recurrent)
    first = []
    step = algo.optimizer.step

    def spy():
        if not first:
            first.append(grads_of(algo.agent.model))
        return step()

    algo.optimizer.step = spy
    new_state, _, jinfo = jalgo.optimize(train_state, None, jax_s, key,
                                         jax_rs)
    info = algo.optimize(torch_s, torch_rs, permutations=t(perms))
    assert_grads_close(first[0], without_count(jgrads))
    assert_info_close(info, jinfo)
    assert algo.update_counter == int(new_state.update_counter) == 4
    # atol 1e-5 on the params: an Adam step divides the gradient by its own
    # running magnitude, so an element whose gradient cancels to ~3e-7 on
    # one minibatch (its rounding ~1e-2 relative) moves ~4e-6 otherwise
    # after the next step, at this learning rate of 3e-3.
    assert_state_close(algo.agent.model, new_state.params, rtol=1e-5,
                       atol=1e-5)


@pytest.mark.parametrize("recurrent", [False, True])
def test_gaussian_trainers_run_on_pendulum(recurrent):
    """The collector with continuous actions: float [B, 1] actions and
    prev_action, DistInfoStd in the sample buffers (with no graph), and
    the Gaussian A2C (feedforward) or PPO (recurrent) through MinibatchRl
    for 3 iterations with finite infos."""
    from rlpyt_tpu_torch.envs.classic import Pendulum
    from rlpyt_tpu_torch.runners.train import MinibatchRl

    if recurrent:
        agent = RecurrentGaussianPgAgent(model_kwargs=GAUSS_LSTM,
                                         device="cpu")
        algo = PPO(epochs=2, minibatches=2, learning_rate=1e-3)
    else:
        agent = GaussianPgAgent(model_kwargs=GAUSS_FF, device="cpu")
        algo = A2C(learning_rate=1e-3)
    runner = MinibatchRl(algo, agent, Pendulum(device="cpu"),
                         BatchSpec(8, 4), n_steps=96, log_interval_steps=32,
                         max_decorrelation_steps=5, device="cpu")
    seen = []
    optimize = algo.optimize

    def spy(samples, rollout_state, **kwargs):
        seen.append(samples)
        return optimize(samples, rollout_state, **kwargs)

    algo.optimize = spy
    rows = []
    record = runner.logger.record_tabular
    runner.logger.record_tabular = lambda k, v: (rows.append((k, v)),
                                                 record(k, v))
    runner.train()
    assert len(seen) == 3
    for samples in seen:
        assert samples.action.shape == (8, 4, 1)
        assert samples.prev_action.dtype == torch.float32
        for leaf in samples.agent_info["dist_info"]:
            assert leaf.shape == (8, 4, 1) and not leaf.requires_grad
    assert algo.update_counter == 3 * algo.updates_per_optimize
    for key in ("loss", "grad_norm", "entropy", "perplexity"):
        vals = [v for k, v in rows if k == key]
        assert len(vals) == 3 and all(math.isfinite(v) for v in vals)
