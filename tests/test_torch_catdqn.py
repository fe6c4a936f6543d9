"""Port's C51 / dueling / prioritized DQN pieces against the JAX package,
from bridged weights and numpy inputs: categorical_projection, the
AtariCatDqnModel (dueling and not) and AtariDqnModel(dueling=True), the
weight bridge, CatDqnAgent.step, one CategoricalDQN loss with its
priorities and grads, one Adam + clip step, and the scalar DQN's loss
under importance weights with the priority write-back.

Tolerances (float32 unless said): projection atol=1e-6 (probabilities);
model probabilities atol=1e-5, Q values rtol=1e-4, atol=1e-5 (conv and
dense sums in another order); bfloat16 forward atol = 0.05 max|ref| + 1e-3
(both round to 8 mantissa bits after every layer, at other places); loss,
priorities and grad norm rtol=1e-5, atol=1e-6; each grad rtol=2e-4,
atol=1e-6; params after one Adam step (lr 1e-2) rtol=1e-5, atol=2e-6.

The atom support is injected like every other input: ``jnp.linspace`` and
``torch.linspace`` round a few of 51 atoms one float32 ulp apart (held
below 1e-6 here), which the projection's 1/dz would magnify past the
loss tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlpyt_tpu.agents.base import StepCtx
from rlpyt_tpu.agents.dqn import CatDqnAgent as JaxCatDqnAgent
from rlpyt_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from rlpyt_tpu.algos.base import global_norm, make_optimizer
from rlpyt_tpu.algos.cat_dqn import CategoricalDQN as JaxCategoricalDQN
from rlpyt_tpu.algos.dqn import DQN as JaxDQN
from rlpyt_tpu.envs.base import EnvSpaces as JaxEnvSpaces
from rlpyt_tpu.models.dqn import AtariCatDqnModel as JaxAtariCatDqnModel
from rlpyt_tpu.models.dqn import AtariDqnModel as JaxAtariDqnModel
from rlpyt_tpu.ops.value import categorical_projection as jax_projection
from rlpyt_tpu.replay.base import AgentInputs as JaxAgentInputs
from rlpyt_tpu.replay.base import SamplesFromReplay as JaxSamples
from rlpyt_tpu.replay.base import SamplesToBuffer as JaxSamplesToBuffer
from rlpyt_tpu.replay.prioritized import \
    PrioritizedReplayBuffer as JaxPrioritizedBuffer
from rlpyt_tpu.spaces import IntBox as JaxIntBox
from rlpyt_tpu_torch.agents.dqn import CatDqnAgent, DqnAgent
from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.models.dqn import AtariCatDqnModel, AtariDqnModel
from rlpyt_tpu_torch.ops.value import categorical_projection
from rlpyt_tpu_torch.params import from_jax_params, to_jax_params
from rlpyt_tpu_torch.replay.base import AgentInputs, SamplesFromReplay
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.spaces import IntBox

torch.set_num_threads(2)

K, H, W, A, BS, ATOMS = 4, 52, 40, 6, 16, 11
NARROW = dict(channels=(8, 8, 8), fc_sizes=(32,))
LR = 1e-2
MODELS = {  # name -> (JAX class, port class, extra kwargs)
    "cat": (JaxAtariCatDqnModel, AtariCatDqnModel, dict(n_atoms=ATOMS)),
    "cat_dueling": (JaxAtariCatDqnModel, AtariCatDqnModel,
                    dict(n_atoms=ATOMS, dueling=True)),
    "dqn_dueling": (JaxAtariDqnModel, AtariDqnModel, dict(dueling=True)),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def load(module, tree):
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            from_jax_params(tree).items()})


def frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_categorical_projection_matches_jax():
    rng = np.random.default_rng(0)
    z = np.linspace(-10.0, 10.0, 51).astype(np.float32)
    logits = rng.normal(size=(3, 7, 51)).astype(np.float32) * 2
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ret = (rng.normal(size=(3, 7)) * 8).astype(np.float32)   # some clip
    ret[0, :2] = [-30.0, 30.0]                     # all mass on one end
    nonterminal = (rng.random((3, 7)) < 0.7).astype(np.float32)
    want = np.asarray(jax_projection(
        jnp.asarray(p), jnp.asarray(ret), jnp.asarray(nonterminal),
        jnp.asarray(z), 0.99 ** 3))
    got = categorical_projection(
        torch.tensor(p), torch.tensor(ret), torch.tensor(nonterminal),
        torch.tensor(z), 0.99 ** 3).numpy()
    assert got.shape == (3, 7, 51)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert got[0, 0, 0] == pytest.approx(1.0, abs=1e-5)
    assert got[0, 1, -1] == pytest.approx(1.0, abs=1e-5)


def bridged_pair(name, s2d=True, jdtype=jnp.float32, tdtype=torch.float32,
                 seed=0):
    JaxCls, Cls, extra = MODELS[name]
    jm = JaxCls(n_actions=A, space_to_depth=s2d, compute_dtype=jdtype,
                **NARROW, **extra)
    params = jm.init(jax.random.key(seed), jnp.zeros((2, K, H, W), jnp.uint8))
    tm = Cls((K, H, W), A, compute_dtype=tdtype, **NARROW, **extra)
    load(tm, np_tree(params))
    return jm, params, tm


@pytest.mark.parametrize("lead", [(5,), (2, 3), ()])
@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax_fp32(name, lead):
    jm, params, tm = bridged_pair(name)
    obs = frames(1, lead + (K, H, W))
    ref = np.asarray(jm.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        out = tm(torch.from_numpy(obs)).numpy()
    tail = (A,) if name == "dqn_dueling" else (A, ATOMS)
    assert out.shape == lead + tail and out.dtype == np.float32
    if name == "dqn_dueling":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax_bf16(name):
    jm, params, tm = bridged_pair(name, jdtype=jnp.bfloat16,
                                  tdtype=torch.bfloat16)
    obs = frames(3, (6, K, H, W))
    ref = np.asarray(jm.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        out = tm(torch.from_numpy(obs)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=0.05 * np.abs(ref).max() + 1e-3)
    if name != "dqn_dueling":
        # The softmax runs on float32 logits: each row sums to 1 to
        # float32 rounding, not bfloat16's.
        np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_round_trip(name, s2d):
    _, params, tm = bridged_pair(name, s2d, seed=4)
    back = to_jax_params(tm.state_dict(), 4 if s2d else None)
    ref = np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    jax.tree.map(np.testing.assert_array_equal, back, ref)
    head = {"cat": "MlpModel_0", "cat_dueling": "DistributionalDuelingHead_0",
            "dqn_dueling": "DuelingHead_0"}[name]
    assert head in back["params"]


def env_spaces():
    return (JaxEnvSpaces(JaxIntBox(0, 256, (K, H, W), jnp.uint8),
                         JaxIntBox(0, A)),
            EnvSpaces(IntBox(0, 256, (K, H, W), torch.uint8), IntBox(0, A)))


def cat_agents(dueling=True, **kw):
    model_kwargs = dict(NARROW, dueling=dueling)
    jagent = JaxCatDqnAgent(ModelCls=JaxAtariCatDqnModel,
                            model_kwargs=model_kwargs, n_atoms=ATOMS,
                            v_min=-4.0, v_max=6.0, **kw)
    tagent = CatDqnAgent(model_kwargs=model_kwargs, n_atoms=ATOMS,
                         v_min=-4.0, v_max=6.0, device="cpu", **kw)
    jspaces, tspaces = env_spaces()
    jagent.initialize(jspaces)
    tagent.initialize(tspaces)
    return jagent, tagent


def test_cat_agent_step_matches_jax_with_injected_noise(monkeypatch):
    """The port draws its exploration noise from a torch.Generator; here
    it is handed the values JAX's key draws."""
    B = 12
    jagent, tagent = cat_agents(eps_init=1.0, eps_final=0.1, eps_steps=1000)
    np.testing.assert_allclose(tagent.z.numpy(), np.asarray(jagent.z),
                               rtol=0, atol=1e-6)
    assert tagent.model.n_atoms == ATOMS
    params = jagent.init(jax.random.key(0),
                         jnp.zeros((2, K, H, W), jnp.uint8))
    load(tagent.model, np_tree(params))
    obs = frames(7, (B, K, H, W))
    zeros = np.zeros(B, np.float32)
    key = jax.random.key(3)
    cum_steps = 500                                   # epsilon = 0.55
    jstep, _ = jagent.step(params, key, jnp.asarray(obs), jnp.asarray(zeros),
                           jnp.asarray(zeros), None,
                           StepCtx(jnp.asarray(cum_steps, jnp.int32)))
    k1, k2 = jax.random.split(key)
    rand = np.asarray(jax.random.randint(k1, (B,), 0, A, dtype=jnp.int32))
    unif = np.asarray(jax.random.uniform(k2, (B,)))
    monkeypatch.setattr(torch, "randint",
                        lambda *a, **k: torch.tensor(rand).long())
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.tensor(unif))
    tstep, carry = tagent.step(torch.from_numpy(obs), torch.tensor(zeros),
                               torch.tensor(zeros), None, cum_steps,
                               torch.Generator())
    monkeypatch.undo()
    assert carry is None and set(tstep.agent_info) == {"p"}
    np.testing.assert_allclose(tstep.agent_info["p"].numpy(),
                               np.asarray(jstep.agent_info["p"]), atol=1e-5)
    np.testing.assert_array_equal(tstep.action.numpy(),
                                  np.asarray(jstep.action))
    explore = unif < 0.55
    assert explore.any() and not explore.all()
    # Greedy lanes take the argmax of the expected value over the support.
    q = (tstep.agent_info["p"] * tagent.z).sum(-1)
    np.testing.assert_array_equal(tstep.action.numpy()[~explore],
                                  q.argmax(-1).numpy()[~explore])


def fixed_batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (BS, K, H, W), dtype=np.uint8),
        target_obs=rng.integers(0, 256, (BS, K, H, W), dtype=np.uint8),
        action=rng.integers(0, A, BS).astype(np.int32),
        return_=(rng.normal(size=BS) * 2).astype(np.float32),
        done_n=rng.random(BS) < 0.25,
        timeout_n=rng.random(BS) < 0.25,
        is_weights=rng.uniform(0.2, 1.0, BS).astype(np.float32),
        t_idx=rng.choice(8, BS, replace=True).astype(np.int64),
        b_idx=(np.arange(BS) % 2).astype(np.int64))


def jax_batch(b):
    zeros = jnp.zeros(BS)
    return JaxSamples(
        agent_inputs=JaxAgentInputs(jnp.asarray(b["obs"]), zeros, zeros),
        action=jnp.asarray(b["action"]), return_=jnp.asarray(b["return_"]),
        done=jnp.asarray(b["done_n"]), done_n=jnp.asarray(b["done_n"]),
        timeout_n=jnp.asarray(b["timeout_n"]),
        target_inputs=JaxAgentInputs(jnp.asarray(b["target_obs"]), zeros,
                                     zeros),
        is_weights=jnp.asarray(b["is_weights"]),
        indices=(jnp.asarray(b["t_idx"]), jnp.asarray(b["b_idx"])))


def torch_batch(b):
    zeros = torch.zeros(BS)
    t = {k: torch.tensor(v) for k, v in b.items()}
    return SamplesFromReplay(
        agent_inputs=AgentInputs(t["obs"], zeros, zeros),
        action=t["action"].long(), return_=t["return_"], done=t["done_n"],
        done_n=t["done_n"], timeout_n=t["timeout_n"],
        target_inputs=AgentInputs(t["target_obs"], zeros, zeros),
        is_weights=t["is_weights"], indices=(t["t_idx"], t["b_idx"]))


def jax_update(jagent, jalgo, b, clip):
    ex = jnp.zeros((2, K, H, W), jnp.uint8)
    params = jagent.init(jax.random.key(0), ex)
    target = jagent.init(jax.random.key(1), ex)
    jalgo.agent = jagent
    (loss, pri), grads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        params, target, jax_batch(b))
    opt = make_optimizer(LR, clip, "adam", eps=0.01 / BS)
    updates, _ = opt.update(grads, opt.init(params), params)
    return dict(params=np_tree(params), target=np_tree(target),
                loss=float(loss), priorities=np.asarray(pri),
                grads=np_tree(grads), grad_norm=float(global_norm(grads)),
                new_params=np_tree(optax.apply_updates(params, updates)))


ALGO_KW = dict(batch_size=BS, discount=0.9, n_step_return=3,
               learning_rate=LR, prioritized_replay=True, pri_alpha=0.5,
               pri_beta=0.4)


def cat_sides(b, clip, double_dqn, dueling):
    jagent, tagent = cat_agents(dueling)
    kw = dict(ALGO_KW, double_dqn=double_dqn, clip_grad_norm=clip)
    jalgo = JaxCategoricalDQN(frame_buffer=True, **kw)
    jalgo.v_min, jalgo.v_max, jalgo.n_atoms = -4.0, 6.0, ATOMS
    ref = jax_update(jagent, jalgo, b, clip)
    # The algorithm's own defaults differ from the agent's support: the
    # agent's must win.
    algo = CategoricalDQN(replay_size=64, v_min=-10.0, v_max=10.0,
                          n_atoms=51, frame_buffer=True, **kw)
    algo.initialize(tagent, BatchSpec(T=8, B=2),
                    torch.zeros((2, K, H, W), dtype=torch.uint8),
                    torch.Generator().manual_seed(0))
    assert (algo.v_min, algo.v_max, algo.n_atoms) == (-4.0, 6.0, ATOMS)
    np.testing.assert_allclose(algo.z.numpy(), np.asarray(jalgo.z), rtol=0,
                               atol=1e-6)
    algo.z = torch.tensor(np.asarray(jalgo.z))
    load(tagent.model, ref["params"])
    load(algo.target_model, ref["target"])
    return ref, algo


def assert_grads_match(algo, ref):
    want = from_jax_params(ref["grads"])
    got = {k: p.grad.numpy() for k, p in algo.model.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("double_dqn", [True, False])
def test_cat_loss_priorities_and_grads_match_jax(double_dqn, dueling):
    b = fixed_batch()
    ref, algo = cat_sides(b, 10.0, double_dqn, dueling)
    loss, pri = algo.loss(torch_batch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5,
                               atol=1e-6)
    assert not pri.requires_grad
    np.testing.assert_allclose(pri.numpy(), ref["priorities"], rtol=1e-5,
                               atol=1e-6)
    # Timed-out samples carry no priority; the others a positive |KL|.
    assert (pri.numpy()[b["timeout_n"]] == 0).all()
    assert (pri.numpy()[~b["timeout_n"]] > 0).all()
    assert_grads_match(algo, ref)


@pytest.mark.parametrize("clip", [10.0, 1e-3])
def test_cat_adam_clip_step_and_write_back_match_jax(clip):
    """clip=1e-3 is far below the grad norm, so the clip scales grads.
    After the step the batch's |KL| sits in the replay's priorities."""
    b = fixed_batch(1)
    ref, algo = cat_sides(b, clip, True, True)
    if clip < 1.0:
        assert ref["grad_norm"] > 10 * clip
    info = algo.update(torch_batch(b))
    np.testing.assert_allclose(info.grad_norm.item(), ref["grad_norm"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(info.loss.item(), ref["loss"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(info.td_abs_err.item(),
                               ref["priorities"].mean(), rtol=1e-5, atol=1e-6)
    want = from_jax_params(ref["new_params"])
    for k, p in algo.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5,
                                   atol=2e-6, err_msg=k)
    assert_write_back_matches(algo, b, ref["priorities"])


def assert_write_back_matches(algo, b, priorities):
    """The port's buffer after ``update`` against the JAX buffer's
    ``update_priorities`` on the same indices.  Indices repeat; every
    repeat writes a different value, so compare where they are unique."""
    jbuf = JaxPrioritizedBuffer(size=64, B=2, sample_T=8, alpha=0.5,
                                beta=0.4)
    state = jbuf.init(JaxSamplesToBuffer(
        observation=jnp.zeros((3,), jnp.uint8),
        action=jnp.zeros((), jnp.int32), reward=jnp.zeros((), jnp.float32),
        done=jnp.zeros((), jnp.bool_), timeout=jnp.zeros((), jnp.bool_)))
    state = jbuf.update_priorities(
        state, (jnp.asarray(b["t_idx"]), jnp.asarray(b["b_idx"])),
        jnp.asarray(priorities))
    flat = b["t_idx"] * 2 + b["b_idx"]
    uniq = np.array([np.sum(flat == f) == 1 for f in flat])
    assert uniq.sum() >= 3
    got = algo.replay.priorities.numpy()
    want = np.asarray(state.priorities)
    np.testing.assert_allclose(got[b["t_idx"][uniq], b["b_idx"][uniq]],
                               want[b["t_idx"][uniq], b["b_idx"][uniq]],
                               rtol=1e-5, atol=1e-7)
    untouched = np.ones_like(got, bool)
    untouched[b["t_idx"], b["b_idx"]] = False
    assert (got[untouched] == 0).all()
    np.testing.assert_allclose(float(algo.replay.max_priority),
                               float(state.max_priority), rtol=1e-5)


def test_per_dqn_loss_weights_and_write_back_match_jax():
    """The scalar DQN on a dueling model: the loss multiplies the
    importance weights, and ``update`` writes |delta| back."""
    b = fixed_batch(2)
    model_kwargs = dict(NARROW, dueling=True)
    jagent = JaxDqnAgent(ModelCls=JaxAtariDqnModel, model_kwargs=model_kwargs)
    tagent = DqnAgent(model_kwargs=model_kwargs, device="cpu")
    jspaces, tspaces = env_spaces()
    jagent.initialize(jspaces)
    tagent.initialize(tspaces)
    kw = dict(ALGO_KW, double_dqn=True, clip_grad_norm=10.0)
    ref = jax_update(jagent, JaxDQN(frame_buffer=True, **kw), b, 10.0)
    algo = DQN(replay_size=64, frame_buffer=True, **kw)
    algo.initialize(tagent, BatchSpec(T=8, B=2),
                    torch.zeros((2, K, H, W), dtype=torch.uint8),
                    torch.Generator().manual_seed(0))
    load(tagent.model, ref["params"])
    load(algo.target_model, ref["target"])
    batch = torch_batch(b)
    loss, td_abs = algo.loss(batch)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(td_abs.numpy(), ref["priorities"], rtol=1e-5,
                               atol=1e-6)
    unweighted, _ = algo.loss(batch._replace(is_weights=torch.ones(BS)))
    assert unweighted.item() > loss.item() * 1.2
    loss.backward()
    assert_grads_match(algo, ref)
    algo.optimizer.zero_grad()
    algo.update(batch)
    assert_write_back_matches(algo, b, ref["priorities"])


def test_uniform_dqn_writes_no_priorities():
    tagent = DqnAgent(model_kwargs=NARROW, device="cpu")
    tagent.initialize(env_spaces()[1])
    algo = DQN(batch_size=BS, replay_size=64, frame_buffer=True)
    algo.initialize(tagent, BatchSpec(T=8, B=2),
                    torch.zeros((2, K, H, W), dtype=torch.uint8),
                    torch.Generator().manual_seed(0))
    assert not hasattr(algo.replay, "priorities")
    algo.update(torch_batch(fixed_batch(3)))
    assert algo.update_counter == 1
