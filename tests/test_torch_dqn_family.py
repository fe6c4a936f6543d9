"""The port's DQN family on vector observations against the JAX package,
on the CPU: the Composite space and the tree-observation flattening,
DqnMlpModel and R2d1MlpModel (weights carried by params.py), the agent's
model sizes, and DQN updates through ``make_optimizer`` (centered RMSprop
and Adam) against the JAX DQN.

Tolerances (float32 throughout):
- the flattened tree observation and the bridge's round trip: bit for bit;
- model outputs and recurrent states: rtol 1e-5, atol 1e-5;
- a DQN update: loss and grad norm at rtol 1e-5, atol 1e-6, and every
  parameter within 1e-5 of the largest change any parameter made.  The
  Adam case steps at lr 5e-2, so that the largest change (about lr) is
  far above a parameter's float32 spacing (6e-8 at 0.5): at lr 1e-3 one
  rounding of a parameter is already 3e-5 of the change.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlpyt_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from rlpyt_tpu.algos.dqn import DQN as JaxDQN
from rlpyt_tpu.envs.classic import DictObsCartPole as JaxDictObsCartPole
from rlpyt_tpu.models.dqn import DqnMlpModel as JaxDqnMlpModel
from rlpyt_tpu.models.dqn import R2d1MlpModel as JaxR2d1MlpModel
from rlpyt_tpu.replay.base import AgentInputs as JaxAgentInputs
from rlpyt_tpu.replay.base import SamplesFromReplay as JaxSamples
from rlpyt_tpu.samplers.rollout import BatchSpec as JaxBatchSpec
from rlpyt_tpu.struct import (
    infer_leading_dims_tree as jax_infer_leading_dims_tree,
)
from rlpyt_tpu_torch.agents.dqn import DqnAgent, R2d1Agent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.classic import (
    Acrobot,
    CartPole,
    DictObsCartPole,
    MountainCar,
)
from rlpyt_tpu_torch.envs.minatar import Breakout
from rlpyt_tpu_torch.models.dqn import (
    AtariDqnModel,
    DqnMlpModel,
    R2d1MlpModel,
)
from rlpyt_tpu_torch.params import from_jax_params, to_jax_params
from rlpyt_tpu_torch.replay.base import AgentInputs, SamplesFromReplay
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.spaces import Composite, FloatBox
from rlpyt_tpu_torch.struct import infer_leading_dims_tree

torch.set_num_threads(2)

CLOSE = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.tensor(np.asarray(x))


def load(model, tree):
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           from_jax_params(np_tree(tree)).items()})


# --------------------------------------------------------------- Composite


def test_composite_space_matches_jax():
    """DictObsCartPole's Composite: the same keys and bounds as JAX's; a
    sample draws the subspaces in dict order from one generator."""
    jspace = JaxDictObsCartPole().observation_space
    space = DictObsCartPole(device="cpu").observation_space
    assert isinstance(space, Composite)
    assert list(space.spaces) == list(jspace.spaces) == ["position",
                                                          "velocity"]
    for name, sub in space.spaces.items():
        np.testing.assert_array_equal(sub.low, jspace.spaces[name].low)
        np.testing.assert_array_equal(sub.high, jspace.spaces[name].high)
        assert sub.shape == jspace.spaces[name].shape == (2,)
    x = space.sample(torch.Generator().manual_seed(4), (7,))
    g = torch.Generator().manual_seed(4)
    for name, sub in space.spaces.items():
        assert torch.equal(x[name], sub.sample(g, (7,)))
        assert (x[name] >= torch.tensor(sub.low)).all()
        assert (x[name] <= torch.tensor(sub.high)).all()
    null = space.null_value("cpu")
    assert list(null) == ["position", "velocity"]
    assert all(torch.equal(v, torch.zeros(2)) for v in null.values())


@pytest.mark.parametrize("lead", [(), (5,), (3, 5)])
def test_tree_flattening_sorts_keys_as_jax(lead):
    """A dict whose insertion order is not sorted, nested and of mixed
    dtypes and widths, flattens to JAX's [T*B, F] bit for bit: the leaves
    are concatenated in sorted-key order, not insertion order."""
    rng = np.random.default_rng(0)
    obs = {"zeta": rng.standard_normal(lead + (3,)).astype(np.float32),
           "alpha": rng.integers(0, 5, lead + (2,)).astype(np.int32),
           "mid": {"b": rng.standard_normal(lead + (1,)).astype(np.float32),
                   "a": rng.standard_normal(lead + (4,)).astype(np.float32)}}
    assert list(obs) != sorted(obs)
    want = jax_infer_leading_dims_tree(
        jax.tree.map(jnp.asarray, obs), 1)
    got = infer_leading_dims_tree(
        {k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else t(v)) for k, v in obs.items()}, 1)
    assert got[:3] == tuple(want[:3])
    assert got[3].dtype == torch.float32 and got[3].shape[-1] == 10
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # alpha (2 columns) comes first, zeta (3) last
    np.testing.assert_array_equal(got[3][:, :2].numpy(),
                                  obs["alpha"].reshape(-1, 2))


# ------------------------------------------------------------------ models


T_, B_, A_ = 4, 3, 3


def dict_obs(rng, lead):
    """A dict observation (velocity before position, as insertion order)."""
    return {"velocity": rng.standard_normal(lead + (2,)).astype(np.float32),
            "position": rng.standard_normal(lead + (3,)).astype(np.float32)}


@pytest.mark.parametrize("obs_kind", ["vector", "dict"])
@pytest.mark.parametrize("dueling", [False, True])
def test_dqn_mlp_model_matches_flax(dueling, obs_kind):
    """DqnMlpModel (MlpModel_0 or DuelingHead_0) against flax over [T, B]
    and [B] inputs, a bare vector or a dict; the bridge round-trips the
    tree bit for bit."""
    rng = np.random.default_rng(1)
    if obs_kind == "vector":
        obs = rng.standard_normal((T_, B_, 5)).astype(np.float32)
        tobs = t(obs)
    else:
        obs = dict_obs(rng, (T_, B_))
        tobs = {k: t(v) for k, v in obs.items()}
    jm = JaxDqnMlpModel(A_, (16, 8), dueling=dueling)
    params = jm.init(jax.random.key(0), jax.tree.map(jnp.asarray, obs))
    model = DqnMlpModel(5, A_, (16, 8), dueling=dueling)
    load(model, params)
    with torch.no_grad():
        q = model(tobs)
        q_b = model(jax.tree.map(lambda x: x[0], tobs))
    np.testing.assert_allclose(q.numpy(), np.asarray(jm.apply(params, obs)),
                               **CLOSE)
    np.testing.assert_allclose(
        q_b.numpy(), np.asarray(jm.apply(params, jax.tree.map(
            lambda x: x[0], obs))), **CLOSE)
    assert q.shape == (T_, B_, A_) and q_b.shape == (B_, A_)
    jax.tree.map(np.testing.assert_array_equal,
                 to_jax_params(model.state_dict(), None), np_tree(params))


def r2d1_inputs(rng, T, B, F, H):
    obs = rng.standard_normal((T, B, F)).astype(np.float32)
    pa = rng.integers(0, A_, (T, B)).astype(np.int32)
    pr = rng.standard_normal((T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.3
    state = tuple((0.5 * rng.standard_normal((B, H))).astype(np.float32)
                  for _ in range(2))
    return obs, pa, pr, done, state


@pytest.mark.parametrize("dueling", [False, True])
@pytest.mark.parametrize("impl", ["scan", "pallas_interpret"])
def test_r2d1_mlp_model_matches_flax(impl, dueling):
    """R2d1MlpModel (MlpModel_0, LstmCore_0, MlpModel_1 or DuelingHead_0)
    against flax over a [T, B] window with dones, the JAX LSTM by
    ``lstm_scan`` and by the Pallas kernel in interpret mode, and over a
    one-step [B] input without dones; the bridge round-trips the tree."""
    F, H = 4, 8
    rng = np.random.default_rng(2)
    obs, pa, pr, done, state = r2d1_inputs(rng, T_, B_, F, H)
    jm = JaxR2d1MlpModel(A_, (16,), lstm_size=H, lstm_impl=impl,
                         dueling=dueling)
    jstate = tuple(map(jnp.asarray, state))
    params = jm.init(jax.random.key(0), obs, pa, pr, jstate, done)
    model = R2d1MlpModel(F, A_, (16,), lstm_size=H, dueling=dueling)
    load(model, params)
    jq, (jh, jc) = jm.apply(params, obs, pa, pr, jstate, done)
    with torch.no_grad():
        q, (h, c) = model(t(obs), t(pa), t(pr), tuple(map(t, state)),
                          t(done))
    assert q.shape == (T_, B_, A_)
    for got, want in ((q, jq), (h, jh), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    jq1, (jh1, _) = jm.apply(params, obs[0], pa[0], pr[0], jstate)
    with torch.no_grad():
        q1, (h1, _) = model(t(obs[0]), t(pa[0]), t(pr[0]),
                            tuple(map(t, state)))
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq1), **CLOSE)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), **CLOSE)
    jax.tree.map(np.testing.assert_array_equal,
                 to_jax_params(model.state_dict(), None), np_tree(params))


@pytest.mark.parametrize("env_cls, input_size", [
    (CartPole, 4), (DictObsCartPole, 4), (Acrobot, 6), (MountainCar, 2)])
def test_agents_size_vector_models(env_cls, input_size):
    """DqnAgent gives a vector model its input size (a Composite's is the
    sum of its leaves); R2d1Agent likewise."""
    spaces = env_cls(device="cpu").spaces
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(8,)), device="cpu")
    agent.initialize(spaces)
    assert agent.model.head.layers[0].in_features == input_size
    assert agent.model.head.layers[-1].out_features == spaces.action.n
    r2d1 = R2d1Agent(ModelCls=R2d1MlpModel, lstm_size=6,
                     model_kwargs=dict(hidden_sizes=(8,)), device="cpu")
    if env_cls is not DictObsCartPole:
        r2d1.initialize(spaces)
        assert r2d1.model.mlp.layers[0].in_features == input_size
        assert r2d1.model.lstm.hidden_size == 6


def test_image_agents_keep_image_shape():
    agent = DqnAgent(model_kwargs=dict(channels=(4,), kernel_sizes=(3,),
                                       strides=(1,), paddings=(0,),
                                       fc_sizes=(8,)), device="cpu")
    agent.initialize(Breakout(device="cpu").spaces)
    assert isinstance(agent.model, AtariDqnModel)
    assert agent.model.conv.convs[0].in_channels == 4


# -------------------------------------------------------------- DQN update


OBS, HID, BS = 4, (32, 32), 32
OPTIMS = {
    # dqn_pub's optimizer (experiments/configs/minatar_dqn.py)
    "rmsprop_centered": dict(optim="rmsprop", learning_rate=2.5e-4,
                             optim_kwargs=dict(decay=0.95, eps=0.01,
                                               centered=True)),
    # DQN's default: Adam at eps 0.01 / batch_size
    "adam": dict(learning_rate=5e-2),
}


def dqn_batch(seed, dict_obs_=False):
    rng = np.random.default_rng(seed)
    b = dict(obs=rng.standard_normal((BS, OBS)).astype(np.float32),
             target_obs=rng.standard_normal((BS, OBS)).astype(np.float32),
             action=rng.integers(0, 2, BS).astype(np.int32),
             return_=rng.standard_normal(BS).astype(np.float32),
             done_n=rng.random(BS) < 0.25, timeout_n=rng.random(BS) < 0.25)
    if dict_obs_:
        for k in ("obs", "target_obs"):
            b[k] = {"position": b[k][:, [0, 2]], "velocity": b[k][:, [1, 3]]}
    return b


def jax_batch(b):
    zeros = jnp.zeros(BS)
    return JaxSamples(
        agent_inputs=JaxAgentInputs(jax.tree.map(jnp.asarray, b["obs"]),
                                    zeros, zeros),
        action=jnp.asarray(b["action"]), return_=jnp.asarray(b["return_"]),
        done=jnp.asarray(b["done_n"]), done_n=jnp.asarray(b["done_n"]),
        timeout_n=jnp.asarray(b["timeout_n"]),
        target_inputs=JaxAgentInputs(
            jax.tree.map(jnp.asarray, b["target_obs"]), zeros, zeros),
        is_weights=jnp.ones(BS), indices=(zeros, zeros))


def torch_batch(b):
    zeros = torch.zeros(BS)
    return SamplesFromReplay(
        agent_inputs=AgentInputs(jax.tree.map(t, b["obs"]), zeros, zeros),
        action=t(b["action"]).long(), return_=t(b["return_"]),
        done=t(b["done_n"]), done_n=t(b["done_n"]),
        timeout_n=t(b["timeout_n"]),
        target_inputs=AgentInputs(jax.tree.map(t, b["target_obs"]), zeros,
                                  zeros),
        is_weights=torch.ones(BS), indices=(zeros, zeros))


@pytest.mark.parametrize("dict_obs_", [False, True])
@pytest.mark.parametrize("optim", list(OPTIMS))
def test_dqn_update_matches_jax(optim, dict_obs_):
    """One DQN update (double DQN, clip 10) on DqnMlpModel from bridged
    weights, the port's ``DQN(optim=..., optim_kwargs=...)`` against the
    JAX DQN's own optimizer and loss; with a dict observation too."""
    kw = dict(batch_size=BS, double_dqn=True, discount=0.9,
              clip_grad_norm=10.0, replay_size=256, **OPTIMS[optim])
    jenv = JaxDictObsCartPole() if dict_obs_ else None
    env = DictObsCartPole(device="cpu") if dict_obs_ else CartPole(
        device="cpu")
    jagent = JaxDqnAgent(ModelCls=JaxDqnMlpModel,
                         model_kwargs=dict(hidden_sizes=HID))
    if jenv is None:
        from rlpyt_tpu.envs.classic import CartPole as JaxCartPole
        jenv = JaxCartPole()
    jagent.initialize(jenv.spaces)
    _, jobs = jenv.reset_batch(jax.random.key(0), 2)
    jalgo = JaxDQN(**kw)
    train_state, _ = jalgo.initialize(jagent, JaxBatchSpec(8, 2), jobs,
                                      jax.random.key(1))
    params = train_state.params
    target = jagent.init(jax.random.key(2), jobs)

    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=HID), device="cpu")
    agent.initialize(env.spaces)
    algo = DQN(**kw)
    _, obs = env.reset_batch(2, torch.Generator().manual_seed(0))
    algo.initialize(agent, BatchSpec(8, 2), obs,
                    torch.Generator().manual_seed(0))
    load(agent.model, params)
    load(algo.target_model, target)
    p0 = from_jax_params(np_tree(params))
    b = dqn_batch(10, dict_obs_)
    (loss, _), grads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        params, target, jax_batch(b))
    updates, _ = jalgo.optimizer.update(grads, train_state.opt_state, params)
    params = optax.apply_updates(params, updates)
    info = algo.update(torch_batch(b))
    np.testing.assert_allclose(info.loss.item(), float(loss), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(info.grad_norm.item(),
                               float(optax.global_norm(grads)), rtol=1e-5,
                               atol=1e-6)
    want = from_jax_params(np_tree(params))
    got = {k: v.detach().numpy() for k, v in agent.model.state_dict().items()}
    change = max(np.abs(want[k] - p0[k]).max() for k in want)
    diff = max(np.abs(got[k] - want[k]).max() for k in want)
    assert change > 0 and diff <= 1e-5 * change, (diff, change)


def test_dqn_optimizer_settings():
    """Adam's default eps is 0.01 / batch_size unless optim_kwargs names
    one; RMSprop takes decay, eps and centered; clipping happens once,
    in the optimizer."""
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(8,)), device="cpu")
    agent.initialize(CartPole(device="cpu").spaces)
    obs = torch.zeros((2, 4))
    for kw, want in ((dict(), {"eps": 0.01 / BS}),
                     (dict(optim_kwargs=dict(eps=1e-4)), {"eps": 1e-4}),
                     (OPTIMS["rmsprop_centered"],
                      {"eps": 0.01, "decay": 0.95, "centered": True})):
        algo = DQN(batch_size=BS, replay_size=64, **kw)
        algo.initialize(agent, BatchSpec(8, 2), obs, torch.Generator())
        group = algo.optimizer.inner.param_groups[0]
        assert {k: group[k] for k in want} == want
        assert algo.optimizer.clip_grad_norm == algo.clip_grad_norm == 10.0


def test_float_box_spaces_of_the_classic_envs_match_jax():
    from rlpyt_tpu.envs.classic import Acrobot as JaxAcrobot
    from rlpyt_tpu.envs.classic import MountainCar as JaxMountainCar
    for jenv, env in ((JaxAcrobot(), Acrobot(device="cpu")),
                      (JaxMountainCar(), MountainCar(device="cpu"))):
        js, s = jenv.observation_space, env.observation_space
        assert isinstance(s, FloatBox) and s.shape == js.shape
        np.testing.assert_array_equal(s.low, js.low)
        np.testing.assert_array_equal(s.high, js.high)
        assert env.action_space.n == jenv.action_space.n == 3
        assert env.horizon == jenv.horizon


def test_dict_obs_run_equals_vector_run_in_leaf_order():
    """The learning twin's settings (tests/test_torch_dqn_learning.py:
    test_dict_obs_dqn_learns) at a short budget: MinibatchRl on
    DictObsCartPole gives the run of the vector CartPole whose features
    are in the dict's sorted leaf order (x, theta, x_dot, theta_dot),
    bit for bit: ReturnAverage of every interval and the final weights.
    The dict path (collection, the flat replay ring, the model's leaf
    concatenation) adds nothing of its own; beside the vector twin it
    differs only by the order of the features.  That order is the JAX
    package's: on the same states, the port's dict leaves and the model
    input concatenated from them equal the JAX env's and JAX's
    ``infer_leading_dims_tree``'s, bit for bit, and equal the leaf-order
    twin's vector."""
    from rlpyt_tpu.envs.classic import CartPoleState as JaxCartPoleState
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.struct import tree_leaves

    class LeafOrderCartPole(CartPole):
        @property
        def observation_space(self):
            high = [self.x_threshold * 2, self.theta_threshold * 2, 3.0e2,
                    3.0e2]
            return FloatBox(low=[-h for h in high], high=high, shape=(4,))

        @staticmethod
        def _obs(s):
            return torch.stack([s.x, s.theta, s.x_dot, s.theta_dot], dim=-1)

    def run(env):
        agent = DqnAgent(ModelCls=DqnMlpModel,
                         model_kwargs={"hidden_sizes": (32, 32)},
                         eps_steps=2_000, eps_final=0.02, device="cpu")
        algo = DQN(batch_size=32, min_steps_learn=256, replay_size=4_096,
                   replay_ratio=2.0, target_update_interval=50,
                   learning_rate=1e-3)
        runner = MinibatchRl(algo=algo, agent=agent, env=env,
                             batch_spec=BatchSpec(16, 8), n_steps=2_048,
                             seed=1, log_interval_steps=512, device="cpu")
        averages = []
        record = runner.logger.record_tabular

        def spy(key, value):
            if key == "ReturnAverage":
                averages.append(float(value))
            record(key, value)

        runner.logger.record_tabular = spy
        runner.logger.dump_tabular = lambda *a, **k: None
        runner.train()
        return averages, agent.model.state_dict()

    env = DictObsCartPole(device="cpu")
    state = env.reset_batch(8, torch.Generator().manual_seed(0))[0]
    state = state._replace(**{
        f: torch.from_numpy(np.random.RandomState(i).uniform(
            -1.0, 1.0, 8).astype(np.float32))
        for i, f in enumerate(("x", "x_dot", "theta", "theta_dot"))})
    jstate = JaxCartPoleState(*(jnp.asarray(v.numpy()) for v in state))
    obs, jobs = env._obs(state), jax.vmap(JaxDictObsCartPole()._obs)(jstate)
    leaves, jleaves = tree_leaves(obs), jax.tree_util.tree_leaves(jobs)
    assert len(leaves) == len(jleaves) == 2
    for leaf, jleaf in zip(leaves, jleaves):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    x = infer_leading_dims_tree(obs, 1)[3]
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jax_infer_leading_dims_tree(jobs, 1)[3]))
    assert torch.equal(x, LeafOrderCartPole._obs(state))

    (avg_d, w_d), (avg_l, w_l) = (run(DictObsCartPole(device="cpu")),
                                  run(LeafOrderCartPole(device="cpu")))
    assert len(avg_d) == 4 and avg_d == avg_l
    assert w_d.keys() == w_l.keys()
    for k in w_d:
        assert torch.equal(w_d[k], w_l[k]), k
