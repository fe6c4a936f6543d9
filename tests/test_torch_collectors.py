"""Wait-reset collection and the ``valid`` mask of the port against the
JAX package, on the CPU.

- The twins of tests/test_collectors.py:70 and :79 on the same counting
  env: the JAX Collector and the port's collect one batch under both
  reset rules, and the observations, actions, rewards, dones, the
  agents' carries, the trajectory stats and the state after the batch
  must be equal element by element.
- ``process_returns(mid_batch_reset=False)`` against the JAX method on
  the same samples: valid equal, return and advantage to rtol 1e-5,
  atol 1e-6 (JAX sums the recurrences by an associative scan, the port
  by a reverse loop: a few float32 ulps of the summed terms apart, 3.6e-7
  on an advantage of -1.6 at these inputs).
- A2C's loss and grads and one PPO optimize with a wait-reset ``valid``
  against JAX, within tests/test_torch_pg.py's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pg import B as PG_B
from test_torch_pg import CLOSE, T as PG_T, assert_grads_close, \
    assert_info_close, assert_state_close, grads_of, make_algos, make_batch, \
    t

from rlpyt_tpu.agents.base import AgentStep as JaxAgentStep
from rlpyt_tpu.agents.base import BaseAgent as JaxBaseAgent
from rlpyt_tpu.algos.pg import A2C as JaxA2C
from rlpyt_tpu.algos.pg import PPO as JaxPPO
from rlpyt_tpu.envs.base import Env as JaxEnv
from rlpyt_tpu.envs.base import EnvStep as JaxEnvStep
from rlpyt_tpu.samplers.rollout import BatchSpec as JaxBatchSpec
from rlpyt_tpu.samplers.rollout import Collector as JaxCollector
from rlpyt_tpu.samplers.rollout import Samples as JaxSamples
from rlpyt_tpu.spaces import FloatBox as JaxFloatBox
from rlpyt_tpu.spaces import IntBox as JaxIntBox
from rlpyt_tpu_torch.agents.base import AgentStep, BaseAgent
from rlpyt_tpu_torch.algos.pg import A2C, PPO
from rlpyt_tpu_torch.envs.base import Env, EnvStep
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector, Samples
from rlpyt_tpu_torch.spaces import FloatBox, IntBox

torch.set_num_threads(2)


class JaxCountEnv(JaxEnv):
    """tests/test_collectors.py:13: episodes of ``horizon`` steps; the
    observation is the step index, the reward 1."""

    def __init__(self, horizon):
        self.horizon_n = horizon

    @property
    def observation_space(self):
        return JaxFloatBox(0.0, 100.0, shape=(1,))

    @property
    def action_space(self):
        return JaxIntBox(0, 2)

    def reset(self, key, params=None):
        return jnp.zeros((), jnp.int32), jnp.zeros((1,), jnp.float32)

    def step(self, key, state, action, params=None):
        s = state + 1
        return s, JaxEnvStep(jnp.asarray([s], jnp.float32),
                             jnp.ones((), jnp.float32), s >= self.horizon_n,
                             {"timeout": jnp.zeros((), jnp.bool_)})

    def example_info(self):
        return {"timeout": jnp.zeros((), jnp.bool_)}


class CountEnv(Env):
    """The same env on [B] tensors."""

    def __init__(self, horizon):
        self.horizon_n = horizon
        self.device = torch.device("cpu")

    @property
    def observation_space(self):
        return FloatBox(0.0, 100.0, shape=(1,))

    @property
    def action_space(self):
        return IntBox(0, 2)

    def reset_batch(self, n, generator):
        return torch.zeros((n,), dtype=torch.int32), torch.zeros((n, 1))

    def step_batch(self, state, action, generator):
        s = state + 1
        return s, EnvStep(s[:, None].to(torch.float32), torch.ones(s.shape),
                          s >= self.horizon_n,
                          {"timeout": torch.zeros(s.shape, dtype=torch.bool)})


class JaxCountAgent(JaxBaseAgent):
    """Action = (observation + 1) mod 2; the carry counts the steps since
    the lane's last carry reset."""

    def initialize(self, env_spaces):
        self.env_spaces = env_spaces

    def init_carry(self, B):
        return jnp.zeros((B, 1), jnp.float32)

    def step(self, params, key, observation, prev_action, prev_reward,
             carry, ctx):
        action = (observation[:, 0].astype(jnp.int32) + 1) % 2
        return JaxAgentStep(action, {"carry": carry}), carry + 1.0


class CountAgent(BaseAgent):
    def initialize(self, env_spaces):
        self.env_spaces = env_spaces

    def init_carry(self, B):
        return torch.zeros((B, 1))

    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False):
        action = (observation[:, 0].to(torch.int32) + 1) % 2
        return AgentStep(action, {"carry": carry}), carry + 1.0


def collect_both(mid_batch_reset, T, B, horizon, batches=2):
    jenv, env = JaxCountEnv(horizon), CountEnv(horizon)
    jagent, agent = JaxCountAgent(), CountAgent()
    jagent.initialize(jenv.spaces)
    agent.initialize(env.spaces)
    jcol = JaxCollector(jenv, jagent, JaxBatchSpec(T, B),
                        mid_batch_reset=mid_batch_reset)
    col = Collector(env, agent, BatchSpec(T, B),
                    mid_batch_reset=mid_batch_reset)
    jstate = jcol.init_state(jax.random.key(0))
    state = col.init_state(torch.Generator().manual_seed(0))
    out = []
    collect = jax.jit(jcol.collect)
    for _ in range(batches):
        jstate, jsamples = collect(None, jstate)
        state, samples = col.collect(state, torch.Generator())
        out.append((jstate, jsamples, state, samples))
    return out


def assert_equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("horizon,B", [(5, 2), (3, 3)])
@pytest.mark.parametrize("mid_batch_reset", [True, False])
def test_collect_matches_jax(mid_batch_reset, horizon, B):
    """Two batches of 12 steps under each reset rule: every sample field,
    the agent's carry, the trajectory stats and the state after each
    batch equal the JAX collector's."""
    for jstate, js, state, s in collect_both(mid_batch_reset, 12, B,
                                             horizon):
        for f in ("observation", "action", "reward", "done", "prev_action",
                  "prev_reward"):
            assert_equal(getattr(s, f), getattr(js, f), f)
        assert_equal(s.agent_info["carry"], js.agent_info["carry"], "carry")
        assert_equal(s.env_info["timeout"], js.env_info["timeout"],
                     "timeout")
        for f in state.traj_stats._fields:
            assert_equal(getattr(state.traj_stats, f),
                         getattr(jstate.traj_stats, f), f)
        for f in ("env_state", "observation", "prev_action", "prev_reward",
                  "agent_carry", "ep_return", "ep_length", "ep_nonzero",
                  "ep_discounted", "ep_gamma", "needs_reset"):
            assert_equal(getattr(state, f), getattr(jstate, f), f)
        assert state.cum_steps == int(jstate.cum_steps)


def test_mid_batch_reset_restarts_episodes():
    """tests/test_collectors.py:70."""
    (_, _, state, samples), = collect_both(True, 12, 2, 5, batches=1)
    assert samples.observation[:, 0, 0].tolist() == \
        [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1]
    assert int(state.traj_stats.completed) == 4


def test_wait_reset_freezes_done_envs():
    """tests/test_collectors.py:79: done from step 4 on, reward 0 and the
    observation unchanged while frozen, one episode a lane, and every
    lane reset after the batch."""
    (_, _, state, samples), = collect_both(False, 12, 2, 5, batches=1)
    done = samples.done[:, 0]
    assert not done[:4].any() and done[4:].all()
    assert (samples.reward[5:, 0] == 0).all()
    assert (samples.observation[5:, 0, 0] == 4).all()
    assert int(state.traj_stats.completed) == 2
    assert not state.needs_reset.any()
    assert state.observation[:, 0].tolist() == [0, 0]
    assert (state.agent_carry == 0).all()


def returns_samples(seed=0, T=9, B=5):
    """The same [T, B] samples for both packages, from a seed."""
    rng = np.random.default_rng(seed)
    reward = rng.standard_normal((T, B)).astype(np.float32)
    value = rng.standard_normal((T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.25
    boot = rng.standard_normal(B).astype(np.float32)
    fields = dict(observation=None, action=None, prev_action=None,
                  prev_reward=None, env_info={})
    js = JaxSamples(reward=jnp.asarray(reward), done=jnp.asarray(done),
                    agent_info={"value": jnp.asarray(value)}, **fields)
    s = Samples(reward=t(reward), done=t(done), agent_info={"value": t(value)},
                **fields)
    return js, s, jnp.asarray(boot), t(boot)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("gae_lambda", [1.0, 0.95])
@pytest.mark.parametrize("mid_batch_reset", [True, False])
def test_process_returns_matches_jax(mid_batch_reset, gae_lambda, normalize):
    kw = dict(discount=0.97, gae_lambda=gae_lambda,
              normalize_advantage=normalize)
    jalgo, algo = JaxA2C(**kw), A2C(**kw)
    js, s, jboot, boot = returns_samples()
    jret, jadv, jvalid = jalgo.process_returns(js, jboot, mid_batch_reset)
    ret, adv, valid = algo.process_returns(s, boot, mid_batch_reset)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), **CLOSE)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), **CLOSE)
    if mid_batch_reset:
        assert valid is None and jvalid is None
    else:
        assert_equal(valid, jvalid, "valid")
        assert 0 < float(valid.sum()) < valid.numel()


class _WaitReset:
    """An algorithm whose batches come from a wait-reset collector."""

    def process_returns(self, samples, bootstrap_value,
                        mid_batch_reset=True):
        return super().process_returns(samples, bootstrap_value, False)


class JaxWaitA2C(_WaitReset, JaxA2C):
    pass


class WaitA2C(_WaitReset, A2C):
    pass


class JaxWaitPPO(_WaitReset, JaxPPO):
    pass


class WaitPPO(_WaitReset, PPO):
    pass


@pytest.mark.parametrize("recurrent", [False, True])
def test_a2c_loss_with_valid_matches_jax(recurrent):
    """A2C's loss, entropy and grads with a wait-reset ``valid`` against
    the JAX A2C's."""
    kw = dict(discount=0.99, learning_rate=3e-3, gae_lambda=0.95,
              entropy_loss_coeff=0.01, clip_grad_norm=0.5)
    jalgo, algo, train_state = make_algos(JaxWaitA2C, WaitA2C, recurrent,
                                          **kw)
    jax_s, torch_s, jax_rs, torch_rs = make_batch(recurrent)
    params = train_state.params
    init = (jax.tree.map(lambda x: x[0], jax_s.agent_info["prev_rnn_state"])
            if recurrent else None)
    (jloss, (jent, _)), jgrads = jax.value_and_grad(
        jalgo.loss, has_aux=True)(params, jax_s,
                                  jalgo.bootstrap(params, jax_rs), init)
    tinit = (tuple(x[0] for x in torch_s.agent_info["prev_rnn_state"])
             if recurrent else None)
    loss, entropy, _ = algo.loss(torch_s, algo.bootstrap(torch_rs), tinit)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), **CLOSE)
    np.testing.assert_allclose(float(entropy), float(jent), **CLOSE)
    assert_grads_close(grads_of(algo.agent.model), jgrads)
    # The mask changes the loss: not every step of the batch is valid.
    _, _, valid = algo.process_returns(torch_s, algo.bootstrap(torch_rs))
    assert float(valid.sum()) < valid.numel()


@pytest.mark.parametrize("recurrent", [False, True])
def test_ppo_with_valid_matches_jax(recurrent):
    """One PPO optimize (2 epochs x 2 minibatches, JAX's permutations)
    with a wait-reset ``valid``: infos and params against JAX."""
    kw = dict(discount=0.99, learning_rate=3e-3, epochs=2, minibatches=2,
              ratio_clip=0.1, gae_lambda=0.95, normalize_advantage=True,
              clip_grad_norm=1.0)
    jalgo, algo, train_state = make_algos(JaxWaitPPO, WaitPPO, recurrent,
                                          n_itr=3, **kw)
    jax_s, torch_s, jax_rs, torch_rs = make_batch(recurrent, seed=8)
    key = jax.random.key(9)
    n_items = PG_B if recurrent else PG_T * PG_B
    perms = np.stack([np.asarray(jax.random.permutation(k, n_items))
                      for k in jax.random.split(key, 2)])
    new_state, _, jinfo = jalgo.optimize(train_state, None, jax_s, key,
                                         jax_rs)
    info = algo.optimize(torch_s, torch_rs, permutations=t(perms))
    assert_info_close(info, jinfo)
    assert_state_close(algo.agent.model, new_state.params, **CLOSE)
