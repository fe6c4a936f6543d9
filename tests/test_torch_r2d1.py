"""The port's R2D1 slice (rlpyt_tpu_torch: AtariR2d1Model, R2d1Agent,
sequence replay, R2D1, MinibatchRl) on the CPU against the JAX package.

Full 104x80x4 frames with a narrow model (convs 8/8/8, fc 32, LSTM 16).
Inputs come from numpy with a seed; the two RNG streams differ, so the
replay's uniforms and the env's reset draws are injected.  Tolerances:

- model forward: float32 rtol=1e-4, atol=1e-5; bf16 atol = 0.05 *
  max|ref| + 1e-3 (as tests/test_torch_models.py: both frameworks round
  activations to bf16 after every layer, at different places);
- replay: bit-exact on integers, uint8 and stored floats; importance
  weights and priorities (float32 powers, sums in another order)
  rtol=1e-6;
- loss and priorities rtol=1e-4, atol=1e-5 and grads rtol=atol=2e-4
  against the JAX loss through the Pallas LSTM in interpret mode (a
  12-step recurrence summed in another order);
- params after one Adam step (lr 1e-4, eps 1e-3, so a grad difference
  reaches the params scaled by at most lr/eps = 0.1) rtol=1e-5, atol=1e-6.
"""
import csv
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bench_atari import make_env as jax_make_env
from rlpyt_tpu.agents.base import StepCtx
from rlpyt_tpu.agents.dqn import R2d1Agent as JaxR2d1Agent
from rlpyt_tpu.algos.base import global_norm, make_optimizer
from rlpyt_tpu.algos.r2d1 import R2D1 as JaxR2D1
from rlpyt_tpu.envs.base import EnvSpaces as JaxEnvSpaces
from rlpyt_tpu.models.dqn import AtariR2d1Model as JaxAtariR2d1Model
from rlpyt_tpu.ops import returns as jax_returns
from rlpyt_tpu.ops import value as jax_value
from rlpyt_tpu.replay import sequence as jseq
from rlpyt_tpu.replay.base import SamplesToBuffer as JaxSamplesToBuffer
from rlpyt_tpu.samplers.rollout import BatchSpec as JaxBatchSpec
from rlpyt_tpu.samplers.rollout import Collector as JaxCollector
from rlpyt_tpu.samplers.rollout import Samples as JaxSamples
from rlpyt_tpu.spaces import IntBox as JaxIntBox
from rlpyt_tpu_torch.agents.dqn import DqnAgent, R2d1Agent
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.envs.synthetic_atari import EP_LEN, State, \
    SyntheticAtariEnv
from rlpyt_tpu_torch.models.dqn import AtariR2d1Model
from rlpyt_tpu_torch.ops import returns, value
from rlpyt_tpu_torch.params import from_jax_params, to_jax_params
from rlpyt_tpu_torch.replay import sequence as tseq
from rlpyt_tpu_torch.replay.base import SamplesToBuffer
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector, Samples
from rlpyt_tpu_torch.spaces import IntBox
from rlpyt_tpu_torch.utils.logging import TabularLogger

torch.set_num_threads(2)

K, H, W, A = 4, 104, 80, 6
LSTM = 16
NARROW = dict(channels=(8, 8, 8), fc_sizes=(32,), lstm_size=LSTM)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def load(module, tree):
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            from_jax_params(np_tree(tree)).items()})


def jax_init(jm, seed, B=2):
    z = jnp.zeros((B, LSTM), jnp.float32)
    return jm.init(jax.random.key(seed), jnp.zeros((B, K, H, W), jnp.uint8),
                   jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.float32),
                   (z, z))


def model_inputs(seed, T, B):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (T, B, K, H, W), dtype=np.uint8),
        prev_action=rng.integers(0, A, (T, B)).astype(np.int32),
        prev_reward=rng.normal(size=(T, B)).astype(np.float32),
        h=(rng.normal(size=(B, LSTM)) * 0.5).astype(np.float32),
        c=(rng.normal(size=(B, LSTM)) * 0.5).astype(np.float32),
        done=rng.random((T, B)) < 0.2)


# ---------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------

def test_return_and_value_ops_match_jax():
    rng = np.random.default_rng(0)
    reward = rng.normal(size=(9, 4)).astype(np.float32)
    done = rng.random((9, 4)) < 0.3
    for n in (1, 3, 5):
        r_ref, d_ref = jax_returns.discount_return_n_step(
            jnp.asarray(reward), jnp.asarray(done), n, 0.97)
        r, d = returns.discount_return_n_step(
            torch.from_numpy(reward), torch.from_numpy(done), n, 0.97)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-6)
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(
        returns.valid_from_done(torch.from_numpy(done)).numpy(),
        np.asarray(jax_returns.valid_from_done(jnp.asarray(done))))
    x = (rng.normal(size=50) * 30).astype(np.float32)
    for fn, ref in ((value.value_rescale, jax_value.value_rescale),
                    (value.value_rescale_inv, jax_value.value_rescale_inv)):
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------
# Model and bridge
# ---------------------------------------------------------------------

def bridged_model(jdtype, tdtype, seed=0, dueling=True):
    jm = JaxAtariR2d1Model(n_actions=A, compute_dtype=jdtype,
                           dueling=dueling, **NARROW)
    params = jax_init(jm, seed)
    tm = AtariR2d1Model((K, H, W), A, compute_dtype=tdtype, dueling=dueling,
                        **NARROW)
    load(tm, params)
    return jm, params, tm


def run_both(jm, params, tm, x, lead):
    """(port q, hT, cT), (JAX q, hT, cT); ``lead`` 2 = [T, B] windows with
    dones, 1 = one collection step."""
    if lead == 1:
        x = {k: v[0] if k in ("obs", "prev_action", "prev_reward") else v
             for k, v in x.items()}
        done_j = done_t = None
    else:
        done_j, done_t = jnp.asarray(x["done"]), torch.from_numpy(x["done"])
    q_ref, (h_ref, c_ref) = jm.apply(
        params, jnp.asarray(x["obs"]), jnp.asarray(x["prev_action"]),
        jnp.asarray(x["prev_reward"]),
        (jnp.asarray(x["h"]), jnp.asarray(x["c"])), done_j)
    with torch.no_grad():
        q, (h, c) = tm(torch.from_numpy(x["obs"]),
                       torch.from_numpy(x["prev_action"]),
                       torch.from_numpy(x["prev_reward"]),
                       (torch.from_numpy(x["h"]), torch.from_numpy(x["c"])),
                       done_t)
    return (q.numpy(), h.numpy(), c.numpy()), \
        tuple(np.asarray(v, np.float32) for v in (q_ref, h_ref, c_ref))


@pytest.mark.parametrize("lead", [2, 1])
@pytest.mark.parametrize("dueling", [True, False])
def test_model_matches_jax_fp32(dueling, lead):
    jm, params, tm = bridged_model(jnp.float32, torch.float32, 1, dueling)
    got, want = run_both(jm, params, tm, model_inputs(2, 5, 3), lead)
    assert got[0].shape == want[0].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_model_matches_jax_bf16():
    jm, params, tm = bridged_model(jnp.bfloat16, torch.bfloat16, 3)
    got, want = run_both(jm, params, tm, model_inputs(4, 6, 3), 2)
    assert got[0].dtype == np.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=0.05 * np.abs(w).max() + 1e-3)


def test_bf16_model_rounds_prev_reward_before_lstm():
    """Under bf16 the LSTM input (and so the prev reward) is built in
    bf16, as the JAX model builds it: a reward and its bf16 rounding give
    the same output."""
    _, _, tm = bridged_model(jnp.bfloat16, torch.bfloat16, 5)
    x = model_inputs(6, 3, 2)
    r = torch.tensor([[0.3, 1.0 / 3.0]] * 3)
    r16 = r.to(torch.bfloat16).to(torch.float32)
    assert not torch.equal(r, r16)
    state = (torch.from_numpy(x["h"]), torch.from_numpy(x["c"]))
    with torch.no_grad():
        outs = [tm(torch.from_numpy(x["obs"]),
                   torch.from_numpy(x["prev_action"]), rr, state)
                for rr in (r, r16)]
    (q0, (h0, c0)), (q1, (h1, c1)) = outs
    assert torch.equal(q0, q1) and torch.equal(h0, h1) \
        and torch.equal(c0, c1)


def test_bridge_round_trip():
    _, params, tm = bridged_model(jnp.float32, torch.float32, 7)
    back = to_jax_params(tm.state_dict(), 4)
    ref = np_tree(params)
    jax.tree.map(np.testing.assert_array_equal, back, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    assert set(tm.state_dict()) >= {"lstm.wx", "lstm.wh", "lstm.b",
                                    "head.adv.layers.0.weight",
                                    "head.val.layers.1.bias"}


def test_lstm_core_init_per_gate():
    """wx per gate lecun-normal, wh per gate orthogonal, b zeros."""
    torch.manual_seed(0)
    tm = AtariR2d1Model((K, H, W), A, **NARROW)
    wh = tm.lstm.wh.detach()
    for k in range(4):
        blk = wh[:, k * LSTM:(k + 1) * LSTM]
        np.testing.assert_allclose((blk.T @ blk).numpy(), np.eye(LSTM),
                                   atol=1e-5)
    assert not tm.lstm.b.detach().any()
    F = tm.lstm.wx.shape[0]
    assert F == 8 * 12 * 9 + A + 1
    assert abs(float(tm.lstm.wx.detach().std()) * F ** 0.5 - 1.0) < 0.1


# ---------------------------------------------------------------------
# Agent and collector
# ---------------------------------------------------------------------

def test_vector_epsilon_matches_jax():
    kw = dict(eps_steps=250_000, eps_final=0.1, eps_final_min=0.0005)
    jagent = JaxR2d1Agent(ModelCls=JaxAtariR2d1Model, **kw)
    tagent = R2d1Agent(device="cpu", **kw)
    for cum in (0, 1_000, 125_000, 250_000, 400_000):
        for n in (1, 7, 64):
            want = np.asarray(jagent.epsilon(
                StepCtx(jnp.asarray(cum, jnp.int32)), n))
            got = tagent.epsilon(cum, False, n)
            assert got.shape == (n,) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert tagent.epsilon(5, True, 4) == jagent.epsilon(
        StepCtx(jnp.asarray(5), True), 4)
    # Without eps_final_min the schedule stays one float (slice 1).
    scalar = DqnAgent(eps_steps=100, eps_final=0.1, device="cpu")
    assert scalar.epsilon(50, False, 8) == pytest.approx(0.55)


def jax_reset_draws(env, key, n_steps, B):
    """The t0 values JAX's collector draws at each step's reset."""
    draws = []
    for _ in range(n_steps):
        key, _, _, k_reset = jax.random.split(key, 4)
        draws.append(np.asarray(env.reset_batch(k_reset, B)[0].t))
    return draws


def test_collector_carry_matches_jax_and_resets_on_done():
    """Greedy R2D1 collection through mid-batch resets: the batches, q and
    the stored prev_rnn_state match JAX, and a lane's carry is zero on the
    step after its done."""
    T, B = 6, 3
    env = jax_make_env()
    jagent = JaxR2d1Agent(ModelCls=JaxAtariR2d1Model, model_kwargs=NARROW,
                          eps_init=0.0, eps_final=0.0, eps_final_min=None)
    jagent.initialize(env.spaces)
    jcoll = JaxCollector(env, jagent, JaxBatchSpec(T, B), discount=0.99)
    jstate = jcoll.init_state(jax.random.key(3))
    t_init = jnp.asarray([(b + 1) * EP_LEN - 2 - 3 * b for b in range(B)],
                         jnp.int32)
    env_state, first = env.step_batch(
        jax.random.key(4), jstate.env_state._replace(t=t_init - 1),
        jnp.zeros((B,), jnp.int32))
    jstate = jstate._replace(env_state=env_state,
                             observation=first.observation)
    params = jagent.init(jax.random.key(5), jstate.observation)
    draws = jax_reset_draws(env, jstate.key, 2 * T, B)
    collect = jax.jit(jcoll.collect)
    jbatches = []
    for _ in range(2):
        jstate, samples = collect(params, jstate)
        jbatches.append(samples)

    tenv = SyntheticAtariEnv("cpu")
    agent = R2d1Agent(model_kwargs=NARROW, eps_init=0.0, eps_final=0.0,
                      eps_final_min=None, device="cpu")
    agent.initialize(tenv.spaces)
    load(agent.model, params)
    coll = Collector(tenv, agent, BatchSpec(T, B), discount=0.99)
    t0 = torch.tensor(np.asarray(t_init), dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)
    state = coll.init_state(gen)._replace(env_state=State(t0),
                                          observation=tenv.stack_at(t0))
    queue = iter(draws)

    def reset_batch(n, generator):
        t = torch.tensor(next(queue), dtype=torch.int64)
        return State(t), tenv.stack_at(t)

    tenv.reset_batch = reset_batch
    for jb in jbatches:
        state, tb = coll.collect(state, gen)
        for name in ("observation", "action", "reward", "done",
                     "prev_action", "prev_reward"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
        np.testing.assert_allclose(tb.agent_info["q"].numpy(),
                                   np.asarray(jb.agent_info["q"]),
                                   rtol=1e-4, atol=1e-5)
        for got, want in zip(tb.agent_info["prev_rnn_state"],
                             jb.agent_info["prev_rnn_state"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
        h = tb.agent_info["prev_rnn_state"][0]
        done = tb.done
        assert done[:-1].any()
        for t, b in zip(*torch.nonzero(done[:-1], as_tuple=True)):
            assert not h[t + 1, b].any()
        assert h[1:][~done[:-1]].abs().sum(-1).min() > 0


# ---------------------------------------------------------------------
# Sequence replay
# ---------------------------------------------------------------------

RT, RB, FH, FW = 8, 3, 6, 5   # replay test: sampler T, lanes, frame size


def replay_pair(frame, prioritized):
    kw = dict(size=RT * RB * 5, B=RB, sample_T=RT, warmup_T=4, batch_T=6,
              n_step_return=2, discount=0.9)
    if frame:
        kw.update(frames_per_obs=K)
    if prioritized:
        kw.update(alpha=0.6, beta=0.9)
    name = ("Prioritized" if prioritized else "Uniform") + "Sequence" \
        + ("Frame" if frame else "") + "ReplayBuffer"
    jr = getattr(jseq, name)(**kw)
    tr = getattr(tseq, name)(device="cpu", **kw)
    obs = np.zeros((K, FH, FW), np.uint8)
    h = np.zeros((LSTM,), np.float32)
    jstate = jr.init(JaxSamplesToBuffer(
        jnp.asarray(obs), jnp.zeros((), jnp.int32), jnp.zeros(()),
        jnp.zeros((), bool), jnp.zeros((), bool)),
        (jnp.asarray(h), jnp.asarray(h)))
    tr.init(SamplesToBuffer(
        torch.from_numpy(obs), torch.zeros((), dtype=torch.int32),
        torch.zeros(()), torch.zeros((), dtype=torch.bool),
        torch.zeros((), dtype=torch.bool)),
        (torch.from_numpy(h), torch.from_numpy(h)))
    return jr, jstate, tr


def replay_block(rng, n_slots_new, with_priorities):
    block = dict(
        observation=rng.integers(0, 256, (RT, RB, K, FH, FW),
                                 dtype=np.uint8),
        action=rng.integers(0, A, (RT, RB)).astype(np.int32),
        reward=rng.normal(size=(RT, RB)).astype(np.float32),
        done=rng.random((RT, RB)) < 0.15,
        timeout=np.zeros((RT, RB), bool))
    rnn = tuple(rng.normal(size=(n_slots_new, RB, LSTM)).astype(np.float32)
                for _ in range(2))
    pri = (rng.random((n_slots_new, RB)).astype(np.float32) * 3
           if with_priorities else None)
    return block, rnn, pri


@pytest.mark.parametrize("prioritized", [True, False])
@pytest.mark.parametrize("frame", [True, False])
def test_sequence_replay_matches_jax(frame, prioritized):
    jr, jstate, tr = replay_pair(frame, prioritized)
    assert (tr.size_T, tr.n_slots, tr.interval, tr.window_T) == \
        (jr.size_T, jr.n_slots, jr.interval, jr.window_T) == (40, 10, 4, 12)
    rng = np.random.default_rng(0)
    n_new = RT // tr.interval
    for i in range(7):     # 56 rows into a 40-row ring: wraps
        block, rnn, pri = replay_block(rng, n_new, i % 2 == 0)
        jstate = jr.append(jstate, JaxSamplesToBuffer(
            **{k: jnp.asarray(v) for k, v in block.items()}),
            tuple(map(jnp.asarray, rnn)),
            None if pri is None else jnp.asarray(pri))
        tr.append(SamplesToBuffer(
            **{k: torch.from_numpy(v) for k, v in block.items()}),
            tuple(map(torch.from_numpy, rnn)),
            None if pri is None else torch.from_numpy(pri))
        assert (tr.t, tr.filled_t) == (int(jstate.t), int(jstate.filled_t))
        np.testing.assert_array_equal(tr._slot_validity().numpy(),
                                      np.asarray(jr._slot_validity(jstate)))
    for name in ("observation", "action", "reward", "done", "timeout"):
        np.testing.assert_array_equal(
            getattr(tr.data, name).numpy(),
            np.asarray(getattr(jstate.data, name)), err_msg=name)
    for got, want in zip(tr.rnn_state, jstate.rnn_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tr.priorities.numpy(),
                               np.asarray(jstate.priorities), rtol=1e-6)

    key = jax.random.key(11)
    jbatch = jr.sample(jstate, key, 6)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (6,))))
    slot_idx, b_idx, w = tr.idxs_from_uniforms(u)
    np.testing.assert_array_equal(slot_idx.numpy(),
                                  np.asarray(jbatch.slots[0]))
    np.testing.assert_array_equal(b_idx.numpy(), np.asarray(jbatch.slots[1]))
    np.testing.assert_allclose(w.numpy(), np.asarray(jbatch.is_weights),
                               rtol=1e-6)
    batch = tr.extract_window(slot_idx, b_idx, w)
    for name in ("observation", "action", "reward", "done", "prev_action",
                 "prev_reward"):
        np.testing.assert_array_equal(
            getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)),
            err_msg=name)
    for got, want in zip(batch.init_rnn_state, jbatch.init_rnn_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    valid = tr._slot_validity()
    assert valid[slot_idx].all()

    # Priority write-back at distinct slots.
    slots = (np.array([1, 2, 3, 4]), np.array([0, 2, 1, 0]))
    p = np.array([0.5, 2.0, 1e-9, 7.0], np.float32)
    jstate = jr.update_priorities(jstate, tuple(map(jnp.asarray, slots)),
                                  jnp.asarray(p))
    tr.update_priorities(tuple(map(torch.from_numpy, slots)),
                         torch.from_numpy(p))
    np.testing.assert_allclose(tr.priorities.numpy(),
                               np.asarray(jstate.priorities), rtol=1e-6)
    np.testing.assert_allclose(tr.max_priority.numpy(),
                               np.asarray(jstate.max_priority), rtol=1e-6)


def test_sequence_sample_draws_valid_slots():
    _, _, tr = replay_pair(True, True)
    rng = np.random.default_rng(1)
    for i in range(3):
        block, rnn, pri = replay_block(rng, 2, i == 1)
        tr.append(SamplesToBuffer(
            **{k: torch.from_numpy(v) for k, v in block.items()}),
            tuple(map(torch.from_numpy, rnn)),
            None if pri is None else torch.from_numpy(pri))
    batch = tr.sample(16, torch.Generator().manual_seed(0))
    assert tr._slot_validity()[batch.slots[0]].all()
    assert batch.observation.shape == (12, 16, K, FH, FW)
    assert float(batch.is_weights.max()) == pytest.approx(1.0)


# ---------------------------------------------------------------------
# R2D1 loss, update and runner
# ---------------------------------------------------------------------

WT, BT, NS, BB = 4, 6, 2, 4      # warmup, training slice, n-step, windows
LR = 1e-4
CONFIGS = {
    "default": dict(),
    "variants": dict(double_dqn=False, mask_after_done=True,
                     delta_clip=1.0, zero_state_init=True,
                     use_value_rescale=False),
}


def fixed_windows(seed):
    rng = np.random.default_rng(seed)
    Wn = WT + BT + NS
    return dict(
        observation=rng.integers(0, 256, (Wn, BB, K, H, W), dtype=np.uint8),
        action=rng.integers(0, A, (Wn, BB)).astype(np.int32),
        reward=(rng.normal(size=(Wn, BB)) * 3).astype(np.float32),
        done=rng.random((Wn, BB)) < 0.15,
        prev_action=rng.integers(0, A, (Wn, BB)).astype(np.int32),
        prev_reward=rng.normal(size=(Wn, BB)).astype(np.float32),
        init_rnn_state=tuple((rng.normal(size=(BB, LSTM)) * 0.5)
                             .astype(np.float32) for _ in range(2)),
        is_weights=rng.uniform(0.2, 1.0, BB).astype(np.float32),
        slots=(np.arange(BB), np.arange(BB) % 2))


def jax_r2d1(b, cfg, clip):
    agent = JaxR2d1Agent(
        ModelCls=JaxAtariR2d1Model,
        model_kwargs=dict(NARROW, lstm_impl="pallas_interpret"))
    agent.initialize(JaxEnvSpaces(JaxIntBox(0, 256, (K, H, W), jnp.uint8),
                                  JaxIntBox(0, A)))
    params = jax_init(agent.model, 0)
    target = jax_init(agent.model, 1)
    algo = JaxR2D1(batch_b=BB, batch_T=BT, warmup_T=WT, n_step_return=NS,
                   learning_rate=LR, clip_grad_norm=clip, **cfg)
    algo.agent = agent
    batch = jseq.SequenceSamples(**{k: jax.tree.map(jnp.asarray, v)
                                    for k, v in b.items()})
    (loss, pri), grads = jax.value_and_grad(algo.loss, has_aux=True)(
        params, target, batch)
    opt = make_optimizer(LR, clip, "adam", eps=1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    return dict(params=np_tree(params), target=np_tree(target),
                loss=float(loss), priorities=np.asarray(pri),
                grads=np_tree(grads), grad_norm=float(global_norm(grads)),
                new_params=np_tree(optax.apply_updates(params, updates)))


def torch_r2d1(ref, cfg, clip, target_update_interval=2500):
    agent = R2d1Agent(model_kwargs=NARROW, device="cpu")
    agent.initialize(EnvSpaces(IntBox(0, 256, (K, H, W), torch.uint8),
                               IntBox(0, A)))
    algo = R2D1(batch_b=BB, batch_T=BT, warmup_T=WT, n_step_return=NS,
                learning_rate=LR, clip_grad_norm=clip, replay_size=64,
                target_update_interval=target_update_interval, **cfg)
    algo.initialize(agent, BatchSpec(T=8, B=2),
                    torch.zeros((2, K, H, W), dtype=torch.uint8),
                    torch.Generator().manual_seed(0))
    load(agent.model, ref["params"])
    load(algo.target_model, ref["target"])
    return algo


def torch_windows(b):
    t = {k: (tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
             else torch.from_numpy(v)) for k, v in b.items()}
    t["action"] = t["action"].long()
    return tseq.SequenceSamples(**t)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_loss_priorities_and_grads_match_jax(cfg):
    b = fixed_windows(0)
    ref = jax_r2d1(b, CONFIGS[cfg], 80.0)
    algo = torch_r2d1(ref, CONFIGS[cfg], 80.0)
    loss, pri = algo.loss(torch_windows(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pri.numpy(), ref["priorities"], rtol=1e-4,
                               atol=1e-5)
    want = from_jax_params(ref["grads"])
    got = {k: p.grad.numpy() for k, p in algo.model.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("clip", [80.0, 1e-3])
def test_adam_clip_step_matches_jax(clip):
    """One update: grad norm, params after clip + Adam, the priority
    write-back, and the hard target copy at update_counter % 1 == 0.
    clip=1e-3 is far below the grad norm, so the clip scales grads."""
    b = fixed_windows(1)
    ref = jax_r2d1(b, {}, clip)
    if clip < 1.0:
        assert ref["grad_norm"] > 10 * clip
    algo = torch_r2d1(ref, {}, clip, target_update_interval=1)
    info = algo.update(torch_windows(b))
    np.testing.assert_allclose(info.grad_norm.item(), ref["grad_norm"],
                               rtol=2e-4)
    np.testing.assert_allclose(info.td_abs_err.item(),
                               ref["priorities"].mean(), rtol=1e-4)
    want = from_jax_params(ref["new_params"])
    for k, p in algo.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k, v in algo.target_model.state_dict().items():
        assert torch.equal(v, algo.model.state_dict()[k])
    s, lane = b["slots"]
    np.testing.assert_allclose(
        algo.replay.priorities[s, lane].numpy(),
        np.maximum(ref["priorities"], 1e-6) ** algo.pri_alpha, rtol=1e-4)


def test_input_priorities_match_jax():
    rng = np.random.default_rng(2)
    T_, B_ = 8, 3
    q = rng.normal(size=(T_, B_, A)).astype(np.float32) * 4
    action = rng.integers(0, A, (T_, B_)).astype(np.int32)
    reward = rng.normal(size=(T_, B_)).astype(np.float32)
    done = rng.random((T_, B_)) < 0.2
    jalgo = JaxR2D1()
    jalgo.replay = SimpleNamespace(interval=4)
    want = jalgo._input_priorities(JaxSamples(
        None, jnp.asarray(action), jnp.asarray(reward), jnp.asarray(done),
        None, None, {"q": jnp.asarray(q)}, {}))
    talgo = R2D1()
    talgo.replay = SimpleNamespace(interval=4)
    got = talgo._input_priorities(Samples(
        None, torch.from_numpy(action).long(), torch.from_numpy(reward),
        torch.from_numpy(done), None, None, {"q": torch.from_numpy(q)}, {}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_minibatch_rl_r2d1_smoke(tmp_path):
    """MinibatchRl drives the recurrent agent and R2D1 on the CPU; the log
    has no ReplayRatio (R2D1 has no batch_size), and learning starts once
    whole windows exist (min_steps_learn = 3 T B, as in chip_smoke.py)."""
    T_, B_ = 8, 3
    agent = R2d1Agent(model_kwargs=NARROW, eps_steps=1000, device="cpu")
    algo = R2D1(batch_b=4, batch_T=8, warmup_T=4, n_step_return=2,
                min_steps_learn=3 * T_ * B_, replay_size=T_ * B_ * 8,
                replay_ratio=1.0, target_update_interval=2,
                frame_compress=True)
    runner = MinibatchRl(algo, agent, SyntheticAtariEnv("cpu"),
                         BatchSpec(T_, B_), n_steps=5 * T_ * B_, seed=0,
                         log_interval_steps=T_ * B_, max_decorrelation_steps=0,
                         logger=TabularLogger(str(tmp_path)), device="cpu")
    runner.train()
    runner.logger.close()
    with open(tmp_path / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 5 and "ReplayRatio" not in rows[0]
    assert algo.updates_per_optimize == 1 and algo.update_counter == 3
    assert [float(r["loss"]) for r in rows[:2]] == [0.0, 0.0]
    for row in rows[2:]:
        for key in ("loss", "grad_norm", "td_abs_err"):
            assert np.isfinite(float(row[key])) and float(row[key]) > 0
    assert torch.isfinite(algo.replay.priorities).all()
    h, c = runner.rollout_state.agent_carry
    assert h.shape == (B_, LSTM) and h.abs().sum() > 0
