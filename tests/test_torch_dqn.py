"""Port's DQN update (rlpyt_tpu_torch/algos/dqn.py) against the JAX
algorithm on one fixed batch, from bridged weights.

Tolerances (float32 throughout): loss, |delta| and grad norm at
rtol=1e-5, atol=1e-6; each grad at rtol=1e-4, atol=1e-6 (conv weight
grads are sums over the batch and the image, taken in another order);
params after one Adam step at rtol=1e-5, atol=2e-6 (the step is
lr * m/(sqrt(v)+eps) with lr=1e-2, so grad differences reach the params
scaled by at most lr/eps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlpyt_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from rlpyt_tpu.algos.base import global_norm, make_optimizer
from rlpyt_tpu.algos.dqn import DQN as JaxDQN
from rlpyt_tpu.envs.base import EnvSpaces as JaxEnvSpaces
from rlpyt_tpu.models.dqn import AtariDqnModel as JaxAtariDqnModel
from rlpyt_tpu.ops.value import polyak_update as jax_polyak_update
from rlpyt_tpu.replay.base import AgentInputs as JaxAgentInputs
from rlpyt_tpu.replay.base import SamplesFromReplay as JaxSamples
from rlpyt_tpu.spaces import IntBox as JaxIntBox
from rlpyt_tpu_torch.agents.dqn import DqnAgent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.params import from_jax_params, to_jax_params
from rlpyt_tpu_torch.replay.base import AgentInputs, SamplesFromReplay
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.spaces import IntBox

torch.set_num_threads(2)

K, H, W, A, BS = 4, 52, 40, 6, 16
NARROW = dict(channels=(8, 8, 8), fc_sizes=(32,))
LR = 1e-2


def fixed_batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (BS, K, H, W), dtype=np.uint8),
        target_obs=rng.integers(0, 256, (BS, K, H, W), dtype=np.uint8),
        action=rng.integers(0, A, BS).astype(np.int32),
        return_=rng.normal(size=BS).astype(np.float32),
        done_n=rng.random(BS) < 0.25,
        timeout_n=rng.random(BS) < 0.25)


def jax_side(b, clip, double_dqn=True):
    agent = JaxDqnAgent(ModelCls=JaxAtariDqnModel, model_kwargs=NARROW)
    agent.initialize(JaxEnvSpaces(JaxIntBox(0, 256, (K, H, W), jnp.uint8),
                                  JaxIntBox(0, A)))
    ex = jnp.zeros((2, K, H, W), jnp.uint8)
    params = agent.init(jax.random.key(0), ex)
    target = agent.init(jax.random.key(1), ex)
    algo = JaxDQN(batch_size=BS, double_dqn=double_dqn, discount=0.9,
                  clip_grad_norm=clip, learning_rate=LR)
    algo.agent = agent
    zeros = jnp.zeros(BS)
    batch = JaxSamples(
        agent_inputs=JaxAgentInputs(jnp.asarray(b["obs"]), zeros, zeros),
        action=jnp.asarray(b["action"]), return_=jnp.asarray(b["return_"]),
        done=jnp.asarray(b["done_n"]), done_n=jnp.asarray(b["done_n"]),
        timeout_n=jnp.asarray(b["timeout_n"]),
        target_inputs=JaxAgentInputs(jnp.asarray(b["target_obs"]), zeros,
                                     zeros),
        is_weights=jnp.ones(BS), indices=(zeros, zeros))
    (loss, td_abs), grads = jax.value_and_grad(algo.loss, has_aux=True)(
        params, target, batch)
    opt = make_optimizer(LR, clip, "adam", eps=0.01 / BS)
    updates, _ = opt.update(grads, opt.init(params), params)
    new_params = optax.apply_updates(params, updates)
    np_ = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return dict(params=np_(params), target=np_(target), loss=float(loss),
                td_abs=np.asarray(td_abs), grads=np_(grads),
                grad_norm=float(global_norm(grads)),
                new_params=np_(new_params))


def torch_side(ref, clip, target_update_interval=312, double_dqn=True,
               target_update_tau=1.0):
    agent = DqnAgent(model_kwargs=NARROW, device="cpu")
    agent.initialize(EnvSpaces(IntBox(0, 256, (K, H, W), torch.uint8),
                               IntBox(0, A)))
    algo = DQN(batch_size=BS, double_dqn=double_dqn, discount=0.9,
               clip_grad_norm=clip, learning_rate=LR, replay_size=64,
               frame_buffer=True,
               target_update_interval=target_update_interval,
               target_update_tau=target_update_tau)
    algo.initialize(agent, BatchSpec(T=8, B=2),
                    torch.zeros((2, K, H, W), dtype=torch.uint8),
                    torch.Generator().manual_seed(0))
    for module, tree in ((agent.model, ref["params"]),
                         (algo.target_model, ref["target"])):
        module.load_state_dict({k: torch.tensor(v) for k, v in
                                from_jax_params(tree).items()})
    return algo


def torch_batch(b):
    zeros = torch.zeros(BS)
    t = {k: torch.tensor(v) for k, v in b.items()}
    return SamplesFromReplay(
        agent_inputs=AgentInputs(t["obs"], zeros, zeros),
        action=t["action"].long(), return_=t["return_"], done=t["done_n"],
        done_n=t["done_n"], timeout_n=t["timeout_n"],
        target_inputs=AgentInputs(t["target_obs"], zeros, zeros),
        is_weights=torch.ones(BS), indices=(zeros, zeros))


@pytest.mark.parametrize("double_dqn", [True, False])
def test_loss_and_grads_match_jax(double_dqn):
    b = fixed_batch()
    ref = jax_side(b, clip=10.0, double_dqn=double_dqn)
    algo = torch_side(ref, clip=10.0, double_dqn=double_dqn)
    loss, td_abs = algo.loss(torch_batch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(td_abs.detach().numpy(), ref["td_abs"],
                               rtol=1e-5, atol=1e-6)
    want = from_jax_params(ref["grads"])
    got = {k: p.grad.numpy() for k, p in algo.model.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("clip", [10.0, 1e-3])
def test_adam_clip_step_matches_jax(clip):
    """clip=1e-3 is far below the grad norm, so the clip scales grads."""
    b = fixed_batch(1)
    ref = jax_side(b, clip)
    if clip < 1.0:
        assert ref["grad_norm"] > 10 * clip
    algo = torch_side(ref, clip)
    info = algo.update(torch_batch(b))
    np.testing.assert_allclose(info.grad_norm.item(), ref["grad_norm"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(info.loss.item(), ref["loss"], rtol=1e-5,
                               atol=1e-6)
    want = from_jax_params(ref["new_params"])
    for k, p in algo.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5,
                                   atol=2e-6, err_msg=k)


def test_hard_target_copy_rule():
    """The target copies the online net when the update count reaches a
    multiple of target_update_interval (JAX: counter % interval == 0)."""
    b = fixed_batch(2)
    ref = jax_side(b, 10.0)
    algo = torch_side(ref, 10.0, target_update_interval=2)
    initial = {k: v.clone() for k, v in algo.target_model.state_dict().items()}
    batch = torch_batch(b)
    algo.update(batch)
    for k, v in algo.target_model.state_dict().items():
        assert torch.equal(v, initial[k])
    algo.update(batch)
    online = algo.model.state_dict()
    for k, v in algo.target_model.state_dict().items():
        assert torch.equal(v, online[k])
        assert not torch.equal(v, initial[k])
    algo.update(batch)
    assert algo.update_counter == 3
    for k, v in algo.target_model.state_dict().items():
        assert not torch.equal(v, algo.model.state_dict()[k])


def test_polyak_target_rule_matches_jax():
    """tau < 1: after each update the target moves tau of the way to the
    online net (JAX: ops/value.py:polyak_update)."""
    b = fixed_batch(3)
    ref = jax_side(b, 10.0)
    algo = torch_side(ref, 10.0, target_update_tau=0.25)
    algo.update(torch_batch(b))
    online = {k: v.detach().numpy() for k, v in
              algo.model.state_dict().items()}
    want = from_jax_params(jax_polyak_update(
        ref["target"], to_jax_params(online, 4), 0.25))
    for k, v in algo.target_model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
