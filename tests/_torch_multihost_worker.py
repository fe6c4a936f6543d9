"""Worker processes of tests/test_torch_parallel.py and
tests/test_torch_multihost.py (the port's twins of _multihost_worker.py
and _multihost_farm_worker.py).  It imports the port only, no JAX.

- ``dp_update_rank``: one rank of a data-parallel update from a common
  replay: every rank collects the same [T, B] batches on the CPU with the
  same weights, appends only its lanes, and runs the algorithm's updates
  under a ``DpShard``; with ``world=None`` the single-process update.
- ``python _torch_multihost_worker.py COORD N RANK [farm]``: a process
  of a two-process group joined by ``init_distributed``; it runs SyncRl
  DQN on CartPole (or, with ``farm``, a DQN over a ``SharedMemVecEnv``
  slice of gymnasium CartPole envs) and prints a digest of its final
  parameters and its lane slice.
"""
import os
import sys

import numpy as np
import torch

from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector


def build_case(case: str):
    """(env, agent, algo, batch_spec) of one update case, at small widths
    on the CPU."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent, R2d1Agent
    from rlpyt_tpu_torch.agents.pg import (CategoricalPgAgent,
                                           RecurrentCategoricalPgAgent)
    from rlpyt_tpu_torch.agents.qpg import SacAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.algos.pg import PPO
    from rlpyt_tpu_torch.algos.qpg import SAC
    from rlpyt_tpu_torch.algos.r2d1 import R2D1
    from rlpyt_tpu_torch.envs.classic import Pendulum
    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.envs.synthetic_atari import SyntheticAtariEnv
    from rlpyt_tpu_torch.models.pg import AtariFfModel, AtariLstmModel

    conv = dict(channels=(8,), kernel_sizes=(3,), strides=(1,),
                paddings=(0,), obs_divisor=1.0)
    cpu = dict(device="cpu")
    if case == "dqn":   # prioritized flat replay, n-step 3, double
        return (Breakout(**cpu),
                DqnAgent(model_kwargs=dict(conv, fc_sizes=(32,)), **cpu),
                DQN(batch_size=32, min_steps_learn=3 * 128,
                    replay_size=4096, replay_ratio=0.5, n_step_return=3,
                    double_dqn=True, prioritized_replay=True,
                    learning_rate=1e-3),
                BatchSpec(16, 8))
    if case == "dqn_frame":   # uniform frame replay (the frame gather)
        return (SyntheticAtariEnv("cpu"),
                DqnAgent(model_kwargs=dict(channels=(4, 4, 4),
                                           fc_sizes=(16,)), **cpu),
                DQN(batch_size=16, min_steps_learn=3 * 64, replay_size=1024,
                    replay_ratio=0.5, frame_buffer=True, learning_rate=1e-3),
                BatchSpec(8, 8))
    if case == "r2d1":   # prioritized sequence replay, input priorities
        return (Breakout(**cpu),
                R2d1Agent(model_kwargs=dict(conv, fc_sizes=(32,),
                                            lstm_size=16), **cpu),
                R2D1(batch_b=8, batch_T=8, warmup_T=4, n_step_return=2,
                     min_steps_learn=3 * 128, replay_size=1024,
                     replay_ratio=1.0, learning_rate=1e-3),
                BatchSpec(16, 8))
    if case == "ppo":   # the permutation of T*B samples, advantage moments
        return (Breakout(**cpu),
                CategoricalPgAgent(ModelCls=AtariFfModel,
                                   model_kwargs=dict(conv, fc_sizes=(32,)),
                                   **cpu),
                PPO(epochs=2, minibatches=4, normalize_advantage=True,
                    learning_rate=1e-3),
                BatchSpec(16, 8))
    if case == "lstm_ppo":   # the permutation of lanes
        return (Breakout(**cpu),
                RecurrentCategoricalPgAgent(
                    ModelCls=AtariLstmModel,
                    model_kwargs=dict(conv, fc_sizes=(32,), lstm_size=16),
                    **cpu),
                PPO(epochs=2, minibatches=2, normalize_advantage=True,
                    learning_rate=1e-3),
                BatchSpec(16, 8))
    if case == "sac":   # the normals drawn for every row of the draw
        return (Pendulum(**cpu),
                SacAgent(model_kwargs=dict(hidden_sizes=(32, 32)),
                         q_model_kwargs=dict(hidden_sizes=(32, 32)), **cpu),
                SAC(batch_size=32, min_steps_learn=3 * 64, replay_size=2048,
                    replay_ratio=1.0),
                BatchSpec(8, 8))
    raise ValueError(case)


N_BATCHES = {"ppo": 1, "lstm_ppo": 1}   # others: 3, learning on the last


def lanes_of(tree, lanes: slice, dim: int):
    """Each tensor of ``tree`` with more than ``dim`` dims, cut to
    ``lanes`` on ``dim``."""
    from rlpyt_tpu_torch.struct import tree_map
    return tree_map(lambda x: x.narrow(dim, lanes.start,
                                       lanes.stop - lanes.start)
                    if isinstance(x, torch.Tensor) and x.dim() > dim else x,
                    tree)


def dp_update(case: str, shard=None) -> dict:
    """The case's updates on this process's lanes (all without
    ``shard``); returns the model's state and the algorithm's.  A case
    ending in ``_idle`` zeroes the priorities of the upper half of the
    lanes after each append, so the draws hold no row of rank 1's."""
    torch.manual_seed(0)
    base = case.removesuffix("_idle")
    env, agent, algo, spec = build_case(base)
    agent.initialize(env.spaces)
    gen = torch.Generator().manual_seed(1)
    collector = Collector(env, agent, spec, discount=float(algo.discount))
    state = collector.init_state(gen)
    batches = []
    for _ in range(N_BATCHES.get(base, 3)):
        state, samples = collector.collect(state, gen)
        batches.append((samples, state))
    lanes = slice(0, spec.B) if shard is None else shard.lanes(spec.B)
    algo.shard = shard
    algo.initialize(agent, spec, lanes_of(state.observation, lanes, 0),
                    torch.Generator().manual_seed(2), n_itr=1)
    if case.endswith("_idle"):
        append = algo.replay.append

        def append_then_mask(*args):
            append(*args)
            algo.replay.priorities[:, spec.B // 2:] = 0.0

        algo.replay.append = append_then_mask
    for samples, st in batches:
        local = st._replace(
            observation=lanes_of(st.observation, lanes, 0),
            prev_action=lanes_of(st.prev_action, lanes, 0),
            prev_reward=lanes_of(st.prev_reward, lanes, 0),
            agent_carry=lanes_of(st.agent_carry, lanes, 0))
        info = algo.optimize(lanes_of(samples, lanes, 1), local)
    return {"model": agent.model.state_dict(), "algo": algo.state_dict(),
            "info": tuple(info), "updates": algo.update_counter}


def dp_update_rank(rank: int, world: int, address: str, case: str,
                   out: str):
    """One rank of ``dp_update`` over a gloo group; saves its result."""
    from rlpyt_tpu_torch.parallel.mesh import DpShard, init_distributed
    torch.set_num_threads(1)
    init_distributed(address, world, rank, "gloo", timeout=120)
    try:
        result = dp_update(case, DpShard(rank, world))
    finally:
        torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def shard_check_rank(rank: int, world: int, address: str, out: str):
    """shard_params(min_size=1) over an mp group of ``world``: which
    layers split, their local shapes, and the largest difference of the
    split model's outputs and gradients from the whole model's."""
    import copy

    from rlpyt_tpu_torch.models.pg import AtariFfModel
    from rlpyt_tpu_torch.parallel.mesh import (MeshSpec, full_tensor,
                                               init_distributed, is_sharded,
                                               shard_params)
    torch.set_num_threads(1)
    init_distributed(address, world, rank, "gloo", timeout=120)
    try:
        torch.manual_seed(0)
        model = AtariFfModel((4, 10, 10), 6, fc_sizes=(16,), channels=(8,),
                             kernel_sizes=(3,), strides=(1,), paddings=(0,),
                             obs_divisor=1.0)
        whole = copy.deepcopy(model)
        shard_params(model, MeshSpec(dp=1, mp=world).make("cpu"),
                     min_size=1)
        x = torch.rand((5, 4, 10, 10), generator=torch.Generator()
                       .manual_seed(3))
        outs = [m(x) for m in (model, whole)]
        for pi, v in outs:
            (pi.square().sum() + v.sum()).backward()
        errs = [(a - b).abs().max().item()
                for a, b in zip(outs[0], outs[1])]
        for (name, p), q in zip(model.named_parameters(),
                                whole.parameters()):
            errs.append((full_tensor(p) - q).abs().max().item())
            errs.append((full_tensor(p.grad) - q.grad).abs().max().item())
        result = {
            "split": sorted({n.rsplit(".", 1)[0] for n, p
                             in model.named_parameters() if is_sharded(p)}),
            "local_shapes": {n: tuple(p.to_local().shape) for n, p
                             in model.named_parameters() if is_sharded(p)},
            "max_err": max(errs)}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(out, f"shard{rank}.pt"))


def digest(module) -> float:
    return float(sum(p.detach().abs().sum().item()
                     for p in module.parameters()))


def syncrl_main(coordinator: str, n: int, rank: int):
    """SyncRl DQN on CartPole across the two processes."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.envs.classic import CartPole
    from rlpyt_tpu_torch.models.dqn import DqnMlpModel
    from rlpyt_tpu_torch.parallel.mesh import (MeshSpec, host_env_slice,
                                               init_distributed)
    from rlpyt_tpu_torch.runners.sync import SyncRl

    assert init_distributed(coordinator, n, rank, "gloo", 120) == rank
    B = 16
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(32, 32)),
                     eps_steps=2_000, eps_final=0.1, device="cpu")
    algo = DQN(batch_size=32, min_steps_learn=128, replay_size=4_096,
               replay_ratio=2.0, target_update_interval=50,
               learning_rate=1e-3)
    runner = SyncRl(algo=algo, agent=agent, env=CartPole(device="cpu"),
                    batch_spec=BatchSpec(T=16, B=B), n_steps=1_024, seed=7,
                    log_interval_steps=512, max_decorrelation_steps=0,
                    mesh=MeshSpec(dp=n), device="cpu")
    state = runner.train()
    # Each process collected only its lanes.
    assert state["rollout_state"].observation.shape[0] == B // n
    assert state["algo"]["replay"]["data"].reward.shape[1] == B // n
    sl = host_env_slice(B)
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK rank={rank} digest={digest(agent.model):.10e} "
          f"slice={sl.start}:{sl.stop} "
          f"cum={state['rollout_state'].cum_steps}", flush=True)


def farm_main(coordinator: str, n: int, rank: int):
    """A DQN whose lanes are gymnasium CartPole envs in a
    SharedMemVecEnv slice of each process; one global update an
    iteration over the shard."""
    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.envs.host import SharedMemVecEnv
    from rlpyt_tpu_torch.models.dqn import DqnMlpModel
    from rlpyt_tpu_torch.parallel.mesh import (DpShard, host_env_slice,
                                               init_distributed)
    from rlpyt_tpu_torch.samplers.rollout import RolloutState, Samples

    T, B, N_ITRS = 16, 8, 8
    init_distributed(coordinator, n, rank, "gloo", 120)
    sl = host_env_slice(B)
    B_local = sl.stop - sl.start
    farm = SharedMemVecEnv(["CartPole-v1"] * B_local, n_workers=2,
                           seed=100 + sl.start)
    torch.manual_seed(11)
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(32, 32)),
                     eps_steps=1_000, eps_final=0.1, device="cpu")
    agent.initialize(farm.spaces)
    algo = DQN(batch_size=32, min_steps_learn=64, replay_size=2_048,
               replay_ratio=2.0, target_update_interval=50,
               learning_rate=1e-3)
    algo.shard = DpShard(rank, n)
    obs = torch.as_tensor(np.array(farm.reset()))
    algo.initialize(agent, BatchSpec(T, B), obs,
                    torch.Generator().manual_seed(12), n_itr=N_ITRS)
    gen = torch.Generator().manual_seed(1000 + rank)
    prev_a = torch.zeros((B_local,), dtype=torch.int64)
    prev_r = torch.zeros((B_local,))
    cum = 0
    for _ in range(N_ITRS):
        rec = {k: [] for k in ("obs", "act", "rew", "done", "to", "pa",
                               "pr")}
        for t in range(T):
            step, _ = agent.step(obs, prev_a, prev_r, None, cum + t * B, gen)
            act = step.action
            rec["obs"].append(obs)
            rec["pa"].append(prev_a)
            rec["pr"].append(prev_r)
            o, rew, done, to = farm.step(act.numpy())
            obs = torch.as_tensor(np.array(o))
            done = torch.as_tensor(np.array(done))
            rew = torch.as_tensor(np.array(rew, np.float32))
            rec["act"].append(act)
            rec["rew"].append(rew)
            rec["done"].append(done)
            rec["to"].append(torch.as_tensor(np.array(to)))
            prev_a = torch.where(done, 0, act)
            prev_r = torch.where(done, 0.0, rew)
        cum += T * B
        stack = {k: torch.stack(v) for k, v in rec.items()}
        samples = Samples(stack["obs"], stack["act"], stack["rew"],
                          stack["done"], stack["pa"], stack["pr"], {},
                          {"timeout": stack["to"]})
        ro = RolloutState(None, obs, prev_a, prev_r, None, cum,
                          *(None,) * 7)
        algo.optimize(samples, ro)
    farm.close()
    torch.distributed.destroy_process_group()
    print(f"FARMHOST_OK rank={rank} digest={digest(agent.model):.10e} "
          f"slice={sl.start}:{sl.stop} updates={algo.update_counter}",
          flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main = farm_main if sys.argv[4:5] == ["farm"] else syncrl_main
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
