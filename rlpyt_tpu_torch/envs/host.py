"""Host-environment bridge (port of rlpyt_tpu/envs/host.py; reference:
rlpyt/envs/gym.py:GymEnvWrapper and rlpyt/samplers/parallel/'s worker
and shared-memory machinery -- samplers/parallel/base.py:
ParallelSamplerBase, worker.py:sampling_process, gpu/action_server.py).

Environments that cannot run on the card (ALE, gymnasium, any C++
simulator) step on the host, in numpy:

- ``GymEnv``: one gymnasium env under the farm's contract, with
  ``timeout`` for a TimeLimit truncation; gymnasium is imported only
  when one is built.
- ``SharedMemVecEnv``: B envs over W worker processes writing into
  OS-shared numpy blocks, one barrier a step (the C futex barrier of
  ``csrc/hostfarm.c``, or multiprocessing.Event pairs) -- rlpyt's
  GpuSampler topology: workers step envs, the master batches inference.
  Workers are numpy only and never touch CUDA.  The farm spawns its
  workers when every env spec pickles (gym ids, or a
  ``functools.partial`` of a module-level builder such as
  ``envs/atari.py:make_atari_env``), which is safe after CUDA is up;
  otherwise it forks, which is safe only before.
- ``SerialVecEnv``: the same in one process (rlpyt's SerialSampler).
- ``PairedVecEnv``: two farms stepped out of phase by the alternating
  collection of ``runners/host.py``.

The card side of the bridge is ``runners/host.py:HostMinibatchRl``.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.envs.gym_space import convert_gym_space


def tmap(fn, tree, *rest):
    """Map over host observation trees (a dict of arrays, possibly
    nested, or a bare array): the host mirror of the dict observations
    of a Composite space."""
    if isinstance(tree, dict):
        return {k: tmap(fn, tree[k], *[r[k] for r in rest]) for k in tree}
    return fn(tree, *rest)


def twrite(dst, b, src):
    """``dst[b] = src`` on every leaf of an obs tree."""
    if isinstance(dst, dict):
        for k in dst:
            twrite(dst[k], b, src[k])
    else:
        dst[b] = src


def tconcat(trees):
    """Concatenate a list of obs trees along axis 0."""
    if isinstance(trees[0], dict):
        return {k: tconcat([t[k] for t in trees]) for k in trees[0]}
    return np.concatenate([np.asarray(t) for t in trees])


def null_numpy(space):
    """A space's null value as numpy (a dict for a Composite)."""
    return tmap(lambda x: x.numpy(), space.null_value("cpu"))


class GymEnv:
    """(rlpyt/envs/gym.py:GymEnvWrapper ~L10).  One gymnasium env:
    terminated / truncated stay apart (the farm makes ``done`` and
    ``timeout`` of them); dict observations pass through as dicts of
    arrays."""

    def __init__(self, id_or_env, **kwargs):
        if isinstance(id_or_env, str):
            import gymnasium
            self.env = gymnasium.make(id_or_env, **kwargs)
        else:
            self.env = id_or_env
        self.observation_space = convert_gym_space(self.env.observation_space)
        self.action_space = convert_gym_space(self.env.action_space)

    @property
    def spaces(self) -> EnvSpaces:
        return EnvSpaces(self.observation_space, self.action_space)

    def reset(self, seed: Optional[int] = None):
        obs, _ = self.env.reset(seed=seed)
        return tmap(np.asarray, dict(obs) if isinstance(obs, dict)
                    else obs)

    def step(self, action):
        obs, reward, terminated, truncated, _ = self.env.step(action)
        obs = tmap(np.asarray, dict(obs) if isinstance(obs, dict) else obs)
        return obs, float(reward), bool(terminated), bool(truncated)

    def close(self):
        self.env.close()


CMD_STEP, CMD_RESET, CMD_CLOSE = 0, 1, 2


def _make_env(spec):
    """spec: a gym id string or a callable.  A callable may return a
    gymnasium env (wrapped in GymEnv) or an object already speaking the
    host contract (``.spaces``, reset, step -- e.g. envs/atari.py:
    AtariEnv), used as it is."""
    if isinstance(spec, str):
        return GymEnv(spec)
    env = spec()
    return env if hasattr(env, "spaces") else GymEnv(env)


def _info_spec(env) -> Dict[str, Tuple[np.dtype, tuple]]:
    """The static per-step info schema; ``timeout`` has its own block."""
    return dict(getattr(env, "info_spec", {}))


def _step5(env, action):
    """env.step as (obs, reward, terminated, truncated, info); an env
    without an info channel returns 4 values."""
    out = env.step(action)
    if len(out) == 4:
        return out + ({},)
    return out


def _picklable(obj) -> bool:
    try:
        pickle.dumps(obj)
        return True
    except Exception:
        return False


class _EventMasterSync:
    """multiprocessing.Event barrier (portable; 2·W syscalls a step).
    The fast path is the futex barrier of csrc/hostfarm.c."""

    def __init__(self, pairs, cmd_value):
        self._pairs = pairs
        self._cmd = cmd_value

    def signal(self, cmd: int):
        self._cmd.value = cmd
        for act_ready, _ in self._pairs:
            act_ready.set()

    def wait(self):
        for _, obs_ready in self._pairs:
            obs_ready.wait()
            obs_ready.clear()


class _EventWorkerSync:
    def __init__(self, act_ready, obs_ready, cmd_value):
        self._act = act_ready
        self._obs = obs_ready
        self._cmd = cmd_value

    def wait(self) -> int:
        self._act.wait()
        self._act.clear()
        return int(self._cmd.value)

    def post(self):
        self._obs.set()


def _step_env(env, action):
    """One step of a farm lane: (obs, reward, done, timeout, info).  An
    env reporting ``traj_done`` (episodic-lives Atari) is hard-reset only
    on it, so a life-loss done leaves the emulator mid-game, as rlpyt's
    CpuResetCollector calls env.reset() only on ``env_info.traj_done``."""
    obs, rew, terminated, truncated, info = _step5(env, action)
    done = terminated or truncated
    if info.get("traj_done", done):
        obs = env.reset()
    return obs, rew, done, truncated and not terminated, info


def _worker(env_fns, lo, hi, shm, info_shm, sync, seed,
            cpu: Optional[int], ready_spec=None):
    """(rlpyt/samplers/parallel/worker.py:sampling_process ~L10): own the
    envs [lo, hi), loop on the step barrier, reset as ``_step_env``
    says."""
    if cpu is not None:
        try:
            os.sched_setaffinity(0, {cpu})
        except OSError:
            pass
    envs = [_make_env(fn) for fn in env_fns[lo:hi]]
    obs_spec, act_spec, rew_spec, done_spec, timeout_spec = shm
    obs_np = tmap(lambda sp: sp.view(), obs_spec)
    act_np, rew_np, done_np, timeout_np = (
        spec.view() for spec in (act_spec, rew_spec, done_spec,
                                 timeout_spec))
    info_np = {k: spec.view() for k, spec in info_shm.items()}
    if ready_spec is not None:
        # Startup handshake: the master polls this instead of blocking on
        # the barrier, so a worker that dies during init raises there.
        ready_spec.view()[lo:hi] = True
    while True:
        c = sync.wait()
        if c == CMD_CLOSE:
            for e in envs:
                e.close()
            sync.post()
            return
        for i, env in enumerate(envs):
            b = lo + i
            if c == CMD_RESET:
                twrite(obs_np, b, env.reset(seed=seed + b))
                rew_np[b] = 0.0
                done_np[b] = False
                timeout_np[b] = False
                for v in info_np.values():
                    v[b] = 0
            else:
                obs, rew_np[b], done_np[b], timeout_np[b], info = \
                    _step_env(env, act_np[b])
                twrite(obs_np, b, obs)
                for k, v in info_np.items():
                    v[b] = info.get(k, 0)
        sync.post()


class _ShmSpec:
    """RawArray handle with shape and dtype; picklable for spawned
    workers, which rebuild numpy views over the same shared pages."""

    def __init__(self, shape, dtype, ctx):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        size = max(1, int(np.prod(shape)) * self.dtype.itemsize)
        self.raw = ctx.RawArray("b", size)

    def view(self) -> np.ndarray:
        return np.frombuffer(self.raw, dtype=self.dtype).reshape(self.shape)


class SharedMemVecEnv:
    """B host envs over W workers and shared-memory step buffers (rlpyt
    ParallelSamplerBase.initialize ~L40).  ``step`` returns views of the
    shared blocks, which the next step overwrites."""

    def __init__(self, env_fns: Sequence, n_workers: int = 0,
                 seed: int = 0, cpus: Optional[Sequence[int]] = None,
                 start_method: Optional[str] = None, sync: str = "auto"):
        """``env_fns``: gym ids or callables.  ``start_method``: by
        default ``spawn`` when ``env_fns`` pickle, else ``fork`` (then
        build the farm before CUDA is initialized).

        ``sync``: "c" = the futex barrier (csrc/hostfarm.c, one C call
        per side per step; raises if the library does not build),
        "events" = multiprocessing.Event pairs, "auto" = C when the
        library builds, else events."""
        self.B = len(env_fns)
        probe = _make_env(env_fns[0])
        self.spaces = probe.spaces
        obs_null = null_numpy(self.spaces.observation)
        act_null = null_numpy(self.spaces.action)
        info_spec = _info_spec(probe)
        probe.close()

        W = n_workers or min(self.B, os.cpu_count() or 1)
        if self.B % W:
            raise ValueError(f"B={self.B} must divide over {W} workers")
        per = self.B // W
        if start_method is None:
            start_method = "spawn" if _picklable(list(env_fns)) else "fork"
        self.start_method = start_method
        ctx = mp.get_context(start_method)

        obs_spec = tmap(
            lambda x: _ShmSpec((self.B,) + x.shape, x.dtype, ctx),
            obs_null)
        shm = (
            obs_spec,
            _ShmSpec((self.B,) + act_null.shape, act_null.dtype, ctx),
            _ShmSpec((self.B,), np.float32, ctx),
            _ShmSpec((self.B,), np.bool_, ctx),
            _ShmSpec((self.B,), np.bool_, ctx),
        )
        self.obs = tmap(lambda sp: sp.view(), obs_spec)
        self.act, self.rew, self.done, self.timeout = (
            sp.view() for sp in shm[1:])
        info_shm = {k: _ShmSpec((self.B,) + tuple(shape), dtype, ctx)
                    for k, (dtype, shape) in info_spec.items()}
        self.info = {k: sp.view() for k, sp in info_shm.items()}

        from rlpyt_tpu_torch.envs import hostfarm_c
        use_c = sync == "c" or (sync == "auto"
                                and hostfarm_c.get_lib() is not None)
        if use_c and hostfarm_c.get_lib() is None:
            raise RuntimeError("sync='c' requested but the hostfarm "
                               "library failed to build")
        if use_c:
            ctrl = _ShmSpec(
                (hostfarm_c.CTRL_SLOTS_BASE
                 + hostfarm_c.CTRL_SLOTS_PER_WORKER * W,),
                np.uint32, ctx)
            self._sync = hostfarm_c.CFarmMaster(ctrl, W)
            worker_syncs = [hostfarm_c.CFarmWorker(ctrl, w)
                            for w in range(W)]
        else:
            cmd_value = ctx.Value("i", CMD_STEP)
            pairs = [(ctx.Event(), ctx.Event()) for _ in range(W)]
            self._sync = _EventMasterSync(pairs, cmd_value)
            worker_syncs = [_EventWorkerSync(a, o, cmd_value)
                            for a, o in pairs]
        self.sync_impl = "c" if use_c else "events"

        ready_spec = _ShmSpec((self.B,), np.bool_, ctx)
        self._ready = ready_spec.view()
        self._procs = []
        self.closed = False
        for w in range(W):
            cpu = cpus[w % len(cpus)] if cpus else None
            p = ctx.Process(
                target=_worker,
                args=(list(env_fns), w * per, (w + 1) * per, shm,
                      info_shm, worker_syncs[w], seed, cpu, ready_spec),
                daemon=True)
            p.start()
            self._procs.append(p)
        self._await_workers(timeout=120.0)

    def _await_workers(self, timeout: float):
        """Fail fast, not deadlock on the barrier, when a worker dies
        during startup (rlpyt's crashed-worker-hangs-the-barrier
        failure)."""
        deadline = time.monotonic() + timeout
        while not bool(self._ready.all()):
            dead = [p for p in self._procs if not p.is_alive()]
            if dead or time.monotonic() > deadline:
                # Closed before raising, so close() never signals the
                # barrier at dead or wedged workers.
                self.closed = True
                for p in self._procs:
                    p.terminate()
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} farm worker(s) died during startup "
                        f"(exitcodes {[p.exitcode for p in dead]}). A "
                        f"'spawn' farm cannot re-import an interactive or "
                        "stdin __main__: run from a file, or pass "
                        "start_method='fork' before CUDA is initialized.")
                raise RuntimeError("farm workers not ready within "
                                   f"{timeout}s")
            time.sleep(0.02)

    def _signal_and_wait(self, cmd: int):
        self._sync.signal(cmd)
        self._sync.wait()

    def reset(self):
        self._signal_and_wait(CMD_RESET)
        return self.obs

    def step(self, actions: np.ndarray):
        """Write the actions, step every worker, return views of the
        shared blocks: (obs, reward, done, timeout)."""
        self.act[...] = actions
        self._signal_and_wait(CMD_STEP)
        return self.obs, self.rew, self.done, self.timeout

    def close(self):
        if not self.closed:
            self.closed = True
            self._signal_and_wait(CMD_CLOSE)
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SerialVecEnv:
    """The host envs in one process (rlpyt SerialSampler)."""

    def __init__(self, env_fns: Sequence[Callable], seed: int = 0, **_):
        self.envs = [_make_env(fn) for fn in env_fns]
        self.B = len(self.envs)
        self.spaces = self.envs[0].spaces
        self.seed = seed
        obs_null = null_numpy(self.spaces.observation)
        self.obs = tmap(
            lambda x: np.zeros((self.B,) + x.shape, x.dtype), obs_null)
        self.rew = np.zeros((self.B,), np.float32)
        self.done = np.zeros((self.B,), np.bool_)
        self.timeout = np.zeros((self.B,), np.bool_)
        self.info = {k: np.zeros((self.B,) + tuple(shape), dtype)
                     for k, (dtype, shape)
                     in _info_spec(self.envs[0]).items()}

    def reset(self):
        for b, env in enumerate(self.envs):
            twrite(self.obs, b, env.reset(seed=self.seed + b))
        for v in self.info.values():
            v[:] = 0
        return self.obs

    def step(self, actions: np.ndarray):
        for b, env in enumerate(self.envs):
            obs, self.rew[b], self.done[b], self.timeout[b], info = \
                _step_env(env, actions[b])
            twrite(self.obs, b, obs)
            for k, v in self.info.items():
                v[b] = info.get(k, 0)
        return self.obs, self.rew, self.done, self.timeout

    def close(self):
        for env in self.envs:
            env.close()


class PairedVecEnv:
    """Two farm halves stepped out of phase by the alternating collection
    (rlpyt samplers/parallel/gpu/alternating_sampler.py:
    AlternatingSampler ~L15).  As one vec env it is B = B_a + B_b lanes,
    half a first; the alternating collector reaches the halves through
    ``.halves``."""

    def __init__(self, vec_a, vec_b):
        self.halves = (vec_a, vec_b)
        self.B = vec_a.B + vec_b.B
        self.spaces = vec_a.spaces

    @property
    def obs(self):
        return tconcat([h.obs for h in self.halves])

    @property
    def info(self) -> Dict[str, np.ndarray]:
        a, b = (getattr(h, "info", {}) for h in self.halves)
        return {k: np.concatenate([np.asarray(a[k]), np.asarray(b[k])])
                for k in a}

    def reset(self):
        return tconcat([h.reset() for h in self.halves])

    def step(self, actions: np.ndarray):
        """Both halves in lock step (the non-alternating path)."""
        b_a = self.halves[0].B
        out_a = self.halves[0].step(actions[:b_a])
        out_b = self.halves[1].step(actions[b_a:])
        return tuple(tconcat([a, b]) for a, b in zip(out_a, out_b))

    def close(self):
        for h in self.halves:
            h.close()
