"""ALE Atari host environment (port of rlpyt_tpu/envs/atari.py; reference:
rlpyt/envs/atari/atari_env.py:AtariEnv ~L30-250).

A numpy env on the host, stepped by the farms of ``envs/host.py``; the
emulator cannot run on the card.  Its preprocessing is the reference's:

- grayscale screen, 2x subsample to **104x80** (``[1:-1:2, ::2]``),
- ``frame_skip=4`` with the max over the last two raw frames (the frame
  before the last act and the frame after it),
- a frame stack of ``num_img_obs=4``: obs uint8 [4, 104, 80] (NCHW),
- ``episodic_lives``: done on a life loss, but the emulator is not hard
  reset: the env acts a noop (and FIRE, with ``fire_on_reset``) past the
  lost life and zeroes the frame stack; the farm hard-resets only on
  ``traj_done`` (game over or the horizon), as rlpyt's collectors call
  ``env.reset()`` only on ``env_info.traj_done``,
- ``clip_reward``: reward = sign(game score); the raw score is always
  ``info["game_score"]`` (the GameScore trajectory stat),
- sticky actions (``repeat_action_probability``, applied by the ALE),
  ``fire_on_reset``, ``max_start_noops`` drawn from the env's own
  ``np.random.RandomState``, and the ``horizon`` as a truncation.

The emulator is injectable (``ale_factory``): ``envs/fake_ale.py:
FakeALE`` stands in where ``ale_py`` is absent; without a factory the
real emulator is built, and ``ale_py`` is imported only then.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.spaces import IntBox

H, W = 104, 80  # the reference's 2x-subsampled frame (atari_env.py ~L60)
RAW_H, RAW_W = 210, 160


def _real_ale(game: str, repeat_action_probability: float,
              seed: Optional[int]):
    """Build a real ale_py emulator (import gated at use time)."""
    try:
        from ale_py import ALEInterface
    except ImportError as e:
        raise ImportError(
            "AtariEnv needs ale_py (the C++ Atari emulator). Install "
            "ale_py + ROMs, or pass ale_factory= (e.g. the FakeALE test "
            "double), or use the on-device MinAtar path "
            "(rlpyt_tpu_torch.envs.minatar) / gymnasium host envs.") from e
    ale = ALEInterface()
    if seed is not None:
        ale.setInt("random_seed", int(seed) % (2 ** 31))
    ale.setFloat("repeat_action_probability", repeat_action_probability)
    import ale_py.roms as roms
    name = game.capitalize()
    ale.loadROM(getattr(roms, name) if hasattr(roms, name)
                else roms.get_rom_path(game))
    return ale


class AtariEnv:
    """Host env with the farm's contract: ``reset(seed) -> obs``;
    ``step(a) -> (obs, reward, terminated, truncated, info)``.

    ``info`` carries the reference's EnvInfo fields: ``game_score`` (the
    raw reward of this step) and ``traj_done`` (game over or horizon: it
    ends the trajectory and hard-resets the env, while ``done`` cuts
    bootstrapping and resets the rnn state)."""

    # The farm's static info schema (envs/host.py allocates one shared
    # block per key): name -> (dtype, shape).
    info_spec: Dict[str, Tuple[np.dtype, tuple]] = {
        "game_score": (np.dtype(np.float32), ()),
        "traj_done": (np.dtype(np.bool_), ()),
    }

    def __init__(self, game: str = "pong", frame_skip: int = 4,
                 num_img_obs: int = 4, clip_reward: bool = True,
                 episodic_lives: bool = True,
                 max_start_noops: int = 30,
                 repeat_action_probability: float = 0.25,
                 fire_on_reset: bool = False,
                 horizon: int = 27_000,
                 seed: Optional[int] = None,
                 ale_factory: Optional[Callable[[], Any]] = None):
        self.ale = (ale_factory() if ale_factory is not None
                    else _real_ale(game, repeat_action_probability, seed))
        if ale_factory is not None:
            # Configure the injected emulator as the real path does.
            if seed is not None:
                self.ale.setInt("random_seed", int(seed) % (2 ** 31))
            self.ale.setFloat("repeat_action_probability",
                              repeat_action_probability)
        self.game = game
        self.frame_skip = frame_skip
        self.num_img_obs = num_img_obs
        self.clip_reward = clip_reward
        self.episodic_lives = episodic_lives
        self.max_start_noops = max_start_noops
        self.fire_on_reset = fire_on_reset
        self.horizon = horizon
        self._actions = list(self.ale.getMinimalActionSet())
        self.action_space = IntBox(0, len(self._actions))
        self.observation_space = IntBox(0, 256,
                                        shape=(num_img_obs, H, W),
                                        dtype=torch.uint8)
        raw_h, raw_w = getattr(self.ale, "raw_shape", (RAW_H, RAW_W))
        self._raw = np.zeros((2, raw_h, raw_w), np.uint8)
        self._obs = np.zeros((num_img_obs, H, W), np.uint8)
        self._rng = np.random.RandomState(seed)
        self._t = 0
        self._lives = 0

    @property
    def spaces(self) -> EnvSpaces:
        return EnvSpaces(self.observation_space, self.action_space)

    def _subsample(self, raw: np.ndarray) -> np.ndarray:
        """210x160 -> 104x80 via [1:-1:2, ::2] (atari_env.py:_get_screen
        ~L150)."""
        return raw[1:-1:2, ::2]

    def _push_frame(self, frame: np.ndarray):
        self._obs[:-1] = self._obs[1:]
        self._obs[-1] = frame

    def _fire(self):
        """FIRE to start play (atari_env.py fire_and_up ~L200); minimal
        action sets put FIRE at index 1."""
        if len(self._actions) > 1:
            self.ale.act(self._actions[1])

    def _life_reset(self):
        """Act past the lost-life freeze (atari_env.py:_life_reset ~L210):
        one noop (and FIRE), then re-latch the lives."""
        self.ale.act(0)
        if self.fire_on_reset:
            self._fire()
        self._lives = self.ale.lives()

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        """Hard reset of the game (atari_env.py:reset ~L100), called by
        the farms at ``traj_done`` only.  ``seed`` re-seeds the noop-start
        RNG and the emulator."""
        if seed is not None:
            self._rng = np.random.RandomState(seed)
            self.ale.setInt("random_seed", int(seed) % (2 ** 31))
        self.ale.reset_game()
        self._obs[:] = 0
        for _ in range(self._rng.randint(0, self.max_start_noops + 1)):
            self.ale.act(0)
        if self.fire_on_reset:
            self._fire()
        self._lives = self.ale.lives()
        self.ale.getScreenGrayscale(self._raw[0])
        self._push_frame(self._subsample(self._raw[0]))
        self._t = 0
        return self._obs.copy()

    def step(self, action):
        """(atari_env.py:step ~L110).  In the reference's order: the
        frame-skip acts (the screen captured before the last act), the
        life check (a life reset acts on the emulator), the final screen
        and the max-pool, the frame push (onto a zeroed stack after a
        lost life)."""
        a = self._actions[int(action)]
        game_score = 0.0
        for k in range(self.frame_skip):
            game_score += self.ale.act(a)
            if k == self.frame_skip - 2:
                self.ale.getScreenGrayscale(self._raw[1])

        lives = self.ale.lives()
        lost_life = (lives < self._lives) and (lives > 0)
        if lost_life:
            self._life_reset()
        game_over = bool(self.ale.game_over())

        self.ale.getScreenGrayscale(self._raw[0])
        np.maximum(self._raw[0], self._raw[1], out=self._raw[0])
        if lost_life and self.episodic_lives:
            self._obs[:] = 0  # the reference's _reset_obs (~L190)
        self._push_frame(self._subsample(self._raw[0]))

        self._t += 1
        truncated = (self._t >= self.horizon) and not game_over
        terminated = game_over or (self.episodic_lives and lost_life)
        traj_done = game_over or truncated
        reward = float(np.sign(game_score)) if self.clip_reward \
            else float(game_score)
        info = {"game_score": np.float32(game_score),
                "traj_done": traj_done}
        return (self._obs.copy(), reward, bool(terminated),
                bool(truncated), info)

    def close(self):
        pass


def make_atari_env(ale_factory: Optional[str] = None, **kwargs) -> AtariEnv:
    """An AtariEnv whose emulator factory is named by import path
    (``"module:attr"``, e.g. ``"rlpyt_tpu_torch.envs.fake_ale:FakeALE"``),
    so that ``functools.partial(make_atari_env, ...)`` pickles and a farm
    can start its workers with ``spawn``."""
    if ale_factory is not None:
        import importlib
        module, attr = ale_factory.split(":")
        kwargs["ale_factory"] = getattr(importlib.import_module(module),
                                        attr)
    return AtariEnv(**kwargs)
