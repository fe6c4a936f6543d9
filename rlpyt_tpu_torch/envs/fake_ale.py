"""Scripted ALE stand-in (port of rlpyt_tpu/envs/fake_ale.py, copied:
numpy only, so it gives the JAX package's screens, rewards, lives,
``game_over`` and sticky actions bit for bit from the same seed).

``envs/atari.py:AtariEnv`` takes it as its emulator (``ale_factory=
FakeALE``) where ``ale_py`` and the ROMs are absent.  It implements the
ALE surface AtariEnv consumes -- ``act / lives / game_over / reset_game /
getScreenGrayscale / getMinimalActionSet / setInt / setFloat`` -- as a
small deterministic state machine.

Game rules (deterministic given random_seed):
- ``n_actions`` minimal actions; action ``reward_action`` yields +1
  score every ``reward_period``-th emulator frame (so a policy that
  learns to hold it beats random -- learnable by DQN).
- ``start_lives`` lives; a life ends every ``life_len`` acts; game over
  when lives hit 0.
- sticky actions: with prob ``repeat_action_probability`` the previous
  action is repeated (same semantic as the ALE's), driven by an RNG
  seeded via ``setInt("random_seed", s)``.
- screens: 210x160 uint8 pattern that is a pure function of
  (frame counter, last action, lives).
"""
from __future__ import annotations

import numpy as np


class FakeALE:
    raw_shape = (210, 160)

    def __init__(self, n_actions: int = 4, start_lives: int = 3,
                 life_len: int = 12, reward_action: int = 1,
                 reward_period: int = 3):
        self._n_actions = n_actions
        self._start_lives = start_lives
        self._life_len = life_len
        self._reward_action = reward_action
        self._reward_period = reward_period
        self._seed = 0
        self._rap = 0.0
        self.act_log: list = []  # effective (post-sticky) actions
        self.reset_game()

    # -- ALE configuration surface ------------------------------------

    def setInt(self, key: str, value: int):
        if key == "random_seed":
            self._seed = int(value)

    def setFloat(self, key: str, value: float):
        if key == "repeat_action_probability":
            self._rap = float(value)

    def loadROM(self, *_):
        pass

    def getMinimalActionSet(self):
        return list(range(self._n_actions))

    # -- emulation ------------------------------------------------------

    def reset_game(self):
        self._frame = 0
        self._lives = self._start_lives
        self._acts_this_life = 0
        self._last_a = 0
        self._rng = np.random.RandomState(self._seed)

    def lives(self) -> int:
        return self._lives

    def game_over(self) -> bool:
        return self._lives <= 0

    def act(self, a: int) -> float:
        if self._rng.random_sample() < self._rap:
            a = self._last_a  # sticky action
        self._last_a = int(a)
        self.act_log.append(self._last_a)
        self._frame += 1
        self._acts_this_life += 1
        rew = 1.0 if (a == self._reward_action
                      and self._frame % self._reward_period == 0) else 0.0
        if self._acts_this_life >= self._life_len:
            self._lives -= 1
            self._acts_this_life = 0
        return rew

    def screen_value(self) -> int:
        """The pattern fill value for the current emulator state."""
        return (self._frame * 7 + self._last_a * 13) % 251

    def getScreenGrayscale(self, out: np.ndarray):
        out[:] = self.screen_value()
        # Distinguishable probe pixels (row 1 survives the [1:-1:2]
        # subsample as output row 0).
        out[1, 0] = self._frame % 256
        out[1, 2] = self._last_a
        out[1, 4] = max(self._lives, 0)
