"""The MinAtar games on batched tensors (port of
rlpyt_tpu/envs/minatar.py: MinAtarEnv, Breakout, SpaceInvaders, Asterix,
Freeway, Seaquest, MINATAR_ENVS, make_minatar).

The JAX package writes each game for one instance and vmaps it; here a
game steps all B lanes at once on [B] and [B, 10, 10] tensors on the
env's device.  Every grid the reference writes by scatter is built here
from comparisons with the cell indices: a position off the grid matches
no cell, which is what the reference's clipped or dropped scatter gives,
and no index ever leaves its tensor.  A step is a fixed sequence of
launches with no host sync.

Randomness is split from the rules.  ``draw_step`` / ``draw_reset``
draw a game's raw random values, one [B] field (or [B, 8]) for each
``jax.random`` call of the reference's step or reset, with its range and
dtype; ``step_batch`` / ``reset_batch`` apply the rules to them.  A
caller may pass ``draws=`` to inject the values that the reference's
per-lane keys give.

Conventions, as in the reference: 10x10 grid, [C, 10, 10] uint8
observations in {0, 1}; six actions (0 noop, 1 left, 2 up, 3 right,
4 down, 5 fire); sticky actions repeat the last action with probability
0.1; ``max_steps`` truncates an episode and sets the ``timeout`` info
flag.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.envs.base import Env, EnvStep
from rlpyt_tpu_torch.spaces import IntBox

I32 = torch.int32
NOOP, LEFT, UP, RIGHT, DOWN, FIRE = range(6)
N_LANES = 8   # entity lanes on rows 1-8 (Asterix, Freeway, Seaquest)


def _uniform(n, g, shape=()):
    """``jax.random.uniform``: float32 in [0, 1)."""
    return torch.rand((n,) + shape, generator=g, device=g.device)


def _randint(lo, hi, n, g, shape=()):
    """``jax.random.randint``: int32 in [lo, hi)."""
    return torch.randint(lo, hi, (n,) + shape, generator=g, device=g.device,
                         dtype=I32)


class MinAtarEnv(Env):
    """Shared plumbing: 6-action space, [C, 10, 10] binary observations,
    sticky actions, time limit."""

    n_channels: int = 4

    def __init__(self, sticky_action_prob: float = 0.1,
                 ramping: bool = True, max_steps: int = 5000,
                 device="cuda"):
        self.sticky_action_prob = sticky_action_prob
        self.ramping = ramping
        self.max_steps = max_steps
        self.device = torch.device(device)
        self._idx = torch.arange(10, device=self.device)
        self._lane_rows = torch.arange(1, N_LANES + 1, device=self.device)
        self._lane_ids = torch.arange(N_LANES, device=self.device)

    @property
    def observation_space(self):
        return IntBox(0, 2, (self.n_channels, 10, 10), torch.uint8)

    @property
    def action_space(self):
        return IntBox(0, 6)

    @property
    def horizon(self):
        return self.max_steps

    # -- randomness ------------------------------------------------------

    def draw_reset(self, n: int, generator: torch.Generator):
        """Raw random values of a reset; None for a game whose reset is
        deterministic."""
        return None

    def draw_step(self, n: int, generator: torch.Generator):
        raise NotImplementedError

    def _on_device(self, draws):
        return None if draws is None else type(draws)(
            *(d.to(self.device) for d in draws))

    # -- batched API -----------------------------------------------------

    def reset_batch(self, n: int, generator: Optional[torch.Generator] = None,
                    draws=None):
        if draws is None:
            draws = self.draw_reset(n, generator)
        s = self._reset(n, self._on_device(draws))
        return s, self._obs(s)

    def step_batch(self, state, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None, draws=None):
        if draws is None:
            draws = self.draw_step(action.shape[0], generator)
        return self._step(state, action.to(I32), self._on_device(draws))

    def _reset(self, n: int, draws):
        raise NotImplementedError

    def _step(self, s, a, draws):
        raise NotImplementedError

    def _obs(self, s) -> torch.Tensor:
        raise NotImplementedError

    # -- helpers ---------------------------------------------------------

    def _full(self, n: int, value, dtype=I32):
        return torch.full((n,), value, dtype=dtype, device=self.device)

    def _sticky(self, u, action, last_action):
        if self.sticky_action_prob <= 0.0:
            return action
        return torch.where(u < self.sticky_action_prob, last_action, action)

    @staticmethod
    def _move(x, a, minus, plus, lo, hi):
        """x - (a == minus) + (a == plus), clipped to [lo, hi]."""
        return (x + (a == plus).to(I32) - (a == minus).to(I32)).clamp(lo, hi)

    def _cell(self, y, x):
        """[B] cell (y, x) -> [B, 10, 10] bool grid with that cell set."""
        return ((self._idx == y[:, None])[:, :, None]
                & (self._idx == x[:, None])[:, None, :])

    def _row(self, x):
        """[...] column -> [..., 10] bool one-hot (none if off the grid)."""
        return self._idx == x[..., None]

    def _lanes(self, x, mask):
        """Entities of lanes 0-7 at rows 1-8: columns ``x`` [B, 8] where
        ``mask`` [B, 8] -> [B, 10, 10] bool grid."""
        grid = torch.zeros((x.shape[0], 10, 10), dtype=torch.bool,
                           device=self.device)
        grid[:, 1:N_LANES + 1] = mask[..., None] & self._row(x)
        return grid

    def _in_lane(self, y):
        """[B] row -> [B, 8] bool: which lane is on that row."""
        return self._lane_rows == y[:, None]

    def _finish(self, ns, obs, reward, terminal):
        """Apply the time limit and pack the EnvStep."""
        truncated = ns.t >= self.max_steps
        done = terminal | truncated
        return ns, EnvStep(obs, reward.to(torch.float32), done,
                           {"timeout": truncated & ~terminal})


def _spawn_lane(u, free):
    """Uniform random index among free lanes, from a raw int draw ``u``
    [B] in [0, 2^30): the first lane whose running count of free lanes
    exceeds u mod n_free (lane 0 when none is free).  Returns (lane,
    any free)."""
    n_free = free.sum(1)
    r = u % n_free.clamp(min=1)
    after = (torch.cumsum(free, 1) > r[:, None]).to(torch.uint8)
    return torch.argmax(after, 1), n_free > 0


# ===========================================================================
# Breakout
# ===========================================================================

class BreakoutState(NamedTuple):
    ball_y: torch.Tensor
    ball_x: torch.Tensor
    ball_dir: torch.Tensor    # 0 up-left 1 down-left 2 down-right 3 up-right
    pos: torch.Tensor         # paddle column
    brick_map: torch.Tensor   # [B, 10, 10] bool
    strike: torch.Tensor      # inside a brick-hit streak
    last_y: torch.Tensor      # previous ball cell (trail channel)
    last_x: torch.Tensor
    last_action: torch.Tensor
    t: torch.Tensor


class BreakoutResetDraws(NamedTuple):
    side: torch.Tensor        # randint(0, 2)


class StickyDraws(NamedTuple):
    sticky: torch.Tensor      # uniform


class Breakout(MinAtarEnv):
    """MinAtar Breakout: 3 brick rows, diagonal ball, 1-cell paddle.
    Channels: 0 paddle, 1 ball, 2 trail, 3 bricks."""

    n_channels = 4
    # Direction tables (the reference's _REFLECT_X, _REFLECT_Y, _SWAP,
    # _DX, _DY), indexed by ball_dir.
    REFLECT_X = (3, 2, 1, 0)
    REFLECT_Y = (1, 0, 3, 2)
    SWAP = (2, 3, 0, 1)
    DX = (-1, -1, 1, 1)
    DY = (-1, 1, 1, -1)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._tables = {name: torch.tensor(getattr(self, name), dtype=I32,
                                           device=self.device)
                        for name in ("REFLECT_X", "REFLECT_Y", "SWAP", "DX",
                                     "DY")}
        bricks = torch.zeros((10, 10), dtype=torch.bool, device=self.device)
        bricks[1:4] = True
        self._bricks = bricks

    def draw_reset(self, n, generator):
        return BreakoutResetDraws(_randint(0, 2, n, generator))

    def draw_step(self, n, generator):
        return StickyDraws(_uniform(n, generator))

    def _reset(self, n, draws):
        x = torch.where(draws.side == 0, 0, 9).to(I32)
        return BreakoutState(
            ball_y=self._full(n, 3), ball_x=x,
            ball_dir=torch.where(draws.side == 0, 2, 3).to(I32),
            pos=self._full(n, 4),
            brick_map=self._bricks.expand(n, 10, 10).clone(),
            strike=self._full(n, False, torch.bool),
            last_y=self._full(n, 3), last_x=x.clone(),
            last_action=self._full(n, 0), t=self._full(n, 0))

    def _obs(self, s):
        return torch.stack([
            self._cell(self._full(s.pos.shape[0], 9), s.pos),
            self._cell(s.ball_y, s.ball_x),
            self._cell(s.last_y, s.last_x),
            s.brick_map], 1).to(torch.uint8)

    def _step(self, s, a, draws):
        tb = self._tables
        a = self._sticky(draws.sticky, a, s.last_action)
        pos = self._move(s.pos, a, LEFT, RIGHT, 0, 9)

        last_y, last_x = s.ball_y, s.ball_x
        d0 = s.ball_dir.long()
        new_x = s.ball_x + tb["DX"][d0]
        new_y = s.ball_y + tb["DY"][d0]

        # Side walls reflect x.
        side_hit = (new_x < 0) | (new_x > 9)
        new_x = new_x.clamp(0, 9)
        d = torch.where(side_hit, tb["REFLECT_X"][d0], s.ball_dir)

        # Exclusive cases on y (the reference's order: top, brick, bottom).
        top_hit = new_y < 0
        y_idx = new_y.clamp(0, 9)
        cell = self._cell(y_idx, new_x)
        brick_here = ~top_hit & (s.brick_map & cell).flatten(1).any(1)
        strike_hit = brick_here & ~s.strike     # only first contact acts
        bottom = ~top_hit & ~brick_here & (new_y == 9)

        reward = strike_hit.to(torch.float32)
        brick_map = s.brick_map & ~(strike_hit[:, None, None] & cell)

        # Bottom row: paddle save or death; bricks respawn once cleared.
        cleared = ~brick_map.flatten(1).any(1)
        brick_map = torch.where((bottom & cleared)[:, None, None],
                                self._bricks, brick_map)
        flat_save = bottom & (s.ball_x == pos)      # ball directly above
        corner_save = bottom & (s.ball_x != pos) & (new_x == pos)
        death = bottom & ~flat_save & ~corner_save

        d = torch.where(top_hit | strike_hit, tb["REFLECT_Y"][d.long()], d)
        d = torch.where(flat_save, tb["REFLECT_X"][d.long()], d)
        d = torch.where(corner_save, tb["SWAP"][d.long()], d)

        fy = torch.where(top_hit, 0, new_y)
        fy = torch.where(strike_hit | flat_save | corner_save, last_y, fy)
        fy = fy.clamp(0, 9)

        ns = BreakoutState(
            ball_y=fy, ball_x=new_x, ball_dir=d, pos=pos,
            brick_map=brick_map, strike=brick_here, last_y=last_y,
            last_x=last_x, last_action=a, t=s.t + 1)
        return self._finish(ns, self._obs(ns), reward, death)


# ===========================================================================
# Space Invaders
# ===========================================================================

class SpaceInvadersState(NamedTuple):
    pos: torch.Tensor
    f_bullet_map: torch.Tensor   # [B, 10, 10] friendly bullets (move up)
    e_bullet_map: torch.Tensor   # [B, 10, 10] enemy bullets (move down)
    alien_map: torch.Tensor      # [B, 10, 10]
    alien_dir: torch.Tensor      # +-1 horizontal march direction
    enemy_move_interval: torch.Tensor
    alien_move_timer: torch.Tensor
    alien_shot_timer: torch.Tensor
    shot_timer: torch.Tensor     # player fire cooldown
    last_action: torch.Tensor
    t: torch.Tensor


_SI_SHOT_COOL = 5
_SI_ENEMY_MOVE_INTERVAL = 12
_SI_ENEMY_SHOT_INTERVAL = 10


def _shift_rows(m, d: int):
    """Move every cell d rows down (d = +-1); the edge row falls off."""
    z = torch.zeros_like(m[:, :1])
    return torch.cat([z, m[:, :-1]], 1) if d > 0 else \
        torch.cat([m[:, 1:], z], 1)


def _shift_cols(m, d: int):
    """Move every cell d columns right (d = +-1); the edge column falls
    off."""
    z = torch.zeros_like(m[:, :, :1])
    return torch.cat([z, m[:, :, :-1]], 2) if d > 0 else \
        torch.cat([m[:, :, 1:], z], 2)


class SpaceInvaders(MinAtarEnv):
    """MinAtar Space Invaders.  Channels: 0 cannon, 1 alien, 2 alien-left,
    3 alien-right, 4 friendly bullet, 5 enemy bullet."""

    n_channels = 6

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        aliens = torch.zeros((10, 10), dtype=torch.bool, device=self.device)
        aliens[0:4, 2:8] = True
        self._aliens = aliens

    def draw_step(self, n, generator):
        return StickyDraws(_uniform(n, generator))

    def _reset(self, n, draws):
        empty = torch.zeros((n, 10, 10), dtype=torch.bool, device=self.device)
        return SpaceInvadersState(
            pos=self._full(n, 5), f_bullet_map=empty,
            e_bullet_map=empty.clone(),
            alien_map=self._aliens.expand(n, 10, 10).clone(),
            alien_dir=self._full(n, -1),
            enemy_move_interval=self._full(n, _SI_ENEMY_MOVE_INTERVAL),
            alien_move_timer=self._full(n, _SI_ENEMY_MOVE_INTERVAL),
            alien_shot_timer=self._full(n, _SI_ENEMY_SHOT_INTERVAL),
            shot_timer=self._full(n, 0), last_action=self._full(n, 0),
            t=self._full(n, 0))

    def _obs(self, s):
        left = (s.alien_dir < 0)[:, None, None]
        right = (s.alien_dir > 0)[:, None, None]
        return torch.stack([
            self._cell(self._full(s.pos.shape[0], 9), s.pos), s.alien_map,
            s.alien_map & left, s.alien_map & right, s.f_bullet_map,
            s.e_bullet_map], 1).to(torch.uint8)

    def _step(self, s, a, draws):
        n = a.shape[0]
        rows = torch.arange(n, device=self.device)
        a = self._sticky(draws.sticky, a, s.last_action)

        # Player: fire or move.
        fire = (a == FIRE) & (s.shot_timer == 0)
        f_map = s.f_bullet_map | (fire[:, None, None]
                                  & self._cell(self._full(n, 9), s.pos))
        shot_timer = torch.where(fire, _SI_SHOT_COOL, s.shot_timer)
        pos = self._move(s.pos, a, LEFT, RIGHT, 0, 9)
        pos_l = pos.long()

        # Bullets advance.
        f_map = _shift_rows(f_map, -1)
        e_map = _shift_rows(s.e_bullet_map, 1)
        terminal = e_map[rows, 9, pos_l]

        # Alien march: down at a wall, else sideways.
        alien_map, alien_dir = s.alien_map, s.alien_dir
        move_now = s.alien_move_timer - 1 == 0
        at_left = alien_map[:, :, 0].any(1) & (alien_dir < 0)
        at_right = alien_map[:, :, 9].any(1) & (alien_dir > 0)
        turn = at_left | at_right
        landed = alien_map[:, 9].any(1)
        terminal = terminal | (move_now & turn & landed)
        moved_down = torch.roll(alien_map, 1, 1)
        moved_side = torch.where((alien_dir > 0)[:, None, None],
                                 torch.roll(alien_map, 1, 2),
                                 torch.roll(alien_map, -1, 2))
        alien_map = torch.where(
            move_now[:, None, None],
            torch.where(turn[:, None, None], moved_down, moved_side),
            alien_map)
        alien_dir = torch.where(move_now & turn, -alien_dir, alien_dir)
        terminal = terminal | (move_now & alien_map[rows, 9, pos_l])
        n_aliens = alien_map.flatten(1).sum(1).to(I32)
        alien_move_timer = torch.where(
            move_now,
            torch.minimum(n_aliens.clamp(min=1), s.enemy_move_interval),
            s.alien_move_timer - 1)

        # Alien shooting: nearest column to the player, lowest alien there.
        shoot_now = s.alien_shot_timer - 1 == 0
        has_alien = alien_map.any(1)                            # [B, 10]
        dist = (self._idx - pos[:, None]).abs() \
            + torch.where(has_alien, 0, 100)
        col = torch.argmin(dist, 1)
        column = alien_map[rows, :, col].to(torch.uint8)        # [B, 10]
        row = 9 - torch.argmax(column.flip(1), 1)
        can_shoot = shoot_now & (n_aliens > 0)
        e_map = e_map | (can_shoot[:, None, None] & self._cell(row, col))
        alien_shot_timer = torch.where(shoot_now, _SI_ENEMY_SHOT_INTERVAL,
                                       s.alien_shot_timer - 1)

        # Friendly bullets kill aliens.
        kills = alien_map & f_map
        reward = kills.flatten(1).sum(1).to(torch.float32)
        alien_map = alien_map & ~kills
        f_map = f_map & ~kills

        shot_timer = (shot_timer - (s.shot_timer > 0).to(I32)).clamp(min=0)

        # Wave respawn (+ optional speed ramping).
        wave_clear = ~alien_map.flatten(1).any(1)
        enemy_move_interval = s.enemy_move_interval
        if self.ramping:
            enemy_move_interval = torch.where(
                wave_clear & (enemy_move_interval > 6),
                enemy_move_interval - 1, enemy_move_interval)
        alien_map = torch.where(wave_clear[:, None, None], self._aliens,
                                alien_map)

        ns = SpaceInvadersState(
            pos=pos, f_bullet_map=f_map, e_bullet_map=e_map,
            alien_map=alien_map, alien_dir=alien_dir,
            enemy_move_interval=enemy_move_interval,
            alien_move_timer=alien_move_timer,
            alien_shot_timer=alien_shot_timer, shot_timer=shot_timer,
            last_action=a, t=s.t + 1)
        return self._finish(ns, self._obs(ns), reward, terminal)


# ===========================================================================
# Asterix
# ===========================================================================

class AsterixState(NamedTuple):
    player_x: torch.Tensor
    player_y: torch.Tensor
    ent_x: torch.Tensor        # [B, 8]
    ent_lr: torch.Tensor       # [B, 8] 1 = moving right
    ent_gold: torch.Tensor     # [B, 8] bool
    ent_alive: torch.Tensor    # [B, 8] bool
    spawn_speed: torch.Tensor
    spawn_timer: torch.Tensor
    move_speed: torch.Tensor
    move_timer: torch.Tensor
    ramp_timer: torch.Tensor
    ramp_index: torch.Tensor
    last_action: torch.Tensor
    t: torch.Tensor


class AsterixDraws(NamedTuple):
    sticky: torch.Tensor      # uniform
    slot: torch.Tensor        # randint(0, 2^30)
    lr: torch.Tensor          # randint(0, 2)
    gold: torch.Tensor        # uniform


_AX_INIT_SPAWN_SPEED = 10
_AX_INIT_MOVE_SPEED = 5
_AX_RAMP_INTERVAL = 100


class Asterix(MinAtarEnv):
    """MinAtar Asterix: dodge enemies, collect gold; 8 entity lanes on
    rows 1-8.  Channels: 0 player, 1 enemy, 2 trail, 3 gold."""

    n_channels = 4

    def draw_step(self, n, generator):
        return AsterixDraws(_uniform(n, generator),
                            _randint(0, 1 << 30, n, generator),
                            _randint(0, 2, n, generator),
                            _uniform(n, generator))

    def _reset(self, n, draws):
        z8 = torch.zeros((n, N_LANES), dtype=I32, device=self.device)
        f8 = torch.zeros((n, N_LANES), dtype=torch.bool, device=self.device)
        return AsterixState(
            player_x=self._full(n, 5), player_y=self._full(n, 5),
            ent_x=z8, ent_lr=z8.clone(), ent_gold=f8, ent_alive=f8.clone(),
            spawn_speed=self._full(n, _AX_INIT_SPAWN_SPEED),
            spawn_timer=self._full(n, _AX_INIT_SPAWN_SPEED),
            move_speed=self._full(n, _AX_INIT_MOVE_SPEED),
            move_timer=self._full(n, _AX_INIT_MOVE_SPEED),
            ramp_timer=self._full(n, _AX_RAMP_INTERVAL),
            ramp_index=self._full(n, 0), last_action=self._full(n, 0),
            t=self._full(n, 0))

    def _obs(self, s):
        alive = s.ent_alive
        back_x = s.ent_x - (2 * s.ent_lr - 1)
        in_grid = (back_x >= 0) & (back_x <= 9) & alive
        return torch.stack([
            self._cell(s.player_y, s.player_x),
            self._lanes(s.ent_x, alive & ~s.ent_gold),
            self._lanes(back_x.clamp(0, 9), in_grid),
            self._lanes(s.ent_x, alive & s.ent_gold)], 1).to(torch.uint8)

    def _collide(self, px, py, ent_x, ent_gold, ent_alive, reward, terminal):
        """Player / entity contact: gold collects, an enemy kills."""
        hit = ent_alive & self._in_lane(py) & (ent_x == px[:, None])
        gold_hit = hit & ent_gold
        reward = reward + gold_hit.sum(1).to(torch.float32)
        terminal = terminal | (hit & ~ent_gold).any(1)
        return ent_alive & ~gold_hit, reward, terminal

    def _step(self, s, a, draws):
        n = a.shape[0]
        a = self._sticky(draws.sticky, a, s.last_action)
        reward = torch.zeros((n,), device=self.device)
        terminal = torch.zeros((n,), dtype=torch.bool, device=self.device)

        # Spawn into a uniformly random free lane.
        spawn_now = s.spawn_timer == 0
        slot, any_free = _spawn_lane(draws.slot, ~s.ent_alive)
        do_spawn = spawn_now & any_free
        gold = draws.gold < (1.0 / 3.0)
        x0 = torch.where(draws.lr == 1, 0, 9).to(I32)
        sel = (self._lane_ids == slot[:, None]) & do_spawn[:, None]
        ent_x = torch.where(sel, x0[:, None], s.ent_x)
        ent_lr = torch.where(sel, draws.lr[:, None], s.ent_lr)
        ent_gold = torch.where(sel, gold[:, None], s.ent_gold)
        ent_alive = s.ent_alive | sel
        spawn_timer = torch.where(spawn_now, s.spawn_speed,
                                  s.spawn_timer - 1)

        # Player move.
        px = self._move(s.player_x, a, LEFT, RIGHT, 0, 9)
        py = self._move(s.player_y, a, UP, DOWN, 1, 8)
        ent_alive, reward, terminal = self._collide(
            px, py, ent_x, ent_gold, ent_alive, reward, terminal)

        # Entities march every move_speed steps.
        move_now = s.move_timer == 0
        new_x = ent_x + torch.where(move_now[:, None], 2 * ent_lr - 1, 0)
        off = (new_x < 0) | (new_x > 9)
        ent_x = new_x.clamp(0, 9)
        ent_alive = ent_alive & ~off
        ent_alive, reward, terminal = self._collide(
            px, py, ent_x, ent_gold, ent_alive, reward, terminal)
        move_timer = torch.where(move_now, s.move_speed, s.move_timer - 1)

        # Difficulty ramping: alternately speed up spawning and movement.
        spawn_speed, move_speed = s.spawn_speed, s.move_speed
        ramp_timer, ramp_index = s.ramp_timer, s.ramp_index
        if self.ramping:
            ramp_now = (ramp_timer == 0) & ((spawn_speed > 1)
                                            | (move_speed > 1))
            do_move = ramp_now & ((ramp_index % 2 == 0) | (spawn_speed <= 1))
            do_spawn_r = ramp_now & ~do_move
            move_speed = torch.where(do_move, (move_speed - 1).clamp(min=1),
                                     move_speed)
            spawn_speed = torch.where(do_spawn_r,
                                      (spawn_speed - 1).clamp(min=1),
                                      spawn_speed)
            ramp_index = ramp_index + ramp_now.to(I32)
            ramp_timer = torch.where(ramp_now, _AX_RAMP_INTERVAL,
                                     (ramp_timer - 1).clamp(min=0))

        ns = AsterixState(
            player_x=px, player_y=py, ent_x=ent_x, ent_lr=ent_lr,
            ent_gold=ent_gold, ent_alive=ent_alive, spawn_speed=spawn_speed,
            spawn_timer=spawn_timer, move_speed=move_speed,
            move_timer=move_timer, ramp_timer=ramp_timer,
            ramp_index=ramp_index, last_action=a, t=s.t + 1)
        return self._finish(ns, self._obs(ns), reward, terminal)


# ===========================================================================
# Freeway
# ===========================================================================

class FreewayState(NamedTuple):
    pos: torch.Tensor          # chicken row (column fixed at 4)
    car_x: torch.Tensor        # [B, 8] rows 1-8
    car_dir: torch.Tensor      # [B, 8] +-1
    car_period: torch.Tensor   # [B, 8] steps per move, 1..5
    car_timer: torch.Tensor    # [B, 8]
    move_timer: torch.Tensor   # chicken move cooldown
    last_action: torch.Tensor
    t: torch.Tensor


class CarDraws(NamedTuple):
    period: torch.Tensor      # [B, 8] randint(1, 6)
    direction: torch.Tensor   # [B, 8] randint(0, 2): the sign's bit


class FreewayDraws(NamedTuple):
    sticky: torch.Tensor      # uniform
    period: torch.Tensor      # as CarDraws, for a crossing's new traffic
    direction: torch.Tensor


_FW_PLAYER_SPEED = 3
_FW_TIME_LIMIT = 2500


class Freeway(MinAtarEnv):
    """MinAtar Freeway: cross 8 lanes of traffic upward; +1 a crossing.
    Channels: 0 chicken, 1 car, 2-6 car trails by speed (period 1-5).
    The chicken moves at most every 3 steps; a car moves every
    ``period + 1`` steps and wraps around; every car (re)spawns at x = 0;
    the episode ends only by the time limit (2500 steps by default)."""

    n_channels = 7

    def __init__(self, sticky_action_prob: float = 0.1,
                 ramping: bool = True, max_steps: int = _FW_TIME_LIMIT,
                 device="cuda"):
        super().__init__(sticky_action_prob, ramping, max_steps, device)
        self._trail_periods = torch.arange(1, 6, device=self.device)

    @staticmethod
    def _cars(n, generator):
        return (_randint(1, 6, n, generator, (N_LANES,)),
                _randint(0, 2, n, generator, (N_LANES,)))

    def draw_reset(self, n, generator):
        return CarDraws(*self._cars(n, generator))

    def draw_step(self, n, generator):
        return FreewayDraws(_uniform(n, generator), *self._cars(n, generator))

    def _reset(self, n, draws):
        return FreewayState(
            pos=self._full(n, 9),
            car_x=torch.zeros((n, N_LANES), dtype=I32, device=self.device),
            car_dir=2 * draws.direction - 1, car_period=draws.period,
            car_timer=draws.period.clone(),
            move_timer=self._full(n, _FW_PLAYER_SPEED),
            last_action=self._full(n, 0), t=self._full(n, 0))

    def _obs(self, s):
        n = s.pos.shape[0]
        obs = torch.zeros((n, self.n_channels, 10, 10), dtype=torch.bool,
                          device=self.device)
        obs[:, 0] = self._cell(s.pos, self._full(n, 4))
        obs[:, 1] = self._lanes(s.car_x, torch.ones_like(s.car_x,
                                                          dtype=torch.bool))
        back_x = (s.car_x - s.car_dir) % 10      # trails wrap
        # Periods 1..5 -> trail channels 2..6.
        by_period = s.car_period[:, None, :] \
            == self._trail_periods[None, :, None]            # [B, 5, 8]
        obs[:, 2:7, 1:N_LANES + 1] = by_period[..., None] \
            & self._row(back_x)[:, None]
        return obs.to(torch.uint8)

    def _step(self, s, a, draws):
        a = self._sticky(draws.sticky, a, s.last_action)

        can_move = s.move_timer == 0
        move_up = can_move & (a == UP)
        move_down = can_move & (a == DOWN)
        pos = (s.pos - move_up.to(I32) + move_down.to(I32)).clamp(0, 9)
        # The timer is set on a move and counts down in the same step: a
        # move every 3 steps.
        move_timer = torch.where(move_up | move_down, _FW_PLAYER_SPEED - 1,
                                 (s.move_timer - 1).clamp(min=0))

        # A crossing scores before the cars move: +1, the chicken
        # respawns, the traffic re-randomizes with every car at x = 0.
        scored = pos == 0
        reward = scored.to(torch.float32)
        sc = scored[:, None]
        car_x = torch.where(sc, 0, s.car_x)
        car_dir = torch.where(sc, 2 * draws.direction - 1, s.car_dir)
        car_period = torch.where(sc, draws.period, s.car_period)
        car_timer = torch.where(sc, draws.period, s.car_timer)
        pos = torch.where(scored, 9, pos)

        # Collision before the cars advance (stepping into a parked car),
        # then after.
        hit_pre = (self._in_lane(pos) & (car_x == 4)).any(1)
        pos = torch.where(hit_pre, 9, pos)
        tick = car_timer == 0
        car_x = torch.where(tick, (car_x + car_dir) % 10, car_x)
        car_timer = torch.where(tick, car_period, car_timer - 1)
        hit_post = (self._in_lane(pos) & (car_x == 4)).any(1)
        pos = torch.where(hit_post, 9, pos)

        ns = FreewayState(
            pos=pos, car_x=car_x, car_dir=car_dir, car_period=car_period,
            car_timer=car_timer, move_timer=move_timer, last_action=a,
            t=s.t + 1)
        return self._finish(ns, self._obs(ns), reward,
                            torch.zeros_like(scored))


# ===========================================================================
# Seaquest
# ===========================================================================

class SeaquestState(NamedTuple):
    sub_x: torch.Tensor         # player submarine
    sub_y: torch.Tensor         # 0 = surface, 1-8 water lanes
    sub_or: torch.Tensor        # facing: +1 right, -1 left
    fb_l: torch.Tensor          # [B, 10, 10] friendly bullets moving left
    fb_r: torch.Tensor          # [B, 10, 10] friendly bullets moving right
    eb_l: torch.Tensor          # [B, 10, 10] enemy bullets moving left
    eb_r: torch.Tensor          # [B, 10, 10] enemy bullets moving right
    fish_x: torch.Tensor        # [B, 8] one fish lane per row 1-8
    fish_dir: torch.Tensor      # [B, 8] +-1
    fish_alive: torch.Tensor    # [B, 8] bool
    esub_x: torch.Tensor        # [B, 8] enemy subs, same lane model
    esub_dir: torch.Tensor
    esub_alive: torch.Tensor
    esub_shot_timer: torch.Tensor
    diver_x: torch.Tensor       # [B, 8]
    diver_dir: torch.Tensor
    diver_alive: torch.Tensor
    oxygen: torch.Tensor
    diver_count: torch.Tensor
    e_spawn_speed: torch.Tensor
    e_spawn_timer: torch.Tensor
    d_spawn_timer: torch.Tensor
    move_speed: torch.Tensor    # enemy move period (ramps down)
    move_timer: torch.Tensor
    diver_move_timer: torch.Tensor
    shot_timer: torch.Tensor    # player fire cooldown
    surface: torch.Tensor       # was at the surface last step
    last_action: torch.Tensor
    t: torch.Tensor


class SeaquestDraws(NamedTuple):
    sticky: torch.Tensor      # uniform
    enemy_lane: torch.Tensor  # randint(0, 2^30), for the fish and sub lanes
    enemy_type: torch.Tensor  # uniform
    enemy_dir: torch.Tensor   # randint(0, 2)
    diver_lane: torch.Tensor  # randint(0, 2^30)
    diver_dir: torch.Tensor   # randint(0, 2)


_SQ_MAX_OXYGEN = 200
_SQ_INIT_SPAWN_SPEED = 20
_SQ_DIVER_SPAWN_SPEED = 30
_SQ_INIT_MOVE_SPEED = 5
_SQ_SHOT_COOL = 5
_SQ_ENEMY_SHOT_INTERVAL = 10
_SQ_DIVER_MOVE_INTERVAL = 5


class Seaquest(MinAtarEnv):
    """MinAtar Seaquest, as the reference lays it out: entities on 8 fixed
    lanes (rows 1-8), at most one fish, one enemy sub and one diver a
    lane.  Shoot fish and subs (+1 each), collect divers, manage oxygen
    and surface to refill: surfacing with no diver (or running out of
    oxygen) ends the game; surfacing with all 6 cashes them in for +6 and
    ramps the difficulty.

    Channels: 0 sub front, 1 sub trail (orientation), 2 friendly bullet,
    3 diver, 4 enemy bullet, 5 fish, 6 enemy sub, 7 oxygen gauge (row 9),
    8 diver gauge (row 9)."""

    n_channels = 9

    def draw_step(self, n, generator):
        g = generator
        return SeaquestDraws(_uniform(n, g), _randint(0, 1 << 30, n, g),
                             _uniform(n, g), _randint(0, 2, n, g),
                             _randint(0, 1 << 30, n, g), _randint(0, 2, n, g))

    def _reset(self, n, draws):
        def lanes(v, dtype=I32):
            return torch.full((n, N_LANES), v, dtype=dtype,
                              device=self.device)

        def grid():
            return torch.zeros((n, 10, 10), dtype=torch.bool,
                               device=self.device)

        return SeaquestState(
            sub_x=self._full(n, 5), sub_y=self._full(n, 0),
            sub_or=self._full(n, 1),
            fb_l=grid(), fb_r=grid(), eb_l=grid(), eb_r=grid(),
            fish_x=lanes(0), fish_dir=lanes(1),
            fish_alive=lanes(False, torch.bool),
            esub_x=lanes(0), esub_dir=lanes(1),
            esub_alive=lanes(False, torch.bool), esub_shot_timer=lanes(0),
            diver_x=lanes(0), diver_dir=lanes(1),
            diver_alive=lanes(False, torch.bool),
            oxygen=self._full(n, _SQ_MAX_OXYGEN),
            diver_count=self._full(n, 0),
            e_spawn_speed=self._full(n, _SQ_INIT_SPAWN_SPEED),
            e_spawn_timer=self._full(n, _SQ_INIT_SPAWN_SPEED),
            d_spawn_timer=self._full(n, _SQ_DIVER_SPAWN_SPEED),
            move_speed=self._full(n, _SQ_INIT_MOVE_SPEED),
            move_timer=self._full(n, _SQ_INIT_MOVE_SPEED),
            diver_move_timer=self._full(n, _SQ_DIVER_MOVE_INTERVAL),
            shot_timer=self._full(n, 0),
            surface=self._full(n, True, torch.bool),
            last_action=self._full(n, 0), t=self._full(n, 0))

    def _obs(self, s):
        n = s.sub_x.shape[0]
        gauge = torch.zeros((n, 2, 10, 10), dtype=torch.bool,
                            device=self.device)
        # Row 9: oxygen left to right, divers right to left.
        gauge[:, 0, 9] = self._idx < (s.oxygen * 10 // _SQ_MAX_OXYGEN)[:, None]
        gauge[:, 1, 9] = (9 - self._idx) < s.diver_count[:, None]
        return torch.cat([torch.stack([
            self._cell(s.sub_y, s.sub_x),
            self._cell(s.sub_y, (s.sub_x - s.sub_or).clamp(0, 9)),
            s.fb_l | s.fb_r,
            self._lanes(s.diver_x, s.diver_alive),
            s.eb_l | s.eb_r,
            self._lanes(s.fish_x, s.fish_alive),
            self._lanes(s.esub_x, s.esub_alive)], 1), gauge],
            1).to(torch.uint8)

    def _spawn(self, sel, x0, d, xs, dirs, alive):
        """Place the lanes ``sel`` [B, 8] (at most one a row) at x0 [B]
        moving d [B]."""
        return (torch.where(sel, x0[:, None], xs),
                torch.where(sel, d[:, None], dirs), alive | sel)

    def _step(self, s, a, draws):
        n = a.shape[0]
        rows = torch.arange(n, device=self.device)
        a = self._sticky(draws.sticky, a, s.last_action)
        reward = torch.zeros((n,), device=self.device)

        # --- player: fire and move -----------------------------------------
        fire = (a == FIRE) & (s.shot_timer == 0)
        at_sub = self._cell(s.sub_y, s.sub_x)
        fb_l = s.fb_l | ((fire & (s.sub_or < 0))[:, None, None] & at_sub)
        fb_r = s.fb_r | ((fire & (s.sub_or > 0))[:, None, None] & at_sub)
        shot_timer = torch.where(fire, _SQ_SHOT_COOL,
                                 (s.shot_timer - 1).clamp(min=0))
        sub_x = self._move(s.sub_x, a, LEFT, RIGHT, 0, 9)
        sub_or = torch.where(a == RIGHT, 1,
                             torch.where(a == LEFT, -1, s.sub_or)).to(I32)
        sub_y = self._move(s.sub_y, a, UP, DOWN, 0, 8)

        # --- bullets advance (friendly, then enemy) ------------------------
        fb_l, fb_r = _shift_cols(fb_l, -1), _shift_cols(fb_r, 1)
        eb_l, eb_r = _shift_cols(s.eb_l, -1), _shift_cols(s.eb_r, 1)

        # Friendly bullets kill fish and enemy subs (+1 each).
        fb = (fb_l | fb_r)[:, 1:N_LANES + 1]                     # [B, 8, 10]
        fish_hit = s.fish_alive & torch.gather(
            fb, 2, s.fish_x.long()[..., None])[..., 0]
        esub_hit = s.esub_alive & torch.gather(
            fb, 2, s.esub_x.long()[..., None])[..., 0]
        reward = reward + fish_hit.sum(1).to(torch.float32) \
            + esub_hit.sum(1).to(torch.float32)
        fish_alive = s.fish_alive & ~fish_hit
        esub_alive = s.esub_alive & ~esub_hit
        # The bullets that struck are spent.
        strike = self._lanes(s.fish_x, fish_hit) \
            | self._lanes(s.esub_x, esub_hit)
        fb_l = fb_l & ~strike
        fb_r = fb_r & ~strike

        # --- enemies march on the move period ------------------------------
        move_now = (s.move_timer == 0)[:, None]
        fish_x = s.fish_x + torch.where(move_now & fish_alive, s.fish_dir, 0)
        fish_alive = fish_alive & (fish_x >= 0) & (fish_x <= 9)
        fish_x = fish_x.clamp(0, 9)
        esub_x = s.esub_x + torch.where(move_now & esub_alive, s.esub_dir, 0)
        esub_alive = esub_alive & (esub_x >= 0) & (esub_x <= 9)
        esub_x = esub_x.clamp(0, 9)
        move_timer = torch.where(move_now[:, 0], s.move_speed,
                                 s.move_timer - 1)

        # Divers drift on their own, slower period.
        d_move = (s.diver_move_timer == 0)[:, None]
        diver_x = s.diver_x + torch.where(s.diver_alive & d_move,
                                          s.diver_dir, 0)
        diver_alive = s.diver_alive & (diver_x >= 0) & (diver_x <= 9)
        diver_x = diver_x.clamp(0, 9)
        diver_move_timer = torch.where(d_move[:, 0], _SQ_DIVER_MOVE_INTERVAL,
                                       s.diver_move_timer - 1)

        # --- enemy subs fire -----------------------------------------------
        esub_shoot = esub_alive & (s.esub_shot_timer == 0)
        eb_l = eb_l | self._lanes((esub_x - 1).clamp(0, 9),
                                  esub_shoot & (s.esub_dir < 0))
        eb_r = eb_r | self._lanes((esub_x + 1).clamp(0, 9),
                                  esub_shoot & (s.esub_dir > 0))
        esub_shot_timer = torch.where(
            esub_shoot, _SQ_ENEMY_SHOT_INTERVAL,
            (s.esub_shot_timer - 1).clamp(min=0))

        # --- contact: enemies and enemy bullets kill the player ------------
        in_lane = self._in_lane(sub_y)
        terminal = (eb_l | eb_r)[rows, sub_y.long(), sub_x.long()]
        terminal = terminal | (in_lane & fish_alive
                               & (fish_x == sub_x[:, None])).any(1)
        terminal = terminal | (in_lane & esub_alive
                               & (esub_x == sub_x[:, None])).any(1)

        # --- divers collected ----------------------------------------------
        grab = in_lane & diver_alive & (diver_x == sub_x[:, None]) \
            & (s.diver_count < 6)[:, None]
        diver_alive = diver_alive & ~grab
        diver_count = (s.diver_count + grab.sum(1).to(I32)).clamp(max=6)

        # --- spawns --------------------------------------------------------
        e_spawn_now = s.e_spawn_timer == 0
        is_sub = draws.enemy_type < (1.0 / 3.0)   # fish 2:1 over subs
        e_dir = 2 * draws.enemy_dir - 1
        e_x0 = torch.where(e_dir > 0, 0, 9).to(I32)
        lane_f, ok_f = _spawn_lane(draws.enemy_lane, ~fish_alive)
        lane_s, ok_s = _spawn_lane(draws.enemy_lane, ~esub_alive)
        sel_f = (self._lane_ids == lane_f[:, None]) \
            & (e_spawn_now & ~is_sub & ok_f)[:, None]
        sel_s = (self._lane_ids == lane_s[:, None]) \
            & (e_spawn_now & is_sub & ok_s)[:, None]
        fish_x, fish_dir, fish_alive = self._spawn(
            sel_f, e_x0, e_dir, fish_x, s.fish_dir, fish_alive)
        esub_x, esub_dir, esub_alive = self._spawn(
            sel_s, e_x0, e_dir, esub_x, s.esub_dir, esub_alive)
        esub_shot_timer = torch.where(sel_s, _SQ_ENEMY_SHOT_INTERVAL,
                                      esub_shot_timer)
        e_spawn_timer = torch.where(e_spawn_now, s.e_spawn_speed,
                                    s.e_spawn_timer - 1)

        d_spawn_now = s.d_spawn_timer == 0
        d_dir = 2 * draws.diver_dir - 1
        d_x0 = torch.where(d_dir > 0, 0, 9).to(I32)
        lane_d, ok_d = _spawn_lane(draws.diver_lane, ~diver_alive)
        sel_d = (self._lane_ids == lane_d[:, None]) \
            & (d_spawn_now & ok_d)[:, None]
        diver_x, diver_dir, diver_alive = self._spawn(
            sel_d, d_x0, d_dir, diver_x, s.diver_dir, diver_alive)
        d_spawn_timer = torch.where(d_spawn_now, _SQ_DIVER_SPAWN_SPEED,
                                    s.d_spawn_timer - 1)

        # --- oxygen and surfacing ------------------------------------------
        at_surface = sub_y == 0
        came_up = at_surface & ~s.surface
        # Surfacing with no diver ends the game.
        terminal = terminal | (came_up & (diver_count == 0))
        cash_all = came_up & (diver_count == 6)
        reward = reward + torch.where(cash_all, 6.0, 0.0)
        # A cash-in clears the divers; any other surfacing spends one.
        diver_count = torch.where(
            cash_all, 0, torch.where(came_up & (diver_count > 0),
                                     diver_count - 1, diver_count)).to(I32)
        oxygen = torch.where(at_surface, _SQ_MAX_OXYGEN, s.oxygen - 1)
        terminal = terminal | (oxygen < 0)
        oxygen = oxygen.clamp(min=0)

        # Difficulty ramp on a full cash-in.
        e_spawn_speed, move_speed = s.e_spawn_speed, s.move_speed
        if self.ramping:
            e_spawn_speed = torch.where(cash_all & (e_spawn_speed > 5),
                                        e_spawn_speed - 1, e_spawn_speed)
            move_speed = torch.where(cash_all & (move_speed > 2),
                                     move_speed - 1, move_speed)

        ns = SeaquestState(
            sub_x=sub_x, sub_y=sub_y, sub_or=sub_or,
            fb_l=fb_l, fb_r=fb_r, eb_l=eb_l, eb_r=eb_r,
            fish_x=fish_x, fish_dir=fish_dir, fish_alive=fish_alive,
            esub_x=esub_x, esub_dir=esub_dir, esub_alive=esub_alive,
            esub_shot_timer=esub_shot_timer,
            diver_x=diver_x, diver_dir=diver_dir, diver_alive=diver_alive,
            oxygen=oxygen, diver_count=diver_count,
            e_spawn_speed=e_spawn_speed, e_spawn_timer=e_spawn_timer,
            d_spawn_timer=d_spawn_timer, move_speed=move_speed,
            move_timer=move_timer, diver_move_timer=diver_move_timer,
            shot_timer=shot_timer, surface=at_surface, last_action=a,
            t=s.t + 1)
        return self._finish(ns, self._obs(ns), reward, terminal)


MINATAR_ENVS = {
    "breakout": Breakout,
    "space_invaders": SpaceInvaders,
    "asterix": Asterix,
    "freeway": Freeway,
    "seaquest": Seaquest,
}


def make_minatar(name: str, **kwargs) -> MinAtarEnv:
    """A MinAtar game by name (the Atari path's AtariEnv(game=...))."""
    if name not in MINATAR_ENVS:
        raise ValueError(
            f"unknown minatar game {name!r}; have {sorted(MINATAR_ENVS)}")
    return MINATAR_ENVS[name](**kwargs)
