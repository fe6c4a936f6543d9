"""Plain PyTorch reference of the R2D1 trainer on IMPALA's deep residual
trunk: the trunk, the recurrent Q-network, the R2D1 loss with burn-in,
value rescaling and n-step double-Q targets, clip-by-global-norm and
Adam.

Written from the published equations (IMPALA, Espeholt et al. 2018,
arXiv:1802.01561, Fig. 3 right; R2D2, Kapturowski et al., ICLR 2019;
Adam, Kingma & Ba, 2015), in float32 with no kernel, no cache and no
batching trick.  It imports nothing of the program: it takes the
parameters as a dict of tensors named as the model's ``state_dict``
names them (``conv.sections.i.conv``, ``conv.sections.i.blocks.j.conv0``
and ``conv1``, ``conv.fc``, ``lstm``, ``head``), and the sizes from the
configuration.  The LSTM, the head's layers, value rescaling and the
forms of the arithmetic (``Precision``: TF32 controls, float64) are
``r2d1.py``'s; the functions that run the trunk are written again here
around this one.

The trunk: three sections, each a 3x3 conv (stride 1, pad 1), a 3x3
max over stride 2 of the frame bordered by one cell of -inf, and
``blocks`` residual blocks x + conv(relu(conv(relu(x)))); then ReLU, the
dense layer and ReLU.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from reference.r2d1 import (
    Batch,
    Params,
    Precision,
    Steps,
    _as,
    _linear,
    _mlp,
    _n_actions,
    lstm,
    rescale,
    rescale_inv,
)


class Spec(NamedTuple):
    """The sizes and hyperparameters the reference needs."""
    obs_scale: float          # 1 / obs_divisor, rounded to float32
    channels: Sequence[int]   # of each section
    blocks: int               # residual blocks a section
    n_fc: int                 # hidden layers of each head stream
    dueling: bool
    discount: float
    n_step: int
    warmup_T: int
    batch_T: int
    eta: float
    rescale_eps: float
    lr: float
    clip_norm: float
    adam_eps: float
    betas: tuple = (0.9, 0.999)

    @staticmethod
    def from_config(config: dict) -> "Spec":
        m, a = config["model"], config["algo"]
        divisor = float(m.get("obs_divisor", 255.0))
        scale = float(torch.tensor(1.0 / divisor, dtype=torch.float32))
        return Spec(
            obs_scale=scale, channels=tuple(m["channels"]),
            blocks=int(m["blocks"]),
            n_fc=len(m.get("fc_sizes", (512,))),
            dueling=bool(m.get("dueling", True)),
            discount=float(a["discount"]), n_step=int(a["n_step_return"]),
            warmup_T=int(a["warmup_T"]), batch_T=int(a["batch_T"]),
            eta=float(a["pri_eta"]), rescale_eps=1e-3,
            lr=float(a["learning_rate"]), clip_norm=80.0, adam_eps=1e-3)


def _conv3x3(pr: Precision, P: Params, name: str, x):
    return F.conv2d(pr.operand(x), pr.operand(P[f"{name}.weight"]),
                    P[f"{name}.bias"], padding=1)


def max_pool(x):
    """The 3x3 max over stride 2 of x bordered by one cell of -inf a
    side: ceil(n / 2) outputs a side."""
    x = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    return F.max_pool2d(x, 3, stride=2)


def resnet_trunk(pr: Precision, P: Params, s: Spec, obs):
    """[N, C, H, W] observations -> [N, features]."""
    x = obs.to(pr.dtype)
    if s.obs_scale != 1.0:
        x = x * s.obs_scale
    for i in range(len(s.channels)):
        section = f"conv.sections.{i}"
        x = max_pool(_conv3x3(pr, P, f"{section}.conv", x))
        for j in range(s.blocks):
            block = f"{section}.blocks.{j}"
            y = _conv3x3(pr, P, f"{block}.conv0", torch.relu(x))
            x = x + _conv3x3(pr, P, f"{block}.conv1", torch.relu(y))
    x = torch.relu(x).flatten(1)
    return torch.relu(_linear(pr, x, P["conv.fc.weight"], P["conv.fc.bias"]))


def q_values(pr: Precision, P: Params, s: Spec, obs, prev_action,
             prev_reward, state, reset):
    """The recurrent Q-network over [T, B]: the trunk's features, one-hot
    previous action and previous reward into the LSTM, then the (dueling)
    head.  Returns (q [T, B, A], (h, c))."""
    T, B = obs.shape[:2]
    feats = resnet_trunk(pr, P, s, obs.reshape((T * B,) + obs.shape[2:]))
    A = _n_actions(P, s)
    pa = F.one_hot(prev_action.reshape(T, B).long(), A).to(pr.dtype)
    x = torch.cat([feats.reshape(T, B, -1), pa,
                   prev_reward.reshape(T, B, 1).to(pr.dtype)], dim=-1)
    y, state = lstm(pr, P, x, reset, *state)
    y = y.reshape(T * B, -1)
    if s.dueling:
        adv = _mlp(pr, P, "head.adv", s.n_fc, y)
        val = _mlp(pr, P, "head.val", s.n_fc, y)
        q = val + adv - adv.mean(dim=-1, keepdim=True)
    else:
        q = _mlp(pr, P, "head", s.n_fc, y)
    return q.reshape(T, B, -1), state


def r2d1_loss(pr: Precision, P: Params, Pt: Params, s: Spec, batch: Batch,
              rows: slice = slice(None)):
    """The loss (mean over the training slice of 0.5 delta^2 times the
    importance weight), the sequence priorities
    eta max|delta| + (1 - eta) mean|delta|, the double-Q argmax's
    closest call (the least gap between the online network's two largest
    Q-values, over the largest |Q|), and the online network's Q-values
    over the window after the burn-in.  ``rows``: the batch rows the loss
    averages over (all of them; fewer only for a planted fault)."""
    wT, T, n = s.warmup_T, s.batch_T, s.n_step
    W = wT + T + n
    reset = torch.cat([torch.zeros_like(batch.done[:1]), batch.done[:-1]])

    def run(params, lo, hi, state):
        return q_values(pr, params, s, batch.observation[lo:hi],
                        batch.prev_action[lo:hi], batch.prev_reward[lo:hi],
                        state, reset[lo:hi])

    state = (batch.init_h, batch.init_c)
    with torch.no_grad():
        _, online = run(P, 0, wT, state) if wT else (None, state)
        _, target = run(Pt, 0, wT, state) if wT else (None, state)
    q_full, _ = run(P, wT, W, online)
    with torch.no_grad():
        qt_full, _ = run(Pt, wT, W, target)
        online_next = q_full[n:n + T]
        next_a = online_next.argmax(dim=-1, keepdim=True)
        top2 = online_next.topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min()
                       / online_next.abs().max())
        next_q = qt_full[n:n + T].gather(-1, next_a)[..., 0]
        rew = batch.reward[wT:W - 1]
        dn = batch.done[wT:W - 1].to(torch.bool)
        ret = torch.zeros_like(rew[:T])
        ended = torch.zeros_like(dn[:T])
        for k in range(n):
            ret = ret + (s.discount ** k) * rew[k:k + T] \
                * (~ended).to(pr.dtype)
            ended = ended | dn[k:k + T]
        y = rescale(ret + s.discount ** n * (~ended).to(pr.dtype)
                    * rescale_inv(next_q, s.rescale_eps), s.rescale_eps)
    q = q_full[:T].gather(-1, batch.action[wT:wT + T].long()[..., None])[
        ..., 0]
    delta = y - q
    losses = 0.5 * delta ** 2 * batch.is_weights[None, :]
    loss = losses[:, rows].mean()
    ad = delta.detach().abs()
    priorities = s.eta * ad.max(dim=0).values \
        + (1 - s.eta) * ad.mean(dim=0)
    return loss, priorities, margin, q_full.detach()


def train_steps(P0: Params, s: Spec, batches: Sequence[Batch],
                tf32: bool = False, rows: slice = slice(None),
                dtype: torch.dtype = torch.float32) -> Steps:
    """Steps of the online network from ``P0`` (the target network stays
    at ``P0``), one a batch: the loss's gradient, clipped to a global
    norm of ``clip_norm`` (left as it is below it), then Adam."""
    device = next(iter(P0.values())).device
    pr = Precision(tf32, device, dtype)
    P = {k: v.detach().to(dtype).clone().requires_grad_(True)
         for k, v in P0.items()}
    Pt = {k: v.detach().to(dtype).clone() for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P0.items()}
    b1, b2 = s.betas
    out = Steps([], [], {}, {}, [], [])
    with pr.scope():
        for t, batch in enumerate(batches, start=1):
            batch = Batch(*(_as(dtype, x) for x in batch))
            loss, pri, margin, q = r2d1_loss(pr, P, Pt, s, batch, rows)
            out.margins.append(margin)
            out.window_q.append(q)
            grads = torch.autograd.grad(loss, list(P.values()))
            with torch.no_grad():
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                if norm >= s.clip_norm:
                    grads = [g / norm * s.clip_norm for g in grads]
                for (k, p), g in zip(P.items(), grads):
                    m[k] = b1 * m[k] + (1 - b1) * g
                    v2[k] = b2 * v2[k] + (1 - b2) * g * g
                    m_hat = m[k] / (1 - b1 ** t)
                    v_hat = v2[k] / (1 - b2 ** t)
                    p -= s.lr * m_hat / (torch.sqrt(v_hat) + s.adam_eps)
                    if t == 1:
                        out.first_grad[k] = g.clone()
            out.losses.append(float(loss.detach()))
            out.priorities.append(pri)
    out.params.update({k: p.detach() for k, p in P.items()})
    return out


def one_steps(P0: Params, s: Spec, steps, tf32: bool = False,
              dtype: torch.dtype = torch.float32):
    """The collection's forward at T = 1 for each captured step
    (obs, prev_action, prev_reward, h, c): [(q, h', c')]."""
    device = next(iter(P0.values())).device
    pr = Precision(tf32, device, dtype)
    P0 = {k: v.to(dtype) for k, v in P0.items()}
    out = []
    with pr.scope(), torch.no_grad():
        for step in steps:
            obs, pa, pr_, h, c = (_as(dtype, x) for x in step)
            B = obs.shape[0]
            q, (h2, c2) = q_values(
                pr, P0, s, obs[None], pa[None], pr_[None], (h, c),
                torch.zeros((1, B), dtype=torch.bool, device=obs.device))
            out.append((q[0], h2, c2))
    return out
