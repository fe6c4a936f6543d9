"""Plain PyTorch reference of the R2D1 trainer's computations: the
recurrent Q-network, the R2D1 loss with burn-in, value rescaling and
n-step double-Q targets, clip-by-global-norm and Adam.

Written from the published equations (R2D2, Kapturowski et al., ICLR
2019; Adam, Kingma & Ba, 2015; the Nature CNN), in float32 with no
kernel, no cache and no batching trick.  It imports nothing of the
program: it takes the parameters as a dict of tensors named as the
model's ``state_dict`` names them, and the sizes from the configuration.

``tf32=True`` is the control: the same arithmetic with every matrix
product and convolution on TF32 operands (10-bit mantissas).  On the
card it switches TF32 on for cuBLAS and cuDNN; on the CPU, which has no
TF32, the operands are rounded to TF32 before each product.
``dtype=torch.float64`` is a witness for the look at the check's tail:
the same arithmetic in float64, against which float32's own round-off
shows.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Spec(NamedTuple):
    """The sizes and hyperparameters the reference needs."""
    strides: Sequence[int]
    paddings: Sequence[int]
    obs_scale: float          # 1 / obs_divisor, rounded to float32
    n_convs: int
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
        channels = m.get("channels", (32, 64, 64))
        return Spec(
            strides=tuple(m.get("strides", (4, 2, 1))),
            paddings=tuple(m.get("paddings", (0, 1, 1))),
            obs_scale=scale, n_convs=len(channels),
            n_fc=len(m.get("fc_sizes", (512,))),
            dueling=bool(m.get("dueling", True)),
            discount=float(a["discount"]), n_step=int(a["n_step_return"]),
            warmup_T=int(a["warmup_T"]), batch_T=int(a["batch_T"]),
            eta=float(a["pri_eta"]), rescale_eps=1e-3,
            lr=float(a["learning_rate"]), clip_norm=80.0, adam_eps=1e-3)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits); the
    gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000 + ((bits >> 13) & 1)) & ~0x1FFF).view(
        torch.float32)
    return x + (rounded - x).detach()


class Precision:
    """Where the products compute: float32 (TF32 off) or TF32; ``dtype``:
    the type every value is held in."""

    def __init__(self, tf32: bool, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        self.tf32 = tf32
        self.emulate = tf32 and device.type != "cuda"
        self.dtype = dtype

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _tf32_round(x) if self.emulate else x

    @contextlib.contextmanager
    def scope(self):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def _mm(pr: Precision, a, b):
    return pr.operand(a) @ pr.operand(b)


def _linear(pr: Precision, x, w, b):
    return _mm(pr, x, w.t()) + b


def _mlp(pr: Precision, P: Params, prefix: str, n_hidden: int, x):
    i = 0
    while f"{prefix}.layers.{i}.weight" in P:
        x = _linear(pr, x, P[f"{prefix}.layers.{i}.weight"],
                    P[f"{prefix}.layers.{i}.bias"])
        if i < n_hidden:
            x = torch.relu(x)
        i += 1
    return x


def conv_trunk(pr: Precision, P: Params, s: Spec, obs):
    """[N, C, H, W] observations -> [N, features]: each conv, then ReLU."""
    x = obs.to(pr.dtype)
    if s.obs_scale != 1.0:
        x = x * s.obs_scale
    for i in range(s.n_convs):
        x = torch.relu(F.conv2d(pr.operand(x),
                                pr.operand(P[f"conv.convs.{i}.weight"]),
                                P[f"conv.convs.{i}.bias"],
                                stride=s.strides[i], padding=s.paddings[i]))
    return x.flatten(1)


def lstm(pr: Precision, P: Params, x, reset, h, c):
    """x [T, B, F]; ``reset`` [T, B] bool zeroes the state before step t.
    Gates i, f, g, o from x W_x + h W_h + b.  Returns (y, (h, c))."""
    wx, wh, b = P["lstm.wx"], P["lstm.wh"], P["lstm.b"]
    H = wh.shape[0]
    ys = []
    for t in range(x.shape[0]):
        keep = (~reset[t]).to(pr.dtype)[:, None]
        h, c = h * keep, c * keep
        z = _mm(pr, x[t], wx) + _mm(pr, h, wh) + b
        i, f = torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H])
        g, o = torch.tanh(z[:, 2 * H:3 * H]), torch.sigmoid(z[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), (h, c)


def q_values(pr: Precision, P: Params, s: Spec, obs, prev_action,
             prev_reward, state, reset):
    """The recurrent Q-network over [T, B]: conv features, one-hot
    previous action and previous reward into the LSTM, then the (dueling)
    head.  Returns (q [T, B, A], (h, c))."""
    T, B = obs.shape[:2]
    feats = conv_trunk(pr, P, s, obs.reshape((T * B,) + obs.shape[2:]))
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


def _n_actions(P: Params, s: Spec) -> int:
    prefix = "head.adv" if s.dueling else "head"
    i = 0
    while f"{prefix}.layers.{i + 1}.weight" in P:
        i += 1
    return P[f"{prefix}.layers.{i}.weight"].shape[0]


def rescale(x, eps):
    """h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def rescale_inv(x, eps):
    """h^-1, in closed form: sign(x)(((sqrt(1 + 4 eps (|x| + 1 + eps)) - 1)
    / (2 eps))^2 - 1), with the quotient written as
    2 (|x| + 1 + eps) / (sqrt(1 + 4 eps (|x| + 1 + eps)) + 1), the same
    number without the cancellation of sqrt(...) - 1, which in float32
    loses all but the last few bits of the difference (one unit in the
    last place of the root over 2 eps: about 6e-5 relative at eps =
    1e-3)."""
    a = x.abs() + 1.0 + eps
    root = 2.0 * a / (torch.sqrt(1.0 + 4.0 * eps * a) + 1.0)
    return torch.sign(x) * (root ** 2 - 1.0)


class Batch(NamedTuple):
    """A [W, b] window batch as the replay hands it over."""
    observation: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    prev_action: torch.Tensor
    prev_reward: torch.Tensor
    init_h: torch.Tensor
    init_c: torch.Tensor
    is_weights: torch.Tensor


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


class Steps(NamedTuple):
    losses: List[float]
    priorities: List[torch.Tensor]
    first_grad: Params        # the clipped gradient of step 1
    params: Params            # the parameters after the last step
    margins: List[float]      # the double-Q argmax's closest call a step
    window_q: List[torch.Tensor]   # the online window's Q-values a step


def _as(dtype, x):
    return x.to(dtype) if x.is_floating_point() else x


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


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def leaf_norms(tree: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keys=None) -> float:
    """max over leaves of |norm_prog - norm_ref| / max(norm_ref, the
    median leaf's norm_ref)."""
    keys = list(ref) if keys is None else list(keys)
    med = median([ref[k] for k in ref])
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| over max |ref|."""
    prog, ref = prog.double(), ref.double()
    return float((prog - ref).abs().max() / max(float(ref.abs().max()),
                                                  1e-30))


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keys=None) -> str:
    """The leaf at which ``worst_leaf_gap`` is taken."""
    keys = list(ref) if keys is None else list(keys)
    med = median([ref[k] for k in ref])
    return max(keys, key=lambda k: abs(prog[k] - ref[k])
               / max(ref[k], med, 1e-30))
