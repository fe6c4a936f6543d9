"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``s.  It takes and returns numpy arrays only.

Tree paths read (AtariDqnModel, AtariCatDqnModel, AtariR2d1Model,
DqnMlpModel, R2d1MlpModel, Conv2dHeadModel and the policy-gradient
models)::

    params/Conv2dModel_0/Conv_{i}/{kernel,bias}  <->  conv.convs.{i}.{weight,bias}
    params/MlpModel_0/Dense_{j}/{kernel,bias}    <->  head.layers.{j}.{weight,bias}
                                     (a PG tree: fc.layers.{j}.{weight,bias})
    params/Dense_0/{kernel,bias}  (PG, pi)       <->  pi.{weight,bias}
    params/Dense_1/{kernel,bias}  (PG, V)        <->  value.{weight,bias}
    params/DuelingHead_0/MlpModel_0/Dense_{j}/.. <->  head.adv.layers.{j}.{..}
    params/DuelingHead_0/MlpModel_1/Dense_{j}/.. <->  head.val.layers.{j}.{..}
    params/DistributionalDuelingHead_0/MlpModel_{0,1}/..  <->  head.{adv,val}...
    params/LstmCore_0/{wx,wh,b}                  <->  lstm.{wx,wh,b}
    params/MlpModel_{0,1}/..  (R2d1MlpModel)     <->  mlp... / head...
    params/MlpModel_1/Dense_{j}/.. (Gaussian V)  <->  value_mlp.layers.{j}...
    params/log_std  (Gaussian PG)                <->  log_std
    norm_stats/RunningMeanStd_0/{mean,var,count} <->  obs_norm.{mean,var,count}

The Q-value policy-gradient agents keep a dict of networks ("mu" or
"pi", "q" or "q1"/"q2", "target_*"), each a flax MlpModel_0:
``from_jax_qpg_params`` and ``to_jax_qpg_params`` map that dict onto the
agent's ``nets`` state_dict::

    {name}/params/MlpModel_0/Dense_{j}/{kernel,bias}
        <->  {name}.mlp.layers.{j}.{weight,bias}

Layout rules:

- Dense ``kernel [in, out]`` becomes ``weight [out, in]``.
- Conv ``kernel [kh, kw, in, out]`` becomes ``weight [out, in, kh, kw]``.
- LstmCore's ``wx [F, 4H]``, ``wh [H, 4H]`` and ``b [4H]`` are copied as
  they are: the port keeps the JAX layout and gate order (i, f, g, o).
- The space-to-depth first conv (``space_to_depth=True``, the flax
  default) stores ``Conv_0/kernel`` as ``[C, k/s, k/s, s*s, out]``: a
  stride-1 3D conv over the per-frame blocked input whose s*s channel
  index is ``dy*s + dx`` (rlpyt_tpu/models/conv.py:144-153,
  rlpyt_tpu/ops/pallas/frame_gather.py:62).  It is re-blocked into the
  plain stride-s conv weight as::

      weight[o, c, hb*s + dy, wb*s + dx] = kernel[c, hb, wb, dy*s + dx, o]

  The rank of ``Conv_0/kernel`` (5 or 4) says which form a tree holds.
- A tree with a top-level ``Dense_0`` is a policy-gradient tree: its
  ``MlpModel_0`` is the fc trunk before the pi and V layers, and a
  top-level ``MlpModel_1`` (the Gaussian feedforward model's) is the V
  MLP.
- A Q tree with an ``LstmCore_0`` and no conv is R2d1MlpModel's: its
  ``MlpModel_0`` is the trunk before the LSTM (``mlp``) and
  ``MlpModel_1`` the head.  Going back, ``mlp.*`` keys say so.
- Both dueling heads map onto ``head.adv`` / ``head.val``.  Going back,
  the value stream's output width says which flax module a state_dict
  came from: 1 for ``DuelingHead_0``, ``n_atoms`` (> 1) for
  ``DistributionalDuelingHead_0``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

# flax module of each head in a tree  <->  the port's prefix for it
_HEADS = ((("MlpModel_0",), "head"),
          (("DuelingHead_0", "MlpModel_0"), "head.adv"),
          (("DuelingHead_0", "MlpModel_1"), "head.val"),
          (("DistributionalDuelingHead_0", "MlpModel_0"), "head.adv"),
          (("DistributionalDuelingHead_0", "MlpModel_1"), "head.val"))


# A policy-gradient model's top-level pi and V layers.
_PG_DENSE = {"Dense_0": "pi", "Dense_1": "value"}
# The Gaussian feedforward model's V MLP, and its observation statistics.
_PG_VALUE_MLP = ("MlpModel_1", "value_mlp")
_NORM = ("RunningMeanStd_0", "obs_norm")


def _s2d_to_plain(kernel: np.ndarray) -> np.ndarray:
    C, kb, _, ss, out = kernel.shape
    s = math.isqrt(ss)
    x = kernel.reshape(C, kb, kb, s, s, out)        # [c, hb, wb, dy, dx, o]
    x = x.transpose(5, 0, 1, 3, 2, 4)               # [o, c, hb, dy, wb, dx]
    return x.reshape(out, C, kb * s, kb * s)


def _plain_to_s2d(weight: np.ndarray, s: int) -> np.ndarray:
    out, C, k, _ = weight.shape
    kb = k // s
    x = weight.reshape(out, C, kb, s, kb, s)        # [o, c, hb, dy, wb, dx]
    x = x.transpose(1, 2, 4, 3, 5, 0)               # [c, hb, wb, dy, dx, o]
    return x.reshape(C, kb, kb, s * s, out)


def from_jax_params(tree) -> Dict[str, np.ndarray]:
    """flax param tree (numpy leaves) -> state_dict of the port's model
    (numpy; wrap with ``torch.from_numpy`` to load).  Also maps gradient
    trees."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for name, leaf in p.get("Conv2dModel_0", {}).items():
        i = int(name.split("_")[1])
        k = np.asarray(leaf["kernel"])
        w = _s2d_to_plain(k) if k.ndim == 5 else k.transpose(3, 2, 0, 1)
        out[f"conv.convs.{i}.weight"] = np.ascontiguousarray(w)
        out[f"conv.convs.{i}.bias"] = np.asarray(leaf["bias"])
    pg = "Dense_0" in p
    mlp_r2d1 = (not pg and "LstmCore_0" in p
                and "Conv2dModel_0" not in p)
    heads = _HEADS + ((("MlpModel_1",), "head"),) if mlp_r2d1 else _HEADS
    for path, prefix in heads:
        if pg and path == ("MlpModel_0",):
            prefix = "fc"
        elif mlp_r2d1 and path == ("MlpModel_0",):
            prefix = "mlp"
        mlp = p
        for key in path:
            mlp = mlp.get(key, {})
        for name, leaf in mlp.items():
            j = int(name.split("_")[1])
            out[f"{prefix}.layers.{j}.weight"] = np.ascontiguousarray(
                np.asarray(leaf["kernel"]).T)
            out[f"{prefix}.layers.{j}.bias"] = np.asarray(leaf["bias"])
    for name, leaf in p.get("LstmCore_0", {}).items():
        out[f"lstm.{name}"] = np.asarray(leaf)
    for flax_name, prefix in _PG_DENSE.items():
        if flax_name in p:
            out[f"{prefix}.weight"] = np.ascontiguousarray(
                np.asarray(p[flax_name]["kernel"]).T)
            out[f"{prefix}.bias"] = np.asarray(p[flax_name]["bias"])
    if pg:
        for name, leaf in p.get(_PG_VALUE_MLP[0], {}).items():
            j = int(name.split("_")[1])
            out[f"{_PG_VALUE_MLP[1]}.layers.{j}.weight"] = \
                np.ascontiguousarray(np.asarray(leaf["kernel"]).T)
            out[f"{_PG_VALUE_MLP[1]}.layers.{j}.bias"] = np.asarray(
                leaf["bias"])
    if "log_std" in p:
        out["log_std"] = np.asarray(p["log_std"])
    stats = tree.get("norm_stats", {}).get(_NORM[0], {})
    for name, leaf in stats.items():
        out[f"{_NORM[1]}.{name}"] = np.asarray(leaf)
    return out


def to_jax_params(state_dict, s2d_stride: Optional[int]) -> dict:
    """The port's state_dict -> flax param tree of numpy arrays.
    ``s2d_stride``: the first conv's stride when the flax model uses
    ``space_to_depth=True``, else None."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    val_bias = {int(k.split(".")[-2]): v for k, v in sd.items()
                if k.startswith("head.val.layers.") and k.endswith(".bias")}
    dueling = ("DistributionalDuelingHead_0"
               if val_bias and val_bias[max(val_bias)].shape[0] > 1
               else "DuelingHead_0")
    paths = {prefix: path for path, prefix in _HEADS
             if path[0] in ("MlpModel_0", dueling)}
    paths["fc"] = ("MlpModel_0",)
    paths[_PG_VALUE_MLP[1]] = (_PG_VALUE_MLP[0],)
    if any(k.startswith("mlp.layers.") for k in sd):    # R2d1MlpModel
        paths["mlp"], paths["head"] = ("MlpModel_0",), ("MlpModel_1",)
    pg_dense = {prefix: name for name, prefix in _PG_DENSE.items()}
    tree, stats = {}, {}

    def node(path):
        d = tree
        for key in path:
            d = d.setdefault(key, {})
        return d

    for key, v in sd.items():
        prefix, _, rest = key.rpartition(".layers.")
        if key == "log_std":
            tree["log_std"] = v
        elif key.startswith(_NORM[1] + "."):
            stats[key.split(".")[1]] = v
        elif key.startswith("conv."):
            i, kind = key.split(".")[2:]
            leaf = node(("Conv2dModel_0", f"Conv_{i}"))
            if kind == "weight":
                v = np.ascontiguousarray(
                    _plain_to_s2d(v, s2d_stride) if i == "0" and s2d_stride
                    else v.transpose(2, 3, 1, 0))
                leaf["kernel"] = v
            else:
                leaf["bias"] = v
        elif key.startswith("lstm."):
            node(("LstmCore_0",))[key.split(".")[1]] = v
        elif key.split(".")[0] in pg_dense:
            prefix, kind = key.split(".")
            leaf = node((pg_dense[prefix],))
            if kind == "weight":
                leaf["kernel"] = np.ascontiguousarray(v.T)
            else:
                leaf["bias"] = v
        else:
            j, kind = rest.split(".")
            leaf = node(paths[prefix] + (f"Dense_{j}",))
            if kind == "weight":
                leaf["kernel"] = np.ascontiguousarray(v.T)
            else:
                leaf["bias"] = v
    if stats:
        return {"params": tree, "norm_stats": {_NORM[0]: stats}}
    return {"params": tree}


def s2d_stride_of(model) -> Optional[int]:
    """The first conv's stride where the JAX model (``space_to_depth``
    at its default, True) stores ``Conv_0`` blocked: stride above 1,
    kernel a multiple of it, no padding.  None for any other model, and
    for one whose JAX counterpart never blocks (``space_to_depth`` False
    on the class: Conv2dHeadModel)."""
    conv = getattr(model, "conv", None)
    if conv is None or not getattr(model, "space_to_depth", True):
        return None
    c0 = conv.convs[0]
    k, s, p = c0.kernel_size[0], c0.stride[0], c0.padding[0]
    return s if s > 1 and k % s == 0 and p == 0 else None


def agent_params_to_jax(agent, state_dict=None) -> dict:
    """The agent's weights as the JAX agent's parameter tree, numpy
    leaves: a model's flax variables, or a Q-value policy-gradient
    agent's dict of them.  What a snapshot stores.  ``state_dict``: the
    model's, if not its live one (a split model's gathered whole)."""
    if state_dict is None:
        state_dict = agent.model.state_dict()
    if hasattr(agent, "nets"):
        return to_jax_qpg_params(state_dict)
    return to_jax_params(state_dict, s2d_stride_of(agent.model))


def from_jax_qpg_params(tree) -> Dict[str, np.ndarray]:
    """A QPG agent's dict of flax trees (or of their gradients) -> the
    state_dict of its ``nets``."""
    out = {}
    for group, sub in tree.items():
        mlp = (sub["params"] if "params" in sub else sub)["MlpModel_0"]
        for name, leaf in mlp.items():
            j = int(name.split("_")[1])
            out[f"{group}.mlp.layers.{j}.weight"] = np.ascontiguousarray(
                np.asarray(leaf["kernel"]).T)
            out[f"{group}.mlp.layers.{j}.bias"] = np.asarray(leaf["bias"])
    return out


def to_jax_qpg_params(state_dict) -> dict:
    """A QPG agent's ``nets`` state_dict -> its dict of flax trees."""
    tree = {}
    for key, v in state_dict.items():
        group, _, _, j, kind = key.split(".")
        v = np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
        leaf = tree.setdefault(group, {"params": {"MlpModel_0": {}}})[
            "params"]["MlpModel_0"].setdefault(f"Dense_{j}", {})
        if kind == "weight":
            leaf["kernel"] = np.ascontiguousarray(v.T)
        else:
            leaf["bias"] = v
    return tree
