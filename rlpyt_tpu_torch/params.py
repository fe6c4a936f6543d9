"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``s.  It takes and returns numpy arrays only.

Tree paths read (AtariDqnModel, AtariCatDqnModel, AtariR2d1Model)::

    params/Conv2dModel_0/Conv_{i}/{kernel,bias}  <->  conv.convs.{i}.{weight,bias}
    params/MlpModel_0/Dense_{j}/{kernel,bias}    <->  head.layers.{j}.{weight,bias}
    params/DuelingHead_0/MlpModel_0/Dense_{j}/.. <->  head.adv.layers.{j}.{..}
    params/DuelingHead_0/MlpModel_1/Dense_{j}/.. <->  head.val.layers.{j}.{..}
    params/DistributionalDuelingHead_0/MlpModel_{0,1}/..  <->  head.{adv,val}...
    params/LstmCore_0/{wx,wh,b}                  <->  lstm.{wx,wh,b}

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
    for name, leaf in p["Conv2dModel_0"].items():
        i = int(name.split("_")[1])
        k = np.asarray(leaf["kernel"])
        w = _s2d_to_plain(k) if k.ndim == 5 else k.transpose(3, 2, 0, 1)
        out[f"conv.convs.{i}.weight"] = np.ascontiguousarray(w)
        out[f"conv.convs.{i}.bias"] = np.asarray(leaf["bias"])
    for path, prefix in _HEADS:
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
    tree = {}

    def node(path):
        d = tree
        for key in path:
            d = d.setdefault(key, {})
        return d

    for key, v in sd.items():
        prefix, _, rest = key.rpartition(".layers.")
        if key.startswith("conv."):
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
        else:
            j, kind = rest.split(".")
            leaf = node(paths[prefix] + (f"Dense_{j}",))
            if kind == "weight":
                leaf["kernel"] = np.ascontiguousarray(v.T)
            else:
                leaf["bias"] = v
    return {"params": tree}
