"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``s.  It takes and returns numpy arrays only.

Tree paths read (AtariDqnModel, non-dueling)::

    params/Conv2dModel_0/Conv_{i}/{kernel,bias}  <->  conv.convs.{i}.{weight,bias}
    params/MlpModel_0/Dense_{j}/{kernel,bias}    <->  head.layers.{j}.{weight,bias}

Layout rules:

- Dense ``kernel [in, out]`` becomes ``weight [out, in]``.
- Conv ``kernel [kh, kw, in, out]`` becomes ``weight [out, in, kh, kw]``.
- The space-to-depth first conv (``space_to_depth=True``, the flax
  default) stores ``Conv_0/kernel`` as ``[C, k/s, k/s, s*s, out]``: a
  stride-1 3D conv over the per-frame blocked input whose s*s channel
  index is ``dy*s + dx`` (rlpyt_tpu/models/conv.py:144-153,
  rlpyt_tpu/ops/pallas/frame_gather.py:62).  It is re-blocked into the
  plain stride-s conv weight as::

      weight[o, c, hb*s + dy, wb*s + dx] = kernel[c, hb, wb, dy*s + dx, o]

  The rank of ``Conv_0/kernel`` (5 or 4) says which form a tree holds.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


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
    """flax param tree (numpy leaves) -> AtariDqnModel state_dict (numpy;
    wrap with ``torch.from_numpy`` to load).  Also maps gradient trees."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for name, leaf in p["Conv2dModel_0"].items():
        i = int(name.split("_")[1])
        k = np.asarray(leaf["kernel"])
        w = _s2d_to_plain(k) if k.ndim == 5 else k.transpose(3, 2, 0, 1)
        out[f"conv.convs.{i}.weight"] = np.ascontiguousarray(w)
        out[f"conv.convs.{i}.bias"] = np.asarray(leaf["bias"])
    for name, leaf in p["MlpModel_0"].items():
        j = int(name.split("_")[1])
        out[f"head.layers.{j}.weight"] = np.ascontiguousarray(
            np.asarray(leaf["kernel"]).T)
        out[f"head.layers.{j}.bias"] = np.asarray(leaf["bias"])
    return out


def to_jax_params(state_dict, s2d_stride: Optional[int]) -> dict:
    """AtariDqnModel state_dict -> flax param tree of numpy arrays.
    ``s2d_stride``: the first conv's stride when the flax model uses
    ``space_to_depth=True``, else None."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    convs, dense = {}, {}
    for key, v in sd.items():
        parts = key.split(".")
        if parts[0] == "conv":
            i = int(parts[2])
            if parts[3] == "weight":
                v = (_plain_to_s2d(v, s2d_stride) if i == 0 and s2d_stride
                     else v.transpose(2, 3, 1, 0))
                convs.setdefault(f"Conv_{i}", {})["kernel"] = \
                    np.ascontiguousarray(v)
            else:
                convs.setdefault(f"Conv_{i}", {})["bias"] = v
        else:
            j = int(parts[2])
            leaf = dense.setdefault(f"Dense_{j}", {})
            if parts[3] == "weight":
                leaf["kernel"] = np.ascontiguousarray(v.T)
            else:
                leaf["bias"] = v
    return {"params": {"Conv2dModel_0": convs, "MlpModel_0": dense}}
