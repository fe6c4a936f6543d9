"""Config variants (port of rlpyt_tpu/utils/variant.py: update_config,
save_variant, load_variant).  Configs are nested plain dicts; a variant
is deep-merged into a copy of the default."""
from __future__ import annotations

import json
import os
from typing import Dict


def update_config(default: Dict, variant: Dict) -> Dict:
    """Deep-merge ``variant`` into a copy of ``default``; keys the default
    lacks are added."""
    out = dict(default)
    for k, v in variant.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = update_config(out[k], v)
        else:
            out[k] = v
    return out


def save_variant(variant: Dict, log_dir: str):
    """Write ``variant`` to ``log_dir/variant.json``."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "variant.json"), "w") as f:
        json.dump(variant, f, indent=2, default=str)


def load_variant(log_dir: str) -> Dict:
    with open(os.path.join(log_dir, "variant.json")) as f:
        return json.load(f)
