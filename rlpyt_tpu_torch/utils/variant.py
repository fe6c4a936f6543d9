"""Config variants (port of rlpyt_tpu/utils/variant.py: VariantLevel,
make_variants, update_config, save_variant, load_variant).  Configs are
nested plain dicts; a variant is deep-merged into a copy of the default,
and a sweep is the cross product of levels of keyed values."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple


class VariantLevel(NamedTuple):
    """One sweep axis: ``keys`` are key paths into the config,
    ``values`` one tuple of values per variant (one value per key), and
    ``dir_names`` the variants' directory names."""

    keys: Sequence[Tuple[str, ...]]
    values: Sequence[Sequence[Any]]
    dir_names: Sequence[str]


def make_variants(*levels: VariantLevel) -> Tuple[List[Dict], List[str]]:
    """The cross product of ``levels``: (variants, log_dirs), the first
    level varying slowest; each log dir joins the levels' names."""
    variants: List[Dict] = [{}]
    log_dirs: List[str] = [""]
    for level in levels:
        if len(level.values) != len(level.dir_names):
            raise ValueError("a level needs one dir name per value tuple")
        new_variants, new_dirs = [], []
        for variant, log_dir in zip(variants, log_dirs):
            for vals, name in zip(level.values, level.dir_names):
                if len(vals) != len(level.keys):
                    raise ValueError("a value tuple needs one value per key")
                v = json.loads(json.dumps(variant))   # a deep copy
                for key_path, val in zip(level.keys, vals):
                    d = v
                    for k in key_path[:-1]:
                        d = d.setdefault(k, {})
                    d[key_path[-1]] = val
                new_variants.append(v)
                new_dirs.append(os.path.join(log_dir, name) if log_dir
                                else name)
        variants, log_dirs = new_variants, new_dirs
    return variants, log_dirs


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
