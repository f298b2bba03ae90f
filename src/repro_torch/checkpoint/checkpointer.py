"""Numpy-based checkpointing for parameter / optimizer trees, in the format
of ``repro.checkpoint.checkpointer``: a checkpoint written by either package
restores in the other.

A tree is flattened to path-keyed arrays in one ``.npz`` beside a JSON
manifest (step, sorted keys, metadata). Paths follow the reference's
``_flatten``: dict keys in sorted order, a NamedTuple field as ``.<field>``
(``opt/.step``, ``opt/.mu/<path>``, ``opt/.nu/<path>``), a sequence entry
by its index; ``None`` holds no leaf. bf16 is stored as f32, which holds
every bf16 value exactly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _children(tree):
    """(path part, child) pairs of a tree node in the reference's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), t) for i, t in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if tree is None:
        return {}
    children = _children(tree)
    if children is None:
        return {prefix: tree}
    flat = {}
    for part, child in children:
        flat.update(_flatten(child, f"{prefix}/{part}" if prefix else part))
    return flat


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``leaf_fn(path, leaf)``."""
    if tree is None:
        return None
    path = lambda part: f"{prefix}/{part}" if prefix else part
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, path(str(k))) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf_fn, path(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaf_fn, path(str(i))) for i, t in enumerate(tree))
    return leaf_fn(prefix, tree)


def _to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:         # npz has no bf16: store as f32 (lossless)
        t = t.float()
    return t.numpy()


def save_checkpoint(directory: str, step: int, params, opt_state=None,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}")
    flat = _flatten({"params": params, "opt": opt_state or {}})
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    np.savez(path + ".npz", **arrays)
    manifest = dict(step=step, keys=sorted(arrays.keys()),
                    metadata=metadata or {})
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".json")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like, step: Optional[int] = None
                       ) -> Tuple[Any, Any, int]:
    """Restore (params, opt_state, step); ``like`` = a (params, opt_state)
    template pair, whose leaves give each restored tensor its device and
    dtype."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    template = {"params": like[0], "opt": like[1] if like[1] is not None else {}}
    with np.load(path) as data:
        missing = [k for k in _flatten(template) if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}")
        restored = _rebuild(template, lambda key, leaf: torch.from_numpy(data[key]).to(
            device=leaf.device, dtype=leaf.dtype))
    return restored["params"], restored["opt"], step
