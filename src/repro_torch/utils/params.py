"""Parameter construction with paired logical-sharding specs.

``ParamBuilder`` creates initialized tensors while recording, in a parallel
tree, the logical axes of every parameter. ``init`` functions therefore
return ``(params, specs)`` with identical structure. The port runs on one
device, so the specs are metadata only.

Parameters keep the reference's tree: nested dicts of tensors, with a
stacked leading layer axis under ``"blocks"``. ``from_jax`` therefore maps a
reference parameter tree leaf by leaf.

For shape-only work (``param_count``) build on ``device="meta"``: every
parameter is then a tensor without storage.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


class ParamBuilder:
    """Draws parameters from ``generator`` (which must live on ``device``;
    unused on the meta device) and records their logical axes."""

    def __init__(self, generator: Optional[torch.Generator], dtype=torch.bfloat16,
                 device="cuda"):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: Dict[str, Any] = {}
        self.specs: Dict[str, Any] = {}

    def param(
        self,
        name: str,
        shape: Tuple[int, ...],
        axes: Tuple[Optional[str], ...],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype=None,
    ) -> torch.Tensor:
        assert len(shape) == len(axes), f"{name}: shape {shape} vs axes {axes}"
        assert name not in self.params, f"duplicate param {name}"
        dtype = dtype or self.dtype
        if init not in ("zeros", "ones", "normal", "embedding"):
            raise ValueError(f"unknown init {init!r}")
        if self.device.type == "meta":
            arr = torch.empty(shape, dtype=dtype, device=self.device)
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=dtype, device=self.device)
        else:
            if init == "embedding":
                scale = scale or 0.02
            elif scale is None:
                # fan-in scaling over the contracting (second-to-last) axis
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            arr = (torch.randn(shape, generator=self.generator, dtype=torch.float32,
                               device=self.device) * scale).to(dtype)
        self.params[name] = arr
        self.specs[name] = axes
        return arr

    def sub(self, name: str) -> "ParamBuilder":
        """A child builder whose tree hangs under ``name``; it draws from the
        same generator."""
        assert name not in self.params, f"duplicate sub {name}"
        child = ParamBuilder(self.generator, self.dtype, self.device)
        self.params[name] = child.params
        self.specs[name] = child.specs
        return child

    def build(self):
        return self.params, self.specs


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts of equal structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def stack_layers(per_layer: list):
    """Stack a list of identical-structure (params, specs) into layer-stacked
    params. Tensors gain a leading layer axis; specs gain a leading "layers"
    entry."""
    params_list = [p for p, _ in per_layer]
    stacked = tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)
    specs = _prefix_specs(per_layer[0][1])
    return stacked, specs


def _prefix_specs(specs):
    if isinstance(specs, dict):
        return {k: _prefix_specs(v) for k, v in specs.items()}
    return ("layers",) + tuple(specs)


def abstract_stack(params, specs, num_layers: int):
    """Add a leading layer axis to meta-tensor params without building each
    layer; specs gain a leading "layers" entry."""
    stacked = tree_map(lambda s: torch.empty((num_layers,) + tuple(s.shape), dtype=s.dtype,
                                             device="meta"), params)
    return stacked, _prefix_specs(specs)


def layer_slices(tree) -> list:
    """Every layer of a layer-stacked tree, as views. One ``torch.unbind`` per
    leaf: its backward stacks the layers' gradients in one pass, where
    indexing each layer would add a zero tensor of the whole stack per layer."""
    split = tree_map(lambda a: a.unbind(0), tree)
    n = len(tree_leaves(split)[0])
    return [tree_map(lambda layers: layers[i], split) for i in range(n)]


def count_params(params) -> int:
    return int(sum(leaf.numel() for leaf in tree_leaves(params)))


def tree_bytes(params) -> int:
    return int(sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(params)))


def from_jax(params_np, device="cuda"):
    """Convert a reference parameter tree (JAX or numpy leaves) to torch.

    ``torch.from_numpy`` rejects the ``ml_dtypes`` bfloat16, so bf16 leaves
    go through float32, which holds every bf16 value exactly.
    """
    def conv(a):
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                              dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(device)  # a writable copy
    return tree_map(conv, params_np)


def mobilenetv2_from_jax(ref_leaves_or_params, device="cuda"):
    """The port's MobileNetV2 leaves carrying the reference's weights.

    ``ref_leaves_or_params``: the reference's 141 leaves
    (``repro.models.mobilenetv2.build_mobilenetv2``) or their ``params``
    dicts, in order. Each dict goes through :func:`from_jax`; the leaves
    convert HWIO conv weights to their OIHW channels-last layout.
    """
    from repro_torch.models.mobilenetv2 import build_mobilenetv2  # models sit above utils

    leaves = build_mobilenetv2(device=device)
    refs = list(ref_leaves_or_params)
    if len(refs) != len(leaves):
        raise ValueError(f"expected {len(leaves)} leaves, got {len(refs)}")
    with torch.no_grad():
        for leaf, ref in zip(leaves, refs):
            params = getattr(ref, "params", ref)
            leaf.load_reference(from_jax(params, device))
    return leaves
