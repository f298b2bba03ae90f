"""AdamW with decoupled weight decay and global-norm clipping, as plain
functions on the port's parameter trees (nested dicts of tensors), the
counterpart of ``repro.optim.adamw``.

Moments are kept in fp32 whatever the parameter's dtype; parameters keep
their own dtype (a bf16 parameter is updated in fp32 and cast back). The
global norm and the bias corrections are computed in fp32.

Unlike the reference, whose arrays are immutable, ``update`` writes the new
parameters and moments into the tensors it is given and returns them: a
second copy of the parameters and moments would not fit beside the first at
full width (qwen2.5-3b: 6.2 GB of bf16 parameters and 24.7 GB of fp32
moments). It works through each leaf in slices along its leading axis, so
that its fp32 temporaries never exceed one slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim.schedule import constant
from repro_torch.utils.params import tree_leaves, tree_map

#: elements in one slice of a leaf that ``update`` and ``global_norm`` work on
#: at a time (each fp32 temporary of the update is at most 256 MB)
_SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _slices(*tensors):
    """Matching views of same-shape tensors along their leading axis, each of
    at most ``_SLICE`` elements where rows allow (the whole tensor below two
    dimensions, and a DTensor, which is its rank's shard already)."""
    t0 = tensors[0]
    if t0.dim() < 2 or t0.numel() <= _SLICE or hasattr(t0, "placements"):
        return [tensors]
    rows = max(1, _SLICE // (t0.numel() // t0.shape[0]))
    return zip(*(t.split(rows) for t in tensors))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    with torch.no_grad():
        squares = [s.float().square().sum() for leaf in tree_leaves(tree)
                   for (s,) in _slices(leaf)]
        return torch.stack(squares).sum().sqrt()


def opt_state_specs(param_specs) -> AdamWState:
    """Logical-axes tree for AdamWState mirroring the params' specs."""
    return AdamWState(step=(), mu=param_specs, nu=param_specs)


def adamw(
    lr: Callable[[torch.Tensor], torch.Tensor] | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        """One step: returns (params, state, {"grad_norm", "lr"}), the
        parameters and moments updated in place."""
        gnorm = global_norm(grads)
        scale = (torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
                 if clip_norm is not None else None)
        step = state.step + 1
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def update_leaf(p, g, m, v):
            for p_, g_, m_, v_ in _slices(p, g, m, v):
                g32 = g_.float() if scale is None else g_.float() * scale
                m_.mul_(b1).add_(g32, alpha=1 - b1)
                v_.mul_(b2).addcmul_(g32, g32, value=1 - b2)
                p32 = p_.float()
                delta = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) + weight_decay * p32
                p_.copy_(p32 - lr_t * delta)

        # by key, so that trees built in another key order still pair up
        tree_map(update_leaf, params, grads, state.mu, state.nu)
        return params, AdamWState(step, state.mu, state.nu), dict(grad_norm=gnorm, lr=lr_t)

    return Optimizer(init=init, update=update)
