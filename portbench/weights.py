"""Random weights for a configuration, made by the benchmark from the seed.

The program's ``Model.init(device="meta")`` gives the tree's names, shapes
and dtypes only; the values are drawn here, on the device, from a
``torch.Generator`` seeded with the run's seed: one buffer per dtype filled
by normal draws in a few large calls, then each leaf a view of it, scaled
in place by the family's ``init_scale`` (``reference/<family>.py``). Both
the program and the plain reference read these tensors.
"""

from __future__ import annotations

import torch

#: elements drawn per call
CHUNK = 1 << 30


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def make(meta_params, seed: int, device, scale) -> dict:
    """A tree shaped like ``meta_params`` (meta tensors), filled from
    ``seed``; ``scale(path, shape)`` gives each leaf's (mean, std)."""
    leaves = list(_leaves(meta_params))
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    buffers = {}
    for dtype in sorted({t.dtype for _, t in leaves}, key=str):
        n = sum(t.numel() for _, t in leaves if t.dtype == dtype)
        buf = torch.empty(n, dtype=dtype, device=device)
        for i in range(0, n, CHUNK):
            buf[i:i + CHUNK].normal_(generator=gen)
        buffers[dtype] = [buf, 0]
    out: dict = {}
    for path, t in leaves:
        buf = buffers[t.dtype]
        leaf = buf[0][buf[1]:buf[1] + t.numel()].view(t.shape)
        buf[1] += t.numel()
        mean, std = scale(path, t.shape)
        leaf.mul_(std).add_(mean)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
