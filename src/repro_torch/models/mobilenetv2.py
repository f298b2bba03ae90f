"""Executable MobileNetV2 in PyTorch — the paper's evaluation model.

The same 141 leaves as ``models.graph.mobilenetv2_graph`` and
``repro.models.mobilenetv2``, each an ``nn.Module`` that carries the
reference's ``name``, ``kind`` and residual flags, so AMP4EC partitions —
contiguous leaf ranges — run leaf by leaf on different simulated edge nodes,
and the partitioned output can be held against the monolithic forward.

Residual adds are attached to the *last* leaf of each inverted-residual
block (the projection BN): the residual tensor rides along with the
activation between partitions, exactly as in the reference.

Layout: activations and residuals are NHWC, as the reference's, at every
leaf boundary. A conv leaf hands cuDNN ``x.permute(0, 3, 1, 2)``, which for
a contiguous NHWC tensor is a channels-last NCHW view (no copy), and its
channels-last output permutes back to NHWC as a view too. Weights are drawn
in the reference's HWIO layout and kept as OIHW in channels-last.

Arithmetic follows the reference: BatchNorm is
``(x - mean) * rsqrt(var + 1e-5) * scale + bias`` (never folded into the
conv), global pooling is the mean over H and W inside the Dropout leaf, and
the classifier is ``x @ w + b``. No global precision flag is set here: on
the card, fp32 convolutions follow ``torch.backends.cudnn`` (TF32 unless the
caller turns it off).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs import mobilenetv2 as C


class Leaf(nn.Module):
    """One leaf layer: ``forward(x) -> x``; the residual is handled by
    :func:`run_range` from ``save_residual`` / ``add_residual``."""

    def __init__(self, name: str, kind: str):
        super().__init__()
        self.name = name
        self.kind = kind
        self.save_residual = False       # stash x before this leaf
        self.add_residual = False        # add stash after this leaf

    def load_reference(self, params) -> None:
        """Copy the reference's parameter dict (torch tensors, reference
        layouts) into this leaf."""
        for key, value in params.items():
            getattr(self, key).copy_(value)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` split of one spatial axis: (before, after). Under
    stride 2 an even ``n`` gets (0, 1), which torch's symmetric ``padding``
    cannot express."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(Leaf):
    """NHWC convolution: ``"SAME"`` for k > 1, ``"VALID"`` for 1×1, as the
    reference's ``_conv2d``. ``w`` is held as OIHW in channels-last; its
    reference counterpart is HWIO."""

    def __init__(self, name: str, w_hwio: torch.Tensor, stride: int, cin: int):
        super().__init__(name, "Conv2d")
        self.k = w_hwio.shape[0]
        self.stride = stride
        self.groups = cin // w_hwio.shape[2]
        self.w = _frozen(w_hwio.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last))

    def load_reference(self, params) -> None:
        self.w.copy_(params["w"].permute(3, 2, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding: Tuple[int, int] = (0, 0)
        if self.k > 1:
            (hb, ha), (wb, wa) = (same_padding(n, self.k, self.stride)
                                  for n in x.shape[1:3])
            if hb == ha and wb == wa:
                padding = (hb, wb)
            else:     # pad in NHWC, so the permute below stays a view
                x = F.pad(x, (0, 0, wb, wa, hb, ha))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.w, stride=self.stride,
                     padding=padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm2d(Leaf):
    """Inference BatchNorm over the channel (last) axis, in the reference's
    order of operations."""

    def __init__(self, name: str, c: int, device):
        super().__init__(name, "BatchNorm2d")
        self.scale = _frozen(torch.ones(c, device=device))
        self.bias = _frozen(torch.zeros(c, device=device))
        self.mean = _frozen(torch.zeros(c, device=device))
        self.var = _frozen(torch.ones(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + 1e-5)
        return (x - self.mean) * inv * self.scale + self.bias


class ReLU6(Leaf):
    """``clip(x, 0, 6)``."""

    def __init__(self, name: str):
        super().__init__(name, "ReLU6")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, 0.0, 6.0)


class Dropout(Leaf):
    """Identity at inference; holds the global average pool over H and W,
    as torch's functional pooling sits between features and classifier."""

    def __init__(self, name: str):
        super().__init__(name, "Dropout")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2)) if x.ndim == 4 else x


class Linear(Leaf):
    """``x @ w + b`` with ``w`` as (in, out), the reference's layout."""

    def __init__(self, name: str, w: torch.Tensor, b: torch.Tensor):
        super().__init__(name, "Linear")
        self.w = _frozen(w)
        self.b = _frozen(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def build_mobilenetv2(generator: Optional[torch.Generator] = None,
                      device="cuda") -> nn.ModuleList:
    """Return the ordered 141 leaves with initialized parameters on
    ``device``. Weights are drawn from ``generator`` (a CPU generator;
    seed 0 when None) and then moved, so one seed gives the same weights on
    every device."""
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    device = torch.device(device)

    def conv(name, cin, cout, k, stride, groups=1) -> Conv2d:
        fan = k * k * cin // groups
        w = torch.randn((k, k, cin // groups, cout), generator=generator) / math.sqrt(fan)
        return Conv2d(name, w.to(device), stride, cin)

    def bn(name, c) -> BatchNorm2d:
        return BatchNorm2d(name, c, device)

    leaves = [conv("features.0.0", 3, 32, 3, 2), bn("features.0.1", 32),
              ReLU6("features.0.2")]
    cin = 32
    idx = 1
    for t, c, n, s in C.INVERTED_RESIDUAL_SETTING:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            use_res = stride == 1 and cin == c
            pre = f"features.{idx}"
            first_of_block = len(leaves)
            if t != 1:
                leaves += [conv(f"{pre}.pw", cin, hidden, 1, 1),
                           bn(f"{pre}.pw_bn", hidden), ReLU6(f"{pre}.pw_relu")]
            leaves += [conv(f"{pre}.dw", hidden, hidden, 3, stride, groups=hidden),
                       bn(f"{pre}.dw_bn", hidden), ReLU6(f"{pre}.dw_relu"),
                       conv(f"{pre}.proj", hidden, c, 1, 1), bn(f"{pre}.proj_bn", c)]
            if use_res:
                leaves[first_of_block].save_residual = True
                leaves[-1].add_residual = True
            cin = c
            idx += 1
    leaves += [conv("features.18.0", cin, C.LAST_CHANNELS, 1, 1),
               bn("features.18.1", C.LAST_CHANNELS), ReLU6("features.18.2"),
               Dropout("classifier.0")]
    w = torch.randn((C.LAST_CHANNELS, C.NUM_CLASSES), generator=generator) / math.sqrt(C.LAST_CHANNELS)
    leaves.append(Linear("classifier.1", w.to(device),
                         torch.zeros(C.NUM_CLASSES, device=device)))
    assert len(leaves) == 141, f"expected 141 leaves, got {len(leaves)}"
    return nn.ModuleList(leaves)


@torch.no_grad()
def run_range(leaves: nn.ModuleList, lo: int, hi: int, x: torch.Tensor,
              residual: Optional[torch.Tensor] = None):
    """Execute leaves [lo, hi) — one AMP4EC partition. Returns (x, residual)."""
    for leaf in leaves[lo:hi]:
        if leaf.save_residual:
            residual = x
        x = leaf(x)
        if leaf.add_residual:
            x = x + residual
            residual = None
    return x, residual


def run_full(leaves: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """The monolithic forward: every leaf in order."""
    y, _ = run_range(leaves, 0, len(leaves), x)
    return y


def partition_params_bytes(leaves: nn.ModuleList, lo: int, hi: int) -> int:
    """Bytes of the parameters of leaves [lo, hi)."""
    return sum(p.numel() * p.element_size()
               for leaf in leaves[lo:hi] for p in leaf.parameters())
