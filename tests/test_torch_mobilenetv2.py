"""The port's MobileNetV2 executor (``repro_torch.models.mobilenetv2``)
against the reference ``repro.models.mobilenetv2``, on the same weights
(``mobilenetv2_from_jax``) and numpy-seeded inputs, within the reference's
own bound (``rtol = atol = 1e-5``, ``tests/test_pipeline.py``).

JAX is imported inside the CPU tests only: the card's machine runs the
``gpu`` case with ``--noconftest`` and may have no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import DistributedInference, ModelPartitioner, make_paper_cluster
from repro_torch.models.graph import mobilenetv2_graph
from repro_torch.models.mobilenetv2 import (build_mobilenetv2, partition_params_bytes,
                                            run_full, run_range, same_padding)
from repro_torch.utils.params import mobilenetv2_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The reference's leaves and the port's leaves carrying their weights."""
    from repro.models.mobilenetv2 import build_mobilenetv2 as ref_build
    ref = ref_build()
    return ref, mobilenetv2_from_jax(ref, "cpu")


def test_leaves_match_reference(pair):
    ref, port = pair
    assert len(port) == 141
    assert [(l.name, l.kind, l.save_residual, l.add_residual) for l in port] == \
           [(l.name, l.kind, l.save_residual, l.add_residual) for l in ref]
    graph = mobilenetv2_graph()
    assert [(l.name, l.kind) for l in port] == [(l.name, l.kind) for l in graph.layers]


@pytest.mark.parametrize("shape", [(1, 96, 96, 3), (1, 224, 224, 3), (2, 97, 61, 3)])
def test_outputs_match_reference(pair, shape):
    """(2, 97, 61, 3) takes the symmetric split under stride 2 at odd sizes."""
    import jax.numpy as jnp
    from repro.models.mobilenetv2 import run_full as ref_run_full
    ref, port = pair
    x = _x(shape)
    want = np.asarray(ref_run_full(ref, jnp.asarray(x)))
    got = run_full(port, torch.from_numpy(x))
    assert got.shape == want.shape == (shape[0], 1000)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_weights_from_param_dicts_equal_weights_from_leaves(pair):
    ref, port = pair
    again = mobilenetv2_from_jax([leaf.params for leaf in ref], "cpu")
    for a, b in zip(port.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_boundaries_match_reference(pair):
    """Activation and residual at every boundary of [40, 80, 120], where the
    logits' small scale would make an absolute 1e-5 loose."""
    import jax.numpy as jnp
    from repro.models.mobilenetv2 import run_range as ref_run_range
    ref, port = pair
    x = _x((1, 96, 96, 3), seed=1)
    h, res = torch.from_numpy(x), None
    rh, rres = jnp.asarray(x), None
    lo = 0
    for cut in (40, 80, 120, 141):
        h, res = run_range(port, lo, cut, h, res)
        rh, rres = ref_run_range(ref, lo, cut, rh, rres)
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)
        assert (res is None) == (rres is None), cut
        if res is not None:
            np.testing.assert_allclose(res.numpy(), np.asarray(rres), **TOL)
        lo = cut
    # a cut inside a block carries its residual across the boundary
    _, res = run_range(port, 0, 42, torch.from_numpy(x))
    _, rres = ref_run_range(ref, 0, 42, jnp.asarray(x))
    assert res is not None and rres is not None
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), **TOL)


def test_every_two_way_cut_is_bit_exact():
    leaves = build_mobilenetv2(device="cpu")
    x = torch.from_numpy(_x((1, 64, 64, 3), seed=2))
    y = run_full(leaves, x)
    for cut in range(1, 141):
        h, res = run_range(leaves, 0, cut, x)
        h, res = run_range(leaves, cut, 141, h, res)
        assert res is None and torch.equal(h, y), cut


def test_partition_params_bytes_match_reference(pair):
    from repro.models.mobilenetv2 import partition_params_bytes as ref_bytes
    ref, port = pair
    for lo, hi in ((0, 141), (0, 108), (108, 124), (124, 141), (7, 8), (139, 141)):
        assert partition_params_bytes(port, lo, hi) == ref_bytes(ref, lo, hi), (lo, hi)


@pytest.mark.parametrize("n, stride", [(224, 2), (112, 2), (97, 2), (61, 2), (7, 2), (96, 1), (1, 2)])
def test_same_padding_is_xlas(n, stride):
    """Against the padding XLA applies: a 3×3 conv of ones over a ramp,
    whose output reveals which input rows each window covered."""
    import jax
    import jax.numpy as jnp
    x = jnp.arange(1, n + 1, dtype=jnp.float32).reshape(1, n, 1, 1)
    w = jnp.ones((3, 1, 1, 1), jnp.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))[0, :, 0, 0]
    before, after = same_padding(n, 3, stride)
    padded = np.concatenate([np.zeros(before), np.arange(1, n + 1), np.zeros(after)])
    got = np.array([padded[i:i + 3].sum() for i in range(0, len(padded) - 2, stride)])
    np.testing.assert_array_equal(got, want)


def _executor(leaves):
    return lambda lo, hi, x, res: run_range(leaves, lo, hi, x, res)


def test_port_executor_in_reference_pipeline():
    """The port's executor plugged into ``repro.core.pipeline`` unchanged."""
    from repro.core.cluster import make_paper_cluster as ref_cluster
    from repro.core.partitioner import ModelPartitioner as RefPartitioner
    from repro.core.pipeline import DistributedInference as RefInference
    from repro.models.graph import mobilenetv2_graph as ref_graph
    d = RefInference(ref_cluster(), RefPartitioner(ref_graph()),
                     executor=_executor(build_mobilenetv2(device="cpu")))
    assert d.verify_numerics(torch.from_numpy(_x((1, 96, 96, 3), seed=1)))


def test_port_pipeline_verifies_and_serves_from_cache():
    leaves = build_mobilenetv2(device="cpu")
    d = DistributedInference(make_paper_cluster(), ModelPartitioner(mobilenetv2_graph()),
                             executor=_executor(leaves), use_cache=True)
    x = torch.from_numpy(_x((1, 96, 96, 3), seed=1))
    assert d.verify_numerics(x)
    y = d.infer(x)
    assert torch.equal(y, run_full(leaves, x))
    stages = len(d.plan.partitions)
    assert (d.cache.hits, d.cache.misses) == (0, stages)
    assert d.infer(x.clone()) is y
    assert (d.cache.hits, d.cache.misses) == (stages, stages)


def test_build_is_seeded_and_keeps_reference_layouts():
    a = build_mobilenetv2(torch.Generator().manual_seed(3), device="cpu")
    b = build_mobilenetv2(torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    stem, dw, head = a[0], a[3], a[140]
    assert stem.w.shape == (32, 3, 3, 3) and stem.w.is_contiguous(memory_format=torch.channels_last)
    assert dw.kind == "Conv2d" and dw.w.shape == (32, 1, 3, 3) and dw.groups == 32
    assert head.w.shape == (1280, 1000) and head.b.shape == (1000,)


@pytest.mark.gpu
def test_card_matches_cpu():
    """The card against the CPU on the same weights, fp32 convolutions in
    IEEE fp32 (cuDNN's TF32 off for the test), and ``verify_numerics`` on
    CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = build_mobilenetv2(device="cpu")
    gpu = build_mobilenetv2(device="cuda")
    x = torch.from_numpy(_x((4, 224, 224, 3), seed=4))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = run_full(gpu, x.cuda())
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), run_full(cpu, x), **TOL)
        d = DistributedInference(make_paper_cluster(), ModelPartitioner(mobilenetv2_graph()),
                                 executor=_executor(gpu))
        assert d.verify_numerics(x.cuda())
