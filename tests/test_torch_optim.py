"""The port's AdamW and learning-rate schedules against the reference's.

Schedules at steps 0-100 within 1e-6 (fp32 arithmetic of the same
expressions). AdamW updates on random trees of fp32 and bf16 leaves: fp32
within 1e-6 of the reference, bf16 within one bf16 rounding step (2^-8,
relative) of it, since both round an fp32 result that may differ in its last
bit; the moments are fp32 whatever the parameter's dtype. Plus the
reference's own convergence check (``tests/test_system.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import constant as ref_constant
from repro.optim import cosine_with_warmup as ref_cosine
from repro.optim import global_norm as ref_global_norm
from repro_torch.optim import AdamWState, adamw, constant, cosine_with_warmup, global_norm
from repro_torch.utils.params import tree_leaves, tree_map

# the module, which the package's ``adamw`` function shadows
adamw_mod = importlib.import_module("repro_torch.optim.adamw")

SCHEDULES = {
    "cosine(3e-3, 10, 80)": ((3e-3, 10, 80), {}),
    "cosine(1e-3, 0, 50, final 0)": ((1e-3, 0, 50), {"final_frac": 0.0}),
    "cosine(5e-4, 30, 30)": ((5e-4, 30, 30), {}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_cosine_schedule_matches_reference(name):
    args, kw = SCHEDULES[name]
    ref_fn, fn = ref_cosine(*args, **kw), cosine_with_warmup(*args, **kw)
    steps = np.arange(0, 101, dtype=np.int32)
    want = np.asarray(jax.vmap(ref_fn)(jnp.asarray(steps)))
    got = torch.stack([fn(torch.tensor(s)) for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * args[0])


def test_constant_schedule_matches_reference():
    for s in (0, 1, 100):
        got = constant(2e-4)(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == float(ref_constant(2e-4)(jnp.int32(s)))


def _tree(seed):
    """Numpy leaves: a stacked (layers, in, out) weight, a matrix, a vector
    and a scalar, in fp32 or bf16 (bf16 values, held in fp32)."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (3, 8, 5), "norm": (3, 8)}, "embed": (11, 8), "bias": (5,),
              "gain": ()}
    return tree_map(lambda s: np.asarray(rng.standard_normal(s), dtype=np.float32), shapes)


DTYPES = {"blocks": {"w": "bfloat16", "norm": "float32"}, "embed": "bfloat16",
          "bias": "float32", "gain": "float32"}


def _by_path(tree, path=""):
    """{path: leaf} of nested dicts (either package's tree)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _by_path(tree[k], f"{path}/{k}").items()}
    return {path: tree}


def _to_torch(tree):
    # a copy: the update writes in place, and jnp.asarray may share the buffer
    return tree_map(lambda a, d: torch.from_numpy(np.array(a)).to(getattr(torch, d)), tree,
                    DTYPES)


def _to_jax(tree):
    return tree_map(lambda a, d: jnp.asarray(a, dtype=getattr(jnp, d)), tree, DTYPES)


def test_adamw_matches_reference_and_keeps_dtypes():
    params_np = _tree(0)
    params, ref_params = _to_torch(params_np), _to_jax(params_np)
    opt, ref_opt = adamw(cosine_with_warmup(1e-2, 2, 10)), ref_adamw(ref_cosine(1e-2, 2, 10))
    state, ref_state = opt.init(params), ref_opt.init(ref_params)
    for step in range(3):
        grads_np = tree_map(lambda a: a * (3.0 if step == 1 else 0.1), _tree(step + 1))
        params, state, m = opt.update(_to_torch(grads_np), state, params)
        ref_params, ref_state, ref_m = ref_opt.update(_to_jax(grads_np), ref_state,
                                                      ref_params)
        assert isinstance(state, AdamWState) and int(state.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-6)
        got_p, want_p, dtypes = _by_path(params), _by_path(ref_params), _by_path(DTYPES)
        for path, got in got_p.items():
            want, dt = want_p[path], dtypes[path]
            assert got.dtype == getattr(torch, dt)
            tol = 2.0 ** -8 if dt == "bfloat16" else 1e-6
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=tol, atol=1e-6)
        for tree, ref_tree in ((state.mu, ref_state.mu), (state.nu, ref_state.nu)):
            want_t = _by_path(ref_tree)
            for path, got in _by_path(tree).items():
                want = want_t[path]
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                           atol=1e-9)


def test_adamw_slices_give_the_whole_leaf_update(monkeypatch):
    """Working through a leaf in slices along its leading axis changes no
    value (without clipping, which sums the norm in another order)."""
    params_np, grads_np = _tree(0), _tree(1)
    results = []
    for slice_elems in (1 << 26, 7):
        monkeypatch.setattr(adamw_mod, "_SLICE", slice_elems)
        opt = adamw(1e-2, clip_norm=None)
        params = _to_torch(params_np)
        state = opt.init(params)
        for _ in range(2):
            params, state, m = opt.update(_to_torch(grads_np), state, params)
        results.append((params, state, m))
    (p1, s1, m1), (p2, s2, m2) = results
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1.mu) + tree_leaves(s1.nu),
                    tree_leaves(p2) + tree_leaves(s2.mu) + tree_leaves(s2.nu)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-6)


def test_adamw_pairs_leaves_by_key():
    """Moments built in another key order (a restored checkpoint, say) still
    meet their own parameters, even between leaves of one shape."""
    g = torch.Generator().manual_seed(0)
    rn = lambda: torch.randn(4, 4, generator=g)
    params, grads = {"w_q": rn(), "w_o": rn()}, {"w_q": rn(), "w_o": rn()}
    opt = adamw(1e-2)
    state = opt.init(params)
    mu = {"w_o": rn(), "w_q": rn()}
    nu = {k: v.abs() for k, v in mu.items()}
    results = []
    for order in (["w_q", "w_o"], ["w_o", "w_q"]):
        p = {k: v.clone() for k, v in params.items()}
        st = AdamWState(state.step, {k: mu[k].clone() for k in order},
                        {k: nu[k].clone() for k in order})
        results.append(opt.update(grads, st, p))
    (p1, s1, _), (p2, s2, _) = results
    for k in params:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1.mu[k], s2.mu[k])


def test_global_norm_matches_reference(monkeypatch):
    tree = _tree(5)
    want = float(ref_global_norm(_to_jax(tree)))
    assert float(global_norm(_to_torch(tree))) == pytest.approx(want, rel=1e-6)
    monkeypatch.setattr(adamw_mod, "_SLICE", 10)
    assert float(global_norm(_to_torch(tree))) == pytest.approx(want, rel=1e-6)


def test_adamw_converges_on_quadratic():
    """``tests/test_system.py::test_adamw_converges_on_quadratic`` on the port."""
    opt = adamw(lambda s: torch.tensor(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state, _ = opt.update({"w": g}, state, params)
    assert float(params["w"].abs().max()) < 1e-2
