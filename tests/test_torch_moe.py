"""The port's MoE (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) in fp32: the sort-based dispatch with capacity drops
(the default capacity factor, on tokens that lean towards one expert until
it overflows) and without (capacity factor 32), the Switch load-balance
aux, ``apply_moe`` with a shared expert, and gradients through the index
scatter and gather; plus the reference's per-token oracle
(``tests/test_models.py::test_moe_dispatch_matches_per_token_oracle``) at
its 2e-5.

Tolerance 1e-4 against the reference, as ``tests/test_torch_model.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.models import moe as REF_MOE
from repro.utils.params import ParamBuilder as RefParamBuilder
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from repro_torch.utils.params import ParamBuilder, from_jax

TOL = 1e-4
#: the reference oracle's sizes (tests/test_models.py:165-168)
SMALL = dict(d_model=32, num_experts=4, top_k=2, d_ff_expert=16, num_shared_experts=0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], f"{path}/{k}").items()}
    return {path: tree}


def _pair(arch, seed, **changes):
    """(reference cfg, reference params, port cfg, port params) of one MoE layer."""
    changes = {"dtype": "float32", **changes}
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    b = RefParamBuilder(jax.random.PRNGKey(seed), dtype=jnp.float32)
    REF_MOE.init_moe(b, "ffn", ref_cfg)
    ref_p = b.build()[0]["ffn"]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    return ref_cfg, ref_p, cfg, from_jax(ref_p, device="cpu")


def _capacity(T, cfg):
    return max(4, int(T * cfg.top_k / cfg.num_experts * cfg.capacity_factor) + 1)


def _dispatch_both(ref_p, cfg, x, capacity):
    kw = dict(top_k=cfg.top_k, e_lo=0, num_experts=cfg.num_experts,
              e_local=cfg.num_experts, capacity=capacity)
    want = jax.jit(lambda p, x: REF_MOE._dispatch_compute(
        x, p["router"], p["w_in"], p["w_out"], axis_name=None, **kw))(ref_p, jnp.asarray(x))
    p = from_jax(ref_p, device="cpu")
    got = MOE._dispatch_compute(torch.from_numpy(x), p["router"], p["w_in"], p["w_out"], **kw)
    return got, want


def _tokens_leaning_to_expert_0(ref_p, T, D, seed):
    """(T, D) tokens plus a shared component along the router's expert-0
    column, so that expert 0 is in most tokens' top-k and overflows."""
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)
    col = np.asarray(ref_p["router"][:, 0])
    return x + (2.0 * col / np.linalg.norm(col) ** 2).astype(np.float32)


@pytest.mark.parametrize("case", ["drops", "no_drops"])
def test_dispatch_matches_reference(case):
    """y and aux of ``_dispatch_compute`` with ``axis_name=None``, e_lo = 0:
    with drops at the default capacity factor (asserted to occur), and
    without at capacity factor 32."""
    cf = 1.25 if case == "drops" else 32.0
    _, ref_p, cfg, _ = _pair("kimi-k2-1t-a32b", 0, capacity_factor=cf, **SMALL)
    T = 64
    x = _tokens_leaning_to_expert_0(ref_p, T, cfg.d_model, 1)
    capacity = _capacity(T, cfg)
    (y, aux), (want_y, want_aux) = _dispatch_both(ref_p, cfg, x, capacity)
    probs = jax.nn.softmax(jnp.asarray(x) @ ref_p["router"], -1)
    counts = np.bincount(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]).ravel(),
                         minlength=cfg.num_experts)
    assert (counts.max() > capacity) == (case == "drops"), (counts, capacity)
    assert y.shape == (T, cfg.d_model) and aux.shape == (T,)
    _close(y, want_y)
    _close(aux, want_aux)


def test_dispatch_matches_per_token_oracle():
    """No drops (capacity factor 32): each token's output is the weighted sum
    of its top-k experts' SwiGLU FFNs, at the reference test's 2e-5."""
    _, ref_p, cfg, p = _pair("kimi-k2-1t-a32b", 0, capacity_factor=32.0, **SMALL)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4, cfg.d_model))
                         .astype(np.float32))
    y, _ = MOE.apply_moe(p, x, cfg)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], -1)
    top_w, top_i = torch.topk(probs, cfg.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.top_k):
            e = int(top_i[t, j])
            u, g = torch.chunk(xf[t] @ p["w_in"][e], 2)
            want[t] += top_w[t, j] * ((u * F.silu(g)) @ p["w_out"][e])
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), want, rtol=2e-5, atol=2e-5)


def test_aux_is_the_switch_loss():
    """aux = E * sum_e f_e p_e on every token, positive, as the reference's."""
    _, ref_p, cfg, p = _pair("kimi-k2-1t-a32b", 0, **SMALL)
    T = 24
    x = np.random.default_rng(3).standard_normal((T, cfg.d_model)).astype(np.float32)
    (_, aux), (_, want_aux) = _dispatch_both(ref_p, cfg, x, _capacity(T, cfg))
    probs = torch.softmax(torch.from_numpy(x) @ p["router"], -1)
    f = torch.bincount(torch.topk(probs, cfg.top_k)[1].ravel(),
                       minlength=cfg.num_experts) / (T * cfg.top_k)
    want = cfg.num_experts * torch.sum(f * probs.mean(0))
    torch.testing.assert_close(aux, want.expand(T), rtol=1e-6, atol=1e-6)
    _close(aux, want_aux)
    assert float(aux[0]) > 0


@pytest.fixture(scope="module", params=["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def layer_pair(request):
    """One reduced MoE layer with its shared expert, and x (2, 16, D)."""
    ref_cfg, ref_p, cfg, p = _pair(request.param, 4)
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return ref_cfg, ref_p, cfg, p, x


def test_init_tree_matches_reference(layer_pair):
    """The router fp32, (E, D, 2F) and (E, F, D) stacks, the shared leaves."""
    ref_cfg, _, cfg, _, _ = layer_pair
    rb = RefParamBuilder(None, dtype=jnp.bfloat16, abstract=True)
    REF_MOE.init_moe(rb, "ffn", ref_cfg)
    b = ParamBuilder(torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    MOE.init_moe(b, "ffn", cfg)
    (ref_params, ref_specs), (params, specs) = rb.build(), b.build()
    ref_leaves, leaves = _leaves(ref_params), _leaves(params)
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert tuple(leaves[path].shape) == tuple(ref_leaf.shape), path
        assert str(leaves[path].dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
    assert _leaves(specs) == _leaves(ref_specs)
    assert leaves["/ffn/router"].dtype == torch.float32
    assert "/ffn/w_shared_up" in leaves


def test_apply_moe_matches_reference(layer_pair):
    ref_cfg, ref_p, cfg, p, x = layer_pair
    want, want_aux = jax.jit(lambda p, x: REF_MOE.apply_moe(p, x, ref_cfg))(ref_p,
                                                                             jnp.asarray(x))
    got, aux = MOE.apply_moe(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and aux.shape == (x.shape[0] * x.shape[1],)
    _close(got, want)
    _close(aux, want_aux)


def test_apply_moe_gradients_match_reference(layer_pair):
    """d/d(params, x) of sum(y * w) + aux.mean(): through the router's
    softmax and top-k weights, the scatter into the capacity buffer, the
    expert products, the gather back and the inverse permutation."""
    ref_cfg, ref_p, cfg, p, x = layer_pair
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, x):
        y, aux = REF_MOE.apply_moe(p, x, ref_cfg)
        return jnp.sum(y * w) + aux.mean()

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(ref_p, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = MOE.apply_moe(leaves, xt, cfg)
    (torch.sum(y * torch.from_numpy(w)) + aux.mean()).backward()
    _close(xt.grad, want_x)
    for k in want_p:
        _close(leaves[k].grad, want_p[k])


def test_capacity_follows_reference(layer_pair, monkeypatch):
    """The same Python expression: max(4, int(B*S*k/E*cf) + 1), at the
    forward's token count and at a decode step's (T = B)."""
    ref_cfg, ref_p, cfg, p, x = layer_pair
    seen = {"ref": [], "port": []}
    for mod, key in ((REF_MOE, "ref"), (MOE, "port")):
        inner = mod._dispatch_compute

        def spy(*args, _inner=inner, _key=key, **kw):
            seen[_key].append(kw["capacity"])
            return _inner(*args, **kw)

        monkeypatch.setattr(mod, "_dispatch_compute", spy)
    for xs in (x, x[:, :1]):
        REF_MOE.apply_moe(ref_p, jnp.asarray(xs), ref_cfg)
        MOE.apply_moe(p, torch.from_numpy(np.ascontiguousarray(xs)), cfg)
    assert seen["port"] == seen["ref"] == [_capacity(32, cfg), 4]


def test_2d_impl_without_rules_fails_as_reference():
    """``impl="2d"`` needs logical rules on a mesh with a "model" axis: without
    them it fails at the reference's ``assert``, in both packages."""
    ref_cfg, ref_p, cfg, p = _pair("kimi-k2-1t-a32b", 0, **SMALL)
    with pytest.raises(AssertionError):
        REF_MOE.apply_moe(ref_p, jnp.zeros((1, 2, cfg.d_model)), ref_cfg, impl="2d")
    with pytest.raises(AssertionError):
        MOE.apply_moe(p, torch.zeros(1, 2, cfg.d_model), cfg, impl="2d")
    assert not hasattr(MOE, "_MESH_ITEM")


# ---------------------------------------------------------------------------
# expert parallelism on 4 gloo ranks: a (2, 2) ("data", "model") mesh
# ---------------------------------------------------------------------------

#: y and aux against the reference's, its own sharded test's tolerance
#: (tests/test_moe_sharded.py:58-59); the gradients at TOL
EP_TOL = 2e-5


@pytest.fixture(scope="module")
def expert_parallel(tmp_path_factory):
    """The reference's reduced kimi-k2 layer and x (2, 8, 64) from a seed;
    its local (no-mesh) ``apply_moe`` with the gradients of sum(y * w) +
    mean(aux) for each case's aux; and the port's ranks' results
    (``torch_gloo_ranks.job_moe``)."""
    from torch_gloo_ranks import MOE_CASES, MOE_CHANGES, Ranks, flatten

    ref_cfg = dataclasses.replace(ref_get_config("kimi-k2-1t-a32b").reduced(), **MOE_CHANGES)
    b = RefParamBuilder(jax.random.PRNGKey(0), dtype=jnp.float32)
    REF_MOE.init_moe(b, "ffn", ref_cfg)
    ref_p = b.build()[0]["ffn"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, ref_cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    d = tmp_path_factory.mktemp("moe_ranks")
    np.savez(d / "in.npz", x=x, w=w, **{k: np.asarray(v) for k, v in flatten(ref_p, "p/").items()})
    ranks = Ranks("moe", d)

    T, E = x.shape[0] * x.shape[1], ref_cfg.num_experts
    kw = dict(top_k=ref_cfg.top_k, e_lo=0, num_experts=E, e_local=E, axis_name=None)

    def block_aux(p, x):
        """The default rules' aux: the Switch loss of each data block of
        tokens (the mesh branch's per-block ``_dispatch_compute``)."""
        xf = x.reshape(T, -1)
        cap = max(4, int(T // 2 * ref_cfg.top_k / E * ref_cfg.capacity_factor) + 1)
        return jnp.concatenate([REF_MOE._dispatch_compute(
            blk, p["router"], p["w_in"], p["w_out"], capacity=cap, **kw)[1]
            for blk in jnp.split(xf, 2)])

    want = {}
    for name, _, _ in MOE_CASES:
        def loss(p, x, name=name):
            y, aux = REF_MOE.apply_moe(p, x, ref_cfg)
            if name == "default":
                aux = block_aux(p, x)
            return jnp.sum(y * w) + aux.mean(), (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                             has_aux=True))(ref_p, jnp.asarray(x))
        want[name] = dict(y=y, aux=aux, grads={"x": gx, **gp})
    return ranks.results(), want


@pytest.mark.parametrize("case", ["default", "experts_data_model", "2d"])
def test_expert_parallel_matches_reference(expert_parallel, case):
    """On every rank: y within 2e-5 of the reference's local ``apply_moe``
    (drop-free at capacity factor 16), aux within 2e-5 of the reference's
    (per data block of tokens under the default rules, where the tokens are
    cut on "data"; global where they are not), and every gradient of
    sum(y * w) + mean(aux), x's included, within 1e-4."""
    ranks, want = expert_parallel
    for out in ranks:
        _close(torch.from_numpy(out[f"{case}/y"]), want[case]["y"], EP_TOL)
        _close(torch.from_numpy(out[f"{case}/aux"]), want[case]["aux"], EP_TOL)
        for k, g in want[case]["grads"].items():
            _close(torch.from_numpy(out[f"{case}/grad/{k}"]), g)


def test_expert_parallel_matches_port_off_the_mesh(expert_parallel):
    """Each case's y equals the port's own off-mesh ``apply_moe`` within 2e-5."""
    ranks, _ = expert_parallel
    for out in ranks:
        for case in ("default", "experts_data_model", "2d"):
            _close(torch.from_numpy(out[f"{case}/y"]), out["offmesh/y"], EP_TOL)
