"""The port's model against the reference in fp32, on reduced configs of
each ported family: qwen2.5-3b (dense), mamba2-130m (SSM), recurrentgemma-9b
(hybrid: 2 layers = one (rec, attn) super-block), a 3-layer hybrid whose
third layer is a tail block, deepseek-v2-236b (MoE with MLA: one dense
layer, then one MoE layer), kimi-k2-1t-a32b (MoE with GQA), a dense model
with MLA, whisper-medium (audio: a 2-layer encoder over 64 frames, 2
decoder layers with cross attention) and llama-3.2-vision-90b (VLM at 4
layers: two super-blocks of one self-attention and one gated cross layer,
over 32 image tokens). Train logits and the MoE aux loss, prefill logits
and caches, loss, and decode steps (after ``fill_cross_cache`` for audio
and VLM), from the same converted parameters; plus the reference's own
consistency checks (``tests/test_models.py``) run on the port, the MoE ones
at its capacity factor 16 (the forward drops tokens at capacity,
single-token decode never does).

The VLM's cross-layer ``gate`` starts at zero, and tanh(0) = 0 makes every
cross layer add nothing, so a wrong cross attention would pass: every VLM
case sets the gate to 0.5 in both trees before it compares.

Tolerance 1e-4 against the reference: a few layers of the same fp32
arithmetic summed in another order, over logits of magnitude ~10. The
decode-vs-forward bound 2e-3 is the reference's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.utils.params import from_jax, tree_map

TOL = 1e-4
T = 16


#: (arch, config changes) of each case; "-tail" is the hybrid with a tail block
VARIANTS = {
    "qwen2.5-3b": ("qwen2.5-3b", {}),
    "mamba2-130m": ("mamba2-130m", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "recurrentgemma-9b-tail": ("recurrentgemma-9b", {"num_layers": 3}),
    "deepseek-v2-236b": ("deepseek-v2-236b", {}),
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", {}),
    "dense-mla": ("deepseek-v2-236b", {"family": "dense"}),
    "whisper-medium": ("whisper-medium", {}),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {"num_layers": 4}),
}
#: the VLM's cross-layer gate in every comparison (init: 0, which hides the layer)
GATE = 0.5
#: the reference's capacity factor for decode-vs-forward checks of MoE
#: (tests/test_models.py:84-92)
NO_DROPS = 16.0


def _pair(arch="qwen2.5-3b", **changes):
    changes = {"dtype": "float32", **changes}
    ref_model = RefModel(dataclasses.replace(ref_get_config(arch).reduced(), **changes))
    model = Model(dataclasses.replace(get_config(arch).reduced(), **changes))
    ref_params, _ = ref_model.init(jax.random.PRNGKey(1))
    ref_params = open_gates(ref_params)
    return ref_model, ref_params, model, from_jax(ref_params, device="cpu")


def open_gates(ref_params):
    """The reference tree with every gated cross layer's ``gate`` at GATE."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, GATE) if path[-1].key == "gate" else a, ref_params)


def memory(cfg, batch, seed=0):
    """{"frames"} or {"images"} (numpy fp32, seeded) of the audio and VLM
    families, else {}."""
    if cfg.family not in ("audio", "vlm"):
        return {}
    m = cfg.num_frames if cfg.family == "audio" else cfg.num_image_tokens
    arr = np.random.default_rng(100 + seed).standard_normal((batch, m, cfg.d_model))
    return {"frames" if cfg.family == "audio" else "images": arr.astype(np.float32)}


def fill(model, params, cache, mem, framework):
    """``fill_cross_cache`` with the batch's memory (audio and VLM only)."""
    if not mem:
        return cache
    (arr,) = mem.values()
    arr = jnp.asarray(arr) if framework == "jax" else torch.from_numpy(arr)
    return model.fill_cross_cache(params, cache, arr)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaves(tree, path=""):
    """{path: leaf} of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, t in enumerate(tree) for p, v in _leaves(t, f"{path}/{i}").items()}
    return {path: tree}


@pytest.fixture(scope="module", params=list(VARIANTS))
def model_pair(request):
    arch, changes = VARIANTS[request.param]
    ref_model, ref_params, model, params = _pair(arch, **changes)
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, T + 1))
    return ref_model, ref_params, model, params, toks.astype(np.int32), memory(model.cfg, 2)


def test_forward_train_and_prefill_match_reference(model_pair):
    ref_model, ref_params, model, params, toks, mem = model_pair
    batch_j = {"tokens": jnp.asarray(toks[:, :T]), **tree_map(jnp.asarray, mem)}
    batch_t = {"tokens": torch.from_numpy(toks[:, :T]), **tree_map(torch.from_numpy, mem)}
    want, want_aux, _ = jax.jit(lambda p, b: ref_model.forward(p, b, mode="train"))(
        ref_params, batch_j)
    got, aux, cache = model.forward(params, batch_t, mode="train")
    assert cache is None
    _close(aux, want_aux)
    assert (float(aux) > 0) if model.cfg.family == "moe" else (float(aux) == 0.0)
    _close(got[..., :model.cfg.vocab_size], want[..., :model.cfg.vocab_size])
    assert torch.all(got[..., model.cfg.vocab_size:] == -1e30)

    want_last, _, want_cache = jax.jit(
        lambda p, b: ref_model.forward(p, b, mode="prefill"))(ref_params, batch_j)
    got_last, _, got_cache = model.forward(params, batch_t, mode="prefill")
    _close(got_last[:, :model.cfg.vocab_size], want_last[:, :model.cfg.vocab_size])
    got_leaves, want_leaves = _leaves(got_cache), _leaves(want_cache)
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, w in want_leaves.items():
        assert tuple(got_leaves[path].shape) == tuple(w.shape), path
        _close(got_leaves[path], w)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen2-7b", "yi-9b"])
def test_forward_matches_reference_other_dense(arch):
    """The other dense configs: partial rotary (chatglm3), no QKV bias (yi),
    untied embeddings."""
    ref_model, ref_params, model, params = _pair(arch)
    toks = np.random.default_rng(3).integers(0, model.cfg.vocab_size, (1, 8)).astype(np.int32)
    want, _, _ = jax.jit(lambda p, t: ref_model.forward(p, {"tokens": t}))(
        ref_params, jnp.asarray(toks))
    got, _, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    v = model.cfg.vocab_size
    _close(got[..., :v], want[..., :v])


def test_loss_matches_reference(model_pair):
    ref_model, ref_params, model, params, toks, mem = model_pair
    want, want_nll = jax.jit(lambda p, b: ref_model.loss_fn(p, b, remat=False))(
        ref_params, {"tokens": jnp.asarray(toks), **tree_map(jnp.asarray, mem)})
    got, got_nll = model.loss_fn(params, {"tokens": torch.from_numpy(toks),
                                          **tree_map(torch.from_numpy, mem)})
    _close(got, want)
    _close(got_nll, want_nll)


@pytest.mark.parametrize("variant,kv_cache_dtype", [
    ("qwen2.5-3b", "model"), ("qwen2.5-3b", "int8"), ("mamba2-130m", "model"),
    ("recurrentgemma-9b", "model"), ("recurrentgemma-9b-tail", "model"),
    ("deepseek-v2-236b", "model"), ("kimi-k2-1t-a32b", "model"), ("kimi-k2-1t-a32b", "int8"),
    ("dense-mla", "model"), ("whisper-medium", "model"), ("llama-3.2-vision-90b", "model")])
def test_decode_steps_match_reference(variant, kv_cache_dtype):
    arch, changes = VARIANTS[variant]
    ref_model, ref_params, model, params = _pair(arch, kv_cache_dtype=kv_cache_dtype,
                                                 **changes)
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (2, T)).astype(np.int32)
    jcache, _ = ref_model.init_cache(2, T + 2)
    tcache, _ = model.init_cache(2, T + 2, device="cpu")
    mem = memory(model.cfg, 2, seed=1)
    jcache = fill(ref_model, ref_params, jcache, mem, "jax")
    tcache = fill(model, params, tcache, mem, "torch")
    step = jax.jit(ref_model.decode_step)
    for t in range(T):
        want, jcache = step(ref_params, jnp.asarray(toks[:, t]), jcache)
        got, tcache = model.decode_step(params, torch.from_numpy(toks[:, t]), tcache)
        _close(got[:, :model.cfg.vocab_size], want[:, :model.cfg.vocab_size])
    assert int(tcache["pos"]) == T
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == tuple(jcache[name].shape), name
        assert str(tcache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype), name
        _close(tcache[name], jcache[name])


@pytest.mark.parametrize("variant", ["whisper-medium", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("memory_len", [0, 7])
def test_init_cache_matches_reference(variant, memory_len):
    """The audio and VLM caches (self K/V and the cross "xk"/"xv" of
    ``memory_len`` memory tokens, 0 = the config's): the reference's names,
    shapes, dtypes and logical axes."""
    arch, changes = VARIANTS[variant]
    ref_model, _, model, _ = _pair(arch, **changes)
    want, want_specs = ref_model.init_cache(3, 9, abstract=True, memory_len=memory_len)
    got, got_specs = model.init_cache(3, 9, device="cpu", memory_len=memory_len)
    assert sorted(got) == sorted(want) and got_specs == want_specs
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype), name
    m = memory_len or (model.cfg.num_frames if model.cfg.family == "audio"
                       else model.cfg.num_image_tokens)
    assert got["xk"].shape[3] == m


def test_decode_matches_forward(model_pair):
    """Sequential decode logits == full-forward logits at every position (MoE
    at the drop-free capacity factor)."""
    _, _, model, params, toks, mem = model_pair
    if model.cfg.num_experts:
        model = Model(dataclasses.replace(model.cfg, capacity_factor=NO_DROPS))
    tokens = torch.from_numpy(toks[:1, :T])
    mem = {k: a[:1] for k, a in mem.items()}
    fwd, _, _ = model.forward(params, {"tokens": tokens, **tree_map(torch.from_numpy, mem)},
                              mode="train")
    cache, _ = model.init_cache(1, 32, device="cpu")
    cache = fill(model, params, cache, mem, "torch")
    v = model.cfg.vocab_size
    errs = []
    for t in range(T):
        logits, cache = model.decode_step(params, tokens[:, t], cache)
        errs.append(float(torch.max(torch.abs(logits[0, :v] - fwd[0, t, :v]))))
    assert max(errs) < 2e-3, f"max dec-vs-fwd err {max(errs)}"


def test_sliding_window_decode_matches_windowed_forward():
    """Ring-buffer sliding decode == full forward with the same window."""
    cfg = dataclasses.replace(get_config("yi-9b").reduced(), dtype="float32", window=8)
    model = Model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(2), device="cpu")
    steps = 20
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (1, steps)).astype(np.int32))
    fwd, _, _ = model.forward(params, {"tokens": tokens}, mode="train", window=8)
    cache, _ = model.init_cache(1, 8, device="cpu")   # ring buffer of window size
    for t in range(steps):
        logits, cache = model.decode_step(params, tokens[:, t], cache, window=8)
        err = float(torch.max(torch.abs(logits[0, :cfg.vocab_size]
                                        - fwd[0, t, :cfg.vocab_size])))
        assert err < 2e-3, f"pos {t}: err {err}"


def test_sliding_window_decode_matches_windowed_forward_moe():
    """The same on kimi-k2 (GQA + MoE): its leading dense layer and its MoE
    layer both decode against window-sized ring buffers."""
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(), dtype="float32",
                              window=8, capacity_factor=NO_DROPS)
    model = Model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(2), device="cpu")
    steps = 20
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (1, steps)).astype(np.int32))
    fwd, _, _ = model.forward(params, {"tokens": tokens}, mode="train", window=8)
    cache, _ = model.init_cache(1, 8, device="cpu")
    assert cache["d_k"].shape[3] == cache["k"].shape[3] == 8
    for t in range(steps):
        logits, cache = model.decode_step(params, tokens[:, t], cache, window=8)
        err = float(torch.max(torch.abs(logits[0, :cfg.vocab_size]
                                        - fwd[0, t, :cfg.vocab_size])))
        assert err < 2e-3, f"pos {t}: err {err}"


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b"])
def test_window_follows_reference(arch):
    ref_model, _, model, _ = _pair(arch)
    for kind in ("train", "prefill", "decode", "long"):
        assert model._window(kind) == ref_model._window(kind)


def _loss_grads(model, params, batch, remat=True):
    from repro_torch.utils.params import tree_leaves

    inputs = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss_fn(inputs, batch, remat=remat)
    return loss, torch.autograd.grad(loss, tree_leaves(inputs))


def test_remat_outputs_matches_full_and_reference():
    """``remat_policy = "outputs"`` (reduced qwen2.5-3b, fp32): the gradients
    equal "full"'s and the reference's "outputs" gradients within 1e-5, and
    its backward recomputes fewer FLOPs than "full"'s: the forward of each
    layer's saved attention output, the w_o product. The FFN's w_out
    product is recomputed under neither policy: torch's checkpoint stops
    its recomputation before a block's last product."""
    from repro_torch.launch.dryrun import count_step
    from repro_torch.utils.params import tree_leaves

    ref_model, ref_params, model, params = _pair("qwen2.5-3b")
    ref_model.remat_policy = "outputs"
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, T + 1)).astype(np.int32)
    want = jax.grad(lambda p: ref_model.loss_fn(p, {"tokens": jnp.asarray(toks)},
                                                remat=True)[0])(ref_params)
    want = [np.asarray(a) for a in jax.tree.leaves(want)]
    batch = {"tokens": torch.from_numpy(toks)}
    grads = {}
    for policy in ("full", "outputs"):
        model.remat_policy = policy
        _, grads[policy] = _loss_grads(model, params, batch)
    # JAX walks a dict's keys sorted
    assert len(want) == len(grads["outputs"]) == len(tree_leaves(params))
    flat_ref = dict(zip(sorted(_leaves(ref_params)), want))
    for path, g_full, g_out in zip(_leaves(params), grads["full"], grads["outputs"]):
        assert torch.equal(g_full, g_out), path
        _close(g_out, flat_ref[path], tol=1e-5)

    def step(p, b):
        return _loss_grads(model, p, b)[1]

    flops = {}
    meta_params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
    meta_batch = {"tokens": torch.empty((2, T + 1), dtype=torch.int32, device="meta")}
    for policy in ("full", "outputs"):
        model.remat_policy = policy
        flops[policy] = count_step(step, (meta_params, meta_batch))["flops"]
    cfg = model.cfg
    tokens = 2 * T
    saved = cfg.num_layers * 2 * tokens * cfg.num_heads * cfg.head_dim_ * cfg.d_model
    assert flops["full"] - flops["outputs"] == saved
