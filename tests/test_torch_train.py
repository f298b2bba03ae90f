"""The port's training path against the reference, on reduced configs in
fp32 with the reference's parameters (JAX ``init``, converted).

- ``loss_fn`` gradients of the dense, SSM, hybrid, MoE (deepseek-v2
  with MLA, kimi-k2 with GQA), audio (whisper: the encoder's non-causal
  attention included) and VLM (4 layers, the cross-layer gate at 0.5: at
  its initial 0 the cross layers would add nothing) families, with and
  without remat, against ``jax.value_and_grad`` of the reference's
  ``loss_fn``; once on the plain path and once through the kernels'
  ``torch.autograd.Function``s, whose launch is swapped for the plain version
  (the CPU has no kernel).
- Two training steps of reduced qwen2.5-3b against the jitted reference
  step: metrics, parameters and the AdamW state.
- The Functions' mechanics: gradients equal to autograd of the plain
  version, nothing saved without grad, a missing final-state gradient.
- Ports of ``tests/test_system.py``'s training and checkpoint checks, with
  its thresholds, and the training launcher on the CPU.

Tolerance 1e-4, as ``tests/test_torch_model.py``: the same fp32 arithmetic
summed in another order, over gradients and losses of magnitude ~1-10.

Card tests (marker ``gpu``): the gradients of ``loss_fn`` on the card,
through the Hopper kernels, against the CPU on the same parameters. They
skip where no CUDA device is present.
"""

import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batches_for_model
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models.model import Model
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import make_eval_step, make_train_step, train
from repro_torch.utils.params import from_jax, tree_leaves, tree_map

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models.model import Model as RefModel
    from repro.optim import adamw as ref_adamw
    from repro.optim import cosine_with_warmup as ref_cosine
    from repro.train.step import make_train_step as ref_make_train_step
except ModuleNotFoundError:
    # the machine with the card has no JAX; only the gpu-marked tests, which
    # need no reference, run there (``pytest --noconftest -m gpu``)
    jax = None

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
T = 16
ARCHS = ["qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "whisper-medium", "llama-3.2-vision-90b"]
#: config changes of the gradient checks: two VLM super-blocks
CHANGES = {"llama-3.2-vision-90b": {"num_layers": 4}}
#: the VLM's cross-layer gate in every comparison (init 0 hides the layer)
GATE = 0.5


def _leaves(tree, path=""):
    """{path: leaf} of nested dicts."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], f"{path}/{k}").items()}
    return {path: tree}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(cfg, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, T + 1)).astype(np.int32)


def _memory(cfg, seed=0, batch=2) -> dict:
    """The audio frames or VLM image tokens of a batch (numpy fp32), else {}."""
    if cfg.family not in ("audio", "vlm"):
        return {}
    m = cfg.num_frames if cfg.family == "audio" else cfg.num_image_tokens
    arr = np.random.default_rng(100 + seed).standard_normal((batch, m, cfg.d_model))
    return {"frames" if cfg.family == "audio" else "images": arr.astype(np.float32)}


def _open_gates(params):
    """The port's tree with every gated cross layer's gate at GATE."""
    return {k: (_open_gates(v) if isinstance(v, dict)
                else torch.full_like(v, GATE) if k == "gate" else v)
            for k, v in params.items()}


def _port_grads(model, params, tokens, remat, mem=None):
    inputs = tree_map(lambda p: p.detach().requires_grad_(), params)
    mem = {k: torch.from_numpy(a).to(tokens.device) for k, a in (mem or {}).items()}
    loss, _ = model.loss_fn(inputs, {"tokens": tokens, **mem}, remat=remat)
    grads = iter(torch.autograd.grad(loss, tree_leaves(inputs)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


@pytest.fixture(scope="module", params=[(a, r) for a in ARCHS for r in (False, True)],
                ids=[f"{a}-remat{r}" for a in ARCHS for r in (False, True)])
def reference_grads(request):
    """(arch, remat, port model, port params, tokens, memory, ref loss, ref
    grads)."""
    arch, remat = request.param
    changes = {"dtype": "float32", **CHANGES.get(arch, {})}
    ref_model = RefModel(dataclasses.replace(ref_get_config(arch).reduced(), **changes))
    ref_params, _ = ref_model.init(jax.random.PRNGKey(1))
    ref_params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, GATE) if path[-1].key == "gate" else a, ref_params)
    model = Model(dataclasses.replace(get_config(arch).reduced(), **changes))
    toks, mem = _tokens(model.cfg), _memory(model.cfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(p, b, remat=remat), has_aux=True))(
            ref_params, {"tokens": jnp.asarray(toks), **tree_map(jnp.asarray, mem)})
    return (arch, remat, model, from_jax(ref_params, device="cpu"), torch.from_numpy(toks),
            mem, float(loss), jax.tree.map(np.asarray, grads))


def _check_grads(got_loss, got, want_loss, want):
    assert abs(float(got_loss) - want_loss) < TOL
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path in got:
        assert got[path] is not None and torch.isfinite(got[path]).all(), path
        _close(got[path], want[path])


def test_loss_grads_match_reference(reference_grads):
    _, remat, model, params, toks, mem, want_loss, want = reference_grads
    loss, grads = _port_grads(model, params, toks, remat, mem)
    _check_grads(loss, grads, want_loss, want)


def _plain_launches(monkeypatch):
    """Route CPU tensors through the kernels' autograd Functions, with each
    launch replaced by the plain version and counted: the card's code path
    minus the CUDA kernels."""
    counts = dict.fromkeys(("flash_attention", "ssd_scan", "rglru_scan"), 0)

    def counted(name, fn):
        def launch(*args):
            counts[name] += 1
            return fn(*args)
        return launch

    monkeypatch.setattr(fa, "_launch", counted("flash_attention", lambda q, k, v, c, w, s:
                                               ref.attention_ref(q, k, v, causal=c, window=w,
                                                                 scale=s)))
    monkeypatch.setattr(ss, "_launch", counted("ssd_scan", ref.ssd_chunked_ref))
    monkeypatch.setattr(rg, "_launch", counted("rglru_scan", ref.rglru_ref))
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, *, causal, window, scale:
                        fa._FlashAttention.apply(q, k, v, causal, window,
                                                 scale or 1.0 / math.sqrt(q.shape[3])))
    monkeypatch.setattr(ops, "ssd_scan", lambda x, dt, a, b, c, *, chunk:
                        ss._SSDScan.apply(x, dt, a, b, c, chunk))
    monkeypatch.setattr(ops, "rglru_scan", rg._RGLRUScan.apply)
    return counts


def test_loss_grads_through_kernel_functions_match_reference(reference_grads, monkeypatch):
    """The card's path (each kernel inside its autograd Function), on the CPU:
    under remat every launch happens twice, once in the forward and once in
    the recompute. The Whisper encoder is not recomputed (the reference's
    remat covers the decoder blocks only)."""
    arch, remat, model, params, toks, mem, want_loss, want = reference_grads
    counts = _plain_launches(monkeypatch)
    loss, grads = _port_grads(model, params, toks, remat, mem)
    _check_grads(loss, grads, want_loss, want)
    per_forward = {"qwen2.5-3b": {"flash_attention": 2},
                   "mamba2-130m": {"ssd_scan": 2},
                   "recurrentgemma-9b": {"rglru_scan": 1, "flash_attention": 1},
                   "deepseek-v2-236b": {"flash_attention": 2},
                   "kimi-k2-1t-a32b": {"flash_attention": 2},
                   "whisper-medium": {"flash_attention": 2},       # the decoder
                   "llama-3.2-vision-90b": {"flash_attention": 2}}[arch]
    once = {"whisper-medium": {"flash_attention": 2}}.get(arch, {})  # the encoder
    assert counts == {k: per_forward.get(k, 0) * (2 if remat else 1) + once.get(k, 0)
                      for k in counts}


def _reduced_qwen_pair():
    ref_model = RefModel(dataclasses.replace(ref_get_config("qwen2.5-3b").reduced(),
                                             dtype="float32"))
    model = Model(dataclasses.replace(get_config("qwen2.5-3b").reduced(), dtype="float32"))
    ref_params, _ = ref_model.init(jax.random.PRNGKey(1))
    return ref_model, ref_params, model, from_jax(ref_params, device="cpu")


def test_two_train_steps_match_reference():
    ref_model, ref_params, model, params = _reduced_qwen_pair()
    ref_opt = ref_adamw(ref_cosine(1e-3, 2, 10))
    opt = adamw(cosine_with_warmup(1e-3, 2, 10))
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_opt))
    step = make_train_step(model, opt)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for seed in (0, 1):
        toks = _tokens(model.cfg, seed)
        ref_params, ref_state, want = ref_step(ref_params, ref_state,
                                               {"tokens": jnp.asarray(toks)})
        params, state, got = step(params, state, {"tokens": torch.from_numpy(toks)})
        assert got.keys() == want.keys() == {"loss", "nll", "grad_norm", "lr"}
        for k in want:
            _close(got[k], want[k])
        assert int(state.step) == int(ref_state.step) == seed + 1
        for tree, ref_tree in ((params, ref_params), (state.mu, ref_state.mu),
                               (state.nu, ref_state.nu)):
            got_l, want_l = _leaves(tree), _leaves(jax.tree.map(np.asarray, ref_tree))
            assert got_l.keys() == want_l.keys()
            for path in got_l:
                _close(got_l[path], want_l[path])


def test_eval_step():
    _, _, model, params = _reduced_qwen_pair()
    batch = {"tokens": torch.from_numpy(_tokens(model.cfg))}
    m = make_eval_step(model)(params, batch)
    _, nll = model.loss_fn(params, batch, remat=False)
    assert float(m["nll"]) == float(nll)
    assert float(m["ppl"]) == pytest.approx(math.exp(float(nll)), rel=1e-6)


# ---------------------------------------------------------------------------
# the autograd Functions' mechanics, with each launch swapped for the plain
# version
# ---------------------------------------------------------------------------

def _inputs(kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g)
    if kind == "flash":
        # q as the model hands it over: a (B, H, S, D) view of (B, S, H, D)
        return (rn(2, 16, 4, 8).transpose(1, 2), rn(2, 2, 16, 8), rn(2, 2, 16, 8))
    if kind == "ssd":
        return (rn(2, 16, 4, 8), torch.nn.functional.softplus(rn(2, 16, 4)) * 0.1,
                -torch.exp(rn(4) * 0.5), rn(2, 16, 2, 8) * 0.3, rn(2, 16, 2, 8) * 0.3)
    return (torch.sigmoid(rn(2, 16, 8)), rn(2, 16, 8))


def _apply(kind, args):
    if kind == "flash":
        return fa._FlashAttention.apply(*args, True, 6, 0.3)
    if kind == "ssd":
        return ss._SSDScan.apply(*args, 8)
    return rg._RGLRUScan.apply(*args)


def _plain(kind, args):
    if kind == "flash":
        return ref.attention_ref(*args, causal=True, window=6, scale=0.3)
    if kind == "ssd":
        return ref.ssd_chunked_ref(*args, 8)
    return ref.rglru_ref(*args)


@pytest.mark.parametrize("kind", ["flash", "ssd", "rglru"])
def test_kernel_function_gradients_equal_plain_autograd(kind, monkeypatch):
    counts = _plain_launches(monkeypatch)
    args = [t.detach().requires_grad_() for t in _inputs(kind)]
    outs = _apply(kind, args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    plain = _plain(kind, args)
    plain = plain if isinstance(plain, tuple) else (plain,)
    g = torch.Generator().manual_seed(1)
    cotangents = [torch.randn(o.shape, generator=g) for o in outs]
    got = torch.autograd.grad(outs, args, cotangents)
    want = torch.autograd.grad(plain, args, cotangents)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the backward recomputes the plain version; only the forward launched
    assert sum(counts.values()) == 1


def test_ssd_function_without_final_state_gradient(monkeypatch):
    """A train forward drops the final state: the backward gets no gradient
    for it, and the inputs' gradients are those of y alone."""
    _plain_launches(monkeypatch)
    args = [t.detach().requires_grad_() for t in _inputs("ssd")]
    y, _ = ss._SSDScan.apply(*args, 8)
    got = torch.autograd.grad(y.square().sum(), args)
    y_plain, _ = ref.ssd_chunked_ref(*args, 8)
    want = torch.autograd.grad(y_plain.square().sum(), args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["flash", "ssd", "rglru"])
def test_kernel_function_saves_only_what_a_gradient_needs(kind, monkeypatch):
    _plain_launches(monkeypatch)
    saved = []

    def run(args, grad):
        saved.clear()
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            with torch.set_grad_enabled(grad):
                return _apply(kind, args)

    args = [t.detach().requires_grad_() for t in _inputs(kind)]
    run(args, grad=False)
    assert saved == []                  # serving and prefill keep nothing
    run([t.detach() for t in args], grad=True)
    assert saved == []                  # no input asks for a gradient
    run(args, grad=True)
    assert len(saved) == len(args)      # the inputs, for the recompute


# ---------------------------------------------------------------------------
# ports of tests/test_system.py (training and checkpoints), same thresholds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    opt = adamw(cosine_with_warmup(3e-3, 10, 80))
    params, opt_state, hist = train(model, opt, batches_for_model(cfg, dc), 80,
                                    log_every=40, remat=False, log_fn=lambda s: None,
                                    device="cpu")
    return cfg, model, params, opt_state, hist


def test_training_reduces_loss(trained):
    _, _, _, _, hist = trained
    assert [h["step"] for h in hist] == [1, 40, 80]
    assert hist[-1]["loss"] < hist[0]["loss"] - 1.0


def test_checkpoint_roundtrip_exact(trained, tmp_path):
    cfg, model, params, opt_state, _ = trained
    save_checkpoint(str(tmp_path), 5, params, opt_state)
    p2, o2, step = restore_checkpoint(str(tmp_path), (params, opt_state))
    assert step == 5
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(o2.step, opt_state.step)
    for a, b in zip(tree_leaves(opt_state.mu) + tree_leaves(opt_state.nu),
                    tree_leaves(o2.mu) + tree_leaves(o2.nu)):
        assert b.dtype == torch.float32 and torch.equal(a, b)


def test_launch_train_runs_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-130m",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("mamba2-130m-reduced:") and "on cpu" in lines[0]
    assert [ln.split()[:2] for ln in lines[1:]] == [["step", "1"], ["step", "2"]]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.json", "ckpt_00000002.npz"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_on_the_card_match_cpu(arch, remat):
    """Queue C item 1: through the Hopper kernels, every leaf gets a gradient
    and it agrees with the CPU's (plain path) within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                      **CHANGES.get(arch, {})))
    params, _ = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = _open_gates(params)
    toks, mem = torch.from_numpy(_tokens(model.cfg)), _memory(model.cfg)
    want_loss, want = _port_grads(model, params, toks, remat, mem)
    launches = {fn: fn.launches for fn in (fa.flash_attention, ss.ssd_scan, rg.rglru_scan)}
    got_loss, got = _port_grads(model, tree_map(lambda p: p.cuda(), params), toks.cuda(),
                                remat, mem)
    ran = [fn for fn, n in launches.items() if fn.launches > n]
    assert ran, "no kernel launched"
    assert abs(float(got_loss) - float(want_loss)) < TOL
    got, want = _leaves(got), _leaves(want)
    for path in want:
        torch.testing.assert_close(got[path].cpu(), want[path], rtol=TOL, atol=TOL)
