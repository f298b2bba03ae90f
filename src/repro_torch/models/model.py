"""The unified model: the dense, MoE (with MLA: deepseek-v2), SSM (mamba2)
and hybrid (recurrentgemma) families.

One ``Model`` object per ``ModelConfig`` exposes, as the reference does:

  init(generator, device)            -> (params, specs)
  forward(params, batch, mode, remat) -> (logits, aux_loss, cache_or_None)
  loss_fn(params, batch, remat)      -> (loss, nll)
  init_cache(batch, cache_len, device) -> (cache, cache_specs)
  decode_step(params, token, cache)  -> (logits, cache)

Parameters keep the reference's tree, with the layers stacked on a leading
axis under ``"blocks"`` (the MoE family's leading dense layers under
``"dense_blocks"``; the hybrid family: repeating super-blocks under
``"super"`` and the leftover layers as ``"tail{t}"``); the reference's
``lax.scan`` over layers is a Python loop over layer slices, and the port
runs eagerly. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``), the reference's ``remat_policy = "full"``.
Entry points run on the card unless the caller names another device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.utils.params import ParamBuilder, count_params, layer_slices, stack_layers

#: the families still missing here, with the ROADMAP item that ports them
_UNPORTED = ("audio", "vlm")
_UNPORTED_ITEM = "ROADMAP Queue A item 14 (audio and VLM families)"


def _init_dense_block(b: ParamBuilder, cfg: ModelConfig, use_moe: bool):
    L.init_norm(b, "ln1", cfg.d_model, cfg.norm)
    if cfg.use_mla:
        MLA.init_mla(b, "attn", cfg)
    else:
        L.init_attention(b, "attn", cfg)
    L.init_norm(b, "ln2", cfg.d_model, cfg.norm)
    if use_moe:
        MOE.init_moe(b, "ffn", cfg)
    else:
        L.init_mlp(b, "ffn", cfg)


def _init_ssm_block(b: ParamBuilder, cfg: ModelConfig):
    L.init_norm(b, "ln", cfg.d_model, cfg.norm)
    SSM.init_ssm(b, "mixer", cfg)


def _init_hybrid_block(b: ParamBuilder, cfg: ModelConfig, kind: str):
    L.init_norm(b, "ln1", cfg.d_model, cfg.norm)
    if kind == "rec":
        RG.init_rglru(b, "mixer", cfg)
    else:
        L.init_attention(b, "attn", cfg)
    L.init_norm(b, "ln2", cfg.d_model, cfg.norm)
    L.init_mlp(b, "ffn", cfg)


def _stack_init(generator, n: int, fn, dtype, device):
    """Build ``n`` identical blocks and stack along a leading layer axis."""
    outs = []
    for _ in range(n):
        b = ParamBuilder(generator, dtype=dtype, device=device)
        fn(b)
        outs.append(b.build())
    return stack_layers(outs)


def _stack_states(states: list):
    """Stack per-layer states (tensors, or dicts / tuples of them) along a new
    leading layer axis, as the reference's ``lax.scan`` stacks its outputs."""
    s0 = states[0]
    if isinstance(s0, dict):
        return {k: _stack_states([s[k] for s in states]) for k in s0}
    if isinstance(s0, tuple):
        return tuple(_stack_states(list(z)) for z in zip(*states))
    return torch.stack(states)


class Model:
    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        if cfg.family in _UNPORTED:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; see {_UNPORTED_ITEM}")
        self.cfg = cfg

    # -- structure helpers --------------------------------------------------

    @property
    def _pattern(self) -> Tuple[str, ...]:
        return self.cfg.block_pattern or ()

    @property
    def _n_super(self) -> int:
        if self.cfg.family == "hybrid":
            return self.cfg.num_layers // len(self._pattern)
        return 0

    @property
    def _n_tail(self) -> int:
        if self.cfg.family == "hybrid":
            return self.cfg.num_layers % len(self._pattern)
        return 0

    def _tail_kind(self, t: int) -> str:
        return self._pattern[t % len(self._pattern)]

    @property
    def _n_dense_first(self) -> int:
        """The MoE family's leading dense layers (``"dense_blocks"``)."""
        return self.cfg.first_dense_layers if self.cfg.family == "moe" else 0

    # -- init ---------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None, *, device="cuda"):
        """Random parameters drawn from ``generator`` (seeded 0 when None) on
        ``device``; ``device="meta"`` gives shapes and dtypes only."""
        cfg = self.cfg
        device = torch.device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        dtype = cfg.torch_dtype
        b = ParamBuilder(generator, dtype=dtype, device=device)
        L.init_embed(b, cfg)
        L.init_norm(b, "final_norm", cfg.d_model, cfg.norm)
        params, specs = b.build()
        if cfg.family in ("dense", "moe"):
            fd = self._n_dense_first
            if fd:
                params["dense_blocks"], specs["dense_blocks"] = _stack_init(
                    generator, fd, lambda bb: _init_dense_block(bb, cfg, use_moe=False),
                    dtype, device)
            params["blocks"], specs["blocks"] = _stack_init(
                generator, cfg.num_layers - fd,
                lambda bb: _init_dense_block(bb, cfg, use_moe=cfg.family == "moe"),
                dtype, device)
        elif cfg.family == "ssm":
            params["blocks"], specs["blocks"] = _stack_init(
                generator, cfg.num_layers, lambda bb: _init_ssm_block(bb, cfg), dtype, device)
        else:
            def init_super(bb: ParamBuilder):
                for j, kind in enumerate(self._pattern):
                    _init_hybrid_block(bb.sub(f"b{j}_{kind}"), cfg, kind)
            params["super"], specs["super"] = _stack_init(
                generator, self._n_super, init_super, dtype, device)
            for t in range(self._n_tail):
                tb = ParamBuilder(generator, dtype=dtype, device=device)
                _init_hybrid_block(tb, cfg, self._tail_kind(t))
                params[f"tail{t}"], specs[f"tail{t}"] = tb.build()
        return params, specs

    # -- block applications (full sequence) ---------------------------------

    def _dense_block(self, p, x, positions, *, window, use_moe, collect_kv=False):
        """One block of the dense and MoE families; returns (x, aux, kv), kv
        being (k, v) or, under MLA, (c_kv, k_rope). MLA takes no window."""
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        if cfg.use_mla:
            attn_out, kv = MLA.apply_mla(p["attn"], h, cfg, positions)
        else:
            attn_out, kv = L.apply_attention(p["attn"], h, cfg, positions, causal=True,
                                             window=window)
        x = x + attn_out
        h = L.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        if use_moe:
            ffn_out, aux = MOE.apply_moe(p["ffn"], h, cfg)
        else:
            ffn_out = L.apply_mlp(p["ffn"], h, cfg)
            aux = torch.zeros((1,), dtype=torch.float32, device=x.device)
        return x + ffn_out, aux, (kv if collect_kv else None)

    def _hybrid_block(self, p, kind: str, x, positions, *, collect: bool):
        """One rec or attn block of the hybrid family; returns (x, state), the
        state being the RG-LRU's {"conv", "h"} or the window-clipped (k, v)."""
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        if kind == "rec":
            out, st = RG.apply_rglru(p["mixer"], h, cfg)
        else:
            out, kv = L.apply_attention(p["attn"], h, cfg, positions, causal=True,
                                        window=cfg.local_window)
            st = self._clip_window_kv(kv, x.shape[1]) if collect else None
        x = x + out
        h = L.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        return x + L.apply_mlp(p["ffn"], h, cfg), (st if collect else None)

    def _clip_window_kv(self, kv, S: int):
        """Keep only the trailing window of prefill K/V for the local cache."""
        w = self.cfg.local_window
        k, v = kv
        if S < w:
            pad = (0, 0, 0, w - S)   # zeros after the S positions, as jnp.pad
            k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        elif S > w:
            k, v = k[:, :, -w:, :], v[:, :, -w:, :]
        return (k, v)

    def _window(self, shape_kind: str) -> int:
        """Attention window for a given execution (0 = full)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return cfg.local_window
        if shape_kind == "long" and cfg.long_context == "sliding":
            return cfg.window
        return 0

    # -- training / prefill forward -----------------------------------------

    def _ssm_block(self, p, x):
        cfg = self.cfg
        h = L.apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
        out, st = SSM.apply_ssm(p["mixer"], h, cfg)
        return x + out, st

    def forward(self, params, batch: Dict[str, torch.Tensor], *, mode: str = "train",
                window: int = 0, remat: bool = False):
        """Full-sequence forward.

        batch: {"tokens": (B, S) int}
        Returns (logits (B, S, V), aux_loss scalar, cache_or_None).
        mode: "train" (logits over all positions) or "prefill" (last-position
        logits and the reference's prefill cache: the dense and MoE families'
        stacked (L, B, Hkv, S, hd) K/V under "kv", or under MLA the stacked
        (c_kv (L, B, S, kv_lora), k_rope (L, B, S, rope)), with the MoE
        family's leading dense layers under "dense_kv"; the SSM family's
        stacked {"conv", "ssm"} states, the hybrid family's per-super-block
        states under "super" and each tail's under "tail{t}").
        remat: recompute each block in the backward instead of keeping its
        activations (every kernel then launches twice per training step).
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = L.embed_tokens(params, tokens, cfg)
        positions = torch.arange(S, device=tokens.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        collect = mode == "prefill"
        caches: Dict[str, Any] = {}

        def block(fn, *args, **kwargs):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False, **kwargs)
            return fn(*args, **kwargs)

        if cfg.family in ("dense", "moe"):
            stacks = [("dense_kv", "dense_blocks", False)] if self._n_dense_first else []
            stacks.append(("kv", "blocks", cfg.family == "moe"))
            for cache_name, stack, use_moe in stacks:
                kvs = []
                for p in layer_slices(params[stack]):
                    x, a, kv = block(self._dense_block, p, x, positions, window=window,
                                     use_moe=use_moe, collect_kv=collect)
                    aux_total = aux_total + a.mean()
                    kvs.append(kv)
                if collect:
                    caches[cache_name] = _stack_states(kvs)
        elif cfg.family == "ssm":
            states = []
            for p in layer_slices(params["blocks"]):
                x, st = block(self._ssm_block, p, x)
                states.append(st)
            if collect:
                caches["ssm_states"] = _stack_states(states)
        else:
            sup_states = []
            for p in layer_slices(params["super"]):
                st_out = {}
                for j, kind in enumerate(self._pattern):
                    x, st_out[f"b{j}"] = block(self._hybrid_block, p[f"b{j}_{kind}"], kind, x,
                                               positions, collect=collect)
                sup_states.append(st_out)
            if collect:
                caches["super"] = _stack_states(sup_states)
            for t in range(self._n_tail):
                x, st = block(self._hybrid_block, params[f"tail{t}"], self._tail_kind(t), x,
                              positions, collect=collect)
                if collect:
                    caches[f"tail{t}"] = st

        x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        if mode == "prefill":
            logits = L.unembed(params, x[:, -1:, :], cfg)
            return logits[:, 0, :], aux_total, caches
        logits = L.unembed(params, x, cfg)
        return logits, aux_total, None

    # -- loss ---------------------------------------------------------------

    def loss_fn(self, params, batch, *, remat: bool = True):
        """Next-token cross entropy over ``batch["tokens"]`` (B, S + 1), plus
        ``router_aux_weight`` times the MoE load-balance loss (zero in the
        other families). Returns (loss, nll)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        logits, aux, _ = self.forward(params, {**batch, "tokens": tokens[:, :-1]},
                                      mode="train", remat=remat)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tokens[:, 1:, None].long())[..., 0]
        nll = (logz - gold).mean()
        return nll + cfg.router_aux_weight * aux, nll

    # -- decode -------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, *, device="cuda"):
        """Build an empty decode cache (+ its logical-axes spec tree)."""
        cfg = self.cfg
        dt = cfg.torch_dtype
        hd = cfg.head_dim_ if cfg.num_heads else 0
        n = cfg.num_layers
        entries: Dict[str, Any] = {}
        specs: Dict[str, Any] = {}

        def put(name, shape, axes, dtype=dt):
            entries[name] = torch.zeros(shape, dtype=dtype, device=device)
            specs[name] = axes

        kvs = ("layers", "batch", "kv_heads", "kv_seq", None)
        if cfg.family in ("dense", "moe"):
            fd = self._n_dense_first
            # the MoE family's leading dense layers keep theirs under "d_*"
            stacks = [("", n - fd)] + ([("d_", fd)] if fd else [])
            if cfg.use_mla:
                lat = ("layers", "batch", "kv_seq", None)
                for pre, m in stacks:
                    put(pre + "ckv", (m, batch, cache_len, cfg.kv_lora_rank), lat)
                    put(pre + "krope", (m, batch, cache_len, cfg.qk_rope_head_dim), lat)
            else:
                q8 = cfg.kv_cache_dtype == "int8"
                kvdt = torch.int8 if q8 else dt
                scs = ("layers", "batch", "kv_heads", "kv_seq")
                for pre, m in stacks:
                    put(pre + "k", (m, batch, cfg.num_kv_heads, cache_len, hd), kvs, kvdt)
                    put(pre + "v", (m, batch, cfg.num_kv_heads, cache_len, hd), kvs, kvdt)
                    if q8:
                        put(pre + "k_scale", (m, batch, cfg.num_kv_heads, cache_len), scs,
                            torch.float32)
                        put(pre + "v_scale", (m, batch, cfg.num_kv_heads, cache_len), scs,
                            torch.float32)
        elif cfg.family == "ssm":
            di, H, _, d_bc = SSM.ssm_dims(cfg)
            put("conv", (n, batch, cfg.ssm_conv - 1, di + 2 * d_bc),
                ("layers", "batch", None, "ff"))
            put("ssm", (n, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                ("layers", "batch", "heads", None, None), torch.float32)
        else:
            # the local-attention caches are ring buffers of the window's size,
            # whatever cache_len asks, as in the reference
            W, win, ns = RG.lru_width(cfg), cfg.local_window, self._n_super
            for j, kind in enumerate(self._pattern):
                if kind == "rec":
                    put(f"s{j}_conv", (ns, batch, RG._CONV_K - 1, W),
                        ("layers", "batch", None, "ff"))
                    put(f"s{j}_h", (ns, batch, W), ("layers", "batch", "ff"), torch.float32)
                else:
                    put(f"s{j}_k", (ns, batch, cfg.num_kv_heads, win, hd), kvs)
                    put(f"s{j}_v", (ns, batch, cfg.num_kv_heads, win, hd), kvs)
            for t in range(self._n_tail):
                if self._tail_kind(t) == "rec":
                    put(f"t{t}_conv", (batch, RG._CONV_K - 1, W), ("batch", None, "ff"))
                    put(f"t{t}_h", (batch, W), ("batch", "ff"), torch.float32)
                else:
                    put(f"t{t}_k", (batch, cfg.num_kv_heads, win, hd), kvs[1:])
                    put(f"t{t}_v", (batch, cfg.num_kv_heads, win, hd), kvs[1:])
        put("pos", (), (), torch.int32)
        return entries, specs

    def decode_step(self, params, token: torch.Tensor, cache: Dict[str, Any],
                    *, window: int = 0):
        """token: (B,) int. Returns (logits (B, V), new_cache)."""
        cfg = self.cfg
        x = L.embed_tokens(params, token[:, None], cfg)
        pos = cache["pos"]
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        if cfg.family == "ssm":
            x = self._ssm_decode(params, x, cache, new_cache)
        elif cfg.family == "hybrid":
            x = self._hybrid_decode(params, x, cache, new_cache, pos)
        else:
            x = self._dense_decode(params, x, cache, new_cache, pos, window)
        x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        logits = L.unembed(params, x, cfg)
        return logits[:, 0, :], new_cache

    def _dense_decode(self, params, x, cache, new_cache, pos, window):
        """The dense and MoE families: the leading dense layers against the
        "d_*" entries, then the blocks (MoE at T = B in that family)."""
        cfg = self.cfg
        q8 = not cfg.use_mla and cfg.kv_cache_dtype == "int8"
        if cfg.use_mla:
            kv_names = ("ckv", "krope")
        elif q8:
            kv_names = ("k", "v", "k_scale", "v_scale")
        else:
            kv_names = ("k", "v")
        stacks = [("d_", "dense_blocks", False)] if self._n_dense_first else []
        stacks.append(("", "blocks", cfg.family == "moe"))
        for pre, stack, use_moe in stacks:
            outs = [[] for _ in kv_names]
            for i, p in enumerate(layer_slices(params[stack])):
                c = [cache[pre + n][i] for n in kv_names]
                h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
                if cfg.use_mla:
                    out, nckv, nkr = MLA.apply_mla_decode(p["attn"], h, cfg, c[0], c[1], pos)
                    nc = (nckv, nkr)
                elif q8:
                    out, nk, nv, (nks, nvs) = L.apply_attention_decode(
                        p["attn"], h, cfg, c[0], c[1], pos, window=window,
                        cache_scales=(c[2], c[3]))
                    nc = (nk, nv, nks, nvs)
                else:
                    out, nk, nv = L.apply_attention_decode(p["attn"], h, cfg, c[0], c[1], pos,
                                                           window=window)
                    nc = (nk, nv)
                x = x + out
                h = L.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
                if use_moe:
                    f, _ = MOE.apply_moe(p["ffn"], h, cfg)
                else:
                    f = L.apply_mlp(p["ffn"], h, cfg)
                x = x + f
                for acc, arr in zip(outs, nc):
                    acc.append(arr)
            for nm, arrs in zip(kv_names, outs):
                new_cache[pre + nm] = torch.stack(arrs)
        return x

    def _ssm_decode(self, params, x, cache, new_cache):
        cfg = self.cfg
        convs, ssms = [], []
        for i, p in enumerate(layer_slices(params["blocks"])):
            h = L.apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
            out, st = SSM.apply_ssm_decode(p["mixer"], h, cfg,
                                           {"conv": cache["conv"][i], "ssm": cache["ssm"][i]})
            x = x + out
            convs.append(st["conv"])
            ssms.append(st["ssm"])
        new_cache["conv"], new_cache["ssm"] = torch.stack(convs), torch.stack(ssms)
        return x

    def _hybrid_decode_block(self, p, kind, x, c, pos):
        """One decode step of a rec or attn block; ``c`` holds the block's
        cache entries under the suffixes conv/h or k/v, and the new ones are
        returned the same way."""
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        if kind == "rec":
            out, nc = RG.apply_rglru_decode(p["mixer"], h, cfg, c)
        else:
            out, nk, nv = L.apply_attention_decode(p["attn"], h, cfg, c["k"], c["v"], pos,
                                                   window=cfg.local_window)
            nc = {"k": nk, "v": nv}
        x = x + out
        h = L.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        return x + L.apply_mlp(p["ffn"], h, cfg), nc

    def _hybrid_decode(self, params, x, cache, new_cache, pos):
        suffixes = {"rec": ("conv", "h"), "attn": ("k", "v")}
        outs: Dict[str, list] = {}
        for i, p in enumerate(layer_slices(params["super"])):
            for j, kind in enumerate(self._pattern):
                c = {sfx: cache[f"s{j}_{sfx}"][i] for sfx in suffixes[kind]}
                x, nc = self._hybrid_decode_block(p[f"b{j}_{kind}"], kind, x, c, pos)
                for sfx, arr in nc.items():
                    outs.setdefault(f"s{j}_{sfx}", []).append(arr)
        for name, arrs in outs.items():
            new_cache[name] = torch.stack(arrs)
        for t in range(self._n_tail):
            kind = self._tail_kind(t)
            c = {sfx: cache[f"t{t}_{sfx}"] for sfx in suffixes[kind]}
            x, nc = self._hybrid_decode_block(params[f"tail{t}"], kind, x, c, pos)
            for sfx, arr in nc.items():
                new_cache[f"t{t}_{sfx}"] = arr
        return x

    def param_count(self, params=None) -> int:
        if params is None:
            params, _ = self.init(device="meta")
        return count_params(params)
