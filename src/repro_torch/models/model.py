"""The dense decoder family of the unified model.

One ``Model`` object per ``ModelConfig`` exposes, as the reference does:

  init(generator, device)            -> (params, specs)
  forward(params, batch, mode)       -> (logits, aux_loss, cache_or_None)
  loss_fn(params, batch)             -> (loss, nll)
  init_cache(batch, cache_len, device) -> (cache, cache_specs)
  decode_step(params, token, cache)  -> (logits, cache)

Parameters keep the reference's tree, with the layers stacked on a leading
axis under ``"blocks"``; the reference's ``lax.scan`` over layers is a Python
loop over layer slices, and the port runs eagerly. Entry points run on the
card unless the caller names another device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils.params import ParamBuilder, count_params, layer_slice, stack_layers

#: the ROADMAP item that ports each family still missing here
_FAMILY_ITEMS = {
    "moe": "ROADMAP Queue A item 13 (MoE on one device)",
    "ssm": "ROADMAP Queue A item 10 (SSM family)",
    "hybrid": "ROADMAP Queue A item 11 (hybrid family)",
    "audio": "ROADMAP Queue A item 14 (audio and VLM families)",
    "vlm": "ROADMAP Queue A item 14 (audio and VLM families)",
}


def _init_dense_block(b: ParamBuilder, cfg: ModelConfig):
    L.init_norm(b, "ln1", cfg.d_model, cfg.norm)
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


class Model:
    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        if cfg.family != "dense" or cfg.use_mla:
            item = _FAMILY_ITEMS.get(cfg.family, "ROADMAP Queue A item 12 (MLA)")
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; see {item}")
        self.cfg = cfg

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
        params["blocks"], specs["blocks"] = _stack_init(
            generator, cfg.num_layers, lambda bb: _init_dense_block(bb, cfg), dtype, device)
        return params, specs

    # -- block applications (full sequence) ---------------------------------

    def _dense_block(self, p, x, positions, *, window, collect_kv=False):
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        attn_out, kv = L.apply_attention(p["attn"], h, cfg, positions, causal=True,
                                         window=window)
        x = x + attn_out
        h = L.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + L.apply_mlp(p["ffn"], h, cfg)
        return x, (kv if collect_kv else None)

    def _window(self, shape_kind: str) -> int:
        """Attention window for a given execution (0 = full)."""
        cfg = self.cfg
        if shape_kind == "long" and cfg.long_context == "sliding":
            return cfg.window
        return 0

    # -- training / prefill forward -----------------------------------------

    def forward(self, params, batch: Dict[str, torch.Tensor], *, mode: str = "train",
                window: int = 0):
        """Full-sequence forward.

        batch: {"tokens": (B, S) int}
        Returns (logits (B, S, V), aux_loss scalar, cache_or_None).
        mode: "train" (logits over all positions) or "prefill" (last-position
        logits and the stacked (L, B, Hkv, S, hd) K/V cache).
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = L.embed_tokens(params, tokens, cfg)
        positions = torch.arange(S, device=tokens.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        collect = mode == "prefill"
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, kv = self._dense_block(layer_slice(params["blocks"], i), x, positions,
                                      window=window, collect_kv=collect)
            if collect:
                ks.append(kv[0])
                vs.append(kv[1])

        x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        if mode == "prefill":
            logits = L.unembed(params, x[:, -1:, :], cfg)
            return logits[:, 0, :], aux_total, {"kv": (torch.stack(ks), torch.stack(vs))}
        logits = L.unembed(params, x, cfg)
        return logits, aux_total, None

    # -- loss ---------------------------------------------------------------

    def loss_fn(self, params, batch):
        """Next-token cross entropy over ``batch["tokens"]`` (B, S + 1).
        Returns (loss, nll); the dense family has no auxiliary loss."""
        cfg = self.cfg
        tokens = batch["tokens"]
        logits, aux, _ = self.forward(params, {**batch, "tokens": tokens[:, :-1]},
                                      mode="train")
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
        hd = cfg.head_dim_
        n = cfg.num_layers
        entries: Dict[str, Any] = {}
        specs: Dict[str, Any] = {}

        def put(name, shape, axes, dtype=dt):
            entries[name] = torch.zeros(shape, dtype=dtype, device=device)
            specs[name] = axes

        kvs = ("layers", "batch", "kv_heads", "kv_seq", None)
        q8 = cfg.kv_cache_dtype == "int8"
        kvdt = torch.int8 if q8 else dt
        put("k", (n, batch, cfg.num_kv_heads, cache_len, hd), kvs, kvdt)
        put("v", (n, batch, cfg.num_kv_heads, cache_len, hd), kvs, kvdt)
        if q8:
            scs = ("layers", "batch", "kv_heads", "kv_seq")
            put("k_scale", (n, batch, cfg.num_kv_heads, cache_len), scs, torch.float32)
            put("v_scale", (n, batch, cfg.num_kv_heads, cache_len), scs, torch.float32)
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
        q8 = cfg.kv_cache_dtype == "int8"
        kv_names = ("k", "v", "k_scale", "v_scale") if q8 else ("k", "v")
        outs = [[] for _ in kv_names]
        for i in range(cfg.num_layers):
            p = layer_slice(params["blocks"], i)
            c = [cache[n][i] for n in kv_names]
            h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
            if q8:
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
            x = x + L.apply_mlp(p["ffn"], h, cfg)
            for acc, arr in zip(outs, nc):
                acc.append(arr)
        for nm, arrs in zip(kv_names, outs):
            new_cache[nm] = torch.stack(arrs)

        x = L.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        logits = L.unembed(params, x, cfg)
        return logits[:, 0, :], new_cache

    def param_count(self, params=None) -> int:
        if params is None:
            params, _ = self.init(device="meta")
        return count_params(params)
