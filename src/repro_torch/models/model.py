"""The unified model: the dense, MoE (with MLA: deepseek-v2), SSM (mamba2),
hybrid (recurrentgemma), audio (whisper: encoder-decoder) and VLM
(llama-3.2-vision: gated cross-attention layers) families.

One ``Model`` object per ``ModelConfig`` exposes, as the reference does:

  init(generator, device)            -> (params, specs)
  forward(params, batch, mode, remat) -> (logits, aux_loss, cache_or_None)
  loss_fn(params, batch, remat)      -> (loss, nll)
  init_cache(batch, cache_len, device, memory_len) -> (cache, cache_specs)
  fill_cross_cache(params, cache, memory) -> cache   (audio and VLM)
  decode_step(params, token, cache)  -> (logits, cache)
  input_specs(shape_name)            -> the step's inputs as meta tensors

Parameters keep the reference's tree, with the layers stacked on a leading
axis under ``"blocks"`` (the MoE family's leading dense layers under
``"dense_blocks"``; the audio family's encoder under ``"enc_blocks"``; the
hybrid and VLM families: repeating super-blocks under ``"super"``, and the
hybrid's leftover layers as ``"tail{t}"``); the reference's ``lax.scan``
over layers is a Python loop over layer slices, and the port runs
eagerly. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``) under ``remat_policy`` (see ``Model``).
Entry points run on the card unless the caller names another device.
``moe_impl`` and ``block_impl`` choose, as in the reference, the MoE's
expert parallelism and the dense blocks' Megatron-SP form
(``models/smblock.py``) under logical rules on a mesh (``utils/sharding.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import smblock as SMB
from repro_torch.models import ssm as SSM
from repro_torch.utils.params import (ParamBuilder, abstract_stack, count_params, layer_slices,
                                      stack_layers)
from repro_torch.utils.sharding import current_rules, mesh_shape, shard

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


def _init_cross_block(b: ParamBuilder, cfg: ModelConfig, gated: bool):
    L.init_norm(b, "ln1", cfg.d_model, cfg.norm)
    L.init_cross_attention(b, "xattn", cfg, gated=gated)
    L.init_norm(b, "ln2", cfg.d_model, cfg.norm)
    L.init_mlp(b, "ffn", cfg)


def _init_audio_dec_block(b: ParamBuilder, cfg: ModelConfig):
    L.init_norm(b, "ln1", cfg.d_model, cfg.norm)
    L.init_attention(b, "attn", cfg)
    L.init_norm(b, "lnx", cfg.d_model, cfg.norm)
    L.init_cross_attention(b, "xattn", cfg, gated=False)
    L.init_norm(b, "ln2", cfg.d_model, cfg.norm)
    L.init_mlp(b, "ffn", cfg)


def _sinusoid(length: int, dim: int, device=None) -> torch.Tensor:
    """The Whisper encoder's fixed positions: sin on even, cos on odd columns."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _stack_init(generator, n: int, fn, dtype, device):
    """Build ``n`` identical blocks and stack along a leading layer axis (on
    the meta device, one block's shapes with the layer axis added)."""
    if device.type == "meta":
        b = ParamBuilder(None, dtype=dtype, device=device)
        fn(b)
        return abstract_stack(*b.build(), n)
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


#: the output projections of a block's sublayers: what ``remat_policy =
#: "outputs"`` keeps (the reference's ``blk_out``)
_BLOCK_OUT_WEIGHTS = (("attn", "w_o"), ("ffn", "w_out"), ("ffn", "w_shared_out"))


def _storage_key(t):
    """The storage a tensor (or a DTensor's local shard) reads."""
    return getattr(t, "_local_tensor", t).untyped_storage()._cdata


def _save_block_outputs(p):
    """A ``torch.utils.checkpoint`` context for one block that saves the ops
    reading the block's output projections (``_BLOCK_OUT_WEIGHTS`` of ``p``;
    a layer slice shares its stack's storage) and recomputes the rest."""
    keys = {_storage_key(p[a][w]) for a, w in _BLOCK_OUT_WEIGHTS if a in p and w in p[a]}

    def policy(ctx, op, *args, **kwargs):
        if any(isinstance(a, torch.Tensor) and _storage_key(a) in keys for a in args):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


class Model:
    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        self.cfg = cfg
        # remat policy under ``remat``: "full" recomputes each block whole in
        # the backward; "outputs" keeps each block's attention and FFN
        # outputs (the reference's ``blk_out``): a selective checkpoint
        # (``create_selective_checkpoint_contexts``) saves the results of the
        # ops that read the block's output projections (w_o, w_out, and the
        # MoE's w_shared_out; the routed experts' w_out off the mesh) and
        # recomputes everything else, so the backward skips the attention
        # projection's forward (and, on a mesh, its all-reduce). The FFN's
        # w_out product is recomputed under neither policy: torch's
        # checkpoint stops recomputing before a block's last product.
        self.remat_policy = "full"
        # MoE execution: "auto" = expert-parallel over the rules' expert axes
        # (every expert local off the mesh); "2d" = weight-resident 2D expert
        # parallelism (decode regime)
        self.moe_impl = "auto"
        # dense block execution: "gspmd" (the plain block) or "shardmap"
        # (explicit Megatron-SP collectives over the rules' mesh; train path)
        self.block_impl = "gspmd"

    # -- structure helpers --------------------------------------------------

    @property
    def _pattern(self) -> Tuple[str, ...]:
        return self.cfg.block_pattern or ()

    @property
    def _n_super(self) -> int:
        cfg = self.cfg
        if cfg.family == "hybrid":
            return cfg.num_layers // len(self._pattern)
        if cfg.family == "vlm":
            return cfg.num_layers // cfg.cross_attn_every
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
        elif cfg.family == "audio":
            # an encoder block is a dense block (ln1, attn, ln2, ffn)
            params["enc_blocks"], specs["enc_blocks"] = _stack_init(
                generator, cfg.encoder_layers,
                lambda bb: _init_dense_block(bb, cfg, use_moe=False), dtype, device)
            eb = ParamBuilder(generator, dtype=dtype, device=device)
            L.init_norm(eb, "enc_final_norm", cfg.d_model, cfg.norm)
            eb.param("dec_pos", (cfg.max_positions, cfg.d_model), (None, None),
                     init="embedding")
            p2, s2 = eb.build()
            params.update(p2)
            specs.update(s2)
            params["blocks"], specs["blocks"] = _stack_init(
                generator, cfg.num_layers, lambda bb: _init_audio_dec_block(bb, cfg),
                dtype, device)
        elif cfg.family == "vlm":
            def init_vlm_super(bb: ParamBuilder):
                for j in range(cfg.cross_attn_every - 1):
                    _init_dense_block(bb.sub(f"self{j}"), cfg, use_moe=False)
                _init_cross_block(bb.sub("cross"), cfg, gated=True)
            params["super"], specs["super"] = _stack_init(
                generator, self._n_super, init_vlm_super, dtype, device)
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
        # under sequence-parallel rules this asks for a reduce-scatter at the
        # out-projection instead of all-reduce + re-shard (no-op otherwise)
        x, h = L.add_norm(p["ln2"], x, shard(attn_out, "batch", "seq", None), cfg.norm,
                          cfg.norm_eps)
        if use_moe:
            ffn_out, aux = MOE.apply_moe(p["ffn"], h, cfg, impl=self.moe_impl)
        else:
            ffn_out = L.apply_mlp(p["ffn"], h, cfg)
            aux = torch.zeros((1,), dtype=torch.float32, device=x.device)
        x = x + shard(ffn_out, "batch", "seq", None)
        return shard(x, "batch", "seq", None), aux, (kv if collect_kv else None)

    def _shardmap_mesh(self, S: int, *, use_moe: bool, collect: bool):
        """The mesh to run a dense block on with ``smblock``, or None for the
        plain block: under ``block_impl == "shardmap"``, for a non-MoE,
        non-MLA block outside prefill whose sequence and heads divide the
        model axis (the reference's condition; it needs active rules)."""
        cfg = self.cfg
        if self.block_impl != "shardmap" or use_moe or cfg.use_mla or collect:
            return None
        rules = current_rules()
        assert rules is not None, "shardmap blocks need a mesh"
        msize = mesh_shape(rules.mesh).get("model", 1)
        if S % msize == 0 and cfg.num_heads % msize == 0:
            return rules.mesh
        return None

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
        x, h = L.add_norm(p["ln2"], x, out, cfg.norm, cfg.norm_eps)
        return x + L.apply_mlp(p["ffn"], h, cfg), (st if collect else None)

    def _audio_block(self, p, x, positions, memory, *, collect: bool):
        """One Whisper decoder block: causal self attention, cross attention
        to the encoder's output, MLP; returns (x, ((k, v), (xk, xv)) or None)."""
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        out, kv = L.apply_attention(p["attn"], h, cfg, positions, causal=True)
        xk, xv = L.cross_kv(p["xattn"], memory, cfg)
        x = self._cross_and_ffn(p, "lnx", x + out, xk, xv)
        return shard(x, "batch", "seq", None), ((kv, (xk, xv)) if collect else None)

    def _vlm_super(self, p, x, positions, images, *, window, collect: bool):
        """One VLM super-block: ``cross_attn_every - 1`` dense self-attention
        blocks, then the gated cross block over the image tokens; returns
        (x, {"self{j}": (k, v), "cross": (xk, xv)} or None)."""
        cfg = self.cfg
        kvs = {}
        for j in range(cfg.cross_attn_every - 1):
            x, _, kvs[f"self{j}"] = self._dense_block(p[f"self{j}"], x, positions,
                                                      window=window, use_moe=False,
                                                      collect_kv=collect)
        kvs["cross"] = L.cross_kv(p["cross"]["xattn"], images, cfg)
        x = self._cross_and_ffn(p["cross"], "ln1", x, *kvs["cross"])
        return shard(x, "batch", "seq", None), (kvs if collect else None)

    def _cross_and_ffn(self, p, norm: str, x, xk, xv):
        """The cross-attention residual against memory K/V (its norm named
        ``norm``: the Whisper decoder's "lnx", the VLM cross block's "ln1"),
        then the MLP residual."""
        cfg = self.cfg
        h = L.apply_norm(p[norm], x, cfg.norm, cfg.norm_eps)
        x, h = L.add_norm(p["ln2"], x, L.apply_cross_attention(p["xattn"], h, xk, xv, cfg),
                          cfg.norm, cfg.norm_eps)
        return x + L.apply_mlp(p["ffn"], h, cfg)

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper encoder over precomputed frame embeddings (B, F, D):
        non-causal flash attention in every layer. Not recomputed under
        remat, as in the reference."""
        cfg = self.cfg
        _, F, D = frames.shape
        dt = cfg.torch_dtype
        x = frames.to(dt) + _sinusoid(F, D, frames.device).to(dt)
        x = shard(x, "batch", "seq", None)
        positions = torch.arange(F, device=frames.device)
        for p in layer_slices(params["enc_blocks"]):
            h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
            out, _ = L.apply_attention(p["attn"], h, cfg, positions, causal=False)
            x = x + out
            h = L.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
            x = shard(x + L.apply_mlp(p["ffn"], h, cfg), "batch", "seq", None)
        return L.apply_norm(params["enc_final_norm"], x, cfg.norm, cfg.norm_eps)

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

        batch: {"tokens": (B, S) int [, "frames": (B, F, D) (audio),
        "images": (B, I, D) (VLM)]}
        Returns (logits (B, S, V), aux_loss scalar, cache_or_None).
        mode: "train" (logits over all positions) or "prefill" (last-position
        logits and the reference's prefill cache: the dense and MoE families'
        stacked (L, B, Hkv, S, hd) K/V under "kv", or under MLA the stacked
        (c_kv (L, B, S, kv_lora), k_rope (L, B, S, rope)), with the MoE
        family's leading dense layers under "dense_kv"; the SSM family's
        stacked {"conv", "ssm"} states, the hybrid family's per-super-block
        states under "super" and each tail's under "tail{t}"; the audio
        family's ((k, v), (xk, xv)) stacked over layers under "dec"; the VLM
        family's {"self{j}": (k, v), "cross": (xk, xv)} stacked over
        super-blocks under "super").
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

        def block(fn, p, *args, **kwargs):
            if not remat:
                return fn(p, *args, **kwargs)
            if self.remat_policy == "outputs":
                return checkpoint(fn, p, *args, use_reentrant=False,
                                  context_fn=lambda: _save_block_outputs(p), **kwargs)
            return checkpoint(fn, p, *args, use_reentrant=False, **kwargs)

        if cfg.family in ("dense", "moe"):
            stacks = [("dense_kv", "dense_blocks", False)] if self._n_dense_first else []
            stacks.append(("kv", "blocks", cfg.family == "moe"))
            for cache_name, stack, use_moe in stacks:
                kvs = []
                mesh = self._shardmap_mesh(S, use_moe=use_moe, collect=collect)
                for p in layer_slices(params[stack]):
                    if mesh is not None:
                        x = block(SMB.dense_block_shardmap, p, x, cfg, mesh, window=window)
                        continue
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
        elif cfg.family == "audio":
            memory = self._encode(params, batch["frames"])
            # learned decoder positions
            x = x + params["dec_pos"].to(x.dtype)[:S][None]
            states = []
            for p in layer_slices(params["blocks"]):
                x, st = block(self._audio_block, p, x, positions, memory, collect=collect)
                states.append(st)
            if collect:
                caches["dec"] = _stack_states(states)
        elif cfg.family == "vlm":
            states = []
            for p in layer_slices(params["super"]):
                x, st = block(self._vlm_super, p, x, positions, batch["images"], window=window,
                              collect=collect)
                states.append(st)
            if collect:
                caches["super"] = _stack_states(states)
        else:
            sup_states = []
            for p in layer_slices(params["super"]):
                st_out = {}
                for j, kind in enumerate(self._pattern):
                    x, st_out[f"b{j}"] = block(self._hybrid_block, p[f"b{j}_{kind}"], kind, x,
                                               positions, collect=collect)
                x = shard(x, "batch", "seq", None)
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
        nll = (L.log_partition(logits) - L.gold_logits(logits, tokens[:, 1:])).mean()
        return nll + cfg.router_aux_weight * aux, nll

    # -- decode -------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, *, device="cuda", memory_len: int = 0):
        """Build an empty decode cache (+ its logical-axes spec tree). The
        audio and VLM families also hold the cross-attention K/V ("xk",
        "xv") of ``memory_len`` memory tokens (default: the config's frames
        or image tokens), which ``fill_cross_cache`` fills."""
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
        elif cfg.family in ("audio", "vlm"):
            kvh = cfg.num_kv_heads
            if cfg.family == "audio":
                nx, m = n, memory_len or cfg.num_frames
                put("k", (n, batch, kvh, cache_len, hd), kvs)
                put("v", (n, batch, kvh, cache_len, hd), kvs)
            else:   # per super-block, its self-attention layers on a second axis
                nx, m = self._n_super, memory_len or cfg.num_image_tokens
                shape = (nx, cfg.cross_attn_every - 1, batch, kvh, cache_len, hd)
                kv6 = ("layers", None, "batch", "kv_heads", "kv_seq", None)
                put("k", shape, kv6)
                put("v", shape, kv6)
            xs = ("layers", "batch", "kv_heads", None, None)
            put("xk", (nx, batch, kvh, m, hd), xs)
            put("xv", (nx, batch, kvh, m, hd), xs)
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
        elif cfg.family == "audio":
            x = self._audio_decode(params, x, cache, new_cache, pos)
        elif cfg.family == "vlm":
            x = self._vlm_decode(params, x, cache, new_cache, pos, window)
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
                x, h = L.add_norm(p["ln2"], x, out, cfg.norm, cfg.norm_eps)
                if use_moe:
                    f, _ = MOE.apply_moe(p["ffn"], h, cfg, impl=self.moe_impl)
                else:
                    f = L.apply_mlp(p["ffn"], h, cfg)
                x = x + f
                for acc, arr in zip(outs, nc):
                    acc.append(arr)
            for nm, arrs in zip(kv_names, outs):
                new_cache[pre + nm] = torch.stack(arrs)
        return x

    def _self_attn_decode(self, p, x, k, v, pos, window=0):
        """The self-attention residual of one decode step: (x, new k, new v)."""
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        out, nk, nv = L.apply_attention_decode(p["attn"], h, cfg, k, v, pos, window=window)
        return x + out, nk, nv

    def _audio_decode(self, params, x, cache, new_cache, pos):
        x = x + params["dec_pos"].to(x.dtype).index_select(0, pos.reshape(1).long())[None]
        ks, vs = [], []
        for i, p in enumerate(layer_slices(params["blocks"])):
            x, nk, nv = self._self_attn_decode(p, x, cache["k"][i], cache["v"][i], pos)
            x = self._cross_and_ffn(p, "lnx", x, cache["xk"][i], cache["xv"][i])
            ks.append(nk)
            vs.append(nv)
        new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
        return x

    def _vlm_decode(self, params, x, cache, new_cache, pos, window):
        cfg = self.cfg
        ks, vs = [], []
        for i, p in enumerate(layer_slices(params["super"])):
            nks, nvs = [], []
            for j in range(cfg.cross_attn_every - 1):
                bp = p[f"self{j}"]
                x, nk, nv = self._self_attn_decode(bp, x, cache["k"][i][j], cache["v"][i][j],
                                                   pos, window)
                h = L.apply_norm(bp["ln2"], x, cfg.norm, cfg.norm_eps)
                x = x + L.apply_mlp(bp["ffn"], h, cfg)
                nks.append(nk)
                nvs.append(nv)
            x = self._cross_and_ffn(p["cross"], "ln1", x, cache["xk"][i], cache["xv"][i])
            ks.append(torch.stack(nks))
            vs.append(torch.stack(nvs))
        new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
        return x

    def fill_cross_cache(self, params, cache, memory: torch.Tensor):
        """Precompute cross-attention K/V from modality memory into ``cache``
        (a new dict; the other families' caches come back as they are).

        audio: ``memory`` = frame embeddings (B, F, D) -> runs the encoder.
        vlm:   ``memory`` = patch embeddings (B, I, D), cast to the model's dtype.
        """
        cfg = self.cfg
        if cfg.family == "audio":
            mem = self._encode(params, memory)
            xattn = [p["xattn"] for p in layer_slices(params["blocks"])]
        elif cfg.family == "vlm":
            mem = memory.to(cfg.torch_dtype)
            xattn = [p["cross"]["xattn"] for p in layer_slices(params["super"])]
        else:
            return cache
        kvs = [L.cross_kv(p, mem, cfg) for p in xattn]
        cache = dict(cache)
        cache["xk"] = torch.stack([k for k, _ in kvs])
        cache["xv"] = torch.stack([v for _, v in kvs])
        return cache

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
        x, h = L.add_norm(p["ln2"], x, out, cfg.norm, cfg.norm_eps)
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

    # -- input specs ---------------------------------------------------------

    def input_specs(self, shape_name: str) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins for the step functions' inputs at
        ``INPUT_SHAPES[shape_name]``: int32 "tokens" (train: one longer, for
        the shifted labels) or "token" (decode), and the audio family's
        "frames" / the VLM's "images" outside decode."""
        cfg = self.cfg
        sh = INPUT_SHAPES[shape_name]
        B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if kind == "decode":
            out = {"token": meta((B,), torch.int32)}
        else:
            out = {"tokens": meta((B, S + 1 if kind == "train" else S), torch.int32)}
        if cfg.family == "audio" and kind != "decode":
            out["frames"] = meta((B, cfg.num_frames, cfg.d_model), cfg.torch_dtype)
        if cfg.family == "vlm" and kind != "decode":
            out["images"] = meta((B, cfg.num_image_tokens, cfg.d_model), cfg.torch_dtype)
        return out

    def param_count(self, params=None) -> int:
        if params is None:
            params, _ = self.init(device="meta")
        return count_params(params)
