"""Smoke run of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives the port's three paths at full width, with random weights from a
seed: qwen2.5-3b (dense; 36 layers, d_model 2048, bf16) through the
hand-written Hopper flash-attention kernel; mamba2-130m (SSM; 24 layers,
d_model 768) through the SSD-scan kernel; recurrentgemma-9b (hybrid; 38
layers, d_model 4096) through the RG-LRU-scan kernel and the flash kernel's
local window. Each model is prefilled and served greedily through the AMP4EC
NSA scheduler, then trained a few steps (AdamW, remat, gradients through the
kernels' autograd Functions). Then the paper's own model, MobileNetV2, is
partitioned, verified and served on the card through the port's copy of the
AMP4EC control plane (``DistributedInference``); it reaches none of the
repo's kernels (its convolutions are cuDNN's). Then deepseek-v2-236b (MoE
with multi-head latent attention; d_model 5120, 128 heads, 160 routed
experts top-6 and 2 shared, bf16) at full width cut to 4 layers (one dense
MLA block, three MLA-MoE blocks: 13.3 B parameters) is prefilled through
the flash kernel at D = 192, Dv = 128 and served. Then the two
cross-attention families: whisper-medium (audio; 24 encoder and 24 decoder
layers, d_model 1024, 16 heads x 64, full depth) is prefilled over 1500
frames, its encoder through the flash kernel's non-causal mask, and served
(each request group's cross cache runs the encoder); llama-3.2-vision-90b
(VLM; d_model 8192, 64/8 heads x 128, d_ff 28672, a gated cross layer over
1601 image tokens every 5th layer) at full width cut to 10 layers (10.66 B
parameters) is prefilled and served. Then the kernel tooling: the rates
the card attains against the cost model's H100 block, the batch-cost
calibration sweep (``scripts/calibrate_costmodel_torch.py``) on the three
Hopper kernels, whose curves the paper's planner then uses for MobileNetV2,
and the transformer-partitioning example. Then the multi-device code on
the one card, under a NCCL process group of one: qwen2.5-3b through the
Megatron-SP blocks and a deepseek-v2 MoE layer through the mesh branches.
The script builds every
kernel from the sources in the checkout, holds each against its plain
PyTorch version on the card, times it (and its backward, the plain version's VJP) beside its bound,
its plain version and the closest PyTorch library call, and checks that each
path launched its kernels: every count is set to 0 just before a path's
prefill or training step and read just after.

Phases (any failure exits non-zero):
  1. card name and power limit; build the kernels (one nvcc each, together)
  2. each kernel against its plain version on the card, with the variant
     each case takes (flash: wgmma or CUDA cores; SSD: tensor-core passes
     or CUDA cores), the model's strided (B, S, H, D) views included; the
     RG-LRU scan also with long memory (a in [0.99, 1) and a = 1), against
     an fp64 loop too
     and DeepSeek-V2's MLA prefill (1, 128, 4096, D 192 / Dv 128, scale
     1/sqrt(192)) with the reduced MLA's D 48 / Dv 32 in fp32; the Whisper
     encoder's non-causal (4, 16, 1500, 64) in bf16 and fp32 and the VLM's
     causal (1, 64/8, 4096, 128)
     the dense block's fused passes (add + RMSNorm, bias + RoPE, SwiGLU)
     against their plain chains: the residual sum bit-exact, the rest within
     1 ulp (bf16) / 4 ulps (fp32; the norm 32)
  3. timing at the main-path shapes (CUDA events), TFLOP/s and share of the
     bound of each kernel; flash also at the qwen prefill's own call, at
     the MLA prefill's (with the SDPA backends that take Dv != D) and at
     the Whisper encoder's, the Whisper decoder's and the VLM's calls; the
     RG-LRU scan in fp32 and bf16 beside a same-bytes torch.add pass; each
     fused pass at prefill_batch32's (32, 1024) tokens against its bytes
     bound and the plain chain it replaces
  4-6. qwen2.5-3b: prefill (launches, finite logits, profile with its count
     of copy kernels; the fused passes' launches per call, and every
     kernel's launches with the plain chains and with the fused passes), fp32
     prefill-vs-decode consistency (bound 2e-3), serving 8 requests
  7-9. mamba2-130m: the same three
  10-12. recurrentgemma-9b: the same three (the fp32 check at depth 5)
  13. loss gradients on the card (through the kernels) against the CPU, for
      reduced qwen2.5-3b, mamba2-130m, recurrentgemma-9b, deepseek-v2-236b,
      kimi-k2-1t-a32b, whisper-medium and llama-3.2-vision-90b (4 layers,
      cross-layer gate 0.5) in fp32, remat off and on: every leaf, within
      1e-4 (the MoE routing on both devices compared, any top-k flip
      reported)
  14. full-width qwen2.5-3b training: 3 steps at (2, 512 + 1), bf16 params,
      fp32 moments, remat (launches per step, every leaf moved, peak
      memory), then one step under the profiler
  15. full-width mamba2-130m training at (2, 2048 + 1), then an exact
      checkpoint round trip on the card
  16. full-width recurrentgemma-9b cut to 5 layers (one super-block and both
      tails) training at (1, 4096 + 1), past the 2048 window
  17. MobileNetV2 at the paper's batch, (32, 224, 224, 3) fp32: partition
      sizes [116, 25] / [108, 16, 17]; the card against the CPU on the same
      seeded weights (1e-5, TF32 off); verify_numerics and a repeated cached
      infer through DistributedInference on the paper cluster (no kernel of
      the repo launched); the quickstart's run(100) rows (simulated edge ms);
      forward and partition times at batch 1 and 32, launches, busy share,
      copy kernels and peak memory
  18-20. deepseek-v2-236b, full width cut to 4 layers: prefill (1, 4096)
      (one flash launch per layer, MLA caches), fp32 prefill-vs-decode at 2
      layers with the drop-free capacity factor 16 (bound 2e-3), serving 8
      requests and a profiled decode step at batch 4 (every decode step
      reads all 160 experts of each MoE layer, as the reference's dense
      capacity buffer does)
  21-23. whisper-medium at full width and depth: prefill (4, 448) over
      frames (4, 1500, 1024) (24 non-causal encoder and 24 causal decoder
      flash launches, all on wgmma), fp32 prefill-vs-decode (bound 2e-3),
      serving 8 requests (24 encoder launches per request group)
  24-26. llama-3.2-vision-90b, full width cut to 10 layers (two
      super-blocks of 4 self-attention layers and 1 gated cross layer; the
      gate set to 0.5, since its initial 0 hides the cross layers): prefill
      (1, 4096) over images (1, 1601, 8192) (8 flash launches; cross
      attention is plain PyTorch), fp32 check at 5 layers, serving
  27. attainable rates against the cost model's H100 block: a bf16 matmul
      at 8192^3 and a 1 GiB device copy (CUDA events), each as a share of
      GPU_PEAK_FLOPS and GPU_HBM_BW (fails above 1.05)
  28. the calibration sweep: scripts/calibrate_costmodel_torch.py's
      run on the card (Attention, SSD and RGLRU through the Hopper kernels
      in fp32, Linear and Conv2d through the library; k in 1, 2, 4, 8, host
      clock, the least of 3 passes; each point's device time by the
      profiler beside it, or by CUDA events where the profiler lost
      kernels, which the results say), the artifact written under the
      temporary directory and loaded back as calibrated, naming the card;
      each kernel launched; the sweep's inputs at k = 1 and 8 through each
      kernel against its plain version (fp32: attention 2e-5 and the SSD
      2e-4 on the CUDA-core variants, the RG-LRU scan 2e-5)
  29. MobileNetV2 (32, 224, 224, 3) planned by the DP planner on the paper
      cluster at expected_k = 4 with the analytic model and with the
      card's curves: both plans, verify_numerics on the card, run(200) with
      micro-batches of up to 4 (simulated edge ms), and whether the plan
      moved
  30. examples/partition_transformer_torch.py in a process without JAX
  31. the multi-device path on the one card: a NCCL process group of one
      and its (1, 1) ("data", "model") mesh; full-width qwen2.5-3b (36
      layers) in fp32 through the Megatron-SP blocks (block_impl =
      "shardmap" under {"seq": ("model",)}: all-gather, local heads and FF,
      reduce-scatter per sublayer), its train forward at (1, 512) against
      the plain blocks within 5e-4, with one flash launch per layer
  32. one deepseek-v2-236b MoE layer at full width (160 experts top-6, 2
      shared) in bf16 at (1, 512) through the expert-parallel and the 2D
      mesh branches: bit-equal to the off-mesh branch (at a group of one
      every collective is the identity); then the group is destroyed
  33. the dry run (``launch/dryrun.py``) on the production meshes, each in
      a process of its own with no CUDA device: qwen2.5-3b train_4k on the
      16x16 mesh (256 ranks) and deepseek-v2-236b decode_32k on the
      2x16x16 mesh (512 ranks, the kv_seq override, rolled accounting);
      every record ok, with FLOPs and collective bytes; then the roofline
      table over the records (data-sheet arithmetic, not measured time)
  34. the dry run's counting layer against the card: full-width qwen2.5-3b
      bf16 prefill (2, 512) counted with no mesh on CPU fake tensors (in a
      process of its own), then run on the card: the counted argument bytes
      equal the card's parameter and batch bytes, and the card's device
      time is at least the compute term; measured / compute term and
      measured / memory term
  35. JSON lines of the training, MobileNetV2, kernel-tooling,
      multi-device, dry-run and kernel results, the card line, then the
      device line last

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (DistributedInference, EdgeCluster,  # noqa: E402
                              EngineConfig, ModelPartitioner, make_paper_cluster,
                              run_monolithic)
from repro_torch.core.cost_model import (ANALYTIC_BATCH_MODEL, BatchCostModel,  # noqa: E402
                                         GPU_HBM_BW as HBM_BYTES_PER_S,
                                         GPU_PEAK_FLOPS as PEAK_BF16_FLOPS)
from repro_torch.data import DataConfig, batches_for_model, frontend_stub  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused as fu  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.graph import mobilenetv2_graph  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.mobilenetv2 import build_mobilenetv2, run_full, run_range  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw, cosine_with_warmup  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.utils.params import ParamBuilder, tree_leaves, tree_map  # noqa: E402
from repro_torch.utils.sharding import logical_rules  # noqa: E402

SEED = 0
# the bf16 and memory peaks are the cost model's H100 block (PEAK_BF16_FLOPS,
# HBM_BYTES_PER_S above); the fp32 rate is the same data sheet's
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
MAIN = dict(b=1, hq=16, hkv=2, s=2048, d=128)   # qwen2.5-3b attention at S=2048
PREFILL = dict(b=2, hq=16, hkv=2, s=512, d=128)  # qwen2.5-3b attention in phase 4's prefill
# recurrentgemma-9b local attention at its (1, 4096) prefill
HYBRID = dict(b=1, hq=16, hkv=1, s=4096, d=256, window=2048)
# mamba2-130m SSD at its (2, 2048) prefill: (B, L, H, P, G, N, chunk)
SSD_MAIN = dict(B=2, L=2048, H=24, P=64, G=1, N=128, chunk=256)
RGLRU_MAIN = dict(B=1, L=4096, W=4096)           # recurrentgemma-9b RG-LRU prefill
# deepseek-v2-236b MLA attention at its (1, 4096) prefill: nope 128 + rope 64
# for q and k, v_head_dim 128, scale 1/sqrt(192)
MLA_MAIN = dict(b=1, hq=128, hkv=128, s=4096, d=192, dv=128)
# the reduced MLA (d_model 256, 4 heads, nope 32 + rope 16, v 32) at phase
# 13's (2, 128) fp32 forward: the CUDA-core variant
MLA_REDUCED = dict(b=2, hq=4, hkv=4, s=128, d=48, dv=32)
# whisper-medium: the encoder's non-causal attention over 1500 frames and
# the decoder's causal attention at its 448-token context, batch 4
WHISPER_ENC = dict(b=4, hq=16, hkv=16, s=1500, d=64, dv=64)
WHISPER_DEC = dict(b=4, hq=16, hkv=16, s=448, d=64, dv=64)
# llama-3.2-vision-90b self attention at its (1, 4096) prefill
VLM_DEC = dict(b=1, hq=64, hkv=8, s=4096, d=128, dv=128)
#: the VLM's cross-layer gate on the card (init 0: tanh(0) = 0 hides the layers)
GATE = 0.5
MNV2_INPUT = (32, 224, 224, 3)   # the paper's batch of 32 at MobileNetV2's IMAGE_SIZE, NHWC
ATTAIN_GEMM_N = 8192             # the bf16 GEMM of the attainable-rate phase, N^3
ATTAIN_COPY_BYTES = 2 ** 30      # the streaming copy of the attainable-rate phase
CURVES_REQUESTS = 200            # requests per run on the card's curves
SP_SEQ = 512                     # tokens of the multi-device phases' (1, S) inputs
#: phase 33's dry runs: (arch, shape, the CLI's further flags); each traces
#: on CPU fake tensors as rank 0 of a fake group of 256 or 512 ranks
DRYRUN_CASES = (("qwen2.5-3b", "train_4k", ()),
                ("deepseek-v2-236b", "decode_32k", ("--multi-pod", "--accounting", "rolled")),
                ("whisper-medium", "train_4k", ("--accounting", "rolled")),
                ("mamba2-130m", "train_4k", ("--accounting", "rolled")),
                ("deepseek-v2-236b", "train_4k", ("--opt", "fsdp,ep2d", "--accounting", "rolled")))
#: each dry-run subprocess's own time limit, s (the CPU times are in PERF.md);
#: the cases run at once, each in a process of its own
DRYRUN_TIMEOUT_S = 300
#: phase 34: full-width qwen2.5-3b bf16 prefill at the smoke's (2, 512)
COUNT_BATCH, COUNT_SEQ = 2, 512
#: phase 34's counting layer in a process of its own (no CUDA device, no
#: process group): one prefill of ``arch`` at (batch, seq) on CPU fake
#: tensors, no mesh; prints its counts as JSON
COUNT_PREFILL = """
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import count_step
from repro_torch.models.model import Model
from repro_torch.utils.hlo import op_histogram
arch, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
model = Model(get_config(arch))
params, _ = model.init(device="meta")
tokens = torch.empty((batch, seq), dtype=torch.int32, device="meta")
@torch.no_grad()
def prefill(p, b):
    return model.forward(p, b, mode="prefill")[0]
c = count_step(prefill, (params, {"tokens": tokens}))
print(json.dumps(dict(flops=c["flops"], bytes=c["bytes"], memory=c["memory"],
                      trace_s=c["trace_s"], hlo_ops=op_histogram(c["ops"]))))
"""
CALIBRATE = ROOT / "scripts" / "calibrate_costmodel_torch.py"
EXAMPLE = ROOT / "examples" / "partition_transformer_torch.py"
#: the kernels' wrappers, whose ``launches`` count their kernel launches
KERNELS = {"flash_attention": fa.flash_attention, "ssd_scan": ss.ssd_scan,
           "rglru_scan": rg.rglru_scan}
#: each wrapper's kernel symbols in a profile, one event per launch (the SSD's
#: tensor-core variant runs three passes; its last, ssd_chunk_scan, once)
KERNEL_SYMBOLS = {"flash_attention": ("flash_fwd",), "ssd_scan": ("ssd_fwd", "ssd_chunk_scan"),
                  "rglru_scan": ("rglru_fwd",)}
#: the dense block's fused elementwise passes (``kernels/fused.py``), kept out
#: of KERNELS: their counts are printed per prefill, not asserted per family
FUSED = {"add_rms_norm": fu.add_rms_norm, "qkv_bias_rope": fu.qkv_bias_rope,
         "swiglu": fu.swiglu}
FUSED_SYMBOLS = {"add_rms_norm": "add_rms_norm_kernel", "qkv_bias_rope": "qkv_bias_rope_kernel",
                 "swiglu": "swiglu_kernel"}
#: the ops entry points that reach FUSED, which ``plain_chains`` sends to
#: their plain versions
FUSED_ENTRIES = ("rms_norm", "add_rms_norm", "qkv_bias_rope", "rope", "swiglu")
#: prefill_batch32's calls at their longest: (32, 1024) tokens of qwen2.5-3b
FUSED_TIMING = dict(rows=32 * 1024, d=2048, hq=16, hkv=2, hd=128, ff=11008)
#: profiles of one call taken before one that lost kernel events is kept
PROFILE_ATTEMPTS = 3
#: the profiler ranges of the kernels' backward passes (their plain VJPs)
BACKWARD_RANGES = {"flash_attention": "flash_attention backward (plain VJP)",
                   "ssd_scan": "ssd_scan backward (plain VJP)",
                   "rglru_scan": "rglru_scan backward (plain VJP)"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "by_variant"):
            fn.by_variant = dict.fromkeys(fn.by_variant, 0)


def read_variants() -> dict:
    return {name: dict(fn.by_variant) for name, fn in KERNELS.items()
            if hasattr(fn, "by_variant")}


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def read_fused() -> dict:
    return {name: fn.launches for name, fn in FUSED.items()}


@contextlib.contextmanager
def plain_chains():
    """The fused passes' entry points sent to their plain versions (every
    other entry point as it is): the model as it ran before the fusion."""
    saved = {name: getattr(ops, name) for name in FUSED_ENTRIES}
    try:
        for name, fn in saved.items():
            setattr(ops, name, lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "impl": "torch"}))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def kernel_counts(fn) -> dict:
    """{kernel name: launches} over one call of ``fn`` under the profiler."""
    events, _ = _profile_once(fn)
    return {e.key: e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA}


def fused_launch_table(fn, label: str) -> dict:
    """Kernel launches of one call of ``fn`` with the plain chains (before
    the fusion) and with the fused passes (after), by kernel: the totals,
    the fused kernels and every kernel whose count moved."""
    with plain_chains():
        before = kernel_counts(fn)
    after = kernel_counts(fn)
    moved = {k: (before.get(k, 0), after.get(k, 0)) for k in set(before) | set(after)
             if before.get(k, 0) != after.get(k, 0)}
    log(f"  launches of {label}, plain chains -> fused passes: "
        f"{sum(before.values())} -> {sum(after.values())} kernels")
    for k, (b, a) in sorted(moved.items(), key=lambda kv: -abs(kv[1][0] - kv[1][1])):
        log(f"    {b:6d} -> {a:6d}  {k[:100]}")
    return dict(before=sum(before.values()), after=sum(after.values()),
                moved={k[:100]: v for k, v in moved.items()})


def build_all() -> None:
    """Build the four libraries at once: one nvcc per source, in threads."""
    libs = {"flash_attention": fa._lib, "ssd_scan": ss._lib, "rglru_scan": rg._lib,
            "fused_elementwise": fu._lib}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(fn) for fn in libs.values()]:
            fut.result()
    log(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s of wall")
    for name in libs:
        seconds, ptxas = build.build_info(name)
        log(f"  {name}: nvcc {seconds:.1f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")


def qkv(seed, b, hq, hkv, s, d, dv, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda h, w: torch.randn((b, h, s, w), generator=g, device="cuda").to(dtype)
    return mk(hq, d), mk(hkv, d), mk(hkv, dv)


def qkv_heads_last(seed, b, hq, hkv, s, d, dv, dtype):
    """q, k, v as the model hands them over: (B, H, S, D) transposes of
    contiguous (B, S, H, D) projections."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda h, w: torch.randn((b, s, h, w), generator=g, device="cuda").to(dtype)
    return mk(hq, d).transpose(1, 2), mk(hkv, d).transpose(1, 2), mk(hkv, dv).transpose(1, 2)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, n: int = 10) -> tuple:
    """(device ms per call of ``fn``, how it was taken). "profiler": the sum
    of its kernels' time under torch.profiler, without the host's gaps
    between launches, from a profile that holds every kernel: one call is
    profiled alone for its count of kernels, and n calls must show n times
    that count. The profiler keeps only some kernel events now and then in
    a fresh process and in almost every profile late in this script's long
    process (each profile here is a new single-cycle profiler, so its
    acc_events, which keeps events across the cycles of one profiler, does
    not apply; scripts/profiler_probe.py counts what profiles keep). A
    short profile is taken again; after three
    the CUDA-event time of n calls stands in, "cuda events", and the log
    names the kernels each profile kept."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(calls: int) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        one, many = kernels(1), kernels(n)
        per_call = sum(c for c, _ in one.values())
        total_us = sum(t for _, t in many.values())
        if per_call and total_us > 0 and sum(c for c, _ in many.values()) == n * per_call:
            return total_us / n / 1e3, "profiler"
    short = lambda ks: {k[:48]: c for k, (c, _) in ks.items()}  # noqa: E731
    log(f"    the profiler kept {short(one)} of one call and {short(many)} of {n}, 3 times: "
        "CUDA-event time instead")
    return cuda_ms(fn, iters=n), "cuda events"


def device_ms(fn, n: int = 10) -> float:
    """Device ms per call of ``fn`` (``device_time``; the log names a stand-in)."""
    return device_time(fn, n)[0]


def check(kernel: str, name: str, got, want, tol: float) -> dict:
    """max |kernel - plain| over the outputs, asserted within ``tol``."""
    err, close = 0.0, True
    for g, w in zip(got, want):
        err = max(err, float((g.float() - w.float()).abs().max()))
        close &= torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
    log(f"  {kernel} {name}: max|kernel-plain| = {err:.3e} (tolerance {tol:g}) "
        f"{'ok' if close else 'FAIL'}")
    assert close and math.isfinite(err), f"{kernel} disagrees: {name}"
    return dict(case=name, max_abs_err=err, tol=tol)


def flash_vs_plain():
    """Each case (name, shape, dtype, causal, window, tolerance): the kernel
    against the plain version on the same inputs -> max |kernel - plain|."""
    m = MAIN
    cases = [
        ("main bf16 causal", dict(m, dv=128), torch.bfloat16, True, 0, 2e-2),
        ("main fp32 causal", dict(m, dv=128), torch.float32, True, 0, 2e-5),
        # the shapes phases 4 and 5 give the kernel: the (2, 512) bf16 prefill
        # (batch offsets) and the 16-token fp32 forward (one partial tile)
        ("prefill B=2 S=512 bf16 causal", dict(m, b=2, s=512, dv=128), torch.bfloat16,
         True, 0, 2e-2),
        ("forward B=1 S=16 fp32 causal", dict(m, s=16, dv=128), torch.float32, True, 0, 2e-5),
        ("fp32 window=256", dict(m, dv=128), torch.float32, True, 256, 2e-5),
        ("fp32 non-causal", dict(m, dv=128), torch.float32, False, 0, 2e-5),
        ("fp32 ragged S=1000", dict(m, s=1000, dv=128), torch.float32, True, 0, 2e-5),
        ("fp32 D=192 Dv=128", dict(m, d=192, dv=128), torch.float32, True, 0, 2e-5),
        # bf16 beyond the main shape: the tensor-core variant on the other
        # masks, and the CUDA-core variant (D % 16 != 0)
        ("bf16 window=256", dict(m, dv=128), torch.bfloat16, True, 256, 2e-2),
        ("bf16 non-causal", dict(m, dv=128), torch.bfloat16, False, 0, 2e-2),
        ("bf16 ragged S=1000", dict(m, s=1000, dv=128), torch.bfloat16, True, 0, 2e-2),
        ("bf16 D=192 Dv=128", dict(m, d=192, dv=128), torch.bfloat16, True, 0, 2e-2),
        ("bf16 D=72 Dv=40 (CUDA cores)", dict(m, d=72, dv=40), torch.bfloat16, True, 0, 2e-2),
    ]
    # recurrentgemma-9b: D = 256, one kv head, window 2048, at its bf16
    # prefill (S > window) and at the 16-token fp32 forward of phase 11
    hy = dict(b=1, hq=16, hkv=1, s=HYBRID["s"], d=256, dv=256)
    win = HYBRID["window"]
    cases += [
        ("hybrid bf16 (1,16,1,4096,256) window 2048", hy, torch.bfloat16, True, win, 2e-2),
        ("hybrid fp32 (1,16,1,4096,256) window 2048", hy, torch.float32, True, win, 2e-5),
        ("hybrid forward S=16 fp32 window 2048", dict(hy, s=16), torch.float32, True, win, 2e-5),
    ]
    cases += [
        # D = 64 (whisper), and a window edge that falls inside a 128-row tile
        ("bf16 D=64 (2,8,2,300,64)", dict(m, b=2, hq=8, s=300, d=64, dv=64), torch.bfloat16,
         True, 0, 2e-2),
        ("bf16 window=200 S=1000", dict(m, s=1000, dv=128), torch.bfloat16, True, 200, 2e-2),
        ("bf16 D=64 window=200 S=1000", dict(m, hq=8, s=1000, d=64, dv=64), torch.bfloat16,
         True, 200, 2e-2),
    ]
    results = []
    for i, (name, shape, dtype, causal, window, tol) in enumerate(cases):
        q, k, v = qkv(SEED + i, **shape, dtype=dtype)
        variant = fa.route(q, k, v)
        wide = dtype == torch.bfloat16 and shape["d"] % 64 == 0 and shape["dv"] % 64 == 0
        assert variant == ("wgmma" if wide else "cuda_core"), (name, variant)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        results.append(dict(check("flash_attention", f"{name} [{variant}]", [got], [want], tol),
                            variant=variant))
    # the model's own layout: transposed (B, S, H, D) views in, and out through
    # a (B, S, H, Dv) allocation, so that neither side copies. Phase 4's
    # prefill, and phase 31's fp32 (1, 512) forward: the Megatron-SP block's
    # 16 q heads over the 16 kv heads it picked, and the plain block's 2
    for i, (name, shape, dtype) in enumerate((
            ("prefill (2,16,2,512,128) bf16", PREFILL, torch.bfloat16),
            ("prefill (2,16,2,512,128) fp32", PREFILL, torch.float32),
            ("Megatron-SP (1,16,16,512,128) fp32", dict(PREFILL, b=1, hkv=16), torch.float32),
            ("plain block (1,16,2,512,128) fp32", dict(PREFILL, b=1), torch.float32))):
        b_, s_, h_, d_ = shape["b"], shape["s"], shape["hq"], shape["d"]
        q, k, v = qkv_heads_last(SEED + 50 + i, **shape, dv=d_, dtype=dtype)
        variant = fa.route(q, k, v)
        assert variant == ("wgmma" if dtype == torch.bfloat16 else "cuda_core"), variant
        got = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert got.stride() == (s_ * h_ * d_, d_, h_ * d_, 1), got.stride()
        want = ref.attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        results.append(dict(check("flash_attention", f"{name} causal on (B,S,H,D) views "
                                  f"[{variant}]", [got], [want], tol), variant=variant))
    # DeepSeek-V2's MLA: q and k (B, H, S, 192) and v (B, H, S, 128) as
    # apply_mla hands them over, the scale given as 1/sqrt(nope + rope)
    for i, (name, shape, dtype, tol, want_variant) in enumerate((
            ("MLA prefill (1,128,4096,192/128) bf16", MLA_MAIN, torch.bfloat16, 2e-2, "wgmma"),
            ("MLA reduced (2,4,128,48/32) fp32", MLA_REDUCED, torch.float32, 2e-5,
             "cuda_core"))):
        q, k, v = qkv_heads_last(SEED + 60 + i, **shape, dtype=dtype)
        scale = 1.0 / math.sqrt(shape["d"])
        variant = fa.route(q, k, v)
        assert variant == want_variant, (name, variant)
        got = fa.flash_attention(q, k, v, causal=True, scale=scale)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=True, scale=scale)
        torch.cuda.synchronize()
        results.append(dict(check("flash_attention", f"{name} causal scale 1/sqrt({shape['d']}) "
                                  f"on (B,S,H,D) views [{variant}]", [got], [want], tol),
                            variant=variant))
        del q, k, v, got, want
        torch.cuda.empty_cache()
    # the cross-attention families' self attention, as the model hands it
    # over: the Whisper encoder's non-causal mask at S = 1500 (a multiple of
    # neither the 128-row q tile nor the 64-key tile) and the VLM's 64 q heads
    # over 8 kv heads
    for i, (name, shape, dtype, causal, tol, want_variant) in enumerate((
            ("Whisper encoder (4,16,16,1500,64) bf16 non-causal", WHISPER_ENC, torch.bfloat16,
             False, 2e-2, "wgmma"),
            ("Whisper encoder (4,16,16,1500,64) fp32 non-causal", WHISPER_ENC, torch.float32,
             False, 2e-5, "cuda_core"),
            ("VLM decoder (1,64,8,4096,128) bf16 causal", VLM_DEC, torch.bfloat16, True, 2e-2,
             "wgmma"))):
        q, k, v = qkv_heads_last(SEED + 70 + i, **shape, dtype=dtype)
        variant = fa.route(q, k, v)
        assert variant == want_variant, (name, variant)
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        results.append(dict(check("flash_attention", f"{name} on (B,S,H,D) views [{variant}]",
                                  [got], [want], tol), variant=variant))
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return results


def ssd_inputs(seed, B, L, H, P, G, N, dtype=torch.bfloat16):
    """x, B, C in ``dtype``; dt (a softplus) and a in fp32, as the model gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    x = (rn(B, L, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, L, H)) * 0.1
    a = -torch.exp(rn(H) * 0.5)
    return x, dt, a, (rn(B, L, G, N) * 0.3).to(dtype), (rn(B, L, G, N) * 0.3).to(dtype)


def ssd_vs_plain():
    """The SSD kernel against the sequential oracle: y and the final state."""
    m = SSD_MAIN
    shape = {k: m[k] for k in "BLHPGN"}
    cases = [
        ("main (2,2048,24,64,G1,N128,Q256) bf16 x/B/C", shape, m["chunk"], torch.bfloat16, 3e-2),
        ("main shape fp32", shape, m["chunk"], torch.float32, 2e-4),
        ("grouped G=2 fp32", dict(shape, L=512, G=2), m["chunk"], torch.float32, 2e-4),
        ("single chunk L=256 fp32", dict(shape, L=256), m["chunk"], torch.float32, 2e-4),
        # the 16-token fp32 forward of phase 8: chunk = min(256, L)
        ("forward (1,16) fp32, chunk 16", dict(shape, B=1, L=16), 16, torch.float32, 2e-4),
        # the tensor-core passes beyond the main shape: grouped B/C, a single
        # chunk, and a bf16 prefill of L = 100 (chunk = min(256, L) = 100)
        ("grouped G=2 bf16", dict(shape, L=512, G=2), m["chunk"], torch.bfloat16, 3e-2),
        ("single chunk L=256 bf16", dict(shape, L=256), m["chunk"], torch.bfloat16, 3e-2),
        ("Q=L=100 bf16", dict(shape, L=100), 100, torch.bfloat16, 3e-2),
        # P % 16 != 0 in bf16: the CUDA-core kernel
        ("bf16 P=40 (CUDA cores)", dict(shape, L=512, P=40), m["chunk"], torch.bfloat16, 3e-2),
    ]
    results = []
    for i, (name, sh, chunk, dtype, tol) in enumerate(cases):
        args = ssd_inputs(SEED + 100 + i, **sh, dtype=dtype)
        variant = ss.route(*args, chunk)
        fast = dtype == torch.bfloat16 and sh["P"] % 16 == 0
        assert variant == ("tensor_core" if fast else "cuda_core"), (name, variant)
        got = ss.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        want = ref.ssd_sequential(*args)
        torch.cuda.synchronize()
        results.append(dict(check("ssd_scan", f"{name} [{variant}]", got, want, tol),
                            variant=variant))
    return results


def rglru_inputs(seed, B, L, W, dtype=torch.float32, a_from="sigmoid"):
    """a from sigmoid(randn) (the state forgets in tens of steps), uniform in
    [0.99, 1) (a carry lives for hundreds of steps) or exactly 1 (a prefix
    sum); b from 0.5 randn."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, L, W)
    if a_from == "sigmoid":
        a = torch.sigmoid(torch.randn(shape, generator=g, device="cuda"))
    elif a_from == "[0.99, 1)":
        a = 0.99 + 0.01 * torch.rand(shape, generator=g, device="cuda")
    else:
        assert a_from == "1", a_from
        a = torch.ones(shape, device="cuda")
    return a.to(dtype), (torch.randn(shape, generator=g, device="cuda") * 0.5).to(dtype)


def share_of_tol(got, want, tol: float) -> float:
    """max |got - want| / (tol (1 + |want|)): at most 1 where allclose holds."""
    want = want.double()
    return float(((got.double() - want).abs() / (tol * (1 + want.abs()))).max())


def rglru_vs_plain():
    """The RG-LRU kernel against the plain log-depth scan; the long-memory
    cases (L over many 256-step tiles with a ragged tail) also against an
    fp64 loop, so that a carry lost between tiles shows."""
    m = RGLRU_MAIN
    long_l = dict(m, L=4096 + 37)
    cases = [
        ("main (1,4096,4096) fp32", m, torch.float32, "sigmoid", 2e-5),
        ("main shape bf16 a and b", m, torch.bfloat16, "sigmoid", 3e-2),
        ("ragged L=1000 fp32", dict(m, L=1000), torch.float32, "sigmoid", 2e-5),
        ("L=1 fp32", dict(m, L=1), torch.float32, "sigmoid", 2e-5),
        # the 16-token fp32 forward of phase 11
        ("forward (1,16,4096) fp32", dict(m, L=16), torch.float32, "sigmoid", 2e-5),
        ("long memory (1,4133,40) fp32, a in [0.99, 1)", dict(long_l, W=40), torch.float32,
         "[0.99, 1)", 2e-5),
        ("long memory (1,4133,4096) fp32, a in [0.99, 1)", long_l, torch.float32,
         "[0.99, 1)", 2e-5),
        ("long memory (1,4133,40) fp32, a = 1", dict(long_l, W=40), torch.float32, "1", 2e-5),
        ("long memory (1,4133,4096) fp32, a = 1", long_l, torch.float32, "1", 2e-5),
        ("long memory (1,4133,4096) bf16 a and b, a in [0.99, 1)", long_l, torch.bfloat16,
         "[0.99, 1)", 3e-2),
    ]
    results = []
    for i, (name, sh, dtype, a_from, tol) in enumerate(cases):
        a, b = rglru_inputs(SEED + 200 + i, **sh, dtype=dtype, a_from=a_from)
        got = rg.rglru_scan(a, b)
        torch.cuda.synchronize()
        want = ref.rglru_ref(a, b)
        results.append(check("rglru_scan", name, [got], [want], tol))
        if a_from != "sigmoid":
            exact = ref.rglru_sequential(a, b)
            k_err, p_err = share_of_tol(got, exact, tol), share_of_tol(want, exact, tol)
            log(f"    against an fp64 loop, as a share of {tol:g} (1 + |h|): kernel "
                f"{k_err:.3f}, plain {p_err:.3f}; kernel against plain "
                f"{share_of_tol(got, want, tol):.3f}")
            results[-1].update(kernel_vs_fp64=k_err, plain_vs_fp64=p_err)
    return results


def ulps(got, want) -> int:
    """The largest distance between got and want in units in the last place
    of their dtype (sign and magnitude mapped to one integer line)."""
    ity = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    top = 1 << (8 * got.element_size() - 1)
    a, b = (t.contiguous().view(ity).long() for t in (got, want))
    a, b = (torch.where(t < 0, -(t + top), t) for t in (a, b))
    return int((a - b).abs().max())


def randn(seed: int, *shape, dtype=torch.bfloat16, scale: float = 1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device="cuda")).to(dtype)


def fused_cases():
    """(kernel, case, kernel call, plain call) of each fused pass's cases:
    qwen2.5-3b's shapes at the smoke's (2, 512) prefill in bf16 and fp32,
    decode's S = 1 with (B, 1) int32 positions, rotary_pct 0.5, MLA's rope
    slices, a row count no block divides, widths no 16-byte access divides,
    with and without biases and residual, and operands read through row
    strides."""
    cases = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        x, r = randn(1, 2, 512, 2048, dtype=dt), randn(2, 2, 512, 2048, dtype=dt)
        scale = randn(3, 2048, dtype=torch.float32, scale=0.1) + 1.0
        x37, r37 = x.view(-1, 2048)[:37], r.view(-1, 2048)[:37]
        xs = randn(4, 9, 2051, dtype=dt)[:, :2048]          # row stride d + 3
        cases += [
            ("add_rms_norm", f"(2,512,2048) + residual {tag}",
             lambda x=x, r=r, sc=scale: fu.add_rms_norm(x, r, sc, 1e-6),
             lambda x=x, r=r, sc=scale: ref.add_rms_norm(x, r, sc, 1e-6)),
            ("add_rms_norm", f"(2,512,2048) no residual {tag}",
             lambda x=x, sc=scale: (fu.add_rms_norm(x, None, sc, 1e-6),),
             lambda x=x, sc=scale: (ref.rms_norm(x, sc, 1e-6),)),
            ("add_rms_norm", f"37 rows + residual {tag}",
             lambda x=x37, r=r37, sc=scale: fu.add_rms_norm(x, r, sc, 1e-6),
             lambda x=x37, r=r37, sc=scale: ref.add_rms_norm(x, r, sc, 1e-6)),
            ("add_rms_norm", f"9 rows at row stride 2051 {tag}",
             lambda x=xs, sc=scale: (fu.add_rms_norm(x, None, sc, 1e-6),),
             lambda x=xs, sc=scale: (ref.rms_norm(x, sc, 1e-6),)),
        ]
        for B, S, pct, bias, pos in (
                (2, 512, 1.0, True, torch.arange(512, device="cuda")),
                (4, 1, 1.0, True,
                 torch.tensor(4093, dtype=torch.int32, device="cuda").reshape(1, 1).expand(4, 1)),
                (2, 512, 0.5, False, torch.arange(512, device="cuda"))):
            q, k, v = (randn(10 + i, B, S, n, 128, dtype=dt) for i, n in enumerate((16, 2, 2)))
            bs = ([randn(20 + i, n * 128, dtype=dt, scale=0.5) for i, n in enumerate((16, 2, 2))]
                  if bias else [None] * 3)
            cases.append(("qkv_bias_rope", f"({B},{S},16/2/2,128) pct {pct} bias {bias} {tag}",
                          lambda q=q, k=k, v=v, bs=bs, pos=pos, pct=pct:
                          fu.qkv_bias_rope(q, k, v, *bs, pos, 1e6, pct),
                          lambda q=q, k=k, v=v, bs=bs, pos=pos, pct=pct:
                          ref.qkv_bias_rope(q, k, v, *bs, pos, 1e6, pct)))
        qm, kv = randn(30, 1, 512, 16, 192, dtype=dt), randn(31, 1, 512, 576, dtype=dt)
        pos = torch.arange(512, device="cuda")
        for name, t in (("q", qm[..., 128:]), ("k", kv[..., 512:].reshape(1, 512, 1, 64))):
            cases.append(("qkv_bias_rope", f"MLA rope slice of {name} {tuple(t.shape)} {tag}",
                          lambda t=t: (ops.rope(t, pos, 1e4),),
                          lambda t=t: (ref.rope(t, pos, 1e4),)))
        g, u = randn(40, 2, 512, 11008, dtype=dt, scale=3.0), randn(41, 2, 512, 11008, dtype=dt)
        gu = randn(42, 37, 2 * 11008, dtype=dt, scale=3.0)
        g100, u100 = randn(43, 15, 100, dtype=dt, scale=3.0), randn(44, 15, 100, dtype=dt)
        for name, a, b in (("(2,512,11008)", g, u), ("37 rows of a merged gate|up", gu[:, :11008],
                                                     gu[:, 11008:]), ("(15,100)", g100, u100)):
            cases.append(("swiglu", f"{name} {tag}", lambda a=a, b=b: (fu.swiglu(a, b),),
                          lambda a=a, b=b: (ref.swiglu(a, b),)))
    return cases


def fused_vs_plain() -> dict:
    """Each fused pass against its plain chain: the residual sum bit-exact,
    every other output within 1 ulp in bf16 and 4 in fp32, the norm's 32 (the
    order of its fp32 mean of squares and a libm call's last bit are all
    that may differ)."""
    out = {name: [] for name in FUSED}
    for kernel, name, run, plain in fused_cases():
        got, want = run(), plain()
        torch.cuda.synchronize()
        worst = max(ulps(a, b) for a, b in zip(got, want))
        equal = sum(int((a == b).sum()) for a, b in zip(got, want)) / sum(
            b.numel() for b in want)
        exact = kernel != "add_rms_norm" or len(got) == 1 or torch.equal(got[0], want[0])
        limit = 1 if got[0].dtype == torch.bfloat16 else (32 if kernel == "add_rms_norm" else 4)
        log(f"  {kernel} {name}: {worst} ulps at most, {100 * equal:.4f}% of values equal"
            + ("; residual sum bit-exact" if len(got) == 2 and kernel == "add_rms_norm" else "")
            + (" ok" if worst <= limit and exact else " FAIL"))
        assert worst <= limit and exact, f"{kernel} disagrees: {name}"
        out[kernel].append(dict(case=name, max_ulps=worst, equal_share=equal))
    return out


def fused_timing(device_line: str) -> dict:
    """Each fused pass at prefill_batch32's longest call, (32, 1024) tokens of
    qwen2.5-3b in bf16: CUDA-event and profiler device time, the bytes bound
    at HBM_BYTES_PER_S (each input read once, each output written once), and
    the plain chain it replaces."""
    m = FUSED_TIMING
    rows, d = m["rows"], m["d"]
    x, r = randn(50, rows, d), randn(51, rows, d)
    scale = randn(52, d, dtype=torch.float32, scale=0.1) + 1.0
    q = randn(53, 32, 1024, m["hq"], m["hd"])
    k, v = (randn(54 + i, 32, 1024, m["hkv"], m["hd"]) for i in range(2))
    bs = [randn(60 + i, n * m["hd"]) for i, n in enumerate((m["hq"], m["hkv"], m["hkv"]))]
    pos = torch.arange(1024, device="cuda")
    calls = {
        "rms_norm": (lambda: fu.add_rms_norm(x, None, scale, 1e-6),
                     lambda: ref.rms_norm(x, scale, 1e-6), nbytes(x) * 2),
        "add_rms_norm": (lambda: fu.add_rms_norm(x, r, scale, 1e-6),
                         lambda: ref.add_rms_norm(x, r, scale, 1e-6), nbytes(x) * 4),
        "qkv_bias_rope": (lambda: fu.qkv_bias_rope(q, k, v, *bs, pos, 1e6),
                          lambda: ref.qkv_bias_rope(q, k, v, *bs, pos, 1e6),
                          2 * nbytes(q, k, v) + nbytes(*bs)),
    }
    out = {}
    for name, (run, plain, nb) in calls.items():
        out[name] = fused_time_one(name, run, plain, nb, device_line)
    del x, r, q, k, v
    torch.cuda.empty_cache()
    gate, up = randn(70, rows, m["ff"], scale=3.0), randn(71, rows, m["ff"])
    out["swiglu"] = fused_time_one("swiglu", lambda: fu.swiglu(gate, up),
                                   lambda: ref.swiglu(gate, up), nbytes(gate) * 3, device_line)
    del gate, up
    torch.cuda.empty_cache()
    return out


def fused_time_one(name: str, run, plain, nb: int, device_line: str) -> dict:
    kernel_ms = cuda_ms(run, iters=20)
    dev_ms, how = device_time(run)
    plain_ms = cuda_ms(plain, iters=10)
    plain_dev_ms, plain_how = device_time(plain)
    bound_ms = nb / HBM_BYTES_PER_S * 1e3
    log(f"  [{device_line}] {name} bf16 at (32, 1024) tokens: kernel {kernel_ms:.4f} ms "
        f"(device {dev_ms:.4f} ms, {how}), plain chain {plain_ms:.4f} ms (device "
        f"{plain_dev_ms:.4f} ms, {plain_how}), bound {bound_ms:.4f} ms (bytes: "
        f"{nb / 1e6:.2f} MB); {nb / dev_ms / 1e6:.1f} GB/s = {100 * bound_ms / dev_ms:.2f}% of "
        f"the bytes bound; plain / kernel {plain_dev_ms / dev_ms:.2f}")
    return dict(ms=kernel_ms, device_ms=dev_ms, plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
                bound_ms=bound_ms, bound_by="bytes", bytes=nb)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(bound ms, what bounds it): the larger of operations over the peak for
    their type and bytes over the memory rate."""
    flop_ms, byte_ms = flops / peak_flops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max((flop_ms, "operations"), (byte_ms, "bytes"))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def backward_timing(name: str, shape: str, fn, iters: int, device_line: str) -> float:
    """CUDA-event time per call of a kernel's backward: its plain version's
    VJP, recomputed from the inputs."""
    ms = cuda_ms(fn, iters=iters, warmup=1)
    log(f"  [{device_line}] {name} backward (plain VJP) at {shape}: {ms:.4f} ms per call")
    return ms


def flash_timing(device_line: str):
    """The main (qwen2.5-3b) shape and the hybrid (recurrentgemma-9b) shape."""
    m = MAIN
    q, k, v = qkv(SEED, **m, dv=m["d"], dtype=torch.bfloat16)
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=20)
    dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    # the same inputs 2 bytes past an aligned start take the CUDA-core variant
    qu, ku, vu = (torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
                  .view(t.shape).copy_(t) for t in (q, k, v))
    core_ms = cuda_ms(lambda: fa.flash_attention(qu, ku, vu, causal=True), iters=5)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), iters=10)
    kr = ref.repeat_kv(k, m["hq"])
    vr = ref.repeat_kv(v, m["hq"])
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), iters=20)
    # work this run's inputs need: the causal mask leaves S(S+1)/2 key-query
    # pairs per head, each 2*D FLOPs for QK^T and 2*Dv for PV
    pairs = m["s"] * (m["s"] + 1) / 2
    flops = 2.0 * m["b"] * m["hq"] * pairs * (m["d"] + m["d"])
    nb = nbytes(q, k, v) + q.numel() * 2
    bound_ms, bound_by = bound(flops, nb, PEAK_BF16_FLOPS)
    log(f"  [{device_line}] flash_attention bf16 (1,16,2048,128) causal: kernel "
        f"{kernel_ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, {nb / 1e6:.2f} MB); "
        f"kernel at {flops / kernel_ms / 1e9:.1f} TFLOP/s = "
        f"{100 * bound_ms / kernel_ms:.2f}% of the bf16 roofline, kernel / SDPA = "
        f"{kernel_ms / library_ms:.3f}; "
        f"{flops / core_ms / 1e9:.1f} TFLOP/s on the CUDA-core variant ({core_ms:.4f} ms, "
        f"{100 * flops / core_ms / 1e9 / (PEAK_FP32_FLOPS / 1e12):.1f}% of the fp32 peak)")

    # the model's own call in phase 4's prefill: transposed (B, S, H, D) views
    pf = PREFILL
    q, k, v = qkv_heads_last(SEED + 2, **pf, dv=pf["d"], dtype=torch.bfloat16)
    pf_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=50)
    pf_dev = device_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    pf_plain = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True), iters=10)
    kr = ref.repeat_kv(k, pf["hq"])
    vr = ref.repeat_kv(v, pf["hq"])
    pf_lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), iters=50)
    pf_flops = 2.0 * pf["b"] * pf["hq"] * pf["s"] * (pf["s"] + 1) / 2 * (pf["d"] + pf["d"])
    pf_bytes = nbytes(q, k, v) + q.numel() * 2
    pf_bound, pf_by = bound(pf_flops, pf_bytes, PEAK_BF16_FLOPS)
    log(f"  [{device_line}] flash_attention bf16 (2,16,2,512,128) causal on (B,S,H,D) views "
        f"(the qwen prefill's call): kernel {pf_ms:.4f} ms (device {pf_dev:.4f} ms), plain {pf_plain:.4f} ms, SDPA "
        f"{pf_lib:.4f} ms, bound {pf_bound:.4f} ms ({pf_by}: {pf_flops / 1e9:.3f} GFLOP, "
        f"{pf_bytes / 1e6:.2f} MB); kernel at {pf_flops / pf_ms / 1e9:.1f} TFLOP/s = "
        f"{100 * pf_bound / pf_ms:.2f}% of the bf16 roofline (device: "
        f"{pf_flops / pf_dev / 1e9:.1f} TFLOP/s); kernel / SDPA = {pf_ms / pf_lib:.3f}")
    scale = 1.0 / math.sqrt(pf["d"])
    grad = torch.randn_like(fa.flash_attention(q, k, v, causal=True))   # the output's layout
    pf_bwd = backward_timing(
        "flash_attention", "the qwen training call (2,16,2,512,128) bf16 on (B,S,H,D) views",
        lambda: fa.flash_attention_vjp(q, k, v, grad, causal=True, window=0, scale=scale),
        10, device_line)

    h = HYBRID
    q, k, v = qkv(SEED + 1, h["b"], h["hq"], h["hkv"], h["s"], h["d"], h["d"], torch.bfloat16)
    w = h["window"]
    hy_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=w), iters=10)
    hy_dev = device_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=w))
    hy_plain = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True, window=w), iters=3)
    kr = ref.repeat_kv(k, h["hq"])
    vr = ref.repeat_kv(v, h["hq"])
    # SDPA has no sliding-window flag: the window goes in as a boolean mask
    pos = torch.arange(h["s"], device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
    hy_lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, attn_mask=mask), iters=10)
    # key-query pairs the window leaves: min(i + 1, window) for query i
    pairs = float(torch.clamp(pos + 1, max=w).sum())
    hy_flops = 2.0 * h["b"] * h["hq"] * pairs * (h["d"] + h["d"])
    hy_bytes = nbytes(q, k, v) + q.numel() * 2
    hy_bound, hy_by = bound(hy_flops, hy_bytes, PEAK_BF16_FLOPS)
    log(f"  [{device_line}] flash_attention bf16 (1,16,1,4096,256) window 2048: kernel "
        f"{hy_ms:.4f} ms (device {hy_dev:.4f} ms), plain {hy_plain:.4f} ms, SDPA with a mask {hy_lib:.4f} ms, bound "
        f"{hy_bound:.4f} ms ({hy_by}: {hy_flops / 1e9:.2f} GFLOP, {hy_bytes / 1e6:.2f} MB); "
        f"kernel at {hy_flops / hy_ms / 1e9:.1f} TFLOP/s = "
        f"{100 * hy_bound / hy_ms:.2f}% of the bf16 roofline, kernel / SDPA = "
        f"{hy_ms / hy_lib:.3f}")
    scale = 1.0 / math.sqrt(h["d"])
    grad = torch.randn_like(fa.flash_attention(q, k, v, causal=True, window=w))
    hy_bwd = backward_timing(
        "flash_attention", "the recurrentgemma training call (1,16,1,4096,256) window 2048",
        lambda: fa.flash_attention_vjp(q, k, v, grad, causal=True, window=w, scale=scale),
        3, device_line)
    del q, k, v, kr, vr, mask, grad
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, device_ms=dev_ms, cuda_core_ms=core_ms,
                backward_ms=pf_bwd, backward_at="qwen training call (2,16,2,512,128) bf16",
                prefill=dict(ms=pf_ms, plain_ms=pf_plain, library_ms=pf_lib, bound_ms=pf_bound,
                             bound_by=pf_by, device_ms=pf_dev, backward_ms=pf_bwd),
                hybrid=dict(ms=hy_ms, plain_ms=hy_plain, library_ms=hy_lib, bound_ms=hy_bound,
                            bound_by=hy_by, device_ms=hy_dev, backward_ms=hy_bwd),
                mla=mla_timing(device_line), **cross_family_timing(device_line))


def sdpa_backends(q, k, v, scale: float, iters: int, causal: bool = True) -> dict:
    """Each SDPA backend on these inputs (the mask and scale given): its ms by
    CUDA events, or the reason it gave for refusing them."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                sdpa(q, k, v, is_causal=causal, scale=scale)
            except RuntimeError as e:   # "No available kernel": the warnings say why
                msgs = [str(w.message).split(" (Triggered internally")[0] for w in caught]
                why = [m for m in msgs if "not used because" not in m
                       and "runtime disabled" not in m]
                out[backend.name] = f"refused: {'; '.join(why) or str(e).splitlines()[0]}"
                continue
            out[backend.name] = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal, scale=scale),
                                        iters=iters)
    return out


def views_timing(label: str, shape: dict, causal: bool, seed: int, device_line: str,
                 plain_iters: int, scale: float | None = None) -> dict:
    """One model call of the kernel, bf16 on (B, S, H, D) views: its ms by
    CUDA events and on the device, the plain version's ms, SDPA's ms on each
    backend and as a user calls it (k and v repeated to the q heads where
    Hkv < Hq), and the bound."""
    q, k, v = qkv_heads_last(seed, **shape, dtype=torch.bfloat16)
    scale = scale if scale is not None else 1.0 / math.sqrt(shape["d"])
    call = lambda: fa.flash_attention(q, k, v, causal=causal, scale=scale)  # noqa: E731
    kernel_ms = cuda_ms(call, iters=20)
    dev_ms = device_ms(call)
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, causal=causal, scale=scale),
                       iters=plain_iters, warmup=1)
    kr, vr = ref.repeat_kv(k, shape["hq"]), ref.repeat_kv(v, shape["hq"])
    backends = sdpa_backends(q, kr, vr, scale, iters=5, causal=causal)
    accepted = [b for b, t in backends.items() if not isinstance(t, str)]
    # the library call: SDPA as a user calls it, on whichever backend it picks
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=causal, scale=scale), iters=5) if accepted else None
    # key-query pairs the mask leaves, each 2 D FLOPs for QK^T and 2 Dv for PV;
    # q, k, v read once and the (B, Hq, S, Dv) output written once
    s_ = shape["s"]
    pairs = s_ * (s_ + 1) / 2 if causal else float(s_ * s_)
    flops = 2.0 * shape["b"] * shape["hq"] * pairs * (shape["d"] + shape["dv"])
    nb = nbytes(q, k, v) + shape["b"] * shape["hq"] * s_ * shape["dv"] * 2
    bound_ms, bound_by = bound(flops, nb, PEAK_BF16_FLOPS)
    log(f"  [{device_line}] flash_attention bf16 {label} on (B,S,H,D) views, variant "
        f"{fa.route(q, k, v)}: kernel {kernel_ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, SDPA {'none' if library_ms is None else f'{library_ms:.4f} ms'}"
        f", bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, {nb / 1e6:.2f} MB); "
        f"kernel at {flops / kernel_ms / 1e9:.1f} TFLOP/s (device: "
        f"{flops / dev_ms / 1e9:.1f}) = {100 * bound_ms / kernel_ms:.2f}% of the bf16 roofline"
        + ("" if library_ms is None else f", kernel / SDPA = {kernel_ms / library_ms:.3f}"))
    log(f"    SDPA backends: {json.dumps(backends)}")
    del q, k, v, kr, vr
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, device_ms=dev_ms, sdpa_backends=backends)


def mla_timing(device_line: str) -> dict:
    """The deepseek-v2 MLA prefill's call: (1, 128, 4096), D 192, Dv 128,
    bf16, causal, scale 1/sqrt(192); SDPA's flash backend refuses Dv != D."""
    return views_timing("(1,128,4096,192/128) causal scale 1/sqrt(192) (the deepseek-v2 MLA "
                        "prefill's call)", MLA_MAIN, True, SEED + 3, device_line, plain_iters=2,
                        scale=1.0 / math.sqrt(MLA_MAIN["d"]))


def cross_family_timing(device_line: str) -> dict:
    """The audio and VLM families' calls: the Whisper encoder's non-causal
    attention over 1500 frames, the Whisper decoder's causal prefill at its
    448-token context, and the VLM's 64 q heads over 8 kv heads."""
    return dict(
        whisper_encoder=views_timing("(4,16,16,1500,64) non-causal (the Whisper encoder's call)",
                                     WHISPER_ENC, False, SEED + 4, device_line, plain_iters=3),
        whisper_decoder=views_timing("(4,16,16,448,64) causal (the Whisper decoder's prefill)",
                                     WHISPER_DEC, True, SEED + 5, device_line, plain_iters=10),
        vlm_decoder=views_timing("(1,64,8,4096,128) causal (the VLM's self-attention prefill)",
                                 VLM_DEC, True, SEED + 6, device_line, plain_iters=2))


def ssd_timing(device_line: str):
    m = SSD_MAIN
    B, L, H, P, G, N, Q = (m[k] for k in ("B", "L", "H", "P", "G", "N", "chunk"))
    args = ssd_inputs(SEED, B, L, H, P, G, N, dtype=torch.bfloat16)
    kernel_ms = cuda_ms(lambda: ss.ssd_scan(*args, chunk=Q), iters=10)
    dev_ms = device_ms(lambda: ss.ssd_scan(*args, chunk=Q))
    plain_ms = cuda_ms(lambda: ref.ssd_chunked_ref(*args, Q), iters=3)
    # work the function needs per chunk: C B^T over the causal triangle once
    # per (batch, group), and per (batch, head) the gate times x dt over the
    # triangle, the carried state's term C h^T and the state update
    nc, tri = L // Q, Q * (Q + 1) / 2
    flops = (B * G * nc * tri * N * 2.0
             + B * H * nc * (tri * P * 2.0 + 2 * Q * N * P * 2.0))
    y_bytes = args[0].numel() * args[0].element_size()
    nb = nbytes(*args) + y_bytes + B * H * P * N * 4
    bound_ms, bound_by = bound(flops, nb, PEAK_BF16_FLOPS)
    log(f"  [{device_line}] ssd_scan (2,2048,24,64,G1,N128,Q256) bf16 x/B/C, fp32 dt/a: "
        f"kernel {kernel_ms:.4f} ms (device {dev_ms:.4f} ms), plain (chunked) "
        f"{plain_ms:.4f} ms, library: none, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP at the bf16 rate, "
        f"{nb / 1e6:.2f} MB); {flops / kernel_ms / 1e9:.2f} TFLOP/s, "
        f"{100 * bound_ms / kernel_ms:.2f}% of the roofline; variant "
        f"{ss.route(*args, Q)}, {B * H * nc} blocks per chunk pass on 132 SMs")
    profile_call(lambda: ss.ssd_scan(*args, chunk=Q), "one ssd_scan call", device_line)
    grad = torch.randn_like(args[0])
    bwd = backward_timing("ssd_scan", "the mamba2 training call (2,2048,24,64,G1,N128,Q256)",
                          lambda: ss.ssd_scan_vjp(*args, grad, None, chunk=Q), 3, device_line)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, device_ms=dev_ms, backward_ms=bwd,
                backward_at="mamba2 training call (2,2048,24,64,G1,N128,Q256)")


def rglru_timing(device_line: str):
    """fp32 and bf16 at the main shape, each beside torch.add(a, b): an
    elementwise pass that moves the same bytes, as a yardstick of the
    bandwidth a kernel can reach (it computes another function, so it is no
    library_ms)."""
    out = {}
    for key, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        a, b = rglru_inputs(SEED, **RGLRU_MAIN, dtype=dtype)
        add_ms = cuda_ms(lambda: torch.add(a, b), iters=50)
        kernel_ms = cuda_ms(lambda: rg.rglru_scan(a, b), iters=50)
        add_ms = (add_ms + cuda_ms(lambda: torch.add(a, b), iters=50)) / 2
        dev_ms = device_ms(lambda: rg.rglru_scan(a, b))
        plain_ms = cuda_ms(lambda: ref.rglru_ref(a, b), iters=3)
        flops = 2.0 * a.numel()                   # one multiply-add per element
        nb = nbytes(a, b) + b.numel() * b.element_size()
        bound_ms, bound_by = bound(flops, nb, PEAK_FP32_FLOPS)
        log(f"  [{device_line}] rglru_scan (1,4096,4096) {key}: kernel {kernel_ms:.4f} ms "
            f"(device {dev_ms:.4f} ms), plain (log-depth scan) {plain_ms:.4f} ms, library: "
            f"none, bound {bound_ms:.4f} ms ({bound_by}: {nb / 1e6:.2f} MB, "
            f"{flops / 1e6:.1f} MFLOP); {nb / kernel_ms / 1e6:.1f} GB/s, "
            f"{100 * bound_ms / kernel_ms:.2f}% of the roofline; same-bytes elementwise "
            f"pass torch.add(a, b) {add_ms:.4f} ms ({nb / add_ms / 1e6:.1f} GB/s): the kernel "
            f"reaches {100 * add_ms / kernel_ms:.2f}% of its rate")
        out[key] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                        bound_by=bound_by, device_ms=dev_ms, same_bytes_add_ms=add_ms)
    a, b = rglru_inputs(SEED, **RGLRU_MAIN, dtype=torch.float32)
    grad = torch.randn_like(b)
    bwd = backward_timing("rglru_scan", "the recurrentgemma training call (1,4096,4096) fp32",
                          lambda: rg.rglru_scan_vjp(a, b, grad), 5, device_line)
    return dict(out["fp32"], bf16=out["bf16"], backward_ms=bwd,
                backward_at="recurrentgemma training call (1,4096,4096) fp32")


def phase_prefill(model, params, batch: int, seq: int, device_line: str) -> dict:
    """Two prefills from zeroed counts (the audio and VLM families over their
    frames or image tokens); returns the launches of both, checked against
    one launch of each kernel per layer that runs it."""
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device="cuda",
                           dtype=torch.int32)
    inputs = {"tokens": tokens, **memory_inputs(cfg, batch)}
    reset_counts()
    fused_before = read_fused()
    times = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _, cache = model.forward(params, inputs, mode="prefill")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    fused_per_call = {k: (n - fused_before[k]) // 2 for k, n in read_fused().items()}
    launches = read_counts()
    variants = read_variants()
    expected = expected_launches(model)
    assert launches == {k: 2 * n for k, n in expected.items()}, (launches, expected)
    # the bf16 prefill runs on the redesigned variants, and only on them
    assert variants["flash_attention"]["wgmma"] == launches["flash_attention"], variants
    assert variants["ssd_scan"]["tensor_core"] == launches["ssd_scan"], variants
    assert logits.shape == (batch, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[:, :cfg.vocab_size].float()).all()), "non-finite logits"
    shapes = {path: tuple(t.shape) for path, t in leaves(cache).items()}
    want = reference_cache_shapes(model, batch, seq)
    assert shapes == want, (shapes, want)
    log(f"  prefill ({batch}, {seq}): launches per call "
        f"{ {k: n // 2 for k, n in launches.items()} }, by variant over both calls "
        f"{variants}; cache {shapes}")
    log(f"  [{device_line}] wall {times[0]:.4f} s first call, {times[1]:.4f} s second")
    log(f"  fused passes per call {fused_per_call}")
    with torch.no_grad():
        profile_call(lambda: model.forward(params, inputs, mode="prefill"),
                     f"one prefill ({batch}, {seq})", device_line)
        table = fused_launch_table(lambda: model.forward(params, inputs, mode="prefill"),
                                   f"one prefill ({batch}, {seq})")
    return dict(launches=launches, variants=variants, wall_s=times,
                fused_launches=fused_per_call, launches_before_after=table)


def expected_launches(model) -> dict:
    """One launch per layer whose mixer runs the kernel: every self-attention
    layer (the Whisper encoder's too), none of the cross-attention layers."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        kinds = ([k for _ in range(model._n_super) for k in model._pattern]
                 + [model._tail_kind(t) for t in range(model._n_tail)])
    elif cfg.family == "audio":
        kinds = ["attn"] * (cfg.encoder_layers + cfg.num_layers)
    elif cfg.family == "vlm":
        kinds = ["attn"] * (model._n_super * (cfg.cross_attn_every - 1))
    else:
        kinds = [cfg.family] * cfg.num_layers
    per_kind = {"dense": "flash_attention", "moe": "flash_attention", "attn": "flash_attention",
                "ssm": "ssd_scan", "rec": "rglru_scan"}
    return {name: sum(per_kind[k] == name for k in kinds) for name in KERNELS}


def expected_step_launches(model, remat: bool) -> dict:
    """Launches of one loss gradient: each layer's forward, and under remat
    its recompute too, but for the Whisper encoder, which the reference's
    remat does not cover."""
    per_forward = expected_launches(model)
    if not remat:
        return per_forward
    once = model.cfg.encoder_layers if model.cfg.family == "audio" else 0
    return {k: 2 * n - (once if k == "flash_attention" else 0) for k, n in per_forward.items()}


def memory_inputs(cfg, batch: int) -> dict:
    """The audio family's frames or the VLM's image tokens, (batch, M,
    d_model) standard normal in the model's dtype on the card (the
    frontends are stubs, as in the reference); {} for the other families."""
    if cfg.family not in ("audio", "vlm"):
        return {}
    m = cfg.num_frames if cfg.family == "audio" else cfg.num_image_tokens
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    arr = torch.randn((batch, m, cfg.d_model), generator=g, device="cuda").to(cfg.torch_dtype)
    return {"frames" if cfg.family == "audio" else "images": arr}


def open_gates(params) -> None:
    """Every gated cross layer's gate set to GATE, in place (the VLM's init
    puts 0 there, and tanh(0) = 0 would make every cross layer add nothing)."""
    with torch.no_grad():
        for path, leaf in leaves(params).items():
            if path.endswith("/gate"):
                leaf.fill_(GATE)


def leaves(tree, path="") -> dict:
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in leaves(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, t in enumerate(tree) for p, v in leaves(t, f"{path}/{i}").items()}
    return {path: tree}


def reference_cache_shapes(model, batch: int, seq: int) -> dict:
    """The reference's prefill cache shapes (``repro.models.model.forward``)."""
    cfg = model.cfg
    if cfg.family == "audio":   # ((k, v), (xk, xv)) stacked over the decoder layers
        kv = (cfg.num_layers, batch, cfg.num_kv_heads, seq, cfg.head_dim_)
        xkv = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.num_frames, cfg.head_dim_)
        return {"/dec/0/0": kv, "/dec/0/1": kv, "/dec/1/0": xkv, "/dec/1/1": xkv}
    if cfg.family == "vlm":     # {"self{j}": (k, v), "cross": (xk, xv)} per super-block
        kv = (model._n_super, batch, cfg.num_kv_heads, seq, cfg.head_dim_)
        xkv = (model._n_super, batch, cfg.num_kv_heads, cfg.num_image_tokens, cfg.head_dim_)
        out = {f"/super/self{j}/{i}": kv for j in range(cfg.cross_attn_every - 1)
               for i in range(2)}
        return dict(out, **{"/super/cross/0": xkv, "/super/cross/1": xkv})
    if cfg.family in ("dense", "moe"):
        fd = cfg.first_dense_layers if cfg.family == "moe" else 0
        if cfg.use_mla:     # (c_kv, k_rope)
            per_layer = ((batch, seq, cfg.kv_lora_rank), (batch, seq, cfg.qk_rope_head_dim))
        else:               # (k, v)
            per_layer = ((batch, cfg.num_kv_heads, seq, cfg.head_dim_),) * 2
        out = {f"/kv/{i}": (cfg.num_layers - fd,) + shape for i, shape in enumerate(per_layer)}
        if fd:
            out.update({f"/dense_kv/{i}": (fd,) + shape for i, shape in enumerate(per_layer)})
        return out
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        nconv = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        return {"/ssm_states/conv": (cfg.num_layers, batch, cfg.ssm_conv - 1, nconv),
                "/ssm_states/ssm": (cfg.num_layers, batch, d_inner // cfg.ssm_head_dim,
                                    cfg.ssm_head_dim, cfg.ssm_state)}
    W = cfg.lru_width or cfg.d_model
    kv = (batch, cfg.num_kv_heads, cfg.local_window, cfg.head_dim_)
    rec = {"conv": (batch, 3, W), "h": (batch, W)}
    out = {}
    for j, kind in enumerate(model._pattern):
        for name, shape in (rec.items() if kind == "rec" else (("0", kv), ("1", kv))):
            out[f"/super/b{j}/{name}"] = (model._n_super,) + shape
    for t in range(model._n_tail):
        for name, shape in (rec.items() if model._tail_kind(t) == "rec"
                            else (("0", kv), ("1", kv))):
            out[f"/tail{t}/{name}"] = shape
    return out


def _profile_once(fn) -> tuple:
    """(key_averages, wall us) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof.key_averages(), wall_us


def profile_call(fn, label: str, device_line: str) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and the
    device time under each kernel's backward range; returns the wall, busy
    and backward times in ms (empty where no device time was recorded).

    The profiler loses kernel events now and then (see ``device_time``): a
    profile is whole only if it holds every launch that the wrappers counted
    during the call. One that holds fewer is taken again, up to
    PROFILE_ATTEMPTS times; the last is kept with ``whole: false`` in the
    log and the results (its busy time and counts are then lower bounds).
    A call that launches none of the repo's kernels cannot be held so:
    ``whole: null``. A retake calls ``fn`` again, so ``fn`` must leave what
    it reads as it found it, or say itself what each call did (the training
    step counts the steps it takes)."""
    ranges = set(BACKWARD_RANGES.values())
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before, fused_before = read_counts(), read_fused()
        events, wall_us = _profile_once(fn)
        launched = {k: n - before[k] for k, n in read_counts().items()}
        fused_launched = {k: n - fused_before[k] for k, n in read_fused().items()}
        # the backward ranges also appear on the device's timeline as annotations,
        # which are spans, not kernels: they stay out of the busy time
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges]
        kept = {name: sum(e.count for e in kernels if any(sym in e.key for sym in syms))
                for name, syms in KERNEL_SYMBOLS.items()}
        whole = (kept == launched) if any(launched.values()) else None
        if whole is not False:
            break
        log(f"  profile of {label}, attempt {attempt}: kept {kept} of the wrappers' "
            f"{launched} launches")
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"  profile of {label}: no device time recorded; breakdown not measured")
        return {}
    verdict = {True: "whole", None: "not checkable (no launch of the repo's kernels)",
               False: f"whole: false after {attempt} attempts (a lower bound)"}[whole]
    fused_kept = {name: sum(e.count for e in kernels if FUSED_SYMBOLS[name] in e.key)
                  for name in FUSED}
    log(f"  profile [{device_line}] {label} under the profiler: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% of wall), "
        f"{sum(e.count for e in kernels)} kernel launches; {verdict}; fused passes: kernel "
        f"events {fused_kept}, wrapper launches {fused_launched}")
    # copies (layout changes such as .contiguous()): PyTorch's copy kernels
    copies = [e for e in kernels if "copy" in e.key.lower()]
    log(f"    copy kernels: {sum(e.count for e in copies)} launches, "
        f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms")
    for e in copies:
        log(f"      x{e.count:<4d} {e.key[:100]}")
    # cuDNN's own layout transforms, which do not say "copy"
    layout = [e for e in kernels if any(k in e.key.lower() for k in ("nchwtonhwc", "nhwctonchw"))]
    log(f"    cuDNN layout transforms: {sum(e.count for e in layout)} launches, "
        f"{sum(e.self_device_time_total for e in layout) / 1e3:.3f} ms")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the eight largest, and this repo's kernels wherever they rank
    ours = [e for e in ranked[8:] if any(k in e.key for k in ("flash_fwd", "ssd_", "rglru_fwd",
                                                               *FUSED_SYMBOLS.values()))]
    for e in ranked[:8] + ours:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {100 * e.self_device_time_total / busy_us:5.1f}%"
            f"  x{e.count:<4d} {e.key[:90]}")
    out = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, whole=whole, attempts=attempt,
               kept_launches=kept, wrapper_launches=launched, fused_kept=fused_kept,
               fused_launches=fused_launched,
               launches=sum(e.count for e in kernels),
               copy_launches=sum(e.count for e in copies),
               layout_launches=sum(e.count for e in layout), backward_ms={})
    for name, rng in BACKWARD_RANGES.items():
        host = [e for e in events if e.key == rng and e.device_type != torch.autograd.DeviceType.CUDA]
        if not host:
            continue
        dev_us = sum(e.device_time_total for e in host)
        calls = sum(e.count for e in host)
        log(f"    {name} backward (plain VJP): {calls} calls, device "
            f"{dev_us / 1e3:.3f} ms ({100 * dev_us / busy_us:.1f}% of busy), host "
            f"{sum(e.cpu_time_total for e in host) / 1e3:.3f} ms"
            + ("" if dev_us > 0 else "; device time under the range not recorded"))
        out["backward_ms"][name] = dict(calls=calls, device_ms=dev_us / 1e3)
    return out


def phase_consistency(cfg) -> float:
    """fp32 train forward (through the kernels) against 16 decode steps; MoE
    at the reference test's capacity factor 16 (tests/test_models.py:84-92),
    since the forward drops tokens at capacity and single-token decode never
    does. The audio and VLM families decode after ``fill_cross_cache`` from
    the forward's own frames or image tokens, the VLM's gate at GATE."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.family == "moe":
        cfg32 = dataclasses.replace(cfg32, capacity_factor=16.0)
    model = Model(cfg32)
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    open_gates(params)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), generator=g, device="cuda",
                           dtype=torch.int32)
    mem = memory_inputs(cfg32, 1)
    v = cfg.vocab_size
    with torch.no_grad():
        reset_counts()
        fwd, _, _ = model.forward(params, {"tokens": tokens, **mem}, mode="train")
        assert read_counts() == expected_launches(model), read_counts()
        cache, _ = model.init_cache(1, 32, device="cuda")
        for m in mem.values():
            cache = model.fill_cross_cache(params, cache, m)
        err = 0.0
        for t in range(16):
            logits, cache = model.decode_step(params, tokens[:, t], cache)
            err = max(err, float((logits[0, :v] - fwd[0, t, :v]).abs().max()))
    torch.cuda.synchronize()
    log(f"  fp32 {cfg.name} ({cfg.num_layers} layers, {model.param_count(params) / 1e9:.3f} B "
        f"parameters) train forward ({expected_launches(model)}) vs 16 decode steps: "
        f"max|dlogit| = {err:.3e} (bound 2e-3); max allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    assert err < 2e-3, f"prefill-vs-decode max err {err}"
    del model, params
    torch.cuda.empty_cache()
    return err


def phase_serving(cfg, params, device_line: str) -> dict:
    """8 requests through the engine in two groups of 4; the kernels launch
    only where a group's cross cache runs the Whisper encoder (one launch per
    encoder layer and group). Then one decode step, timed and profiled."""
    engine = ServingEngine(cfg, params, make_paper_cluster(), max_batch=4, device="cuda")
    reqs = [Request(i, np.arange(3, 19, dtype=np.int32), 8) for i in range(8)]
    groups = 2
    expected = {k: (groups * cfg.encoder_layers if k == "flash_attention"
                    and cfg.family == "audio" else 0) for k in KERNELS}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = read_counts(), read_variants()
    assert m["num_requests"] == 8
    assert all(r.output is not None and r.output.shape == (8,) for r in reqs)
    assert len(m["requests_per_node"]) >= 2, m["requests_per_node"]
    assert m["tokens_per_s"] > 0
    assert launches == expected, (launches, expected)
    assert variants["flash_attention"]["wgmma"] == launches["flash_attention"], variants
    new_tokens = sum(r.max_new_tokens for r in reqs)
    log(f"  [{device_line}] served 8 requests (prompt 16, 8 new tokens, max_batch 4): "
        f"wall {wall:.4f} s, {new_tokens / wall:.2f} generated tokens/s; kernel launches "
        f"{launches} (the engine feeds prompts through decode_step"
        + ("; each group's cross cache runs the encoder" if cfg.family == "audio" else "")
        + f"); max allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("  simulated edge-cluster metrics (cost model, not device time): "
        + json.dumps({k: m[k] for k in m if k != "scheduler"}))
    stub_s = None
    if cfg.family in ("audio", "vlm"):
        # the engine draws each group's memory on the host, as the reference's does
        m_len = cfg.num_frames if cfg.family == "audio" else cfg.num_image_tokens
        t0 = time.perf_counter()
        frontend_stub(cfg.family, 4, m_len, cfg.d_model)
        stub_s = time.perf_counter() - t0
        log(f"  the engine's frontend stub for one group of 4 ({4 * m_len * cfg.d_model / 1e6:.1f} M "
            f"values drawn by numpy on the host): {stub_s:.4f} s")
    # one decode step as the engine runs it: batch 4, cache of P + N + 1 slots
    cache, _ = engine.model.init_cache(4, 25, device="cuda")
    with torch.no_grad():
        for mem in memory_inputs(cfg, 4).values():
            cache = engine.model.fill_cross_cache(params, cache, mem)
    token = torch.zeros(4, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        step_ms = cuda_ms(lambda: engine.model.decode_step(params, token, cache), iters=5,
                          warmup=1)
        log(f"  [{device_line}] one decode step (batch 4): {step_ms:.4f} ms (CUDA events, "
            f"5 steps)")
        profile_call(lambda: engine.model.decode_step(params, token, cache),
                     "one decode step (batch 4)", device_line)
    return dict(wall_s=wall, launches=launches, decode_step_ms=step_ms, frontend_stub_s=stub_s)


def drive(arch: str, first: int, batch: int, seq: int, device_line: str,
          consistency_layers: int = 0, num_layers: int = 0) -> dict:
    """Prefill, fp32 consistency and serving of one model at full width, its
    depth cut to ``num_layers`` where that is given."""
    cfg = get_config(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    depth = f", depth cut to {num_layers}" if num_layers else ""
    log(f"phase {first}: full-width {arch} prefill{depth}")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    open_gates(params)
    log(f"  {model.param_count(params) / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"({torch.cuda.max_memory_allocated() / 1e9:.2f} GB at most during init)")
    torch.cuda.reset_peak_memory_stats()
    out = phase_prefill(model, params, batch, seq, device_line)
    log(f"  max allocated over the prefills {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    cut = f", depth cut to {consistency_layers}" if consistency_layers else ""
    log(f"phase {first + 1}: full-width fp32 prefill vs decode{cut}")
    torch.cuda.reset_peak_memory_stats()
    phase_consistency(dataclasses.replace(cfg, num_layers=consistency_layers or cfg.num_layers))
    log(f"phase {first + 2}: {arch} serving")
    out["serving"] = phase_serving(cfg, params, device_line)
    del model, params
    torch.cuda.empty_cache()
    return out


def loss_grads(model, params, tokens, remat: bool, mem=None):
    """(loss, {path: gradient}) of ``model.loss_fn`` (over the audio or VLM
    memory ``mem`` too, moved to the tokens' device); a leaf that the loss
    does not reach raises."""
    inputs = tree_map(lambda p: p.detach().requires_grad_(), params)
    mem = {k: t.to(tokens.device) for k, t in (mem or {}).items()}
    loss, _ = model.loss_fn(inputs, {"tokens": tokens, **mem}, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(inputs))
    return loss.detach(), dict(zip(leaves(params), grads))


def routing(model, params, tokens) -> list:
    """(probs, top-k experts) of every MoE layer in one forward, in the
    router's fp32 on the device of ``params``."""
    seen, inner = [], moe._dispatch_compute

    def spy(x, router_w, *args, top_k, **kw):
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        seen.append((probs.cpu(), torch.topk(probs, top_k)[1].cpu()))
        return inner(x, router_w, *args, top_k=top_k, **kw)

    moe._dispatch_compute = spy
    try:
        with torch.no_grad():
            model.forward(params, {"tokens": tokens[:, :-1]}, mode="train")
    finally:
        moe._dispatch_compute = inner
    return seen


def routing_flips(model, params, tokens) -> int:
    """Tokens whose top-k experts differ between the card and the CPU, each
    logged with its two probability rows; the count."""
    flips = 0
    cpu = routing(model, params, tokens)
    card = routing(model, tree_map(lambda p: p.cuda(), params), tokens.cuda())
    for layer, ((p_cpu, i_cpu), (p_card, i_card)) in enumerate(zip(cpu, card)):
        for t in torch.nonzero((i_cpu.sort(-1)[0] != i_card.sort(-1)[0]).any(-1)).ravel():
            flips += 1
            log(f"  top-k flip: MoE layer {layer}, token {int(t)}: CPU experts "
                f"{i_cpu[t].tolist()} probs {p_cpu[t].tolist()}; card experts "
                f"{i_card[t].tolist()} probs {p_card[t].tolist()}")
    return flips


def phase_grads() -> dict:
    """Queue C item 1: loss gradients on the card, through the kernels'
    autograd Functions, against the CPU's plain path on the same fp32
    parameters and tokens; every leaf finite and within 1e-4. For the MoE
    archs the router's top-k on both devices is compared first (the scatter
    and gather backward then run on the card too). Whisper's encoder runs
    flash's backward through the non-causal mask; the VLM runs at 4 layers
    (two super-blocks) with its gate at GATE."""
    out = {}
    for arch in ("qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v2-236b",
                 "kimi-k2-1t-a32b", "whisper-medium", "llama-3.2-vision-90b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, num_layers=4)
        model = Model(cfg)
        params, _ = model.init(torch.Generator().manual_seed(SEED), device="cpu")
        open_gates(params)
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 129))
                                  .astype(np.int32))
        mem = {k: t.cpu() for k, t in memory_inputs(cfg, 2).items()}
        if model.cfg.family == "moe":
            flips = routing_flips(model, params, tokens)
            log(f"  {arch}: router top-k on the card vs the CPU over {2 * 128} tokens per MoE "
                f"layer: {flips} tokens differ")
        worst = 0.0
        for remat in (False, True):
            want_loss, want = loss_grads(model, params, tokens, remat, mem)
            reset_counts()
            got_loss, got = loss_grads(model, tree_map(lambda p: p.cuda(), params),
                                       tokens.cuda(), remat, mem)
            torch.cuda.synchronize()
            launches = read_counts()
            assert launches == expected_step_launches(model, remat), (arch, remat, launches)
            assert abs(float(got_loss) - float(want_loss)) < 1e-4, (arch, remat)
            assert got.keys() == want.keys()
            for path, g in got.items():
                assert bool(torch.isfinite(g).all()), (arch, remat, path)
                g = g.cpu()
                worst = max(worst, float((g - want[path]).abs().max()))
                assert torch.allclose(g, want[path], rtol=1e-4, atol=1e-4), (arch, remat, path)
            log(f"  {arch} reduced fp32 (2, 128 + 1), remat {remat}: {len(got)} leaves, loss "
                f"{float(got_loss):.6f} (CPU {float(want_loss):.6f}), launches in the CUDA "
                f"forward and recompute {launches}")
        log(f"  {arch}: largest |CUDA - CPU| over every gradient leaf {worst:.3e} "
            f"(tolerance 1e-4 rtol and atol)")
        out[arch] = worst
    return out


def phase_train(cfg, batch: int, seq: int, steps: int, device_line: str, *,
                check_moved: bool = False, check_checkpoint: bool = False) -> dict:
    """``steps`` AdamW steps with remat on Markov-corpus batches of (batch,
    seq + 1) tokens, each from zeroed counts, then one more under the
    profiler. Every kernel launches twice per step (forward and recompute)."""
    model = Model(cfg)
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    # a peak lr that moves every bf16 leaf in one step, the unit norm scales
    # included (half a bf16 step at 1.0 is 2^-9)
    opt = adamw(cosine_with_warmup(5e-3, 1, steps + 1))
    state = opt.init(params)
    step_fn = make_train_step(model, opt, remat=True)
    data = batches_for_model(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                             global_batch=batch, seed=SEED))
    expected = expected_step_launches(model, remat=True)
    log(f"  {model.param_count(params) / 1e9:.3f} B parameters in {cfg.dtype}, fp32 moments: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the first step")
    before = ({p: t.to("cpu", copy=True) for p, t in leaves(params).items()}
              if check_moved else None)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(1, steps + 1):
        tokens = torch.from_numpy(next(data)["tokens"]).cuda()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, {"tokens": tokens})
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"  [{device_line}] step {i}: wall {wall:.4f} s, {tokens[:, :-1].numel() / wall:.1f} "
            f"tokens/s, loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, lr {m['lr']:.2e}, "
            f"launches {launches} (expected {expected}), max allocated {peak / 1e9:.2f} GB")
        assert launches == expected, (launches, expected)
        assert math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]), m
        assert m["grad_norm"] > 0, m
        rows.append(dict(m, wall_s=wall, tokens_per_s=tokens[:, :-1].numel() / wall,
                         launches=launches, max_allocated_gb=peak / 1e9))
        if before is not None:
            still = [p for p, t in leaves(params).items() if torch.equal(before[p], t.cpu())]
            assert not still, f"leaves unchanged by step 1: {still}"
            log(f"  every one of the {len(before)} parameter leaves changed in step 1")
            before = None
    tokens = torch.from_numpy(next(data)["tokens"]).cuda()
    # the step updates the parameters and moments in place: each retake of
    # the profile is one more step, carried on from the last
    taken = [params, state]

    def one_more_step():
        taken[:2] = step_fn(*taken[:2], {"tokens": tokens})[:2]
        taken.append(1)

    prof = profile_call(one_more_step, f"one more training step ({batch}, {seq} + 1)",
                        device_line)
    params, state, steps = taken[0], taken[1], steps + len(taken) - 2
    log(f"  the profile took {len(taken) - 2} step(s): {steps} steps in all")
    assert int(state.step) == steps, (int(state.step), steps)
    if check_checkpoint:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            save_checkpoint(tmp, steps, params, state)
            saved = time.perf_counter() - t0
            like = (tree_map(torch.empty_like, params),
                    type(state)(torch.empty_like(state.step),
                                tree_map(torch.empty_like, state.mu),
                                tree_map(torch.empty_like, state.nu)))
            p2, s2, step = restore_checkpoint(tmp, like)
        assert step == steps
        pairs = list(zip(tree_leaves(params) + tree_leaves(state.mu) + tree_leaves(state.nu),
                         tree_leaves(p2) + tree_leaves(s2.mu) + tree_leaves(s2.nu)))
        assert torch.equal(state.step, s2.step)
        for a, b in pairs:
            assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
        log(f"  checkpoint of step {steps} saved in {saved:.2f} s and restored onto the card: "
            f"{len(pairs) + 1} arrays bit-equal (params, moments, step)")
    return dict(steps=rows, profile=prof, launches=rows[0]["launches"])


def phase_mobilenetv2(device_line: str) -> dict:
    """The paper's flow on the card (``examples/quickstart.py``): MobileNetV2
    partitioned, verified and served through the port's DistributedInference,
    then timed and profiled. Reaches none of the repo's kernels."""
    graph = mobilenetv2_graph()
    sizes = {n: ModelPartitioner(graph).plan(n).sizes for n in (2, 3)}
    log(f"  ModelPartitioner(mobilenetv2_graph()): 2-way {sizes[2]}, 3-way {sizes[3]} "
        "(paper: [116, 25], [108, 16, 17])")
    assert sizes == {2: [116, 25], 3: [108, 16, 17]}, sizes
    gpu = build_mobilenetv2(torch.Generator().manual_seed(SEED), device="cuda")
    cpu = build_mobilenetv2(torch.Generator().manual_seed(SEED), device="cpu")
    x_cpu = torch.randn(MNV2_INPUT, generator=torch.Generator().manual_seed(SEED + 3))
    x = x_cpu.cuda()
    executor = lambda lo, hi, h, res: run_range(gpu, lo, hi, h, res)  # noqa: E731

    # the main path: deploy-time verification, then one request twice
    # through the result cache; its counts are zeroed before and read after
    reset_counts()
    amp = DistributedInference(make_paper_cluster(), ModelPartitioner(graph), executor=executor)
    assert amp.verify_numerics(x), "partitioned forward diverged from the monolithic one"
    cached = DistributedInference(make_paper_cluster(), ModelPartitioner(graph),
                                  executor=executor, use_cache=True)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walls.append((cached.infer(x), time.perf_counter() - t0))
        torch.cuda.synchronize()
    launches = read_counts()
    assert not any(launches.values()), f"MobileNetV2 reached a kernel of the repo: {launches}"
    (y1, miss_s), (y2, hit_s) = walls
    stages = len(cached.plan.partitions)
    assert (cached.cache.hits, cached.cache.misses) == (stages, stages), cached.cache.stats()
    assert y2 is y1
    parts = [(p.lo, p.hi) for p in amp.plan.partitions]
    log(f"  [{device_line}] verify_numerics on CUDA tensors {tuple(x.shape)}: True; plan {parts} "
        f"on {sorted(amp.placement.values())}; infer with the cache: first call {stages} misses "
        f"in {miss_s * 1e3:.3f} ms of wall, second call {stages} hits in {hit_s * 1e3:.3f} ms "
        "(the input's digest, on the host), the same tensor")

    y = run_full(gpu, x)
    y_cpu = run_full(cpu, x_cpu)
    err = float((y.cpu() - y_cpu).abs().max())
    close = torch.allclose(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    log(f"  monolithic forward {tuple(x.shape)} fp32 (TF32 off), card vs CPU on the same seeded "
        f"weights: max|d| = {err:.3e} (|y| up to {float(y_cpu.abs().max()):.3e}; tolerance 1e-5) "
        f"{'ok' if close else 'FAIL'}")
    assert close and bool(torch.isfinite(y).all()) and y.shape == (MNV2_INPUT[0], 1000)
    assert torch.allclose(y1, y, rtol=1e-5, atol=1e-5)

    mono_cluster = EdgeCluster()
    mono_cluster.add_node("mono", "monolithic")
    rows = [run_monolithic(mono_cluster, ModelPartitioner(graph), 100),
            amp.run(100, name="amp4ec"),
            DistributedInference(make_paper_cluster(), ModelPartitioner(graph),
                                 use_cache=True).run(100, repeat_rate=0.8, name="amp4ec+cache")]
    sim = {r.name: dict(latency_ms=r.steady_latency_ms, throughput_rps=r.throughput_rps)
           for r in rows}
    log("  run(100), simulated edge-cluster ms from the cost model (not device time): "
        + json.dumps(sim))

    timing = {}
    for batch in (1, MNV2_INPUT[0]):
        xb = x[:batch].contiguous()
        iters = 50 if batch == 1 else 20
        row = dict(forward_ms=cuda_ms(lambda: run_full(gpu, xb), iters), partitions_ms=[])
        h, res = xb, None
        for lo, hi in parts:
            row["partitions_ms"].append(
                cuda_ms(lambda h=h, res=res, lo=lo, hi=hi: run_range(gpu, lo, hi, h, res), iters))
            h, res = run_range(gpu, lo, hi, h, res)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run_full(gpu, xb)
        torch.cuda.synchronize()
        row["peak_allocated_mb"] = torch.cuda.max_memory_allocated() / 1e6
        row["forward_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        log(f"  [{device_line}] batch {batch}: forward {row['forward_ms']:.4f} ms "
            f"(CUDA events, {iters} calls); partitions {parts}: "
            + ", ".join(f"{t:.4f}" for t in row["partitions_ms"])
            + f" ms; peak allocated {row['peak_allocated_mb']:.1f} MB "
            f"({row['forward_peak_mb']:.1f} MB above the weights and inputs)")
        row["profile"] = profile_call(lambda: run_full(gpu, xb), f"MobileNetV2 forward, batch {batch}",
                                      device_line)
        assert row["profile"], "the profiler recorded no device time"
        timing[batch] = row
    return dict(launches=launches, sizes=sizes, max_abs_err=err, simulated=sim,
                infer_wall_ms=[miss_s * 1e3, hit_s * 1e3], timing=timing)


def phase_attainable(device_line: str) -> dict:
    """The rates this card attains against the cost model's H100 block: a
    bf16 GEMM at 8192^3 and a streaming copy of 1 GiB, by CUDA events. A
    share above 1.05 means the block's published peaks are wrong for the
    card."""
    n = ATTAIN_GEMM_N
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a, b = (torch.randn((n, n), generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    c = torch.empty_like(a)
    gemm_ms = cuda_ms(lambda: torch.matmul(a, b, out=c), iters=20)
    flops_per_s = 2.0 * n ** 3 / (gemm_ms * 1e-3)
    del a, b, c
    src = torch.ones(ATTAIN_COPY_BYTES // 4, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), iters=20)
    bytes_per_s = 2.0 * ATTAIN_COPY_BYTES / (copy_ms * 1e-3)   # read once, written once
    del src, dst
    torch.cuda.empty_cache()
    out = dict(gemm_ms=gemm_ms, gemm_tflops=flops_per_s / 1e12,
               gemm_share=flops_per_s / PEAK_BF16_FLOPS, copy_ms=copy_ms,
               copy_gb_per_s=bytes_per_s / 1e9, copy_share=bytes_per_s / HBM_BYTES_PER_S)
    log(f"  [{device_line}] bf16 matmul {n}^3: {gemm_ms:.4f} ms, {out['gemm_tflops']:.1f} "
        f"TFLOP/s = {out['gemm_share']:.3f} of the block's {PEAK_BF16_FLOPS / 1e12:.0f}")
    log(f"  [{device_line}] copy of {ATTAIN_COPY_BYTES / 2 ** 30:.0f} GiB: {copy_ms:.4f} ms, "
        f"{out['copy_gb_per_s']:.1f} GB/s (bytes read + written) = {out['copy_share']:.3f} of "
        f"the block's {HBM_BYTES_PER_S / 1e9:.0f}")
    assert out["gemm_share"] <= 1.05 and out["copy_share"] <= 1.05, \
        f"the H100 block's peaks are below what this card attains: {out}"
    return out


def phase_calibration(device_line: str) -> dict:
    """``scripts/calibrate_costmodel_torch.py`` on the card: the k in {1, 2,
    4, 8} sweep of the three Hopper kernels and the two library classes,
    the curves fitted and the artifact written under the temporary
    directory (the checkout's own artifact is the standalone script's),
    then loaded back as the port's calibrated cost model. The sweep's own
    inputs at k = 1 and 8 then go through each kernel once more, held
    against its plain version."""
    spec = importlib.util.spec_from_file_location("calibrate_costmodel_torch", CALIBRATE)
    calib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(calib)
    out = pathlib.Path(tempfile.gettempdir()) / "chip_smoke_batch_curves_h100.json"
    thunks = {}
    reset_counts()
    path = calib.main(out, device="cuda", thunks=thunks)
    launches, variants = read_counts(), read_variants()
    body = json.loads(path.read_text())
    # the device's part of each point: kernel time per call by the profiler,
    # on the thunks the sweep timed (cuDNN in IEEE fp32, as in the sweep)
    with calib.ieee_conv():
        device_us = {}
        for (kind, k), thunk in thunks.items():
            ms, by = device_time(thunk)
            device_us.setdefault(kind, {})[str(k)] = dict(us=ms * 1e3, by=by)
    for row in body["bench"]:
        t = ", ".join(f"{row['t_us'][str(k)]:.1f}" for k in calib.K_SWEEP)
        dev = ", ".join(f"{d['us']:.1f}{'' if d['by'] == 'profiler' else ' (events)'}"
                        for d in device_us[row["kind"]].values())
        log(f"  [{device_line}] {row['kind']}: t_us at k = 1, 2, 4, 8: {t} (device {dev}); "
            f"fixed {row['fixed_us']:.1f} us, per item {row['per_item_us']:.1f} us, tail slope "
            f"{row['tail_slope_us']:.1f} us; launches {row.get('launches', 'none (library)')}"
            f", variants {row.get('variants', '-')}; {len(row['passes_us'])} passes"
            f"{', stalled at k = ' + str(row['stalled_k']) if 'stalled_k' in row else ''}")
    model = BatchCostModel.from_artifact(path)
    log(f"  {path} loads as {model.source!r}: "
        + json.dumps(body["curves"], sort_keys=True))
    assert not model.is_analytic and model.source != "analytic-fallback", model.source
    assert device_line in model.source, (model.source, device_line)
    for name in KERNELS:
        assert launches[name] > 0, f"the sweep launched no {name}: {launches}"
    checks = {}
    for kind, name, variant, tol, plain in (
            ("Attention", "flash_attention", "cuda_core", 2e-5,
             lambda q, k, v: [ref.attention_ref(q, k, v, causal=True)]),
            ("SSD", "ssd_scan", "cuda_core", 2e-4, lambda *a: list(ref.ssd_sequential(*a))),
            ("RGLRU", "rglru_scan", None, 2e-5, lambda a, b: [ref.rglru_ref(a, b)])):
        for k in (calib.K_SWEEP[0], calib.K_SWEEP[-1]):
            thunk = thunks[kind, k]
            reset_counts()
            got = thunk()
            torch.cuda.synchronize()
            assert read_counts()[name] == 1, (kind, k, read_counts())
            if variant:
                assert read_variants()[name][variant] == 1, (kind, k, read_variants())
            shape = "x".join(map(str, thunk.args[0].shape))
            checks.setdefault(name, []).append(dict(check(
                name, f"sweep {kind} k={k} ({shape}) fp32 [{variant or 'scan'}]",
                list(got) if isinstance(got, tuple) else [got], plain(*thunk.args), tol),
                variant=variant))
    return dict(launches=launches, variants=variants, path=path, source=model.source,
                bench=body["bench"], device_us=device_us, curves=body["curves"],
                checks=checks)


def phase_card_curves(artifact: pathlib.Path, device_line: str) -> dict:
    """The paper's flow on the card's curves: MobileNetV2 planned by the DP
    planner (the greedy partitioner reads no cost curve) on the paper
    cluster at expected_k = 4, with the analytic model and with the fresh
    artifact; each verified on the card and run through the event engine
    with micro-batches of up to 4. The reports are simulated edge ms."""
    graph = mobilenetv2_graph()
    gpu = build_mobilenetv2(torch.Generator().manual_seed(SEED), device="cuda")
    x = torch.randn(MNV2_INPUT, generator=torch.Generator().manual_seed(SEED + 3)).cuda()
    executor = lambda lo, hi, h, res: run_range(gpu, lo, hi, h, res)  # noqa: E731
    out = {}
    for label, model in (("analytic", ANALYTIC_BATCH_MODEL),
                         ("card curves", BatchCostModel.from_artifact(artifact))):
        amp = DistributedInference(make_paper_cluster(), ModelPartitioner(graph),
                                   executor=executor, method="planner", expected_k=4,
                                   batch_model=model)
        assert amp.verify_numerics(x), f"{label}: partitioned forward diverged on the card"
        rep = amp.run(CURVES_REQUESTS, name=label, engine=EngineConfig(
            transfer="overlap", micro_batch=4, adaptive_batch=True))
        assert len(rep.columns) == CURVES_REQUESTS, (label, len(rep.columns))
        out[label] = dict(source=model.source,
                          plan=[(p.lo, p.hi) for p in amp.plan.partitions],
                          placement={i: amp.placement[i] for i in sorted(amp.placement)},
                          throughput_rps=rep.throughput_rps, p50_ms=rep.p50_sojourn_ms,
                          p99_ms=rep.p99_sojourn_ms, batch_hist=rep.batch_hist)
        r = out[label]
        log(f"  {label} ({model.source}): plan {r['plan']} on {r['placement']}; verify_numerics "
            f"on the card True; run({CURVES_REQUESTS}) in simulated edge ms (not device time): "
            f"{r['throughput_rps']:.4f} rps, sojourn p50 {r['p50_ms']:.2f} / p99 "
            f"{r['p99_ms']:.2f} ms, batches {r['batch_hist']}")
    a, c = out["analytic"], out["card curves"]
    out["plan_moved"] = (a["plan"], a["placement"]) != (c["plan"], c["placement"])
    log(f"  the card's curves {'moved' if out['plan_moved'] else 'did not move'} the plan")
    return out


def phase_example() -> list:
    """``examples/partition_transformer_torch.py`` at its defaults, in a
    process where JAX and the reference package cannot be imported."""
    code = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, str(EXAMPLE)], capture_output=True,
                          text=True, env=env, timeout=300)
    lines = proc.stdout.splitlines()
    for line in lines:
        log(f"    {line}")
    assert proc.returncode == 0, f"{EXAMPLE.name} exited {proc.returncode}: {proc.stderr[-2000:]}"
    log(f"  {EXAMPLE.name}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return lines


def phase_megatron_sp(mesh, device_line: str) -> dict:
    """qwen2.5-3b at full width and depth in fp32 (TF32 off): the train
    forward at (1, SP_SEQ) through the Megatron-SP blocks (``block_impl =
    "shardmap"`` under the rules {"seq": ("model",)} on the (1, 1) mesh of
    a NCCL group of one) against the plain blocks without rules, within
    5e-4; the counts are zeroed just before the shardmap forward and read
    just after: one flash launch per layer."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), dtype="float32")
    model = Model(cfg)
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    tokens = torch.randint(0, cfg.vocab_size, (1, SP_SEQ), generator=g, device="cuda",
                           dtype=torch.int32)
    walls = {}
    with torch.no_grad():
        for impl in ("gspmd", "shardmap"):
            model.block_impl = impl
            walls[impl] = []
            for _ in range(2):
                rules = (logical_rules(mesh, {"seq": ("model",)}) if impl == "shardmap"
                         else contextlib.nullcontext())
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                with rules:
                    logits, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
                torch.cuda.synchronize()
                walls[impl].append(time.perf_counter() - t0)
                launches, variants = read_counts(), read_variants()
            if impl == "gspmd":
                want = logits
    v = cfg.vocab_size
    err = float((logits[..., :v] - want[..., :v]).abs().max())
    log(f"  [{device_line}] {model.param_count(params) / 1e9:.3f} B parameters in fp32, train "
        f"forward (1, {SP_SEQ}), two calls each: plain blocks "
        f"{walls['gspmd'][0]:.4f} / {walls['gspmd'][1]:.4f} s, Megatron-SP blocks "
        f"{walls['shardmap'][0]:.4f} / {walls['shardmap'][1]:.4f} s of wall; max|dlogit| = "
        f"{err:.3e} (tolerance 5e-4; |logit| up to {float(want[..., :v].abs().max()):.3e}); "
        f"launches of the last call {launches}, by variant {variants}")
    assert launches == {"flash_attention": cfg.num_layers, "ssd_scan": 0, "rglru_scan": 0}, \
        launches
    assert bool(torch.isfinite(logits[..., :v]).all()) and logits.shape == (1, SP_SEQ,
                                                                            cfg.padded_vocab)
    assert err <= 5e-4, f"Megatron-SP blocks disagree with the plain blocks: {err}"
    del logits, want

    def forward(impl):
        model.block_impl = impl
        with (logical_rules(mesh, {"seq": ("model",)}) if impl == "shardmap"
              else contextlib.nullcontext()):
            model.forward(params, {"tokens": tokens}, mode="train")

    profiles = {}
    with torch.no_grad():
        for impl, label in (("gspmd", "plain"), ("shardmap", "Megatron-SP")):
            profiles[impl] = profile_call(lambda: forward(impl),
                                          f"one {label} train forward (1, {SP_SEQ})", device_line)
    del model, params
    torch.cuda.empty_cache()
    return dict(launches=launches, variants=variants, max_abs_err=err, wall_s=walls,
                profiles=profiles)


def phase_moe_mesh(mesh, device_line: str) -> dict:
    """One MoE layer of deepseek-v2-236b at full width (160 experts top-6, 2
    shared, d_model 5120) in bf16 on (1, SP_SEQ) tokens: the off-mesh
    branch, then under the rules on the (1, 1) mesh the expert-parallel
    branch (``impl="auto"``) and the weight-resident 2D one (``"2d"``). At a
    group of one each collective is the identity and each rank holds every
    block, so both must equal the off-mesh result bit for bit."""
    cfg = get_config("deepseek-v2-236b")
    b = ParamBuilder(torch.Generator(device="cuda").manual_seed(SEED), dtype=cfg.torch_dtype,
                     device="cuda")
    moe.init_moe(b, "ffn", cfg)
    p = b.build()[0]["ffn"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = torch.randn((1, SP_SEQ, cfg.d_model), generator=g, device="cuda").to(cfg.torch_dtype)
    out = {}
    with torch.no_grad():
        for label, impl, rules in (("off-mesh", "auto", contextlib.nullcontext()),
                                   ("auto", "auto", logical_rules(mesh)),
                                   ("2d", "2d", logical_rules(mesh))):
            with rules:
                call = lambda: moe.apply_moe(p, x, cfg, impl=impl)  # noqa: E731
                y, aux = call()
                out[label] = dict(y=y, aux=aux, ms=cuda_ms(call, iters=5, warmup=1))
    base = out["off-mesh"]
    rows = {}
    for impl in ("auto", "2d"):
        r = out[impl]
        equal = torch.equal(r["y"], base["y"]) and torch.equal(r["aux"], base["aux"])
        err = float((r["y"].float() - base["y"].float()).abs().max())
        log(f"  [{device_line}] apply_moe impl={impl!r} on the (1, 1) mesh: {r['ms']:.4f} ms "
            f"(CUDA events, 5 calls; off the mesh {base['ms']:.4f} ms); y and aux bit-equal to "
            f"the off-mesh branch: {equal} (max|dy| = {err:.3e})")
        assert equal, f"impl={impl} on a group of one differs from the off-mesh branch: {err}"
        rows[impl] = dict(ms=r["ms"], bit_equal=equal, max_abs_err=err)
    assert bool(torch.isfinite(base["y"].float()).all()) and base["y"].shape == x.shape
    rows["off-mesh"] = dict(ms=base["ms"])
    del p, out, base
    torch.cuda.empty_cache()
    return rows


def subprocess_env() -> dict:
    """The environment of the dry run's processes: the checkout's sources,
    and no CUDA device to see (the dry run touches none)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                      env.get("PYTHONPATH")]))
    return env


def run_logged(cmd: list, timeout: float) -> str:
    """Run ``cmd`` from the checkout with ``subprocess_env``; its stdout
    lines go to the log. Fails on a non-zero exit or on the time limit (the
    process is killed)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=subprocess_env(), capture_output=True, text=True,
                          timeout=timeout)
    for line in proc.stdout.splitlines():
        log(f"    {line}")
    if proc.returncode:
        log(proc.stderr[-4000:])
        raise RuntimeError(f"{' '.join(cmd[1:4])} exited {proc.returncode}")
    log(f"  ({time.perf_counter() - t0:.1f} s of {timeout} s allowed)")
    return proc.stdout


def run_concurrently(cmds: dict, timeout: float) -> dict:
    """Start every command of ``cmds`` ({name: argv}) at once from the
    checkout with ``subprocess_env``, wait for all, then log each one's
    stdout lines in turn. Fails on a non-zero exit or on the time limit
    (every process still running is killed first). Returns {name: seconds
    from the common start to that process's exit}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = {name: open(pathlib.Path(tmp) / f"{i}.log", "w+")
                for i, name in enumerate(cmds)}
        procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=subprocess_env(), text=True,
                                        stdout=outs[name], stderr=subprocess.STDOUT)
                 for name, cmd in cmds.items()}
        seconds = {}
        try:
            while len(seconds) < len(procs) and time.perf_counter() - t0 < timeout:
                for name, proc in procs.items():
                    if name not in seconds and proc.poll() is not None:
                        seconds[name] = time.perf_counter() - t0
                time.sleep(0.1)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        failed = []
        for name, proc in procs.items():
            outs[name].seek(0)
            text = outs[name].read()
            outs[name].close()
            log(f"  {' '.join(cmds[name][1:])}")
            for line in text.splitlines()[-40:] if proc.returncode else text.splitlines():
                log(f"    {line}")
            if name not in seconds:
                failed.append(f"{name}: killed at the time limit of {timeout} s")
            elif proc.returncode:
                failed.append(f"{name}: exited {proc.returncode}")
            else:
                log(f"  ({seconds[name]:.1f} s of {timeout} s allowed)")
    if failed:
        raise RuntimeError("; ".join(failed))
    return seconds


def phase_dryrun(out_dir: pathlib.Path) -> dict:
    """``launch/dryrun.py`` on the production meshes (``DRYRUN_CASES``), all
    at once, each in a process of its own (this process's default group may
    be NCCL's), then ``launch/roofline.py`` over the records, both meshes.
    Every record must be ``ok``, with FLOPs and, on a mesh, collective
    bytes."""
    cmds = {" ".join((arch, shape) + flags): [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
        "--out", str(out_dir), *flags] for arch, shape, flags in DRYRUN_CASES}
    t0 = time.perf_counter()
    seconds = run_concurrently(cmds, DRYRUN_TIMEOUT_S)
    log(f"  the {len(cmds)} dry runs at once: {time.perf_counter() - t0:.1f} s")
    records = {}
    for path in sorted(out_dir.glob("*.json")):
        rec = json.loads(path.read_text())
        assert rec["status"] == "ok", (path.name, rec.get("error"))
        assert rec["flops_per_device"] > 0, (path.name, rec["flops_per_device"])
        assert rec["chips"] > 1 and rec["collective_bytes_per_device"] > 0, (
            path.name, rec["chips"], rec["collective_bytes_per_device"])
        records[path.stem] = {k: rec[k] for k in (
            "chips", "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
            "collective_counts", "memory", "roofline", "lower_s")}
    assert len(records) == len(DRYRUN_CASES), sorted(records)
    tables = {}
    for pod2 in (False, True):
        log(f"  python -m repro_torch.launch.roofline --markdown{' --pod2' if pod2 else ''} "
            "(data-sheet arithmetic for 256 or 512 H100s, not measured time)")
        tables["pod2" if pod2 else "pod1"] = run_logged(
            [sys.executable, "-m", "repro_torch.launch.roofline", "--dir", str(out_dir),
             "--markdown"] + (["--pod2"] if pod2 else []), 120)
    return dict(records=records, seconds=seconds, tables=tables)


def phase_counts(device_line: str) -> dict:
    """The counting layer against the card: full-width qwen2.5-3b bf16
    prefill at (COUNT_BATCH, COUNT_SEQ), counted with no mesh on CPU fake
    tensors in a process of its own, then run on the card. The counted
    argument bytes must be the card's parameter and batch bytes exactly, and
    the card's device time at least the compute term (FLOPs over
    GPU_PEAK_FLOPS): a count that claims more work than the card can do in
    the time it took is wrong."""
    arch = "qwen2.5-3b"
    cfg = get_config(arch)
    counted = json.loads(run_logged(
        [sys.executable, "-c", COUNT_PREFILL, arch, str(COUNT_BATCH), str(COUNT_SEQ)],
        DRYRUN_TIMEOUT_S).splitlines()[-1])
    model = Model(cfg)
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (COUNT_BATCH, COUNT_SEQ), generator=g,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}
    card_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    card_bytes += tokens.numel() * tokens.element_size()
    assert counted["memory"]["argument_bytes"] == card_bytes, (counted["memory"], card_bytes)

    def prefill():
        with torch.no_grad():
            return model.forward(params, batch, mode="prefill")[0]

    events_ms = cuda_ms(prefill, iters=5)
    prof = profile_call(prefill, f"one prefill ({COUNT_BATCH}, {COUNT_SEQ})", device_line)
    compute_ms = counted["flops"] / PEAK_BF16_FLOPS * 1e3
    memory_ms = counted["bytes"] / HBM_BYTES_PER_S * 1e3
    busy_ms = prof.get("busy_ms")
    measured_ms = busy_ms if busy_ms else events_ms
    out = dict(flops=counted["flops"], bytes=counted["bytes"], memory=counted["memory"],
               hlo_ops=counted["hlo_ops"], trace_s=counted["trace_s"],
               card_argument_bytes=card_bytes, events_ms=events_ms, busy_ms=busy_ms,
               compute_term_ms=compute_ms, memory_term_ms=memory_ms,
               measured_over_compute=measured_ms / compute_ms,
               measured_over_memory=measured_ms / memory_ms, device=device_line)
    log(f"  counted: {counted['flops']:.6e} FLOPs, {counted['bytes']:.6e} bytes, "
        f"{counted['hlo_ops'].get('fusion', 0)} launches, argument bytes "
        f"{counted['memory']['argument_bytes']} = the card's {card_bytes}")
    log(f"  [{device_line}] prefill {events_ms:.4f} ms (CUDA events, 5 calls), device busy "
        f"{busy_ms} ms; compute term {compute_ms:.4f} ms, memory term {memory_ms:.4f} ms; "
        f"measured / compute term {out['measured_over_compute']:.4f}, measured / memory term "
        f"{out['measured_over_memory']:.4f} ({'busy' if busy_ms else 'events'})")
    assert measured_ms >= compute_ms, (measured_ms, compute_ms)
    del model, params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    device_line = card()
    log(f"phase 1: {device_line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all()

    log("phase 2: kernels vs plain versions on the card")
    cases = {"flash_attention": flash_vs_plain(), "ssd_scan": ssd_vs_plain(),
             "rglru_scan": rglru_vs_plain()}
    fused_cases_out = fused_vs_plain()

    log("phase 3: timing at the main-path shapes")
    timing = {"flash_attention": flash_timing(device_line), "ssd_scan": ssd_timing(device_line),
              "rglru_scan": rglru_timing(device_line)}
    fused_times = fused_timing(device_line)

    # each path: its counts are zeroed just before its prefill and read after
    paths = {
        "qwen2.5-3b prefill (2, 512)": drive("qwen2.5-3b", 4, 2, 512, device_line),
        "mamba2-130m prefill (2, 2048)": drive("mamba2-130m", 7, 2, 2048, device_line),
        # full depth in fp32 would not fit beside the bf16 weights: the
        # consistency check keeps 5 layers (one super-block and both tails)
        "recurrentgemma-9b prefill (1, 4096)": drive("recurrentgemma-9b", 10, 1, 4096,
                                                     device_line, consistency_layers=5),
    }

    log("phase 13: loss gradients on the card vs the CPU (Queue C item 1)")
    grads = phase_grads()

    log("phase 14: full-width qwen2.5-3b training, (2, 512 + 1), remat")
    train_runs = {"qwen2.5-3b training step (2, 512)": phase_train(
        get_config("qwen2.5-3b"), 2, 512, 3, device_line, check_moved=True)}
    torch.cuda.empty_cache()
    log("phase 15: full-width mamba2-130m training, (2, 2048 + 1), remat, checkpoint")
    train_runs["mamba2-130m training step (2, 2048)"] = phase_train(
        get_config("mamba2-130m"), 2, 2048, 3, device_line, check_checkpoint=True)
    torch.cuda.empty_cache()
    log("phase 16: full-width recurrentgemma-9b cut to 5 layers, training (1, 4096 + 1)")
    train_runs["recurrentgemma-9b (5 layers) training step (1, 4096)"] = phase_train(
        dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=5), 1, 4096, 2,
        device_line)
    torch.cuda.empty_cache()
    paths.update(train_runs)

    log(f"phase 17: MobileNetV2 {MNV2_INPUT} through DistributedInference on the paper cluster")
    mnv2 = phase_mobilenetv2(device_line)
    paths[f"mobilenetv2 {MNV2_INPUT} through DistributedInference"] = mnv2
    torch.cuda.empty_cache()

    # 236 B parameters (472 GB in bf16) do not fit on the card: full width,
    # depth cut to the dense MLA block and three MLA-MoE blocks (26.6 GB); the
    # fp32 check keeps the dense block and one MoE block (21.4 GB in fp32)
    paths["deepseek-v2-236b (4 layers) prefill (1, 4096)"] = drive(
        "deepseek-v2-236b", 18, 1, 4096, device_line, consistency_layers=2, num_layers=4)
    torch.cuda.empty_cache()

    # whisper-medium (0.845 B parameters) fits at full depth, its fp32 check
    # too; 448 tokens is Whisper's decoder context
    whisper = drive("whisper-medium", 21, 4, 448, device_line)
    paths["whisper-medium prefill (4, 448) over (4, 1500) frames"] = whisper
    paths["whisper-medium serving 8 x (16 + 8), max batch 4"] = whisper["serving"]
    torch.cuda.empty_cache()
    # 87.7 B parameters (175 GB in bf16) do not fit on the card: full width,
    # depth cut from 100 to 10 layers (two super-blocks, 10.66 B parameters,
    # 21.3 GB); the fp32 check keeps one super-block (5 layers, 25.5 GB)
    paths["llama-3.2-vision-90b (10 layers) prefill (1, 4096) over 1601 image tokens"] = drive(
        "llama-3.2-vision-90b", 24, 1, 4096, device_line, consistency_layers=5, num_layers=10)
    torch.cuda.empty_cache()

    log("phase 27: attainable bf16 GEMM and copy rates against the cost model's H100 block")
    attainable = phase_attainable(device_line)
    log("phase 28: the batch-cost calibration sweep on the Hopper kernels")
    calibration = phase_calibration(device_line)
    paths["calibration sweep, k in (1, 2, 4, 8)"] = calibration
    log("phase 29: MobileNetV2 planned and run at expected_k = 4 on the card's curves")
    card_curves = phase_card_curves(calibration["path"], device_line)
    log(f"phase 30: {EXAMPLE.relative_to(ROOT)}")
    phase_example()

    # the multi-device path on the one card: a NCCL group of one, a (1, 1) mesh
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_host_mesh()
            assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1), mesh
            log(f"phase 31: full-width qwen2.5-3b through the Megatron-SP blocks, (1, {SP_SEQ}) "
                "fp32, on a NCCL group of one")
            sp = phase_megatron_sp(mesh, device_line)
            paths[f"qwen2.5-3b Megatron-SP train forward (1, {SP_SEQ}), NCCL group of one"] = sp
            log(f"phase 32: deepseek-v2-236b MoE layer through the mesh branches, (1, {SP_SEQ})")
            moe_mesh = phase_moe_mesh(mesh, device_line)
        finally:
            dist.destroy_process_group()

    with tempfile.TemporaryDirectory() as records:
        log("phase 33: the dry run on the production meshes (fake groups of 256 and 512 ranks)")
        dryrun = phase_dryrun(pathlib.Path(records))
    log("phase 34: the dry run's counts against the card, full-width qwen2.5-3b prefill "
        f"({COUNT_BATCH}, {COUNT_SEQ})")
    counts = phase_counts(device_line)

    log("phase 35: results")
    kernels = []
    for name, source, replaces in (
            ("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:30"),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:24"),
            ("rglru_scan", "rglru_scan.cu", "src/repro/kernels/rglru_scan.py:26")):
        by_path = {p: r["launches"][name] for p, r in paths.items() if r["launches"][name]}
        assert by_path, f"{name} was launched on no path"
        t = timing[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=cases[name][0]["max_abs_err"], **t,
            cases=cases[name] + calibration["checks"][name]))
    print(json.dumps({"training": train_runs, "grad_max_abs_err": grads}))
    print(json.dumps({"mobilenetv2": mnv2, "device": device_line}))
    calibration = {k: v for k, v in calibration.items() if k != "path"}
    print(json.dumps({"attainable": attainable, "calibration": calibration,
                      "card_curves": card_curves, "device": device_line}))
    print(json.dumps({"megatron_sp": sp, "moe_mesh": moe_mesh, "device": device_line}))
    print(json.dumps({"dryrun": dryrun, "counts": counts, "device": device_line}))
    print(json.dumps({"kernels": kernels}))
    fused_by_path = {p: r["fused_launches"] for p, r in paths.items() if "fused_launches" in r}
    print(json.dumps({"fused": {"cases": fused_cases_out, "timing": fused_times,
                                "launches_per_prefill_call": fused_by_path,
                                "device": device_line}}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
