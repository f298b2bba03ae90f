"""Smoke run of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives the port's main path at the full width of qwen2.5-3b (36 layers,
d_model 2048, 16 q heads / 2 kv heads, bf16, random weights from a seed):
prefill through the hand-written Hopper flash-attention kernel, and greedy
serving through the AMP4EC NSA scheduler. It builds every kernel of that
path from the sources in the checkout, holds each against its plain PyTorch
version on the card, times it beside its bound, its plain version and the
closest PyTorch library call, and checks that the main path launched it.

Phases (any failure exits non-zero):
  1. card name and power limit; build the kernels
  2. each kernel against its plain version on the card
  3. timing at the main-path shape (CUDA events)
  4. full-width prefill: launches per call, finite logits
  5. full-width fp32 prefill-vs-decode consistency (bound 2e-3)
  6. serving: 8 requests through ServingEngine on the paper cluster
  7. one JSON line of kernels, then the device line last

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cluster import make_paper_cluster  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

SEED = 0
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense tensor-core rate, bf16
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
MAIN = dict(b=1, hq=16, hkv=2, s=2048, d=128)   # qwen2.5-3b attention at S=2048


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def qkv(seed, b, hq, hkv, s, d, dv, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda h, w: torch.randn((b, h, s, w), generator=g, device="cuda").to(dtype)
    return mk(hq, d), mk(hkv, d), mk(hkv, dv)


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


def phase_kernels_vs_plain():
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
    results = []
    for i, (name, shape, dtype, causal, window, tol) in enumerate(cases):
        q, k, v = qkv(SEED + i, **shape, dtype=dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        close = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        log(f"  {name}: max|kernel-plain| = {err:.3e} (tolerance {tol:g}) "
            f"{'ok' if close else 'FAIL'}")
        assert close and math.isfinite(err), f"flash_attention disagrees: {name}"
        results.append(dict(case=name, max_abs_err=err, tol=tol))
    return results


def phase_timing(device_line: str):
    m = MAIN
    q, k, v = qkv(SEED, **m, dv=m["d"], dtype=torch.bfloat16)
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=20)
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
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + q.numel() * 2
    flop_ms, byte_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((flop_ms, "operations"), (byte_ms, "bytes"))
    log(f"  [{device_line}] flash_attention bf16 (1,16,2048,128) causal: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
        f"kernel at {flops / kernel_ms / 1e9:.1f} TFLOP/s = "
        f"{100 * bound_ms / kernel_ms:.2f}% of the bf16 roofline, "
        f"{flops / core_ms / 1e9:.1f} TFLOP/s on the CUDA-core variant ({core_ms:.4f} ms, "
        f"{100 * flops / core_ms / 1e9 / (PEAK_FP32_FLOPS / 1e12):.1f}% of the fp32 peak)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, cuda_core_ms=core_ms)


def phase_prefill(model, params, device_line: str) -> int:
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=g, device="cuda",
                           dtype=torch.int32)
    fa.flash_attention.launches = 0
    times = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _, cache = model.forward(params, {"tokens": tokens}, mode="prefill")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = fa.flash_attention.launches
    assert launches == 2 * cfg.num_layers, f"{launches} flash launches in 2 prefills"
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[:, :cfg.vocab_size].float()).all()), "non-finite logits"
    k, v = cache["kv"]
    assert k.shape == (cfg.num_layers, 2, cfg.num_kv_heads, 512, cfg.head_dim_) == v.shape
    log(f"  prefill (2, 512): {launches // 2} flash launches per call; "
        f"[{device_line}] wall {times[0]:.4f} s first call, {times[1]:.4f} s second")
    with torch.no_grad():
        profile_call(lambda: model.forward(params, {"tokens": tokens}, mode="prefill"),
                     "one prefill (2, 512)", device_line)
    return launches


def profile_call(fn, label: str, device_line: str) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"  profile of {label}: no device time recorded; breakdown not measured")
        return
    log(f"  profile [{device_line}] {label} under the profiler: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% of wall), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {100 * e.self_device_time_total / busy_us:5.1f}%"
            f"  x{e.count:<4d} {e.key[:90]}")


def phase_consistency(cfg) -> float:
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg32)
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), generator=g, device="cuda",
                           dtype=torch.int32)
    v = cfg.vocab_size
    with torch.no_grad():
        before = fa.flash_attention.launches
        fwd, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
        assert fa.flash_attention.launches - before == cfg.num_layers
        cache, _ = model.init_cache(1, 32, device="cuda")
        err = 0.0
        for t in range(16):
            logits, cache = model.decode_step(params, tokens[:, t], cache)
            err = max(err, float((logits[0, :v] - fwd[0, t, :v]).abs().max()))
    torch.cuda.synchronize()
    log(f"  fp32 train-forward (flash kernel) vs 16 decode steps: max|dlogit| = {err:.3e} "
        f"(bound 2e-3)")
    assert err < 2e-3, f"prefill-vs-decode max err {err}"
    return err


def phase_serving(cfg, params, device_line: str):
    engine = ServingEngine(cfg, params, make_paper_cluster(), max_batch=4, device="cuda")
    reqs = [Request(i, np.arange(3, 19, dtype=np.int32), 8) for i in range(8)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert m["num_requests"] == 8
    assert all(r.output is not None and r.output.shape == (8,) for r in reqs)
    assert len(m["requests_per_node"]) >= 2, m["requests_per_node"]
    assert m["tokens_per_s"] > 0
    new_tokens = sum(r.max_new_tokens for r in reqs)
    log(f"  [{device_line}] served 8 requests (prompt 16, 8 new tokens, max_batch 4): "
        f"wall {wall:.4f} s, {new_tokens / wall:.2f} generated tokens/s")
    log("  simulated edge-cluster metrics (cost model, not device time): "
        + json.dumps({k: m[k] for k in m if k != "scheduler"}))
    # one decode step as the engine runs it: batch 4, cache of P + N + 1 slots
    cache, _ = engine.model.init_cache(4, 25, device="cuda")
    token = torch.zeros(4, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        engine.model.decode_step(params, token, cache)
        profile_call(lambda: engine.model.decode_step(params, token, cache),
                     "one decode step (batch 4)", device_line)
    return wall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    device_line = card()
    log(f"phase 1: {device_line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    fa._lib()
    seconds, ptxas = build.build_info("flash_attention")
    log(f"  built flash_attention in {seconds:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 2: kernels vs plain versions on the card")
    cases = phase_kernels_vs_plain()

    log("phase 3: timing at the main-path shape")
    timing = phase_timing(device_line)

    log("phase 4: full-width qwen2.5-3b prefill (main path)")
    cfg = get_config("qwen2.5-3b")
    model = Model(cfg)
    params, _ = model.init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    launches = phase_prefill(model, params, device_line)

    log("phase 5: full-width fp32 prefill vs decode")
    phase_consistency(cfg)
    torch.cuda.empty_cache()

    log("phase 6: serving (main path)")
    fa.flash_attention.launches = 0
    phase_serving(cfg, params, device_line)
    log(f"  flash launches while serving: {fa.flash_attention.launches} "
        f"(the engine feeds prompts through decode_step)")

    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:30",
        launches=launches, max_abs_err=cases[0]["max_abs_err"],
        ms=timing["ms"], kernel_ms=timing["ms"], plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
        library_ms=timing["library_ms"], cuda_core_ms=timing["cuda_core_ms"], cases=cases)]
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
