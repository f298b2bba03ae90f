"""Build variants of the port's Hopper kernels and compare them on the card.

Each variant is a committed source under ``src/repro_torch/kernels/csrc/``
with one named edit (for the RG-LRU scan: other warp counts and run lengths,
loads issued only when a tile is scanned, the carry's fold in fp32). For each variant the script reports what the compiler
made of it (spilled bytes from ``-Xptxas -v``, local-memory instructions and
wgmma serialisation from the SASS: a ``WARPGROUP.DEPBAR`` after every
``HGMMA`` means ptxas waits for each wgmma before the next), checks it
against the plain PyTorch version, and times it at the main-path shapes of
``chip_smoke.py`` by the device time ``torch.profiler`` records (ms per
call). Variants that drop work on purpose (``*_without_*``) give wrong
outputs; their time is the share of the work they drop.

Run on a machine with an H100 and the CUDA toolkit, from the repo root:

    python3 scripts/kernel_variants.py [flash] [ssd] [rglru]

(the kernels named, all three by default). It needs one card, writes its builds under a temporary directory, and prints
one line per kernel function and per variant.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import itertools
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant edit does not apply: {old[:70]!r}")
    return src.replace(old, new)


def flash_variants() -> dict:
    src = (CSRC / "flash_attention.cu").read_text()
    # Dv = 256 in one block: O takes 128 registers of the 168
    whole = edit(src, "  if (Dv % 128 == 0)\n",
                 "  if (Dv == 256)\n    return launch_wgmma<D, 256>(q, k, v, o, s, B, Hq, Hkv, S, Dv, "
                 "scale, causal, window, st);\n  if (Dv % 128 == 0)\n")
    # ... with a producer warpgroup that gives its registers to the consumers
    regs = edit(whole, "constexpr int WG_THREADS = 288;", "constexpr int WG_THREADS = 384;")
    regs = edit(regs, "  if (threadIdx.x >= 2 * 128) {",
                "  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 2) {")
    regs = edit(regs, "    // ---- producer warp: one thread issues every TMA load ----\n",
                "    // ---- producer warp: one thread issues every TMA load ----\n"
                "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\");\n")
    regs = edit(regs, "    // ---- two consumer warpgroups, 64 query rows each ----\n",
                "    // ---- two consumer warpgroups, 64 query rows each ----\n"
                "    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n")
    # the loop over D's 16-column steps kept at run time
    loop = edit(src, "#pragma unroll\n      for (int kk = 0; kk < D / 16; ++kk) {",
                "#pragma unroll 1\n      for (int kk = 0; kk < D / 16; ++kk) {")
    # the softmax's exponentials through exp2f instead of ex2.approx
    exp2f = edit(src, "        x = ex2(fmaf(x, scale_log2, -m_use));",
                 "        x = exp2f(fmaf(x, scale_log2, -m_use));")
    exp2f = edit(exp2f, "    alpha[r] = ex2(m[r] - m_use);", "    alpha[r] = exp2f(m[r] - m_use);")
    return {"flash_committed": src, "flash_dv256_in_one_block": whole,
            "flash_dv256_in_one_block_setmaxnreg": regs, "flash_d_loop_at_run_time": loop,
            "flash_exp2f_in_softmax": exp2f}


def ssd_variants() -> dict:
    src = (CSRC / "ssd_scan.cu").read_text()
    no_cbt = edit(src, "          mma_16816(sc[2 * kb], cf[kk], bf[0], bf[1]);\n"
                       "          mma_16816(sc[2 * kb + 1], cf[kk], bf[2], bf[3]);",
                  "          sc[2 * kb][0] += __uint_as_float(bf[0] ^ cf[kk][0]);")
    return {"ssd_committed": src, "ssd_without_cbt_products": no_cbt}


RGLRU_LOOP = """  TA a0[T], a1[T];
  TB b0[T], b1[T];
  load_run(a0, b0, a, b, t_run, L, W, live);
  for (int k = 0; k < ntiles; k += 2) {
    const int t0 = k * TILE + t_run;
    if (k + 1 < ntiles) load_run(a1, b1, a, b, t0 + TILE, L, W, live);
    scan_run<0>(a0, b0, out, t0, L, W, live, carry, agg, warp, lane);
    if (k + 1 == ntiles) break;
    if (k + 2 < ntiles) load_run(a0, b0, a, b, t0 + 2 * TILE, L, W, live);
    scan_run<1>(a1, b1, out, t0 + TILE, L, W, live, carry, agg, warp, lane);
  }
"""
# each tile's loads issued only when the tile is scanned: nothing in flight
# through the barrier and the fold
RGLRU_LOAD_THEN_SCAN = """  TA a0[T];
  TB b0[T];
  for (int k = 0; k < ntiles; ++k) {
    const int t0 = k * TILE + t_run;
    load_run(a0, b0, a, b, t0, L, W, live);
    if (k & 1) scan_run<1>(a0, b0, out, t0, L, W, live, carry, agg, warp, lane);
    else scan_run<0>(a0, b0, out, t0, L, W, live, carry, agg, warp, lane);
  }
"""


def rglru_shape(src: str, nw: int, t: int) -> str:
    src = edit(src, "constexpr int NW = 16;", f"constexpr int NW = {nw};")
    return edit(src, "constexpr int T = 16;", f"constexpr int T = {t};")


def rglru_variants() -> dict:
    src = (CSRC / "rglru_scan.cu").read_text()
    simple = edit(src, RGLRU_LOOP, RGLRU_LOAD_THEN_SCAN)
    # the fold over the warp runs and the block's carry in fp32
    fp32 = src
    for old, new in (("__shared__ double2 agg", "__shared__ float2 agg"),
                     ("double& carry, double2 (&agg)", "float& carry, float2 (&agg)"),
                     ("make_double2(p, h)", "make_float2(p, h)"),
                     ("double pp = 1.0, hp = 0.0, cin = 0.0;", "float pp = 1.f, hp = 0.f, cin = 0.f;"),
                     ("const double2 g", "const float2 g"),
                     ("double carry = 0.0;", "float carry = 0.f;")):
        fp32 = edit(fp32, old, new)
    # drops the barrier and the fold (wrong outputs): what the loads, the two
    # passes and the stores take alone
    alone = edit(src, "  __syncthreads();\n", "")
    alone = edit(alone, """#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (j == warp) cin = fma(pp, carry, hp);
    const double2 g = agg[PARITY][j][lane];
    hp = fma(g.x, hp, g.y);
    pp *= g.x;
  }
""", "")
    loads = """    av[u] = ok ? a[off] : from_f32<TA>(0.f);
    bv[u] = ok ? b[off] : from_f32<TB>(0.f);
"""
    # loads that ask L2 to fetch the whole 256-byte sector pair (the
    # neighbouring block's channels too)
    l2_256 = edit(src, "// Issue the T loads", """__device__ __forceinline__ float ldg256(const float* p) {
  float v;
  asm("ld.global.nc.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 ldg256(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L2::256B.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return __ushort_as_bfloat16(v);
}

// Issue the T loads""")
    l2_256 = edit(l2_256, loads, loads.replace("a[off]", "ldg256(a + off)")
                  .replace("b[off]", "ldg256(b + off)"))
    # loads and stores marked streaming (evict first)
    streaming = edit(src, loads, loads.replace("a[off]", "__ldcs(a + off)")
                     .replace("b[off]", "__ldcs(b + off)"))
    streaming = edit(streaming, "out[(size_t)(t0 + u) * W] = from_f32<TB>(h);",
                     "__stcs(out + (size_t)(t0 + u) * W, from_f32<TB>(h));")
    return {"rglru_committed": src, "rglru_without_barrier_and_fold": alone,
            "rglru_l2_prefetch_256b": l2_256, "rglru_streaming_cache_hints": streaming,
            "rglru_load_then_scan_nw16_t32": rglru_shape(simple, 16, 32),
            "rglru_load_then_scan_nw16_t16": simple,
            "rglru_nw8_t32": rglru_shape(src, 8, 32),
            "rglru_nw32_t8": rglru_shape(src, 32, 8),
            "rglru_fp32_fold": fp32}


def compile_variant(workdir: pathlib.Path, name: str, src: str) -> pathlib.Path:
    d = workdir / name
    d.mkdir()
    (d / "k.cu").write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "k.so"),
                           str(d / "k.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    (d / "ptxas.log").write_text(proc.stdout + proc.stderr)
    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    (d / "k.sass").write_text(subprocess.run([str(cuobjdump), "-sass", str(d / "k.so")],
                                             capture_output=True, text=True).stdout)
    return d


def compiler_report(name: str, d: pathlib.Path) -> None:
    spills = {}
    fn = None
    for line in (d / "ptxas.log").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spills[fn] = int(m.group(1))
    regs = {}
    for line in (d / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "rglru_fwd" in fn:
            regs[fn] = int(m.group(1))
    for fname, n in regs.items():  # the four (a, b) dtype pairs
        pair = re.search(r"rglru_fwdI(\w+?)EEv", fname)
        print(f"  {name}: rglru_fwd<{pair.group(1) if pair else fname}> {n} registers, "
              f"spill stores {spills.get(fname, 0)} B")
    for part in re.split(r"\n\s*Function : ", (d / "k.sass").read_text())[1:]:
        fname = part.split("\n", 1)[0].strip()
        if "rglru_fwdIffE" in fname:
            # where the loads sit against the barriers: the order of the
            # memory and fp64 instructions, runs counted
            seq = re.findall(r"\b(LDG|STG|BAR|LDS|STS|DFMA|DMUL)\b", part)
            runs = [f"{op}x{len(list(g))}" for op, g in itertools.groupby(seq)]
            print(f"  {name}: rglru_fwd<ff> SASS order: {' '.join(runs)}")
            continue
        m = re.search(r"flash_fwd_wgmmaILi(128ELi128|256ELi128|256ELi256)E|"
                      r"ssd_chunk_scanILi64ELi128E|ssd_chunk_state", fname)
        if not m:  # the functions of the main-path shapes only
            continue
        short = m.group(0)
        ops = collections.Counter(re.findall(r"\b(HGMMA|HMMA|WARPGROUP\.DEPBAR|STL|LDL)\b", part))
        print(f"  {name}: {short} spill stores {spills.get(fname, 0)} B, STL {ops['STL']} "
              f"LDL {ops['LDL']}, HGMMA {ops['HGMMA']} WARPGROUP.DEPBAR "
              f"{ops['WARPGROUP.DEPBAR']}, HMMA {ops['HMMA']}")


def run_flash(lib_path: pathlib.Path, q, k, v, window: int = 0) -> torch.Tensor:
    """The wrapper's call, on the library at ``lib_path`` (the wgmma variant)."""
    fn = ctypes.CDLL(str(lib_path)).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    b, hq, s, d = q.shape
    dv = v.shape[3]
    st = (fa._strides(q), fa._strides(k), fa._strides(v))
    ost = (s * hq * dv, dv, hq * dv)
    out = torch.empty_strided((b, hq, s, dv), ost + (1,), dtype=q.dtype, device="cuda")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             fa._STRIDES(*st[0], *st[1], *st[2], *ost), 1, 1, b, hq, k.shape[1], s, d, dv,
             1.0 / math.sqrt(d), 1, window, torch.cuda.current_device(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def run_ssd(lib_path: pathlib.Path, x, dt, a, bm, cm, chunk: int):
    fn = ctypes.CDLL(str(lib_path)).ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    B, L, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), device="cuda")
    states = torch.empty((B, H, L // chunk, P, N), device="cuda")
    ltot = torch.empty((B, H, L // chunk), device="cuda")
    err = fn(x.data_ptr(), 1, dt.data_ptr(), 0, a.data_ptr(), 0, bm.data_ptr(), 1, cm.data_ptr(),
             1, y.data_ptr(), h.data_ptr(), states.data_ptr(), ltot.data_ptr(), 1, B, L, H, P, G,
             N, chunk, torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return y, h


def run_rglru(lib_path: pathlib.Path, a, b) -> torch.Tensor:
    fn = ctypes.CDLL(str(lib_path)).rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    codes = {torch.float32: 0, torch.bfloat16: 1}
    out = torch.empty_like(b)
    err = fn(a.data_ptr(), codes[a.dtype], b.data_ptr(), codes[b.dtype], out.data_ptr(),
             *a.shape, torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def flash_report(dirs: dict) -> None:
    m, hy = cs.MAIN, cs.HYBRID
    main_qkv = cs.qkv(cs.SEED, **m, dv=m["d"], dtype=torch.bfloat16)
    hy_qkv = cs.qkv(cs.SEED + 1, hy["b"], hy["hq"], hy["hkv"], hy["s"], hy["d"], hy["d"],
                    torch.bfloat16)
    want_main = ref.attention_ref(*main_qkv, causal=True)
    want_hy = ref.attention_ref(*hy_qkv, causal=True, window=hy["window"])
    for name in flash_variants():
        lib = dirs[name] / "k.so"
        err = max(float((run_flash(lib, *main_qkv) - want_main).float().abs().max()),
                  float((run_flash(lib, *hy_qkv, window=hy["window"]) - want_hy)
                        .float().abs().max()))
        t_main = cs.device_ms(lambda: run_flash(lib, *main_qkv))
        t_hy = cs.device_ms(lambda: run_flash(lib, *hy_qkv, window=hy["window"]))
        print(f"{name}: max|kernel-plain| {err:.3e}; device ms (1,16,2048,128) causal "
              f"{t_main:.4f}, (1,16,1,4096,256) window 2048 {t_hy:.4f}")


def ssd_report(dirs: dict) -> None:
    sm = cs.SSD_MAIN
    args = cs.ssd_inputs(cs.SEED, *(sm[k] for k in "BLHPGN"))
    y_want, _ = ref.ssd_sequential(*args)
    for name in ssd_variants():
        lib = dirs[name] / "k.so"
        y, _ = run_ssd(lib, *args, sm["chunk"])
        err = float((y.float() - y_want.float()).abs().max())
        t = cs.device_ms(lambda: run_ssd(lib, *args, sm["chunk"]))
        print(f"{name}: max|kernel-plain| {err:.3e}; device ms (2,2048,24,64,G1,N128,Q256) "
              f"{t:.4f} (three launches)")


def rglru_report(dirs: dict, rounds: int = 5) -> None:
    """Accuracy once, then device time in ``rounds`` round-robin passes over
    the variants (their times drift between calls): median, min and max."""
    main32 = cs.rglru_inputs(cs.SEED, **cs.RGLRU_MAIN)
    main16 = cs.rglru_inputs(cs.SEED, **cs.RGLRU_MAIN, dtype=torch.bfloat16)
    want32 = ref.rglru_ref(*main32)
    # a = 1 over many tiles with a ragged tail: the carry never fades
    ones = cs.rglru_inputs(cs.SEED + 1, **dict(cs.RGLRU_MAIN, L=4096 + 37), a_from="1")
    ones_ref, ones_exact = ref.rglru_ref(*ones), ref.rglru_sequential(*ones)
    libs = {name: dirs[name] / "k.so" for name in rglru_variants()}
    times = {name: ([], []) for name in libs}
    for _ in range(rounds):
        for name, lib in libs.items():
            times[name][0].append(cs.device_ms(lambda: run_rglru(lib, *main32), n=20))
            times[name][1].append(cs.device_ms(lambda: run_rglru(lib, *main16), n=20))
    spread = lambda ts: f"{statistics.median(ts):.4f} ({min(ts):.4f}-{max(ts):.4f})"
    for name, lib in libs.items():
        err = float((run_rglru(lib, *main32) - want32).abs().max())
        h1 = run_rglru(lib, *ones)
        print(f"{name}: max|kernel-plain| {err:.3e} at (1,4096,4096) fp32; a = 1 at "
              f"(1,4133,4096), share of 2e-5 (1 + |h|): against plain "
              f"{cs.share_of_tol(h1, ones_ref, 2e-5):.3f}, against an fp64 loop "
              f"{cs.share_of_tol(h1, ones_exact, 2e-5):.3f}; device ms (1,4096,4096), median "
              f"(min-max) of {rounds} rounds: fp32 {spread(times[name][0])}, "
              f"bf16 {spread(times[name][1])}")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    families = {"flash": flash_variants, "ssd": ssd_variants, "rglru": rglru_variants}
    chosen = sys.argv[1:] or list(families)
    if set(chosen) - set(families):
        print(f"kernel_variants: choose from {sorted(families)}", file=sys.stderr)
        return 2
    print(cs.card())
    variants = {n: s for f in chosen for n, s in families[f]().items()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
            futs = {n: pool.submit(compile_variant, pathlib.Path(tmp), n, s)
                    for n, s in variants.items()}
            dirs = {n: f.result() for n, f in futs.items()}
        print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s")
        for name, d in dirs.items():
            compiler_report(name, d)

        if "flash" in chosen:
            flash_report(dirs)
        if "ssd" in chosen:
            ssd_report(dirs)
        if "rglru" in chosen:
            rglru_report(dirs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
