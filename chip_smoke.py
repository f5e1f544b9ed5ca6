#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]      # needs one card

Phase 1 builds the hand-written kernels from the sources in this checkout
(CUDA C++ flash attention, tensor-core bf16 and CUDA-core f32, and SSD
scan through nvcc, one process per source, Triton RMSNorm) and holds each
one against its plain PyTorch version on the card, at the JAX package's
test cases, at the zoo's head dims and at the shapes of the serving
paths, with the tolerances of ``tests/test_kernels.py`` (f32 2e-5, bf16
2e-2; SSD y 2e-4 f32 / 5e-2 bf16, h 1e-4).  It times the kernel, the
plain version and, where one exists, one PyTorch library call computing
the same function (a yardstick only; the port never calls it) and works
out each kernel's bound: the larger of (bytes moved / 3.35 TB/s) and
(operations / peak rate for their type: 989 TFLOP/s bf16, 67 TFLOP/s
f32), H100 SXM data sheet.  Two timings only: flash attention at a long
prompt, where operations bound it, and both RMSNorm designs at
2048 x 2560 and 2048 x 5120, in turns.  On a small input (each path's smoke config, f32)
the card's kernel path must match the CPU plain path to 1e-3.

Phase 2 serves each path at full published width with random weights
from ``--seed`` (bf16 compute over f32 masters, kernels on): qwen1.5-0.5b
(KV cache; flash attention + RMSNorm) with a sync and an async snapshot,
then mamba2-2.7b (SSM cache; SSD scan + RMSNorm) with a sync snapshot.
Each prefills a batch of prompts, decodes greedily, snapshots
mid-generation, and a fresh server cold-restores the image and carries on
token-exact; each image is deleted once checked.  The kernels' launch
counters are zeroed just before each path's serving run and read just
after it.  Each path's bf16 kernel logits are then held against its f32
plain path (mamba2's over its first 4 layers), and one prefill and a few
decode steps are profiled.

Every phase must pass; the script exits non-zero otherwise, and at once
(printing no result) when no CUDA device is present or the package is not
beside it.  The last line is the device summary.
"""
import os

# before torch is imported: cuBLAS picks its workspace at initialisation,
# and bitwise resume needs the deterministic one
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}

# (B, Sq, Sk, H, KV, hd, causal, window): tests/test_kernels.py:22-29
ATTN_CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (1, 192, 192, 4, 2, 32, True, 64),
    (2, 64, 160, 4, 4, 64, False, 0),
    (1, 100, 100, 2, 1, 16, True, 0),
    (2, 256, 256, 40, 10, 128, True, 0),     # phi3-medium's heads, hd 128
    (1, 192, 192, 32, 8, 80, True, 64),      # h2o-danube's hd 80, window
]
ATTN_SLICE = (4, 512, 512, 16, 16, 64, True, 0)   # qwen1.5-0.5b prefill
# timing only: phi3-medium's attention at a 4096-token prompt, bounded by
# operations (172 GFLOP against 105 MB)
ATTN_LONG = (1, 4096, 4096, 40, 10, 128, True, 0)
NORM_SLICE = (2048, 1024)                          # prefill rows x d_model
NORM_DESIGN_SHAPE = (2048, 5120)                   # mamba2's gated norm
# both RMSNorm designs, timed in turns: mamba2's block and gated norms
NORM_DESIGN_SHAPES = [(2048, 2560), NORM_DESIGN_SHAPE]
# qwen1.5 block norms (prefill, decode), odd widths, then mamba2's block
# norms (d_model 2560) and gated norms (d_inner 5120)
NORM_CASES = [(2048, 1024), (4, 1024), (21, 96), (1, 384), (130, 384),
              (2048, 2560), (4, 2560), (2048, 5120), (4, 5120)]
# (B, S, nh, P, N, chunk): tests/test_kernels.py:70-74, then the mamba2
# smoke config's prefill (a partial last chunk) and jamba's (P, N)
SSD_CASES = [
    (1, 64, 2, 16, 32, 16),
    (2, 100, 3, 32, 64, 32),
    (1, 128, 1, 64, 128, 128),
    (2, 12, 8, 16, 16, 8),
    (1, 40, 2, 64, 16, 128),
]
SSD_SLICE = (4, 512, 80, 64, 128, 128)             # mamba2-2.7b prefill
SSD_INVARIANCE = ((1, 96, 2, 16, 32), 96, (16, 32, 48))   # :92-107
SSD_TOL = {"torch.float32": 2e-4, "torch.bfloat16": 5e-2}
SSD_H_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time of one fn() call in ms: CUDA events around `iters`
    back-to-back calls, queued behind a spin kernel so the host's launch
    overhead is not counted; median of `reps` such windows."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)      # ~25 ms: the queue fills meanwhile
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[len(times) // 2]


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phase 1
def attention_case(case, dtype, gen, timing_only: bool = False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KV, hd, causal, window = case
    dev = "cuda"
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    run = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                     window=window)
    out = run()
    torch.cuda.synchronize()
    # one owner per output element, no atomics: bitwise the same again
    ok = bool(torch.isfinite(out.float()).all()) and torch.equal(out, run())
    visible = int(fa._visible(Sq, Sk, causal, window, dev).sum())
    flops = 4.0 * B * H * hd * visible
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, flops, dtype)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window or (causal and Sq != Sk):
        mask = fa._visible(Sq, Sk, causal, window, dev)
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=H != KV)

    def lib():
        # the yardstick at its fastest: deterministic mode (which the
        # serving phase needs) steers SDPA to a slower backend
        torch.use_deterministic_algorithms(False)
        try:
            return sdpa()
        finally:
            torch.use_deterministic_algorithms(True)
    if timing_only:     # the plain version would not fit: SDPA instead
        want, plain_ms = lib().transpose(1, 2), None
    else:
        want = fa.attention_plain(q, k, v, causal=causal, window=window)
        plain_ms = cuda_ms(lambda: fa.attention_plain(
            q, k, v, causal=causal, window=window))
        ok = ok and (out.float() - want.float()).abs().max().item() <= \
            TOL[str(dtype)]
    ms = cuda_ms(run)
    return {
        "ok": ok, "variant": fa.variant(dtype, hd),
        "max_abs_err": (out.float() - want.float()).abs().max().item(),
        "ms": ms, "plain_ms": plain_ms, "library_ms": cuda_ms(lib),
        "bound_ms": b_ms, "bound_by": b_by, "tflops": flops / ms / 1e9,
    }


def rmsnorm_designs(gen) -> dict:
    """Both RMSNorm designs at NORM_DESIGN_SHAPES (bf16), timed in turns;
    {shape: {design: {"ms": [first, second], "ok": bool}}}."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    out = {}
    for rows, d in NORM_DESIGN_SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        s = torch.randn(d, generator=gen, device="cuda")
        want = rn.rmsnorm_plain(x, s)
        times = {name: [] for name in rn.DESIGNS}
        for name in rn.DESIGNS + rn.DESIGNS[::-1]:
            times[name].append(cuda_ms(lambda: rn.rmsnorm(x, s,
                                                          design=name)))
        res = out[f"{rows}x{d}"] = {}
        for name in rn.DESIGNS:
            got = rn.rmsnorm(x, s, design=name)
            res[name] = {"ms": times[name], "ok": got.dtype == x.dtype
                         and _close(got, want, 2e-2)}
    return out


def rmsnorm_case(shape, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    rows, d = shape
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    s = torch.randn(d, generator=gen, device="cuda")
    out = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    want = rn.rmsnorm_plain(x, s)
    err = (out.float() - want.float()).abs().max().item()
    # the criterion of tests/test_kernels.py:14-16 (rtol = atol): at
    # d = 5120, |y| reaches ~20, where one bf16 step is 0.125
    ok = out.dtype == x.dtype and _close(out, want, TOL[str(dtype)])
    nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
    b_ms, b_by = bound(nbytes, 4.0 * x.numel(), torch.float32)
    sx = s.to(dtype)
    return {
        "ok": ok, "max_abs_err": err,
        "ms": cuda_ms(lambda: rn.rmsnorm(x, s)),
        "plain_ms": cuda_ms(lambda: rn.rmsnorm_plain(x, s)),
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), sx, eps=1e-5)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def _close(got, want, tol: float) -> bool:
    """Finite, and |got - want| <= tol + tol·|want| everywhere (the
    tests' assert_allclose with rtol = atol = tol)."""
    import torch
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= tol + tol * want.abs()).all())


def ssd_inputs(shape, dtype, gen):
    import torch
    import torch.nn.functional as F
    B, S, nh, P, N = shape
    dev = "cuda"
    x = torch.randn(B, S, nh, P, generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn(B, S, nh, generator=gen, device=dev))
    A = -torch.exp(0.3 * torch.randn(nh, generator=gen, device=dev))
    Bm = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
    Cm = torch.randn(B, S, N, generator=gen, device=dev).to(dtype)
    return x, dt, A, Bm, Cm


def ssd_flops(B, S, nh, P, N) -> float:
    """Operations SSD needs on this input, whatever tile a kernel uses:
    the fewer of the per-step recurrence (h·decay + dt·x⊗B, then C·h:
    5·N·P per head) and the chunked form at the chunk length T that
    minimises it.  Per step of a T-step chunk, causal halves only: C·Bᵀ
    (T+1)·N, shared by the heads, and per head G·x (T+1)·P, C·hᵀ and
    xᵀ·W 2·N·P each, and the state's decay N·P/T."""
    chunked = min((T + 1) * N + nh * ((T + 1) * P + 4 * N * P + N * P / T)
                  for T in range(1, S + 1))
    return float(B * S * min(chunked, 5 * nh * N * P))


def ssd_case(case, dtype, gen):
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    B, S, nh, P, N, chunk = case
    args = ssd_inputs((B, S, nh, P, N), dtype, gen)
    y, h = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    y_p, h_p = ssd.ssd_plain(*args, chunk=chunk)
    ok = (y.dtype == dtype and h.dtype == torch.float32
          and _close(y, y_p, SSD_TOL[str(dtype)]) and _close(h, h_p, SSD_H_TOL))
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y, h))
    b_ms, b_by = bound(nbytes, ssd_flops(B, S, nh, P, N), torch.float32)
    return {
        "ok": ok, "max_abs_err": (y.float() - y_p.float()).abs().max().item(),
        "h_max_abs_err": (h - h_p).abs().max().item(),
        "y_max_abs": y_p.float().abs().max().item(),
        "ms": cuda_ms(lambda: ssd.ssd_scan(*args, chunk=chunk)),
        "plain_ms": cuda_ms(lambda: ssd.ssd_plain(*args, chunk=chunk)),
        "library_ms": None,          # no single PyTorch call computes SSD
        "bound_ms": b_ms, "bound_by": b_by,
    }


def ssd_chunk_invariance(gen) -> list:
    """The kernel at several chunks against the plain version at one."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    shape, ref_chunk, chunks = SSD_INVARIANCE
    args = ssd_inputs(shape, torch.float32, gen)
    y0, h0 = ssd.ssd_plain(*args, chunk=ref_chunk)
    failed = []
    for c in chunks:
        y, h = ssd.ssd_scan(*args, chunk=c)
        ok = _close(y, y0, 2e-4) and _close(h, h0, 2e-4)
        log(f"[kernels] ssd_scan chunk {c} vs plain chunk {ref_chunk} "
            f"{shape}: ok={ok} err={(y - y0).abs().max().item():.3g}")
        if not ok:
            failed.append(("ssd_scan", "chunk", c))
    return failed


def tensor_core_instructions(library) -> int:
    """HGMMA (wgmma) instructions in a built library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def phase_kernels(seed: int) -> dict:
    """Build, check and time the kernels; returns the slice-shape rows."""
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[kernels] nvcc build {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                log(f"[kernels] {name}: {line.strip()}")
    hgmma = tensor_core_instructions(build.library_path("flash_attention_tc"))
    log(f"[kernels] flash_attention_tc: {hgmma} HGMMA instructions in its "
        f"SASS")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    failed = [] if hgmma else [("flash_attention_tc", "no HGMMA in SASS")]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ATTN_CASES + [ATTN_SLICE]:
            r = attention_case(case, dtype, gen)
            tag = "slice" if case == ATTN_SLICE else "case"
            log(f"[kernels] flash_attention ({r['variant']}) {tag} {case} "
                f"{dtype}: ok={r['ok']} err={r['max_abs_err']:.3g} "
                f"ms={r['ms']:.5f} plain={r['plain_ms']:.4f} "
                f"sdpa={r['library_ms']:.5f} bound={r['bound_ms']:.5f} "
                f"({r['bound_by']}) {r['tflops']:.1f} TFLOP/s")
            if not r["ok"]:
                failed.append(("flash_attention", case, str(dtype)))
            if case == ATTN_SLICE:
                rows[f"flash_attention/{r['variant']}"] = r
        for shape in NORM_CASES:
            r = rmsnorm_case(shape, dtype, gen)
            log(f"[kernels] rmsnorm {shape} {dtype}: ok={r['ok']} "
                f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']})")
            if not r["ok"]:
                failed.append(("rmsnorm", shape, str(dtype)))
            if dtype == torch.bfloat16 and shape in (
                    NORM_SLICE, NORM_DESIGN_SHAPE):
                rows[f"rmsnorm/{shape[1]}"] = r
        for case in SSD_CASES + [SSD_SLICE]:
            r = ssd_case(case, dtype, gen)
            tag = "slice" if case == SSD_SLICE else "case"
            log(f"[kernels] ssd_scan {tag} {case} {dtype}: ok={r['ok']} "
                f"y err {r['max_abs_err']:.3g} (|y| max "
                f"{r['y_max_abs']:.3g}) h err {r['h_max_abs_err']:.3g} "
                f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']})")
            if not r["ok"]:
                failed.append(("ssd_scan", case, str(dtype)))
            if case == SSD_SLICE and dtype == torch.bfloat16:
                rows["ssd_scan"] = r
    failed += ssd_chunk_invariance(gen)
    r = attention_case(ATTN_LONG, torch.bfloat16, gen, timing_only=True)
    log(f"[kernels] flash_attention ({r['variant']}) long {ATTN_LONG} "
        f"bf16, timing only: ms={r['ms']:.5f} sdpa={r['library_ms']:.5f} "
        f"bound={r['bound_ms']:.5f} ({r['bound_by']}), "
        f"{r['tflops']:.1f} TFLOP/s; max diff from SDPA "
        f"{r['max_abs_err']:.3g}; deterministic {r['ok']}")
    if not r["ok"]:
        failed.append(("flash_attention", ATTN_LONG, "bf16"))
    rows["flash_attention/long"] = r
    designs = rmsnorm_designs(gen)
    for shape, res in designs.items():
        log(f"[kernels] rmsnorm designs at {shape} bf16, in turns: "
            + "; ".join(f"{k} {v['ms']} ms ok={v['ok']}"
                        for k, v in res.items()))
        failed += [("rmsnorm", shape, k) for k, v in res.items()
                   if not v["ok"]]
    rows["rmsnorm/designs"] = {shape: {k: v["ms"] for k, v in res.items()}
                               for shape, res in designs.items()}
    if failed:
        raise SystemExit(f"kernel check failed: {failed}")
    return rows


# ----------------------------------------------------------------- phase 2
SERVE_B, SERVE_S, SERVE_MAX = 4, 512, 1024
SERVE_TOKENS = 16
# each serving path: its config, its snapshot modes, the kernels it must
# launch, and the depth of its logit check (None: every layer)
SERVE_PATHS = (
    ("qwen1.5-0.5b", ("sync", "async"), ("flash_attention", "rmsnorm"),
     None),
    ("mamba2-2.7b", ("sync",), ("ssd_scan", "rmsnorm"), 4),
)
# At full width the bf16 kernel path and the bf16 plain path round at
# different places (the kernels keep attention scores and probabilities in
# f32), and many random layers amplify that: both are held against the f32
# plain path, and the kernel path must be no further from it than
# LOGIT_SLACK times the plain bf16 path's own distance.  Mamba2's 64
# random layers carry both bf16 paths O(1) logits away from f32, where a
# wrong SSD kernel would not show, so its check runs the first 4 layers of
# the full-width params.
LOGIT_SLACK = 1.5


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": fa, "rmsnorm": rn, "ssd_scan": ssd}


def _zero_counters() -> None:
    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    fa = counters["flash_attention"]
    fa.launches_tc = fa.launches_fma = 0
    fa.served.clear()


def _flash_variants() -> dict:
    """Launches of each flash-attention variant since the counters were
    zeroed, with the (dtype, head dim) each served."""
    fa = _counters()["flash_attention"]
    served = {"tc": [], "fma": []}
    for (kind, dtype, hd), n in sorted(fa.served.items()):
        served[kind].append([dtype, hd, n])
    return {"tc": fa.launches_tc, "fma": fa.launches_fma, "served": served}


def check_small_reference(arch: str, seed: int) -> None:
    """The card's kernel path agrees with the CPU plain path on a small
    input (the smoke config, f32, the same params): logits to 1e-3."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import LM
    cfg = get_smoke_config(arch)
    cpu = LM(cfg, compute_dtype=torch.float32, device="cpu")
    gpu = LM(cfg, compute_dtype=torch.float32, use_kernels=True,
             device="cuda")
    params = cpu.init(seed)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 24)))
    want, _ = cpu.prefill(params, {"tokens": toks})
    got, _ = gpu.prefill(_map(lambda t: t.cuda(), params),
                         {"tokens": toks.cuda()})
    err = (got.cpu() - want).abs()[:, :cfg.vocab_size].max().item()
    log(f"[reference] {cfg.name}, card kernels vs CPU plain: max logit "
        f"err {err:.3g} (tol 1e-3)")
    if not err <= 1e-3:
        raise SystemExit(f"{arch}: card path disagrees with the CPU "
                         f"reference")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _image_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def phase_serving(arch: str, modes, kernels, check_layers, seed: int,
                  workdir: str) -> dict:
    """Serve `arch` at full width with snapshots; returns the kernels'
    launches on this serving path, and flash attention's by variant."""
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer

    cfg = get_config(arch)
    dev = torch.device("cuda")
    model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
               device=dev)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"vocab {cfg.padded_vocab}; {n_params} f32 params "
        f"({n_params * 4 / 2**30:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)

    counters = _counters()
    _zero_counters()                  # this path's launches start here
    for mode in modes:
        run = os.path.join(workdir, mode)
        opts = CheckpointOptions(mode=mode)
        srv = DecodeServer(cfg, run, max_seq=SERVE_MAX, options=opts,
                           device=dev, model=model)
        srv.load(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.start({"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        srv.decode(SERVE_TOKENS)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / SERVE_TOKENS
        t0 = time.perf_counter()
        path = srv.checkpoint(srv.pos)
        dump_s = time.perf_counter() - t0
        st = dict(srv.session.last_stats)
        step = srv.pos
        expected = srv.decode(SERVE_TOKENS).copy()
        srv.session.wait_pending()
        write_s = srv.session.last_stats.get("write_s", float("nan"))
        image = _image_bytes(path)

        t0 = time.perf_counter()
        fresh = DecodeServer(cfg, run, max_seq=SERVE_MAX, options=opts,
                             device=dev, model=model)
        fresh.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = fresh.decode(SERVE_TOKENS)
        same = fresh.pos == srv.pos and np.array_equal(got, expected)
        freeze_ms = (st["lock_s"] + st["frozen_s"]) * 1e3
        log(f"[serve] {cfg.name} {mode}: prefill {prefill_ms:.1f} ms "
            f"(B={SERVE_B}, S={SERVE_S}); decode {decode_ms:.2f} ms/token; "
            f"snapshot at pos {step}: freeze (lock + D2H) {freeze_ms:.1f} ms, "
            f"dump call {dump_s:.2f} s, write {write_s:.2f} s, image "
            f"{image} bytes; cold restore {restore_s:.2f} s; "
            f"continuation token-exact: {same}")
        if not same:
            raise SystemExit(f"{cfg.name} {mode}: cold-restored server "
                             f"diverged")
        del srv, fresh
        shutil.rmtree(run)            # one image on the disk at a time
        torch.cuda.empty_cache()
    launches = {name: mod.launches for name, mod in counters.items()}
    variants = _flash_variants()
    log(f"[serve] {cfg.name}: kernel launches on the serving path: "
        f"{launches}; flash attention by variant: {variants}")
    if not all(launches[k] for k in kernels):
        raise SystemExit(f"{cfg.name}: a kernel of the path was not "
                         f"launched while serving: {launches}")
    # bf16 at the zoo's head dims runs on the tensor cores, never on FMAs
    if "flash_attention" in kernels and not (variants["tc"]
                                             and not variants["fma"]):
        raise SystemExit(f"{cfg.name}: bf16 prefill attention did not go "
                         f"through the tensor-core kernel alone: {variants}")

    # kernel path against the plain path at full width (not counted)
    ccfg, cparams = cfg, params
    if check_layers:
        ccfg = dataclasses.replace(cfg, num_layers=check_layers)
        n_sb = check_layers // len(cfg.layer_pattern)
        cparams = dict(params, blocks=_map(lambda t: t[:n_sb],
                                           params["blocks"]))
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                       device=dev)}
    out = {}
    for name, m in (("kernels", LM(ccfg, compute_dtype=torch.bfloat16,
                                   use_kernels=True, device=dev)),
                    ("plain", LM(ccfg, compute_dtype=torch.bfloat16,
                                 device=dev)),
                    ("f32", LM(ccfg, compute_dtype=torch.float32,
                               device=dev))):
        out[name] = m.prefill(cparams, batch)[0][:, :cfg.vocab_size].float()
    ref = out["f32"]
    err = {k: (out[k] - ref).abs().max().item() for k in ("kernels", "plain")}
    agree = {k: (out[k].argmax(-1) == ref.argmax(-1)).float().mean().item()
             for k in ("kernels", "plain")}
    log(f"[serve] {cfg.name} ({ccfg.num_layers} layers) prefill logits "
        f"{tuple(ref.shape)} (|logit| max {ref.abs().max().item():.3g}) "
        f"against the f32 plain path: bf16 kernels max err "
        f"{err['kernels']:.3g}, argmax agreement {agree['kernels']:.2f}; "
        f"bf16 plain max err {err['plain']:.3g}, argmax agreement "
        f"{agree['plain']:.2f}; bf16 kernels vs bf16 plain max diff "
        f"{(out['kernels'] - out['plain']).abs().max().item():.3g}")
    if not (torch.isfinite(out["kernels"]).all()
            and err["kernels"] <= LOGIT_SLACK * err["plain"]):
        raise SystemExit(f"{cfg.name}: full-width kernel path is further "
                         f"from the f32 reference than the plain bf16 path")
    del out, ref, cparams
    profile_serving(model, params, prompts, dev)
    return launches, variants


def profile_serving(model, params, prompts, dev) -> None:
    """torch.profiler over one prefill and a few decode steps (outside the
    counted window): device busy share and the ops that take its time."""
    import torch
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    cache = model.init_cache(prompts.shape[0], SERVE_MAX)
    last = tokens[:, -1]
    runs = {
        "prefill": (1, lambda i: model.prefill(params, {"tokens": tokens})),
        "decode": (4, lambda i: model.decode_step(params, cache, last,
                                                  SERVE_S + i)),
    }
    for name, (steps, fn) in runs.items():
        fn(0)                                                  # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                fn(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        # device rows only (kernels, copies): a CPU op's self device time
        # is the kernels it launched, which have rows of their own
        rows = [e for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in rows) / steps / 1e3
        n_ops = sum(e.count for e in rows) // steps
        log(f"[profile] {model.cfg.name} {name} (profiled): wall "
            f"{wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
            f"({busy_ms / wall_ms:.0%}), {n_ops} device kernels and "
            f"copies/step")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"[profile]   {e.key[:60]}: "
                f"{e.self_device_time_total / steps / 1e3:.3f} ms/step "
                f"x{e.count // steps}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------- main
KERNEL_ROWS = (
    ("flash_attention", "cuda", "src/repro_torch/csrc/flash_attention_tc.cu",
     "src/repro/kernels/flash_attention.py:29"),
    ("rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm.py",
     "src/repro/kernels/rmsnorm.py:19"),
    ("ssd_scan", "cuda", "src/repro_torch/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:31"),
)
# each row's numbers: the bf16 case at its slice shape
ROW_CASE = {"flash_attention": "flash_attention/tc",
            "rmsnorm": f"rmsnorm/{NORM_SLICE[1]}", "ssd_scan": "ssd_scan"}
FLASH_SOURCES = {"tc": "src/repro_torch/csrc/flash_attention_tc.cu",
                 "fma": "src/repro_torch/csrc/flash_attention.cu"}
TIMES = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
         "bound_by")


def kernel_rows(rows: dict, by_path: dict) -> list:
    """The `kernels` line: one row per kernel (its slice case, its launches
    on the serving paths), flash attention's variants (tc at the bf16
    slice, fma at the f32 slice) and long-prompt timing, RMSNorm at
    d = 5120 and its two designs."""
    out = []
    for name, route, source, replaces in KERNEL_ROWS:
        row = dict(name=name, route=route, source=source, replaces=replaces,
                   **{k: rows[ROW_CASE[name]][k] for k in TIMES})
        row["launches"] = sum(p[name] for p, _ in by_path.values())
        row["launches_by_path"] = {a: p[name] for a, (p, _) in
                                   by_path.items()}
        out.append(row)
    fa_row, rn_row = out[0], out[1]
    fa_row["variants"] = [dict(
        variant=kind, source=FLASH_SOURCES[kind],
        launches=sum(v[kind] for _, v in by_path.values()),
        served=[s for _, v in by_path.values() for s in v["served"][kind]],
        timed_dtype="bfloat16" if kind == "tc" else "float32",
        **{k: rows[f"flash_attention/{kind}"][k] for k in TIMES})
        for kind in ("tc", "fma")]
    long = rows["flash_attention/long"]
    fa_row["long"] = dict(case=list(ATTN_LONG), tflops=long["tflops"],
                          **{k: long[k] for k in TIMES if k != "plain_ms"})
    rn_row["wide"] = dict(shape=list(NORM_DESIGN_SHAPE), **{
        k: rows[f"rmsnorm/{NORM_DESIGN_SHAPE[1]}"][k] for k in TIMES})
    rn_row["designs_ms"] = rows["rmsnorm/designs"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    # deterministic mode would also NaN-fill every fresh allocation (a
    # debugging aid: one extra kernel per torch.empty); results do not
    # depend on it
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; {card}")
    rows = phase_kernels(args.seed)
    for arch, *_ in SERVE_PATHS:
        check_small_reference(arch, args.seed)
    by_path = {}
    for arch, modes, kernels, check_layers in SERVE_PATHS:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            by_path[arch] = phase_serving(arch, modes, kernels, check_layers,
                                          args.seed, workdir)
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": kernel_rows(rows, by_path)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
