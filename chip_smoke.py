#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]      # needs one card

Phase 1 builds the hand-written kernels from the sources in this checkout
(CUDA C++ flash attention through nvcc, Triton RMSNorm) and holds each one
against its plain PyTorch version on the card, at the JAX package's test
cases and at the shapes of the serving path, with the tolerances of
``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2).  It times the kernel, the
plain version and one PyTorch library call computing the same function
(a yardstick only; the port never calls it) and works out each kernel's
bound: the larger of (bytes moved / 3.35 TB/s) and (operations / peak rate
for their type: 989 TFLOP/s bf16, 67 TFLOP/s f32), H100 SXM data sheet.

Phase 2 serves qwen1.5-0.5b at full published width with random weights
from ``--seed`` (bf16 compute over f32 masters, kernels on): prefill of a
batch of prompts, greedy decode, a sync and an async snapshot
mid-generation, and a fresh server cold-restoring each image and carrying
on token-exact.  The kernels' launch counters are zeroed just before the
serving run and read just after it.

Every phase must pass; the script exits non-zero otherwise, and at once
(printing no result) when no CUDA device is present or the package is not
beside it.  The last line is the device summary.
"""
import os

# before torch is imported: cuBLAS picks its workspace at initialisation,
# and bitwise resume needs the deterministic one
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import argparse
import json
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
]
ATTN_SLICE = (4, 512, 512, 16, 16, 64, True, 0)   # qwen1.5-0.5b prefill
NORM_SLICE = (2048, 1024)                          # prefill rows x d_model
NORM_CASES = [(2048, 1024), (4, 1024), (21, 96), (1, 384), (130, 384)]


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
def attention_case(case, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KV, hd, causal, window = case
    dev = "cuda"
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.attention_plain(q, k, v, causal=causal, window=window)
    err = (out.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err <= TOL[str(dtype)]
    visible = int(fa._visible(Sq, Sk, causal, window, dev).sum())
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 4.0 * B * H * hd * visible, dtype)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window or (causal and Sq != Sk):
        mask = fa._visible(Sq, Sk, causal, window, dev)
    lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=H != KV)
    return {
        "ok": ok, "max_abs_err": err,
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                 window=window)),
        "plain_ms": cuda_ms(lambda: fa.attention_plain(
            q, k, v, causal=causal, window=window)),
        "library_ms": cuda_ms(lib),
        "bound_ms": b_ms, "bound_by": b_by,
    }


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
    ok = (bool(torch.isfinite(out.float()).all()) and out.dtype == x.dtype
          and err <= TOL[str(dtype)])
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


def phase_kernels(seed: int) -> dict:
    """Build, check and time both kernels; returns the slice-shape rows."""
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
    gen = torch.Generator(device="cuda").manual_seed(seed)
    failed = []
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ATTN_CASES + [ATTN_SLICE]:
            r = attention_case(case, dtype, gen)
            tag = "slice" if case == ATTN_SLICE else "case"
            log(f"[kernels] flash_attention {tag} {case} {dtype}: "
                f"ok={r['ok']} err={r['max_abs_err']:.3g} "
                f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
                f"sdpa={r['library_ms']:.4f} bound={r['bound_ms']:.4f} "
                f"({r['bound_by']})")
            if not r["ok"]:
                failed.append(("flash_attention", case, str(dtype)))
            if case == ATTN_SLICE and dtype == torch.bfloat16:
                rows["flash_attention"] = r
        for shape in NORM_CASES:
            r = rmsnorm_case(shape, dtype, gen)
            log(f"[kernels] rmsnorm {shape} {dtype}: ok={r['ok']} "
                f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']})")
            if not r["ok"]:
                failed.append(("rmsnorm", shape, str(dtype)))
            if shape == NORM_SLICE and dtype == torch.bfloat16:
                rows["rmsnorm"] = r
    if failed:
        raise SystemExit(f"kernel check failed: {failed}")
    return rows


# ----------------------------------------------------------------- phase 2
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_B, SERVE_S, SERVE_MAX = 4, 512, 1024
SERVE_TOKENS = 16
# At full width the bf16 kernel path and the bf16 plain path round at
# different places (the kernels keep attention scores and probabilities in
# f32), and 24 random layers amplify that: both are held against the f32
# plain path, and the kernel path must be no further from it than
# LOGIT_SLACK times the plain bf16 path's own distance.
LOGIT_SLACK = 1.5


def check_small_reference(seed: int) -> None:
    """The card's kernel path agrees with the CPU plain path on a small
    input (the smoke config, f32, the same params): logits to 1e-3."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import LM
    cfg = get_smoke_config(SERVE_ARCH)
    cpu = LM(cfg, compute_dtype=torch.float32, device="cpu")
    gpu = LM(cfg, compute_dtype=torch.float32, use_kernels=True,
             device="cuda")
    params = cpu.init(seed)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 24)))
    want, _ = cpu.prefill(params, {"tokens": toks})
    got, _ = gpu.prefill(_to(params, "cuda"), {"tokens": toks.cuda()})
    err = (got.cpu() - want).abs()[:, :cfg.vocab_size].max().item()
    log(f"[reference] smoke config, card kernels vs CPU plain: max logit "
        f"err {err:.3g} (tol 1e-3)")
    if not err <= 1e-3:
        raise SystemExit("card path disagrees with the CPU reference")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _image_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def phase_serving(seed: int, workdir: str) -> dict:
    """Serve at full width with snapshots; returns the kernels' launches
    on the serving path."""
    import numpy as np
    import torch
    from repro_torch.api import CheckpointOptions
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer

    cfg = get_config(SERVE_ARCH)
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

    fa.launches = 0          # the serving path's launches start here
    rn.launches = 0
    for mode in ("sync", "async"):
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
        log(f"[serve] {mode}: prefill {prefill_ms:.1f} ms "
            f"(B={SERVE_B}, S={SERVE_S}); decode {decode_ms:.2f} ms/token; "
            f"snapshot at pos {step}: freeze (lock + D2H) {freeze_ms:.1f} ms, "
            f"dump call {dump_s:.2f} s, write {write_s:.2f} s, image "
            f"{image} bytes; cold restore {restore_s:.2f} s; "
            f"continuation token-exact: {same}")
        if not same:
            raise SystemExit(f"{mode}: cold-restored server diverged")
        del srv, fresh
        torch.cuda.empty_cache()
    launches = {"flash_attention": fa.launches, "rmsnorm": rn.launches}
    log(f"[serve] kernel launches on the serving path: {launches}")
    if not all(launches.values()):
        raise SystemExit(f"a kernel was not launched while serving: "
                         f"{launches}")

    # kernel path against the plain path at full width (not counted)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                       device=dev)}
    out = {}
    for name, m in (("kernels", model),
                    ("plain", LM(cfg, compute_dtype=torch.bfloat16,
                                 device=dev)),
                    ("f32", LM(cfg, compute_dtype=torch.float32,
                               device=dev))):
        out[name] = m.prefill(params, batch)[0][:, :cfg.vocab_size].float()
    ref = out["f32"]
    err = {k: (out[k] - ref).abs().max().item() for k in ("kernels", "plain")}
    agree = {k: (out[k].argmax(-1) == ref.argmax(-1)).float().mean().item()
             for k in ("kernels", "plain")}
    log(f"[serve] prefill logits {tuple(ref.shape)} (|logit| max "
        f"{ref.abs().max().item():.3g}) against the f32 plain path: "
        f"bf16 kernels max err {err['kernels']:.3g}, argmax agreement "
        f"{agree['kernels']:.2f}; bf16 plain max err {err['plain']:.3g}, "
        f"argmax agreement {agree['plain']:.2f}")
    if not (torch.isfinite(out["kernels"]).all()
            and err["kernels"] <= LOGIT_SLACK * err["plain"]):
        raise SystemExit("full-width kernel path is further from the f32 "
                         "reference than the plain bf16 path")
    profile_serving(model, params, prompts, dev)
    return launches


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
        rows = [e for e in prof.key_averages()
                if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in rows) / steps / 1e3
        n_ops = sum(e.count for e in rows) // steps
        log(f"[profile] {name} (profiled): wall {wall_ms:.2f} ms/step, "
            f"device busy {busy_ms:.2f} ms/step ({busy_ms / wall_ms:.0%}), "
            f"{n_ops} device ops/step")
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
    check_small_reference(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = phase_serving(args.seed, workdir)
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:29",
             **rows["flash_attention"]),
        dict(name="rmsnorm", route="triton",
             source="src/repro_torch/kernels/rmsnorm.py",
             replaces="src/repro/kernels/rmsnorm.py:19", **rows["rmsnorm"]),
    ]
    for k in kernels:
        k.pop("ok")
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
