#!/usr/bin/env python3
"""Quick card check of the tensor-core SSD kernel, for the first call after
an edit of ``csrc/ssd_scan_tc.cu`` or ``csrc/hopper.cuh``.

    python3 tools/ssd_tc_check.py          # needs one NVIDIA GPU and nvcc

Builds a copy of the sources whose mbarrier waits trap after ~4M polls (a
barrier that never completes then fails the launch instead of holding the
card), prints ptxas's register and spill lines and the HGMMA count, holds
the kernel against ``ssd_plain`` (y 5e-2, h 1e-4) and against its own
rounding model ``ssd_tc_plain`` at eight shapes, checks that two runs agree
bitwise, then times it against the CUDA-core kernel in turns (fma, tc, tc,
fma) at mamba2-2.7b's prefill shape, at tile 64 and at a 4096-token prompt,
with the device time of each of its launches.  About 40 s on the card;
``chip_smoke.py`` is the full check.
"""
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import _close, card_line, cuda_ms, ssd_inputs  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

TRAP_WAIT = r'''__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long n = 0;; ++n) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (n > (1l << 22)) __trap();
  }
}'''
CASES = [(1, 128, 1, 64, 128, 128), (1, 40, 2, 64, 16, 128),
         (2, 100, 3, 64, 32, 64), (1, 200, 2, 64, 64, 128),
         (2, 77, 4, 64, 128, 128), (1, 160, 2, 64, 32, 32),
         (4, 512, 80, 64, 128, 128), (4, 512, 80, 64, 128, 64)]
TIMED = [((4, 512, 80, 64, 128), 128), ((4, 512, 80, 64, 128), 64),
         ((1, 4096, 80, 64, 128), 128)]


def log(*a):
    print(*a, flush=True)


def trap_build(name: str) -> ctypes.CDLL:
    d = Path(tempfile.mkdtemp(prefix="ssd_tc_check_"))
    for f in build.CSRC.iterdir():
        shutil.copy(f, d / f.name)
    h = (d / "hopper.cuh").read_text()
    i = h.index("__device__ __forceinline__ void mbar_wait")
    j = h.index("\n}\n", i) + 3
    (d / "hopper.cuh").write_text(h[:i] + TRAP_WAIT + "\n" + h[j:])
    lib = d / f"lib{name}.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(d / f"{name}.cu")], capture_output=True,
                       text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if any(w in line for w in ("registers", "spill", "error")):
            log(f"[{name}] {line.strip()}")
    if r.returncode:
        raise SystemExit(f"nvcc failed for {name}")
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    log(f"[{name}] HGMMA {sum('HGMMA' in s for s in sass.splitlines())}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_tc_check: no CUDA device", file=sys.stderr)
        return 2
    log(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    log(card_line())
    lib = trap_build("ssd_scan_tc")
    real_load = build.load
    build.load = lambda n: lib if n == "ssd_scan_tc" else real_load(n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for case in CASES:
        B, S, nh, P, N, chunk = case
        args = ssd_inputs((B, S, nh, P, N), torch.bfloat16, gen)
        y, h = ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        y_p, h_p = ssd.ssd_plain(*args, chunk=128)
        y_m, h_m = ssd.ssd_tc_plain(*args, chunk=chunk)
        y2, h2 = ssd.ssd_scan(*args, chunk=chunk)
        ok = _close(y, y_p, 5e-2) and _close(h, h_p, 1e-4)
        same = torch.equal(y, y2) and torch.equal(h, h2)
        log(f"tc {case}: ok={ok} bitwise={same} y err "
            f"{(y.float() - y_p.float()).abs().max().item():.3g} (|y| "
            f"{y_p.float().abs().max().item():.3g}) h err "
            f"{(h - h_p).abs().max().item():.3g} (|h| "
            f"{h_p.abs().max().item():.3g}); vs tc model y "
            f"{(y.float() - y_m.float()).abs().max().item():.3g} h "
            f"{(h - h_m).abs().max().item():.3g}")
        bad += not (ok and same)
    if bad:
        log(f"{bad} cases failed")
        return 1
    for shape, chunk in TIMED:
        args = ssd_inputs(shape, torch.bfloat16, gen)
        ts = {"tc": [], "fma": []}
        for kind in ("fma", "tc", "tc", "fma"):
            ts[kind].append(cuda_ms(lambda: ssd.ssd_scan(*args, chunk=chunk,
                                                         kind=kind)))
        log(f"time {shape} chunk {chunk}: {ts}")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ssd.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                log(f"   {e.key[:70]}: "
                    f"{e.self_device_time_total / e.count / 1e3:.4f} ms "
                    f"x{e.count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
