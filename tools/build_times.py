#!/usr/bin/env python3
"""Time the build of the port's CUDA kernels with and without nvcc's
``--split-compile``, in turns, on a machine with the CUDA toolkit.

    python3 tools/build_times.py

``repro_torch.kernels.build`` starts one ``nvcc`` per source, all at
once.  This script builds every source that way into a temporary
directory with the package's flags and with them less
``--split-compile=0``, in the order with, without, without, with, then
each source alone with the package's flags, and prints each wall time
and a JSON summary.  Nothing is left in ``repro_torch/_build``.
"""
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels import build  # noqa: E402

SPLIT = "--split-compile=0"


def timed(names, flags, where: Path) -> float:
    """Wall seconds of one parallel build of `names` with `flags`."""
    build.NVCC_FLAGS, build.BUILD_DIR = flags, where
    t0 = time.perf_counter()
    build.build_all(names)
    return time.perf_counter() - t0


def main() -> int:
    flags = build.NVCC_FLAGS
    if SPLIT not in flags:
        raise SystemExit(f"the package's nvcc flags lack {SPLIT}")
    without = tuple(f for f in flags if f != SPLIT)
    out = {"split": [], "no_split": [], "alone_split": {}}
    for split in (True, False, False, True):
        with tempfile.TemporaryDirectory(prefix="build_times_") as d:
            s = timed(build.SOURCES, flags if split else without, Path(d))
        out["split" if split else "no_split"].append(s)
        print(f"[build] all sources, {'with' if split else 'without'} "
              f"{SPLIT}: {s:.1f} s", flush=True)
    for name in build.SOURCES:
        with tempfile.TemporaryDirectory(prefix="build_times_") as d:
            s = timed([name], flags, Path(d))
        out["alone_split"][name] = s
        print(f"[build] {name} alone, with {SPLIT}: {s:.1f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
