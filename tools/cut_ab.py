#!/usr/bin/env python3
"""What a depth cut of one ``chip_smoke.py`` path would save, timed in
turns on one card.

    python3 tools/cut_ab.py --path ARCH --layers N [--seed S]   # one GPU

Runs the path alone, as the whole script runs it (``chip_smoke.py --path
ARCH``, a process of its own): a serving path's prefill, decode, images,
cold restores, logit check and profile; ``--path elastic``: phase 8 (c),
the elastic restores; ``--path orch``: phase 6, the orchestrator, the
interception baseline and the fleet; ``--path repl``: phase 5 (a)-(c),
replication and the serving pre-copy migration; ``--path dist``: phase 11,
the launchers over every card of the host (one rank per card), images
across devices and world sizes, the engine's modes across the ranks;
``--path train``: phase 3's qwen1.5 training.  It runs at N layers and
at the path's own depth, in the order cut, own, own, cut, so a drift of
the host over the four runs falls on both depths alike.  Each run's time
is the process's wall time, from its start to its exit.  The kernels are
built once before the first run.  Prints one line per run and a JSON
summary (the four times and the saving: the mean time at the path's own
depth minus the mean time at N layers) with the card's name and power
limit, and fails if a run fails.

    python3 tools/cut_ab.py --path ARCH --against DIR [--layers N]

times a change of the code instead: the path at one depth (its own, or
N layers) from the checkout at DIR (another commit's tree, unpacked with
``git archive``) and from this one, in the order DIR, this, this, DIR;
each tree's kernels are built before the first run.  The JSON then gives
``against_s``, ``this_s`` and the saving (DIR's mean minus this tree's).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def run(arch: str, seed: int, layers, root: Path = ROOT) -> float:
    """Wall seconds of one ``chip_smoke.py --path`` process of the tree
    at `root`."""
    with tempfile.TemporaryDirectory(prefix="cut_ab_") as workdir:
        cmd = [sys.executable, str(root / "chip_smoke.py"), "--seed",
               str(seed), "--path", arch, "--out",
               str(Path(workdir) / "launches.json")]
        if layers is not None:
            cmd += ["--layers", str(layers)]
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, timeout=1200).returncode
        wall = time.perf_counter() - t0
    if rc:
        raise SystemExit(f"{arch} at {layers or 'its own'} layers failed "
                         f"(exit {rc}, {root})")
    return wall


def main() -> int:
    paths = [p[0] for p in chip_smoke.SERVE_PATHS + chip_smoke.ZOO_PATHS
             + chip_smoke.MM_PATHS] + [chip_smoke.ELASTIC_PATH,
                                       chip_smoke.ORCH_PATH,
                                       chip_smoke.REPL_PATH,
                                       chip_smoke.DIST_PATH,
                                       chip_smoke.TRAIN_PATH]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", required=True, choices=paths)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--against", type=Path, help="time this tree against "
                    "the checkout at this directory, at one depth")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.layers is None and args.against is None:
        ap.error("--layers or --against is required")
    import torch
    if not torch.cuda.is_available():
        print("cut_ab: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all()
    if args.against is not None:
        other = args.against.resolve()
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import build; build.build_all()"], check=True,
                       cwd=other, env={**os.environ,
                                       "PYTHONPATH": str(other / "src")})
        times = {"against": [], "this": []}
        for mine in (False, True, True, False):
            wall = run(args.path, args.seed, args.layers,
                       ROOT if mine else other)
            times["this" if mine else "against"].append(wall)
            print(f"[cut_ab] {args.path} at {args.layers or 'its own'} "
                  f"layers, {'this tree' if mine else other}: {wall:.1f} s",
                  flush=True)
        print(json.dumps(dict(path=args.path, layers=args.layers,
                              against=str(other),
                              against_s=times["against"],
                              this_s=times["this"],
                              saving_s=(sum(times["against"])
                                        - sum(times["this"])) / 2)))
        print(chip_smoke.card_line())
        return 0
    times = {"cut": [], "own": []}
    for cut in (True, False, False, True):
        wall = run(args.path, args.seed, args.layers if cut else None)
        times["cut" if cut else "own"].append(wall)
        print(f"[cut_ab] {args.path} at "
              f"{args.layers if cut else 'its own'} layers: {wall:.1f} s",
              flush=True)
    print(json.dumps(dict(path=args.path, layers=args.layers,
                          cut_s=times["cut"], own_s=times["own"],
                          saving_s=(sum(times["own"])
                                    - sum(times["cut"])) / 2)))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
