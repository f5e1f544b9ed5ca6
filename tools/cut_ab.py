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
``--path train``: phase 3's qwen1.5 training; ``--path train-zoo/ARCH``:
phase 10's training of one arch of ``ZOO_TRAIN`` (its grad check, its
runs, its image and cold restore where it has one).  It runs at N layers and
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

    python3 tools/cut_ab.py --path ARCH --beside OTHER [--layers N]

times a placement: the path (at its own depth, or N layers) and the path
OTHER (at its own depth) one after the other ("apart") and both at once
("together"), in the order apart, together, together, apart; a run's
time is the wall time until both processes have exited.  The JSON then
gives ``apart_s``, ``together_s`` and the saving (the mean apart minus
the mean together).
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


def start(arch: str, seed: int, layers, workdir: str,
          root: Path = ROOT) -> subprocess.Popen:
    """One ``chip_smoke.py --path`` process of the tree at `root`,
    started."""
    cmd = [sys.executable, str(root / "chip_smoke.py"), "--seed",
           str(seed), "--path", arch, "--out",
           str(Path(workdir) / f"{arch.replace('/', '_')}.json")]
    if layers is not None:
        cmd += ["--layers", str(layers)]
    return subprocess.Popen(cmd)


def wait(proc: subprocess.Popen, arch: str, layers, root: Path = ROOT):
    try:
        rc = proc.wait(timeout=1200)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timed out"
    if rc:
        raise SystemExit(f"{arch} at {layers or 'its own'} layers failed "
                         f"(exit {rc}, {root})")


def run(arch: str, seed: int, layers, root: Path = ROOT) -> float:
    """Wall seconds of one ``chip_smoke.py --path`` process of the tree
    at `root`."""
    with tempfile.TemporaryDirectory(prefix="cut_ab_") as workdir:
        t0 = time.perf_counter()
        wait(start(arch, seed, layers, workdir, root), arch, layers, root)
        return time.perf_counter() - t0


def run_beside(paths: list, seed: int, together: bool) -> float:
    """Wall seconds of the (path, layers) pairs `paths`, one after the
    other or all at once."""
    with tempfile.TemporaryDirectory(prefix="cut_ab_") as workdir:
        t0 = time.perf_counter()
        if together:
            procs = [start(a, seed, n, workdir) for a, n in paths]
            for proc, (a, n) in zip(procs, paths):
                wait(proc, a, n)
        else:
            for a, n in paths:
                wait(start(a, seed, n, workdir), a, n)
        return time.perf_counter() - t0


def main() -> int:
    paths = [p[0] for p in chip_smoke.SERVE_PATHS + chip_smoke.ZOO_PATHS
             + chip_smoke.MM_PATHS] + [chip_smoke.ELASTIC_PATH,
                                       chip_smoke.ORCH_PATH,
                                       chip_smoke.REPL_PATH,
                                       chip_smoke.DIST_PATH,
                                       chip_smoke.TRAIN_PATH] + [
        chip_smoke.ZOO_TRAIN_PATH + p[0] for p in chip_smoke.ZOO_TRAIN]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", required=True, choices=paths)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--against", type=Path, help="time this tree against "
                    "the checkout at this directory, at one depth")
    ap.add_argument("--beside", choices=paths, help="time running the "
                    "path beside this one against running them in turn")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.layers is None and args.against is None and args.beside is None:
        ap.error("--layers, --against or --beside is required")
    import torch
    if not torch.cuda.is_available():
        print("cut_ab: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all()
    if args.beside is not None:
        pair = [(args.path, args.layers), (args.beside, None)]
        times = {"apart": [], "together": []}
        for together in (False, True, True, False):
            wall = run_beside(pair, args.seed, together)
            times["together" if together else "apart"].append(wall)
            print(f"[cut_ab] {args.path} at {args.layers or 'its own'} "
                  f"layers and {args.beside}, "
                  f"{'together' if together else 'apart'}: {wall:.1f} s",
                  flush=True)
        print(json.dumps(dict(path=args.path, layers=args.layers,
                              beside=args.beside, apart_s=times["apart"],
                              together_s=times["together"],
                              saving_s=(sum(times["apart"])
                                        - sum(times["together"])) / 2)))
        print(chip_smoke.card_line())
        return 0
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
