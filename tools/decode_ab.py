#!/usr/bin/env python3
"""Decode speed of two source trees of the port, in turns, on one card.

    python3 tools/decode_ab.py --trees OLD NEW     # needs one NVIDIA GPU

Each tree is a directory that holds ``src/repro_torch`` (the repo root, or
a ``git archive`` of another commit unpacked into a git-ignored directory).
The trees run in the order OLD, NEW, NEW, OLD, each in a process of its
own, and each process serves ``LM.decode_step`` at full width for every
``--archs`` the way ``chip_smoke.py`` phase 2 does: bf16 compute through
the kernels, f32 masters made from ``--seed``, B = 4, a cache of
``max_seq`` 1024 (zeroed: the step's work does not depend on its values)
written from position 512 on, each step's argmax read back on the host.
After ``--warmup`` steps it times ``--tokens`` steps on the host clock
around a synchronize, and prints one JSON line per process and a summary
with the card's name and power limit.  About 20 s per process.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

B, MAX_SEQ, POS = 4, 1024, 512


def child(tree: Path, archs, seed: int, warmup: int, tokens: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    src = Path(repro_torch.__file__).resolve()
    if src.parent.parent.parent != tree.resolve():
        raise SystemExit(f"imported {src}, not the tree {tree}")
    dev = torch.device("cuda")
    out = {"tree": str(tree), "ms_per_token": {}}
    for arch in archs:
        cfg = get_config(arch)
        model = LM(cfg, compute_dtype=torch.bfloat16, use_kernels=True,
                   device=dev)
        params = model.init(seed)
        cache = model.init_cache(B, MAX_SEQ)
        gen = torch.Generator().manual_seed(seed)
        last = torch.randint(0, cfg.vocab_size, (B,), generator=gen).to(dev)
        pos = POS

        def step():
            nonlocal cache, last, pos
            logits, cache = model.decode_step(params, cache, last, pos)
            nxt = torch.argmax(logits, dim=-1).cpu()
            last = nxt.to(dev)
            pos += 1

        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(tokens):
            step()
        torch.cuda.synchronize()
        out["ms_per_token"][arch] = (time.perf_counter() - t0) * 1e3 / tokens
        del model, params, cache
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--archs", nargs="+",
                    default=["qwen1.5-0.5b", "mamba2-2.7b"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(Path(a.child), a.archs, a.seed, a.warmup,
                               a.tokens)), flush=True)
        return 0
    old, new = a.trees
    runs = []
    for tree in (old, new, new, old):
        p = subprocess.run(
            [sys.executable, __file__, "--child", tree, "--archs", *a.archs,
             "--seed", str(a.seed), "--warmup", str(a.warmup),
             "--tokens", str(a.tokens)],
            capture_output=True, text=True, timeout=600)
        if p.returncode:
            sys.stderr.write(p.stderr)
            raise SystemExit(f"{tree}: exit {p.returncode}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(json.dumps({
        "card": card.stdout.strip().splitlines()[0],
        "order": [old, new, new, old],
        "ms_per_token": {arch: [r["ms_per_token"][arch] for r in runs]
                         for arch in a.archs}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
