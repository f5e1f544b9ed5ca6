"""Serving-state snapshot demo on PyTorch: checkpoint a half-finished
batched generation (params + KV cache + decode cursor) and resume it
token-exact in a fresh server, the sub-second-cold-start story from the
paper's production deployments (Modal memory snapshots, §6).

    PYTHONPATH=src python examples/torch/serve_with_snapshots.py [RUN_DIR]
    PYTHONPATH=src python examples/torch/serve_with_snapshots.py --device cpu

The counterpart of ``examples/serve_with_snapshots.py`` on
``repro_torch``.  ``--device`` defaults to ``cuda`` and raises without a
card.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np
import torch

from repro_torch.api import CheckpointOptions
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.devices import resolve_device, set_deterministic
from repro_torch.models.encdec import build_model
from repro_torch.runtime.server import DecodeServer


def main(device="cuda", run_dir=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        set_deterministic()                       # token-exact on the card
    cfg = get_smoke_config("qwen1.5-0.5b")
    run_dir = run_dir or tempfile.mkdtemp(prefix="serve_")

    srv = DecodeServer(cfg, run_dir, max_seq=64, device=device,
                       options=CheckpointOptions())
    model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                        device=device)
    srv.load(model.init(0))

    batch = TokenPipeline(cfg, 4, 12, seed=7).next()
    srv.start(batch)
    print("prefilled batch of 4 prompts (12 tokens each)")

    srv.decode(5)
    print(f"decoded 5 tokens; pos={srv.pos}")
    srv.checkpoint(0)
    print("serving snapshot taken mid-generation")
    snap_pos = srv.pos
    expected = srv.decode(6).copy()
    print(f"uninterrupted continuation: {expected[0, -6:].tolist()}")

    print("=== fresh server: restore + continue ===")
    srv2 = DecodeServer(cfg, run_dir, max_seq=64, device=device)
    srv2.load(srv.params)
    srv2.start(batch)          # build structures, then roll back
    pos = srv2.restore()
    print(f"restored at pos {pos}")
    got = srv2.decode(6)
    print(f"restored continuation:      {got[0, -6:].tolist()}")
    np.testing.assert_array_equal(expected, got)
    print("token-exact resume: OK")
    return {"snapshot_pos": snap_pos, "restored_pos": pos,
            "tokens": got.tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir", nargs="?")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    main(args.device, args.run_dir)
