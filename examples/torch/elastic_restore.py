"""Elastic restore demo on PyTorch: a unified snapshot taken on a (4, 2)
mesh restored onto a (2, 2) mesh, the scale-down-after-node-loss path
that GPU-side CRIUgpu cannot do (the paper requires identical GPU count
and order; §4.4).

    PYTHONPATH=src python examples/torch/elastic_restore.py [RUN_DIR]
    PYTHONPATH=src python examples/torch/elastic_restore.py --device cpu

The counterpart of ``examples/elastic_restore.py`` on ``repro_torch``,
whose meshes are grids of slots on one device
(``repro_torch.launch.mesh``): the image holds one block per distinct
shard of the (4, 2) layout, and the restore reassembles the blocks and
lays them out for (2, 2).  ``--device`` defaults to ``cuda`` and raises
without a card.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import torch

from repro_torch.api import CheckpointSession
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.data import TokenPipeline
from repro_torch.devices import resolve_device, set_deterministic
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.encdec import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.runtime.elastic import elastic_restore
from repro_torch.sharding import state_shardings


def main(device="cuda", run_dir=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        set_deterministic()
    cfg = get_smoke_config("qwen1.5-0.5b", d_model=64, num_heads=4,
                           num_kv_heads=4, head_dim=16)
    opt = AdamW(lr=constant(1e-3))
    run_dir = run_dir or tempfile.mkdtemp(prefix="elastic_")

    def mesh_of(shape):
        return make_mesh(shape, ("data", "model"), devices=device)

    mesh_a = mesh_of((4, 2))
    print(f"slots: {mesh_a.size} on {device}")
    model = build_model(cfg, compute_dtype=torch.float32, remat=False,
                        device=device)
    params = model.init(0)
    opt_state = opt.init(params)

    session = CheckpointSession(run_dir, device=device, mesh=mesh_a)
    session.attach(lambda: {"train_state": {"params": params,
                                            "opt": opt_state}},
                   {"train_state": state_shardings(model, mesh_a)})
    session.register_host_state("trainer", lambda: {"step": 100},
                                lambda st: None)
    session.register_host_state("data_cursor", lambda: {"step": 100},
                                lambda st: None)
    session.checkpoint(100)
    print("snapshot taken on mesh (4,2): 8 slots")

    print("=== node loss: restore onto mesh (2,2): 4 slots ===")
    mesh_b = mesh_of((2, 2))
    out = elastic_restore(run_dir, mesh_b, model, opt)
    print(f"topology mode: {out['topology_mode']}   step: {out['step']}")

    saved, got = (flatten_with_paths({"params": p, "opt": o}) for p, o in (
        (params, opt_state), (out["params"], out["opt"])))
    assert saved.keys() == got.keys()
    for k, v in saved.items():
        assert torch.equal(v, got[k]), k
    print(f"restored values bitwise identical; now laid out over "
          f"{mesh_b.size} slots")

    # the restored state trains on the new mesh
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in TokenPipeline(cfg, 4, 16).next().items()}
    batch["tokens"] = batch["tokens"].long()
    with torch.no_grad():
        loss = float(model.loss(out["params"], batch)[0])
    print(f"first loss on the replacement mesh: {loss:.4f}")
    print("OK")
    return {"topology_mode": out["topology_mode"], "step": out["step"],
            "slots": mesh_b.size, "loss": loss}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir", nargs="?")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    main(args.device, args.run_dir)
