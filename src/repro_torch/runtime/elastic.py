"""Elastic restart: restore a training image onto a *different* mesh.

Port of the reference's ``runtime/elastic.py``.  The paper's CUDA path
requires identical GPU type, count and order on restore (§4.4); the AMD
path translates GPU ids onto a compatible subset (§3.1.2).  The
reference goes further, and so does the port: saved blocks are
reassembled and laid out for whatever mesh the replacement job brings up
(scale-down after losing slots, scale-up after repair), the engine's
"resharded" topology mode; onto the image's own mesh each block is
placed straight at its index ("identical").

On a mesh of slots on one device (:mod:`repro_torch.launch.mesh`) the
restored tensors are whole, and the target layout decides how they are
placed and how the next image of the state is cut.  On a process mesh
(any ``(data, model)`` shape over the ranks of a group) each rank reads
and places only its own block of the target layout, from the saved
blocks that overlap it: an image of ``(2, 2)`` ranks restores onto
``(4, 1)``, ``(2, 1)`` or one process, and back, bit-equal.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.sharding import state_shardings


def elastic_restore(run_dir: str, new_mesh, model, opt,
                    step: Optional[int] = None,
                    options: Optional[CheckpointOptions] = None,
                    policy=None) -> Dict[str, Any]:
    """Restore ``train_state`` from `run_dir` onto `new_mesh`.

    The target layout is `model`'s state laid over `new_mesh` by `policy`
    (default ``"baseline"``: the port's models carry no policy); shapes
    do not depend on the mesh, so any saved image can be laid out anew.
    Returns {"params", "opt", "step", "meta", "topology_mode"}: `meta`
    holds the trainer's host state and, under ``"cursor"``, the data
    pipeline's."""
    session = CheckpointSession(run_dir, options, mesh=new_mesh)
    meta: Dict[str, Any] = {}
    session.register_host_state("trainer", lambda: {},
                                lambda st: meta.update(st))
    session.register_host_state("data_cursor", lambda: {},
                                lambda st: meta.setdefault("cursor", st))
    params_t = model.init_abstract()
    opt_t = opt.init_abstract(params_t)
    restored = session.restore_into(
        {"params": params_t, "opt": opt_t}, state="train_state", step=step,
        mesh=new_mesh, shardings=state_shardings(model, new_mesh, policy))
    return {"params": restored["params"], "opt": restored["opt"],
            "step": meta.get("step"), "meta": meta,
            "topology_mode": session.last_stats.get("topology_mode")}
