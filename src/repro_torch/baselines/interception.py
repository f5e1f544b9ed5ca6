"""Cricket-style API-interception checkpointing baseline (paper §2).

State-of-the-art *semi-transparent* GPU checkpointing interposes a device
proxy between the application and the device API (LD_PRELOAD), then

  intercept → log → (at restore) replay

every device call.  The port keeps the JAX package's interposition point:
the boundary of the step callable (every device-touching computation of a
step passes through it, as every CUDA call passes through Cricket's
proxy).  Under eager PyTorch that is ONE intercepted call per step, where
a CUDA proxy would see every kernel launch and copy: 7329 launches per
qwen1.5-0.5b training step at full width (``ROADMAP.md`` A.15).  So the
per-call cost measured here is a lower bound of a proxy's, while the
replay-based restore is the same in kind.  Per intercepted call this
layer does what the proxy does:

  * flatten the arguments (dicts, lists, tuples, dataclasses) and record
    their structure (the proxy records argument values/handles for
    replay);
  * copy host-resident inputs (numpy arrays: the proxy's cudaMemcpy
    forwarding, a synchronous copy of the H2D payload);
  * tag device-resident arguments (torch tensors) by object identity
    (GPU pointers in the proxy's handle table);
  * append the record to the replay log.

Unlike JAX arrays, torch tensors are mutable, so three things differ from
the JAX package:

  * :meth:`register_initial_state` copies the state to the host when it
    is registered (a later in-place step must not change the snapshot
    replay starts from);
  * a step that updates its inputs in place (the port's AdamW) returns
    the same tensor objects: they keep their handles, and replay mutates
    the restored tensors in the same order, so the table holds one copy
    of the state however long the run;
  * the handle table holds every tensor it tags (an ``id()`` is reused
    once torch frees a tensor, so the table must keep alive what it
    keys).  A *functional* step therefore keeps every call's outputs
    alive: at full width one copy of the training state (~5.6 GB) per
    call.  Such runs must be short; the in-place step has no such bound.

The costs reproduce the paper's findings: per-call work on the critical
path, a replay log whose length is proportional to run time, and restore
= re-execution of the whole log from the initial snapshot.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device

PyTree = Any


# ------------------------------------------------------------- pytrees
def _flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """Leaves in a fixed order and a picklable structure spec (dict keys
    in insertion order; dataclasses by field; lists and tuples)."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = tuple(node)
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            names = tuple(f.name for f in dataclasses.fields(node))
            return ("dataclass", type(node), names,
                    tuple(walk(getattr(node, n)) for n in names))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(v) for v in node))
        leaves.append(node)
        return None
    return leaves, walk(tree)


def _unflatten(spec: Any, leaves: List[Any]) -> PyTree:
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        if sp[0] == "dict":
            return {k: build(c) for k, c in zip(sp[1], sp[2])}
        if sp[0] == "dataclass":
            return sp[1](**{n: build(c) for n, c in zip(sp[2], sp[3])})
        seq = [build(c) for c in sp[1]]
        return tuple(seq) if sp[0] == "tuple" else seq
    return build(spec)


def _tensors(tree: PyTree) -> List[torch.Tensor]:
    return [l for l in _flatten(tree)[0] if isinstance(l, torch.Tensor)]


def _sync(tensors) -> None:
    devices = {t.device for t in tensors if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class InterceptionCheckpointer:
    def __init__(self, run_dir: Optional[str] = None):
        self.run_dir = run_dir
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
        self.log: List[Dict[str, Any]] = []
        self._fns: Dict[str, Callable] = {}
        self._handles: Dict[int, str] = {}       # id(device arg) -> handle
        self._next_handle = 0
        self._results: Dict[str, Any] = {}       # handle -> live object
        self.initial_state: Optional[Dict[str, Any]] = None   # host copies
        self._initial_handles: Dict[str, List[str]] = {}
        self.stats = {"intercepted_calls": 0, "logged_bytes": 0,
                      "intercept_s": 0.0}

    # ------------------------------------------------------------ wiring
    def _handle_for(self, obj) -> str:
        key = id(obj)
        if key not in self._handles:
            h = f"h{self._next_handle}"
            self._next_handle += 1
            self._handles[key] = h
            self._results[h] = obj           # held: the id stays unique
        return self._handles[key]

    def register_initial_state(self, name: str, tree: PyTree) -> None:
        """The proxy snapshots device memory once; replay starts from it.
        The snapshot is a host copy taken now: later in-place steps
        change the live tensors, not the snapshot."""
        if self.initial_state is None:
            self.initial_state = {}
        leaves, spec = _flatten(tree)
        handles, copies = [], []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                handles.append(self._handle_for(leaf))
                copies.append(leaf.detach().to("cpu", copy=True))
            else:
                copies.append(leaf)
        self.initial_state[name] = _unflatten(spec, copies)
        self._initial_handles[name] = handles

    def wrap(self, fn: Callable, name: str) -> Callable:
        """Interpose on a device-touching callable."""
        self._fns[name] = fn

        def intercepted(*args, **kwargs):
            t0 = time.perf_counter()
            flat, spec = _flatten((args, kwargs))
            rec_args = []
            logged = 0
            for leaf in flat:
                if isinstance(leaf, torch.Tensor):
                    rec_args.append(("dev", self._handle_for(leaf)))
                elif isinstance(leaf, np.ndarray):
                    # H2D transfer: the proxy logs the payload synchronously
                    buf = leaf.copy()
                    rec_args.append(("host", buf))
                    logged += buf.nbytes
                else:
                    rec_args.append(("py", leaf))
            rec = {"fn": name, "treedef": spec, "args": rec_args}
            self.stats["intercept_s"] += time.perf_counter() - t0

            out = fn(*args, **kwargs)

            t1 = time.perf_counter()
            rec["out_handles"] = [self._handle_for(l) for l in _tensors(out)]
            self.log.append(rec)
            self.stats["intercepted_calls"] += 1
            self.stats["logged_bytes"] += logged
            self.stats["intercept_s"] += time.perf_counter() - t1
            return out

        return intercepted

    # ------------------------------------------------------------ ckpt
    def checkpoint(self, step: int) -> str:
        """Persist the initial state + the replay log (the proxy's
        image)."""
        assert self.run_dir, "run_dir required for checkpoint()"
        t0 = time.perf_counter()
        path = os.path.join(self.run_dir, f"intercept_{step:08d}.pkl")
        payload = {
            "initial_state": self.initial_state,
            "initial_handles": self._initial_handles,
            "log": [self._strip(rec) for rec in self.log],
            "step": step,
        }
        torch.save(payload, path + ".tmp")
        os.rename(path + ".tmp", path)
        self.stats["checkpoint_s"] = time.perf_counter() - t0
        return path

    @staticmethod
    def _strip(rec):
        return {"fn": rec["fn"], "treedef": rec["treedef"],
                "args": rec["args"], "out_handles": rec["out_handles"]}

    # ------------------------------------------------------------ restore
    def restore(self, path: str, fns: Dict[str, Callable],
                device: DeviceLike = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Replay the log from the initial snapshot on `device` (``cuda``
        unless the caller passes ``"cpu"``): the slow path the paper
        measures.  Returns (final handle table, stats); ``restore_s`` is
        the whole restore, ``load_s`` its read and placement of the
        initial state, ``replay_s`` the re-execution."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        payload = torch.load(path, map_location="cpu", weights_only=False)
        # rebuild the handle table exactly as register+wrap built it
        results: Dict[str, Any] = {}
        self._restored = {}
        for name, tree in payload["initial_state"].items():
            leaves, spec = _flatten(tree)
            self._restored[name] = (spec, leaves,
                                    payload["initial_handles"][name])
            tensors = [t.to(dev) for t in leaves
                       if isinstance(t, torch.Tensor)]
            for h, t in zip(payload["initial_handles"][name], tensors):
                results[h] = t
        _sync(results.values())
        t_loaded = time.perf_counter()

        replayed = 0
        for rec in payload["log"]:
            flat = [results[val] if kind == "dev" else val
                    for kind, val in rec["args"]]
            args, kwargs = _unflatten(rec["treedef"], flat)
            out = fns[rec["fn"]](*args, **kwargs)
            for h, leaf in zip(rec["out_handles"], _tensors(out)):
                results[h] = leaf
            replayed += 1
        _sync([v for v in results.values() if isinstance(v, torch.Tensor)])
        t1 = time.perf_counter()
        stats = {"replayed_calls": replayed,
                 "restore_s": t1 - t0,
                 "load_s": t_loaded - t0,
                 "replay_s": t1 - t_loaded,
                 "log_entries": len(payload["log"])}
        return results, stats

    def replayed_tree(self, results: Dict[str, Any], name: str) -> PyTree:
        """Registered state `name` rebuilt from the handle table of the
        last :meth:`restore`: after an in-place step's replay, the state
        at the checkpoint (a functional step's newest state is its last
        logged call's outputs instead)."""
        spec, leaves, handles = self._restored[name]
        it = iter(handles)
        return _unflatten(spec, [results[next(it)]
                                 if isinstance(l, torch.Tensor) else l
                                 for l in leaves])
