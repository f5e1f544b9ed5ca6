"""Multi-pod dry run: trace every (arch x shape cell x mesh) cell on the
meta device and predict it for a mesh of H100 slots.

Port of the reference's ``launch/dryrun.py`` as a torch design.  The
reference lowers and compiles each cell onto a TPU mesh and reads XLA's
artifacts; torch has no HLO and no SPMD partitioner, so here the FULL
published config's step runs eagerly on the ``meta`` device (shapes and
dtypes, no allocation: the counterpart of ``ShapeDtypeStruct``s) under
an aten op trace (:mod:`repro_torch.launch.hlo_analysis`), with the
arguments laid over a production mesh of slots
(``make_production_mesh(device="meta")``) by the fitted shardings of a
policy (:func:`repro_torch.sharding.state_shardings`).  Each cell
records:

  * the memory record: ``argument_size_in_bytes``, one slot's bytes of
    params, optimizer state, batch and cache (exact: the shard
    arithmetic of the fitted ``NamedSharding``s, as the reference's
    compile lays them out); ``temp_size_in_bytes``, the trace's peak of
    live intermediate bytes per slot (modelled: eager torch frees what
    XLA's scheduler would, but fuses nothing); ``fits``, their sum
    against the H100's 80 GB;
  * the op analysis: per-slot FLOPs (matmul and convolution FLOPs are
    those of the reference's trip-count-aware analysis at the same
    configs), unfused bytes, attention-score bytes and a collective
    census modelled from the policy's roles (no partitioner runs);
  * a three-term roofline on H100 SXM5 constants.

These are predictions FOR a mesh of H100 slots: nothing runs on a card.
Models are built with ``use_kernels=False``, as the reference's
``build_model`` defaults: no kernel runs on a meta tensor
(``kernels/ops.py`` raises).

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k \\
      --mesh pod|multipod|both [--policy baseline] [--variant base] \\
      [--out artifacts/dryrun_torch] [--no-remat]
  python -m repro_torch.launch.dryrun --cell qwen1.5-0.5b/train_4k/pod \\
      --cell whisper-tiny/decode_32k/multipod      # cells, one process
  python -m repro_torch.launch.dryrun --all [--mesh both]  # one process
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.hlo_analysis import (OpTrace, analyze_trace,
                                             role_census, top_buffers)
from repro_torch.sharding.policy import map_tree

# H100 SXM5, from NVIDIA's H100 Tensor Core GPU datasheet: dense bf16
# tensor-core rate, HBM3 bandwidth, NVLink 4 (900 GB/s total = 450 GB/s
# per direction) inside a node of 8, and one 400 Gb/s NDR InfiniBand
# port per card across nodes; 80 GB of HBM3.
PEAK_FLOPS = 989.4e12        # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card per direction, in a node
NET_BW = 50e9                # bytes/s per card across nodes
NODE_SLOTS = 8               # slots per node, taken in row-major order
HBM_BYTES = 80e9             # bytes per card

DEFAULT_OUT = os.path.join("artifacts", "dryrun_torch")


# ----------------------------------------------------------------------
VARIANTS = ("base", "bf16score", "xentchunk", "noremat", "gqaexpand",
            "bf16cast", "gradbf16", "gqaexpand_bf16cast",
            "gqaexpand_bf16cast_gradbf16", "opt")

_KNOBS = {"base", "bf16score", "xentchunk", "noremat", "gqaexpand",
          "bf16cast", "gradbf16"}


def variant_parts(variant: str) -> set:
    if variant == "opt":        # every knob the reference's hillclimb kept
        return {"gqaexpand", "bf16cast", "gradbf16", "xentchunk"}
    parts = set(variant.split("_"))
    unknown = parts - _KNOBS
    if unknown:
        raise ValueError(f"unknown variant knob(s) {sorted(unknown)}; "
                         f"known: {sorted(_KNOBS)}")
    return parts


def apply_variant(variant: str) -> bool:
    """Set the port's knobs (``models/layers.py``) for `variant` (knobs
    compose with '_'; 'opt' is every kept knob).  Returns the remat
    setting the variant implies."""
    from repro_torch.models import layers as L
    parts = variant_parts(variant)
    L.SCORE_DTYPE = torch.bfloat16 if "bf16score" in parts else torch.float32
    L.XENT_SEQ_CHUNK = 512 if "xentchunk" in parts else 0
    L.GQA_EXPAND = "gqaexpand" in parts
    L.CAST_PARAMS_ONCE = "bf16cast" in parts
    return "noremat" not in parts


# ---------------------------------------------------------------- layout
def _dp_size(policy, mesh) -> int:
    dp = tuple(a for a in policy.dp if a in mesh.axis_names)
    return int(np.prod([mesh.shape[a] for a in dp])) if dp else 1


def _cfg_cell(arch, shape):
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES
    cfg = get_config(arch) if isinstance(arch, str) else arch
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    return cfg, cell


def arguments(model, cfg, cell, mesh, policy) -> Dict[str, Tuple[Any, Any]]:
    """The step's arguments on the meta device beside their fitted
    shardings, by part: ``params``, ``opt`` (train), ``batch`` (train,
    prefill), ``cache`` and ``tokens`` (decode; the port's decode position
    is a host int, so it takes no device bytes)."""
    from repro_torch.launch.shapes import batch_shardings, batch_specs
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.sharding import NamedSharding, PartitionSpec, get_policy
    from repro_torch.sharding.policy import (fit_shardings_tree,
                                             state_shardings)
    pol = get_policy(policy).for_mesh(mesh)
    B, S = cell.global_batch, cell.seq_len
    decode = cell.kind == "decode"
    sh = state_shardings(model, mesh, pol, batch=B if decode else None,
                         max_seq=S if decode else None)
    params = model.init_abstract()
    out = {"params": (params, sh["params"])}
    if cell.kind == "train":
        opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100000))
        out["opt"] = (opt.init_abstract(params), sh["opt"])
    if decode:
        dp = _dp_size(pol, mesh)
        tok_sh = (pol.sharding(mesh, "batch") if B % dp == 0 and dp > 1
                  else NamedSharding(mesh, PartitionSpec()))
        out["cache"] = (model.cache_abstract(B, S), sh["cache"])
        out["tokens"] = (torch.empty((B,), dtype=torch.int32,
                                     device="meta"), tok_sh)
    else:
        batch = batch_specs(cfg, B, S)
        out["batch"] = (batch, fit_shardings_tree(
            batch_shardings(cfg, pol, mesh), batch, mesh))
    return out


def slot_bytes(tree, shardings) -> int:
    """One slot's bytes of `tree` laid out by `shardings` (a tree of the
    same structure, or one sharding for a single tensor)."""
    from repro_torch.core.device_plugin import flatten_with_paths
    if isinstance(tree, torch.Tensor):
        tree, shardings = {"x": tree}, {"x": shardings}
    sh = flatten_with_paths(shardings)
    return sum(math.prod(sh[k].shard_shape(tuple(t.shape)))
               * t.element_size()
               for k, t in flatten_with_paths(tree).items())


def argument_bytes(args: Dict[str, Tuple[Any, Any]]) -> Dict[str, int]:
    """Per-slot bytes by part (the optimizer state as ``opt/step``,
    ``opt/m``, ``opt/v``)."""
    out = {}
    for part, (tree, sh) in args.items():
        if part == "opt":
            for f in ("step", "m", "v"):
                out[f"opt/{f}"] = slot_bytes(getattr(tree, f),
                                             getattr(sh, f))
        else:
            out[part] = slot_bytes(tree, sh)
    return out


def _batch_axes(args) -> Tuple[str, ...]:
    """The mesh axes the batch dim is sharded over, as fitted."""
    s = args["tokens"][1] if "tokens" in args else args["batch"][1]["tokens"]
    e = tuple(s.spec)[0] if len(s.spec) else None
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


# ----------------------------------------------------------------- trace
@dataclasses.dataclass
class Traced:
    """One traced cell: the op trace and what ``analyse`` reads."""
    trace: OpTrace
    cfg: Any
    cell: Any
    mesh: Any
    argument_bytes: Dict[str, int]
    output_bytes: float
    alias_bytes: float
    trace_s: float


def train_step(model, opt, params, opt_state, batch, on_grad=None,
               grad_bf16: bool = False):
    """The trainer's step (``runtime.trainer.loss_and_grads``, then
    ``AdamW.update`` in place); `on_grad` as ``loss_and_grads`` takes it.
    Returns the metrics."""
    from repro_torch.runtime.trainer import loss_and_grads
    metrics, grads = loss_and_grads(model, params, batch, on_grad=on_grad)
    if grad_bf16:
        # gradient compression: the reduction moves bf16, the optimizer
        # upcasts again
        grads = map_tree(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)
    opt.update(grads, opt_state, params)
    return metrics


def build_traced(arch, shape, mesh, policy="baseline", remat: bool = True,
                 variant: str = "base") -> Traced:
    """Build the FULL config of `arch` (a name or a ``ModelConfig``) with
    ``use_kernels=False``, lay its arguments for `shape` (a cell name or a
    ``ShapeCell``) over `mesh`'s slots by `policy`, and trace its step
    on the meta device: the train step (loss, backward, AdamW update),
    the prefill, or one decode step."""
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.models import layers as L
    from repro_torch.models.encdec import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.sharding import get_policy

    if variant != "base":
        remat = apply_variant(variant) and remat
    cfg, cell = _cfg_cell(arch, shape)
    pol = get_policy(policy).for_mesh(mesh)
    t0 = time.perf_counter()
    model = build_model(cfg, compute_dtype=torch.bfloat16, remat=remat,
                        use_kernels=False, device="meta")
    args = arguments(model, cfg, cell, mesh, pol)
    batch_axes = _batch_axes(args)
    fsdp = pol.fsdp if pol.zero_stage >= 3 else ()
    trace = OpTrace(mesh, tp=pol.tp, ep=pol.ep, sp=pol.sp,
                    batch_axes=batch_axes)
    params, psh = args["params"]
    trace.tag_tree(params, psh, drop=fsdp)          # gathered for compute
    for part, (tree, sh) in args.items():
        if part != "params":
            trace.tag_tree(tree, sh)
    grad_bf16 = "gradbf16" in variant_parts(variant)
    psh_flat = flatten_with_paths(psh)
    with trace:
        if cell.kind == "train":
            opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100000))
            loss = train_step(
                model, opt, params, args["opt"][0], args["batch"][0],
                on_grad=lambda k, g: trace.retag(g, psh_flat[k]),
                grad_bf16=grad_bf16)["loss"]
            trace.tag_tree(params, psh)      # the update runs on shards
            outputs, alias = [loss], [args["params"], args["opt"]]
        elif cell.kind == "prefill":
            outputs, alias = list(model.prefill(params, args["batch"][0])), []
        else:
            logits, _ = model.decode_step(params, args["cache"][0],
                                          args["tokens"][0],
                                          cell.seq_len - 1)
            outputs, alias = [logits], [args["cache"]]
    trace.collectives += role_census(
        model.param_axes(), params, psh, fsdp=fsdp, batch_axes=batch_axes,
        sizes=trace.sizes, train=cell.kind == "train", remat=remat,
        gather_dtype=torch.bfloat16 if L.CAST_PARAMS_ONCE else None,
        grad_dtype=torch.bfloat16 if grad_bf16 else None)
    out_bytes = sum(t.numel() * t.element_size() / trace.split(t)
                    for t in flatten_with_paths(outputs).values())
    alias_bytes = sum(slot_bytes(tree, sh) for tree, sh in alias)
    return Traced(trace, cfg, cell, mesh, argument_bytes(args),
                  out_bytes + alias_bytes, alias_bytes,
                  time.perf_counter() - t0)


# -------------------------------------------------------------- analysis
def _in_node(mesh, axes) -> bool:
    """Whether every group of slots over `axes` lies in one node (slots
    taken NODE_SLOTS to a node in row-major order)."""
    names = list(mesh.axis_names)
    idx = np.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    keep = [names.index(a) for a in axes]
    rest = [d for d in range(idx.ndim) if d not in keep]
    groups = idx.transpose(rest + keep).reshape(-1, math.prod(
        idx.shape[d] for d in keep)) // NODE_SLOTS
    return bool((groups.min(axis=1) == groups.max(axis=1)).all())


def link_bw(mesh, axes) -> float:
    return NVLINK_BW if _in_node(mesh, axes) else NET_BW


def analyse(traced: Traced, n_devices: int) -> Dict[str, Any]:
    """Three-term roofline from the trace, per slot, on H100 SXM5
    constants; the reference's record keys (``xla_cost_*`` are None: no
    XLA cost analysis exists here), plus ``fits`` and the link each
    collective's group takes."""
    cfg, cell, trace = traced.cfg, traced.cell, traced.trace
    rec = analyze_trace(trace, n_devices,
                        seq_len=cell.seq_len
                        if cell.kind in ("train", "prefill") else None)
    flops_dev, bytes_dev = rec["flops"], rec["bytes"]
    score_bytes = rec["score_bytes"]
    coll = dict(rec["collectives"])
    coll["total_wire_bytes"] = rec["collective_wire_bytes"]
    coll["total_count"] = rec["collective_count"]
    bw = {}
    t_coll = 0.0
    for c in trace.collectives:
        if c.axes not in bw:
            bw[c.axes] = link_bw(traced.mesh, c.axes)
        t_coll += c.wire_bytes / bw[c.axes]

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    # a flash-attention kernel keeps the score/prob blocks on chip: the
    # memory term without them (modelled, beside the traced one)
    t_memory_flash = max(bytes_dev - score_bytes, 0.0) / HBM_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]

    tokens = (cell.global_batch * cell.seq_len
              if cell.kind in ("train", "prefill") else cell.global_batch)
    n_active = cfg.param_count(active_only=True)
    mf = (6.0 if cell.kind == "train" else 2.0) * n_active * tokens
    global_flops = sum(r.flops for r in trace.records)
    ideal_s = mf / n_devices / PEAK_FLOPS
    bound = max(t_compute, t_memory, t_coll)
    bound_flash = max(t_compute, t_memory_flash, t_coll)
    args = float(sum(traced.argument_bytes.values()))
    temp = float(trace.peak_temp_bytes)
    mem = {"argument_size_in_bytes": args,
           "output_size_in_bytes": float(traced.output_bytes),
           "temp_size_in_bytes": temp,
           "alias_size_in_bytes": float(traced.alias_bytes),
           "generated_code_size_in_bytes": 0.0}
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "score_bytes_per_device": score_bytes,
        "flops_by_kind": rec["flops_by_kind"],
        "bytes_by_kind": rec["bytes_by_kind"],
        "top_traffic": rec["top_traffic"],
        "top_collectives": rec["top_collectives"],
        "xla_cost_flops": None,
        "xla_cost_bytes": None,
        "collectives": coll,
        "collective_links": {"x".join(a) or "-": ("nvlink" if b == NVLINK_BW
                                                  else "network")
                             for a, b in bw.items()},
        "memory": mem,
        "argument_bytes_by_part": traced.argument_bytes,
        "temp_modelled": True,
        "fits": args + temp <= HBM_BYTES,
        "top_buffers": top_buffers(trace, 8),
        "n_ops": rec["n_ops"],
        "unmodelled_ops": rec["unmodelled_ops"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_flash_s": t_memory_flash,     # modelled (flash kernel)
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": global_flops,
        "useful_flops_ratio": mf / global_flops if global_flops else 0.0,
        "roofline_bound_s": bound,
        "roofline_fraction": ideal_s / bound if bound else 0.0,
        "roofline_fraction_flash": ideal_s / bound_flash if bound_flash
        else 0.0,
        "hardware": "H100 SXM5 (datasheet): 989.4 TFLOP/s bf16, 3.35 TB/s "
                    "HBM3, NVLink 450 GB/s per direction in a node of 8, "
                    "50 GB/s per card across nodes, 80 GB",
    }


def run_cell(arch: str, shape: str, mesh_kind: str, policy: str,
             out_dir: str, remat: bool = True,
             variant: str = "base") -> Dict[str, Any]:
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                device="meta")
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "policy": policy, "variant": variant,
                           "n_devices": mesh.size,
                           "prediction_for": "a mesh of H100 slots"}
    try:
        traced = build_traced(arch, shape, mesh, policy, remat=remat,
                              variant=variant)
        rec["trace_s"] = traced.trace_s
        t1 = time.perf_counter()
        rec.update(analyse(traced, mesh.size))
        rec["analyse_s"] = time.perf_counter() - t1
    finally:
        apply_variant("base")
    rec["ok"] = True
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if variant == "base" else f"__{variant}"
    name = f"{arch}__{shape}__{mesh_kind}__{policy}{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary(rec: Dict[str, Any]) -> str:
    """The reference's two summary lines for one cell."""
    keys = ("arch", "shape", "mesh", "variant", "trace_s", "t_compute_s",
            "t_memory_s", "t_memory_flash_s", "t_collective_s", "dominant",
            "useful_flops_ratio", "roofline_fraction", "fits")
    mem = rec.get("memory", {})
    return (json.dumps({k: rec[k] for k in keys}, indent=1)
            + "\nmemory_analysis: " + str({k: f"{v / 2**30:.2f}GiB"
                                           for k, v in mem.items()
                                           if isinstance(v, float)}))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--policy", default="baseline")
    ap.add_argument("--variant", default="base",
                    help="'_'-composed knobs from: base bf16score xentchunk "
                         "noremat gqaexpand bf16cast gradbf16 | opt")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", action="append", default=[],
                    help="ARCH/SHAPE/MESH (repeatable): these cells, in "
                         "this process")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.shapes import cells_for, skipped_cells_for

    if args.list:
        for a in ARCH_IDS:
            cfg = get_config(a)
            print(a, cells_for(cfg),
                  [f"SKIP:{c} ({why[:40]}…)" for c, why in
                   skipped_cells_for(cfg)])
        return 0

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        t0 = time.perf_counter()
        failures = []
        for a in ARCH_IDS:
            for c in cells_for(get_config(a)):
                for mk in meshes:
                    out = os.path.join(
                        args.out, f"{a}__{c}__{mk}__{args.policy}.json")
                    if os.path.exists(out):
                        print(f"[skip cached] {a} {c} {mk}")
                        continue
                    print(f"[dryrun] {a} {c} {mk} ...", flush=True)
                    try:
                        run_cell(a, c, mk, args.policy, args.out)
                    except Exception as e:     # one cell's failure
                        print(f"[dryrun] {a} {c} {mk} FAILED: {e!r}",
                              flush=True)
                        failures.append((a, c, mk))
        if failures:
            print("FAILURES:", failures)
            return 1
        print(f"all cells OK ({time.perf_counter() - t0:.1f} s)")
        return 0

    cells = [tuple(c.split("/")) for c in args.cell]
    if not cells:
        assert args.arch and args.shape, \
            "--arch/--shape, --cell or --all required"
        cells = [(args.arch, args.shape, mk) for mk in meshes]
    for arch, shape, mk in cells:
        rec = run_cell(arch, shape, mk, args.policy, args.out,
                       remat=not args.no_remat, variant=args.variant)
        print(summary(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
