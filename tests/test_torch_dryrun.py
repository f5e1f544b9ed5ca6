"""The port's dry run (``repro_torch.launch.dryrun``) held against the
reference's on the CPU.

* ``make_production_mesh``: the reference's shapes and axes, on the meta
  device.
* Per-slot argument bytes (params, AdamW's step, m and v, the batch, and
  the decode cache and tokens) equal the reference's shard arithmetic,
  ``NamedSharding(AbstractMesh(...), spec).shard_shape`` over the
  reference's fitted shardings, for every arch, each of its cells, both
  production meshes and two policies: pure arithmetic, no compile.
* Matmul (``dot``) and convolution FLOPs of the train step (remat on and
  off), the prefill and one decode step equal the reference's
  ``analyze_hlo`` on a 1-device compile of the smoke configs, exactly but
  for mamba2 and jamba (within 1%, see ``NEAR``).
* ``--list`` prints what the reference's prints; a reduced-mesh run of
  ``build_traced`` + ``analyse`` on (4, 2) and (2, 2, 2) meta meshes gives
  the reference's record keys (tests/test_dryrun_machinery.py:60-103);
  the CLI writes its cells under ``--out`` only; the kernel ops refuse
  meta tensors.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeCell, cells_for
from repro_torch.models.encdec import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small traces run fastest on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _base_knobs():
    yield
    dr.apply_variant("base")


# ------------------------------------------------------------------ meshes
def test_production_mesh_shapes_and_axes():
    pod = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert pod.device == torch.device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()


def test_kernel_ops_refuse_meta_tensors():
    from repro_torch.kernels import ops
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.attention(q, q, q)
    with pytest.raises(ValueError, match="use_kernels=False"):
        ops.rmsnorm(torch.empty(4, 8, device="meta"),
                    torch.empty(8, device="meta"))


# --------------------------------------------------------- argument bytes
def _ref_argument_bytes(arch, shape, multi_pod, policy):
    """The reference's per-slot bytes by part: its fitted shardings over an
    AbstractMesh of the production shape (no devices, no compile)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config as ref_config
    from repro.launch.shapes import batch_shardings, batch_specs
    from repro.models.encdec import build_model as ref_build
    from repro.sharding import get_policy
    from repro.sharding.policy import fit_shardings_tree

    sizes, axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                   else ((16, 16), ("data", "model")))
    mesh = AbstractMesh(sizes, axes)
    cfg, cell = ref_config(arch), SHAPES[shape]
    pol = get_policy(policy).for_mesh(mesh)
    model = ref_build(cfg, pol, mesh, compute_dtype=jnp.bfloat16)

    def nbytes(tree, sh):
        return sum(math.prod(s.shard_shape(a.shape))
                   * np.dtype(a.dtype).itemsize
                   for a, s in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(sh)))
    params = model.init_abstract()
    out = {"params": nbytes(params, fit_shardings_tree(
        model.param_shardings(), params, mesh))}
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        out.update({"opt/step": 4, "opt/m": out["params"],
                    "opt/v": out["params"]})
    if cell.kind == "decode":
        out["cache"] = nbytes(model.cache_abstract(B, S),
                              model.cache_shardings(batch=B, max_seq=S))
        dp = [mesh.shape[a] for a in pol.dp if a in mesh.axis_names]
        dp = int(np.prod(dp)) if dp else 1
        tok = (pol.sharding(mesh, "batch") if B % dp == 0 and dp > 1
               else NamedSharding(mesh, P()))
        out["tokens"] = math.prod(tok.shard_shape((B,))) * 4
    else:
        batch = batch_specs(cfg, B, S)
        out["batch"] = nbytes(batch, fit_shardings_tree(
            batch_shardings(cfg, pol, mesh), batch, mesh))
    return out


CELLS = [(a, c) for a in ARCH_IDS for c in cells_for(get_config(a))]


@pytest.mark.parametrize("policy", ["baseline", "fsdp_all"])
@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{c}" for a, c in CELLS])
def test_argument_bytes_equal_reference(arch, shape, mesh_kind, policy):
    multi = mesh_kind == "multipod"
    mesh = make_production_mesh(multi_pod=multi, device="meta")
    cfg = get_config(arch)
    model = build_model(cfg, compute_dtype=torch.bfloat16, device="meta")
    got = dr.argument_bytes(dr.arguments(model, cfg, SHAPES[shape], mesh,
                                         policy))
    assert got == _ref_argument_bytes(arch, shape, multi, policy)


# ------------------------------------------------------------------ FLOPs
# Where the port's matmul / convolution FLOPs differ from the reference's:
#  * mamba2, jamba: the reference's SSD forms its intra-chunk output and
#    its chunk states as three- and four-operand einsums
#    (src/repro/models/mamba.py:117,121), whose backward XLA contracts
#    in part as dots where the port's two-operand einsums, over operands
#    it multiplied elementwise first (kernels/ssd_scan.py, ``_chunked``),
#    have none: three dots of 32,768 FLOPs per Mamba layer in a train
#    step at the smoke config (0.12-0.23% of the dot total);
#  * mamba2, jamba: the backward of the depthwise causal conv
#    (``mamba.causal_conv``): XLA's weight-gradient convolution, counted
#    by the reference's convolution formula, against torch's
#    ``convolution_backward`` formula -- 2,560 FLOPs per conv (0.04%).
NEAR = {"mamba2-2.7b", "jamba-v0.1-52b"}
FLOP_ARCHS = ["qwen1.5-0.5b", "h2o-danube-1.8b", "qwen3-moe-30b-a3b",
              "mamba2-2.7b", "jamba-v0.1-52b", "whisper-tiny",
              "qwen2-vl-7b"]
KINDS = ["train", "train_noremat", "prefill", "decode"]
B, S = 2, 64


def _ref_flops(arch, kind):
    """``analyze_hlo``'s dot and convolution FLOPs of the reference's step
    compiled for one device (the dry run's step: loss, grads, AdamW)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.shapes import batch_specs
    from repro.models.encdec import build_model as ref_build
    from repro.optim import AdamW
    from repro.optim.schedule import warmup_cosine
    from repro.sharding import get_policy

    cfg = ref_smoke(arch)
    model = ref_build(cfg, get_policy("baseline"), None,
                      compute_dtype=jnp.bfloat16,
                      remat=kind != "train_noremat")
    params = model.init_abstract()
    if kind.startswith("train"):
        opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100000))

        def step(p, o, b):
            (_, _), g = jax.value_and_grad(model.loss, has_aux=True)(p, b)
            return opt.update(g, o, p)[:2]
        lowered = jax.jit(step).lower(params, opt.init_abstract(params),
                                      batch_specs(cfg, B, S))
    elif kind == "prefill":
        lowered = jax.jit(model.prefill).lower(params,
                                               batch_specs(cfg, B, S))
    else:
        lowered = jax.jit(model.decode_step).lower(
            params, model.cache_abstract(B, S),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32))
    rec = analyze_hlo(lowered.compile().as_text(), 1)
    return {k: rec["flops_by_kind"].get(k, 0.0)
            for k in ("dot", "convolution")}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_smoke_flops_equal_reference(arch, kind):
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    cell = ShapeCell(f"smoke_{kind}", kind.split("_")[0], S, B)
    traced = dr.build_traced(get_smoke_config(arch), cell, mesh,
                             remat=kind != "train_noremat")
    rec = dr.analyse(traced, 1)
    got = {k: rec["flops_by_kind"].get(k, 0.0)
           for k in ("dot", "convolution")}
    want = _ref_flops(arch, kind)
    if arch in NEAR:
        assert got == pytest.approx(want, rel=1e-2)
    else:
        assert got == want
    assert not rec["unmodelled_ops"]          # the rules know every op


# -------------------------------------------------------------- the CLI
def test_list_equals_reference(capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                          "--list"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert dr.main(["--list"]) == 0
    assert capsys.readouterr().out == ref.stdout


# the reference's record keys (src/repro/launch/dryrun.py:297-322)
REF_KEYS = {"flops_per_device", "bytes_per_device", "score_bytes_per_device",
            "flops_by_kind", "bytes_by_kind", "top_traffic",
            "top_collectives", "xla_cost_flops", "xla_cost_bytes",
            "collectives", "memory", "top_buffers", "t_compute_s",
            "t_memory_s", "t_memory_flash_s", "t_collective_s", "dominant",
            "model_flops", "hlo_flops_global", "useful_flops_ratio",
            "roofline_bound_s", "roofline_fraction",
            "roofline_fraction_flash"}


@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
def test_reduced_mesh_traces_and_analyses(mesh_kind):
    """tests/test_dryrun_machinery.py's reduced-mesh run: the production
    axes at (4, 2) / (2, 2, 2), the smoke config, a train and a decode
    cell through ``build_traced`` and ``analyse``."""
    multi = mesh_kind == "multipod"
    mesh = make_mesh((2, 2, 2) if multi else (4, 2),
                     ("pod", "data", "model") if multi
                     else ("data", "model"), devices="meta")
    # a vocab that pads (500 -> 512): the masked padding columns run too
    cfg = get_smoke_config("qwen1.5-0.5b", vocab_size=500)
    assert cfg.padded_vocab > cfg.vocab_size
    for cell in (ShapeCell("smoke_train", "train", 64, 8),
                 ShapeCell("smoke_decode", "decode", 64, 8)):
        rec = dr.analyse(dr.build_traced(cfg, cell, mesh, "baseline"),
                         mesh.size)
        assert REF_KEYS <= set(rec), REF_KEYS - set(rec)
        assert rec["t_compute_s"] > 0 and rec["flops_per_device"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["memory"]["temp_size_in_bytes"] > 0
        assert rec["memory"]["argument_size_in_bytes"] == sum(
            rec["argument_bytes_by_part"].values())
        assert rec["fits"] and not rec["unmodelled_ops"]
        if cell.kind == "train":       # fsdp gathers, grad reductions
            coll = rec["collectives"]
            assert coll["all-gather"]["count"] > 0
            assert coll["reduce-scatter"]["count"] > 0
            assert coll["all-reduce"]["count"] > 0      # tp matmuls


def test_cli_writes_cells_under_out(tmp_path, capsys):
    out = tmp_path / "dryrun_torch"
    assert dr.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                    "--mesh", "both", "--out", str(out)]) == 0
    assert dr.main(["--cell", "whisper-tiny/train_4k/pod",
                    "--out", str(out)]) == 0
    names = sorted(os.listdir(out))
    assert names == [f"whisper-tiny__{c}__{m}__baseline.json" for c, m in
                     (("decode_32k", "multipod"), ("decode_32k", "pod"),
                      ("train_4k", "pod"))]
    for name in names:
        rec = json.loads((out / name).read_text())
        assert rec["ok"] and rec["n_devices"] in (256, 512)
        assert rec["memory"]["argument_size_in_bytes"] > 0
    printed = capsys.readouterr().out
    assert printed.count("memory_analysis:") == 3
    assert '"dominant"' in printed
