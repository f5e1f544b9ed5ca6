"""Images across world sizes: restore an N-rank image onto M ranks.

Images written by the train launcher at 1, 2 and 4 gloo ranks (``--nproc
N --device cpu``) and one written on a (4, 2) mesh of slots in this
process (PR 22's one-device layout) are restored by ``elastic_restore``
onto a process mesh of M ranks (2 -> 1, 1 -> 2, 4 -> 2, slots -> 2), each
rank reading only the blocks that overlap its own, and the 2-rank image
onto a mesh of slots in this process: every rank's restored blocks,
placed at their indices, give back every saved leaf bit-equal.  The
ranks run ``_RANKS`` (written beside the images) under
``repro_torch.launch.dist.launch``, each subprocess bounded by a timeout.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.api import CheckpointOptions
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import (TorchBackend, assemble_global,
                                            flatten_with_paths)
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.distributed import Group
from repro_torch.launch.mesh import ProcessMesh, make_mesh
from repro_torch.models.encdec import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.runtime.elastic import elastic_restore
from repro_torch.runtime.trainer import TrainConfig, Trainer
from repro_torch.sharding import state_shardings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "qwen1.5-0.5b"
STEP = 3
TIMEOUT_S = 120
BASE = ["--smoke", "--device", "cpu", "--batch-size", "4", "--seq-len",
        "16", "--ckpt-mode", "sync", "--keep", "0", "--steps", str(STEP),
        "--ckpt-every", str(STEP), "--dist-timeout", "20"]

_RANKS = textwrap.dedent('''
    """Each rank restores an image with elastic_restore and saves its
    blocks, with their indices, for the test to place."""
    import json
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.device_plugin import flatten_with_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.encdec import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.sharding import state_shardings
    from repro_torch.sharding.policy import index_to_json, rank_index

    def restore_blocks(argv, g):
        run, out, arch = argv
        mesh = make_host_mesh(data=g.world, model=1, device="cpu", group=g)
        model = build_model(get_smoke_config(arch),
                            compute_dtype=torch.float32, remat=False,
                            device="cpu")
        got = elastic_restore(run, mesh, model, AdamW(lr=constant(1e-3)))
        tree = {"params": got["params"], "opt": got["opt"]}
        sh = flatten_with_paths(state_shardings(model, mesh))
        abstract = flatten_with_paths(
            {"params": model.init_abstract(),
             "opt": AdamW(lr=constant(1e-3)).init_abstract(
                 model.init_abstract())})
        blocks, index = {}, {}
        for k, t in flatten_with_paths(tree).items():
            shape = tuple(abstract[k].shape)
            blocks[k] = t.numpy()
            index[k] = index_to_json(rank_index(sh[k], shape), shape)
        np.savez(f"{out}/rank{g.rank}.npz", **blocks)
        with open(f"{out}/rank{g.rank}.json", "w") as f:
            json.dump({"index": index, "mode": got["topology_mode"],
                       "step": got["step"]}, f)
        return 0
''')


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + (extra or [])))
    env.pop("XLA_FLAGS", None)
    return env


def _start(argv, env=None):
    return subprocess.Popen([sys.executable, *argv], env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out: {proc.args}\n{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    return out


def _restore_on(ranks, run, out, helper_dir):
    os.makedirs(out, exist_ok=True)
    code = ("import sys\nfrom repro_torch.launch import dist\n"
            f"sys.exit(dist.launch('dist_ranks:restore_blocks', "
            f"{[run, out, ARCH]!r}, {ranks}, 'cpu', {out!r}, 20.0))")
    return _start(["-c", code], _env([helper_dir]))


def _slot_image(run):
    """A trainer on a (4, 2) mesh of slots, sync image at STEP."""
    cfg = get_smoke_config(ARCH)
    tcfg = TrainConfig(batch_size=4, seq_len=16, total_steps=STEP,
                       ckpt_every=STEP, compute_dtype=torch.float32,
                       ckpt=CheckpointOptions(mode="sync", keep=0))
    t = Trainer(cfg, tcfg, run, mesh=make_mesh((4, 2), ("data", "model"),
                                               devices="cpu"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t.initialize()
        t.run(STEP)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    (root / "dist_ranks.py").write_text(_RANKS)
    images = {n: str(root / f"n{n}") for n in (1, 2, 4)}
    procs = {n: _start(["-m", "repro_torch.launch.train", *BASE, "--nproc",
                        str(n), "--run-dir", run])
             for n, run in images.items()}
    images["slots"] = str(root / "slots")
    _slot_image(images["slots"])
    for p in procs.values():
        _finish(p)
    cases = {"2->1": (1, images[2]), "1->2": (2, images[1]),
             "4->2": (2, images[4]), "slots->2": (2, images["slots"])}
    procs = {c: _restore_on(m, run, str(root / c.replace(">", "")),
                            str(root)) for c, (m, run) in cases.items()}
    for p in procs.values():
        _finish(p)
    return {"root": root, "images": images, "cases": cases}


def _saved(run):
    reader = SnapshotStore(run).reader(STEP)
    try:
        return {k: assemble_global(reader.load_entry("train_state", k))
                for k, m in reader.meta["train_state"].items()
                if m["kind"] == "device_array"}
    finally:
        reader.close()


@pytest.mark.parametrize("case", ["2->1", "1->2", "4->2", "slots->2"])
def test_an_image_restores_onto_another_world_size_bit_equal(restored,
                                                             case):
    ranks, run = restored["cases"][case]
    out = restored["root"] / case.replace(">", "")
    saved = _saved(run)
    placed = {k: np.zeros_like(v) for k, v in saved.items()}
    seen = {k: np.zeros(v.shape, bool) for k, v in saved.items()}
    for r in range(ranks):
        blocks = np.load(out / f"rank{r}.npz")
        with open(out / f"rank{r}.json") as f:
            info = json.load(f)
        assert info["step"] == STEP and info["mode"] == "resharded"
        assert sorted(blocks.files) == sorted(saved)
        for k in saved:
            idx = tuple(slice(a, b) for a, b in info["index"][k])
            placed[k][idx] = blocks[k]
            seen[k][idx] = True
    for k, v in saved.items():
        assert seen[k].all(), k
        assert np.array_equal(placed[k], v), k
    if ranks == 2:
        # the params' d_model blocks went to the two ranks
        a = np.load(out / "rank0.npz")["params/embed/tok"]
        assert a.shape[-1] * 2 == saved["params/embed/tok"].shape[-1]


@pytest.mark.parametrize("shape", [(2, 1), (4, 2), (1, 1)])
def test_a_two_rank_image_restores_onto_a_mesh_of_slots(restored, shape):
    run = restored["images"][2]
    model = build_model(get_smoke_config(ARCH), compute_dtype=torch.float32,
                        remat=False, device="cpu")
    out = elastic_restore(run, make_mesh(shape, ("data", "model"),
                                         devices="cpu"),
                          model, AdamW(lr=constant(1e-3)))
    # (2, 1) slots: the image's mesh shape on one process ("translated")
    assert out["step"] == STEP and out["topology_mode"] == (
        "translated" if shape == (2, 1) else "resharded")
    got = flatten_with_paths({"params": out["params"], "opt": out["opt"]})
    saved = _saved(run)
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert np.array_equal(got[k].numpy(), v), k


def test_a_rank_reads_only_the_blocks_that_overlap_its_own(restored):
    """On a 2-rank process mesh rank r's restore of the 2-rank image reads
    block r of a split leaf, and a whole leaf's one block."""
    model = build_model(get_smoke_config(ARCH), compute_dtype=torch.float32,
                        remat=False, device="cpu")
    reader = SnapshotStore(restored["images"][2]).reader(STEP)
    try:
        for rank in (0, 1):
            devs = np.empty(2, dtype=object)
            devs[:] = [torch.device("cpu")] * 2
            mesh = ProcessMesh(devs.reshape(2, 1), ("data", "model"),
                               Group(rank, 2, torch.device("cpu"), "gloo"))
            names = TorchBackend.needed_pack_entries(
                reader, mesh, {"train_state": state_shardings(model, mesh)})
            embed = [n for n in names if "::params/embed/tok::" in n]
            assert embed == [f"train_state::params/embed/tok::s{rank}"]
            assert "train_state::opt/step::s0" in names
            assert {"__meta__", "__host__"} <= set(names)
    finally:
        reader.close()
