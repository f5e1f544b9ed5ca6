"""The port's launchers and batch shapes on the CPU.

``repro_torch.launch.train`` with ``--fail-at`` and then ``--restore``
gives the uninterrupted run's final loss bitwise (qwen1.5 and
whisper-tiny, ``--smoke --device cpu``); ``repro_torch.launch.serve``
with ``--snapshot-at`` and then ``--restore`` gives the uninterrupted
tokens; without a card ``--device cuda`` (the default) raises.  The
shape cells, their meta-tensor batch specs and batch shardings equal the
reference's ``launch/shapes.py``.
"""
import json

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core.topology import spec_to_json as jax_spec_to_json
from repro.launch import shapes as jax_shapes
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.sharding import get_policy as jax_get_policy
from repro_torch.configs import get_config
from repro_torch.core.snapshot_io import SnapshotStore
from repro_torch.core.topology import spec_to_json
from repro_torch.launch import serve, shapes, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import get_policy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    start = out.index("{\n")
    return rc, json.loads(out[start:]), out


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_train_crash_and_restore_is_bitwise(arch, tmp_path, capsys):
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "8",
            "--ckpt-every", "4", "--batch-size", "2", "--seq-len", "16"]
    rc, ref, _ = _run(train.main, base + ["--run-dir",
                                          str(tmp_path / "a")], capsys)
    assert rc == 0 and ref["steps"] == 8 and ref["snapshots"] == [4, 8]
    assert train.main(base + ["--run-dir", str(tmp_path / "b"),
                              "--fail-at", "6"]) == 1
    assert "crashed" in capsys.readouterr().err
    assert SnapshotStore(str(tmp_path / "b")).list_steps() == [4]
    rc, got, out = _run(train.main, base + ["--run-dir",
                                            str(tmp_path / "b"),
                                            "--restore"], capsys)
    assert rc == 0 and "restored unified snapshot at step 4" in out
    assert got["final_loss"] == ref["final_loss"]         # bitwise
    assert got["restore_s"] > 0 and got["device"] == "cpu"
    meta = SnapshotStore(str(tmp_path / "b")).reader(8).meta["train_state"]
    assert meta["params/final_norm/scale"]["sharding"]["mesh"][
        "mesh_shape"] == [1, 1]                           # named, (1, 1)


def test_serve_snapshot_and_restore_is_token_exact(tmp_path, capsys):
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "8", "--tokens", "6", "--max-seq", "32"]
    rc, ref, _ = _run(serve.main, base + ["--run-dir",
                                          str(tmp_path / "a")], capsys)
    assert rc == 0 and ref["generated"] == 7 and ref["pos"] == 14
    rc, snap, out = _run(serve.main, base + ["--run-dir",
                                             str(tmp_path / "b"),
                                             "--snapshot-at", "3"], capsys)
    assert "serving snapshot at pos 11" in out
    assert snap["tokens_sha256"] == ref["tokens_sha256"]
    rc, got, out = _run(serve.main, base + ["--run-dir",
                                            str(tmp_path / "b"),
                                            "--restore"], capsys)
    assert rc == 0 and "restored mid-generation snapshot at pos 11" in out
    assert got["tokens_sha256"] == ref["tokens_sha256"]
    assert got["tokens_preview"] == ref["tokens_preview"]
    assert got["timings"]["restore_s"] > 0


@pytest.mark.parametrize("main", [train.main, serve.main],
                         ids=["train", "serve"])
def test_default_device_is_the_card(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--run-dir", str(tmp_path / "r")])


# ------------------------------------------------------------- shapes
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_specs_match_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert shapes.cells_for(cfg) == jax_shapes.cells_for(ref)
    assert shapes.skipped_cells_for(cfg) == jax_shapes.skipped_cells_for(ref)
    for cell in shapes.SHAPES:
        assert shapes.SHAPES[cell].__dict__ == \
            jax_shapes.SHAPES[cell].__dict__
        got = shapes.input_specs(arch, cell)
        want = jax_shapes.input_specs(arch, cell)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"                # no allocation
            assert tuple(t.shape) == tuple(want[k].shape), (cell, k)
            assert str(t.dtype).split(".")[1] == \
                jnp.dtype(want[k].dtype).name, (cell, k)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny",
                                  "qwen2-vl-7b"])
def test_batch_shardings_match_reference(arch):
    got = shapes.batch_shardings(get_config(arch), get_policy("baseline"),
                                 make_host_mesh(device="cpu"))
    want = jax_shapes.batch_shardings(jax_get_config(arch),
                                      jax_get_policy("baseline"),
                                      jax_host_mesh())
    assert sorted(got) == sorted(want)
    for k in got:
        assert spec_to_json(got[k].spec) == jax_spec_to_json(want[k].spec)
