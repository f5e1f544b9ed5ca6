"""The port's examples (``examples/torch/``) on the CPU, against the JAX
package's scripts of the same name.

Each port example's ``main(device="cpu", run_dir)`` runs in this process
and asserts what its JAX script asserts (bitwise losses after a restore,
a token-exact resumed generation, completion after injected crashes, a
(4, 2) image restored bit-equal onto (2, 2)).  The JAX script runs beside
it as a subprocess, and what it prints is compared with what the port's
``main`` returns wherever the two do not depend on the random init (the
packages draw their params from different generators): the image steps,
the restored step or decode position, the restart count, the topology
mode.
"""
import ast
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ["quickstart", "serve_with_snapshots", "fault_tolerant_training",
            "elastic_restore"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_example(name: str):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start_jax_example(name: str, run_dir: pathlib.Path):
    """The JAX script in a subprocess, on the host's default device count
    (another test module of this worker may have set ``XLA_FLAGS``;
    ``elastic_restore.py`` sets its own)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"),
         str(run_dir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _printed(out: str, pattern: str):
    m = re.search(pattern, out)
    assert m, f"{pattern!r} not in the JAX example's output:\n{out}"
    return m.group(1)


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_matches_jax_example(name, tmp_path):
    jax_run = _start_jax_example(name, tmp_path / "jax")
    try:
        got = _port_example(name).main(device="cpu",
                                       run_dir=str(tmp_path / "port"))
        out, _ = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, out
    assert out.rstrip().endswith("OK"), out
    if name == "quickstart":
        # the periodic images (every 10 steps); a just-in-time image lands
        # where a step ran slow, which differs between runs
        jax_images = ast.literal_eval(_printed(out, r"snapshots: (\[.*\])"))
        assert [s for s in got["snapshots"] if s % 10 == 0] == \
            [s for s in jax_images if s % 10 == 0] == [10, 20]
        assert got["restored_step"] == int(
            _printed(out, r"restored at step (\d+)"))
        assert got["bitwise"] and "bitwise identical = True" in out
    elif name == "serve_with_snapshots":
        assert got["snapshot_pos"] == got["restored_pos"] == int(
            _printed(out, r"restored at pos (\d+)")) == int(
            _printed(out, r"decoded 5 tokens; pos=(\d+)"))
        assert "token-exact resume: OK" in out
    elif name == "fault_tolerant_training":
        assert (got["steps"], got["restarts"]) == tuple(map(int, re.search(
            r"steps=(\d+) restarts=(\d+)", out).groups()))
        jax_images = ast.literal_eval(
            _printed(out, r"snapshots on disk: (\[.*\])"))
        # the periodic images (every 5 steps); a just-in-time image lands
        # where a step ran slow, which differs between runs
        assert [s for s in got["snapshots"] if s % 5 == 0] == \
            [s for s in jax_images if s % 5 == 0]
        assert got["final_step"] == 50
        assert got["dead_workers"] == ast.literal_eval(
            _printed(out, r"dead workers: (\[.*\])"))
    else:
        mode, step = re.search(r"topology mode: (\w+)\s+step: (\d+)",
                               out).groups()
        assert (got["topology_mode"], got["step"]) == (mode, int(step))
        assert got["slots"] == 4 and "bitwise identical" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_needs_a_card_by_default(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _port_example(name).main(run_dir=str(tmp_path / "run"))
