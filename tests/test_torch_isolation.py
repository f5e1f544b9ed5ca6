"""The port stands alone: it imports neither ``jax`` nor ``repro``.

Also: ``chip_smoke.py`` refuses to run (non-zero, no result printed)
without a CUDA device or away from the repository.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SUBPACKAGES = ["repro_torch", "repro_torch.api", "repro_torch.core",
               "repro_torch.kernels", "repro_torch.kernels.flash_attention",
               "repro_torch.kernels.rmsnorm", "repro_torch.kernels.build",
               "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba",
               "repro_torch.models.moe",
               "repro_torch.models.lm", "repro_torch.models.encdec",
               "repro_torch.models.convert",
               "repro_torch.configs", "repro_torch.runtime.server",
               "repro_torch.serialization.pack", "repro_torch.obs",
               "repro_torch.chaos.hooks", "repro_torch.core.streams",
               "repro_torch.optim", "repro_torch.optim.adamw",
               "repro_torch.optim.schedule", "repro_torch.data",
               "repro_torch.data.pipeline", "repro_torch.runtime.fault",
               "repro_torch.runtime.trainer", "repro_torch.core.dirty",
               "repro_torch.core.lazy", "repro_torch.core.engine",
               "repro_torch.core.replication", "repro_torch.core.multihost",
               "repro_torch.transfer", "repro_torch.transfer.cas",
               "repro_torch.transfer.delta", "repro_torch.transfer.precopy",
               "repro_torch.runtime.interval", "repro_torch.baselines",
               "repro_torch.baselines.interception",
               "repro_torch.orchestrator", "repro_torch.orchestrator.signals",
               "repro_torch.orchestrator.recovery",
               "repro_torch.orchestrator.job",
               "repro_torch.orchestrator.scheduler",
               "repro_torch.orchestrator.workloads",
               "repro_torch.orchestrator.orchestrator",
               "repro_torch.orchestrator.scenarios",
               "repro_torch.orchestrator.fleet",
               "repro_torch.chaos", "repro_torch.chaos.plan",
               "repro_torch.chaos.injector", "repro_torch.chaos.sim",
               "repro_torch.chaos.campaign", "repro_torch.obs.plane",
               "repro_torch.obs.export", "repro_torch.cli",
               "repro_torch.__main__"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {SUBPACKAGES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    bad = {"jax", "jaxlib", "repro", "msgpack", "ml_dtypes", "zstandard"}
    assert not bad & set(_imported_roots(path))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_card_or_repo(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "repo":
        import torch
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: chip_smoke.py would run "
                        "in full")
    else:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
