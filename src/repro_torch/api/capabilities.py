"""Preflight — the `criu check` analogue for the torch port.

``capabilities()`` reports what this environment supports: torch and its
CUDA build, the visible device, whether Triton and nvcc (which build the
hand-written kernels) are present, the serialization stack and the
backend registry.  ``check()`` judges.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional


def capabilities() -> Dict[str, Any]:
    """Structured report of what this environment supports."""
    import torch

    from repro_torch.core.backends import available_backends
    from repro_torch.core.plugins import PLUGIN_API_VERSION

    from repro_torch.core.topology import process_info

    cuda = torch.cuda.is_available()
    return {
        "plugin_api_version": PLUGIN_API_VERSION,
        "torch": {
            "version": torch.__version__,
            "cuda_build": torch.version.cuda,
            "cuda_available": cuda,
            "device_count": torch.cuda.device_count() if cuda else 0,
            "device_name": torch.cuda.get_device_name(0) if cuda else None,
            # this process's rank and the group's size (0 and 1 outside
            # a group), as the reference's process_index / process_count
            **process_info(),
        },
        "kernels": {
            "triton": importlib.util.find_spec("triton") is not None,
            "nvcc": (shutil.which("nvcc") is not None
                     or os.path.exists("/usr/local/cuda/bin/nvcc")),
        },
        "serialization": {
            "msgpack": "msgpack_lite",        # the port's own codec
            "zlib": True,
            "zstd": False,
        },
        "backends": available_backends(),
        "modes": ["sync", "async"],
        "pack_formats": {"write": [1, 2], "read": [1, 2]},
        "features": {
            "incremental": True,
            "compression": True,
            "replication": True,
            "elastic_restore": True,      # runtime/elastic.py, any meshes
            "multi_process": True,        # launch/dist.py, a rank per card
            "parallel_restore": True,
            "chunked_packs": True,        # pack v2: per-chunk CRC + codec
            "striped_io": True,           # N pack files/host, appender each
            "pipelined_writer": True,     # capture -> compress -> write
            "chunk_dedup": True,          # incremental reuse at chunk grain
            "lazy_restore": True,         # restore_mode="lazy"
            "concurrent_capture": True,   # capture="concurrent"
            "delta_transfer": True,       # CAS have/want cross-host ship
            "content_addressed_store": True,  # repro_torch.transfer
            "migration": True,            # orchestrator migrate scenario
        },
        "transfer_modes": ["copy", "delta"],
        "restore_modes": ["eager", "lazy"],
        "captures": ["sync", "concurrent"],
    }


@dataclasses.dataclass
class CheckReport:
    ok: bool
    problems: List[str]
    warnings: List[str]
    capabilities: Dict[str, Any]

    def summary(self) -> str:
        lines = [f"repro_torch check: {'OK' if self.ok else 'FAIL'}"]
        lines += [f"  problem: {p}" for p in self.problems]
        lines += [f"  warning: {w}" for w in self.warnings]
        return "\n".join(lines)


def check(run_dir: Optional[str] = None, options=None,
          device=None) -> CheckReport:
    """Validate that checkpoint/restore can work here (`criu check`):
    builds a trivial mesh on `device` (default: the card if there is one,
    else the CPU), round-trips a host blob and, when `run_dir` is given,
    proves the image directory is writable.  No card, Triton or nvcc is a
    warning: CPU runs are legitimate when asked for."""
    problems: List[str] = []
    warns: List[str] = []
    caps = capabilities()
    if not caps["torch"]["cuda_available"]:
        warns.append("no CUDA device: only device='cpu' sessions work")
    elif not (caps["kernels"]["triton"] and caps["kernels"]["nvcc"]):
        warns.append("triton or nvcc missing: use_kernels=True cannot run "
                     "on the card")
    if "torch" not in caps["backends"]:
        problems.append("no 'torch' device backend registered")
    try:
        from repro_torch.launch.mesh import make_mesh
        if device is None:
            device = "cuda" if caps["torch"]["cuda_available"] else "cpu"
        make_mesh((1,), ("data",), devices=device)
    except Exception as e:
        problems.append(f"mesh construction failed: {e}")
    try:
        from repro_torch.core.snapshot_io import (pack_host_blob,
                                                  unpack_host_blob)
        if unpack_host_blob(pack_host_blob({"probe": 1}))["probe"] != 1:
            problems.append("host-blob round-trip corrupted data")
    except Exception as e:
        problems.append(f"host-blob round-trip failed: {e}")
    if options is not None:
        try:
            options.validate()
        except Exception as e:
            problems.append(f"invalid options: {e}")
    if run_dir is not None:
        try:
            os.makedirs(run_dir, exist_ok=True)
            with tempfile.NamedTemporaryFile(dir=run_dir, prefix=".check"):
                pass
        except OSError as e:
            problems.append(f"run_dir {run_dir!r} not writable: {e}")
    return CheckReport(ok=not problems, problems=problems, warnings=warns,
                       capabilities=caps)
