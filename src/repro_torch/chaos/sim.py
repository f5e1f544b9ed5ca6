"""SimWorkload — a cheap, bit-deterministic fleet workload for campaigns.

A chaos campaign needs hundreds of jobs, each with an *unfaulted
reference digest* computable in-process: :func:`reference_digest` runs
the pure step function to completion, and a job that recovered
bit-exact (no matter how many kills/restores it survived) must land on
the identical digest — float64 ops replayed over the exact bytes a pack
round-trip preserves.

The workload drives the same :class:`~repro_torch.api.CheckpointSession`
machinery as the real trainer workloads — sync commits, incremental pack
v2, delta replication to a per-job replica store — so injected faults
exercise the production dump/transfer/restore paths, not a mock.

A port of the JAX package's sim.  The state is a float64 tensor of
``VEC_LEN`` elements on ``device`` (``cuda`` unless the caller passes
``"cpu"``), captured and restored through the torch backend.  The step
function is the workload's definition, and the reference's digest is
over numpy's float64 bits, so its arithmetic depends on where the state
lives:

* on a CPU tensor the step runs ``np.sin`` on the tensor's numpy view,
  so the port's CPU digests (and a campaign's fingerprint) equal the
  JAX package's bit for bit;
* on a CUDA tensor it runs ``torch.sin`` on the card, whose rounding is
  the card's own: ``torch.sin`` is not ``np.sin`` (on the CPU, torch
  2.13 against numpy 2.0, they differ by 1 ulp on 2-5 of the 2048
  elements after one step and on 27-52 after a default job's 12 steps,
  jobs j000-j004), so a card's digests are checked against
  :func:`reference_digest` replayed on the same device.

The digest comparison stays exact either way: a job that recovers to
other bits is silent corruption.
"""
from __future__ import annotations

import hashlib
import time
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.api import CheckpointOptions, CheckpointSession, TransferPolicy
from repro_torch.api.session import SnapshotWriteFailed
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.orchestrator.job import JobSpec
from repro_torch.orchestrator.workloads import job_dir_for

from . import hooks

VEC_LEN = 2048


def _job_seed(job_id: str) -> int:
    return zlib.crc32(job_id.encode())


def _init_vec(job_id: str) -> np.ndarray:
    rng = np.random.default_rng(_job_seed(job_id))
    return rng.standard_normal(VEC_LEN).astype(np.float64)


def _sim_step(vec: torch.Tensor, step: int) -> torch.Tensor:
    # pure f(vec, step): nonlinear enough that a wrong restore diverges,
    # bounded so hundreds of steps stay finite, bitwise-reproducible
    if vec.is_cuda:
        return torch.sin(vec) * 1.0001 + (step % 7) * 1e-3
    v = vec.numpy()
    return torch.from_numpy(np.sin(v) * np.float64(1.0001)
                            + np.float64((step % 7) * 1e-3))


def _digest(vec: torch.Tensor, step: int) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(vec.cpu().numpy()).tobytes())
    h.update(int(step).to_bytes(8, "little"))
    return h.hexdigest()


def _start_vec(job_id: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_init_vec(job_id)).to(device)


def reference_digest(spec: JobSpec, device: DeviceLike = None) -> str:
    """Digest of the job's final state in an unfaulted world, stepped on
    `device` (``cuda`` unless the caller passes ``"cpu"``)."""
    vec = _start_vec(spec.job_id, resolve_device(device))
    for step in range(spec.total_steps):
        vec = _sim_step(vec, step)
    return _digest(vec, spec.total_steps)


def warm_up(device: DeviceLike = None) -> None:
    """One step and one tiny device-to-host copy on `device`, so a
    campaign's first slice pays no CUDA context creation or first-launch
    cost inside its heartbeat deadline."""
    _digest(_sim_step(_start_vec("warm-up", resolve_device(device)), 0), 0)


class SimWorkload:
    """Orchestrator workload protocol over a deterministic float64 state."""

    kind = "sim"

    def __init__(self, spec: JobSpec, run_dir: str,
                 options: Optional[CheckpointOptions] = None,
                 attempt: int = 0, device: DeviceLike = None):
        self.spec = spec
        self.run_dir = run_dir
        self.attempt = attempt
        self.device = resolve_device(device)
        self.vec: Optional[torch.Tensor] = None
        self.step = 0
        self.session = CheckpointSession(
            run_dir, options if options is not None else CheckpointOptions(),
            device=self.device)
        self.session.attach(lambda: {"sim_state": {"vec": self.vec}})
        self.session.register_host_state(
            "cursor", lambda: {"step": self.step}, self._set_cursor)

    def _set_cursor(self, value: Dict[str, Any]) -> None:
        self.step = int(value["step"])

    @property
    def done(self) -> bool:
        return self.step >= self.spec.total_steps

    def start(self) -> None:
        self.vec = _start_vec(self.spec.job_id, self.device)
        self.step = 0

    def run_slice(self, n_steps: int,
                  preempt: Optional[Callable[[], bool]] = None
                  ) -> Dict[str, Any]:
        if hooks.INJECTOR is not None:
            hooks.fire("sim.slice", job_id=self.spec.job_id, step=self.step)
        t0 = time.perf_counter()
        executed, preempted, ckpt_path = 0, False, None
        target = min(self.step + n_steps, self.spec.total_steps)
        while self.step < target:
            if preempt is not None and preempt():
                try:
                    ckpt_path = self.checkpoint(self.step)
                except SnapshotWriteFailed:
                    raise
                except Exception as e:
                    # the orchestrator only recognizes SnapshotWriteFailed
                    # around run_slice; a raw dump failure here must fail
                    # this job, never the whole loop
                    raise SnapshotWriteFailed(
                        f"checkpoint-on-signal failed: {e!r}") from e
                preempted = True
                break
            if hooks.INJECTOR is not None:
                delay = hooks.fire("sim.step", job_id=self.spec.job_id,
                                   step=self.step)
                if delay:              # degraded-I/O straggler window
                    time.sleep(delay)
            self.vec = _sim_step(self.vec, self.step)
            self.step += 1
            executed += 1
        return {"steps": executed, "step": self.step,
                "preempted": preempted, "ckpt_path": ckpt_path,
                "wall_s": time.perf_counter() - t0}

    def checkpoint(self, step: int) -> str:
        if hooks.INJECTOR is not None:
            hooks.fire("sim.checkpoint", job_id=self.spec.job_id, step=step)
        return self.session.checkpoint(step)

    def restore(self) -> int:
        if hooks.INJECTOR is not None:
            hooks.fire("sim.restore", job_id=self.spec.job_id)
        out = self.session.restore()
        self.vec = out["sim_state"]["vec"].to(
            self.device, torch.float64).contiguous()
        return self.step           # cursor setter ran during the restore

    def finish(self) -> None:
        self.session.wait_pending()

    def release(self) -> None:
        """Drop this incarnation's state tensor."""
        self.vec = None

    def digest(self) -> str:
        return _digest(self.vec, self.step)


def make_sim_factory(base_run_dir: str,
                     non_incremental: Any = (),
                     replicate: bool = True,
                     capture: str = "sync",
                     device: DeviceLike = None) -> Callable[..., SimWorkload]:
    """Workload factory for campaigns, every job's state on `device`
    (``cuda`` unless the caller passes ``"cpu"``).

    Every job gets sync pack-v2 commits and (by default) delta
    replication to a per-job ``<job_dir>_replica`` store.  Jobs listed in
    `non_incremental` write self-contained images: a torn historical
    image must not poison later incremental children (their re-push would
    keep re-reading the torn chunk), which is exactly the configuration a
    fleet operator would pick for hosts with suspect storage.

    ``capture="concurrent"`` runs every *incremental* job's dumps through
    the soft-freeze path (pin → speculate → validate → commit);
    non-incremental jobs stay on sync capture, which concurrent mode
    requires anyway.
    """
    non_incremental = set(non_incremental)
    dev = resolve_device(device)

    def factory(spec: JobSpec, attempt: int,
                host: Optional[str] = None) -> SimWorkload:
        job_dir = job_dir_for(base_run_dir, spec.job_id, host)
        incremental = spec.job_id not in non_incremental
        opts = CheckpointOptions(
            mode="sync", pack_format=2, stripes=2, chunk_mb=1,
            io_threads=1,
            incremental=incremental,
            capture=capture if incremental else "sync",
            replicate_to=(job_dir + "_replica") if replicate else None,
            transfer_policy=TransferPolicy(mode="delta", workers=1),
            verify_restore=True)
        return SimWorkload(spec, job_dir, options=opts, attempt=attempt,
                           device=dev)

    return factory
