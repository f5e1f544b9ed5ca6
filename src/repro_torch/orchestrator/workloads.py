"""Workload adapters: what the orchestrator runs inside one job.

A workload is the in-process stand-in for "the container the scheduler
manages": it exposes progress (``step``/``done``), cooperates with
preemption (``run_slice(n, preempt=...)`` checkpoints-on-signal and
yields), and can be rebuilt from its image after the fact (``restore``)
— node-replacement semantics, a *fresh* object per attempt.

Three kinds, matching the JAX package's:

  * :class:`TrainWorkload` — ``runtime.Trainer`` on the session engine
    (sync or async per :class:`CheckpointOptions`);
  * :class:`ServeWorkload` — ``runtime.DecodeServer`` decoding a batch,
    preempted and resumed token-exact mid-generation;
  * :class:`InterceptionWorkload` — the Cricket-style API-interception
    baseline on a 10→32→1 tanh MLP trained by torch autograd on the
    device: checkpoint = persist the replay log, restore = re-execute it.

Every workload runs on ``device``: ``cuda`` unless the caller passes
``"cpu"``.  A :class:`WorkloadConfig` says what the train and serve
workloads build; its defaults are the JAX package's hard-coded ones (the
qwen1.5-0.5b smoke config, a 2 x 32 f32 training batch without remat at
lr 5e-3, a 64-token ``max_seq`` with 8-token prompts), so a run of either
package does the same work.  ``run_slice`` waits for the device before it
reads the clock: its ``wall_s`` is the slice's device time, not its
launch time.  :meth:`release` drops the incarnation's device state when
the orchestrator evicts it, so the next tenant gets the memory back.

``digest()`` hashes the live state (leaves sorted by path, brought to the
host, bf16 as its uint16 bits) so tests can assert bit-exactness of a
preempted-and-recovered run against an undisturbed one.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.orchestrator.job import JobSpec
from repro_torch.serialization.pack import host_numpy

PyTree = Any


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """The model and shapes the train and serve workloads build.
    ``model=None`` is the qwen1.5-0.5b smoke config."""

    model: Optional[Any] = None           # a ModelConfig
    compute_dtype: torch.dtype = torch.float32
    use_kernels: bool = False
    remat: bool = False
    train_batch: int = 2
    train_seq: int = 32
    lr: float = 5e-3
    warmup_steps: int = 2
    serve_batch: int = 2
    prompt_len: int = 8
    max_seq: int = 64

    def model_config(self):
        if self.model is not None:
            return self.model
        from repro_torch.configs import get_smoke_config
        return get_smoke_config("qwen1.5-0.5b")

    def build_model(self, device: torch.device):
        from repro_torch.models.encdec import build_model
        return build_model(self.model_config(), compute_dtype=self.compute_dtype,
                  remat=self.remat, use_kernels=self.use_kernels,
                  device=device)


def sync(device: torch.device) -> None:
    """Wait for `device`'s queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_bytes(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        arr = host_numpy(leaf.detach().cpu())
    else:
        arr = np.asarray(leaf)
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _tree_digest(*trees: PyTree) -> str:
    h = hashlib.sha256()
    for tree in trees:
        flat = flatten_with_paths(tree)
        for k in sorted(flat):
            h.update(k.encode())
            h.update(_host_bytes(flat[k]))
    return h.hexdigest()


def _timed(device: torch.device, run: Callable[[], Dict[str, Any]]
           ) -> Dict[str, Any]:
    t0 = time.perf_counter()
    out = run()
    sync(device)
    out["wall_s"] = time.perf_counter() - t0
    return out


class TrainWorkload:
    kind = "train"

    def __init__(self, spec: JobSpec, run_dir: str, device: DeviceLike = None,
                 options: Optional[CheckpointOptions] = None,
                 attempt: int = 0, seed: int = 0,
                 workload: Optional[WorkloadConfig] = None, model=None):
        from repro_torch.runtime.trainer import TrainConfig, Trainer
        self.spec = spec
        self.device = resolve_device(device)
        w = workload or WorkloadConfig()
        tcfg = TrainConfig(batch_size=w.train_batch, seq_len=w.train_seq,
                           total_steps=max(spec.total_steps, 1),
                           lr=w.lr, warmup_steps=w.warmup_steps, seed=seed,
                           compute_dtype=w.compute_dtype, remat=w.remat,
                           ckpt=options if options is not None
                           else CheckpointOptions())
        self.trainer = Trainer(w.model_config(), tcfg, run_dir,
                               device=self.device,
                               model=model if model is not None
                               else w.build_model(self.device))
        # injected faults fire on the first incarnation only — a restarted
        # attempt replays past the fault point cleanly
        self._fail_at = spec.fail_at_step if attempt == 0 else None
        self._straggle_at = spec.straggle_at_step if attempt == 0 else None

    @property
    def session(self) -> CheckpointSession:
        return self.trainer.session

    @property
    def step(self) -> int:
        return self.trainer.step

    @property
    def done(self) -> bool:
        return self.trainer.step >= self.spec.total_steps

    def start(self) -> None:
        self.trainer.initialize()

    def run_slice(self, n_steps: int,
                  preempt: Optional[Callable[[], bool]] = None
                  ) -> Dict[str, Any]:
        target = min(self.trainer.step + n_steps, self.spec.total_steps)
        return _timed(self.device, lambda: self.trainer.run_until(
            target, preempt=preempt, fail_at=self._fail_at,
            straggle_at=self._straggle_at))

    def checkpoint(self, step: int) -> str:
        return self.session.checkpoint(step)

    def checkpoint_running(self, step: int) -> str:
        """Pre-copy round capture: commit a snapshot with the smallest
        pause the session's capture mode allows (soft-freeze pin+validate
        under capture="concurrent", an ordinary dump otherwise)."""
        return self.session.checkpoint_running(step)

    def restore(self) -> int:
        return self.trainer.restore()

    def finish(self) -> None:
        self.session.wait_pending()

    def release(self) -> None:
        """Drop this incarnation's device state."""
        self.trainer.release()

    @property
    def jit_triggers(self) -> int:
        """Just-in-time checkpoints fired by the trainer's own straggler
        monitor (inside ``run_until``), invisible to the orchestrator's
        slice-level cadence."""
        return len(self.trainer.jit_ckpt.triggered)

    def digest(self) -> str:
        return _tree_digest({"params": self.trainer.params,
                             "opt": self.trainer.opt_state})


class ServeWorkload:
    """Decode-serving job: total_steps = tokens to decode for the batch."""

    kind = "serve"

    def __init__(self, spec: JobSpec, run_dir: str, device: DeviceLike = None,
                 options: Optional[CheckpointOptions] = None,
                 attempt: int = 0, seed: int = 0,
                 workload: Optional[WorkloadConfig] = None, model=None):
        from repro_torch.runtime.server import DecodeServer
        self.spec = spec
        self.seed = seed
        self.device = resolve_device(device)
        w = workload or WorkloadConfig()
        self.server = DecodeServer(
            w.model_config(), run_dir, max_seq=w.max_seq,
            compute_dtype=w.compute_dtype, options=options,
            device=self.device,
            model=model if model is not None else w.build_model(self.device))
        self._batch = w.serve_batch
        self._prompt_len = w.prompt_len
        self._fail_at = spec.fail_at_step if attempt == 0 else None
        self._straggle_at = spec.straggle_at_step if attempt == 0 else None

    @property
    def session(self) -> CheckpointSession:
        return self.server.session

    @property
    def step(self) -> int:
        """Tokens decoded since prefill."""
        return max(0, self.server.pos - self._prompt_len)

    @property
    def done(self) -> bool:
        return self.step >= self.spec.total_steps

    def start(self) -> None:
        rng = np.random.default_rng(self.seed)
        prompt = rng.integers(
            1, self.server.cfg.vocab_size,
            size=(self._batch, self._prompt_len)).astype(np.int32)
        self.server.load(self.server.model.init(self.seed))
        self.server.start({"tokens": prompt})

    def run_slice(self, n_steps: int,
                  preempt: Optional[Callable[[], bool]] = None
                  ) -> Dict[str, Any]:
        target = min(self.step + n_steps, self.spec.total_steps)
        p = self._prompt_len
        out = _timed(self.device, lambda: self.server.decode_until(
            p + target, preempt=preempt,
            fail_at=None if self._fail_at is None else p + self._fail_at,
            straggle_at=(None if self._straggle_at is None
                         else p + self._straggle_at)))
        out["step"] = self.step
        return out

    def checkpoint(self, step: int) -> str:
        return self.server.checkpoint(step)

    def checkpoint_running(self, step: int) -> str:
        """Pre-copy round capture: commit a snapshot with the smallest
        pause the session's capture mode allows (soft-freeze pin+validate
        under capture="concurrent", an ordinary dump otherwise)."""
        return self.session.checkpoint_running(step)

    def restore(self) -> int:
        # cold boot: the image carries params, cache, and cursor; the
        # server derives abstract skeletons from the model — no prefill
        # re-execution on a replacement node
        self.server.restore()
        return self.step

    def finish(self) -> None:
        self.session.wait_pending()

    def release(self) -> None:
        """Drop this incarnation's device state."""
        self.server.release()

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(
            np.asarray(self.server.tokens, np.int32)).tobytes())
        h.update(str(self.server.pos).encode())
        return h.hexdigest()


def mlp_step(w: Dict[str, torch.Tensor], x: np.ndarray, y: np.ndarray
             ) -> Dict[str, torch.Tensor]:
    """One SGD step (lr 0.01) of the tanh MLP on the mean squared error,
    by torch autograd on the weights' device; returns new weights."""
    dev = w["w1"].device
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    p = {k: v.detach().requires_grad_() for k, v in w.items()}
    loss = torch.mean((torch.tanh(xt @ p["w1"]) @ p["w2"] - yt) ** 2)
    grads = torch.autograd.grad(loss, list(p.values()))
    return {k: (w[k] - 0.01 * g).detach() for k, g in zip(p, grads)}


class InterceptionWorkload:
    """Cricket-style baseline driven through the same job lifecycle.

    Checkpoint persists the full intercept log; restore replays it call by
    call from the initial state — recovery time grows with progress, the
    contrast with the image-based engines.  The step is functional (new
    weights per call), so the handle table keeps every call's outputs:
    the MLP is 352 floats.
    """

    kind = "intercept"

    def __init__(self, spec: JobSpec, run_dir: str, device: DeviceLike = None,
                 options: Optional[CheckpointOptions] = None,
                 attempt: int = 0, seed: int = 0,
                 workload: Optional[WorkloadConfig] = None, model=None):
        from repro_torch.baselines.interception import InterceptionCheckpointer
        self.spec = spec
        self.run_dir = run_dir
        self.device = resolve_device(device)
        os.makedirs(run_dir, exist_ok=True)
        self.ic = InterceptionCheckpointer(run_dir)
        wrng = np.random.default_rng([seed, 1])
        self._w0 = {k: torch.as_tensor(
            wrng.normal(size=shape).astype(np.float32) * np.float32(0.1),
            device=self.device) for k, shape in (("w1", (10, 32)),
                                                 ("w2", (32, 1)))}
        rng = np.random.default_rng(seed)
        self._x = rng.normal(size=(16, 10)).astype(np.float32)
        self._y = rng.normal(size=(16, 1)).astype(np.float32)
        self.w: Optional[Dict[str, torch.Tensor]] = None
        self.step = 0
        self._fail_at = spec.fail_at_step if attempt == 0 else None
        self._straggle_at = spec.straggle_at_step if attempt == 0 else None
        self.session = None             # no session engine underneath

    @property
    def done(self) -> bool:
        return self.step >= self.spec.total_steps

    def start(self) -> None:
        self.w = self._w0
        self.ic.register_initial_state("w", self.w)
        self._wrapped = self.ic.wrap(mlp_step, "step")

    def run_slice(self, n_steps: int,
                  preempt: Optional[Callable[[], bool]] = None
                  ) -> Dict[str, Any]:
        from repro_torch.runtime.fault import SimulatedFailure
        t0 = time.perf_counter()
        executed, preempted, ckpt_path = 0, False, None
        target = min(self.step + n_steps, self.spec.total_steps)
        while self.step < target:
            if preempt is not None and preempt():
                ckpt_path = self.checkpoint(self.step)
                preempted = True
                break
            if self._fail_at is not None and self.step == self._fail_at:
                raise SimulatedFailure(f"injected failure at {self.step}")
            if (self._straggle_at is not None
                    and self.step == self._straggle_at):
                time.sleep(0.25)                   # injected straggler
            self.w = self._wrapped(self.w, self._x, self._y)
            self.step += 1
            executed += 1
        sync(self.device)
        return {"steps": executed, "step": self.step,
                "preempted": preempted, "ckpt_path": ckpt_path,
                "wall_s": time.perf_counter() - t0}

    def checkpoint(self, step: int) -> str:
        return self.ic.checkpoint(step)

    def restore(self) -> int:
        paths = sorted(glob.glob(os.path.join(self.run_dir,
                                              "intercept_*.pkl")))
        if not paths:
            raise FileNotFoundError(
                f"no interception image under {self.run_dir}")
        path = paths[-1]
        self.start()
        results, stats = self.ic.restore(path, {"step": mlp_step},
                                         device=self.device)
        payload = torch.load(path, map_location="cpu", weights_only=False)
        self.step = payload["step"]
        # the final weights are the last logged call's outputs (or the
        # initial state when nothing was logged before the dump)
        if payload["log"]:
            handles = payload["log"][-1]["out_handles"]
            self.w = dict(zip(self._w0, (results[h] for h in handles)))
        # replay restored progress up to `step`; re-wrap so post-restore
        # steps keep extending a fresh log from the restored state
        self.ic = type(self.ic)(self.run_dir)
        self.ic.register_initial_state("w", self.w)
        self._wrapped = self.ic.wrap(mlp_step, "step")
        self._restore_stats = stats
        return self.step

    def finish(self) -> None:
        pass

    def release(self) -> None:
        """Drop the weights and the handle table (every logged output)."""
        self.w = None
        self.ic = None

    def digest(self) -> str:
        return _tree_digest({"w": self.w})


WORKLOADS = {"train": TrainWorkload, "serve": ServeWorkload,
             "intercept": InterceptionWorkload}


def job_dir_for(base_run_dir: str, job_id: str,
                host: Optional[str] = None) -> str:
    """Where one job's images live.  Single-host clusters keep the flat
    ``job_<id>`` layout; multi-host clusters nest it under the simulated
    host (``<host>/job_<id>``) — the migration transfer moves images
    between exactly these directories."""
    if host is None:
        return os.path.join(base_run_dir, f"job_{job_id}")
    return os.path.join(base_run_dir, host, f"job_{job_id}")


def host_cas_dir(base_run_dir: str, host: str) -> str:
    """One content-addressed chunk store per simulated host: transfers
    to the same host share dedup state across jobs and steps (the
    warm-CAS recovery-time win)."""
    return os.path.join(base_run_dir, host, ".cas")


def make_workload_factory(base_run_dir: str,
                          options: Optional[CheckpointOptions] = None,
                          device: DeviceLike = None,
                          workload: Optional[WorkloadConfig] = None
                          ) -> Callable[..., Any]:
    """Factory of factories: one job = one image dir under the run dir.
    The train and serve workloads of one factory share one model object
    (it holds no weights), built on first use."""
    dev = resolve_device(device)
    w = workload or WorkloadConfig()
    shared: Dict[str, Any] = {}

    def factory(spec: JobSpec, attempt: int, host: Optional[str] = None):
        cls = WORKLOADS[spec.kind]
        model = None
        if spec.kind != "intercept":
            if "model" not in shared:
                shared["model"] = w.build_model(dev)
            model = shared["model"]
        return cls(spec, job_dir_for(base_run_dir, spec.job_id, host),
                   device=dev, options=options, attempt=attempt,
                   workload=w, model=model)

    return factory
