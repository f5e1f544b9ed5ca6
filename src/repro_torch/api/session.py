"""CheckpointSession — the libcriu-style façade over the snapshot engine.

One object owns the checkpoint lifecycle the way a ``criu_*`` session
does: configured by a :class:`CheckpointOptions`, preflighted with
:meth:`check`, driven with :meth:`checkpoint` / :meth:`restore`.

The :meth:`frozen` context manager exposes the dump phases::

    with session.frozen(step) as snap:      # ①–③ quiesce + capture done
        ...                                 # job is frozen; inspect snap
    # ④ on exit: write + commit + resume (abort on exception)
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

from repro_torch.api.capabilities import CheckReport, capabilities, check
from repro_torch.api.options import CheckpointOptions
from repro_torch.devices import DeviceLike, resolve_device

PyTree = Any


class SnapshotWriteFailed(RuntimeError):
    """A background snapshot write failed; step loops that poll
    :attr:`CheckpointSession.write_error` abort with it."""


class FrozenCheckpoint:
    """Handle to a dump frozen between capture (①–③) and commit (④)."""

    def __init__(self, engine, ctx):
        self._engine = engine
        self._ctx = ctx
        self._done = False
        self.path: Optional[str] = None

    @property
    def step(self) -> int:
        return self._ctx.step

    @property
    def stats(self) -> Dict[str, float]:
        return self._ctx.stats

    @property
    def warnings(self) -> List[str]:
        """The capture's warnings (e.g. the device plugin's note of
        device bytes left outside the captured tree)."""
        return self._ctx.warnings

    def commit(self) -> str:
        """Phase ④: write + manifest-commit the capture, resume the job."""
        if self._done:
            raise RuntimeError("frozen checkpoint already finished")
        self._done = True
        self.path = self._engine.commit_dump(self._ctx)
        return self.path

    def abort(self) -> None:
        """Resume the job without writing an image."""
        if not self._done:
            self._done = True
            self._engine.abort_dump(self._ctx)


class CheckpointSession:
    """Owns engine construction + lifecycle for one run directory.

    The "torch" backend captures and restores tensors on `device`:
    ``cuda`` unless the caller passes ``device="cpu"``, or the device of
    `mesh` (a grid of slots on one device, ``repro_torch.launch.mesh``),
    whose fingerprint the images carry."""

    def __init__(self, run_dir: str,
                 options: Optional[CheckpointOptions] = None, *,
                 device: DeviceLike = None,
                 mesh=None,
                 plugins: Optional[List[Any]] = None,
                 backend: str = "torch",
                 planner=None):
        from repro_torch.core.engine import SnapshotEngine
        self.run_dir = run_dir
        self.options = options if options is not None else CheckpointOptions()
        self.backend_name = backend
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device) if backend == "torch" else None
        if (mesh is not None and self.device is not None
                and mesh.device != self.device):
            raise ValueError(f"mesh on {mesh.device} given to a session "
                             f"on {self.device}")
        self.mesh = mesh
        self.engine = SnapshotEngine(run_dir, plugins=plugins,
                                     options=self.options, backend=backend,
                                     device=self.device, mesh=mesh)
        self._planner = planner

    # ------------------------------------------------------- constructors
    @classmethod
    def from_env(cls, run_dir: str, **kwargs) -> "CheckpointSession":
        """Session configured from ``REPRO_CKPT_*`` environment variables
        (:meth:`CheckpointOptions.from_env`)."""
        return cls(run_dir, CheckpointOptions.from_env(), **kwargs)

    @classmethod
    def from_engine(cls, engine) -> "CheckpointSession":
        """Wrap an already-built SnapshotEngine."""
        self = cls.__new__(cls)
        self.run_dir = engine.run_dir
        self.options = engine.options
        # registry name stamped by create_backend ("torch"/"host"), not
        # the plugin's own .name ("device")
        self.backend_name = getattr(engine.device_plugin, "backend_name",
                                    "torch")
        self.device = getattr(engine.device_plugin, "device", None)
        self.mesh = engine.mesh
        self.engine = engine
        self._planner = None
        return self

    # ------------------------------------------------------- preflight
    def capabilities(self) -> Dict[str, Any]:
        caps = capabilities()
        caps["session"] = {
            "run_dir": self.run_dir,
            "backend": self.backend_name,
            "device": str(self.device),
            "options": self.options.to_dict(),
            "plugins": [p.name for p in self.engine.registry.plugins],
            "plugin_features": sorted(self.engine.registry.features()),
        }
        return caps

    def check(self) -> CheckReport:
        return check(run_dir=self.run_dir, options=self.options)

    # ------------------------------------------------------- wiring
    def attach(self, provider: Callable[[], Dict[str, PyTree]],
               shardings=None) -> None:
        """`shardings`: {state: tree of NamedSharding} beside the
        provider's roots (or a callable returning it), since a tensor
        carries none; None writes every tensor whole."""
        self.engine.attach(provider, shardings)

    def register_host_state(self, name: str, getter: Callable[[], Any],
                            setter: Callable[[Any], None]) -> None:
        self.engine.register_host_state(name, getter, setter)

    def add_plugin(self, plugin) -> None:
        self.engine.add_plugin(plugin)

    def set_planner(self, planner) -> None:
        """Attach an :class:`repro_torch.runtime.interval.IntervalPlanner`:
        every committed dump's measured frozen-window cost
        (``engine.last_stats``) is fed into ``planner.observe(...)``, so
        the checkpoint interval adapts to the engine in use."""
        self._planner = planner

    def _feed_planner(self) -> None:
        if self._planner is not None and self.engine.last_stats:
            self._planner.observe(self.engine.last_stats)

    # ------------------------------------------------------- lifecycle
    def checkpoint(self, step: int) -> str:
        path = self.engine.checkpoint(step)
        self._feed_planner()
        return path

    def checkpoint_running(self, step: int) -> str:
        """Commit a snapshot while minimizing the pause the job observes:
        under ``capture="concurrent"`` the job is only paused for the pin
        and validate windows; otherwise an ordinary checkpoint."""
        path = self.engine.snapshot_while_running(step)
        self._feed_planner()
        return path

    def checkpoint_begin(self, step: int):
        """Start a soft-freeze capture (requires
        ``CheckpointOptions(capture="concurrent")``) and return its
        :class:`repro_torch.core.engine.ConcurrentCapture` handle.  The
        job keeps stepping while speculation runs; poll
        ``handle.speculation_done`` and call :meth:`checkpoint_finalize`
        for the short validate pause."""
        return self.engine.begin_concurrent(step)

    def checkpoint_finalize(self) -> Optional[str]:
        """Finalize the in-flight soft-freeze capture, if any.  Returns
        the snapshot path, or None when nothing was in flight."""
        handle = self.engine.concurrent_capture
        if handle is None:
            return None
        path = handle.finalize()
        self._feed_planner()
        return path

    @property
    def concurrent_capture(self):
        return self.engine.concurrent_capture

    @contextlib.contextmanager
    def frozen(self, step: int):
        """Freeze, yield the in-memory capture, commit (or abort) on exit.
        The body runs with the job quiesced and the image captured in
        host memory: inspect ``snap.step``, ``snap.stats`` and
        ``snap.warnings``, decide to ``snap.abort()``, or ``snap.commit()``
        early.  An exception in the body aborts the dump and propagates;
        an aborted dump feeds the planner no sample."""
        snap = FrozenCheckpoint(self.engine, self.engine.freeze(step))
        try:
            yield snap
        except BaseException:
            snap.abort()
            raise
        if not snap._done:
            snap.commit()
        if snap.path is not None:              # committed (not aborted)
            self._feed_planner()

    def restore(self, step: Optional[int] = None,
                verify: Optional[bool] = None,
                wait: Optional[str] = None, *, mesh=None,
                shardings: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """`criu restore`.  ``wait="critical"`` (the default when
        ``options.restore_mode == "lazy"``) returns once the critical set
        is placed — the job resumes while the rest of the image streams
        in the background; join it with :meth:`restore_barrier`.
        ``wait="all"`` blocks until the whole image is placed.  `mesh`
        (default: the session's) and `shardings` ({state: tree}) give the
        target layout; ``last_stats["topology_mode"]`` says identical,
        translated or resharded."""
        return self.engine.restore(step=step, verify=verify, wait=wait,
                                   mesh=mesh, shardings=shardings)

    def restore_into(self, template: PyTree, state: str = "train_state",
                     step: Optional[int] = None,
                     wait: Optional[str] = None, *, mesh=None,
                     shardings: Optional[PyTree] = None) -> PyTree:
        return self.engine.restore_into(template, state=state, step=step,
                                        wait=wait, mesh=mesh,
                                        shardings=shardings)

    def restore_barrier(self) -> Optional[Dict[str, Any]]:
        """Join the background restore stream (a no-op after eager
        restores) and return the complete restored tree.  Raises
        :class:`repro_torch.core.lazy.LazyRestoreError` if the stream
        died; the step is quarantined and a retried :meth:`restore` falls
        back to the previous committed image."""
        return self.engine.restore_barrier()

    @property
    def lazy_pending(self) -> bool:
        """True while a background restore stream is still outstanding."""
        return self.engine.lazy_pending

    # ------------------------------------------------------- queries
    @property
    def store(self):
        return self.engine.store

    @property
    def last_stats(self) -> Dict[str, Any]:
        return self.engine.last_stats

    @property
    def write_error(self) -> Optional[str]:
        """repr of the most recent async write failure, or None."""
        return self.engine.write_error

    @property
    def last_commit_step(self) -> Optional[int]:
        """Step of the newest image committed by this session."""
        return self.engine.last_commit_step

    @property
    def frozen_window_s(self) -> Optional[float]:
        """Blocked-window cost of the last dump in seconds: how long the
        job was frozen (async: the device-to-host copy only; sync: the
        whole dump and write).  This is the δ that drives τ*."""
        from repro_torch.runtime.interval import frozen_window_s
        return frozen_window_s(self.engine.last_stats)

    def latest_step(self) -> Optional[int]:
        return self.engine.latest_step()

    def wait_pending(self, timeout_s: Optional[float] = None) -> None:
        """Drain the async background writer."""
        self.engine.wait_pending(timeout_s)

    def __enter__(self) -> "CheckpointSession":
        return self

    def __exit__(self, *exc) -> None:
        self.wait_pending()
