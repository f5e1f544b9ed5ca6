"""SnapshotEngine — unified, transparent CPU+device checkpointing on torch.

The CRIUgpu workflow (paper Fig. 4a), as in the reference engine:

  checkpoint(step):
    init plugins("dump")
    ① PAUSE_DEVICES        lock: drain the CUDA streams (timeout -> abort
                           and leave the job running, paper §3.1.1)
    ② CHECKPOINT_DEVICES   device->host: every tensor into pinned host
                           memory, finished before the job resumes
    ③ DUMP_EXT_STATE       host-side state via plugins (decode cursor, ...)
    ④ write + commit       pack files, then MANIFEST.json atomically;
                           sync mode: before resuming (paper-faithful);
                           async mode: resume after ②/③, write in a
                           background thread (CheckFreq-style)
    exit plugins(success)

  restore(step):
    read the newest valid manifest (CRC-verified, torn images skipped)
    RESTORE_EXT_STATE -> UPDATE_TOPOLOGY_MAP -> RESUME_DEVICES_LATE

Transparency contract: the serving code defines no checkpoint logic.  It
attaches a *state provider* (a zero-arg callable returning the live root
trees) and registers host state through CallbackPlugins.

Not ported yet (their options are rejected by ``CheckpointOptions``):
incremental images, concurrent (soft-freeze) capture, lazy restore,
replication and transfer.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.core.device_plugin import (flatten_with_paths,
                                            unflatten_like)
from repro_torch.core.lock import LockTimeout
from repro_torch.core.plugins import (CallbackPlugin, Hook, HookContext,
                                      Plugin, PluginRegistry)
from repro_torch.core.snapshot_io import (SnapshotStore, SnapshotWriter,
                                          auto_io_threads, pack_host_blob,
                                          snapshot_dir)
from repro_torch.core.streams import UnsafeOpInFlight
from repro_torch.core.topology import mesh_fingerprint
from repro_torch.obs import journal as obs_journal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

PyTree = Any
StateProvider = Callable[[], Dict[str, PyTree]]


class CheckpointAborted(RuntimeError):
    pass


class PendingWriteStalled(TimeoutError):
    """wait_pending(timeout_s=...) found the background writer still
    running past the deadline; the thread stays joinable."""

    def __init__(self, step, waited_s: float):
        self.step = step
        self.waited_s = waited_s
        super().__init__(
            f"async snapshot write for step {step} still running after "
            f"{waited_s:.1f}s; it remains joinable (retry wait_pending() "
            f"or check write_error)")


class SnapshotEngine:
    """Checkpoint/restore mechanism; most callers use
    :class:`repro_torch.api.CheckpointSession` one level higher."""

    def __init__(self, run_dir: str,
                 plugins: Optional[List[Plugin]] = None,
                 options=None,                       # api.CheckpointOptions
                 backend="torch",                    # name | Plugin instance
                 device=None):
        from repro_torch.api.options import CheckpointOptions
        self.options = options if options is not None else CheckpointOptions()
        self.options.validate()
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.store = SnapshotStore(run_dir)
        if isinstance(backend, str):
            from repro_torch.core.backends import create_backend
            backend = create_backend(
                backend, lock_timeout_s=self.options.lock_timeout_s,
                restore_threads=self.options.restore_threads, device=device)
        self.device_plugin = backend
        self.registry = PluginRegistry([self.device_plugin]
                                       + list(plugins or []))
        self.mode = self.options.mode
        self._provider: Optional[StateProvider] = None
        self._pending: Optional[threading.Thread] = None
        self._pending_ctx: Optional[HookContext] = None
        self._pending_err: List[BaseException] = []
        self._write_error: Optional[str] = None
        self.last_stats: Dict[str, Any] = {}
        # step of the newest image committed by THIS engine instance
        self.last_commit_step: Optional[int] = None

    # ------------------------------------------------------------ wiring
    def attach(self, provider: StateProvider) -> None:
        """Attach the live state roots (the 'process tree')."""
        self._provider = provider

    def register_host_state(self, name: str, getter: Callable[[], Any],
                            setter: Callable[[Any], None]) -> None:
        self.registry.add(CallbackPlugin(name, getter, setter))

    def _topology(self) -> Dict[str, Any]:
        return mesh_fingerprint(None, getattr(self.device_plugin, "device",
                                              None))

    # ------------------------------------------------------------ dump
    def checkpoint(self, step: int) -> str:
        """Create a unified snapshot.  Returns the snapshot directory."""
        return self.commit_dump(self.freeze(step))

    def freeze(self, step: int) -> HookContext:
        """Phases ①–③: quiesce and capture device + host state.  On return
        the image exists in host memory and the job is frozen; finish with
        :meth:`commit_dump` or :meth:`abort_dump`."""
        if self._provider is None:
            raise RuntimeError("no state provider attached")
        self.wait_pending()
        ctx = HookContext("dump", step)
        ctx.roots = self._provider()
        self.registry.init_all("dump")
        ctx.stats["t_start"] = time.perf_counter()
        try:
            with obs_trace.span("dump.pause", step=step):
                self.registry.run(Hook.PAUSE_DEVICES, ctx)   # ① lock
            t_frozen = time.perf_counter()
            with obs_trace.span("dump.capture", step=step):
                self.registry.run(Hook.CHECKPOINT_DEVICES, ctx)  # ② dev->host
            with obs_trace.span("dump.ext_state", step=step):
                self.registry.run(Hook.DUMP_EXT_STATE, ctx)  # ③ host state
            ctx.stats["frozen_s"] = time.perf_counter() - t_frozen
        except LockTimeout as e:
            # abort-to-running: nothing was mutated
            self.registry.exit_all("dump", False)
            raise CheckpointAborted(str(e)) from e
        except UnsafeOpInFlight as e:
            self.device_plugin.lock.unlock()
            self.registry.exit_all("dump", False)
            raise CheckpointAborted(str(e)) from e
        except Exception:
            self.device_plugin.lock.unlock()
            self.registry.exit_all("dump", False)
            raise
        return ctx

    def abort_dump(self, ctx: HookContext) -> None:
        """Abandon a frozen dump: resume the job, write nothing."""
        self.device_plugin.lock.unlock()
        self.registry.exit_all("dump", False)

    def commit_dump(self, ctx: HookContext) -> str:
        """Phase ④: write + commit the frozen capture, resume the job."""
        t_start = ctx.stats.pop("t_start", time.perf_counter())
        if self.mode == "sync":
            try:
                path = self._write(ctx)
            except Exception:
                self.device_plugin.lock.unlock()
                self.registry.exit_all("dump", False)
                raise
            ctx.stats["total_s"] = time.perf_counter() - t_start
            self.device_plugin.lock.unlock()                  # resume
            self.registry.exit_all("dump", True)
            self.last_stats = dict(ctx.stats)
            self._write_error = None
            self.last_commit_step = ctx.step
            return path

        # async: resume now, write in the background (the capture already
        # holds its own host copies, so the job may mutate its tensors)
        self.device_plugin.lock.unlock()
        ctx.stats["locked_total_s"] = time.perf_counter() - t_start
        obs_ctx = obs_trace.current_context()

        def writer():
            with obs_trace.context(**obs_ctx):
                try:
                    self._write(ctx)
                    self._write_error = None
                    self.last_commit_step = ctx.step
                    self.registry.exit_all("dump", True)
                except BaseException as e:
                    self._pending_err.append(e)
                    self._write_error = repr(e)
                    self.last_stats["write_error"] = repr(e)
                    self.registry.exit_all("dump", False)

        # publish the stats snapshot before the writer starts mutating them
        self.last_stats = dict(ctx.stats)
        self._pending = threading.Thread(target=writer, daemon=True,
                                         name="repro-async-writer")
        self._pending_ctx = ctx
        self._pending.start()
        return snapshot_dir(self.run_dir, ctx.step)

    def _write(self, ctx: HookContext) -> str:
        t0 = time.perf_counter()
        opts = self.options
        writer = SnapshotWriter(self.run_dir, ctx.step, host_id=0,
                                compress=opts.compress,
                                chunk_bytes=opts.chunk_mb << 20,
                                stripes=opts.stripes,
                                io_threads=opts.io_threads)
        try:
            with obs_trace.span("dump.write", step=ctx.step, mode=self.mode):
                writer.write_states(ctx.device_snapshot)
                writer.write_host_state(ctx.host_state)
                ctx.stats["serialize_s"] = time.perf_counter() - t0
                ctx.stats["host_bytes"] = float(
                    len(pack_host_blob(ctx.host_state)))
                path = writer.commit(topology=self._topology(),
                                     stats=ctx.stats,
                                     extra={"warnings": ctx.warnings,
                                            "mode": self.mode,
                                            "capture": "sync",
                                            "incremental": False})
            ctx.stats["write_s"] = time.perf_counter() - t0
            ctx.stats["written_bytes"] = float(writer.written_bytes)
            ctx.stats["reused_bytes"] = 0.0
            ctx.stats["compress_s"] = writer.compress_s
            ctx.stats["io_s"] = writer.io_s
        except BaseException:
            writer.abort()
            raise
        obs_metrics.counter_add("dump.count")
        obs_metrics.counter_add("dump.bytes_written",
                                ctx.stats["written_bytes"])
        obs_metrics.observe("dump.frozen_s", ctx.stats.get("frozen_s", 0.0))
        obs_journal.emit("dump", "commit", step=ctx.step,
                         bytes=ctx.stats["written_bytes"],
                         frozen_s=ctx.stats.get("frozen_s"))
        if chaos_hooks.INJECTOR is not None:
            # chaos: lost-writeback site (image committed)
            chaos_hooks.fire("engine.dump_done", run_dir=self.run_dir,
                             step=ctx.step, path=path)
        if self.options.keep:
            self.store.gc(self.options.keep)
        return path

    def wait_pending(self, timeout_s: Optional[float] = None) -> None:
        """Join the async background writer; with ``timeout_s`` a writer
        still running past the deadline raises PendingWriteStalled."""
        if self._pending is not None:
            t0 = time.perf_counter()
            step = self._pending_ctx.step if self._pending_ctx else None
            with obs_trace.span("dump.wait_pending", step=step) as sp:
                self._pending.join(timeout_s)
                if self._pending.is_alive():
                    waited = time.perf_counter() - t0
                    sp.set(stalled=True, waited_s=waited)
                    obs_metrics.observe("dump.pending_stall_s", waited)
                    obs_journal.emit("dump", "pending_stall", step=step,
                                     waited_s=waited, timeout_s=timeout_s)
                    raise PendingWriteStalled(step, waited)
            self._pending = None
            ctx, self._pending_ctx = self._pending_ctx, None
            if ctx is not None and not self._pending_err:
                # fold the writer's stage timings into last_stats
                self.last_stats.update(ctx.stats)
        if self._pending_err:
            # drain every queued failure: an older failed dump must never
            # be masked by a newer successful one
            errs = list(self._pending_err)
            self._pending_err.clear()
            msg = "; ".join(repr(e) for e in errs)
            self._write_error = msg
            self.last_stats["write_error"] = msg
            if len(errs) > 1:
                raise RuntimeError(
                    f"{len(errs)} async snapshot writes failed: {msg}"
                ) from errs[0]
            raise errs[0]

    @property
    def write_error(self) -> Optional[str]:
        """repr of the most recent async write failure (None if the last
        background dump committed cleanly)."""
        return self._write_error

    # ------------------------------------------------------------ restore
    def _open_verified(self, step: int, verify: bool, io_threads: int):
        reader = self.store.reader(step, verify=verify,
                                   io_threads=io_threads)
        if verify:
            try:
                reader.verify_all()
            except Exception:
                reader.close()
                raise
        return reader

    def restore(self, step: Optional[int] = None,
                verify: Optional[bool] = None) -> Dict[str, Any]:
        """Eager restore.  Returns {state_name: nested-dict tree}; host
        state is pushed back through the registered CallbackPlugins.
        With ``step=None`` the newest image that verifies is used."""
        if verify is None:
            verify = self.options.verify_restore
        self.wait_pending()
        io_threads = self.options.io_threads or auto_io_threads()
        with obs_trace.span("restore.critical", mode="eager") as sp, \
                self.store.lock:
            if step is None:
                # newest *valid* image: fall back past torn/corrupt ones
                for s in reversed(self.store.list_steps()):
                    try:
                        reader = self._open_verified(s, verify, io_threads)
                    except Exception:
                        continue
                    step = s
                    break
                else:
                    raise FileNotFoundError(
                        f"no restorable snapshot under {self.run_dir}")
            else:
                reader = self._open_verified(step, verify, io_threads)
            sp.set(step=step)
            ctx = HookContext("restore", step)
            ctx.reader = reader
            ctx.manifest = reader.manifest
            ctx.restore_threads = self.options.restore_threads
            self.registry.init_all("restore")
            try:
                ctx.host_state = reader.host_state()
                self.registry.run(Hook.RESTORE_EXT_STATE, ctx)
                self.registry.run(Hook.UPDATE_TOPOLOGY_MAP, ctx)
                self.registry.run(Hook.RESUME_DEVICES_LATE, ctx)
            except Exception:
                self.registry.exit_all("restore", False)
                raise
            finally:
                ctx.stats.update(reader.io_stats())
                reader.close()
        self.registry.exit_all("restore", True)
        ctx.stats["restore_mode"] = "eager"
        obs_metrics.counter_add("restore.count")
        obs_journal.emit("restore", "resumed", step=step, mode="eager")
        self.last_stats = dict(ctx.stats)
        self.last_stats["topology_mode"] = ctx.topology_map.get("mode")
        return ctx.restored

    @staticmethod
    def retree(template: PyTree, raw_tree: Any) -> PyTree:
        """Rebuild `template`'s structure (nested dicts, and dataclasses
        such as ``OptState`` as instances of their class) from a raw
        restored tree (every template leaf must be present)."""
        flat = flatten_with_paths(template)
        raw = flatten_with_paths(raw_tree)
        missing = set(flat) - set(raw)
        if missing:
            raise KeyError(f"snapshot missing leaves: {sorted(missing)[:5]}")
        return unflatten_like(template, raw)

    def restore_into(self, template: PyTree, state: str = "train_state",
                     step: Optional[int] = None) -> PyTree:
        """Restore one state into the caller's tree structure."""
        return self.retree(template, self.restore(step=step)[state])

    def latest_step(self) -> Optional[int]:
        return self.store.latest_step()
