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
    lazy mode: return once the critical set is placed; the rest streams
    in the background and restore_barrier() joins it

Incremental images take the newest image strictly below the step as
parent.  Concurrent capture (``capture="concurrent"``) is the soft-freeze
protocol: pin -> speculate -> validate -> patch -> commit
(:class:`ConcurrentCapture`).

Replication (``replicate_to``, or a ``replicator=``): every committed image
is pushed to the peer right after its manifest lands (inside the freeze in
sync mode, so only committed images replicate); a restore that finds no
valid local image pulls the peer's newest and restores it
(``last_stats["restored_from_replica"]``); a lazy stream that hits a torn
chunk re-pulls the image from the peer and retries the entry.

Transparency contract: the serving code defines no checkpoint logic.  It
attaches a *state provider* (a zero-arg callable returning the live root
trees) and registers host state through CallbackPlugins.

Meshes (``mesh=``, a grid of slots on the engine's device,
:mod:`repro_torch.launch.mesh`): a tensor carries no sharding, so the
caller attaches a tree of ``NamedSharding``s beside the provider's
(``attach(provider, shardings=...)``); each sharded tensor is written as
its distinct blocks, and the manifest's topology names the mesh.  A
restore onto ``mesh=`` (default: the engine's) with optional target
``shardings=`` places the blocks straight into the device tensors when
the layouts agree, and reassembles otherwise;
``last_stats["topology_mode"]`` says identical, translated or
resharded.

Across processes (``mesh=`` a ``launch.mesh.ProcessMesh``, one rank per
card; its group gives rank, world and collectives): every rank's engine
captures its own blocks into ``host{rank:04d}.pack`` and the image is
committed by the two-phase commit of ``core/multihost.py`` (each rank
prepares, rank 0 writes the merged manifest once all have, a crash
before that leaves no image), with the group's timeout as the barrier's
deadline.  The ranks agree on
an attempt token when a dump starts, and on the step a restore takes:
the newest image whose entries every rank verifies (each rank checks
only the blocks it reads).  The engine's modes work across the ranks:

  * incremental: rank 0 picks the parent (the newest image below the
    step in its store) and broadcasts it with the attempt token; each
    rank dedups the blocks it holds against the parent's entries of the
    same name *and* extent (after a restore onto another world size a
    name may cover another block), and the merged manifest names the
    parent every rank used, with the written and reused bytes summed;
  * lazy restore: each rank verifies only the critical entries that meet
    its own blocks before it resumes, streams the rest of its blocks on
    the materializer's stream, and :meth:`restore_barrier` is a
    collective: a stream that failed on any rank quarantines the step on
    every rank, so the retry falls back on every rank together;
  * concurrent capture: each rank speculates its own blocks; the trainer
    finalizes once every rank's speculation is done (a collective), and
    the patch and the commit go through each rank's writer and barrier;
  * replication: each rank pushes its own pack, and once every rank has
    reported its push (a filesystem barrier on the peer, as the commit's)
    rank 0 lands the manifest, last; a restore that finds no image every
    rank verifies has rank 0 pull the replica's newest, and every rank
    opens the pulled step.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.core.device_plugin import (flatten_shardings,
                                            flatten_with_paths,
                                            unflatten_like)
from repro_torch.core.dirty import DirtyTracker
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
                 device=None,
                 replicator=None,                    # core.replication
                 mesh=None):                         # launch.mesh.Mesh
        from repro_torch.api.options import CheckpointOptions
        self.options = options if options is not None else CheckpointOptions()
        self.options.validate()
        self.run_dir = run_dir
        self.mesh = mesh
        # across processes: the process mesh whose ranks commit together
        self.ranks = mesh if getattr(mesh, "is_process_mesh", False) \
            else None
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
        self.incremental = self.options.incremental
        self.replicator = replicator
        if replicator is None and self.options.replicate_to:
            policy = self.options.transfer_policy
            if policy.mode == "delta":
                from repro_torch.transfer import DeltaReplicator
                self.replicator = DeltaReplicator(
                    self.options.replicate_to, workers=policy.workers)
            else:
                from repro_torch.core.replication import DirReplicator
                self.replicator = DirReplicator(self.options.replicate_to)
        if self.replicator is not None and self.ranks is not None:
            if not hasattr(self.replicator, "bind_ranks"):
                from repro_torch.api.options import OptionsError
                raise OptionsError(
                    f"replicator {type(self.replicator).__name__} cannot "
                    f"push across the ranks of a process mesh")
            # each rank pushes its own pack; rank 0 lands the manifest
            self.replicator.bind_ranks(self.ranks.rank, self.ranks.world,
                                       self.ranks.group.timeout_s)
        if self.options.capture == "concurrent":
            from repro_torch.api.options import OptionsError
            feats = getattr(self.device_plugin, "features", frozenset())
            if "dirty_tracking" not in feats:
                raise OptionsError(
                    f"capture='concurrent' needs a backend with the "
                    f"'dirty_tracking' feature; backend "
                    f"{getattr(self.device_plugin, 'backend_name', self.device_plugin.name)!r} "
                    f"offers {sorted(feats)} (sync-only capture)")
        self._concurrent: Optional["ConcurrentCapture"] = None
        self._provider: Optional[StateProvider] = None
        self._shardings = None
        self._pending: Optional[threading.Thread] = None
        self._pending_ctx: Optional[HookContext] = None
        self._pending_err: List[BaseException] = []
        self._write_error: Optional[str] = None
        # lazy-restore stream: at most one background materializer per
        # engine; a failed stream quarantines its step so the retry's
        # newest-valid scan falls back past it (eager semantics)
        self._lazy = None
        self._lazy_ctx: Optional[HookContext] = None
        self._lazy_step: Optional[int] = None
        self._last_restored: Optional[Dict[str, Any]] = None
        self._quarantined: set = set()
        self.last_stats: Dict[str, Any] = {}
        # the newest restore's stats (a lazy one's stream time added at
        # the join); later dumps leave them as they are
        self.last_restore_stats: Dict[str, Any] = {}
        # step of the newest image committed by THIS engine instance
        self.last_commit_step: Optional[int] = None

    @property
    def is_primary(self) -> bool:
        """Rank 0 of a process mesh, or the one process."""
        return self.ranks is None or self.ranks.rank == 0

    def _barrier(self, step: int, attempt: Optional[str]):
        """The two-phase commit of `step` across the ranks (None with
        no process mesh); its deadline is the group's timeout."""
        if self.ranks is None:
            return None
        from repro_torch.core.multihost import MultiHostCommit
        return MultiHostCommit(self.run_dir, step, self.ranks.rank,
                               self.ranks.world,
                               deadline_s=self.ranks.group.timeout_s,
                               attempt=attempt, poll_s=0.002)

    def _agree_attempt(self, ctx: HookContext) -> None:
        """Every rank takes rank 0's token for this dump and, for an
        incremental image, rank 0's parent: the newest image strictly
        below the step (a re-dump of a step must never take the image it
        is about to overwrite as its own parent).  A collective: every
        rank dumps the same steps, in the same order."""
        parent = None
        if self.incremental and self.is_primary:
            below = [s for s in self.store.list_steps() if s < ctx.step]
            parent = below[-1] if below else None
        if self.ranks is not None:
            ctx.attempt, parent = self.ranks.group.broadcast_object(
                (uuid.uuid4().hex, parent))
        ctx.parent = parent

    # ------------------------------------------------------------ wiring
    def attach(self, provider: StateProvider, shardings=None) -> None:
        """Attach the live state roots (the 'process tree').  `shardings`
        ({state: tree of NamedSharding, None where unsharded}, or a
        zero-arg callable returning it at each dump) lays the roots over
        the engine's mesh."""
        self._provider = provider
        self._shardings = shardings

    def capture_shardings(self) -> Dict[str, Dict[str, Any]]:
        """The attached shardings as {state: {path: sharding}}."""
        sh = self._shardings
        return flatten_shardings(sh() if callable(sh) else sh)

    def register_host_state(self, name: str, getter: Callable[[], Any],
                            setter: Callable[[Any], None]) -> None:
        self.registry.add(CallbackPlugin(name, getter, setter))

    def add_plugin(self, plugin) -> None:
        self.registry.add(plugin)

    def _topology(self) -> Dict[str, Any]:
        return mesh_fingerprint(self.mesh, getattr(self.device_plugin,
                                                   "device", None))

    # ------------------------------------------------------------ dump
    def checkpoint(self, step: int) -> str:
        """Create a unified snapshot.  Returns the snapshot directory.
        Under ``capture="concurrent"`` this still blocks until the image
        commits, but runs the soft-freeze protocol; callers that want the
        overlap use :meth:`begin_concurrent`."""
        return self.snapshot_while_running(step)

    def snapshot_while_running(self, step: int) -> str:
        """Commit a snapshot of `step` with the least pause the job
        observes: the soft-freeze protocol under ``capture="concurrent"``,
        else a stop-the-world dump."""
        if self.options.capture == "concurrent":
            handle = self.begin_concurrent(step)
            handle.wait_speculated()
            return handle.finalize()
        return self.commit_dump(self.freeze(step))

    def freeze(self, step: int) -> HookContext:
        """Phases ①–③: quiesce and capture device + host state.  On return
        the image exists in host memory and the job is frozen; finish with
        :meth:`commit_dump` or :meth:`abort_dump`."""
        if self._provider is None:
            raise RuntimeError("no state provider attached")
        if self._concurrent is not None:
            # settle an in-flight soft-freeze capture first: a second
            # dump must never interleave with an open stripe set
            self._concurrent.finalize()
        self.wait_pending()
        if self._lazy is not None:
            # never freeze a half-restored job: join the stream first
            # (raises if it died; the state must not become an image)
            self.restore_barrier()
        ctx = HookContext("dump", step)
        self._agree_attempt(ctx)
        ctx.roots = self._provider()
        ctx.shardings = self.capture_shardings()
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

    # ----------------------------------------------- concurrent capture
    def begin_concurrent(self, step: int) -> "ConcurrentCapture":
        """Start a soft-freeze capture (PhoenixOS-style validated
        speculation).

        Pin pause: quiesce (device lock: the CUDA streams drain), pin the
        state tree (strong refs + signatures) and start dirty tracking,
        then *resume the job*.  A background thread speculatively captures
        the pinned leaves into an open stripe set while the step loop
        keeps running.  ``handle.finalize()`` takes the validate pause:
        drain again, re-hash dirtied entries against the speculated chunk
        CRCs, re-capture only the mismatches, and commit — the image is
        the state at the *validate* pause, bit-exact with a sync dump
        taken there.  Raises :class:`CheckpointAborted` (job keeps
        running, no image) on lock timeout or an unsafe op in flight.
        """
        if self._provider is None:
            raise RuntimeError("no state provider attached")
        if self.options.capture != "concurrent":
            from repro_torch.api.options import OptionsError
            raise OptionsError(
                "begin_concurrent() requires "
                "CheckpointOptions(capture='concurrent'); "
                f"these options say capture={self.options.capture!r}")
        if self._concurrent is not None:
            self._concurrent.finalize()          # settle the previous one
        self.wait_pending()
        if self._lazy is not None:
            self.restore_barrier()

        ctx = HookContext("dump", step)
        self._agree_attempt(ctx)
        ctx.roots = self._provider()
        self.registry.init_all("dump")
        ctx.stats["t_begin"] = time.perf_counter()
        try:
            with obs_trace.span("dump.pause", step=step, phase="pin"):
                self.registry.run(Hook.PAUSE_DEVICES, ctx)  # pin pause
        except LockTimeout as e:
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
        try:
            tracker = DirtyTracker()
            pinned = self.device_plugin.flatten_keys(ctx.roots)
            tracker.pin(pinned)
            self.device_plugin.begin_tracking(tracker)
            writer = self._make_writer(ctx)
        except Exception:
            self.device_plugin.end_tracking()
            self.device_plugin.lock.unlock()
            self.registry.exit_all("dump", False)
            raise
        handle = ConcurrentCapture(self, ctx, writer, pinned, tracker)
        self.device_plugin.lock.unlock()                   # job resumes
        ctx.stats["pin_pause_s"] = (time.perf_counter()
                                    - ctx.stats["t_begin"])
        ctx.stats["pin_lock_s"] = ctx.stats.pop("lock_s", 0.0)
        self._concurrent = handle
        handle._start()
        return handle

    @property
    def concurrent_capture(self) -> Optional["ConcurrentCapture"]:
        """The in-flight soft-freeze capture handle, if any."""
        return self._concurrent

    def _make_writer(self, ctx: HookContext) -> SnapshotWriter:
        """The writer of `ctx`'s image, with the agreed attempt's barrier
        and, when incremental, the agreed parent's manifest and block
        layout (its ``__meta__``)."""
        opts = self.options
        prev_manifest = prev_meta = None
        parent = getattr(ctx, "parent", None)
        if self.incremental and parent is not None:
            prev_manifest = self.store.manifest(parent)
            reader = self.store.reader(parent, verify=False)
            try:
                prev_meta = reader.meta
            finally:
                reader.close()
        return SnapshotWriter(self.run_dir, ctx.step,
                              host_id=0 if self.ranks is None
                              else self.ranks.rank,
                              compress=opts.compress,
                              prev_manifest=prev_manifest,
                              prev_meta=prev_meta,
                              pack_format=opts.pack_format,
                              chunk_bytes=opts.chunk_mb << 20,
                              stripes=opts.stripes,
                              io_threads=opts.io_threads,
                              barrier=self._barrier(
                                  ctx.step, getattr(ctx, "attempt", None)))

    @staticmethod
    def _writer_stats(ctx: HookContext, writer: SnapshotWriter) -> None:
        ctx.stats["written_bytes"] = float(writer.written_bytes)
        ctx.stats["reused_bytes"] = float(writer.reused_bytes)
        # pipeline stage timings (thread time: compress_s + io_s may
        # exceed write_s when the stages overlap)
        ctx.stats["compress_s"] = writer.compress_s
        ctx.stats["io_s"] = writer.io_s
        ctx.stats["hash_s"] = writer.hash_s
        stripe_bytes = writer.stripe_bytes
        if stripe_bytes and max(stripe_bytes) > 0:
            ctx.stats["stripe_utilization"] = (
                min(stripe_bytes) / max(stripe_bytes))
        ctx.stats["pack_bytes"] = float(writer.pack_bytes)
        if writer.parent_step is not None:
            ctx.stats["parent_step"] = writer.parent_step
        if writer.barrier is not None:
            ctx.stats["barrier_wait_s"] = writer.barrier_wait_s

    def _write(self, ctx: HookContext) -> str:
        t0 = time.perf_counter()
        writer = self._make_writer(ctx)
        try:
            with obs_trace.span("dump.write", step=ctx.step, mode=self.mode):
                writer.write_states(ctx.device_snapshot)
                writer.write_host_state(ctx.host_state)
                t_serialize = time.perf_counter() - t0
                ctx.stats["host_bytes"] = float(
                    len(pack_host_blob(ctx.host_state)))
                path = writer.commit(topology=self._topology(),
                                     stats=ctx.stats,
                                     extra={"warnings": ctx.warnings,
                                            "mode": self.mode,
                                            "capture": "sync",
                                            "incremental": self.incremental})
            # commit() drains the pipeline and fsyncs: only now are the
            # stage timings and the reuse accounting final
            ctx.stats["write_s"] = time.perf_counter() - t0
            ctx.stats["serialize_s"] = t_serialize
            self._writer_stats(ctx, writer)
        except BaseException:
            writer.abort()
            raise
        return self._after_commit(ctx, path)

    def _after_commit(self, ctx: HookContext, path: str) -> str:
        if self.replicator is not None:
            with obs_trace.span("dump.replicate", step=ctx.step):
                t_rep = time.perf_counter()
                self.replicator.push(self.run_dir, ctx.step)
                ctx.stats["replicate_s"] = time.perf_counter() - t_rep
            # the replicator's counters (files/bytes copied vs skipped,
            # chunks/bytes sent vs reused) ride along in the dump stats
            # under a replica_ prefix and mirror into the metrics
            obs_metrics.counter_add("replica.push_count")
            rep_stats = getattr(self.replicator, "stats", None)
            if not isinstance(rep_stats, dict):
                rep_stats = getattr(self.replicator, "last_stats", None)
            if rep_stats is None:
                obs_metrics.counter_add("replica.missing_stats")
                obs_metrics.warn_once(
                    f"replicator-no-stats:{type(self.replicator).__name__}",
                    f"replicator {type(self.replicator).__name__} exposes "
                    f"no last_stats; replication counters for step "
                    f"{ctx.step} (and later dumps) are not recorded")
                rep_stats = {}
            for k, v in rep_stats.items():
                if isinstance(v, (int, float)):
                    ctx.stats[f"replica_{k}"] = v
                    obs_metrics.counter_add(f"replica.{k}", v)
        obs_metrics.counter_add("dump.count")
        obs_metrics.counter_add("dump.bytes_written",
                                ctx.stats.get("written_bytes", 0.0))
        obs_metrics.counter_add("dump.bytes_deduped",
                                ctx.stats.get("reused_bytes", 0.0))
        if "frozen_s" in ctx.stats:
            obs_metrics.observe("dump.frozen_s", ctx.stats["frozen_s"])
        obs_journal.emit("dump", "commit", step=ctx.step,
                         bytes=ctx.stats.get("written_bytes"),
                         frozen_s=ctx.stats.get("frozen_s"))
        if chaos_hooks.INJECTOR is not None:
            # chaos: lost-writeback site (image committed and replicated)
            chaos_hooks.fire("engine.dump_done", run_dir=self.run_dir,
                             step=ctx.step, path=path)
        if self.options.keep and self.is_primary:
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
    def _verify_reader(self, reader, lazy: bool) -> None:
        """Pre-restore image check: eager verifies every entry; lazy
        verifies the critical set (plus the blobs read eagerly), so the job
        resumes before the cold entries are read — every background chunk
        read re-checks its stored CRC, so the guarantee is the same.  The
        verified bytes stay in the reader for the placement that follows
        (`keep`): the restore reads each byte from disk once."""
        if lazy:
            from repro_torch.core.lazy import (critical_pack_names,
                                               split_schedule)
            critical, _ = split_schedule(reader,
                                         self.options.critical_states)
            reader.verify_entries(critical_pack_names(reader, critical),
                                  keep=True)
        else:
            reader.verify_all(keep=True)

    def _open_verified(self, step: int, verify: bool, io_threads: int,
                       lazy: bool):
        reader = self.store.reader(step, verify=verify,
                                   io_threads=io_threads)
        if verify:
            try:
                self._verify_reader(reader, lazy)
            except Exception:
                reader.close()
                raise
        return reader

    def _open_agreed(self, step: Optional[int], verify: bool,
                     io_threads: int, mesh, shardings, lazy: bool):
        """(reader, step) of the newest image (or `step`) that every rank
        verifies, each rank checking only the entries it will read (when
        `lazy`, only the critical ones: the stream re-checks every chunk
        it reads); the ranks take rank 0's list of steps and agree on
        each candidate."""
        group = self.ranks.group
        steps = group.broadcast_object(
            [s for s in self.store.list_steps()
             if s not in self._quarantined] if step is None else [step])
        for s in reversed(steps):
            reader, err = None, None
            try:
                reader = self.store.reader(s, verify=verify,
                                           io_threads=io_threads)
                if verify:
                    leaves = None
                    if lazy:
                        from repro_torch.core.lazy import split_schedule
                        leaves = set(split_schedule(
                            reader, self.options.critical_states)[0])
                    reader.verify_entries(
                        self.device_plugin.needed_pack_entries(
                            reader, mesh, shardings, leaves), keep=True)
            except Exception as e:                 # noqa: BLE001
                err = e
            if group.all_ranks(err is None):
                return reader, s
            if reader is not None:
                reader.close()
            if step is not None:
                raise RuntimeError(f"image step {step} does not verify on "
                                   f"every rank (here: {err!r})")
        raise FileNotFoundError(
            f"no snapshot under {self.run_dir} verifies on every rank")

    def _make_healer(self, step: int):
        """Background-stream heal hook: re-pull the image (and its delta
        chain) from the replica, so a torn background chunk is repaired
        in place instead of killing the stream."""
        rep = self.replicator
        if rep is None or not hasattr(rep, "pull"):
            return None
        if self.ranks is not None and self.ranks.world > 1:
            # a pull rewrites the step directory that the other ranks'
            # streams read: across ranks a torn chunk fails the stream,
            # and the collective join falls back on every rank instead
            return None

        def heal(state: str, path: str, exc: BaseException) -> bool:
            try:
                manifest = self.store.manifest(step)
                steps = sorted(self.store.referenced_steps(manifest)
                               | {step})
            except (OSError, ValueError, KeyError):
                steps = [step]
            healed = False
            for s in steps:
                try:
                    if rep.pull(self.run_dir, s) is not None:
                        healed = True
                except OSError:
                    continue
            return healed

        return heal

    def _abandon_lazy(self) -> None:
        """A newer restore supersedes a still-streaming one: cancel it and
        wait for its thread to stop (the stream's own cleanup closes its
        reader and unpins its step).  Errors are not raised: the
        superseding restore is often the retry."""
        mat, self._lazy = self._lazy, None
        self._lazy_ctx, self._lazy_step = None, None
        if mat is not None and not mat.done:
            mat.cancel()
            mat.wait_done(timeout=60.0)

    def restore(self, step: Optional[int] = None,
                verify: Optional[bool] = None,
                wait: Optional[str] = None, *, mesh=None,
                shardings: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """Unified restore.  Returns {state_name: nested-dict tree}; host
        state is pushed back through the registered CallbackPlugins.
        With ``step=None`` the newest image that verifies (and was not
        quarantined by a failed lazy stream) is used.  `mesh` (default:
        the engine's) and `shardings` ({state: tree}) give the target
        layout; a leaf without a target sharding takes its saved
        descriptor resolved on `mesh`.

        With ``options.restore_mode == "lazy"`` (or ``wait="critical"``)
        the call returns once the critical set is placed; the remaining
        entries stream in the background and :meth:`restore_barrier`
        joins them.  ``wait="all"`` materializes everything first."""
        if verify is None:
            verify = self.options.verify_restore
        if wait not in (None, "critical", "all"):
            raise ValueError(f"wait must be 'critical' or 'all', "
                             f"got {wait!r}")
        # wait="critical" opts one call into the lazy machinery even
        # under eager options
        lazy = self.options.restore_mode == "lazy" or wait == "critical"
        if wait is None:
            wait = "critical" if lazy else "all"
        self.wait_pending()
        self._abandon_lazy()
        t_restore0 = time.perf_counter()
        io_threads = self.options.io_threads or auto_io_threads()
        # the store lock covers the critical phase, so a gc in another
        # thread of this process cannot delete a step or a parent pack
        # under the reads; the background stream pins its step instead
        sp_crit = obs_trace.span("restore.critical",
                                 mode="lazy" if lazy else "eager")
        with sp_crit, self.store.lock:
            if self.ranks is not None:
                try:
                    reader, step = self._open_agreed(
                        step, verify, io_threads,
                        mesh if mesh is not None else self.mesh, shardings,
                        lazy)
                except FileNotFoundError:
                    if self.replicator is None:
                        raise
                    # rank 0 pulls the replica's newest; every rank then
                    # opens the pulled step
                    got = self.ranks.group.broadcast_object(
                        self.replicator.pull_latest(self.run_dir)
                        if self.is_primary else None)
                    if got is None:
                        raise
                    return self._from_replica(got, verify=verify, wait=wait,
                                              mesh=mesh, shardings=shardings)
            elif step is None:
                # newest valid image: fall back past torn/corrupt ones and
                # past steps whose lazy stream died (the quarantine)
                for s in reversed(self.store.list_steps()):
                    if s in self._quarantined:
                        continue
                    try:
                        reader = self._open_verified(s, verify, io_threads,
                                                     lazy)
                    except Exception:
                        continue
                    step = s
                    break
                else:
                    if self.replicator is not None:
                        got = self.replicator.pull_latest(self.run_dir)
                        if got is not None:
                            return self._from_replica(
                                got, verify=verify, wait=wait, mesh=mesh,
                                shardings=shardings)
                    raise FileNotFoundError(
                        f"no restorable snapshot under {self.run_dir}")
            else:
                reader = self._open_verified(step, verify, io_threads, lazy)
            sp_crit.set(step=step)
            ctx = HookContext("restore", step)
            ctx.reader = reader
            ctx.manifest = reader.manifest
            ctx.restore_threads = self.options.restore_threads
            ctx.target_mesh = mesh if mesh is not None else self.mesh
            ctx.target_shardings = shardings or {}
            ctx.lazy = lazy
            if lazy:
                ctx.critical_specs = self.options.critical_states
                self.store.pin(step)
                ctx.lazy_reopen = (
                    lambda s=step: self.store.reader(
                        s, verify=verify, io_threads=io_threads))
                ctx.lazy_heal = self._make_healer(step)
                ctx.lazy_on_done = (lambda s=step: self.store.unpin(s))
            self.registry.init_all("restore")
            materializer = None
            try:
                ctx.host_state = reader.host_state()
                self.registry.run(Hook.RESTORE_EXT_STATE, ctx)
                self.registry.run(Hook.UPDATE_TOPOLOGY_MAP, ctx)
                self.registry.run(Hook.RESUME_DEVICES_LATE, ctx)
                materializer = getattr(ctx, "materializer", None)
            except Exception:
                self.registry.exit_all("restore", False)
                ctx.stats.update(reader.io_stats())
                reader.close()
                if lazy:
                    self.store.unpin(step)
                raise
            ctx.stats.update(reader.io_stats())   # read_s, decompress_s
            if materializer is None:
                reader.close()                    # eager: image fully read
                if lazy:
                    self.store.unpin(step)        # backend without lazy
        self.registry.exit_all("restore", True)
        if lazy:
            ctx.stats["restore_critical_s"] = (time.perf_counter()
                                               - t_restore0)
        ctx.stats["restore_mode"] = "lazy" if lazy else "eager"
        obs_metrics.counter_add("restore.count")
        if lazy:
            obs_metrics.observe("restore.critical_s",
                                ctx.stats["restore_critical_s"])
        obs_journal.emit("restore", "resumed", step=step,
                         mode=ctx.stats["restore_mode"])
        self.last_stats = dict(ctx.stats)
        self.last_stats["topology_mode"] = ctx.topology_map.get("mode")
        self.last_restore_stats = dict(self.last_stats, step=step)
        self._last_restored = ctx.restored
        if materializer is not None:
            self._lazy = materializer
            self._lazy_ctx = ctx
            self._lazy_step = step
            materializer.start()                  # stream the cold tail
            if wait == "all":
                return self.restore_barrier()
        return ctx.restored

    def _from_replica(self, step: int, **kw) -> Dict[str, Any]:
        """Restore `step`, just pulled from the replica."""
        self._quarantined.discard(step)
        out = self.restore(step=step, **kw)
        self.last_stats["restored_from_replica"] = True
        self.last_restore_stats["restored_from_replica"] = True
        return out

    def restore_barrier(self) -> Optional[Dict[str, Any]]:
        """Join the background restore stream: blocks until every lazily
        scheduled entry has landed (and, on CUDA, orders the caller's
        stream after their copies), then returns the complete restored
        tree.  If the stream died, raises
        :class:`repro_torch.core.lazy.LazyRestoreError` and quarantines
        the step, so a retried :meth:`restore` falls back to the previous
        committed image.  A no-op after eager restores.

        Across ranks the join is a collective (every rank restored
        lazily, and joins at the same point of its run): a stream that
        failed on any rank quarantines the step and raises on every rank,
        so no rank goes on into a step's collectives alone."""
        mat = self._lazy
        if mat is None:
            return self._last_restored
        err = None
        try:
            mat.join()
        except BaseException as e:            # noqa: BLE001
            err = e
        failed = err is not None
        if self.ranks is not None:
            failed = not self.ranks.group.all_ranks(not failed)
        if failed:
            step = self._lazy_step
            if step is not None:
                self._quarantined.add(step)
            self._lazy, self._lazy_ctx, self._lazy_step = None, None, None
            if err is not None:
                raise err
            from repro_torch.core.lazy import LazyRestoreError
            raise LazyRestoreError(
                f"the lazy restore stream of step {step} failed on another "
                f"rank; quarantined here too")
        for k in ("background_s", "background_bytes",
                  "background_entries", "healed_entries"):
            self.last_stats[k] = mat.stats.get(k, 0.0)
        for k in ("placed_blocks", "assembled_entries"):
            if k in self._lazy_ctx.stats:     # counted by the stream too
                self.last_stats[k] = self._lazy_ctx.stats[k]
        self.last_stats["restore_background_s"] = mat.stats["background_s"]
        for k in ("restore_background_s", "background_bytes",
                  "background_entries"):
            self.last_restore_stats[k] = self.last_stats[k]
        restored = self._lazy_ctx.restored
        self._last_restored = restored
        self._lazy, self._lazy_ctx, self._lazy_step = None, None, None
        return restored

    @property
    def lazy_pending(self) -> bool:
        """True while a background restore stream is still outstanding."""
        return self._lazy is not None

    def release(self) -> None:
        """Forget every device tensor this engine references: the job's
        state is going away (evicted, crashed or done).  A lazy stream
        still running is cancelled and waited for, an async write in
        flight is joined (its failure is not raised: the job is gone), a
        soft-freeze capture still open is discarded, and the last
        restored tree and the state provider are dropped, so nothing
        here keeps the job's tensors alive."""
        self._abandon_lazy()
        try:
            self.wait_pending()
        except Exception:                       # noqa: BLE001
            pass
        if self._concurrent is not None:
            self._concurrent.abort()
        self._last_restored = None
        self._provider = self._shardings = None

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
                     step: Optional[int] = None,
                     wait: Optional[str] = None, *, mesh=None,
                     shardings: Optional[PyTree] = None) -> PyTree:
        """Restore one state into the caller's tree structure (`shardings`:
        that state's target tree).  The typed reassembly needs every
        template leaf, so a lazy stream is joined first (callers that
        want the overlap use :meth:`restore` with ``wait="critical"`` and
        :meth:`retree` after the barrier)."""
        restored = self.restore(step=step, wait=wait, mesh=mesh,
                                shardings={state: shardings}
                                if shardings is not None else None)
        if self._lazy is not None:
            restored = self.restore_barrier()
        return self.retree(template, restored[state])

    def latest_step(self) -> Optional[int]:
        return self.store.latest_step()


class ConcurrentCapture:
    """Handle for one in-flight soft-freeze capture.

    ``engine.begin_concurrent(step)`` returns it with the speculation
    thread running and the job resumed; the caller steps freely (polling
    :attr:`speculation_done`), then calls :meth:`finalize` for the
    validate/patch pause and the atomic commit, or :meth:`abort` to
    discard everything.  The committed image is bit-exact with the live
    state at the validate pause.
    """

    def __init__(self, engine: SnapshotEngine, ctx: HookContext,
                 writer: SnapshotWriter, pinned: Dict[str, Any],
                 tracker: DirtyTracker):
        self._engine = engine
        self.ctx = ctx
        self._writer = writer
        self._pinned = pinned
        self._tracker = tracker
        self._stop = threading.Event()
        self._spec_done = threading.Event()
        self._spec_err: Optional[BaseException] = None
        self._speculated: set = set()
        self._done = False
        self._obs_ctx = obs_trace.current_context()
        self._shardings = engine.capture_shardings()
        self._thread = threading.Thread(target=self._speculate,
                                        name="repro-spec-capture",
                                        daemon=True)

    def _start(self) -> None:
        self._thread.start()

    # ------------------------------------------------------------- state
    @property
    def step(self) -> int:
        return self.ctx.step

    @property
    def stats(self) -> Dict[str, Any]:
        return self.ctx.stats

    @property
    def speculation_done(self) -> bool:
        """True once the background pass over the pinned tree finished
        (finalize() after this point pays the smallest pause)."""
        return self._spec_done.is_set()

    def wait_speculated(self, timeout: Optional[float] = None) -> bool:
        return self._spec_done.wait(timeout)

    def _sharding_of(self, state: str, path: str):
        return self._shardings.get(state, {}).get(path)

    # -------------------------------------------------------- speculation
    def _speculate(self) -> None:
        backend = self._engine.device_plugin
        t0 = time.perf_counter()
        with obs_trace.context(**self._obs_ctx), \
                obs_trace.span("dump.speculate", step=self.ctx.step) as sp:
            try:
                dev = getattr(self._engine.device_plugin, "device", None)
                if dev is not None and dev.type == "cuda":
                    torch.cuda.set_device(dev)       # an indexed device
                for key, leaf in self._pinned.items():
                    if self._stop.is_set():
                        break
                    if chaos_hooks.INJECTOR is not None:
                        # chaos: mutation-storm site — a handler may mutate
                        # the live leaf mid-speculation (it must note() it)
                        chaos_hooks.fire("engine.speculate", key=key,
                                         leaf=leaf, note=self._tracker.note,
                                         step=self.ctx.step,
                                         run_dir=self._engine.run_dir)
                    state, path = key.split("::", 1)
                    try:
                        entry = backend.capture_entry(
                            leaf, self._sharding_of(state, path))
                    except RuntimeError:
                        # freed or resized under us: the live value is
                        # captured at the validate pause instead
                        self._tracker.note(key)
                        continue
                    self._writer.put_state_entry(state, path, entry)
                    self._speculated.add(key)
                if not self._stop.is_set():
                    # drain the pack pipeline while the job still runs:
                    # finalize()'s own flush is then a no-op
                    self._writer.flush()
            except BaseException as e:
                self._spec_err = e
            finally:
                self.ctx.stats["speculate_s"] = time.perf_counter() - t0
                self.ctx.stats["speculated_entries"] = len(self._speculated)
                sp.set(entries=len(self._speculated))
                self._spec_done.set()

    # ----------------------------------------------------------- finalize
    def finalize(self) -> str:
        """Validate pause: quiesce (the device synchronises), re-hash the
        dirty entries against the speculated chunk CRCs, re-capture only
        actual mismatches from the live tensors, dump host state, commit
        atomically, resume.  Returns the snapshot directory.  Raises
        CheckpointAborted (no image, job running) on lock timeout or an
        unsafe op in flight."""
        if self._done:
            raise RuntimeError("concurrent capture already finalized")
        eng = self._engine
        ctx = self.ctx
        backend = eng.device_plugin
        t_val = time.perf_counter()
        try:
            ctx.roots = eng._provider()
            with obs_trace.span("dump.pause", step=ctx.step,
                                phase="validate"):
                eng.registry.run(Hook.PAUSE_DEVICES, ctx)  # validate pause
        except LockTimeout as e:
            self._cleanup(unlock=False)
            raise CheckpointAborted(str(e)) from e
        except UnsafeOpInFlight as e:
            self._cleanup(unlock=True)
            raise CheckpointAborted(str(e)) from e
        except Exception:
            self._cleanup(unlock=True)
            raise
        try:
            with obs_trace.span("dump.validate", step=ctx.step) as sp_val:
                self._stop.set()
                self._thread.join()
                if self._spec_err is not None:
                    raise self._spec_err
                self._writer.flush()    # speculated chunk records final
                # the post-lock tree is the commit point
                ctx.roots = eng._provider()
                live = backend.flatten_keys(ctx.roots)
                if chaos_hooks.INJECTOR is not None:
                    # chaos: validate site
                    chaos_hooks.fire("engine.validate", step=ctx.step,
                                     run_dir=eng.run_dir)
                dirty = self._tracker.dirty_keys(live)
                sp_val.set(dirty=len(dirty))
            recaptured = recaptured_bytes = 0
            with obs_trace.span("dump.patch", step=ctx.step) as sp_patch:
                for key, leaf in live.items():
                    if (key in dirty or key not in self._speculated
                            or not isinstance(leaf, (torch.Tensor,
                                                     np.ndarray))):
                        state, path = key.split("::", 1)
                        nb = self._writer.reput_state_entry(
                            state, path, backend.capture_entry(
                                leaf, self._sharding_of(state, path)))
                        if nb:
                            recaptured += 1
                            recaptured_bytes += nb
                for key in self._pinned:
                    if key not in live:  # structural drift: entry gone
                        state, path = key.split("::", 1)
                        self._writer.drop_state_entry(state, path)
                sp_patch.set(recaptured=recaptured)
            eng.registry.run(Hook.DUMP_EXT_STATE, ctx)
            self._writer.write_host_state(ctx.host_state)
            ctx.stats["host_bytes"] = float(
                len(pack_host_blob(ctx.host_state)))
            ctx.stats["dirty_entries"] = len(dirty)
            ctx.stats["recaptured_entries"] = recaptured
            ctx.stats["recaptured_bytes"] = float(recaptured_bytes)
            ctx.stats["superseded_bytes"] = float(
                self._writer.superseded_bytes)
            ctx.stats["validate_pause_s"] = time.perf_counter() - t_val
            ctx.stats["frozen_s"] = (ctx.stats["pin_pause_s"]
                                     + ctx.stats["validate_pause_s"])
            path = self._writer.commit(
                topology=eng._topology(), stats=ctx.stats,
                extra={"warnings": ctx.warnings,
                       "mode": eng.mode,
                       "incremental": eng.incremental,
                       "capture": "concurrent",
                       "capture_stats": {
                           k: ctx.stats[k] for k in (
                               "pin_pause_s", "validate_pause_s",
                               "frozen_s", "speculate_s",
                               "speculated_entries", "dirty_entries",
                               "recaptured_entries", "recaptured_bytes",
                               "superseded_bytes")
                           if k in ctx.stats}})
            ctx.stats["write_s"] = ctx.stats.get("speculate_s", 0.0)
            eng._writer_stats(ctx, self._writer)
        except Exception:
            self._cleanup(unlock=True)
            raise
        # the fsync/rename is part of the pause the caller observed
        ctx.stats["validate_pause_s"] = time.perf_counter() - t_val
        ctx.stats["frozen_s"] = (ctx.stats["pin_pause_s"]
                                 + ctx.stats["validate_pause_s"])
        ctx.stats["locked_total_s"] = ctx.stats["frozen_s"]
        eng.device_plugin.lock.unlock()                    # resume
        backend.end_tracking()
        # the speculation thread is joined and every copy it made has
        # completed: the pinned (possibly replaced) tensors may go
        self._tracker.reset()
        self._pinned = {}
        eng.registry.exit_all("dump", True)
        t_begin = ctx.stats.pop("t_begin", t_val)
        ctx.stats["total_s"] = time.perf_counter() - t_begin
        eng._concurrent = None
        self._done = True
        eng._after_commit(ctx, path)
        eng.last_stats = dict(ctx.stats)
        eng._write_error = None
        eng.last_commit_step = ctx.step
        return path

    # -------------------------------------------------------------- abort
    def abort(self) -> None:
        """Discard the capture: stop speculation, delete the open stripe
        set, resume tracking-free.  The job never observes it."""
        if self._done:
            return
        self._cleanup(unlock=False)

    def _cleanup(self, unlock: bool) -> None:
        eng = self._engine
        self._stop.set()
        self._thread.join(timeout=60.0)
        self._writer.abort()
        eng.device_plugin.end_tracking()
        if not self._thread.is_alive():
            # a copy may still read the pinned tensors while it runs
            self._tracker.reset()
            self._pinned = {}
        if unlock:
            eng.device_plugin.lock.unlock()
        eng.registry.exit_all("dump", False)
        eng._concurrent = None
        self._done = True
