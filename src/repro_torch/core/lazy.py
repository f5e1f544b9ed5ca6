"""Priority-ordered lazy restore — the "resume-before-read" data plane.

Port of the reference's ``core/lazy.py``.  The image's ``restore_order``
hint (recorded at dump time from the order states were registered)
splits into a *critical set* that is placed before ``restore()`` returns
and a *background schedule* that a :class:`LazyMaterializer` streams into
the restored tree while the job is already running.

On a CUDA device the materializer's thread selects the device and copies
each entry from pinned host memory to the card on its own
``torch.cuda.Stream``, recording one event per entry.  A consumer gets a
background tensor only through :meth:`LazyMaterializer.wait_entry` or
:meth:`LazyMaterializer.join`, which make the caller's current stream
wait on that entry's event (and record the tensor's use on it for the
caching allocator) before handing it out.

Corruption guarantees are unchanged: every chunk read re-checks its stored
CRC, so a torn background chunk raises inside the stream; the failure
surfaces at :meth:`LazyMaterializer.join` (the engine's
``restore_barrier()``), the image is quarantined, and a retry falls back
to an eager restore of the previous committed step.  With a replicator,
the engine passes a heal hook: the stream re-pulls the image from the
replica, reopens its reader and retries the entry once.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.obs import journal as obs_journal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

Spec = str                    # "state" or "state/path-prefix"
WorkItem = Tuple[str, str]    # (state, path)


class LazyRestoreError(RuntimeError):
    """The background materializer died; the restored tree is incomplete."""


def match_critical(state: str, path: str, specs: Sequence[Spec]) -> bool:
    """Does entry (state, path) belong to the critical set?  A spec is
    ``"state"`` (every entry of that state) or ``"state/path-prefix"``
    (that subtree only, matched path component by path component)."""
    for spec in specs:
        if "/" not in spec:
            if state == spec:
                return True
            continue
        s, prefix = spec.split("/", 1)
        if state == s and (path == prefix
                           or path.startswith(prefix + "/")):
            return True
    return False


def split_schedule(reader, critical_specs: Optional[Sequence[Spec]]
                   ) -> Tuple[List[WorkItem], List[WorkItem]]:
    """Partition the image's priority-ordered entry schedule into
    (critical, background) work lists.  With no explicit specs the
    critical set is the first state in the image's restore order."""
    if critical_specs:
        specs: Tuple[Spec, ...] = tuple(critical_specs)
    else:
        first = None
        for name in reader.restore_order():
            if name != "__host__":
                first = name.split("::", 1)[0]
                break
        specs = (first,) if first else ()
    critical: List[WorkItem] = []
    background: List[WorkItem] = []
    for state, path in reader.entry_schedule():
        if match_critical(state, path, specs):
            critical.append((state, path))
        else:
            background.append((state, path))
    return critical, background


def covers(specs: Optional[Sequence[Spec]], state: str, prefix: str,
           template: Any) -> bool:
    """Whether critical `specs` place every leaf of `template`, the
    subtree at `state`/`prefix`, before a lazy restore returns.  No specs
    means the image's first state, which covers it for the server's and
    the trainer's images: each holds one state."""
    if not specs:
        return True
    return all(match_critical(state, f"{prefix}/{path}", specs)
               for path in flatten_with_paths(template))


def critical_pack_names(reader, critical: Sequence[WorkItem]) -> List[str]:
    """Pack-entry names the lazy pre-verify must cover before the job
    resumes: the critical leaves plus the blobs the restore reads eagerly
    (``__meta__``, ``__host__``)."""
    names: List[str] = []
    for state, path in critical:
        names.extend(reader.pack_entries(state, path))
    for blob in ("__meta__", "__host__"):
        if blob in reader.manifest.get("locations", {}):
            names.append(blob)
    return names


def insert_leaf(root: Dict[str, Any], state: str, path: str,
                leaf: Any) -> None:
    """Place one restored leaf into the nested {state: tree} dict."""
    node = root.setdefault(state, {})
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


class LazyMaterializer:
    """Streams the background schedule into the restored tree.

    One daemon thread walks `work` in priority order, loading each entry
    through the snapshot reader (chunk CRCs verified on read) and placing
    the rebuilt leaf via ``place_fn(reader, state, path)``.  With a CUDA
    `device`, placement runs on the thread's own stream and each entry's
    copy is fenced by an event (see the module docstring).  Consumers
    block per entry (:meth:`wait_entry`) or on the whole stream
    (:meth:`join`, the engine's ``restore_barrier()``).

    `heal(state, path, exc)` — optional: invoked once per failed entry;
    True means the image was repaired and the entry is retried through a
    fresh reader from `reopen()`.
    """

    def __init__(self, reader, work: Sequence[WorkItem],
                 place_fn: Callable[[Any, str, str], Any],
                 restored: Dict[str, Any], *,
                 device: Optional[torch.device] = None,
                 reopen: Optional[Callable[[], Any]] = None,
                 heal: Optional[Callable[[str, str, BaseException],
                                         bool]] = None,
                 on_done: Optional[Callable[[], None]] = None):
        self._reader = reader
        self._work = list(work)
        self._place = place_fn
        self._restored = restored
        # an indexed CUDA device (resolve_device) or None
        self._cuda = device if (device is not None
                                and device.type == "cuda") else None
        self._reopen = reopen
        self._heal = heal
        self._on_done = on_done
        self._lock = threading.Lock()
        self._events = {item: threading.Event() for item in self._work}
        # CUDA: item -> (copy-done event, placed leaf), until handed out
        self._fences: Dict[WorkItem, Tuple[Any, Any]] = {}
        self._done = threading.Event()
        self._cancelled = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.failed_item: Optional[WorkItem] = None
        self.stats: Dict[str, float] = {
            "background_entries": 0.0, "background_bytes": 0.0,
            "background_s": 0.0, "healed_entries": 0.0}

    # ------------------------------------------------------------ control
    def start(self) -> "LazyMaterializer":
        self._obs_ctx = obs_trace.current_context()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="repro-lazy-materializer")
        self._thread.start()
        return self

    def cancel(self) -> None:
        """Abandon the stream (a newer restore supersedes this one).  The
        current entry finishes; nothing further is placed."""
        self._cancelled = True

    # -------------------------------------------------------------- wait
    def _hand_out(self, items) -> None:
        """Make the caller's current stream wait on each item's copy and
        record the leaf's use there; the leaf is safe to read after."""
        if self._cuda is None:
            return
        consumer = torch.cuda.current_stream(self._cuda)
        with self._lock:
            fences = [self._fences.pop(it) for it in items
                      if it in self._fences]
        for ev, leaf in fences:
            consumer.wait_event(ev)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                leaf.record_stream(consumer)

    def wait_entry(self, state: str, path: str,
                   timeout: Optional[float] = None) -> None:
        """Block until one background leaf has landed (first-touch wait)."""
        ev = self._events.get((state, path))
        if ev is None:                     # not background: already placed
            return
        if not ev.wait(timeout):
            raise TimeoutError(f"lazy restore of {state}/{path} did not "
                               f"land within {timeout}s")
        self._raise_if_failed()
        self._hand_out([(state, path)])

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        """Wait for the stream to stop (success, failure, or cancel)
        without raising — the abandon path of a superseding restore."""
        return self._done.wait(timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until the whole background stream has landed; raises
        :class:`LazyRestoreError` if it died (torn chunk, lost pack)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"lazy restore stream still running after "
                               f"{timeout}s")
        self._raise_if_failed()
        if self._cancelled:
            raise LazyRestoreError(
                "lazy restore stream was cancelled before completing")
        self._hand_out(self._work)

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            state, path = self.failed_item or ("?", "?")
            raise LazyRestoreError(
                f"background materializer failed at {state}/{path}: "
                f"{self.error!r}") from self.error

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ok(self) -> bool:
        return self._done.is_set() and self.error is None \
            and not self._cancelled

    # -------------------------------------------------------------- loop
    def _load_one(self, state: str, path: str) -> Any:
        return self._place(self._reader, state, path)

    def _stream(self, side) -> None:
        for item in self._work:
            if self._cancelled:
                break
            state, path = item
            tr = obs_trace.TRACER
            if tr is not None and tr.detail:
                with tr.begin("restore.entry",
                              {"state": state, "path": path}):
                    ok = self._stream_one(item, state, path, side)
            else:
                ok = self._stream_one(item, state, path, side)
            if not ok:
                break

    def _placed(self, state: str, path: str, side) -> Any:
        """Load + place one entry; on CUDA the copy is enqueued on `side`
        and fenced by an event recorded right after it."""
        if side is None:
            return self._load_one(state, path), None
        with torch.cuda.stream(side):
            leaf = self._load_one(state, path)
            ev = torch.cuda.Event()
            ev.record(side)
        return leaf, ev

    def _stream_one(self, item: WorkItem, state: str, path: str,
                    side) -> bool:
        try:
            leaf, ev = self._placed(state, path, side)
        except BaseException as e:
            if not self._try_heal(state, path, e):
                self.error = e
                self.failed_item = item
                return False
            try:
                leaf, ev = self._placed(state, path, side)
            except BaseException as e2:
                self.error = e2
                self.failed_item = item
                return False
        with self._lock:
            insert_leaf(self._restored, state, path, leaf)
            if ev is not None:
                self._fences[item] = (ev, leaf)
        self.stats["background_bytes"] += \
            self._reader.entry_nbytes(state, path)
        self.stats["background_entries"] += 1
        self._events[item].set()
        return True

    def _run(self) -> None:
        t0 = time.perf_counter()
        side = None
        try:
            if self._cuda is not None:
                torch.cuda.set_device(self._cuda)
                side = torch.cuda.Stream(self._cuda)
            with obs_trace.context(**getattr(self, "_obs_ctx", {})), \
                    obs_trace.span("restore.background",
                                   entries=len(self._work)) as sp:
                self._stream(side)
                sp.set(placed=self.stats["background_entries"],
                       healed=self.stats["healed_entries"])
        except BaseException as e:         # stream setup failed
            if self.error is None:
                self.error = e
        finally:
            try:
                if side is not None:
                    # every copy has landed before the stream reports
                    # done, so an abandoned tree may be dropped at once
                    side.synchronize()
                self.stats["background_s"] = time.perf_counter() - t0
                self._reader.close()
                if self._on_done is not None:
                    self._on_done()
            finally:
                for ev in self._events.values():
                    ev.set()               # unblock every first-touch wait
                self._done.set()

    # ------------------------------------------------------------- heal
    def _try_heal(self, state: str, path: str, exc: BaseException) -> bool:
        if self._heal is None or self._cancelled:
            return False
        try:
            healed = self._heal(state, path, exc)
        except Exception:
            return False
        if not healed:
            return False
        # the image under the reader changed on disk: reopen before retry
        if self._reopen is not None:
            try:
                fresh = self._reopen()
            except Exception:
                return False
            old, self._reader = self._reader, fresh
            old.close()
        self.stats["healed_entries"] += 1
        obs_metrics.counter_add("restore.heal_events")
        obs_journal.emit("restore", "heal", state=state, path=path,
                         error=repr(exc))
        return True


def resume_with_schedule(ctx, place_fn: Callable[[Any, str, str], Any],
                         threads: int,
                         device: Optional[torch.device] = None
                         ) -> LazyMaterializer:
    """The lazy half of RESUME_DEVICES_LATE: place the critical set now
    (parallel entry loads, priority order), hand everything else to a
    materializer the engine starts once the job is unlocked.
    `place_fn(reader, state, path)` loads one leaf through the reader and
    rebuilds it for the backend (onto `device`, if any)."""
    reader = ctx.reader
    critical, background = split_schedule(
        reader, getattr(ctx, "critical_specs", None))
    t0 = time.perf_counter()
    with obs_trace.span("restore.critical_place",
                        entries=len(critical), threads=threads):
        if threads > 1 and len(critical) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=threads) as ex:
                leaves = list(ex.map(lambda it: place_fn(reader, *it),
                                     critical))
        else:
            leaves = [place_fn(reader, *it) for it in critical]
        for (state, path), leaf in zip(critical, leaves):
            insert_leaf(ctx.restored, state, path, leaf)
    ctx.stats["place_critical_s"] = time.perf_counter() - t0
    ctx.stats["critical_entries"] = float(len(critical))
    ctx.stats["background_entries_planned"] = float(len(background))
    ctx.stats["critical_bytes"] = float(
        sum(reader.entry_nbytes(s, p) for s, p in critical))
    ctx.materializer = LazyMaterializer(
        reader, background, place_fn, ctx.restored, device=device,
        reopen=getattr(ctx, "lazy_reopen", None),
        heal=getattr(ctx, "lazy_heal", None),
        on_done=getattr(ctx, "lazy_on_done", None))
    return ctx.materializer
