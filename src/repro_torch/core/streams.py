"""Injectable fake streams — the CRAC-style explicit capture boundary.

CUDA work is asynchronous: a step can return while kernels and copies are
still in flight on a stream.  On the card `freeze()` drains this through
``torch.cuda.synchronize``; for work the runtime cannot see (and for tests
and chaos runs) the boundary must be explicit and testable.

``StreamSet`` models per-stream queues of ``StreamOp``s the workload (or a
test, or the chaos plane) enqueues to simulate async dispatch, host-to-
device prefetch, buffer donation, and cross-host collectives.  The engine
drains every stream at each capture pause:

  * quiescable ops are applied (their side effects land, like a real
    ``block_until_ready``) and retired;
  * a non-quiescable op — one that cannot be completed at a safe point,
    e.g. a collective whose peers are wedged — makes the pause fail fast
    with :class:`UnsafeOpInFlight` instead of snapshotting torn state.

Retirements are reported through ``on_retire`` so a dirty tracker can note
which entries an op mutated between the pin and validate pauses.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class UnsafeOpInFlight(RuntimeError):
    """A capture pause found async work that cannot be quiesced."""

    def __init__(self, ops: Sequence["StreamOp"]):
        self.ops = tuple(ops)
        names = ", ".join(f"{o.stream or '?'}:{o.kind}" for o in self.ops)
        super().__init__(
            f"unsafe op in flight at capture boundary: {names} "
            f"({len(self.ops)} op(s) could not be quiesced — refusing "
            f"to snapshot torn state)")


class StreamOp:
    """One in-flight async operation.

    kind        free-form tag ("dispatch", "prefetch", "donate",
                "collective", ...) — used in diagnostics.
    targets     entry keys ("state::path") this op mutates when it
                retires; fed to the dirty tracker.
    apply       optional side effect run at retirement (mutates live
                state the way a completing transfer would).
    quiescable  False marks an op that cannot complete at a capture
                boundary; draining it raises UnsafeOpInFlight.
    """

    __slots__ = ("kind", "targets", "apply", "quiescable", "stream")

    def __init__(self, kind: str, targets: Sequence[str] = (),
                 apply: Optional[Callable[[], None]] = None,
                 quiescable: bool = True):
        self.kind = kind
        self.targets = tuple(targets)
        self.apply = apply
        self.quiescable = quiescable
        self.stream: Optional[str] = None  # stamped on enqueue


class FakeStream:
    """An ordered queue of StreamOps, retired FIFO like a device stream."""

    def __init__(self, name: str):
        self.name = name
        self._ops: List[StreamOp] = []

    def enqueue(self, op: StreamOp) -> StreamOp:
        op.stream = self.name
        self._ops.append(op)
        return op

    def pending(self) -> Tuple[StreamOp, ...]:
        return tuple(self._ops)

    def retire_ready(self, on_retire) -> List[StreamOp]:
        """Retire quiescable ops in order; stop at the first stuck one
        (a device stream cannot reorder past a blocked op)."""
        stuck: List[StreamOp] = []
        while self._ops:
            op = self._ops[0]
            if not op.quiescable:
                stuck.append(op)
                break
            self._ops.pop(0)
            if op.apply is not None:
                op.apply()
            if on_retire is not None:
                on_retire(op)
        return stuck


class StreamSet:
    """The backend's view of every injectable stream.

    Thread-safe: the step loop enqueues while the engine's capture
    thread drains.  ``on_retire`` (set by the backend when tracking
    starts) receives each retired op so its targets land in the dirty
    set.
    """

    def __init__(self):
        self._streams: Dict[str, FakeStream] = {}
        self._lock = threading.Lock()
        self.on_retire: Optional[Callable[[StreamOp], None]] = None

    def stream(self, name: str) -> FakeStream:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = self._streams[name] = FakeStream(name)
            return s

    def enqueue(self, name: str, op: StreamOp) -> StreamOp:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = self._streams[name] = FakeStream(name)
            return s.enqueue(op)

    def pending_ops(self) -> List[StreamOp]:
        with self._lock:
            return [op for s in self._streams.values()
                    for op in s.pending()]

    def drain(self) -> List[StreamOp]:
        """Retire everything retirable; return the stuck ops (empty =
        fully quiesced).  Caller decides whether stuck is fatal."""
        with self._lock:
            stuck: List[StreamOp] = []
            for s in self._streams.values():
                stuck.extend(s.retire_ready(self.on_retire))
            return stuck

    def clear_stuck(self) -> int:
        """Drop non-quiescable ops (test/chaos cleanup after an
        aborted dump); returns how many were dropped."""
        dropped = 0
        with self._lock:
            for s in self._streams.values():
                kept = [op for op in s._ops if op.quiescable]
                dropped += len(s._ops) - len(kept)
                s._ops = kept
        return dropped
