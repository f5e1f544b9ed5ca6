"""Dirty-set protocol for concurrent (soft-freeze) capture.

Port of the reference's ``core/dirty.py``.  The pin pause records, per
entry key ("state::path"), a strong reference to the live leaf plus its
signature.  While the engine speculates entries to disk the step loop
keeps mutating state; at the validate pause the tracker answers one
question: *which entries might differ from what was speculated?*  A
pinned entry is dirty if any of these holds:

  * it was noted — stream retirements and chaos faults call :meth:`note`
    for entries they mutated (a numpy array mutates without a signal);
  * identity drift — the leaf at a pinned path is another object
    (a functional update, a rebind);
  * structural drift — the pinned path disappeared from the live tree;
  * version drift — a tensor whose ``_version`` or storage address
    differs from the pin's.  The reference needs no such signal because
    JAX hands back new arrays; torch code updates tensors in place
    (AdamW's moments, the KV cache written by index, the SSM conv state),
    and every in-place op, through a view too (views share their base's
    version counter), bumps ``_version``.

The dirty set is an over-approximation: a dirty entry is merely re-hashed
against the speculated chunk CRCs, and only actual mismatches are
re-captured.  Missing a mutation would commit torn state, so every
"maybe" lands in the set — a tensor without a version counter (an
inference-mode tensor) is always dirty.
"""
from __future__ import annotations

import threading
from typing import Dict, Set, Tuple

import torch

_MISSING = object()
_UNTRACKED = object()      # signature of a tensor with no version counter


def signature(leaf: object) -> Tuple:
    """What must stay the same for `leaf` to count as unchanged."""
    if isinstance(leaf, torch.Tensor):
        try:
            version = leaf._version
        except RuntimeError:          # inference tensors track no version
            return (id(leaf), _UNTRACKED)
        return (id(leaf), version, leaf.untyped_storage().data_ptr())
    return (id(leaf),)


class DirtyTracker:
    """Tracks which pinned entries may have been mutated mid-capture."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pinned: Dict[str, object] = {}      # key -> leaf (strong ref)
        self._signatures: Dict[str, Tuple] = {}   # key -> signature at pin
        self._noted: Set[str] = set()
        self._active = False

    # -------------------------------------------------------------- pin
    def pin(self, leaves: Dict[str, object]) -> None:
        """Record the capture-time tree: key -> live leaf.  The strong
        refs keep replaced tensors (and their device memory) alive until
        the speculation has read them."""
        with self._lock:
            self._pinned = dict(leaves)
            self._signatures = {k: signature(v) for k, v in leaves.items()}
            self._noted = set()
            self._active = True

    @property
    def active(self) -> bool:
        return self._active

    def pinned(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._pinned)

    # ------------------------------------------------------------- notes
    def note(self, key: str) -> None:
        """An entry was mutated in place (stream retirement, chaos)."""
        with self._lock:
            if self._active:
                self._noted.add(key)

    def note_many(self, keys) -> None:
        with self._lock:
            if self._active:
                self._noted.update(keys)

    # ---------------------------------------------------------- validate
    def dirty_keys(self, live_leaves: Dict[str, object]) -> Set[str]:
        """Pinned entries that may differ from the speculated bytes:
        noted mutations, identity or version drift, and deletions."""
        with self._lock:
            dirty = set(self._noted)
            for key, sig in self._signatures.items():
                live = live_leaves.get(key, _MISSING)
                if (live is _MISSING or _UNTRACKED in sig
                        or signature(live) != sig):
                    dirty.add(key)
            return dirty

    def reset(self) -> None:
        """Drop the pins.  Call only once nothing reads the pinned
        tensors any more (the speculation's copies have completed)."""
        with self._lock:
            self._pinned = {}
            self._signatures = {}
            self._noted = set()
            self._active = False
