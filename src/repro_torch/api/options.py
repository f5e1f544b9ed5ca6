"""CheckpointOptions — the declarative `criu_set_*` analogue.

Port of the reference's ``api/options.py``: one frozen dataclass carrying
every knob the engine understands, validated at construction.  Fields the
reference has but this port does not implement yet keep their names and
defaults, and a non-default value raises :class:`OptionsError` naming
what is missing, rather than being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

_MODES = ("sync", "async")
_RESTORE_MODES = ("eager", "lazy")
_CAPTURES = ("sync", "concurrent")


class OptionsError(ValueError):
    """An invalid (or not yet ported) CheckpointOptions combination."""


@dataclasses.dataclass(frozen=True)
class CheckpointOptions:
    """Declarative checkpoint configuration.

    mode             "sync" (paper-faithful: frozen through dump+write) or
                     "async" (resume after device capture, write in the
                     background — CheckFreq-style).
    incremental      delta images: entries (and, in pack v2, chunks)
                     whose content CRC matches the newest earlier image
                     are not rewritten; the manifest points at that
                     image's pack (``parent``, ``reused_bytes``).
    compress         per-chunk zlib compression in the pack files.
    keep             GC: retain the newest N images (0 = keep all).
    lock_timeout_s   device-lock deadline; on timeout the dump aborts and
                     the job keeps running (paper §3.1.1).
    restore_threads  parallel pack-entry loads on restore (> 1 enables).
    verify_restore   CRC-verify images before restoring from them.
    restore_mode     "eager" (the whole image is placed before restore()
                     returns) or "lazy" (resume-before-read: restore()
                     returns once the critical set is placed; the rest
                     streams in the background, joined by
                     restore_barrier()).
    critical_states  the lazy critical set: specs "state" or
                     "state/path-prefix" (e.g. "train_state/params");
                     None = the first state of the image's restore order.
    pack_format      2: chunked/striped packs (the only format written;
                     v1 images are still read).
    io_threads       data-plane worker threads; 0 = auto-size.
    chunk_mb         pack-v2 chunk size in MiB.
    stripes          pack files per host, one appender thread each.
    capture          "sync" or "concurrent" (soft-freeze: a brief pin
                     pause, speculation to disk while the job runs, then
                     a validate pause that re-captures only the entries
                     that changed).  Requires pack_format=2,
                     incremental=True and mode="sync".

    Not ported yet, and rejected unless left at their defaults:
    replicate_to, transfer_policy, pack_format=1.
    """

    mode: str = "sync"
    incremental: bool = False
    compress: bool = False
    keep: int = 0
    lock_timeout_s: float = 10.0
    restore_threads: int = 0
    replicate_to: Optional[str] = None
    transfer_policy: Optional[object] = None
    verify_restore: bool = True
    restore_mode: str = "eager"
    critical_states: Optional[Tuple[str, ...]] = None
    pack_format: int = 2
    io_threads: int = 0
    chunk_mb: int = 4
    stripes: int = 2
    capture: str = "sync"

    def __post_init__(self):
        if isinstance(self.critical_states, (list, set)):
            # frozen dataclass: normalize to a hashable tuple in place
            object.__setattr__(self, "critical_states",
                               tuple(self.critical_states))
        self.validate()

    def validate(self) -> None:
        if self.mode not in _MODES:
            raise OptionsError(f"mode must be one of {_MODES}, "
                               f"got {self.mode!r}")
        if not isinstance(self.keep, int) or self.keep < 0:
            raise OptionsError(f"keep must be an int >= 0, got {self.keep!r}")
        if self.lock_timeout_s <= 0:
            raise OptionsError("lock_timeout_s must be > 0, "
                               f"got {self.lock_timeout_s!r}")
        for name in ("restore_threads", "io_threads"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise OptionsError(f"{name} must be an int >= 0, got {v!r}")
        if self.restore_mode not in _RESTORE_MODES:
            raise OptionsError(f"restore_mode must be one of "
                               f"{_RESTORE_MODES}, got {self.restore_mode!r}")
        if self.critical_states is not None:
            if (not isinstance(self.critical_states, tuple)
                    or not all(isinstance(s, str) and s
                               for s in self.critical_states)):
                raise OptionsError(
                    "critical_states must be a tuple of non-empty "
                    "'state' or 'state/path-prefix' specs, "
                    f"got {self.critical_states!r}")
        if not isinstance(self.chunk_mb, int) or self.chunk_mb < 1:
            raise OptionsError("chunk_mb must be an int >= 1, "
                               f"got {self.chunk_mb!r}")
        if not isinstance(self.stripes, int) or not 1 <= self.stripes <= 64:
            raise OptionsError("stripes must be an int in [1, 64], "
                               f"got {self.stripes!r}")
        if self.capture not in _CAPTURES:
            raise OptionsError(f"capture must be one of {_CAPTURES}, "
                               f"got {self.capture!r}")
        if self.capture == "concurrent":
            if self.pack_format != 2:
                raise OptionsError(
                    "capture='concurrent' requires pack_format=2: "
                    "speculation is validated against pack v2's "
                    "per-chunk raw_crc32 content hashes")
            if not self.incremental:
                raise OptionsError(
                    "capture='concurrent' requires incremental=True: "
                    "re-capturing invalidated entries reuses the "
                    "incremental chunk-dedup path to patch the open "
                    "stripe set")
            if self.mode == "async":
                raise OptionsError(
                    "capture='concurrent' is incompatible with "
                    "mode='async': the speculative capture already "
                    "overlaps the step loop, and the final validate "
                    "pause must observe the committed bytes")
        unported = []
        if self.replicate_to is not None:
            unported.append("replicate_to (peer replication)")
        if self.transfer_policy is not None:
            unported.append("transfer_policy (CAS transfer / migration)")
        if self.pack_format != 2:
            unported.append(f"pack_format={self.pack_format!r} (only the "
                            f"v2 writer; v1 images are read)")
        if unported:
            raise OptionsError(
                "not ported to repro_torch yet: " + "; ".join(unported))

    def replace(self, **changes) -> "CheckpointOptions":
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)
