"""CheckpointOptions — the declarative `criu_set_*` analogue.

Port of the reference's ``api/options.py``: one frozen dataclass carrying
every knob the engine understands, validated at construction.  Fields the
reference has but this port does not implement yet keep their names and
defaults, and a non-default value raises :class:`OptionsError` naming
what is missing, rather than being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

_MODES = ("sync", "async")


class OptionsError(ValueError):
    """An invalid (or not yet ported) CheckpointOptions combination."""


@dataclasses.dataclass(frozen=True)
class CheckpointOptions:
    """Declarative checkpoint configuration.

    mode             "sync" (paper-faithful: frozen through dump+write) or
                     "async" (resume after device capture, write in the
                     background — CheckFreq-style).
    compress         per-chunk zlib compression in the pack files.
    keep             GC: retain the newest N images (0 = keep all).
    lock_timeout_s   device-lock deadline; on timeout the dump aborts and
                     the job keeps running (paper §3.1.1).
    restore_threads  parallel pack-entry loads on restore (> 1 enables).
    verify_restore   CRC-verify images before restoring from them.
    pack_format      2: chunked/striped packs (the only format written;
                     v1 images are still read).
    io_threads       data-plane worker threads; 0 = auto-size.
    chunk_mb         pack-v2 chunk size in MiB.
    stripes          pack files per host, one appender thread each.

    Not ported yet, and rejected unless left at their defaults:
    incremental=True, capture="concurrent", restore_mode="lazy",
    replicate_to, transfer_policy.
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
    pack_format: int = 2
    io_threads: int = 0
    chunk_mb: int = 4
    stripes: int = 2
    capture: str = "sync"

    def __post_init__(self):
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
        if not isinstance(self.chunk_mb, int) or self.chunk_mb < 1:
            raise OptionsError("chunk_mb must be an int >= 1, "
                               f"got {self.chunk_mb!r}")
        if not isinstance(self.stripes, int) or not 1 <= self.stripes <= 64:
            raise OptionsError("stripes must be an int in [1, 64], "
                               f"got {self.stripes!r}")
        unported = []
        if self.incremental:
            unported.append("incremental=True (delta images)")
        if self.capture != "sync":
            unported.append(f"capture={self.capture!r} (only 'sync'; "
                             f"concurrent soft-freeze capture)")
        if self.restore_mode != "eager":
            unported.append(f"restore_mode={self.restore_mode!r} (only "
                            f"'eager'; lazy resume-before-read restore)")
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
