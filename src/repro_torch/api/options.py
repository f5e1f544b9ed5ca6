"""CheckpointOptions — the declarative `criu_set_*` analogue.

Port of the reference's ``api/options.py``: one frozen dataclass carrying
every knob the engine understands, validated at construction, and the
:class:`TransferPolicy` that says how snapshot bytes reach a peer.

Not ported yet (they wait for the CLI): the deprecated
``transfer=``/``transfer_workers=`` keyword spellings of the policy and the
``REPRO_CKPT_*`` environment round trip (``from_env``/``to_env``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

_MODES = ("sync", "async")
_TRANSFERS = ("copy", "delta")
_RESTORE_MODES = ("eager", "lazy")
_CAPTURES = ("sync", "concurrent")


class OptionsError(ValueError):
    """An invalid CheckpointOptions combination."""


@dataclasses.dataclass(frozen=True)
class TransferPolicy:
    """How snapshot bytes reach a peer.

    mode                "copy" (whole files, skipped when size+mtime
                        match) or "delta" (content-addressed: only chunks
                        missing from the peer's CAS ship; the cross-host
                        migration path).
    workers             parallel chunk-ship lanes for delta transfer;
                        0 = auto-size like io_threads.
    precopy_rounds      iterative pre-copy live migration: the most delta
                        rounds pushed while the job keeps running before
                        the residual freeze.  0 disables pre-copy
                        (stop-and-copy); > 0 requires mode="delta" (rounds
                        are diffed by pack v2's per-chunk raw-CRC content
                        hashes in the destination CAS).
    max_blackout_ms     blackout budget: the convergence controller
                        freezes once the predicted residual push fits it
                        (or a cap trips and it falls back to
                        stop-and-copy).  None = freeze once a round ships
                        zero new bytes or stops shrinking.
    residual_bytes_cap  fallback trip-wire: cumulative pre-copy bytes
                        above this cap give up on convergence.  None = no
                        byte cap (the round cap still applies).
    """

    mode: str = "copy"
    workers: int = 0
    precopy_rounds: int = 0
    max_blackout_ms: Optional[float] = None
    residual_bytes_cap: Optional[int] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.mode not in _TRANSFERS:
            raise OptionsError(f"TransferPolicy.mode must be one of "
                               f"{_TRANSFERS}, got {self.mode!r}")
        if not isinstance(self.workers, int) or self.workers < 0:
            raise OptionsError("TransferPolicy.workers must be an int "
                               f">= 0, got {self.workers!r}")
        if not isinstance(self.precopy_rounds, int) or \
                self.precopy_rounds < 0:
            raise OptionsError("TransferPolicy.precopy_rounds must be an "
                               f"int >= 0, got {self.precopy_rounds!r}")
        if self.precopy_rounds > 0 and self.mode != "delta":
            raise OptionsError(
                "TransferPolicy.precopy_rounds > 0 requires mode='delta': "
                "pre-copy rounds diff against the destination CAS via "
                "pack v2 content hashes, which a raw copy does not have")
        if self.max_blackout_ms is not None:
            if not isinstance(self.max_blackout_ms, (int, float)) or \
                    self.max_blackout_ms <= 0:
                raise OptionsError(
                    "TransferPolicy.max_blackout_ms must be a number > 0 "
                    f"or None, got {self.max_blackout_ms!r}")
            if self.precopy_rounds == 0:
                raise OptionsError(
                    "TransferPolicy.max_blackout_ms needs pre-copy rounds "
                    "to converge within: set precopy_rounds > 0")
        if self.residual_bytes_cap is not None:
            if not isinstance(self.residual_bytes_cap, int) or \
                    self.residual_bytes_cap <= 0:
                raise OptionsError(
                    "TransferPolicy.residual_bytes_cap must be an int > 0 "
                    f"or None, got {self.residual_bytes_cap!r}")
            if self.precopy_rounds == 0:
                raise OptionsError(
                    "TransferPolicy.residual_bytes_cap only bounds "
                    "pre-copy rounds: set precopy_rounds > 0")

    @property
    def precopy_enabled(self) -> bool:
        return self.mode == "delta" and self.precopy_rounds > 0

    def replace(self, **changes) -> "TransferPolicy":
        return dataclasses.replace(self, **changes)

    # one compact "k=v,k=v" string (None fields omitted), the reference's
    # REPRO_CKPT_TRANSFER_POLICY spelling
    def to_spec(self) -> str:
        parts = [f"mode={self.mode}", f"workers={self.workers}",
                 f"precopy_rounds={self.precopy_rounds}"]
        if self.max_blackout_ms is not None:
            parts.append(f"max_blackout_ms={self.max_blackout_ms!r}")
        if self.residual_bytes_cap is not None:
            parts.append(f"residual_bytes_cap={self.residual_bytes_cap}")
        return ",".join(parts)

    @classmethod
    def from_spec(cls, spec: str) -> "TransferPolicy":
        convs = {"mode": str, "workers": int, "precopy_rounds": int,
                 "max_blackout_ms": float, "residual_bytes_cap": int}
        kwargs = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise OptionsError(
                    f"TransferPolicy spec parts must be k=v, got {part!r} "
                    f"in {spec!r}")
            k, v = part.split("=", 1)
            k = k.strip()
            if k not in convs:
                raise OptionsError(
                    f"unknown TransferPolicy spec key {k!r} in {spec!r}")
            try:
                kwargs[k] = convs[k](v.strip())
            except ValueError as e:
                raise OptionsError(
                    f"bad TransferPolicy spec value for {k}: {e}") from e
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


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
    replicate_to     peer directory for snapshot replication (Gemini-style):
                     every committed image is pushed there, a restore
                     with no valid local image falls back to it, and a
                     lazy stream heals a torn chunk from it.  None
                     disables.
    transfer_policy  a :class:`TransferPolicy` (copy / delta, workers,
                     pre-copy rounds and budgets); None = the default
                     policy (copy, stop-and-copy).
    verify_restore   CRC-verify images before restoring from them.
    restore_mode     "eager" (the whole image is placed before restore()
                     returns) or "lazy" (resume-before-read: restore()
                     returns once the critical set is placed; the rest
                     streams in the background, joined by
                     restore_barrier()).
    critical_states  the lazy critical set: specs "state" or
                     "state/path-prefix" (e.g. "train_state/params");
                     None = the first state of the image's restore order.
    pack_format      2 (default): chunked/striped packs written by the
                     pipelined data plane; 1: serial single-file packs,
                     byte-compatible with the reference's (zlib only).
    io_threads       data-plane worker threads; 0 = auto-size.
    chunk_mb         pack-v2 chunk size in MiB.
    stripes          pack files per host, one appender thread each.
    capture          "sync" or "concurrent" (soft-freeze: a brief pin
                     pause, speculation to disk while the job runs, then
                     a validate pause that re-captures only the entries
                     that changed).  Requires pack_format=2,
                     incremental=True and mode="sync".
    """

    mode: str = "sync"
    incremental: bool = False
    compress: bool = False
    keep: int = 0
    lock_timeout_s: float = 10.0
    restore_threads: int = 0
    replicate_to: Optional[str] = None
    transfer_policy: Optional[TransferPolicy] = None
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
        if self.transfer_policy is None:
            object.__setattr__(self, "transfer_policy", TransferPolicy())
        elif not isinstance(self.transfer_policy, TransferPolicy):
            raise OptionsError("transfer_policy must be a TransferPolicy or "
                               f"None, got {self.transfer_policy!r}")
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
        if self.replicate_to is not None and not self.replicate_to:
            raise OptionsError("replicate_to must be a path or None")
        self.transfer_policy.validate()
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
        if self.pack_format not in (1, 2):
            raise OptionsError(f"pack_format must be 1 or 2, "
                               f"got {self.pack_format!r}")
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

    def replace(self, **changes) -> "CheckpointOptions":
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)
