"""CheckpointOptions — the declarative `criu_set_*` analogue.

Port of the reference's ``api/options.py``: one frozen dataclass carrying
every knob the engine understands, validated at construction, and the
:class:`TransferPolicy` that says how snapshot bytes reach a peer.  Each
field maps to one ``REPRO_CKPT_*`` environment variable
(``from_env``/``to_env``, the `criu_set_*` <-> CRIU_* convention), so a
scheduler configures a job without code.  The stringly
``transfer=``/``transfer_workers=`` keywords (and their environment
variables) still map into the policy, with a one-time DeprecationWarning.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Tuple

_MODES = ("sync", "async")
_TRANSFERS = ("copy", "delta")
_RESTORE_MODES = ("eager", "lazy")
_CAPTURES = ("sync", "concurrent")

# env-var names, one per field
_ENV_PREFIX = "REPRO_CKPT_"

# deprecation warnings fire once per process, keyed by what was deprecated
_WARNED: set = set()


def _warn_once(key: str, message: str) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


class OptionsError(ValueError):
    """An invalid CheckpointOptions combination."""


def auto_io_threads() -> int:
    """The io_threads=0 auto-sizing policy of every data-plane consumer
    (engine, snapshot writer, CLI); defined beside the snapshot writer."""
    from repro_torch.core.snapshot_io import auto_io_threads as policy
    return policy()


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
    transfer         DEPRECATED: ``transfer_policy.mode``; after
                     construction a mirror of it.
    transfer_workers DEPRECATED: ``transfer_policy.workers``; a mirror.
    transfer_policy  a :class:`TransferPolicy` (copy / delta, workers,
                     pre-copy rounds and budgets); None = the default
                     policy (copy, stop-and-copy), or what the legacy
                     keywords map to.
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
    transfer: Optional[str] = None
    transfer_workers: Optional[int] = None
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
        self._resolve_transfer_policy()
        self.validate()

    def _resolve_transfer_policy(self) -> None:
        """Fold the deprecated transfer/transfer_workers keywords into
        transfer_policy, then mirror the policy back onto them so legacy
        readers (and equality across the two spellings) keep working."""
        policy = self.transfer_policy
        if policy is None:
            legacy = {}
            if self.transfer is not None:
                legacy["mode"] = self.transfer
            if self.transfer_workers is not None:
                legacy["workers"] = self.transfer_workers
            if legacy:
                _warn_once(
                    "options.transfer-kwargs",
                    "CheckpointOptions(transfer=..., transfer_workers=...) "
                    "is deprecated; pass "
                    "transfer_policy=TransferPolicy(mode=..., workers=...) "
                    "instead")
            policy = TransferPolicy(**legacy)
        else:
            if not isinstance(policy, TransferPolicy):
                raise OptionsError(
                    "transfer_policy must be a TransferPolicy or None, "
                    f"got {policy!r}")
            if self.transfer is not None and self.transfer != policy.mode:
                raise OptionsError(
                    f"conflicting transfer settings: legacy "
                    f"transfer={self.transfer!r} vs "
                    f"transfer_policy.mode={policy.mode!r} — drop the "
                    f"legacy kwarg")
            if self.transfer_workers is not None and \
                    self.transfer_workers != policy.workers:
                raise OptionsError(
                    f"conflicting transfer settings: legacy "
                    f"transfer_workers={self.transfer_workers!r} vs "
                    f"transfer_policy.workers={policy.workers!r} — drop "
                    f"the legacy kwarg")
        object.__setattr__(self, "transfer_policy", policy)
        object.__setattr__(self, "transfer", policy.mode)
        object.__setattr__(self, "transfer_workers", policy.workers)

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
        if "transfer_policy" in changes:
            # a new policy wins outright; drop the mirrored legacy fields
            # so _resolve_transfer_policy doesn't see a stale conflict
            changes.setdefault("transfer", None)
            changes.setdefault("transfer_workers", None)
        elif "transfer" in changes or "transfer_workers" in changes:
            # legacy-field replace: fold into the current policy so the
            # other policy knobs (precopy_rounds, budgets) survive
            pol_changes = {}
            if "transfer" in changes:
                pol_changes["mode"] = changes["transfer"]
            if "transfer_workers" in changes:
                pol_changes["workers"] = changes["transfer_workers"]
            changes["transfer_policy"] = \
                self.transfer_policy.replace(**pol_changes)
        return dataclasses.replace(self, **changes)

    def effective_io_threads(self) -> int:
        """io_threads with 0 resolved against this host's CPU count."""
        return self.io_threads or auto_io_threads()

    # ------------------------------------------------------------ env i/o
    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> "CheckpointOptions":
        """Build options from REPRO_CKPT_* variables (missing = default)."""
        env = os.environ if env is None else env

        def get(name, conv, default):
            raw = env.get(_ENV_PREFIX + name)
            if raw is None:
                return default
            return conv(raw)

        def as_bool(raw: str) -> bool:
            return raw.strip().lower() in ("1", "true", "yes", "on")

        def as_specs(raw: str) -> Optional[Tuple[str, ...]]:
            specs = tuple(s.strip() for s in raw.split(",") if s.strip())
            return specs or None

        # the structured policy var wins; the legacy vars still map (with
        # a one-time DeprecationWarning) so old scheduler configs work
        policy = get("TRANSFER_POLICY", TransferPolicy.from_spec, None)
        legacy_mode = get("TRANSFER", str, None)
        legacy_workers = get("TRANSFER_WORKERS", int, None)
        if policy is not None:
            legacy_mode = legacy_workers = None
        elif legacy_mode is not None or legacy_workers is not None:
            _warn_once(
                "options.transfer-env",
                f"{_ENV_PREFIX}TRANSFER / {_ENV_PREFIX}TRANSFER_WORKERS "
                f"are deprecated; set {_ENV_PREFIX}TRANSFER_POLICY "
                f"(e.g. 'mode=delta,workers=2') instead")
            # fold into a policy here so the constructor's kwargs shim
            # doesn't fire a *second* deprecation for the same env vars
            legacy = {}
            if legacy_mode is not None:
                legacy["mode"] = legacy_mode
            if legacy_workers is not None:
                legacy["workers"] = legacy_workers
            policy = TransferPolicy(**legacy)
            legacy_mode = legacy_workers = None

        return cls(
            mode=get("MODE", str, cls.mode),
            incremental=get("INCREMENTAL", as_bool, cls.incremental),
            compress=get("COMPRESS", as_bool, cls.compress),
            keep=get("KEEP", int, cls.keep),
            lock_timeout_s=get("LOCK_TIMEOUT_S", float, cls.lock_timeout_s),
            restore_threads=get("RESTORE_THREADS", int, cls.restore_threads),
            replicate_to=get("REPLICATE_TO", str, cls.replicate_to),
            transfer=legacy_mode,
            transfer_workers=legacy_workers,
            transfer_policy=policy,
            verify_restore=get("VERIFY_RESTORE", as_bool, cls.verify_restore),
            restore_mode=get("RESTORE_MODE", str, cls.restore_mode),
            critical_states=get("CRITICAL_STATES", as_specs,
                                cls.critical_states),
            pack_format=get("PACK_FORMAT", int, cls.pack_format),
            io_threads=get("IO_THREADS", int, cls.io_threads),
            chunk_mb=get("CHUNK_MB", int, cls.chunk_mb),
            stripes=get("STRIPES", int, cls.stripes),
            capture=get("CAPTURE", str, cls.capture),
        )

    def to_env(self) -> Dict[str, str]:
        """Inverse of from_env: CheckpointOptions.from_env(o.to_env()) == o."""
        out = {
            _ENV_PREFIX + "MODE": self.mode,
            _ENV_PREFIX + "INCREMENTAL": "1" if self.incremental else "0",
            _ENV_PREFIX + "COMPRESS": "1" if self.compress else "0",
            _ENV_PREFIX + "KEEP": str(self.keep),
            _ENV_PREFIX + "LOCK_TIMEOUT_S": repr(self.lock_timeout_s),
            _ENV_PREFIX + "RESTORE_THREADS": str(self.restore_threads),
            _ENV_PREFIX + "TRANSFER_POLICY": self.transfer_policy.to_spec(),
            _ENV_PREFIX + "VERIFY_RESTORE": "1" if self.verify_restore
            else "0",
            _ENV_PREFIX + "RESTORE_MODE": self.restore_mode,
            _ENV_PREFIX + "PACK_FORMAT": str(self.pack_format),
            _ENV_PREFIX + "IO_THREADS": str(self.io_threads),
            _ENV_PREFIX + "CHUNK_MB": str(self.chunk_mb),
            _ENV_PREFIX + "STRIPES": str(self.stripes),
            _ENV_PREFIX + "CAPTURE": self.capture,
        }
        if self.replicate_to is not None:
            out[_ENV_PREFIX + "REPLICATE_TO"] = self.replicate_to
        if self.critical_states is not None:
            out[_ENV_PREFIX + "CRITICAL_STATES"] = ",".join(
                self.critical_states)
        return out

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)
