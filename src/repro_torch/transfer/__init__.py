"""Cross-host checkpoint transfer: content-addressed chunk store + delta
replication + migration support (port of the reference's ``transfer``
package; host code only).

CRIUgpu's recovery-time wins in a multi-tenant cluster depend on moving
checkpoint images *between hosts* fast — a preempted job usually comes
back somewhere else.  This package is that data path:

  * :class:`ChunkStore` — a content-addressed store (CAS) keyed by the
    raw-CRC content hashes pack v2 already computes per chunk; the
    target host's dedup index and the resume log of interrupted
    transfers.
  * :class:`DeltaReplicator` — a drop-in replacement for
    :class:`repro_torch.core.replication.DirReplicator` that negotiates a
    have/want set with the target's CAS and ships only missing chunks
    (striped + parallel), then re-materializes byte-identical packs.
  * :func:`transfer_closure` — the delta-chain closure of one snapshot
    (incremental children need their parents on the target too).
  * :class:`PrecopyController` — the live-migration convergence
    controller: after each pre-copy round it decides continue / freeze
    (residual fits the blackout budget) / fallback (stop-and-copy).
"""
from repro_torch.transfer.cas import CASCorruption, ChunkStore, chunk_key
from repro_torch.transfer.delta import DeltaReplicator, transfer_closure
from repro_torch.transfer.precopy import (PrecopyController, RoundDecision,
                                          summarize_rounds)

__all__ = ["CASCorruption", "ChunkStore", "chunk_key", "DeltaReplicator",
           "transfer_closure", "PrecopyController", "RoundDecision",
           "summarize_rounds"]
