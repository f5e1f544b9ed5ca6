"""repro_torch.api — the checkpointing surface (paper §3.1).

    from repro_torch.api import CheckpointOptions, CheckpointSession

    session = CheckpointSession(run_dir, CheckpointOptions(mode="async"))
    session.attach(lambda: {"serve_state": state})
    session.checkpoint(step)                  # `criu dump`
    session.restore()                         # `criu restore`

Images are the JAX package's format: ``python -m repro verify|inspect``
operates on them offline.
"""
from repro_torch.api.options import (CheckpointOptions,  # noqa: F401
                                     OptionsError, TransferPolicy)
from repro_torch.api.capabilities import (CheckReport,  # noqa: F401
                                          capabilities, check)
from repro_torch.api.session import (CheckpointSession,  # noqa: F401
                                     FrozenCheckpoint, SnapshotWriteFailed)
from repro_torch.core.engine import PendingWriteStalled  # noqa: F401
