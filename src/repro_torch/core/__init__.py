"""Checkpoint mechanism on torch: the snapshot engine, CRIU-style plugin
hooks, the device lock, device backends, the snapshot store, peer
replication (the ``Replicator`` protocol: capability dispatch through
``supports_rounds``, never isinstance) and the multi-host two-phase
commit."""
from repro_torch.core.engine import (CheckpointAborted,  # noqa: F401
                                     SnapshotEngine)
from repro_torch.core.lock import DeviceLock, LockTimeout  # noqa: F401
from repro_torch.core.plugins import (PLUGIN_API_VERSION,  # noqa: F401
                                      CallbackPlugin, Hook, HookContext,
                                      Plugin, PluginRegistry,
                                      PluginVersionError)
from repro_torch.core.backends import (BackendError,  # noqa: F401
                                       HostNumpyBackend, available_backends,
                                       create_backend, register_backend)
from repro_torch.core.device_plugin import TorchBackend  # noqa: F401
from repro_torch.core.snapshot_io import SnapshotStore  # noqa: F401
from repro_torch.core.replication import (DirReplicator,  # noqa: F401
                                          MemReplicator, Replicator)
from repro_torch.core.multihost import (BarrierTimeout,  # noqa: F401
                                        MultiHostCommit)
