"""CRIU-style plugin/hook architecture (paper §3.1, §3.1.3).

CRIUgpu extends CRIU with plugins that implement well-defined hooks invoked
at fixed stages of the checkpoint/restore workflow.  We keep the same hook
vocabulary and ordering contract:

  dump:    PAUSE_DEVICES → (host freeze) → CHECKPOINT_DEVICES →
           DUMP_EXT_STATE → (write + commit) → resume
  restore: RESTORE_EXT_STATE → RESUME_DEVICES_LATE

Every plugin also gets CRIU's init/exit contract: ``init(op)`` when loaded
(op is "dump" | "restore"), ``exit(success)`` at the end — the exit hook is
where a failed dump rolls the target back to its original running state.
"""
from __future__ import annotations

import enum
from typing import Any, Callable, Dict, FrozenSet, List, Optional

#: Version of the plugin/hook contract (hook vocabulary + HookContext
#: fields + init/exit semantics).  Bump on incompatible change; the
#: registry rejects plugins stamped with a different major version the way
#: CRIU rejects plugins built against a different plugin API.
PLUGIN_API_VERSION = 1


class PluginVersionError(RuntimeError):
    """Plugin was built against an incompatible plugin API version."""


class Hook(enum.Enum):
    PAUSE_DEVICES = "pause_devices"            # before host-state freeze
    CHECKPOINT_DEVICES = "checkpoint_devices"  # device -> host memory
    DUMP_EXT_STATE = "dump_ext_state"          # host-side external state
    RESTORE_EXT_STATE = "restore_ext_state"
    UPDATE_TOPOLOGY_MAP = "update_topology_map"  # GPUID-translation analogue
    RESUME_DEVICES_LATE = "resume_devices_late"  # host -> device + unlock


class Plugin:
    """Base plugin.  Subclasses override the hooks they care about.

    Every plugin is stamped with the ``api_version`` it was written against
    and a set of ``features`` it provides (capability flags surfaced by
    ``repro_torch.api`` capabilities reports and checked by backend selection).
    """

    name = "plugin"
    api_version: int = PLUGIN_API_VERSION
    features: FrozenSet[str] = frozenset()

    def init(self, op: str) -> None:               # "dump" | "restore"
        pass

    def exit(self, op: str, success: bool) -> None:
        pass

    def pause_devices(self, ctx: "HookContext") -> None:
        pass

    def checkpoint_devices(self, ctx: "HookContext") -> None:
        pass

    def dump_ext_state(self, ctx: "HookContext") -> None:
        pass

    def restore_ext_state(self, ctx: "HookContext") -> None:
        pass

    def update_topology_map(self, ctx: "HookContext") -> None:
        pass

    def resume_devices_late(self, ctx: "HookContext") -> None:
        pass

    def dispatch(self, hook: Hook, ctx: "HookContext") -> None:
        getattr(self, hook.value)(ctx)


class HookContext:
    """Mutable bag threaded through one checkpoint or restore operation."""

    def __init__(self, op: str, step: Optional[int] = None):
        self.op = op                       # "dump" | "restore"
        self.step = step
        self.roots: Dict[str, Any] = {}              # live state pytrees
        self.device_snapshot: Dict[str, Any] = {}   # name -> captured state
        self.host_state: Dict[str, Any] = {}        # name -> msgpack-able
        self.restored: Dict[str, Any] = {}          # name -> restored pytree
        self.target_mesh = None
        self.target_shardings: Dict[str, Any] = {}
        self.topology_map: Dict[str, Any] = {}      # translation table
        self.manifest: Dict[str, Any] = {}
        self.reader = None                           # snapshot reader (restore)
        self.warnings: List[str] = []
        self.stats: Dict[str, float] = {}


class PluginRegistry:
    def __init__(self, plugins: Optional[List[Plugin]] = None):
        self.plugins: List[Plugin] = []
        for p in plugins or []:
            self.add(p)

    def add(self, plugin: Plugin) -> None:
        version = getattr(plugin, "api_version", None)
        if version != PLUGIN_API_VERSION:
            raise PluginVersionError(
                f"plugin {getattr(plugin, 'name', plugin)!r} declares "
                f"api_version={version!r}; this engine speaks "
                f"api_version={PLUGIN_API_VERSION}")
        self.plugins.append(plugin)

    def features(self) -> FrozenSet[str]:
        out: set = set()
        for p in self.plugins:
            out |= getattr(p, "features", frozenset())
        return frozenset(out)

    def init_all(self, op: str) -> None:
        for p in self.plugins:
            p.init(op)

    def exit_all(self, op: str, success: bool) -> None:
        for p in self.plugins:
            try:
                p.exit(op, success)
            except Exception:                        # exit must not mask errors
                pass

    def run(self, hook: Hook, ctx: HookContext) -> None:
        for p in self.plugins:
            p.dispatch(hook, ctx)


class CallbackPlugin(Plugin):
    """Host-state plugin built from getter/setter callbacks — the mechanism
    the trainer uses to expose its data-pipeline cursor, RNG, and metric
    accumulators (the paper's DUMP_EXT_FILE/RESTORE_EXT_FILE analogue)."""

    def __init__(self, name: str, getter: Callable[[], Any],
                 setter: Callable[[Any], None]):
        self.name = name
        self._get = getter
        self._set = setter

    def dump_ext_state(self, ctx: HookContext) -> None:
        ctx.host_state[self.name] = self._get()

    def restore_ext_state(self, ctx: HookContext) -> None:
        if self.name in ctx.host_state:
            self._set(ctx.host_state[self.name])
