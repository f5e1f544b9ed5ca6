"""Device quiesce ("lock") — the cuda-checkpoint lock/unlock analogue.

``cuda-checkpoint --action lock`` blocks new CUDA API calls and waits for
in-flight work to finish, with a timeout after which CRIUgpu rolls back to
the running state (paper §3.1.1).  Here in-flight work is everything queued
on the device's CUDA streams: ``torch.cuda.synchronize`` drains it.  It runs
on a watchdog thread so a wedged device turns into :class:`LockTimeout`
after ``timeout_s`` (the engine then aborts the dump and the job keeps
running) instead of a hang.  New work cannot race the capture because the
engine owns the only launching thread while locked.  On the CPU there is
nothing asynchronous to drain.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch


class LockTimeout(RuntimeError):
    pass


class DeviceLock:
    def __init__(self, timeout_s: float = 10.0,
                 device: Optional[torch.device] = None):
        self.timeout_s = timeout_s
        self.device = device
        self.locked = False
        self.lock_time_s = 0.0

    def lock(self) -> float:
        """Drain the device's streams.  Returns the drain time."""
        t0 = time.perf_counter()
        if self.device is not None and self.device.type == "cuda":
            err: List[BaseException] = []

            def drain():
                try:
                    torch.cuda.synchronize(self.device)
                except BaseException as e:           # pragma: no cover
                    err.append(e)

            t = threading.Thread(target=drain, daemon=True,
                                 name="repro-device-lock")
            t.start()
            t.join(self.timeout_s)
            if t.is_alive():
                raise LockTimeout(
                    f"device quiesce exceeded {self.timeout_s}s "
                    f"(in-flight work still running); aborting checkpoint")
            if err:
                raise err[0]
        self.locked = True
        self.lock_time_s = time.perf_counter() - t0
        return self.lock_time_s

    def unlock(self) -> None:
        self.locked = False
