"""Phase timers (reference: RAII println timers, src/utils.rs:32-51).

On a CUDA device a phase is timed with CUDA events recorded on the current
stream: ``device_ms`` is the device timeline from the phase's first queued
work to its last, read after the phase's end event completes.  ``host_ms``
is the host clock around the same block.  On the CPU only the host clock
exists.  Set MINISTARK_TPU_TIMERS=0 to silence the per-phase prints.
"""

from __future__ import annotations

import os
import time

import torch


class Timer:
    enabled = os.environ.get("MINISTARK_TPU_TIMERS", "1") != "0"

    def __init__(self, name: str, device=None, log: list | None = None):
        self.name = name
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.log = log

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        device_ms = None
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            device_ms = self._start.elapsed_time(self._end)
        host_ms = (time.perf_counter() - self._t0) * 1000
        if self.log is not None:
            self.log.append({"phase": self.name, "host_ms": host_ms,
                             "device_ms": device_ms})
        if Timer.enabled:
            dev = "" if device_ms is None else f" (device {device_ms:.1f}ms)"
            print(f"{self.name}: {host_ms:.1f}ms{dev}", flush=True)
        return False
