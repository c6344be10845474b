"""What may slow a run from outside the program, read over the window, so
that a run that reads far off can be told apart: each step's wall time, the
main thread's wait for a core (``/proc/thread-self/schedstat``), Python's
full garbage collections, and the card's SM clock (NVML, at most once a
second).  A source that cannot be read here is left out of the summary."""

from __future__ import annotations

import ctypes
import gc
import time
from typing import List, Optional, Tuple

from . import stats

CLOCK_EVERY_S = 1.0


def _runq_ns() -> Optional[int]:
    """The calling thread's total wait on a run queue, in ns."""
    try:
        with open("/proc/thread-self/schedstat") as f:
            return int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None


class _Nvml:
    """The SM clock of card 0 through the NVIDIA management library."""

    SM = 1          # NVML_CLOCK_SM

    def __init__(self):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        lib.nvmlInit_v2.argtypes = []
        lib.nvmlShutdown.argtypes = []
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [ctypes.c_uint,
                                                      ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetClockInfo.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_uint)]
        for f in (lib.nvmlInit_v2, lib.nvmlShutdown, lib.nvmlDeviceGetHandleByIndex_v2,
                  lib.nvmlDeviceGetClockInfo):
            f.restype = ctypes.c_int
        if lib.nvmlInit_v2() != 0:
            raise OSError("nvmlInit failed")
        self.lib = lib
        self.dev = ctypes.c_void_p()
        if lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(self.dev)) != 0:
            self.close()
            raise OSError("no NVML device 0")

    def sm_mhz(self) -> Optional[int]:
        mhz = ctypes.c_uint()
        ok = self.lib.nvmlDeviceGetClockInfo(self.dev, self.SM, ctypes.byref(mhz)) == 0
        return mhz.value if ok else None

    def close(self) -> None:
        self.lib.nvmlShutdown()


class Watch:
    """Call :meth:`start` when the window opens, :meth:`step` after each
    step inside it, :meth:`stop` when it closes; :meth:`summary` is one
    line for standard error."""

    def __init__(self, cuda: bool):
        self.steps: List[Tuple[float, float, int]] = []    # (t0, t1, run-queue wait ns)
        self.gc_s = 0.0
        self.gc_n = 0
        self.mhz: List[int] = []
        self._gc_t0 = None
        self._runq = None
        self._next_clock = 0.0
        self._nvml = None
        if cuda:
            try:
                self._nvml = _Nvml()
            except (OSError, AttributeError):
                self._nvml = None

    def _on_gc(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_n += 1
            self._gc_t0 = None

    def start(self) -> None:
        gc.callbacks.append(self._on_gc)
        self._runq = _runq_ns()

    def step(self, t0: float, t1: float) -> None:
        q = _runq_ns()
        wait = q - self._runq if q is not None and self._runq is not None else 0
        self._runq = q
        self.steps.append((t0, t1, wait))
        if self._nvml is not None and t1 >= self._next_clock:
            self._next_clock = t1 + CLOCK_EVERY_S
            mhz = self._nvml.sm_mhz()
            if mhz is not None:
                self.mhz.append(mhz)

    def stop(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        if self._nvml is not None:
            self._nvml.close()
            self._nvml = None

    def summary(self) -> str:
        if not self.steps:
            return "no steps in the window"
        walls = [1e3 * (b - a) for a, b, _ in self.steps]
        cut = stats.percentile(walls, 95)
        slow = [w for (a, b, w), ms in zip(self.steps, walls) if ms >= cut]
        parts = [f"{len(walls)} steps, wall p50 {stats.percentile(walls, 50):.3f} p95 {cut:.3f} "
                 f"max {max(walls):.3f} ms",
                 f"main thread waited for a core {sum(w for *_, w in self.steps) / 1e6:.3f} ms "
                 f"({sum(slow) / 1e6:.3f} ms in the {len(slow)} slowest steps)",
                 f"{self.gc_n} full collections, {1e3 * self.gc_s:.3f} ms"]
        if self.mhz:
            parts.append(f"SM clock {min(self.mhz)}..{max(self.mhz)} MHz "
                         f"over {len(self.mhz)} reads")
        return "; ".join(parts)
