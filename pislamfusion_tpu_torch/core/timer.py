"""Named-section wall-clock profiler.

The port's counterpart of pislamfusion_tpu/core/timer.py (GSLAM's
Timer.h:68-125: timer.enter/leave with per-section mean/total stats). A
section is also a `torch.profiler.record_function` range, so it shows up
in a torch.profiler trace beside the card's kernels. The wall clock times
what the host spends in the section: on a CUDA device that is the time to
enqueue its work, not the work itself.
"""
from __future__ import annotations

import atexit
import threading
import time
from contextlib import contextmanager
from typing import Dict

from torch.profiler import record_function


class _Section:
    __slots__ = ("count", "total", "tmin", "tmax", "_t0")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.tmin = float("inf")
        self.tmax = 0.0
        self._t0 = 0.0


class Timer:
    def __init__(self, name: str = "timer", dump_at_exit: bool = False):
        self.name = name
        self.enabled = True
        self._sections: Dict[str, _Section] = {}
        self._lock = threading.Lock()
        if dump_at_exit:
            atexit.register(self.dump)

    def enter(self, name: str):
        if not self.enabled:
            return
        with self._lock:
            s = self._sections.setdefault(name, _Section())
        s._t0 = time.perf_counter()

    def leave(self, name: str):
        if not self.enabled:
            return
        s = self._sections.get(name)
        if s is None or s._t0 == 0.0:
            return
        dt = time.perf_counter() - s._t0
        with self._lock:
            s.count += 1
            s.total += dt
            s.tmin = min(s.tmin, dt)
            s.tmax = max(s.tmax, dt)

    @contextmanager
    def scope(self, name: str):
        """ScopedTimer / SCOPE_TIMER equivalent."""
        self.enter(name)
        with record_function(name):
            try:
                yield
            finally:
                self.leave(name)

    def stats(self):
        with self._lock:
            return {k: dict(count=s.count, total=s.total,
                            mean=(s.total / s.count if s.count else 0.0),
                            min=(0.0 if s.tmin == float("inf") else s.tmin),
                            max=s.tmax)
                    for k, s in self._sections.items()}

    def dump(self):
        st = self.stats()
        if not st:
            return ""
        w = max(len(k) for k in st)
        lines = [f"{'section'.ljust(w)}  calls      mean       total"]
        for k in sorted(st, key=lambda k: -st[k]["total"]):
            s = st[k]
            lines.append(f"{k.ljust(w)}  {s['count']:5d}  "
                         f"{s['mean'] * 1e3:8.3f}ms  {s['total']:8.3f}s")
        report = "\n".join(lines)
        print(report, flush=True)
        return report

    def reset(self):
        with self._lock:
            self._sections.clear()


timer = Timer("global")
