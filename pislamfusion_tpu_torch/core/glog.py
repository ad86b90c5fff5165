"""Mini-glog: leveled logging with pluggable sinks + per-frame ScopedLogger.

Equivalent of GSLAM/GSLAM/core/Glog.h (vendored mini-glog: LOG(severity),
CHECK, pluggable LogSink / AddLogSink / LogFileSink, Glog.h:207-264) and the
reference's per-frame one-line trace (a stringstream accumulated across the
tracker stages and flushed at scope exit, gated by the SLAM.Verbose bitmask
— TrackerOpt.cpp:226-239,303-311, MapperDemo.cpp:359-360).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, List, Optional

INFO, WARNING, ERROR, FATAL = 0, 1, 2, 3
_NAMES = "IWEF"


class LogSink:
    def send(self, severity: int, message: str):  # pragma: no cover - ABC
        raise NotImplementedError


class StderrSink(LogSink):
    def __init__(self, min_severity: int = INFO):
        self.min_severity = min_severity

    def send(self, severity: int, message: str):
        if severity >= self.min_severity:
            print(message, file=sys.stderr, flush=True)


class LogFileSink(LogSink):
    """File sink (the `LogFile` config key, DIYSLAM.cpp:196-201)."""

    def __init__(self, path: str, min_severity: int = INFO):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        self.min_severity = min_severity

    def send(self, severity: int, message: str):
        if severity >= self.min_severity:
            self._fh.write(message + "\n")

    def close(self):
        self._fh.close()


class Logger:
    def __init__(self):
        self._sinks: List[LogSink] = [StderrSink(min_severity=WARNING)]
        self._lock = threading.Lock()

    def add_sink(self, sink: LogSink):
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink: LogSink):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def log(self, severity: int, message: str):
        ts = time.strftime("%m%d %H:%M:%S")
        line = f"{_NAMES[severity]}{ts}] {message}"
        with self._lock:
            sinks = list(self._sinks)
        for s in sinks:
            s.send(severity, line)
        if severity >= FATAL:
            raise SystemExit(line)

    def info(self, message: str):
        self.log(INFO, message)

    def warning(self, message: str):
        self.log(WARNING, message)

    def error(self, message: str):
        self.log(ERROR, message)

    def fatal(self, message: str):
        self.log(FATAL, message)


logger = Logger()


def check(cond, message: str = "CHECK failed"):
    """CHECK(cond) — fatal on failure (Glog.h CHECK macros)."""
    if not cond:
        logger.fatal(message)


class ScopedLogger:
    """Accumulate one line across a frame's stages; flush at scope exit when
    the verbosity bit is set (the reference's per-frame `_logger`
    stringstream, TrackerOpt.cpp:226-239)."""

    def __init__(self, cfg=None, bit: int = 1, severity: int = INFO,
                 sink: Optional[Callable[[str], None]] = None):
        self._parts: List[str] = []
        self._cfg = cfg
        self._bit = bit
        self._severity = severity
        self._sink = sink

    def __lshift__(self, part):          # logger << "stage"
        self._parts.append(str(part))
        return self

    def append(self, part):
        self._parts.append(str(part))
        return self

    def enabled(self) -> bool:
        if self._cfg is None:
            return True
        return bool(self._cfg.get_int("SLAM.Verbose", 0) & self._bit)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._parts and self.enabled():
            msg = "".join(self._parts)
            if self._sink is not None:
                self._sink(msg)
            else:
                logger.log(self._severity, msg)
        self._parts.clear()
        return False
