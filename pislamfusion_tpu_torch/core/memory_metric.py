"""Per-callsite memory profiler.

Equivalent of GSLAM/GSLAM/core/MemoryMetric.h/.inc (malloc/free
interposition with per-callsite statistics, dumped by count or size —
enabled via ENABLE_MEMORYCHECK, gui/pislam.cpp:44-47,172-178). Python has
no malloc hook to interpose, so this wraps the stdlib `tracemalloc`
snapshot machinery behind the same surface: enable/disable, usage counters,
and by-count / by-size callsite dumps.

A copy of pislamfusion_tpu/core/memory_metric.py; only `device_usage`
differs: device memory is the CUDA caching allocator's, read from
`torch.cuda`'s counters instead of the live device arrays.
"""
from __future__ import annotations

import tracemalloc
from typing import List, Tuple

_enabled = False


def enable(nframes: int = 5):
    """MemoryMetric::enable."""
    global _enabled
    if not _enabled:
        tracemalloc.start(nframes)
        _enabled = True


def disable():
    global _enabled
    if _enabled:
        tracemalloc.stop()
        _enabled = False


def is_enabled() -> bool:
    return _enabled


def used_bytes() -> int:
    """Current traced host allocation (MemoryMetric::usage)."""
    return tracemalloc.get_traced_memory()[0] if _enabled else 0


def peak_bytes() -> int:
    return tracemalloc.get_traced_memory()[1] if _enabled else 0


def _stats(key: str) -> List[Tuple[str, int, int]]:
    snap = tracemalloc.take_snapshot()
    out = []
    for st in snap.statistics("lineno"):
        frame = st.traceback[0]
        out.append((f"{frame.filename}:{frame.lineno}", st.count, st.size))
    out.sort(key=lambda r: -r[1] if key == "count" else -r[2])
    return out


def dump_by_count(top: int = 20) -> str:
    """Per-callsite dump sorted by allocation count (dumpByCount)."""
    if not _enabled:
        return "(memory metric disabled)"
    lines = [f"{'callsite':<64} {'count':>8} {'bytes':>12}"]
    for site, count, size in _stats("count")[:top]:
        lines.append(f"{site:<64} {count:>8} {size:>12}")
    return "\n".join(lines)


def dump_by_size(top: int = 20) -> str:
    """Per-callsite dump sorted by bytes (dumpBySize)."""
    if not _enabled:
        return "(memory metric disabled)"
    lines = [f"{'callsite':<64} {'count':>8} {'bytes':>12}"]
    for site, count, size in _stats("size")[:top]:
        lines.append(f"{site:<64} {count:>8} {size:>12}")
    return "\n".join(lines)


def device_usage() -> dict:
    """Device memory of each CUDA device, from the caching allocator:
    {"cuda:i": {"allocated": bytes held by tensors now, "max_allocated":
    their peak since start or `torch.cuda.reset_peak_memory_stats`,
    "reserved": bytes the caching allocator has reserved}}; {} on a run
    without CUDA."""
    import torch
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = dict(
            allocated=int(torch.cuda.memory_allocated(i)),
            max_allocated=int(torch.cuda.max_memory_allocated(i)),
            reserved=int(torch.cuda.memory_reserved(i)))
    return out
