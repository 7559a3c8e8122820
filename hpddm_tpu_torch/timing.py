"""Device timing on the GPU (counterpart of ``hpddm_tpu/timing.py``).

PyTorch returns before the device finishes, so every bracket ends in a
synchronization: CUDA events for kernels and short pieces, the host clock
around ``torch.cuda.synchronize()`` for whole solves. A CPU run gives no
device time: these functions need a CUDA device.
"""

from __future__ import annotations

import time
from statistics import median

import torch

__all__ = ["events_ms", "cold_events_ms", "read_flushed_ms", "timed"]


def events_ms(fn, reps: int = 20, blocks: int = 5) -> float:
    """Milliseconds per call of ``fn()``: the best over ``blocks`` of the
    mean of ``reps`` back-to-back calls between two CUDA events, after one
    warm-up call. Where the host cannot keep up, this is the host's rate."""
    fn()
    best = float("inf")
    for _ in range(blocks):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def cold_events_ms(fn, reps: int = 30, flush_bytes: int = 256 << 20) -> float:
    """Median milliseconds of single calls of ``fn()`` with the L2 cache
    (50 MB on an H100) flushed by a ``flush_bytes`` write before each. The
    flush is still running on the device when the first event is recorded,
    so the bracket holds the call's device time, not its host overhead."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(median(times))


def read_flushed_ms(fn, reps: int = 30, flush_bytes: int = 256 << 20) -> float:
    """Median milliseconds of single calls of ``fn()`` with the L2 flushed
    by a ``flush_bytes`` read before each: the call finds clean lines, as
    after a kernel that only reads (the local solve's bmm)."""
    buf = torch.ones(flush_bytes // 4, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        buf.sum()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(median(times))


def timed(fn, reps: int = 3, warmup: int = 1):
    """Host-clock seconds of ``fn()``, each bracket between two
    ``torch.cuda.synchronize()``. Returns (best, all times, last result)."""
    out = None
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), times, out
