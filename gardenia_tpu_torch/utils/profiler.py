"""Profiling hooks — the port's counterpart of gardenia_tpu/utils/
profiler.py (reference include/profiler.h: PAPI counters, VTune ITT
resume-pause; include/timer.h TIME_OP).

`profile_region` wraps a region in a torch.profiler trace (CPU activity,
and CUDA activity where a card is present) when `log_dir` or
$GARDENIA_PROFILE_DIR is set, and writes it there as a Chrome trace;
`roi` mirrors the reference's gem5 roi_begin/roi_end hooks (include/
sim.h:30-47) as a named record_function range.  The per-kernel device
breakdown of a solve is `python -m gardenia_tpu_torch.profile_solve`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_region(name: str, log_dir: Optional[str] = None
                   ) -> Iterator[None]:
    """Trace a region into <log_dir>/<name>.<pid>.trace.json when log_dir
    (or $GARDENIA_PROFILE_DIR) is set; always names the region."""
    log_dir = log_dir or os.environ.get("GARDENIA_PROFILE_DIR")
    if not log_dir:
        with torch.profiler.record_function(name):
            yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{name}.{os.getpid()}.trace.json"))


@contextlib.contextmanager
def roi(name: str = "roi") -> Iterator[dict]:
    """Region-of-interest timer: gem5 roi_begin/roi_end analog.
    Yields a dict filled with 'seconds' at exit."""
    stats = {"name": name}
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield stats
    finally:
        stats["seconds"] = time.perf_counter() - t0


def device_memory_stats(device) -> dict:
    """Live and peak bytes the caching allocator holds on a CUDA device,
    and the card's memory (the reference's printed cudaMemGetInfo
    diagnostics); {} for a CPU device or when the allocator cannot say.
    A CUDA device that does not exist raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    if not torch.cuda.is_available() or \
            (dev.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {dev} (torch.cuda.device_count()"
                           f" = {torch.cuda.device_count()})")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        s = torch.cuda.memory_stats(index)
        return {"bytes_in_use": s.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(index)
                .total_memory}
    except RuntimeError:
        return {}
