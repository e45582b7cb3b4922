"""Device busy time, idle gaps and kernel counts from a torch.profiler
trace of the measured window.

The profiler traces CUDA activity only (kernels and copies, by CUPTI);
its callbacks still add some microseconds of host time to each launch,
which a host-bound loop shows as idle (PERF.md).  Busy time is the length
of the union of the device operations' intervals, so operations that
overlap (two streams) count once; idle is the rest of the window as the
host clock timed it, so the host's time at both ends of the window
counts as idle too.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def _kind(name: str) -> str:
    """'kernel', 'copy', or '' for a device-side record that is no
    operation (a synchronization)."""
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "" if "Sync" in name else "kernel"


def device_events(prof) -> list:
    """[(name, kind, start_ns, end_ns)] of the device operations that a
    torch.profiler.profile recorded: kind 'kernel' or 'copy'."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.duration_ns() <= 0:
            continue
        kind = _kind(e.name())
        if kind:
            out.append((e.name(), kind, e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def merged(intervals) -> list:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    return float(sum(e - s for s, e in merged(intervals)))


def idle_gaps(events, trial_starts_ns=(), top: int = 10) -> list:
    """[[label, seconds]] of the idle time between device operations,
    summed by label, longest first: 'between trials' where a trial began
    inside the gap, else 'after <the operation that ended last before
    it>'."""
    if not events:
        return []
    ordered = sorted(events, key=lambda ev: ev[2])
    starts = sorted(trial_starts_ns)
    by = defaultdict(float)
    last_end, last_name = ordered[0][3], ordered[0][0]
    for name, _, s, e in ordered[1:]:
        if s > last_end:
            i = bisect.bisect_right(starts, last_end)
            label = ("between trials" if i < len(starts) and starts[i] < s
                     else f"after {last_name[:100]}")
            by[label] += (s - last_end) / 1e9
        if e > last_end:
            last_end, last_name = e, name
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]


def device_ops(events, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time,
    summed by name."""
    by = defaultdict(float)
    for name, _, s, e in events:
        by[name[:120]] += (e - s) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]


def summary(events, window_s: float, trials: int, trial_starts_ns=()
            ) -> dict:
    """What the per-layer metrics read from a traced window."""
    busy_s = union_length((s, e) for _, _, s, e in events) / 1e9
    return {"busy_s": busy_s, "window_s": window_s, "trials": trials,
            "kernels": sum(1 for ev in events if ev[1] == "kernel"),
            "copies": sum(1 for ev in events if ev[1] == "copy"),
            "device_ops": device_ops(events),
            "idle_gaps": idle_gaps(events, trial_starts_ns)}
