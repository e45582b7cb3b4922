"""Profiling hooks — the port's counterpart of gardenia_tpu/utils/
profiler.py (reference include/profiler.h: PAPI counters, VTune ITT
resume-pause; include/timer.h TIME_OP).

The recorder: `span(name)` marks a region of the host's work and
`count(name, n)` adds to a counter, both kept in memory while
`recording()` is on and handed over, and cleared, by `take()`.  Off (the
default), a span is one flag test that returns a shared null context, a
count one flag test; nothing is allocated.  A span is
(id, parent id, name, start ns, end ns) on `time.time_ns()`, the clock
that torch.profiler's device events are stamped on (Kineto's events and
exported traces count ns since the epoch), so spans and kernels can be
laid on one timeline; its parent is the innermost span open when it
began.  Spans open no `record_function`: a traced run's device timeline
holds the device's own work only.  The recorder serves the thread that
calls it (the solvers' host loops); it holds no lock.

Where the port records (names fixed in PERF.md §3):
  solve.<kernel>    every *_solver call (`spanned`)
  pr.iteration      an iteration of solvers/pr's loops
  bfs.level         a level of solvers/bfs's host loops
  read              `host_read`: a device-to-host read the host waits on,
                    also counted as host_reads
  layout.<kind>     a build on a miss of core/graph.Graph._dev, the cache
                    of every layout and upload; counters layout_builds
                    and layout_hits
  graph.from_edges  core/graph.from_edges
  kernels.load      ops/_build.lib()'s first call (the nvcc build when
                    the sources' hash has no library, then the load);
                    counter kernel_builds
`take()` adds the always-on `LAUNCHES` counters of the ops modules that
are loaded, as launches.<module>[.<route>] (process totals, those that
are not 0).

`profile_region` wraps a region in a torch.profiler trace (CPU activity,
and CUDA activity where a card is present) when `log_dir` or
$GARDENIA_PROFILE_DIR is set, and writes it there as a Chrome trace with
the region's spans on a host track of their own; `roi` mirrors the
reference's gem5 roi_begin/roi_end hooks (include/sim.h:30-47) as a
span.  The per-kernel device breakdown of a solve is
`python -m gardenia_tpu_torch.profile_solve`.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import sys
import time
from typing import Iterator, Optional

import torch

_ON = False
_SPANS = []            # [id, parent id, name, start ns, end ns or None]
_OPEN = []             # ids of the spans open now, innermost last
_COUNTS = {}
_IDS = itertools.count()
_NULL = contextlib.nullcontext()

# the ops modules' always-on launch counters (module, attribute), and the
# name take() gives them (a dict's keys are appended)
_LAUNCH_COUNTERS = (("panel", "LAUNCHES", "launches.panel"),
                    ("panel", "SPLIT_LAUNCHES", "launches.panel"),
                    ("tc_count", "LAUNCHES", "launches.tc_count"),
                    ("minselect", "LAUNCHES", "launches.minselect"),
                    ("minselect", "MINPLUS_LAUNCHES",
                     "launches.minselect.minplus"),
                    ("kcl_count", "LAUNCHES", "launches.kcl_count"),
                    ("vc_core", "LAUNCHES", "launches.vc_core"))


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = [next(_IDS), _OPEN[-1] if _OPEN else None, self.name,
               time.time_ns(), None]
        _SPANS.append(rec)
        _OPEN.append(rec[0])
        self.rec = rec

    def __exit__(self, *exc):
        self.rec[4] = time.time_ns()
        _OPEN.remove(self.rec[0])
        return False


def span(name: str):
    """A context manager that records the region as a span while the
    recorder is on."""
    if not _ON:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while the recorder is on."""
    if _ON:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def host_read(t: torch.Tensor):
    """t.tolist(): the Python value(s) of a tensor, which on a card waits
    for the work queued before it; a span `read` and a count of
    host_reads while the recorder is on.  Of a 0-d tensor, the value that
    float(t), int(t) or bool(t) gives for its dtype."""
    if not _ON:
        return t.tolist()
    with _Span("read"):
        _COUNTS["host_reads"] = _COUNTS.get("host_reads", 0) + 1
        return t.tolist()


def spanned(name: str):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counts inside the block; what is recorded stays
    until take()."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


def _launches() -> dict:
    out = {}
    for mod, attr, stem in _LAUNCH_COUNTERS:
        value = getattr(sys.modules.get(f"gardenia_tpu_torch.ops.{mod}"),
                        attr, None)
        if isinstance(value, dict):
            out.update({f"{stem}.{k}": v for k, v in value.items() if v})
        elif value:
            out[stem] = value
    return out


def take() -> dict:
    """{"spans": [(id, parent id, name, start ns, end ns)], "counters":
    {name: n}} recorded since the last take(), which are cleared; spans
    still open have end None.  The counters include the non-zero LAUNCHES
    totals of the loaded ops modules; a counter left out reads 0."""
    spans = [tuple(r) for r in _SPANS]
    counters = dict(_COUNTS)
    _SPANS.clear()
    _COUNTS.clear()
    counters.update(_launches())
    return {"spans": spans, "counters": counters}


def _add_spans_to_trace(path: str, spans) -> None:
    """Append spans to a Chrome trace torch.profiler wrote, as complete
    events on a host track of their own, on the trace's time base."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": "gardenia spans",
                   "args": {"name": "gardenia spans"}})
    for sid, parent, name, start, end in spans:
        if end is None:
            continue
        events.append({"ph": "X", "cat": "gardenia_span", "name": name,
                       "pid": pid, "tid": "gardenia spans",
                       "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": {"id": sid, "parent": parent}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_region(name: str, log_dir: Optional[str] = None
                   ) -> Iterator[None]:
    """Trace a region into <log_dir>/<name>.<pid>.trace.json when log_dir
    (or $GARDENIA_PROFILE_DIR) is set, with the spans recorded inside it;
    always names the region."""
    log_dir = log_dir or os.environ.get("GARDENIA_PROFILE_DIR")
    if not log_dir:
        with torch.profiler.record_function(name):
            yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was_on, mark = _ON, len(_SPANS)
    with recording():
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(name):
                yield
    spans = [tuple(r) for r in _SPANS[mark:]]
    if not was_on:
        take()          # only this region's: nothing else was recording
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    _add_spans_to_trace(path, spans)


@contextlib.contextmanager
def roi(name: str = "roi") -> Iterator[dict]:
    """Region-of-interest timer: gem5 roi_begin/roi_end analog, a span
    `name`.  Yields a dict filled with 'seconds' at exit."""
    stats = {"name": name}
    t0 = time.perf_counter()
    try:
        with span(name):
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
