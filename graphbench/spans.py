"""The port's own spans and counters (gardenia_tpu_torch/utils/profiler)
laid on a traced window's device timeline.

What a run holds for the recorder's metrics, beside run.py's own keys
(metrics/__init__):
  spans     [(id, parent id, name, start ns, end ns)]: set-up and window
  counters  {"setup": {name: n}, "window": {name: n}}: take() before and
            after the window
  window    {"start_ns", "end_ns", "trials", "busy_ns"}: the window on
            the host clock (ns since the epoch, the clock of the spans
            and of the profiler's device events) and the union of its
            device operations' intervals, clipped to it
A run without them (a port that has no recorder) reads None everywhere.

Intervals are [start, end) pairs in ns; "merged" lists are sorted and
disjoint, as trace.merged gives them.
"""

from __future__ import annotations

from collections import defaultdict

from graphbench.trace import merged

OUTSIDE = "outside the port"


def length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo: int, hi: int) -> list:
    """Merged intervals cut to [lo, hi)."""
    return [[max(s, lo), min(e, hi)] for s, e in merged(intervals)
            if min(e, hi) > max(s, lo)]


def intersect(a, b) -> list:
    """The intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """Merged list a less merged list b."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def named(spans, prefix: str) -> list:
    """The merged intervals of the closed spans whose name is `prefix` or
    starts with it."""
    return merged((s[3], s[4]) for s in spans
                  if s[4] is not None and s[2].startswith(prefix))


def has_recorder(run) -> bool:
    return bool(run.get("window")) and run.get("spans") is not None \
        and run.get("counters") is not None


def _window(run):
    w = run["window"]
    return w["start_ns"], w["end_ns"], w["trials"]


def idle(run) -> list:
    """The window's idle intervals: no device operation running."""
    lo, hi, _ = _window(run)
    return subtract([[lo, hi]], clip(run["window"]["busy_ns"], lo, hi))


def issuing(run) -> list:
    """Where the host was inside a solve.* span and outside any read span,
    in the window."""
    lo, hi, _ = _window(run)
    solve = clip(named(run["spans"], "solve."), lo, hi)
    return subtract(solve, named(run["spans"], "read"))


def segments(spans, lo: int, hi: int) -> list:
    """[(start, end, names of the spans open, outermost first)] that
    partition [lo, hi): the spans' nesting on the host's timeline."""
    marks = []
    for sp in spans:
        if sp[4] is None or sp[4] <= lo or sp[3] >= hi:
            continue
        # at one time, ends before starts, and outer spans open first
        marks.append((max(sp[3], lo), 1, -min(sp[4], hi), sp[0], sp[2]))
        marks.append((min(sp[4], hi), 0, 0, sp[0], sp[2]))
    marks.sort()
    out, stack, t = [], [], lo
    for when, is_start, _, sid, name in marks:
        if when > t:
            out.append((t, when, tuple(n for _, n in stack)))
            t = when
        if is_start:
            stack.append((sid, name))
        else:
            stack.remove((sid, name))
    if hi > t:
        out.append((t, hi, tuple(n for _, n in stack)))
    return out


def idle_by_span(run, top: int = 10) -> list:
    """[[name, seconds]] of the window's idle time, summed by the
    innermost port span open at that moment (OUTSIDE where none is),
    longest first."""
    lo, hi, _ = _window(run)
    gaps = idle(run)
    by = defaultdict(float)
    j = 0
    for s, e, names in segments(run["spans"], lo, hi):
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            by[names[-1] if names else OUTSIDE] += \
                (min(e, gaps[k][1]) - max(s, gaps[k][0])) / 1e9
            k += 1
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]


def outermost(spans, prefix: str) -> list:
    """The closed spans named `prefix`... that no span of that prefix
    encloses."""
    by_id = {s[0]: s for s in spans}

    def inside(sp):
        p = by_id.get(sp[1])
        while p is not None:
            if p[2].startswith(prefix):
                return True
            p = by_id.get(p[1])
        return False
    return [s for s in spans if s[4] is not None
            and s[2].startswith(prefix) and not inside(s)]


def before_window_s(run, prefix: str):
    """Seconds of the outermost `prefix` spans that ended before the
    window; None where there is none."""
    lo, _, _ = _window(run)
    found = [s for s in outermost(run["spans"], prefix) if s[4] <= lo]
    if not found:
        return None
    return sum(s[4] - s[3] for s in found) / 1e9
