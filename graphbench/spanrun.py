"""One traced run of a cell with the port's recorder on: the benchmark's
own --trace 1 run (run.run_cell as it stands), with the port's spans and
counters (gardenia_tpu_torch/utils/profiler) recorded from set-up to the
window's end and laid on the window's device timeline.

    python3 -m graphbench.spanrun --workload kron20-pr --seed <n> \
        [--seconds 5] [--recorder 1] [--scale N] [--out file.jsonl]

run.py itself neither records nor keeps the device events, so this module
wraps two of its calls for the run: run.timed_window, to take() the
recorder's set-up before the window and the window's own after it, and
trace.summary, to keep the window's device events and trial starts.  It
prints, last on standard output, one JSON object: the traced result's
metrics, the recorder's five metrics (metrics/host_reads_per_trial,
host_issue_ms_per_trial, idle_issuing_pct, layout_build_s,
kernel_load_s) and idle_by_span, and the checks of the spans against the
host clock's timings (`against`).  With --recorder 0 the same run with
the recorder left off, for its cost.  A port without the recorder reads
None in the recorder's metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from graphbench import manifest, spans

METRICS = ("host_reads_per_trial", "host_issue_ms_per_trial",
           "idle_issuing_pct", "layout_build_s", "kernel_load_s")


def recorder():
    """The port's recorder module, or None where the port has none."""
    try:
        from gardenia_tpu_torch.utils import profiler
    except ImportError:
        return None
    return profiler if hasattr(profiler, "recording") else None


def recorded(got: dict):
    """What the recorder metrics read (spans.py), from what the wrapped
    calls kept; {} where the recorder did not run."""
    if "window" not in got or "events" not in got or not got["starts"]:
        return {}
    lo = got["starts"][0]
    hi = lo + int(round(got["window_s"] * 1e9))
    busy = spans.clip([(s, e) for _, _, s, e in got["events"]], lo, hi)
    return {"spans": got["setup"]["spans"] + got["window"]["spans"],
            "counters": {"setup": got["setup"]["counters"],
                         "window": got["window"]["counters"]},
            "window": {"start_ns": lo, "end_ns": hi,
                       "trials": got["trials"], "busy_ns": busy}}


def against(run: dict, metrics: dict) -> dict:
    """The spans beside the host clock's timings of the same layers: the
    from_edges span and graph_build_s, the first solve span (the layouts
    and the library load inside it) and first_trial_s, and the share of
    the window's device busy time inside solve.* spans."""
    lo = run["window"]["start_ns"]
    setup = [s for s in run["spans"] if s[4] is not None and s[4] <= lo]
    first = min((s for s in spans.outermost(setup, "solve.")),
                key=lambda s: s[3], default=None)
    build = [s for s in setup if s[2] == "graph.from_edges"]
    busy = run["window"]["busy_ns"]
    in_solve = spans.intersect(busy, spans.named(run["spans"], "solve."))
    out = {"from_edges_s": sum(s[4] - s[3] for s in build) / 1e9,
           "graph_build_s": metrics.get("graph_build_s", {}).get("value"),
           "first_solve_s": None if first is None
           else (first[4] - first[3]) / 1e9,
           "first_trial_s": metrics.get("first_trial_s", {}).get("value"),
           "busy_in_solve_pct": 100.0 * spans.length(in_solve)
           / max(1, spans.length(busy)),
           "layout_builds_window":
               run["counters"]["window"].get("layout_builds", 0),
           "layout_hits_window":
               run["counters"]["window"].get("layout_hits", 0),
           "kernel_builds": run["counters"]["setup"].get("kernel_builds", 0)}
    if first is not None:
        for prefix, key in (("layout.", "first_solve_layouts_s"),
                            ("kernels.load", "first_solve_kernel_load_s")):
            inner = [s for s in spans.outermost(setup, prefix)
                     if first[3] <= s[3] and s[4] <= first[4]]
            out[key] = sum(s[4] - s[3] for s in inner) / 1e9
    return out


def traced(bench: dict, workload: str, seed: int, seconds: float, device,
           *, record: bool = True, cfg_override=None,
           t_start: float = None) -> dict:
    """run.run_cell(..., trace=True) with the recorder on (`record`) and
    the recorder's readings added; the result dict."""
    from graphbench import run, trace
    prof = recorder() if record else None
    got = {}
    window, summary = run.timed_window, trace.summary

    def timed_window(*args, **kwargs):
        got["setup"] = prof.take()
        out = window(*args, **kwargs)
        got["window"] = prof.take()
        return out

    def kept_summary(events, window_s, trials, trial_starts_ns=()):
        got.update(events=events, window_s=window_s, trials=trials,
                   starts=list(trial_starts_ns))
        return summary(events, window_s, trials, trial_starts_ns)

    trace.summary = kept_summary
    if prof is not None:
        run.timed_window = timed_window
    try:
        with prof.recording() if prof else contextlib.nullcontext():
            result, lines = run.run_cell(
                bench, workload, seed, seconds, True, device,
                cfg_override=cfg_override,
                t_start=time.perf_counter() if t_start is None else t_start)
        if prof is not None:
            prof.take()
    finally:
        run.timed_window, trace.summary = window, summary
    rec = recorded(got)
    out = {"workload": workload, "seed": seed, "recorder": prof is not None,
           "correct": result["correct"], "attempted": result["attempted"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "device": result["device"], "checks": result["checks"],
           "breakdown": result["breakdown"], "lines": lines}
    if rec:
        values = {name: manifest.metric(name).read(rec) for name in METRICS}
        out["recorder_metrics"] = {k: v for k, v in values.items()
                                   if v is not None}
        out["idle_by_span"] = spans.idle_by_span(rec)
        out["against"] = against(rec, result["metrics"])
        out["counters"] = rec["counters"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m graphbench.spanrun")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    from graphbench import run
    for key, path in run.CACHE_ENV.items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    out = traced(manifest.load_benchmark(), args.workload, args.seed,
                 args.seconds, args.device, record=bool(args.recorder),
                 cfg_override=None if args.scale is None
                 else {"scale": args.scale}, t_start=t_start)
    out["card"] = run.power_limit()
    for line in out.pop("lines"):
        print(line, file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
