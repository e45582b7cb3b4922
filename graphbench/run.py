"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m graphbench.run --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Set-up: the configuration's graph is generated on the card from the seed
(graphbench/generators/, the module its `generator` names) and handed to
the port as the raw edge list its core/graph.from_edges takes; the first
trial builds and uploads what the solver caches on the graph; then the
mix's warm-up trials.  The window:
one caller runs trials back to back for --seconds, each timed on the
host clock up to torch.cuda.synchronize(); the window closes when the
trial that passes its end returns.  With --trace 1 the window (at most
TRACE_SECONDS) runs under torch.profiler, tracing CUDA activity only,
and the line carries the cell's per-layer metrics instead of its
end-to-end ones.  After the window the peak device memory is read, the
port's state is freed, and a sample of the answers (every answer, where
the mix says so) is judged against reference.py.  prepare() and drive()
are the set-up and the timed path; control.py reads its limits' readings
through the same two.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (breakdown,) and, last, checks: each number
compared with its limit, which also close standard error.  Without a
CUDA card, or with fewer than the cell asks for, the run prints no result
and exits with 3; with jax, jaxlib, flax or gardenia_tpu loaded once the
window has closed, with 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from graphbench import manifest  # noqa: E402

# the caches a run may fill, inside the checkout at fixed paths, so that
# only a checkout's first run builds (the port's own kernel and native
# libraries go to gardenia_tpu_torch/_build, also inside the checkout)
CACHE = os.path.join(manifest.ROOT, ".graphbench_cache")
CACHE_ENV = {"TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
             "PYTORCH_KERNEL_CACHE_PATH": os.path.join(CACHE, "torch")}
FORBIDDEN = ("jax", "jaxlib", "flax", "gardenia_tpu")
TRACE_SECONDS = 5.0


class Sampler:
    """A uniform sample of k of the window's answers (reservoir sampling
    from the run's seed; k = 0 keeps every answer)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = random.Random(int(seed))
        self.kept = []

    def offer(self, i: int, out) -> None:
        if self.k <= 0 or len(self.kept) < self.k:
            self.kept.append((i, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, out)

    def items(self) -> list:
        return sorted(self.kept, key=lambda item: item[0])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def build_graph(edges, cfg):
    """The port's Graph of the raw edges, as its loaders build one."""
    from gardenia_tpu_torch.core.graph import from_edges
    from gardenia_tpu_torch.core.io import EdgeListData
    wt = None if edges.wt is None else edges.wt.cpu().numpy()
    data = EdgeListData(edges.m, edges.m, edges.src.cpu().numpy(),
                        edges.dst.cpu().numpy(), wt)
    return from_edges(data, symmetrize=bool(cfg["symmetrize"]),
                      remove_self_loops=bool(cfg["remove_self_loops"]),
                      dedup=bool(cfg["dedup"]))


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cfg: dict, seed: int, device, uses: list, phases: dict):
    """Set-up up to the port's Graph: the configuration's raw edges
    generated from the seed on `device`, the plan of each (kernel module,
    mix) in `uses` drawn from them, then the peak memory reset and the
    Graph built; (edges, plans, graph)."""
    import torch

    from graphbench import generators
    t = time.perf_counter()
    edges = generators.generate(cfg, seed, device)
    plans = [kern.plan(edges, cfg, mix, seed) for kern, mix in uses]
    sync(device)
    phases["generate_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    g = build_graph(edges, cfg)
    phases["graph_build_s"] = time.perf_counter() - t
    return edges, plans, g


def drive(g, kern, mix: dict, plan: dict, seed: int, seconds: float,
          device, phases: dict, *, trace: bool = False,
          t_start: float = None) -> dict:
    """The rest of set-up and the window, the timed path itself: the
    mix's trials on `g`, their first trial (which builds and uploads the
    layouts) and warm-ups, then trials back to back for `seconds` (at
    most TRACE_SECONDS, under torch.profiler, with `trace`).  Returns the
    trial seconds, the window's seconds, the sampled answers, setup_s
    (from `t_start` to the window) and, with `trace`, the trace's
    summary."""
    from graphbench import trace as tracing
    trials = kern.Trials(g, device, mix, plan)
    t = time.perf_counter()
    trials.first()
    sync(device)
    phases["first_trial_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for k in range(trials.warmups):
        trials.warm(k)
    sync(device)
    phases["warm_s"] = time.perf_counter() - t
    setup_s = None if t_start is None else time.perf_counter() - t_start

    sampler = Sampler(mix.get("sample", 0), seed)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if device.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
    try:
        times, starts, window_s = timed_window(
            trials, min(seconds, TRACE_SECONDS) if trace else seconds,
            sampler, lambda: sync(device), record_starts=trace)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    summary = None
    if trace:
        summary = tracing.summary(tracing.device_events(prof), window_s,
                                  len(times), starts)
    return {"times": times, "window_s": window_s, "samples": sampler.items(),
            "setup_s": setup_s, "summary": summary}


def timed_window(trials, seconds: float, sampler: Sampler, sync,
                 record_starts: bool = False):
    """Trials back to back until one returns past `seconds`: (trial
    seconds, trial start times in ns since the epoch when asked, the
    window's seconds)."""
    times, starts = [], []
    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = 0
    while True:
        if record_starts:
            starts.append(time.time_ns())
        a = time.perf_counter()
        out = trials(i)
        sync()
        b = time.perf_counter()
        times.append(b - a)
        sampler.offer(i, out)
        i += 1
        if b >= deadline:
            return times, starts, b - w0


def power_limit() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, *, cfg_override=None,
             t_start: float = T_START):
    """(result dict, lines for standard error) of one run of a cell on
    `device`.  The command line's main() calls it on a CUDA card only;
    tests call it on the CPU at a small scale (cfg_override)."""
    import torch

    from graphbench import peaks, reference
    from graphbench.stats import window_metrics

    cell = manifest.cell(bench, workload)
    cfg = dict(manifest.config(bench, cell["config"]))
    cfg.update(cfg_override or {})
    mix = manifest.mix(cell["traffic"])
    kern = manifest.kernel(mix["kernel"])
    device = torch.device(device)
    on_card = device.type == "cuda"

    phases = {}
    edges, (plan,), g = prepare(cfg, seed, device, [(kern, mix)], phases)
    win = drive(g, kern, mix, plan, seed, seconds, device, phases,
                trace=trace, t_start=t_start)
    times, window_s, summary = win["times"], win["window_s"], win["summary"]
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # free the port's state before the reference runs
    del g
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference.clean_csr(edges.m, edges.src, edges.dst,
                              bool(cfg["symmetrize"]))
    verdict = kern.check(win["samples"], ref, cfg, mix, plan)
    sync(device)
    check_s = time.perf_counter() - t

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run = {"phases": phases, "trace": summary, "graph": ref.stats(),
           "reference": verdict["info"],
           "peaks": peaks.for_device(kind) if on_card else None}
    metrics = {}
    if trace:
        for entry in manifest.per_layer(bench, workload):
            value = manifest.metric(entry["name"]).read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        values = window_metrics(times, window_s)
        values["setup_s"] = win["setup_s"]
        for entry in manifest.end_to_end(bench, workload):
            metrics[entry["name"]] = {"value": values[entry["name"]],
                                      "unit": entry["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(memory_peak)}
    if trace:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    numbers = verdict["numbers"]
    correct = verdict["failed"] == 0 and all(v <= lim
                                             for _, v, lim in numbers)
    result = {"correct": correct, "attempted": len(times),
              "failed": verdict["failed"], "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in numbers}
    lines = [f"graphbench {workload} seed {seed} trace {int(bool(trace))}",
             f"phases {json.dumps(phases)} setup_s {win['setup_s']}",
             f"window {window_s} s, {len(times)} trials, check {check_s} s",
             f"graph {json.dumps(run['graph'])}",
             f"reference {json.dumps(verdict['info'])}"]
    if summary is not None:
        lines.append(f"trace busy_s {summary['busy_s']} kernels "
                     f"{summary['kernels']} copies {summary['copies']}")
    lines += [f"check {name} = {v} (limit {lim})" for name, v, lim in numbers]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m graphbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.load_benchmark()
    cell = manifest.cell(bench, args.workload)
    for key, path in CACHE_ENV.items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    import torch
    available = torch.cuda.is_available()
    count = torch.cuda.device_count() if available else 0
    if count < int(cell["chips"]):
        print(f"graphbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available() = {available}, "
              f"device_count = {count}; no result", file=sys.stderr)
        return 3
    import gardenia_tpu_torch  # noqa: F401  (fails here outside a checkout)
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"graphbench: loaded after the window: {', '.join(bad)}; "
              "no result", file=sys.stderr)
        return 4
    limit = power_limit()
    if limit:
        lines.insert(1, f"card {limit}")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
