"""One module a per-layer metric, found by its name in BENCHMARK.json
(manifest.metric): read(run) -> a number, or None when the run holds
nothing for it to read, and the line then leaves the metric out.

`run` is what run.py gathered:
  phases     {"generate_s", "graph_build_s", "first_trial_s", "warm_s"}
  trace      trace.summary() of the traced window, or None
  graph      reference.RefGraph.stats() of the benchmark's own CSR
  reference  the kernel check's "info" (e.g. pr_iterations)
  peaks      peaks.for_device() of the card, or None
"""
