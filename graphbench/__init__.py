"""graphbench — the benchmark of gardenia_tpu_torch on one NVIDIA card.

GAP-style trials (Beamer, Asanovic, Patterson, arXiv:1508.03619): a graph
is generated on the card from the run's seed and loaded once, then one
caller runs whole solves back to back, each timed on the host clock up to
`torch.cuda.synchronize()`.  One command runs one cell once:

    python3 -m graphbench.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

and prints one JSON object as the last line of its standard output.

Everything that belongs to one configuration, traffic mix, solver or
per-layer metric lives in a file of its own, found by the name that
BENCHMARK.json gives:

    configs/<config>.json   the graph: generator, scale, edge factor
    generators/<gen>.py     edges(cfg, gen, device): the raw edges of a
                            configuration's generator
    mixes/<traffic>.json    the trials: solver, its arguments, sources
    kernels/<kernel>.py     the calls into the port, the check of their
                            answers against reference.py, and the control
    metrics/<metric>.py     read(run) -> a per-layer number, or None

The reference (reference.py) is plain PyTorch; it imports nothing of the
port.  Nothing here imports jax, jaxlib or the JAX package gardenia_tpu.
"""
