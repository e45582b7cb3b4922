"""The benchmark's graph generators, on the device, from the run's seed.

A configuration's `generator` names a module of this package, found by
name (manifest.generator), with one function:

    edges(cfg, gen, device) -> (src, dst)   int32 raw directed edges of
                                            2^scale vertices, drawn from
                                            the torch.Generator `gen`

Self-loops and duplicates stay in: cleaning (and symmetrizing) is the
consumer's job, the port's `from_edges` on one side and reference.py on
the other.  The same seed on the same device gives the same edges.

What every generator shares is done here:

  structure_seed — a configuration that names one draws its edges from
      that seed and takes from the run's seed only a permutation of the
      vertex ids: every run then has the same degrees, so the same layout
      sizes and the same work, in another order.  urand20 needs it: which
      degree buckets its ELL remainder gets moves with the graph (one more
      bucket once a degree passes 64), and with it the trial's launches
      and time.
  max_weight — a configuration that names one gets a weight for every
      raw edge, a whole number uniform in [1, max_weight] (GAP's rule for
      SSSP, the port's core/generate.generate_graph), from a stream of
      its own, so the edges are the same with or without weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Edges:
    """A raw edge list as both sides take it."""
    m: int                          # vertices
    src: torch.Tensor               # int32[nnz]
    dst: torch.Tensor               # int32[nnz]
    wt: Optional[torch.Tensor]      # float64[nnz], or None


def device_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def generate(cfg: dict, seed: int, device) -> Edges:
    """The raw edges of configuration `cfg` on `device`."""
    from graphbench import manifest
    fixed = cfg.get("structure_seed")
    gen = device_generator(seed if fixed is None else fixed, device)
    src, dst = manifest.generator(cfg["generator"]).edges(cfg, gen, device)
    m = 1 << int(cfg["scale"])
    if fixed is not None:
        perm = torch.randperm(m, generator=device_generator(seed, device),
                              device=device).to(torch.int32)
        src, dst = perm[src.long()], perm[dst.long()]
    wt = None
    if cfg.get("max_weight") is not None:
        wt = torch.randint(1, int(cfg["max_weight"]) + 1, (src.numel(),),
                           generator=device_generator(int(seed) + 1, device),
                           device=device).to(torch.float64)
    return Edges(m, src, dst, wt)
