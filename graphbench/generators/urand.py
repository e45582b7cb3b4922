"""Erdos-Renyi, a frozen torch copy of the port's
core/generate.uniform_edges rule: both endpoints uniform over the
vertices.  Keys: scale, edge_factor."""

from __future__ import annotations

import torch


def edges(cfg: dict, gen: torch.Generator, device):
    m = 1 << int(cfg["scale"])
    ends = torch.randint(0, m, (2, m * int(cfg["edge_factor"])),
                         generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)
    return ends[0], ends[1]
