"""Label indexes for labelled-graph mining; torch counterpart of
gardenia_tpu/mining/labels.py.

Reference: the mining Graph builds label frequency and NLF
(neighbour-label-frequency) indexes for candidate filtering
(include/graph.hh, SURVEY.md §2.1).  The frequency is a numpy bincount,
the NLF one index_add_ over the graph's edge list; `default_labels` gives
the labels FSM mines when none are given.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import views


def default_labels(g, labels=None) -> np.ndarray:
    """The labels FSM mines: the given ones, else g.vlabels, else the
    degree buckets min(deg, 10) (the converter's labelling fallback),
    int64."""
    if labels is None:
        labels = g.vlabels
    if labels is None:
        labels = np.minimum(g.degrees, 10)
    return np.asarray(labels, dtype=np.int64)


def label_frequency(labels, num_labels: int) -> np.ndarray:
    """Count of vertices per label (graph.hh label frequency index)."""
    return np.bincount(np.asarray(labels, np.int64),
                       minlength=num_labels)


def nlf_index(g, labels, num_labels: int, device="cuda") -> torch.Tensor:
    """int32 (m, num_labels): NLF[v, l] = number of neighbours of v with
    label l — the classic subgraph-query pruning index: a query vertex q
    can map to v only if NLF[v] >= NLF_query[q] elementwise."""
    dev = resolve_device(device)
    src, dst = views.coo(g, dev)
    lab = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    flat = src.long() * num_labels + lab[dst.long()]
    table = torch.zeros(g.m * num_labels, dtype=torch.int32, device=dev)
    table.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return table.view(g.m, num_labels)


def nlf_filter(nlf: torch.Tensor, query_nlf_row) -> torch.Tensor:
    """bool[m]: vertices whose NLF dominates the query vertex's."""
    q = torch.as_tensor(np.array(query_nlf_row), device=nlf.device)
    return torch.all(nlf >= q[None, :], dim=1)
