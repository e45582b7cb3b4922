"""Host graph code of the port — copies of gardenia_tpu/core (types, build,
io, graph, generate, relabel) — and the torch device views (views.py)."""

from gardenia_tpu_torch.core.graph import Graph, load_graph

__all__ = ["Graph", "load_graph"]
