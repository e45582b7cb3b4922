"""Torch views of the shared host Graph (gardenia_tpu.core.graph.Graph)."""
