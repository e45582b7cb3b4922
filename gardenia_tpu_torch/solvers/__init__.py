"""Solvers of the port, one module per GARDENIA kernel (slice 1: pr,
slice 2: tc)."""
