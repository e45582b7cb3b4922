"""Reporting, timing and checkpointing helpers (torch counterparts of
gardenia_tpu.utils)."""
