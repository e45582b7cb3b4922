"""Reporting and timing helpers (torch counterparts of
gardenia_tpu.utils)."""
