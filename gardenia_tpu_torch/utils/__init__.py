"""Reporting and timing helpers (torch counterparts of gardenia_tpu.utils,
whose package import pulls in jax)."""
