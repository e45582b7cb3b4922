"""Reporting, timing and checkpointing helpers (torch counterparts of
gardenia_tpu.utils)."""

from gardenia_tpu_torch.utils.timer import Timer, time_op
from gardenia_tpu_torch.utils.report import report_runtime

__all__ = ["Timer", "time_op", "report_runtime"]
