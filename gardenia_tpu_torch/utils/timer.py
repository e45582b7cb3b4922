"""Wall-clock timing with device completion semantics.

Counterpart of gardenia_tpu/utils/timer.py (reference include/timer.h).
PyTorch returns from a CUDA call before the device finishes, so on a CUDA
device the timed region is bracketed by torch.cuda.synchronize(): the
number includes the device's work, as the reference's Timer does after
cudaDeviceSynchronize.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    def __init__(self, device):
        self.device = device
        self._start = 0.0
        self.seconds = 0.0

    def start(self):
        _sync(self.device)
        self._start = time.perf_counter()

    def stop(self):
        _sync(self.device)
        self.seconds = time.perf_counter() - self._start
        return self.seconds

    def millisecs(self) -> float:
        return self.seconds * 1e3


def time_op(fn: Callable[[], Any], *, device, warmup: int = 1,
            iters: int = 1) -> Tuple[Any, float]:
    """Run fn `warmup` times untimed, then `iters` timed; return
    (last result, best seconds).  `device` is the one fn solves on, and
    has no default: a CUDA solve timed without its synchronize would
    measure the enqueue."""
    result = None
    for _ in range(max(0, warmup)):
        result = fn()
    _sync(device)
    best = float("inf")
    timer = Timer(device)
    for _ in range(max(1, iters)):
        timer.start()
        result = fn()
        best = min(best, timer.stop())
    return result, best
