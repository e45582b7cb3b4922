"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import statistics


def percentile(values, p: int) -> float:
    """The p-th percentile (1 <= p <= 99) of all values, by
    statistics.quantiles' inclusive method (linear between order
    statistics; the median at p = 50)."""
    values = list(values)
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100,
                                      method="inclusive")[p - 1])


def window_metrics(trial_s, window_s: float) -> dict:
    """trials_per_s, trial_ms_p50 and trial_ms_p95 of one window: every
    trial it ran, over all of its seconds."""
    ms = [t * 1e3 for t in trial_s]
    return {"trials_per_s": len(ms) / window_s,
            "trial_ms_p50": percentile(ms, 50),
            "trial_ms_p95": percentile(ms, 95)}
