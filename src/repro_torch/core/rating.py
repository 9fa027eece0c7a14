"""EMA throughput rating — adaptive compute powers / straggler mitigation.

The paper passes static "computing power" parameters to HGuided; at fleet
scale powers drift (shared hosts, thermal throttling, degraded pods), so we
re-rate from observed throughput.  Used by HGuided(adaptive=True) and by the
heterogeneous trainer (between-step re-partitioning).
"""
from __future__ import annotations

import threading
from typing import Dict


def placement_weight(rate, *, power: float = 1.0, watts: float = 0.0) -> float:
    """One device's placement weight from its observed rate and rating.

    ``rate`` (tokens/s or work-items/s) wins when observed; before any
    observation the static ``power`` prior stands in.  A non-zero ``watts``
    rating divides the weight — placement then optimizes perf-per-watt
    (Green Computing survey) instead of raw throughput."""
    w = rate if (rate is not None and rate > 0.0) else max(power, 1e-9)
    if watts > 0.0:
        w = w / watts
    return w


class ThroughputRater:
    def __init__(self, alpha: float = 0.4) -> None:
        self.alpha = alpha
        self._lock = threading.Lock()
        self._prior: Dict[int, float] = {}
        self._rate: Dict[int, float] = {}
        self._scale: float = 0.0  # throughput units per prior-power unit

    def reset(self, priors: Dict[int, float]) -> None:
        with self._lock:
            self._prior = dict(priors)
            self._rate = {}
            self._scale = 0.0

    def update(self, key: int, throughput: float) -> None:
        with self._lock:
            if self._scale == 0.0:
                # Calibrate priors of not-yet-observed devices to the same
                # units as measured throughput.
                self._scale = throughput / max(self._prior.get(key, 1.0), 1e-12)
            old = self._rate.get(key)
            self._rate[key] = throughput if old is None else (
                self.alpha * throughput + (1 - self.alpha) * old
            )

    def power(self, key: int) -> float:
        with self._lock:
            if key in self._rate:
                return self._rate[key]
            p = self._prior.get(key, 1.0)
            return p * self._scale if self._scale > 0 else p

    def normalized(self) -> Dict[int, float]:
        with self._lock:
            src = {**self._prior, **self._rate}
            tot = sum(src.values()) or 1.0
            return {k: v / tot for k, v in src.items()}
