"""HGuided scheduler (paper §5.3): heterogeneity-aware guided self-scheduling.

    packet_size_i = floor( Gr * P_i / (k * n * sum_j P_j) )

Gr = remaining work-groups (updated on every launch), P_i = compute power of
the requesting device, n = number of devices, k = shrink constant.  Bounded
below by a per-device minimum package size (scaled by power).  Large packages
first → few synchronization points; small tail packages → all devices finish
together.

``adaptive=True`` additionally re-rates powers online from observed package
throughput (EMA) — the EngineCL "computing power" parameter made
self-tuning, which doubles as straggler mitigation at pod scale.
"""
from __future__ import annotations

from repro_torch.core.rating import ThroughputRater
from repro_torch.core.scheduler.base import Scheduler


class HGuided(Scheduler):
    name = "hguided"

    def __init__(self, k: float = 2.0, adaptive: bool = False) -> None:
        super().__init__()
        self.k = k
        self.adaptive = adaptive
        self._rater = ThroughputRater()

    def clone(self) -> "HGuided":
        return HGuided(self.k, self.adaptive)

    def _prepare(self) -> None:
        if self.adaptive:
            self._rater.reset({id(d): d.power for d in self._devices})

    def _power(self, device) -> float:
        if self.adaptive:
            return self._rater.power(id(device))
        return device.power

    def _package_groups(self, device) -> int:
        n = len(self._devices)
        tot = sum(self._power(d) for d in self._devices)
        p = self._power(device)
        groups = int(self._remaining * p / (self.k * n * tot))
        # Minimum package scales with power RELATIVE to the mean (powers may
        # be absolute throughputs when adaptive).
        p_rel = p * n / tot if tot > 0 else 1.0
        min_groups = max(1, int(round(device.min_package_groups * p_rel)))
        return max(min_groups, groups)

    def rebalances(self) -> bool:
        return True

    def observe(self, device, size_wi: int, seconds: float) -> None:
        if self.adaptive and seconds > 0:
            self._rater.update(id(device), size_wi / seconds)
