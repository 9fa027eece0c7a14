"""Dynamic scheduler: fixed number of equal packages, master work queue
(paper §5.3).  Adapts to irregular kernels; each package completion is a
synchronization point, so many packages = overhead (the paper's trade-off)."""
from __future__ import annotations

from repro_torch.core.scheduler.base import Scheduler


class Dynamic(Scheduler):
    name = "dynamic"

    def __init__(self, num_packages: int = 50) -> None:
        super().__init__()
        self.num_packages = max(1, num_packages)
        self._pkg_groups = 1

    def clone(self) -> "Dynamic":
        return Dynamic(self.num_packages)

    def _prepare(self) -> None:
        total = self._remaining
        self._pkg_groups = max(1, -(-total // self.num_packages))

    def _package_groups(self, device) -> int:
        return self._pkg_groups

    def rebalances(self) -> bool:
        return True
