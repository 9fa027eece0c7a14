"""Static scheduler: one package per device, proportional split (paper §5.3).

Splits the dataset before execution using known compute powers (or explicit
proportions).  Minimal synchronization, best for regular kernels; not
adaptive — the paper's Mandelbrot imbalance case reproduces exactly.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.scheduler.base import Scheduler


class Static(Scheduler):
    name = "static"

    def __init__(self, props: Optional[Sequence[float]] = None, reverse: bool = False) -> None:
        super().__init__()
        self.props = list(props) if props is not None else None
        self.reverse = reverse
        self._plan: dict[int, tuple[int, int]] = {}

    def clone(self) -> "Static":
        return Static(self.props, self.reverse)

    def _prepare(self) -> None:
        devs = list(self._devices)
        if self.reverse:
            devs = devs[::-1]
        if self.props is not None:
            # Paper semantics: first N-1 devices get explicit fractions, the
            # last one the remainder (props may also cover all devices).
            props = list(self.props)
            if len(props) == len(devs) - 1:
                props.append(max(0.0, 1.0 - sum(props)))
        else:
            tot = sum(d.power for d in devs)
            props = [d.power / tot for d in devs]
        total = self._remaining
        self._plan.clear()
        off = 0
        for i, (d, p) in enumerate(zip(devs, props)):
            groups = int(round(total * p)) if i < len(devs) - 1 else total - off
            groups = max(0, min(groups, total - off))
            self._plan[id(d)] = (off, groups)
            off += groups

    def placement_weights(self, devices, rates=None) -> list:
        """Static ignores observed rates: the split is fixed up front from
        explicit proportions (or power priors), per the paper's contract."""
        devs = list(devices)
        if self.props is not None:
            props = list(self.props)
            if len(props) == len(devs) - 1:
                props.append(max(0.0, 1.0 - sum(props)))
            return [max(0.0, p) for p in props[: len(devs)]]
        return [d.power for d in devs]

    def _package_groups(self, device) -> int:
        raise AssertionError("Static overrides next_package")

    def next_package(self, device):
        with self._lock:
            ent = self._plan.pop(id(device), None)
            if ent is None or ent[1] == 0:
                return None
            off, groups = ent
            self._remaining -= groups
            return off * self._lws, groups * self._lws
