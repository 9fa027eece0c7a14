"""Scheduler strategy interface (Tier-3, Strategy pattern).

A scheduler hands out *packages* — contiguous work-item ranges, always in
whole work-groups — to device groups.  The engine drives it from one thread
per device; ``next_package`` must therefore be thread-safe (the base class
provides the lock and remaining-work bookkeeping).
"""
from __future__ import annotations

import threading
from typing import Optional


class Scheduler:
    name = "base"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._remaining = 0  # work-groups not yet handed out
        self._next_group = 0
        self._lws = 1
        self._devices = []

    def clone(self) -> "Scheduler":
        """Fresh scheduler with this one's *configuration* but no run state.

        The runtime clones the engine's scheduler per submitted run, so
        concurrent runs never share `_remaining`/`_next_group` bookkeeping.
        Subclasses with constructor arguments override this."""
        return type(self)()

    # -- lifecycle ---------------------------------------------------------
    def prepare(self, total_groups: int, lws: int, devices) -> None:
        """Arm the scheduler for one run.

        Since the dataflow-submission refactor this is called by the *first
        worker that starts the run* (``RunHandle._ensure_prepared``), not at
        submit time: a run queued behind its dependency chain reads geometry
        and (adaptive) device powers when it actually begins.  Callers must
        not invoke ``next_package`` before ``prepare`` returns; before then
        the package stream reads as exhausted (``_remaining == 0``)."""
        with self._lock:
            self._remaining = total_groups
            self._next_group = 0
            self._lws = lws
            self._devices = list(devices)
            self._prepare()

    def _prepare(self) -> None:  # subclass hook (lock held)
        pass

    # -- package stream ------------------------------------------------------
    def next_package(self, device) -> Optional[tuple[int, int]]:
        """Returns (offset_wi, size_wi) or None when exhausted."""
        with self._lock:
            if self._remaining <= 0:
                return None
            groups = self._package_groups(device)
            groups = max(1, min(groups, self._remaining))
            off = self._next_group
            self._next_group += groups
            self._remaining -= groups
            return off * self._lws, groups * self._lws

    def _package_groups(self, device) -> int:  # subclass hook (lock held)
        raise NotImplementedError

    # -- multi-group placement ----------------------------------------------
    def placement_weights(self, devices, rates=None) -> list:
        """Relative share each device group should receive when work is
        *placed* rather than package-scheduled (serving join waves, slot
        counts).  Adaptive schedulers weight by observed rate (falling back
        to the static power prior), divided by the device's watts rating
        when set; ``Static`` overrides this to ignore rates entirely.

        ``rates`` maps device name → observed throughput (or None)."""
        from repro_torch.core.rating import placement_weight

        rates = rates or {}
        return [placement_weight(rates.get(d.name), power=d.power,
                                 watts=getattr(d, "watts", 0.0))
                for d in devices]

    def rebalances(self) -> bool:
        """True when this scheduler wants decode slots migrated between
        groups at segment boundaries (adaptive strategies only — Static's
        contract is a fixed split)."""
        return False

    # -- adaptive powers ----------------------------------------------------
    def observe(self, device, size_wi: int, seconds: float) -> None:
        """Optional feedback after each completed package (adaptive).

        ``seconds`` is the package's *device service time* — dispatch to
        completion, excluding host write-back.  Feeding write-back time here would skew
        ``HGuided(adaptive=True)``/``ThroughputRater`` against groups whose
        packages happen to be written back on slower host paths."""

    @property
    def total_power(self) -> float:
        return sum(d.power for d in self._devices)
