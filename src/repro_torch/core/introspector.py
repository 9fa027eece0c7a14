"""Introspector: per-package execution traces + the paper's metrics.

Records every package (device, offset, size, enqueue/start/end times) and
derives the validation metrics of §7.3/§8:

    balance    = T_FD / T_LD          (first-finisher / last-finisher)
    speedup    = T_baseline / T_coexec
    S_max      = sum(T_i) / max(T_i)   (per single-device response times)
    efficiency = S_real / S_max
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class PackageRecord:
    device: str
    offset_wi: int
    size_wi: int
    t_enqueue: float
    t_start: float
    t_end: float

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


class Introspector:
    """Per-run package recorder.  ``sink`` (optional) is a streaming
    channel: every record is forwarded to it right after being stored —
    the runtime points it at the span tracer so per-package execute spans
    appear in traces without a second measurement path.  All readers
    snapshot ``records`` under ``_lock``: workers append concurrently."""

    def __init__(self, sink: Optional[Callable[[PackageRecord], None]]
                 = None) -> None:
        self._lock = threading.Lock()
        self.records: List[PackageRecord] = []
        self.t_run_start: float = 0.0
        self.t_run_end: float = 0.0
        self.counters: Dict[str, dict] = {}  # device -> transfer counters
        self._sink = sink

    def start_run(self) -> None:
        with self._lock:
            self.records = []
            self.counters = {}
            self.t_run_start = time.perf_counter()

    def end_run(self) -> None:
        with self._lock:
            self.t_run_end = time.perf_counter()

    def record(self, rec: PackageRecord) -> None:
        with self._lock:
            self.records.append(rec)
        if self._sink is not None:
            try:
                self._sink(rec)
            except Exception:  # noqa: BLE001 — observability must never
                pass  # fail the run it observes

    def record_counters(self, device: str, transfers: int,
                        cache_hits: int) -> None:
        """Per-run host→device transfer accounting: the runtime snapshots
        each group's cumulative counters around its portion of the run and
        reports the delta here, so ``RunHandle.metrics`` (and the serving
        layer's ``InferenceServer.metrics``) can attribute transfers and
        cache hits to individual runs, not just group lifetimes."""
        with self._lock:
            d = self.counters.setdefault(
                device, {"transfers": 0, "cache_hits": 0}
            )
            d["transfers"] += transfers
            d["cache_hits"] += cache_hits

    # ------------------------------------------------------------ metrics
    @property
    def response_time(self) -> float:
        with self._lock:
            return self.t_run_end - self.t_run_start

    @staticmethod
    def _per_device(records: List[PackageRecord],
                    t_run_start: float) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for r in records:
            d = out.setdefault(
                r.device,
                {"packages": 0, "work_items": 0, "busy": 0.0, "finish": 0.0, "chunks": []},
            )
            d["packages"] += 1
            d["work_items"] += r.size_wi
            d["busy"] += r.seconds
            d["finish"] = max(d["finish"], r.t_end - t_run_start)
            d["chunks"].append((r.offset_wi, r.size_wi, r.t_start - t_run_start, r.seconds))
        return out

    def per_device(self) -> Dict[str, dict]:
        with self._lock:
            records = list(self.records)
            t0 = self.t_run_start
        return self._per_device(records, t0)

    @staticmethod
    def _balance(per: Dict[str, dict]) -> float:
        if len(per) < 2:
            return 1.0
        finishes = [d["finish"] for d in per.values()]
        return min(finishes) / max(finishes) if max(finishes) > 0 else 1.0

    @staticmethod
    def _work_share(per: Dict[str, dict]) -> Dict[str, float]:
        tot = sum(d["work_items"] for d in per.values()) or 1
        return {k: d["work_items"] / tot for k, d in per.items()}

    def balance(self) -> float:
        return self._balance(self.per_device())

    def work_share(self) -> Dict[str, float]:
        return self._work_share(self.per_device())

    def summary(self) -> dict:
        # One consistent snapshot: records, run window, and counters are
        # read under the lock together, then every derived metric is
        # computed from that snapshot (a worker appending mid-summary can
        # not skew balance against n_packages).
        with self._lock:
            records = list(self.records)
            t0, t1 = self.t_run_start, self.t_run_end
            counters = {k: dict(v) for k, v in self.counters.items()}
        per = self._per_device(records, t0)
        return {
            "response_time": t1 - t0,
            "balance": self._balance(per),
            "work_share": self._work_share(per),
            "per_device": {
                k: {kk: vv for kk, vv in v.items() if kk != "chunks"}
                for k, v in per.items()
            },
            "n_packages": len(records),
            "transfers": counters,
        }


def coexec_metrics(device_times: Dict[str, float], coexec_time: float) -> dict:
    """speedup / S_max / efficiency given single-device baselines."""
    t_fastest = min(device_times.values())
    s_max = sum(t_fastest / t for t in device_times.values())
    s_real = t_fastest / coexec_time if coexec_time > 0 else 0.0
    return {
        "baseline_device": min(device_times, key=device_times.get),
        "speedup": s_real,
        "s_max": s_max,
        "efficiency": s_real / s_max if s_max > 0 else 0.0,
    }


def live_efficiency(util: Dict[str, dict]) -> dict:
    """The paper's load-balancing efficiency from *live* serving signals.

    ``util`` maps each co-executing member to a dict with at least
    ``busy_fraction`` (rolling-window busy time / window) and one speed
    signal — ``capacity_rate`` (observed tokens/s at full occupancy,
    preferred) falling back to ``work_rate`` (work items per busy second).
    Optional ``watts`` (rated board power, 0 = unrated) refines the
    straggler attribution.

    Offline, efficiency is ``S_real / S_max``: achieved speedup over the
    best achievable given each device's standalone speed.  Live, the same
    quantity is the capacity-weighted utilization —

        efficiency = sum_i(c_i * u_i) / sum_i(c_i)

    — i.e. actual aggregate work rate over the rate the ensemble would
    sustain with every member fully busy.  Each member's standalone run
    delivers ~``c_i`` (a saturated standalone group is busy nearly all
    the time), while co-executed it delivers ``c_i * u_i`` — so this
    ratio tracks the offline ``together / (sum of alone)`` measurement
    directly, idle time and all (the BENCH_serve multigroup cell gates
    their agreement at 5%).  When co-execution is perfect every member
    stays saturated and efficiency is ~1; a lagging member drags it down
    by its capacity share times its idleness.  ``balance`` is the
    paper's T_FD/T_LD analog (min/max busy fraction).

    The straggler attribution answers *why* the laggard lags: ``rate``
    (it is simply the slowest member — its observed work rate is the
    minimum), ``watts`` (perf-per-watt placement deliberately starves the
    highest-rated board), or ``placement`` (speed does not explain it —
    the scheduler underfed it).  Returns None fields (never NaN) when
    fewer than one member has data."""
    members = {}
    for name, d in util.items():
        u = d.get("busy_fraction")
        c = d.get("capacity_rate") or d.get("work_rate")
        if u is None or c is None or c <= 0:
            continue
        members[name] = (float(u), float(c), float(d.get("watts") or 0.0))
    out = {"efficiency": None, "balance": None, "straggler": None,
           "members": sorted(members)}
    if not members:
        return out
    us = {n: u for n, (u, _, _) in members.items()}
    u_max = max(us.values())
    if u_max <= 0:
        return out
    total_c = sum(c for _, c, _ in members.values())
    out["efficiency"] = (sum(u * c for u, c, _ in members.values())
                         / total_c)
    out["balance"] = min(us.values()) / u_max
    if len(members) > 1:
        lag = min(us, key=us.get)
        u, c, w = members[lag]
        # Attribution only when the lag is material (>5% behind the lead).
        if u < 0.95 * u_max:
            if c <= min(cc for _, cc, _ in members.values()):
                reason = "rate"
            elif w and w >= max(ww for _, _, ww in members.values()):
                reason = "watts"
            else:
                reason = "placement"
            out["straggler"] = {
                "member": lag, "reason": reason,
                "busy_fraction": u, "lead_busy_fraction": u_max,
                "capacity_share": c / total_c if total_c > 0 else None,
                "watts": w or None,
            }
    return out
