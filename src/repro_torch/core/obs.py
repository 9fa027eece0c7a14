"""Live engine-health observability: utilization/efficiency accounting,
a scheduler decision journal, and a flight recorder with post-mortem dumps.

The paper's headline numbers — 0.89 average load-balancing efficiency at
≤2.8% overhead — are *offline* quantities in this repro: recomputed by the
bench harness after a run ends.  This module makes them live.  Three parts,
all passive (they observe streams the runtime and server already produce —
no second measurement path, the DESIGN §13 rule):

- :class:`UtilizationMeter` — a streaming consumer of the Introspector's
  package-record stream (attached via the module-level :func:`bus`, the
  same seam ``_trace_execute`` uses).  It keeps rolling windows of busy
  intervals and delivered-token events per DeviceGroup and computes busy/
  idle fractions, per-group work rates, and the paper's co-execution
  efficiency with a straggler attribution (:func:`live_efficiency` in
  ``introspector.py`` holds the math).
- :class:`DecisionJournal` — a bounded ring of structured scheduler
  decision records (placement, migration, admission/deferral, SpecGate
  flips, elastic drain/join): inputs, outcome, reason.  Every record also
  lands as a trace instant when the tracer is enabled, so Perfetto shows
  *why* next to *what*.
- :class:`FlightRecorder` — on a failure (``RunError``, poisoned
  dependents, validation errors surfacing as failed segments) dumps a
  self-contained JSON crash bundle: recent spans, decisions, utilization,
  telemetry, server stats.  :func:`validate_bundle` is the schema checker
  tests and CI share.

Disabled-path contract (mirrors the tracer's): when no meter is attached,
an instrumentation site costs one attribute read (``bus().active``) and
allocates nothing; the journal and recorder only run on decision/failure
paths, never per token.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.introspector import live_efficiency
from repro_torch.core.trace import tracer


def jsonable(obj: Any) -> Any:
    """Best-effort conversion to JSON-serializable structures (numpy
    scalars -> python numbers, sets/tuples/deques -> lists, everything
    unknown -> ``repr``)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Mapping):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset, deque)):
        return [jsonable(v) for v in obj]
    if hasattr(obj, "item"):  # numpy scalar
        try:
            return jsonable(obj.item())
        except Exception:  # noqa: BLE001 — diagnostics must not raise
            pass
    if hasattr(obj, "tolist"):  # numpy array
        try:
            return obj.tolist()
        except Exception:  # noqa: BLE001
            pass
    return repr(obj)


# --------------------------------------------------------------------- bus
class ObsBus:
    """Fan-out point between the Introspector package-record stream and any
    attached utilization meters.  Readers are lock-free: ``active`` is one
    attribute read; attach/detach swap an immutable tuple under a lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._meters: tuple = ()
        self.active = False

    def attach(self, meter: "UtilizationMeter") -> None:
        with self._lock:
            if meter not in self._meters:
                self._meters = self._meters + (meter,)
            self.active = True

    def detach(self, meter: "UtilizationMeter") -> None:
        with self._lock:
            self._meters = tuple(m for m in self._meters if m is not meter)
            self.active = bool(self._meters)

    def record(self, rec) -> None:
        """Forward one PackageRecord-shaped object (``device``,
        ``t_enqueue``, ``t_end``, ``size_wi``) to every attached meter.
        Meter exceptions are swallowed — observability must never fail a
        run (the Introspector sink gives the same guarantee)."""
        for m in self._meters:
            try:
                m.note_interval(rec.device, rec.t_enqueue, rec.t_end,
                                rec.size_wi)
            except Exception:  # noqa: BLE001
                pass


_BUS = ObsBus()


def bus() -> ObsBus:
    """The process-wide observability bus the runtime's Introspector sink
    forwards package records into."""
    return _BUS


# ------------------------------------------------------------------- meter
class UtilizationMeter:
    """Rolling-window busy/idle accounting per DeviceGroup.

    Two input streams: *busy intervals* (package enqueue→end from the
    Introspector stream, via the bus) and *delivered-token events* (the
    server notes each harvested segment's emitted tokens).  ``snapshot``
    reduces both to per-group busy fractions, work rates (work items per
    busy second — the relative-speed signal the paper's schedulers use),
    token rates, and the live co-execution efficiency + straggler
    attribution (:func:`repro_torch.core.introspector.live_efficiency`).
    """

    def __init__(self, window_s: float = 30.0, *, max_events: int = 8192,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.window_s = float(window_s)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._iv: Dict[str, deque] = {}   # group -> (t0, t1, size_wi)
        self._tok: Dict[str, deque] = {}  # group -> (t, n_tokens)
        self._max_events = int(max_events)

    def now(self) -> float:
        return self._clock()

    # ----------------------------------------------------------- ingestion
    def note_interval(self, group: str, t0: float, t1: float,
                      size: float = 0.0) -> None:
        """One busy interval on ``group`` (tracer/perf_counter clock)."""
        with self._lock:
            dq = self._iv.get(group)
            if dq is None:
                dq = self._iv[group] = deque(maxlen=self._max_events)
            dq.append((float(t0), float(max(t0, t1)), float(size)))

    def note_tokens(self, group: str, n: int,
                    t: Optional[float] = None) -> None:
        """``n`` tokens delivered by ``group`` at time ``t`` (now)."""
        if n <= 0:
            return
        with self._lock:
            dq = self._tok.get(group)
            if dq is None:
                dq = self._tok[group] = deque(maxlen=self._max_events)
            dq.append((self._clock() if t is None else float(t), float(n)))

    def forget(self, group: str) -> None:
        """Drop a group's windows outright (elastic scale-down beyond
        drain; normally drained members just age out of the window)."""
        with self._lock:
            self._iv.pop(group, None)
            self._tok.pop(group, None)

    # ------------------------------------------------------------ reduction
    @staticmethod
    def _union_busy(ivs: Sequence[tuple], lo: float, hi: float) -> tuple:
        """(union seconds, total work items) of intervals clipped to
        [lo, hi].  Intervals may overlap (pipelined dispatch)."""
        busy = 0.0
        work = 0.0
        cur0 = cur1 = None
        for t0, t1, size in sorted(ivs):
            if t1 <= lo or t0 >= hi:
                continue
            work += size
            a, b = max(t0, lo), min(t1, hi)
            if cur1 is None:
                cur0, cur1 = a, b
            elif a <= cur1:
                cur1 = max(cur1, b)
            else:
                busy += cur1 - cur0
                cur0, cur1 = a, b
        if cur1 is not None:
            busy += cur1 - cur0
        return busy, work

    def snapshot(self, groups: Sequence[str], *,
                 rates: Optional[Mapping[str, Optional[float]]] = None,
                 watts: Optional[Mapping[str, float]] = None,
                 draining: Optional[set] = None,
                 now: Optional[float] = None) -> dict:
        """Point-in-time utilization/efficiency view over ``groups``.

        ``rates`` (optional) are the scheduler's observed capacity rates
        (tokens/s at full occupancy, ``ServiceModel.rate``); when absent a
        group's relative speed falls back to its measured work-item rate
        while busy.  Draining members are reported but excluded from the
        efficiency/straggler reduction (they are *meant* to idle).  Every
        division is guarded: no NaN/inf ever appears in the result.
        """
        now = self._clock() if now is None else now
        lo = now - self.window_s
        # Horizon: how much wall clock the window actually observed (a
        # young meter has seen less than window_s).
        horizon = max(1e-9, min(self.window_s, now - self._t0))
        draining = draining or set()
        with self._lock:
            ivs = {g: list(self._iv.get(g, ())) for g in groups}
            toks = {g: list(self._tok.get(g, ())) for g in groups}
        per: Dict[str, dict] = {}
        for g in groups:
            busy, work = self._union_busy(ivs[g], lo, now)
            n_tok = sum(n for t, n in toks[g] if t >= lo)
            rate = rates.get(g) if rates else None
            per[g] = {
                "busy_s": busy,
                "busy_fraction": min(1.0, busy / horizon),
                "work_items": work,
                "work_rate": (work / busy) if busy > 0 else None,
                "tokens": n_tok,
                "tokens_per_s": n_tok / horizon,
                "capacity_rate": (float(rate) if rate
                                  else ((n_tok / busy) if busy > 0 else None)),
                "watts": float(watts.get(g, 0.0) or 0.0) if watts else 0.0,
                "draining": g in draining,
            }
        eff = live_efficiency({g: d for g, d in per.items()
                               if not d["draining"]})
        delivered = sum(d["tokens"] for d in per.values()) / horizon
        return {
            "enabled": True,
            "window_s": self.window_s,
            "horizon_s": horizon,
            "groups": per,
            "tokens_per_s": delivered,
            **eff,
        }


# ----------------------------------------------------------------- journal
class DecisionJournal:
    """Bounded ring of structured scheduler-decision records.

    Each record is a flat-ish dict: ``seq`` (monotonic), ``t`` (monotonic
    clock — the request/deadline clock), ``kind`` (placement | migration |
    admission | spec_gate | elastic), plus the decision's inputs/outcome/
    reason.  Recording also emits a ``decision`` trace instant on the
    ``sched`` track when the tracer is enabled, so the journal and the
    trace never disagree about what was decided when."""

    def __init__(self, cap: int = 256,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._q: deque = deque(maxlen=int(cap))
        self._lock = threading.Lock()
        self._clock = clock
        self._counts: Dict[str, int] = {}
        self._n = 0

    def record(self, kind: str, **fields) -> dict:
        rec = {"seq": None, "t": self._clock(), "kind": kind, **fields}
        with self._lock:
            rec["seq"] = self._n
            self._n += 1
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._q.append(rec)
        tr = tracer()
        if tr.enabled:
            tr.instant("decision", track="sched", **jsonable(rec))
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def snapshot(self, last: int = 64) -> dict:
        with self._lock:
            return {
                "total": self._n,
                "counts": dict(sorted(self._counts.items())),
                "recent": [dict(r) for r in list(self._q)[-last:]],
            }


# ---------------------------------------------------------- flight recorder
_BUNDLE_SCHEMA = "enginecl-postmortem/1"
_BUNDLE_REQUIRED = {
    "schema": str, "reason": str, "t_wall": (int, float), "pid": int,
    "context": dict, "stats": dict, "efficiency": dict, "decisions": dict,
    "telemetry": dict, "recent_spans": list,
}


def validate_bundle(doc) -> List[str]:
    """Schema check for a post-mortem bundle (empty list = valid) — the
    contract tests and CI's injected-failure step assert."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["bundle is not an object"]
    for key, typ in _BUNDLE_REQUIRED.items():
        if key not in doc:
            errs.append(f"missing required key {key!r}")
        elif not isinstance(doc[key], typ):
            errs.append(f"key {key!r} has type {type(doc[key]).__name__}, "
                        f"expected {typ}")
    if doc.get("schema") not in (None, _BUNDLE_SCHEMA):
        errs.append(f"unknown schema {doc.get('schema')!r}")
    for i, ev in enumerate(doc.get("recent_spans") or []):
        if not isinstance(ev, dict) or "name" not in ev or "ph" not in ev:
            errs.append(f"recent_spans[{i}]: not a span record")
            break
    dec = doc.get("decisions")
    if isinstance(dec, dict) and not isinstance(dec.get("recent"), list):
        errs.append("decisions.recent missing or not a list")
    return errs


class FlightRecorder:
    """Post-mortem dumper: on failure, writes a self-contained JSON crash
    bundle (recent spans + decisions + utilization + telemetry + server
    stats) and logs its path.  Bounded: at most ``max_dumps`` bundles per
    recorder (a failing segment loop must not fill the disk), each holding
    at most ``span_window`` recent span events."""

    def __init__(self, crash_dir: str = "crashes", *, span_window: int = 256,
                 max_dumps: int = 4) -> None:
        self.crash_dir = crash_dir
        self.span_window = int(span_window)
        self.max_dumps = int(max_dumps)
        self._lock = threading.Lock()
        self._n = 0
        self.last_path: Optional[str] = None

    def _recent_spans(self) -> List[dict]:
        tr = tracer()
        out = []
        for seq, t0, t1, ph, name, track, aid, args in \
                tr.events()[-self.span_window:]:
            ev = {"seq": seq, "t0": t0, "ph": ph, "name": name}
            if t1 is not None:
                ev["t1"] = t1
            if track is not None:
                ev["track"] = track
            if aid is not None:
                ev["id"] = aid
            if args:
                ev["args"] = jsonable(args)
            out.append(ev)
        return out

    def dump(self, reason: str, *, context: Optional[dict] = None,
             stats: Optional[dict] = None, efficiency: Optional[dict] = None,
             decisions: Optional[dict] = None,
             telemetry: Optional[dict] = None) -> Optional[str]:
        """Write one bundle; returns its path (None once ``max_dumps`` is
        exhausted).  Never raises — a post-mortem that crashes the crash
        path would be worse than no post-mortem."""
        with self._lock:
            if self._n >= self.max_dumps:
                return None
            n = self._n
            self._n += 1
        try:
            bundle = {
                "schema": _BUNDLE_SCHEMA,
                "reason": str(reason),
                "t_wall": time.time(),
                "pid": os.getpid(),
                "context": jsonable(context or {}),
                "stats": jsonable(stats or {}),
                "efficiency": jsonable(efficiency or {}),
                "decisions": jsonable(decisions or {"total": 0, "counts": {},
                                                    "recent": []}),
                "telemetry": jsonable(telemetry or {}),
                "recent_spans": self._recent_spans(),
            }
            errs = validate_bundle(bundle)
            if errs:  # self-check: a malformed bundle is a bug, note it
                bundle["self_check"] = errs
            os.makedirs(self.crash_dir, exist_ok=True)
            path = os.path.join(
                self.crash_dir, f"postmortem-{os.getpid()}-{n}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1)
            self.last_path = path
            print(f"[flight-recorder] {reason}: post-mortem bundle -> {path}",
                  file=sys.stderr, flush=True)
            return path
        except Exception:  # noqa: BLE001
            return None


# ----------------------------------------------------------------- facade
class EngineObs:
    """One server's observability bundle: a utilization meter (attached to
    the process bus while the server lives), a decision journal, and a
    flight recorder.  ``enabled`` gates the continuous accounting (meter +
    journal + counter tracks); the flight recorder is always armed — it
    only runs on failure paths."""

    def __init__(self, *, enabled: bool = True, window_s: float = 30.0,
                 journal_cap: int = 256, crash_dir: str = "crashes",
                 max_dumps: int = 4) -> None:
        self.enabled = bool(enabled)
        self.meter = UtilizationMeter(window_s)
        self.journal = DecisionJournal(journal_cap)
        self.recorder = FlightRecorder(crash_dir, max_dumps=max_dumps)

    def attach(self) -> "EngineObs":
        if self.enabled:
            bus().attach(self.meter)
        return self

    def detach(self) -> None:
        bus().detach(self.meter)

    def decision(self, kind: str, **fields) -> None:
        if self.enabled:
            self.journal.record(kind, **fields)

    def postmortem(self, reason: str, *, context: Optional[dict] = None,
                   stats: Optional[dict] = None,
                   efficiency: Optional[dict] = None,
                   telemetry: Optional[dict] = None) -> Optional[str]:
        return self.recorder.dump(
            reason, context=context, stats=stats, efficiency=efficiency,
            decisions=self.journal.snapshot(), telemetry=telemetry)
