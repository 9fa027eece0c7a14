"""Span tracing: a thread-safe, lock-light ring buffer of trace events with
Chrome trace-event export (loadable in Perfetto / chrome://tracing).

The paper validates EngineCL by introspecting every package's enqueue/
start/end (§7.3); this module generalizes that sensor to the whole stack.
The runtime, the serving batcher, and client threads emit *events* — sync
begin/end spans, self-contained complete spans, instants, and async
(id-correlated) spans that follow one request across threads — into one
shared ring buffer:

- **Lock-light**: emission takes one tiny lock only to reserve a sequence
  number; the slot write happens outside it (slots are keyed by sequence,
  so concurrent writers never share a slot and snapshots filter stale or
  in-flight slots by sequence range).  Disabled tracers cost one attribute
  read per call site.
- **Bounded**: the ring overwrites the oldest events instead of growing —
  tracing a long-lived server cannot leak.  Export *sanitizes* the window:
  orphaned ends (whose begins were overwritten) are dropped and dangling
  begins are closed, so the emitted JSON always has balanced B/E pairs.
- **One track per actor**: device-group workers, the batcher thread, and
  client threads each get their own named track (Chrome ``tid`` plus a
  ``thread_name`` metadata event); request lifecycles ride async spans
  keyed by request sequence number, so one request's admission → chunks →
  segments → exit line up across tracks.

A module-level tracer (disabled by default) is the instrumentation target:
``tracer()`` returns it, ``set_tracer()`` swaps it (benchmarks install a
fresh enabled tracer per measured pass).  ``validate_chrome`` is the schema
checker CI's ``--trace-out`` smoke and tests share.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


def _thread_track() -> str:
    return threading.current_thread().name


class _NullSpan:
    """``span()`` result when tracing is disabled: a free with-block."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_track", "_args")

    def __init__(self, tr: "Tracer", name: str, track: Optional[str],
                 args: dict) -> None:
        self._tr, self._name, self._track, self._args = tr, name, track, args

    def __enter__(self) -> "_Span":
        self._tr.begin(self._name, track=self._track, **self._args)
        return self

    def __exit__(self, *exc) -> bool:
        self._tr.end(self._name, track=self._track)
        return False


class Tracer:
    """Ring-buffer span tracer.

    Events are ``(seq, t0, t1, ph, name, track, aid, args)`` tuples; ``t1``
    is only set for complete ("X") spans, ``aid`` only for async phases.
    The clock defaults to ``time.perf_counter`` — the same clock the
    runtime's package records use, so runtime-measured intervals can be
    re-emitted as complete spans without conversion.
    """

    def __init__(self, capacity: int = 1 << 16, *, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2: {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()
        self._enabled = bool(enabled)
        self._t0 = clock()

    # ------------------------------------------------------------- control
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> "Tracer":
        self._enabled = True
        return self

    def disable(self) -> "Tracer":
        self._enabled = False
        return self

    def now(self) -> float:
        """Current time on this tracer's clock (for ``complete`` callers
        that bracket an interval themselves)."""
        return self._clock()

    def clear(self) -> None:
        with self._lock:
            self._n = 0
            self._slots = [None] * self.capacity
            self._t0 = self._clock()

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound since the last clear."""
        with self._lock:
            return max(0, self._n - self.capacity)

    # ------------------------------------------------------------ emission
    def _emit(self, ph: str, name: str, track: Optional[str],
              aid: Optional[int], t0: float, t1: Optional[float],
              args: dict) -> None:
        with self._lock:
            seq = self._n
            self._n = seq + 1
        # Slot write outside the lock: seq is unique, so writers never race
        # on a slot; a snapshot taken mid-write filters this slot out by its
        # stale (lapped) sequence number.
        self._slots[seq % self.capacity] = (
            seq, t0, t1, ph, name, track, aid, args or None
        )

    def begin(self, name: str, track: Optional[str] = None, **args) -> None:
        if self._enabled:
            self._emit("B", name, track or _thread_track(), None,
                       self._clock(), None, args)

    def end(self, name: str, track: Optional[str] = None, **args) -> None:
        if self._enabled:
            self._emit("E", name, track or _thread_track(), None,
                       self._clock(), None, args)

    def span(self, name: str, track: Optional[str] = None, **args):
        """``with tracer().span("phase"): ...`` — balanced begin/end."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, track, args)

    def instant(self, name: str, track: Optional[str] = None, **args) -> None:
        if self._enabled:
            self._emit("i", name, track or _thread_track(), None,
                       self._clock(), None, args)

    def counter(self, name: str, track: Optional[str] = None,
                **values) -> None:
        """A counter sample ("C" phase): each kwarg is one series of the
        named counter track.  Perfetto/chrome://tracing render successive
        samples as a stacked load curve interleaved with the spans —
        occupancy, blocks in use, tokens/s, efficiency ride these."""
        if self._enabled:
            self._emit("C", name, track or "counters", None,
                       self._clock(), None, values)

    def complete(self, name: str, t0: float, t1: float,
                 track: Optional[str] = None, **args) -> None:
        """A span whose interval the caller measured (``now()`` clock)."""
        if self._enabled:
            self._emit("X", name, track or _thread_track(), None,
                       t0, max(t0, t1), args)

    def async_begin(self, name: str, aid: int, **args) -> None:
        """Open an id-correlated span (e.g. one request's lifetime)."""
        if self._enabled:
            self._emit("b", name, None, aid, self._clock(), None, args)

    def async_instant(self, name: str, aid: int, **args) -> None:
        if self._enabled:
            self._emit("n", name, None, aid, self._clock(), None, args)

    def async_end(self, name: str, aid: int, **args) -> None:
        if self._enabled:
            self._emit("e", name, None, aid, self._clock(), None, args)

    # -------------------------------------------------------------- export
    def events(self) -> List[tuple]:
        """Snapshot of the live ring window, oldest first."""
        with self._lock:
            n = self._n
        lo = max(0, n - self.capacity)
        out = [s for s in self._slots if s is not None and lo <= s[0] < n]
        out.sort(key=lambda e: e[0])
        return out

    def chrome_events(self) -> List[dict]:
        """Sanitized Chrome trace events: per-track B/E balanced (orphaned
        ends from wraparound dropped, dangling begins closed), async spans
        balanced per (name, id), timestamps in µs from tracer start, one
        ``tid`` per track with ``thread_name`` metadata."""
        evs = self.events()
        t0 = self._t0
        tids: Dict[str, int] = {}

        def tid_for(track: str) -> int:
            t = tids.get(track)
            if t is None:
                t = tids[track] = len(tids) + 1
            return t

        out: List[tuple] = []  # (ts_us, seq, event_dict)
        stacks: Dict[str, List[str]] = {}
        open_async: Dict[tuple, int] = {}
        max_ts = 0.0
        for seq, ts0, ts1, ph, name, track, aid, args in evs:
            us = max(0.0, (ts0 - t0) * 1e6)
            e: Dict[str, Any] = {"name": name, "ph": ph, "ts": us, "pid": 0}
            if args:
                e["args"] = args
            if ph in ("b", "n", "e"):
                key = (name, aid)
                if ph == "e":
                    if open_async.get(key, 0) < 1:
                        continue  # begin overwritten by wraparound
                    open_async[key] -= 1
                elif ph == "b":
                    open_async[key] = open_async.get(key, 0) + 1
                e["cat"] = "request"
                e["id"] = str(aid)
                e["tid"] = tid_for("requests")
            else:
                track = track or "main"
                e["tid"] = tid_for(track)
                if ph == "B":
                    stacks.setdefault(track, []).append(name)
                elif ph == "E":
                    st = stacks.get(track)
                    if not st or st[-1] != name:
                        continue  # orphaned end: begin overwritten
                    st.pop()
                elif ph == "X":
                    e["dur"] = max(0.0, (ts1 - ts0) * 1e6)
                    us = max(us, us + e["dur"])
            max_ts = max(max_ts, us)
            out.append((e["ts"], seq, e))
        # Close dangling sync spans (their ends were not emitted yet or
        # tracing stopped mid-span) at the window's end, innermost first.
        tail = len(self._slots) * 2 + len(out)
        for track, st in stacks.items():
            for name in reversed(st):
                tail += 1
                out.append((max_ts, tail,
                            {"name": name, "ph": "E", "ts": max_ts,
                             "pid": 0, "tid": tid_for(track)}))
        for (name, aid), n_open in open_async.items():
            for _ in range(n_open):
                tail += 1
                out.append((max_ts, tail,
                            {"name": name, "ph": "e", "ts": max_ts, "pid": 0,
                             "tid": tid_for("requests"), "cat": "request",
                             "id": str(aid)}))
        out.sort(key=lambda t: (t[0], t[1]))
        meta: List[dict] = [{"name": "process_name", "ph": "M", "ts": 0,
                             "pid": 0, "tid": 0, "args": {"name": "repro_torch"}}]
        for track, tid in tids.items():
            meta.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": 0,
                         "tid": tid, "args": {"name": track}})
        return meta + [e for _, _, e in out]

    def export(self) -> dict:
        return {"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> dict:
        doc = self.export()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc

    def phase_totals(self) -> Dict[str, dict]:
        return phase_totals(self.chrome_events())


def phase_totals(events: Sequence[dict]) -> Dict[str, dict]:
    """Aggregate span wall-clock per name from Chrome events: complete
    ("X") spans by their ``dur``, matched B/E and async b/e pairs by
    timestamp difference.  Returns ``{name: {count, seconds}}``."""
    totals: Dict[str, dict] = {}

    def add(name: str, us: float) -> None:
        d = totals.setdefault(name, {"count": 0, "seconds": 0.0})
        d["count"] += 1
        d["seconds"] += max(0.0, us) / 1e6

    sync_open: Dict[Any, List[tuple]] = {}
    async_open: Dict[tuple, List[float]] = {}
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        ph = e.get("ph")
        if ph == "X":
            add(e["name"], e.get("dur", 0.0))
        elif ph == "B":
            sync_open.setdefault(e.get("tid"), []).append((e["name"], e["ts"]))
        elif ph == "E":
            st = sync_open.get(e.get("tid"))
            if st and st[-1][0] == e.get("name", st[-1][0]):
                name, ts = st.pop()
                add(name, e["ts"] - ts)
        elif ph == "b":
            async_open.setdefault((e.get("name"), e.get("id")),
                                  []).append(e["ts"])
        elif ph == "e":
            st = async_open.get((e.get("name"), e.get("id")))
            if st:
                add(e["name"], e["ts"] - st.pop())
    return totals


_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_PHASES = frozenset("BEXibneCM")


def validate_chrome(doc) -> List[str]:
    """Check a Chrome trace-event document against the schema contract the
    CI smoke enforces: required keys on every event, non-negative monotonic
    timestamps, balanced B/E per thread, balanced async b/e per (name, id),
    non-negative durations.  Returns a list of problems (empty = valid)."""
    errs: List[str] = []
    evs = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    last_ts: Optional[float] = None
    stacks: Dict[Any, List[str]] = {}
    open_async: Dict[tuple, int] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        for k in _REQUIRED:
            if k not in e:
                errs.append(f"event {i}: missing required key {k!r}")
        ph = e.get("ph")
        if ph not in _PHASES:
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        ts = e.get("ts", 0)
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "M":
            continue
        if last_ts is not None and ts < last_ts:
            errs.append(f"event {i}: ts {ts} < previous {last_ts} "
                        "(not monotonic)")
        last_ts = ts
        if ph == "B":
            stacks.setdefault(e.get("tid"), []).append(e.get("name"))
        elif ph == "E":
            st = stacks.get(e.get("tid"))
            if not st:
                errs.append(f"event {i}: E {e.get('name')!r} without open B")
            elif st[-1] != e.get("name"):
                errs.append(f"event {i}: E {e.get('name')!r} mismatches "
                            f"open B {st[-1]!r}")
            else:
                st.pop()
        elif ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: X missing/negative dur {dur!r}")
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args:
                errs.append(f"event {i}: counter without series args")
            elif any(not isinstance(v, (int, float)) or isinstance(v, bool)
                     for v in args.values()):
                errs.append(f"event {i}: counter series must be numeric: "
                            f"{args!r}")
        elif ph in ("b", "n", "e"):
            if "id" not in e:
                errs.append(f"event {i}: async {ph!r} missing id")
            key = (e.get("name"), e.get("id"))
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
            elif ph == "e":
                if open_async.get(key, 0) < 1:
                    errs.append(f"event {i}: async end without begin: {key}")
                else:
                    open_async[key] -= 1
    for tid, st in stacks.items():
        for name in st:
            errs.append(f"unbalanced: B {name!r} on tid {tid} never ends")
    for key, n in open_async.items():
        if n:
            errs.append(f"unbalanced: async span {key} never ends")
    return errs


_GLOBAL = Tracer(enabled=False)


def tracer() -> Tracer:
    """The process-wide tracer instrumentation points emit into."""
    return _GLOBAL


def set_tracer(t: Tracer) -> Tracer:
    """Install a tracer (e.g. a fresh enabled one per benchmark pass)."""
    global _GLOBAL
    _GLOBAL = t
    return t
