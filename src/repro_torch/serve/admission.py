"""Deadline-aware admission for the inference server (Tier-3 strategy).

Each request may carry an absolute deadline.  The batcher feeds this module
the same *measured service time* signal ``Scheduler.observe`` gets from the
runtime — seconds per completed prefill / decode-segment run, keyed by
shape bucket — and admission answers one question at two points in a
request's life:

- at ``InferenceServer.submit``: is the deadline hopeless even on an empty
  system?  Reject immediately (cheap client feedback, no queue pollution).
- at batch-forming / join time: given what is known *now* (remaining
  decode segments at the observed segment rate), can this request still
  finish in time?  If not, reject late rather than burn slots on work whose
  result is already worthless.

Within a bucket the pending queue is kept in EDF order (earliest deadline
first, FIFO among deadline-less requests), so when slots are scarce the
requests with the tightest feasible deadlines board first.

Estimates are optimistic by design (no queueing term): a request is only
rejected when even the no-contention forecast misses its deadline.  Cold
start admits everything — with no observations yet there is no defensible
basis for rejection.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Optional, Tuple


class ServiceModel:
    """EMA of observed run service times, keyed by (kind, bucket).

    The serving analog of ``ThroughputRater``: the runtime measures each
    run once (dispatch → completion) and the batcher calls ``observe`` from
    the run's done-callback; ``estimate`` returns the smoothed seconds or
    None before the first observation."""

    def __init__(self, alpha: float = 0.4) -> None:
        self.alpha = alpha
        self._lock = threading.Lock()
        self._ema: Dict[Tuple, float] = {}

    def observe(self, kind: str, bucket: int, seconds: float) -> None:
        if seconds <= 0.0 or not math.isfinite(seconds):
            return
        key = (kind, bucket)
        with self._lock:
            old = self._ema.get(key)
            self._ema[key] = seconds if old is None else (
                self.alpha * seconds + (1 - self.alpha) * old
            )

    def estimate(self, kind: str, bucket: int) -> Optional[float]:
        with self._lock:
            return self._ema.get((kind, bucket))

    # -- per-group rates ---------------------------------------------------
    def observe_rate(self, bucket: int, group: str, tokens_per_s: float) -> None:
        """EMA of one device group's decode rate at ``bucket`` — the signal
        multi-group placement consumes.  Fed per harvested segment with the
        group's *capacity* rate (slots × seg_len / seconds), so a half-empty
        group is not mistaken for a slow one."""
        if tokens_per_s <= 0.0 or not math.isfinite(tokens_per_s):
            return
        key = ("rate", bucket, group)
        with self._lock:
            old = self._ema.get(key)
            self._ema[key] = tokens_per_s if old is None else (
                self.alpha * tokens_per_s + (1 - self.alpha) * old
            )

    def rate(self, bucket: int, group: str) -> Optional[float]:
        with self._lock:
            return self._ema.get(("rate", bucket, group))

    # -- speculative decoding ---------------------------------------------
    def observe_acceptance(self, k: int, rate: float) -> None:
        """Rolling EMA of the draft acceptance rate (accepted / drafted
        tokens) at draft depth ``k``, fed per harvested segment."""
        if not math.isfinite(rate):
            return
        rate = min(1.0, max(0.0, rate))
        key = ("acceptance", int(k))
        with self._lock:
            old = self._ema.get(key)
            self._ema[key] = rate if old is None else (
                self.alpha * rate + (1 - self.alpha) * old
            )

    def acceptance(self, k: int) -> Optional[float]:
        with self._lock:
            return self._ema.get(("acceptance", int(k)))

    def tokens_per_step(self, k: int) -> float:
        """Expected tokens a draft-depth-``k`` speculative step emits:
        ``1 + acceptance * k``.  Cold (or k=0) returns 1.0 — the
        non-speculative rate — so forecasts degrade to the plain accounting
        rather than optimistically over-admitting before any evidence."""
        if k <= 0:
            return 1.0
        a = self.acceptance(k)
        return 1.0 if a is None else 1.0 + a * k


class DeadlineAdmission:
    """EDF admission policy: reject requests whose optimistic completion
    forecast misses their deadline by more than ``slack``×.

    ``slack`` > 1 tolerates estimate noise (reject only when the forecast
    exceeds the remaining budget by that factor); ``slack`` < 1 rejects
    conservatively early."""

    def __init__(self, model: Optional[ServiceModel] = None, *,
                 slack: float = 1.0, record_cap: int = 256) -> None:
        self.model = model or ServiceModel()
        self.slack = slack
        self._dlock = threading.Lock()
        self._decisions: deque = deque(maxlen=record_cap)
        # Streaming telemetry registry (serve.telemetry.Telemetry); the
        # owning InferenceServer points this at its own registry so every
        # decision counts and every TTFT forecast lands in a rolling stream.
        self.telemetry = None

    # -- forecast ---------------------------------------------------------
    def forecast(self, bucket: int, segments_left: int,
                 *, include_prefill: bool = True) -> Optional[float]:
        """Optimistic seconds to finish: prefill + remaining decode
        segments, from observed rates.  None while unobserved (cold)."""
        seg = self.model.estimate("segment", bucket)
        if seg is None:
            return None
        total = segments_left * seg
        if include_prefill:
            pre = self.model.estimate("prefill", bucket)
            total += pre if pre is not None else 0.0
        return total

    def ttft_forecast(self, bucket: int, n_chunks: int = 0) -> Optional[float]:
        """Optimistic seconds to first token.  Whole-prompt serving
        (``n_chunks = 0``): the prefill-run EMA.  Chunked prefill: the
        prompt advances one chunk per decode segment, so the first token
        arrives after ``n_chunks`` segments — ``n_chunks ×`` the
        segment-rate EMA.  None while the needed rate is unobserved."""
        if n_chunks > 0:
            seg = self.model.estimate("segment", bucket)
            return None if seg is None else n_chunks * seg
        return self.model.estimate("prefill", bucket)

    def admit(self, now: float, deadline: Optional[float], bucket: int,
              segments_left: int, *, include_prefill: bool = True,
              n_chunks: int = 0) -> bool:
        """True = admit.  Deadline-less requests and cold buckets always
        board; otherwise the no-contention forecast must fit the budget.

        ``n_chunks`` > 0 switches to chunked-prefill accounting: the
        prompt's chunks are extra decode segments (there is no prefill run
        to add), so the completion forecast covers ``segments_left +
        n_chunks`` segments.  Every decision is recorded with its TTFT
        forecast and chunk count (``stats``)."""
        if n_chunks > 0:
            include_prefill = False
            segments_left = segments_left + n_chunks
        ok = True
        if deadline is not None:
            est = self.forecast(bucket, segments_left,
                                include_prefill=include_prefill)
            if est is not None:
                ok = now + est * self.slack <= deadline
        fc = self.ttft_forecast(bucket, n_chunks)
        with self._dlock:
            self._decisions.append({
                "bucket": bucket,
                "n_chunks": n_chunks,
                "ttft_forecast_s": fc,
                "admitted": ok,
            })
        tel = self.telemetry
        if tel is not None:
            tel.count("admission_admitted" if ok else "admission_rejected")
            if fc is not None:
                tel.observe("ttft_forecast_s", fc)
        return ok

    def stats(self) -> dict:
        """Operator-facing snapshot of recent admission decisions: each
        carries its per-request TTFT forecast and chunk count (chunked
        prefill forecasts TTFT as chunks × segment rate rather than one
        whole-prompt prefill run)."""
        with self._dlock:
            recent = list(self._decisions)
        admitted = sum(1 for d in recent if d["admitted"])
        ttfts = [d["ttft_forecast_s"] for d in recent
                 if d["ttft_forecast_s"] is not None]
        return {
            "decisions": recent[-32:],
            "admitted": admitted,
            "rejected": len(recent) - admitted,
            "ttft_forecast_mean_s": sum(ttfts) / len(ttfts) if ttfts else None,
        }


class PoolAdmission:
    """Block-availability admission for paged KV serving (next to the
    deadline forecast: deadlines bound *time*, this bounds *memory*).

    Two decision points mirror :class:`DeadlineAdmission`:

    - at submit: a request whose forecast depth (prompt + every decode-
      segment position it may write) exceeds the pool outright can never be
      served — reject immediately.
    - at boarding: a request may only board when the pool can cover its
      forecast depth *now* (minus blocks already reserved by earlier wave
      members).  Otherwise it is **deferred** — left in the queue in EDF
      order until exits free blocks — because a boarded request's blocks
      are reserved up front, which is what makes mid-stream pool
      exhaustion (and the slot corruption it would cause) impossible.

    Contiguous groups report infinite availability: their slots are
    pre-allocated at full depth, so memory admission never defers."""

    @staticmethod
    def admit_submit(needed_blocks: int, capacity_blocks: int) -> bool:
        return needed_blocks <= capacity_blocks

    @staticmethod
    def admit_board(needed_blocks: int, available_blocks: float) -> bool:
        return needed_blocks <= available_blocks


class SpecGate:
    """Runtime on/off switch for speculative decoding.

    Self-drafting can be a net slowdown: every segment pays the draft model
    whether or not its tokens are accepted.  The gate forecasts the
    speculative speedup from the same EMAs admission already maintains —

        speedup = tokens_per_step(k) × plain_segment_s / spec_segment_s

    — and bypasses drafting while the forecast is < 1.  Both segment
    flavors are measured under their own keys (``seg_spec`` / ``seg_plain``
    per bucket); while either side is cold the gate *probes* it (one
    segment in the unmeasured mode), and afterwards it re-probes the losing
    mode every ``probe_every`` segments so a drift in acceptance or draft
    cost can flip the decision back.  Decisions are cheap: a host-side flag
    the segment kernel branches on, so flipping modes never rebuilds the
    batch."""

    def __init__(self, model: ServiceModel, k: int, *,
                 probe_every: int = 16) -> None:
        self.model = model
        self.k = int(k)
        self.probe_every = max(1, int(probe_every))
        self._lock = threading.Lock()
        self._since_probe: Dict[int, int] = {}  # bucket -> segments since probe
        self._probes = 0
        self._bypassed = 0
        self._speculated = 0
        self._mode: Dict[int, bool] = {}  # bucket -> last decision
        self.journal = None  # DecisionJournal, wired by the server when obs is on

    def forecast_speedup(self, bucket: int) -> Optional[float]:
        spec = self.model.estimate("seg_spec", bucket)
        plain = self.model.estimate("seg_plain", bucket)
        if spec is None or plain is None or spec <= 0.0:
            return None
        return self.model.tokens_per_step(self.k) * plain / spec

    def decide(self, bucket: int) -> bool:
        """True = run the next segment speculatively.  Call once per
        submitted segment; accounts probe scheduling internally."""
        spec = self.model.estimate("seg_spec", bucket)
        plain = self.model.estimate("seg_plain", bucket)
        with self._lock:
            if spec is None:
                speculate, probe = True, plain is not None  # measure spec first
            elif plain is None:
                speculate, probe = False, True  # one plain probe
            else:
                su = self.model.tokens_per_step(self.k) * plain / spec
                speculate = su >= 1.0
                n = self._since_probe.get(bucket, 0) + 1
                probe = n >= self.probe_every
                if probe:
                    speculate = not speculate  # re-measure the losing mode
                    self._since_probe[bucket] = 0
                else:
                    self._since_probe[bucket] = n
            if probe:
                self._probes += 1
            if speculate:
                self._speculated += 1
            else:
                self._bypassed += 1
            prev = self._mode.get(bucket)
            self._mode[bucket] = speculate
            journal = self.journal
        if journal is not None and prev is not None and prev != speculate:
            su = (self.model.tokens_per_step(self.k) * plain / spec
                  if spec and plain else None)
            journal.record("spec_gate", bucket=bucket,
                           mode="spec" if speculate else "plain",
                           probe=probe, forecast_speedup=su)
        return speculate

    def speculating(self, bucket: int) -> bool:
        """Forecast-only view (no probe accounting): is drafting currently
        believed profitable for this bucket?"""
        su = self.forecast_speedup(bucket)
        return su is None or su >= 1.0

    def stats(self, buckets=()) -> dict:
        with self._lock:
            out = {
                "k": self.k,
                "probes": self._probes,
                "speculated_segments": self._speculated,
                "bypassed_segments": self._bypassed,
            }
        per_bucket = {}
        for b in buckets:
            su = self.forecast_speedup(b)
            per_bucket[b] = {
                "forecast_speedup": su,
                "mode": "spec" if (su is None or su >= 1.0) else "plain",
            }
        out["buckets"] = per_bucket
        return out


def edf_key(deadline: Optional[float], seq: int) -> Tuple[float, int]:
    """Sort key for EDF order within a bucket: earliest deadline first,
    submission order among equal (or absent) deadlines."""
    return (deadline if deadline is not None else math.inf, seq)
