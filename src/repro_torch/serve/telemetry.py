"""Streaming serving telemetry: rolling-window quantiles, EMAs, counters,
gauges, and a Prometheus-style text exposition.

``InferenceServer.stats()`` is a point-in-time dict; an operator (and the
schedulers ROADMAP items 1–2 want to feed) needs *distributions* that track
the recent past.  ``Telemetry`` is that channel: the server, batcher, paged
pool, and admission layer all observe into one registry of named streams —
TTFT, inter-token latency, queue wait, segment time, acceptance rate, batch
occupancy, and per-tier block/byte gauges — and readers get rolling
p50/p95/p99 + EMA snapshots (``InferenceServer.metrics()["telemetry"]``) or
a ``/metrics``-format text page (``InferenceServer.prometheus()``).

The rolling window *is* the reservoir: a bounded deque of the last
``window`` observations, so quantiles are exact over the window (no sketch
error) while memory stays O(window) per stream.  ``quantile`` uses the same
linear interpolation as ``np.percentile``'s default, which lets tests and
the bench harness compare internal quantiles against externally computed
ones exactly.
"""
from __future__ import annotations

import math
import re
import threading
from collections import deque
from typing import Dict, Optional, Sequence


def quantile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolated quantile (``np.percentile`` default method) of an
    ascending-sorted sequence; None when empty."""
    n = len(sorted_vals)
    if n == 0:
        return None
    if n == 1:
        return float(sorted_vals[0])
    h = (n - 1) * q
    lo = int(math.floor(h))
    hi = min(lo + 1, n - 1)
    frac = h - lo
    return float(sorted_vals[lo]) * (1.0 - frac) + float(sorted_vals[hi]) * frac


class Ema:
    """Exponential moving average; None until the first update."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.2) -> None:
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = (x if self.value is None
                      else self.alpha * x + (1.0 - self.alpha) * self.value)
        return self.value


class RollingStat:
    """One observation stream: last-``window`` reservoir (exact rolling
    quantiles), lifetime count/sum, and an EMA."""

    __slots__ = ("_win", "count", "total", "ema", "last")

    def __init__(self, window: int = 512, alpha: float = 0.2) -> None:
        self._win: deque = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.ema = Ema(alpha)
        self.last: Optional[float] = None

    def observe(self, x: float) -> None:
        x = float(x)
        self._win.append(x)
        self.count += 1
        self.total += x
        self.ema.update(x)
        self.last = x

    def quantile(self, q: float) -> Optional[float]:
        return quantile(sorted(self._win), q)

    def snapshot(self) -> dict:
        s = sorted(self._win)
        return {
            "count": self.count,
            "sum": self.total,
            "window": len(s),
            "ema": self.ema.value,
            "last": self.last,
            "p50": quantile(s, 0.50),
            "p95": quantile(s, 0.95),
            "p99": quantile(s, 0.99),
        }


_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")

# Operator-facing HELP text for well-known streams; anything else gets a
# generated line (the exposition format requires none, but a scrape UI
# without HELP is a wall of bare names).
_HELP = {
    "ttft_s": "Time to first token, seconds (arrival to first emission)",
    "itl_s": "Inter-token latency, seconds (decode time per token after "
             "the first)",
    "latency_s": "End-to-end request latency, seconds",
    "queue_wait_s": "Arrival-to-boarding queue wait, seconds",
    "segment_s": "Decode segment wall time, seconds",
    "prefill_s": "Prefill wave wall time, seconds",
    "occupancy": "Active decode slots per harvested segment",
    "acceptance": "Speculative draft-token acceptance rate per segment",
    "coexec_efficiency": "Live co-execution load-balancing efficiency "
                         "(capacity-weighted member utilization, 1.0 = "
                         "every member fully busy)",
    "coexec_balance": "min/max member busy fraction over the rolling "
                      "window (the paper's T_FD/T_LD)",
    "tokens_delivered_per_s": "Delivered tokens per second over the "
                              "rolling observability window",
}


def sanitize_metric_name(name: str) -> str:
    """Exposition-legal metric name: illegal characters replaced, a
    leading digit prefixed (names must match [a-zA-Z_:][a-zA-Z0-9_:]*)."""
    name = _NAME_SANITIZE.sub("_", name)
    return "_" + name if name[:1].isdigit() else (name or "_")


def sanitize_label_name(name: str) -> str:
    """Exposition-legal label name ([a-zA-Z_][a-zA-Z0-9_]*)."""
    name = _LABEL_SANITIZE.sub("_", name)
    return "_" + name if name[:1].isdigit() else (name or "_")


def escape_label_value(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def escape_help(text: str) -> str:
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\["\\n])*)"')
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? "
    r"([-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    r"(?: [-+]?[0-9]+)?$")
_SUFFIXES = ("_sum", "_count", "_total", "_bucket")


def parse_exposition(text: str) -> Dict[str, dict]:
    """Strict Prometheus text-format parser: the conformance check CI's
    scrape and the telemetry tests share.  Raises ``ValueError`` on any
    violation (malformed line, sample without a preceding TYPE for its
    family, duplicate TYPE, bad label syntax, missing trailing newline).
    Returns ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.
    """
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    families: Dict[str, dict] = {}

    def family_of(name: str) -> str:
        for suf in _SUFFIXES:
            if name.endswith(suf) and name[: -len(suf)] in families:
                return name[: -len(suf)]
        return name

    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[0] != "#" or parts[1] not in (
                    "HELP", "TYPE"):
                raise ValueError(f"line {i}: malformed comment: {line!r}")
            kind, name = parts[1], parts[2]
            if not _METRIC_NAME_RE.match(name):
                raise ValueError(f"line {i}: bad metric name {name!r}")
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []})
            if kind == "TYPE":
                if fam["type"] is not None:
                    raise ValueError(f"line {i}: duplicate TYPE for {name}")
                if len(parts) != 4 or parts[3] not in (
                        "counter", "gauge", "summary", "histogram",
                        "untyped"):
                    raise ValueError(f"line {i}: bad TYPE: {line!r}")
                fam["type"] = parts[3]
            else:
                fam["help"] = parts[3] if len(parts) == 4 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample: {line!r}")
        name, labels_s, value = m.group(1), m.group(2), m.group(3)
        labels = {}
        if labels_s:
            rest = _LABEL_RE.sub("", labels_s).replace(",", "").strip()
            if rest:
                raise ValueError(f"line {i}: bad labels {labels_s!r}")
            labels = dict(_LABEL_RE.findall(labels_s))
        fam = family_of(name)
        if fam not in families or families[fam]["type"] is None:
            raise ValueError(f"line {i}: sample {name!r} precedes its TYPE")
        families[fam]["samples"].append((name, labels, float(value)))
    return families


class Telemetry:
    """Thread-safe registry of named observation streams / counters /
    gauges.  All mutators are cheap (deque append + EMA under one lock);
    snapshots and expositions sort their windows at read time."""

    def __init__(self, window: int = 512, alpha: float = 0.2) -> None:
        self.window = int(window)
        self.alpha = alpha
        self._lock = threading.Lock()
        self._obs: Dict[str, RollingStat] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    # ------------------------------------------------------------ mutators
    def observe(self, name: str, value) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if not math.isfinite(v):
            return
        with self._lock:
            st = self._obs.get(name)
            if st is None:
                st = self._obs[name] = RollingStat(self.window, self.alpha)
            st.observe(v)

    def count(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def gauge(self, name: str, value) -> None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if not math.isfinite(v):
            return  # a NaN gauge would poison the exposition
        with self._lock:
            self._gauges[name] = v

    # ------------------------------------------------------------- readers
    def quantile(self, name: str, q: float) -> Optional[float]:
        with self._lock:
            st = self._obs.get(name)
            return None if st is None else st.quantile(q)

    def ema(self, name: str) -> Optional[float]:
        with self._lock:
            st = self._obs.get(name)
            return None if st is None else st.ema.value

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "observations": {k: st.snapshot()
                                 for k, st in sorted(self._obs.items())},
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
            }

    def prometheus(self, prefix: str = "enginecl") -> str:
        """Prometheus text exposition: each observation stream as a summary
        (rolling-window quantiles + lifetime _sum/_count), counters as
        ``_total`` counters, gauges as gauges.  Conforms to the text
        exposition format — ``# HELP``/``# TYPE`` per family, sanitized
        metric/label names — and round-trips through the strict
        :func:`parse_exposition` checker."""
        snap = self.snapshot()

        def nm(name: str) -> str:
            return sanitize_metric_name(f"{prefix}_{name}")

        def help_for(key: str, kind: str) -> str:
            return escape_help(_HELP.get(key, f"{kind} {key} from the "
                                              "serving telemetry"))

        lines = []
        for k, st in snap["observations"].items():
            base = nm(k)
            lines.append(f"# HELP {base} {help_for(k, 'observation stream')}")
            lines.append(f"# TYPE {base} summary")
            for q in (0.5, 0.95, 0.99):
                v = st[f"p{int(q * 100)}"]
                if v is not None:
                    lines.append(f'{base}{{quantile="{q}"}} {v:.9g}')
            lines.append(f"{base}_sum {st['sum']:.9g}")
            lines.append(f"{base}_count {st['count']}")
        for k, v in snap["counters"].items():
            base = nm(k if k.endswith("_total") else k + "_total")
            lines.append(f"# HELP {base} {help_for(k, 'counter')}")
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base} {v:.9g}")
        for k, v in snap["gauges"].items():
            base = nm(k)
            lines.append(f"# HELP {base} {help_for(k, 'gauge')}")
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {v:.9g}")
        return "\n".join(lines) + "\n"
