"""SLO engine: streaming quantiles + declarative latency objectives.

≙ `paddle_tpu/observability/slo.py`, whole. Production serving is
operated on objectives — "p95 TTFT under 500 ms", "99% of requests
succeed" — not on raw counters. This module turns the registry into that
operable layer:

* **Quantiles**, two ways. `quantile_from_buckets` interpolates a
  quantile from the registry's cumulative le-bucket histograms
  (Prometheus `histogram_quantile` semantics: linear within the
  bucket, the highest finite boundary when the quantile lands in
  +Inf) — cheap, streaming, bounded error. `Reservoir` keeps the raw
  samples of a sliding time window (bounded count) and answers EXACT
  quantiles with numpy-percentile linear interpolation — the right
  tool at serving-test sample counts, where bucket interpolation is
  coarse.
* **Objectives.** `SloObjective` declares one target — a latency
  quantile bound (`kind="latency"`), a max error rate
  (`kind="error_rate"`), or a min availability
  (`kind="availability"`) — over a rolling window. `SloMonitor`
  ingests samples (`observe` for latencies, `observe_outcome` for
  success/failure, optionally per replica), and `evaluate()` grades
  each objective **pass / warn / breach** with a BURN RATE: the
  fraction of the error budget being consumed (for "p95 <= T" the
  budget is the 5% of requests allowed past T; burn 1.0 = consuming
  it exactly, >1.0 = breach, >= `warn_burn` = warn). Results export
  as `pdt_slo_value` / `pdt_slo_burn_rate` / `pdt_slo_state{objective=}`
  gauges so the SLO verdicts themselves land in the scrape.
* **Offline evaluation.** `evaluate_snapshot` grades the same
  objectives against a saved `telemetry.snapshot()` (latencies from
  the le-bucket histograms, error rate / availability from the
  terminal-status counters) — the `python -m
  paddle_tpu_torch.observability slo` CLI path, no live process required.

A fleet router feeds it terminal outcomes and TTFT per request
(`observe` / `observe_outcome` with ``replica=``), so `replica_state()`
can report per-replica SLO state beside health.
"""
from __future__ import annotations

import json
import math
import time
from collections import deque
from dataclasses import dataclass, fields
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .registry import gauge

__all__ = ["PASS", "WARN", "BREACH", "STATE_CODE",
           "quantile_from_buckets", "fraction_over_threshold",
           "Reservoir", "SloObjective", "SloStatus", "SloMonitor",
           "default_serving_objectives", "objectives_from_spec",
           "evaluate_snapshot", "format_slo_report"]

PASS, WARN, BREACH = "pass", "warn", "breach"
# the pdt_slo_state gauge encoding
STATE_CODE = {PASS: 0, WARN: 1, BREACH: 2}

_M_SLO_VALUE = gauge(
    "pdt_slo_value",
    "Measured value per objective (latency quantile in seconds, or "
    "the error/availability ratio).", ("objective",))
_M_SLO_BURN = gauge(
    "pdt_slo_burn_rate",
    "Error-budget burn rate per objective (1.0 = consuming the budget "
    "exactly; > 1.0 = breach; infinite burns on zero-budget "
    "objectives export capped at 1e9).", ("objective",))
_M_SLO_STATE = gauge(
    "pdt_slo_state",
    "Objective verdict (0=pass 1=warn 2=breach).", ("objective",))


# -- quantile math -----------------------------------------------------
def _bucket_items(buckets: Dict[str, float]) -> List[Tuple[float, float]]:
    items = []
    for le, c in buckets.items():
        b = math.inf if le == "+Inf" else float(le)
        items.append((b, float(c)))
    items.sort()
    return items


def quantile_from_buckets(buckets: Dict[str, float],
                          q: float) -> Optional[float]:
    """Interpolated quantile from a snapshot histogram's CUMULATIVE
    le-bucket map (`{"0.1": 3, "1": 7, "+Inf": 9}`) — Prometheus
    `histogram_quantile` semantics: linear interpolation inside the
    bucket the rank lands in (lower bound 0 for the first), and the
    highest finite boundary when it lands in +Inf. None when empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    items = _bucket_items(buckets)
    if not items or items[-1][1] <= 0:
        return None
    rank = q * items[-1][1]
    prev_b, prev_c = 0.0, 0.0
    for b, c in items:
        if c >= rank and c > prev_c:
            if math.isinf(b):
                finite = [x for x, _ in items if not math.isinf(x)]
                return finite[-1] if finite else None
            frac = (rank - prev_c) / (c - prev_c)
            return prev_b + (b - prev_b) * min(max(frac, 0.0), 1.0)
        prev_b, prev_c = b, c
    return items[-1][0] if not math.isinf(items[-1][0]) else None


def fraction_over_threshold(buckets: Dict[str, float],
                            threshold: float) -> Optional[float]:
    """Estimated fraction of observations STRICTLY above `threshold`,
    interpolating linearly within the bucket containing it (the
    burn-rate numerator on the histogram path). When the threshold
    lies beyond every finite boundary, the +Inf bucket's mass cannot
    be placed relative to it and counts as OVER — an unresolvable
    threshold must grade conservatively, never as a confident pass.
    None when empty."""
    items = _bucket_items(buckets)
    if not items or items[-1][1] <= 0:
        return None
    total = items[-1][1]
    prev_b, prev_c = 0.0, 0.0
    for b, c in items:
        if threshold <= b:
            if math.isinf(b):
                at = prev_c        # +Inf mass: only ">last finite
                #                    boundary" is known — count it over
            else:
                width = b - prev_b
                frac = 1.0 if width <= 0 \
                    else (threshold - prev_b) / width
                at = prev_c + (c - prev_c) * min(max(frac, 0.0), 1.0)
            return max(0.0, (total - at) / total)
        prev_b, prev_c = b, c
    return 0.0


def exact_quantile(values: Sequence[float], q: float) -> Optional[float]:
    """numpy-percentile (linear interpolation) quantile of raw values —
    the Reservoir path's math, exposed for reuse and golden tests."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    pos = q * (len(vals) - 1)
    lo = int(math.floor(pos))
    hi = int(math.ceil(pos))
    if lo == hi:
        return vals[lo]
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


class Reservoir:
    """Sliding-window sample store for EXACT small-N quantiles: keeps
    the last `max_samples` observations no older than `window_s` on the
    injectable clock, answers `quantile`/`fraction_over` with the same
    linear interpolation as `numpy.percentile`. O(1) ingest, bounded
    memory; expiry happens lazily on both ingest and read. Samples may
    carry a `tag` (the SloMonitor uses the serving replica) and
    `values(tag=...)` reads one tag's slice — the window semantics
    live HERE, once, for every consumer."""

    def __init__(self, window_s: float = 60.0, max_samples: int = 2048,
                 clock: Optional[Callable[[], float]] = None):
        if window_s <= 0 or max_samples < 1:
            raise ValueError("window_s must be > 0 and max_samples >= 1")
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._clock = clock if clock is not None else time.monotonic
        self._samples: Deque[Tuple[float, float, Optional[str]]] = \
            deque()

    def observe(self, value: float, now: Optional[float] = None,
                tag: Optional[str] = None):
        now = self._clock() if now is None else now
        self._samples.append((now, float(value), tag))
        while len(self._samples) > self.max_samples:
            self._samples.popleft()
        self._expire(now)

    def _expire(self, now: float):
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] <= cutoff:
            self._samples.popleft()

    def values(self, now: Optional[float] = None,
               tag: Optional[str] = None) -> List[float]:
        self._expire(self._clock() if now is None else now)
        return [v for _, v, t in self._samples
                if tag is None or t == tag]

    def __len__(self) -> int:
        return len(self.values())

    def quantile(self, q: float,
                 now: Optional[float] = None) -> Optional[float]:
        return exact_quantile(self.values(now), q)

    def fraction_over(self, threshold: float,
                      now: Optional[float] = None) -> Optional[float]:
        vals = self.values(now)
        if not vals:
            return None
        return sum(1 for v in vals if v > threshold) / len(vals)


# -- objectives --------------------------------------------------------
@dataclass(frozen=True)
class SloObjective:
    """One declarative objective (the JSON spec format mirrors these
    fields 1:1).

    * `kind="latency"`: "the `quantile` of `signal` latencies is <=
      `threshold` seconds". Budget = the (1 - quantile) fraction of
      requests allowed past the threshold.
    * `kind="error_rate"`: "the failing fraction of outcomes is <=
      `threshold`". Budget = `threshold` itself.
    * `kind="availability"`: "the succeeding fraction of outcomes is
      >= `threshold`". Budget = 1 - `threshold`.

    `signal` is the feed key (`SloMonitor.observe(signal, ...)`), so
    several objectives can grade one stream (p50 and p95 of the same
    TTFT feed). `metric` names the registry series used when no live
    samples exist: a histogram for latency objectives, the
    terminal-status counter for ratio objectives (offline
    `evaluate_snapshot` uses it exclusively)."""

    name: str
    signal: str
    kind: str                      # latency | error_rate | availability
    threshold: float
    quantile: float = 0.95         # latency only
    window_s: float = 60.0
    metric: Optional[str] = None

    def __post_init__(self):
        if self.kind not in ("latency", "error_rate", "availability"):
            raise ValueError(f"objective {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.kind == "latency" and not 0.0 < self.quantile < 1.0:
            raise ValueError(f"objective {self.name!r}: quantile must "
                             f"be in (0, 1), got {self.quantile}")
        if self.kind != "latency" and not 0.0 <= self.threshold <= 1.0:
            raise ValueError(f"objective {self.name!r}: ratio threshold "
                             f"must be in [0, 1], got {self.threshold}")


@dataclass
class SloStatus:
    """One objective's verdict from an evaluation pass."""

    objective: str
    kind: str
    state: str                     # pass | warn | breach
    threshold: float
    value: Optional[float] = None  # quantile seconds, or the ratio
    burn_rate: float = 0.0
    samples: int = 0
    source: str = "none"           # reservoir | histogram | counter | none

    @property
    def ok(self) -> bool:
        return self.state != BREACH


def _grade(bad_fraction: Optional[float], budget: float,
           warn_burn: float) -> Tuple[str, float]:
    """(state, burn rate) from the observed bad fraction vs the error
    budget. No data (None) grades pass at burn 0 — absence of traffic
    is not a breach."""
    if bad_fraction is None:
        return PASS, 0.0
    if budget <= 0:
        burn = math.inf if bad_fraction > 0 else 0.0
    else:
        burn = bad_fraction / budget
    if burn > 1.0:
        return BREACH, burn
    if burn >= warn_burn:
        return WARN, burn
    return PASS, burn


def default_serving_objectives(ttft_p95: float = 0.5,
                               tpot_p95: float = 0.1,
                               max_error_rate: float = 0.01,
                               min_availability: float = 0.99,
                               window_s: float = 60.0) \
        -> List[SloObjective]:
    """The stock serving objective set: TTFT p95, TPOT p95, error
    rate, availability — fed by the router hook (signals `ttft` /
    `tpot` / `outcome`) and evaluable offline from the
    `pdt_serving_*` metrics."""
    return [
        SloObjective("ttft_p95", "ttft", "latency", ttft_p95,
                     quantile=0.95, window_s=window_s,
                     metric="pdt_serving_ttft_seconds"),
        SloObjective("tpot_p95", "tpot", "latency", tpot_p95,
                     quantile=0.95, window_s=window_s,
                     metric="pdt_serving_tpot_seconds"),
        SloObjective("error_rate", "outcome", "error_rate",
                     max_error_rate, window_s=window_s,
                     metric="pdt_serving_requests_terminal_total"),
        SloObjective("availability", "outcome", "availability",
                     min_availability, window_s=window_s,
                     metric="pdt_serving_requests_terminal_total"),
    ]


def objectives_from_spec(spec) -> List[SloObjective]:
    """Build objectives from the JSON spec format: a list of dicts
    whose keys mirror `SloObjective` fields, or a path to a JSON file
    holding one. Unknown keys raise (a typo'd spec must not silently
    grade pass)."""
    if isinstance(spec, str):
        with open(spec) as f:
            spec = json.load(f)
    allowed = {f.name for f in fields(SloObjective)}
    out = []
    for d in spec:
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(f"SLO spec entry {d.get('name', d)!r}: "
                             f"unknown keys {sorted(unknown)}")
        out.append(SloObjective(**d))
    return out


class SloMonitor:
    """Live objective evaluation over rolling windows (module
    docstring). Deterministic: pass the fleet's fake clock in tests.
    `replica=` tags samples so `replica_state()` can grade one
    replica's slice of the traffic (the router's `fleet_info` hook)."""

    def __init__(self, objectives: Optional[Sequence[SloObjective]] = None,
                 *, clock: Optional[Callable[[], float]] = None,
                 warn_burn: float = 0.5, max_samples: int = 4096):
        self._clock = clock if clock is not None else time.monotonic
        self.warn_burn = float(warn_burn)
        self.max_samples = int(max_samples)
        self.objectives: Dict[str, SloObjective] = {}
        # one Reservoir per objective (outcomes stored as 1.0/0.0) —
        # the window/cap semantics live in the golden-tested class
        self._res: Dict[str, Reservoir] = {}
        for obj in (objectives if objectives is not None
                    else default_serving_objectives()):
            self.add_objective(obj)

    def add_objective(self, obj: SloObjective):
        if obj.name in self.objectives:
            raise ValueError(f"objective {obj.name!r} already added")
        self.objectives[obj.name] = obj
        self._res[obj.name] = Reservoir(window_s=obj.window_s,
                                        max_samples=self.max_samples,
                                        clock=self._clock)

    # -- ingest --------------------------------------------------------
    def observe(self, signal: str, seconds: float,
                replica: Optional[str] = None):
        """Record one latency sample for every `kind="latency"`
        objective fed by `signal`."""
        for obj in self.objectives.values():
            if obj.kind == "latency" and obj.signal == signal:
                self._res[obj.name].observe(float(seconds),
                                            tag=replica)

    def observe_outcome(self, signal: str, ok: bool,
                        replica: Optional[str] = None):
        """Record one success/failure outcome for every ratio
        objective (`error_rate` / `availability`) fed by `signal`."""
        for obj in self.objectives.values():
            if obj.kind != "latency" and obj.signal == signal:
                self._res[obj.name].observe(1.0 if ok else 0.0,
                                            tag=replica)

    def _window(self, obj: SloObjective, now: float,
                replica: Optional[str] = None) -> List[float]:
        return self._res[obj.name].values(now, tag=replica)

    # -- evaluation ----------------------------------------------------
    def _grade_latency(self, obj: SloObjective, vals: List[float]) \
            -> SloStatus:
        st = SloStatus(obj.name, obj.kind, PASS, obj.threshold,
                       samples=len(vals))
        if vals:
            st.value = exact_quantile(vals, obj.quantile)
            bad = sum(1 for v in vals if v > obj.threshold) / len(vals)
            st.source = "reservoir"
        else:
            series = _histogram_series(obj.metric)
            if series is None:
                return st
            st.value = quantile_from_buckets(series["buckets"],
                                             obj.quantile)
            bad = fraction_over_threshold(series["buckets"],
                                          obj.threshold)
            st.samples = int(series.get("count", 0))
            st.source = "histogram"
        st.state, st.burn_rate = _grade(bad, 1.0 - obj.quantile,
                                        self.warn_burn)
        return st

    def _grade_ratio(self, obj: SloObjective,
                     outcomes: List[float]) -> SloStatus:
        st = SloStatus(obj.name, obj.kind, PASS, obj.threshold,
                       samples=len(outcomes))
        if not outcomes:
            return st
        st.source = "reservoir"
        bad = sum(1 for v in outcomes if v < 0.5) / len(outcomes)
        if obj.kind == "error_rate":
            st.value = bad
            budget = obj.threshold
        else:                                  # availability
            st.value = 1.0 - bad
            budget = 1.0 - obj.threshold
        st.state, st.burn_rate = _grade(bad, budget, self.warn_burn)
        return st

    def _evaluate_one(self, obj: SloObjective, now: float,
                      replica: Optional[str] = None) -> SloStatus:
        window = self._window(obj, now, replica)
        if obj.kind == "latency":
            if replica is not None and not window:
                # per-replica grading never falls back to the GLOBAL
                # histogram — that would grade every replica identically
                return SloStatus(obj.name, obj.kind, PASS,
                                 obj.threshold)
            return self._grade_latency(obj, window)
        return self._grade_ratio(obj, window)

    def evaluate(self, export: bool = True) -> Dict[str, SloStatus]:
        """Grade every objective now; optionally export the
        `pdt_slo_*` gauges. Returns {objective name: SloStatus}."""
        now = self._clock()
        out = {}
        for name, obj in self.objectives.items():
            st = self._evaluate_one(obj, now)
            out[name] = st
            if export:
                if st.value is not None:
                    _M_SLO_VALUE.set(st.value, objective=name)
                # an infinite burn (zero-budget objective violated)
                # exports as the 1e9 cap: still wildly > any alert
                # threshold, unlike a sentinel a `burn > 1` rule would
                # miss, and finite so the text exposition stays valid
                _M_SLO_BURN.set(min(st.burn_rate, 1e9), objective=name)
                _M_SLO_STATE.set(STATE_CODE[st.state], objective=name)
        return out

    def replica_state(self, replica: str) -> Optional[str]:
        """Worst objective state over THIS replica's samples (None when
        the replica contributed no samples at all) — read by
        `ServingRouter.fleet_info` to report SLO next to health."""
        now = self._clock()
        worst = None
        for obj in self.objectives.values():
            if not self._window(obj, now, replica):
                continue
            st = self._evaluate_one(obj, now, replica)
            if worst is None or STATE_CODE[st.state] > STATE_CODE[worst]:
                worst = st.state
        return worst

    def report(self) -> str:
        """Human-readable objective report (the operator surface)."""
        return format_slo_report(self.evaluate(export=False),
                                 warn_burn=self.warn_burn)


def _histogram_series(metric: Optional[str]) -> Optional[dict]:
    """The unlabelled series of `metric` from the LIVE registry
    (cumulative since the last reset), or None."""
    if metric is None:
        return None
    from .registry import snapshot
    series = snapshot()["histograms"].get(metric, {}).get("")
    return series if series and series.get("count") else None


# -- offline path ------------------------------------------------------
_BAD_STATUSES = ("failed", "timeout", "preempted")


def evaluate_snapshot(snap: dict,
                      objectives: Optional[Sequence[SloObjective]] = None,
                      warn_burn: float = 0.5) -> Dict[str, SloStatus]:
    """Grade objectives against a saved `telemetry.snapshot()` (the
    CLI path): latency objectives from their `metric` histogram's
    le buckets, ratio objectives from the per-status terminal counter
    named by `metric` (bad = failed|timeout|preempted). Objectives
    whose metric is absent grade pass with source "none"."""
    objectives = (default_serving_objectives()
                  if objectives is None else objectives)
    out: Dict[str, SloStatus] = {}
    for obj in objectives:
        st = SloStatus(obj.name, obj.kind, PASS, obj.threshold)
        if obj.kind == "latency":
            series = (snap.get("histograms", {})
                      .get(obj.metric or "", {}).get(""))
            if series and series.get("count"):
                st.value = quantile_from_buckets(series["buckets"],
                                                 obj.quantile)
                bad = fraction_over_threshold(series["buckets"],
                                              obj.threshold)
                st.samples = int(series["count"])
                st.source = "histogram"
                st.state, st.burn_rate = _grade(
                    bad, 1.0 - obj.quantile, warn_burn)
        else:
            series = (snap.get("counters", {})
                      .get(obj.metric or "", {}))
            total = sum(series.values())
            if total > 0:
                bad = sum(v for k, v in series.items()
                          if any(f'status="{s}"' in k
                                 for s in _BAD_STATUSES)) / total
                st.samples = int(total)
                st.source = "counter"
                if obj.kind == "error_rate":
                    st.value, budget = bad, obj.threshold
                else:
                    st.value, budget = 1.0 - bad, 1.0 - obj.threshold
                st.state, st.burn_rate = _grade(bad, budget, warn_burn)
        out[obj.name] = st
    return out


def format_slo_report(statuses: Dict[str, SloStatus],
                      warn_burn: float = 0.5) -> str:
    """Fixed-width objective table (recipes + the `slo` CLI command)."""
    lines = [f"SLO report ({len(statuses)} objectives, "
             f"warn at burn >= {warn_burn:g})",
             f"  {'objective':<16} {'state':<7} {'value':>12} "
             f"{'threshold':>10} {'burn':>8}  source"]
    for name, st in statuses.items():
        value = "-" if st.value is None else f"{st.value:.6g}"
        burn = "inf" if math.isinf(st.burn_rate) \
            else f"{st.burn_rate:.2f}"
        lines.append(
            f"  {name:<16} {st.state.upper():<7} {value:>12} "
            f"{st.threshold:>10.6g} {burn:>8}  "
            f"{st.source}({st.samples})")
    return "\n".join(lines)
