"""Metrics registry: typed Counter / Gauge / Histogram instruments.

≙ `paddle_tpu/observability/registry.py`, whole. Process-local and
stdlib only. Serving stacks tune against these signals (TTFT, per-step
decode throughput, KV-page occupancy), so the instruments mirror the
Prometheus data model 1:1:

* **Counter** — monotone float, `inc()` only.
* **Gauge** — settable float, `set()`/`inc()`/`dec()`.
* **Histogram** — fixed bucket boundaries chosen at creation
  (le-style cumulative export), plus running count/sum; `observe()`
  and a monotonic-clock `time()` context manager.

All three carry optional LABELS: an instrument declares its label
names once, every record call passes values for exactly those names,
and each distinct value combination is an independent series (keyed in
snapshots by the canonical Prometheus label string `a="x",b="y"`, or
`""` for unlabelled).

GUARANTEED NO-OP UNLESS ENABLED: recording methods return immediately —
touching no state, taking no lock — unless telemetry is on (env
`PDT_TELEMETRY=1`, read dynamically like `PDT_CHECK_INVARIANTS`, or a
programmatic `enable()` override). Instrument *creation* is always
allowed and idempotent (`registry.counter(name, ...)` get-or-creates),
so instrumented modules pay one dict lookup per call site and nothing
else when telemetry is off.

A single process-wide lock guards mutation: host-side instrumentation
sites (engine step loop, heartbeat daemon threads, launcher restarts)
are rare relative to device work, so a coarse lock is simpler than
per-series atomics and plenty fast.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "enable", "disable",
           "enabled", "reset", "snapshot", "value", "DEFAULT_BUCKETS"]

# latency buckets in seconds: sub-ms host ops up through multi-minute
# checkpoint writes, +Inf implied
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_LOCK = threading.RLock()

# None -> env-driven; True/False -> programmatic override (enable()/
# disable() win over the environment either way)
_ENABLED_OVERRIDE: Optional[bool] = None


def enabled() -> bool:
    """Is telemetry recording on? `enable()`/`disable()` override the
    environment; otherwise `PDT_TELEMETRY=1` decides (read dynamically
    so test fixtures can flip it per-module)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    return os.environ.get("PDT_TELEMETRY") == "1"


def enable():
    """Turn telemetry on for this process (wins over the env var)."""
    global _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = True


def disable(clear_override: bool = False):
    """Turn telemetry off. With `clear_override=True` the decision
    returns to the `PDT_TELEMETRY` env var instead of a hard off."""
    global _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = None if clear_override else False


def _label_key(labelnames: Tuple[str, ...], labels: Dict[str, str]) \
        -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(sorted(labels))}")
    return tuple(str(labels[n]) for n in labelnames)


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping: backslash, double-quote, and
    newline must be escaped or a value like `a"b` (e.g. a --job_id fed
    straight into a label) corrupts the scrape text."""
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                              r"\n")


def _label_string(labelnames: Tuple[str, ...],
                  values: Tuple[str, ...]) -> str:
    """Canonical Prometheus label body: `a="x",b="y"` (no braces,
    values escaped), `""` for the unlabelled series — the
    snapshot/export key."""
    return ",".join(f'{n}="{_escape_label_value(v)}"'
                    for n, v in zip(labelnames, values))


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # label-values tuple -> series state (float, or histogram dict)
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return _label_key(self.labelnames, labels)

    def clear(self):
        with _LOCK:
            self._series.clear()

    def remove(self, **labels):
        """Drop one series (e.g. a departed worker's gauge) so snapshots
        and exports stop reporting a frozen last value. Safe when the
        series is absent, and NOT gated on enabled() — retiring stale
        state is cleanup, not recording."""
        with _LOCK:
            self._series.pop(self._key(labels), None)


class Counter(_Instrument):
    """Monotonically increasing value (Prometheus counter)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if not enabled():
            return
        if amount < 0:
            raise ValueError(f"counter {self.name}: inc by {amount} < 0")
        key = self._key(labels)
        with _LOCK:
            self._series[key] = self._series.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Instrument):
    """Settable point-in-time value (Prometheus gauge)."""

    kind = "gauge"

    def set(self, v: float, **labels):
        if not enabled():
            return
        with _LOCK:
            self._series[self._key(labels)] = float(v)

    def inc(self, amount: float = 1.0, **labels):
        if not enabled():
            return
        key = self._key(labels)
        with _LOCK:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def get(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))


class _Timer:
    """Monotonic-clock span feeding one histogram observation; usable
    as a context manager or via explicit stop()."""

    def __init__(self, hist: "Histogram", labels: Dict[str, str]):
        self._hist = hist
        self._labels = labels
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._hist.observe(dt, **self._labels)
        return dt

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Histogram(_Instrument):
    """Fixed-boundary histogram (Prometheus le-bucket export)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name}: needs >= 1 bucket")
        self.buckets = bs                     # +Inf implied

    def observe(self, v: float, exemplar: Optional[str] = None,
                **labels):
        """Record one observation. `exemplar` (e.g. a request/trace id)
        is remembered as the MOST RECENT exemplar of whichever bucket
        the value lands in — OpenMetrics exemplar semantics, so a p99
        bucket in the export links straight to a concrete trace."""
        if not enabled():
            return
        v = float(v)
        key = self._key(labels)
        with _LOCK:
            s = self._series.get(key)
            if s is None:
                s = {"count": 0, "sum": 0.0,
                     "counts": [0] * (len(self.buckets) + 1)}
                self._series[key] = s
            s["count"] += 1
            s["sum"] += v
            # non-cumulative per-bucket counts; cumulated at export
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s["counts"][i] += 1
                    break
            else:
                i = len(self.buckets)
                s["counts"][-1] += 1          # +Inf bucket
            if exemplar is not None:
                # keyed by bucket INDEX internally; snapshot renders
                # the le-boundary string ("exemplars" key only when one
                # was ever recorded, preserving export round-trip)
                s.setdefault("exemplars", {})[i] = {
                    "trace_id": str(exemplar), "value": v}

    def time(self, **labels) -> _Timer:
        """Context manager timing its body on the monotonic clock."""
        return _Timer(self, labels)

    def get(self, **labels) -> Dict[str, float]:
        """{"count", "sum"} for the series (0s when never observed)."""
        s = self._series.get(self._key(labels))
        if s is None:
            return {"count": 0, "sum": 0.0}
        return {"count": s["count"], "sum": s["sum"]}


class Registry:
    """Name -> instrument map with get-or-create accessors. Creation is
    idempotent; re-declaring a name with a different kind/labels/buckets
    raises (two call sites disagreeing about an instrument is a bug,
    not a merge)."""

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with _LOCK:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, labelnames, **kw)
                self._instruments[name] = inst
                return inst
            if not isinstance(inst, cls) or type(inst) is not cls:
                raise ValueError(
                    f"instrument {name!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            if inst.labelnames != tuple(labelnames):
                raise ValueError(
                    f"instrument {name!r} already registered with labels "
                    f"{inst.labelnames}, not {tuple(labelnames)}")
            if kw.get("buckets") is not None and isinstance(
                    inst, Histogram) and inst.buckets != tuple(
                    sorted(float(b) for b in kw["buckets"])):
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    f"buckets {inst.buckets}")
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, tuple(labelnames))

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) \
            -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   tuple(labelnames), buckets=buckets)

    def instruments(self) -> Dict[str, _Instrument]:
        with _LOCK:
            return dict(self._instruments)

    def reset(self):
        """Zero every series (instruments stay registered — their call
        sites hold references). Test isolation + scrape-epoch resets."""
        with _LOCK:
            for inst in self._instruments.values():
                inst.clear()

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe dump of every live series. Histogram buckets are
        CUMULATIVE keyed by the le boundary (Prometheus semantics), so
        a parsed text exposition compares equal to this directly."""
        out = {"enabled": enabled(),
               "counters": {}, "gauges": {}, "histograms": {}}
        with _LOCK:
            for name, inst in sorted(self._instruments.items()):
                if not inst._series:
                    continue      # never recorded: absent, not {} — the
                    # text exposition skips it too, so parse-back of the
                    # export compares equal to this snapshot
                if isinstance(inst, Histogram):
                    dst = out["histograms"].setdefault(name, {})
                    for key, s in sorted(inst._series.items()):
                        cum, bmap = 0, {}
                        for b, c in zip(inst.buckets, s["counts"]):
                            cum += c
                            bmap[_fmt_float(b)] = cum
                        bmap["+Inf"] = s["count"]
                        entry = {"count": s["count"], "sum": s["sum"],
                                 "buckets": bmap}
                        ex = s.get("exemplars")
                        if ex:
                            les = [_fmt_float(b)
                                   for b in inst.buckets] + ["+Inf"]
                            entry["exemplars"] = {
                                les[i]: dict(e)
                                for i, e in sorted(ex.items())}
                        dst[_label_string(inst.labelnames, key)] = entry
                elif isinstance(inst, (Counter, Gauge)):
                    dst = out["counters" if isinstance(inst, Counter)
                              else "gauges"].setdefault(name, {})
                    for key, v in sorted(inst._series.items()):
                        dst[_label_string(inst.labelnames, key)] = v
        return out


def _fmt_float(v: float) -> str:
    """Round-trippable number formatting shared by snapshot and the
    text exposition: integers render bare (`3`, not `3.0`) so the
    golden test output stays readable, everything else via repr."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


REGISTRY = Registry()


# module-level conveniences bound to the global registry --------------
def counter(name: str, help: str = "",
            labelnames: Iterable[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Iterable[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Iterable[str] = (),
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def reset():
    REGISTRY.reset()


def snapshot() -> Dict[str, object]:
    return REGISTRY.snapshot()


def value(name: str, **labels) -> float:
    """Current value of a counter/gauge series (0.0 when absent) — the
    one-liner tests reach for when reconciling engine counters."""
    inst = REGISTRY.instruments().get(name)
    if inst is None:
        return 0.0
    if isinstance(inst, Histogram):
        raise TypeError(f"{name!r} is a histogram — use "
                        "snapshot()['histograms'] or .get()")
    return inst.get(**labels)
