"""Performance attribution: decode-round decomposition, program-cache
observability, the dispatch-gap sampler, and the memory ledger.

≙ `paddle_tpu/observability/profile.py`, whole, on PyTorch programs:
the same instruments, components, op families and report. Guaranteed
no-op unless telemetry is enabled:

* **Decode-round decomposition** — the engine threads `note_round()`
  through `step()` / `_decode` / `_harvest_pending`, splitting each
  round's wall into dispatch / device / harvest / host components
  (`pdt_profile_round_seconds{component}`; `journal` and `sentry` belong
  to the fleet). The components are measured wall intervals, so their
  sums reconcile against an independently timed round. "dispatch" is
  the host issuing a dispatch (a CUDA graph replay on the card),
  "device" the wait for its tokens at the harvest's copy (at
  ``harvest_every`` > 1 the window's one copy), "harvest" the token
  commits, "host" the rest (expiry, admission, page growth, packing).
* **Dispatch-gap sampler** — `gap_sampler()` + the `fence()` hooks in
  `models/llama.py`: `ContinuousBatchingEngine.profile_round()` runs ONE
  decode body eagerly (never a graph replay) with a
  `torch.cuda.synchronize` at every op-family boundary, attributing the
  host time between fences as the dispatch gap of that op pair
  (`pdt_profile_gap_seconds{op_pair}`, ranked by `gap_table()`). On the
  CPU a fence only stamps the clock.
* **Program-cache observability** — every program the engine's
  `_program_lru` / `_program_singleton` builds is metered through
  `compile_timed()`: its first run (on the card the eager warm-up) counts
  in `pdt_jit_compiles_total{family}` and its wall in
  `pdt_jit_compile_seconds` under a `jit.compile` span; on the card the
  graph capture at the key's second run is metered under `jit.compile`
  too, without a count, so a family's compile seconds hold its warm-ups
  and its share of the engine's ``graph_capture_seconds``. Cache sizes
  ride `pdt_jit_cache_entries{family}` / `pdt_jit_cache_evictions_total`,
  and a sliding-window retrace-storm detector emits the
  `profile.retrace_storm` event (+ `pdt_jit_retrace_storms_total`) when
  program-key churn drives compiles past a threshold.
* **Memory ledger** — `memory_ledger()` folds `cache_memory_info`, the
  draft pools (``numel() * element_size()`` of each), prefix-store
  spill bytes and model-store residency into the one
  `pdt_mem_bytes{pool}` family.

`render_profile_report(snapshot)` renders all four surfaces from any
saved snapshot (``python -m paddle_tpu_torch.observability profile``).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import registry as _registry
from . import trace as _trace
from .registry import counter, gauge, histogram

__all__ = ["COMPONENTS", "note_round", "compile_timed", "note_cache",
           "configure_retrace", "retrace_window", "gap_sampler",
           "fence", "gap_table", "memory_ledger", "perf_section",
           "round_summary", "compile_summary", "mem_summary",
           "render_profile_report", "snapshot_report"]

# the decode-round attribution axes (see module docstring); "host" is
# the expiry/admission/bookkeeping remainder the engine meters itself
COMPONENTS = ("dispatch", "device", "harvest", "journal", "sentry",
              "host")

# round walls are sub-ms host slices up to multi-second cold dispatches
_ROUND_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 0.001,
                  0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                  1.0, 2.5, 5.0)

_M_ROUND = histogram(
    "pdt_profile_round_seconds",
    "Wall seconds of one decode-round component (the engine/router "
    "attribution hooks), by component.", ("component",),
    buckets=_ROUND_BUCKETS)
_M_GAP = gauge(
    "pdt_profile_gap_seconds",
    "Host dispatch gap between two op families summed over the most "
    "recently gap-sampled decode round (profile_round), by op pair — "
    "the megakernel fusion ladder's ranked shopping list.", ("op_pair",))
_M_JIT_COMPILES = counter(
    "pdt_jit_compiles_total",
    "Programs compiled through the _jit_lru/_jit_singleton seam "
    "(first invocation of a freshly built jit), by program family.",
    ("family",))
_M_JIT_COMPILE_SECONDS = histogram(
    "pdt_jit_compile_seconds",
    "Wall seconds of a program's first invocation — trace + compile + "
    "first execute, the honest cold-start bill.", ("family",))
_M_JIT_CACHE = gauge(
    "pdt_jit_cache_entries",
    "Programs resident in a keyed-LRU jit cache, by family.",
    ("family",))
_M_JIT_EVICTIONS = counter(
    "pdt_jit_cache_evictions_total",
    "Programs evicted from a keyed-LRU jit cache past its cap, by "
    "family.", ("family",))
_M_RETRACE_STORMS = counter(
    "pdt_jit_retrace_storms_total",
    "Retrace-storm detections: sliding-window compile count exceeded "
    "the storm threshold (program-key churn).")
_M_MEM = gauge(
    "pdt_mem_bytes",
    "Memory ledger: bytes held per accounting pool (KV pools, draft "
    "pools, prefix-store spill, model-store residency).", ("pool",))


def note_round(component: str, seconds: float) -> None:
    """Record one decode-round component wall interval. No-op unless
    telemetry is enabled (the Histogram gate)."""
    _M_ROUND.observe(seconds, component=component)


# -- compile-cache observability --------------------------------------

class _RetraceWindow:
    """Sliding-window compile counter: a storm is >= `threshold`
    compiles inside `window_s` seconds. The clock is injectable for
    tests; detection is re-armed only after the window drains below
    half the threshold, so one sustained churn episode fires once per
    window rather than once per compile."""

    def __init__(self, window_s: float = 30.0, threshold: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.threshold = int(threshold)
        self.clock = clock
        self._times: deque = deque()
        self._families: deque = deque()
        self._armed = True

    def note(self, family: str) -> bool:
        """Record one compile; True when this compile tripped a storm."""
        now = self.clock()
        self._times.append(now)
        self._families.append(family)
        while self._times and now - self._times[0] > self.window_s:
            self._times.popleft()
            self._families.popleft()
        n = len(self._times)
        if n < self.threshold:
            if n <= self.threshold // 2:
                self._armed = True
            return False
        if not self._armed:
            return False
        self._armed = False
        fams: Dict[str, int] = {}
        for f in self._families:
            fams[f] = fams.get(f, 0) + 1
        _M_RETRACE_STORMS.inc()
        _trace.event("profile.retrace_storm", compiles=n,
                     window_s=self.window_s,
                     threshold=self.threshold,
                     families=",".join(f"{k}={v}"
                                       for k, v in sorted(fams.items())))
        return True

    def count(self) -> int:
        now = self.clock()
        while self._times and now - self._times[0] > self.window_s:
            self._times.popleft()
            self._families.popleft()
        return len(self._times)


_RETRACE = _RetraceWindow()


def retrace_window() -> _RetraceWindow:
    return _RETRACE


def configure_retrace(window_s: Optional[float] = None,
                      threshold: Optional[int] = None,
                      clock: Optional[Callable[[], float]] = None) \
        -> _RetraceWindow:
    """Replace the process-wide retrace-storm detector (tests inject a
    fake clock / low threshold; returns the new window)."""
    global _RETRACE
    cur = _RETRACE
    _RETRACE = _RetraceWindow(
        window_s=cur.window_s if window_s is None else window_s,
        threshold=cur.threshold if threshold is None else threshold,
        clock=cur.clock if clock is None else clock)
    return _RETRACE


def compile_timed(fn, family: str, key=None, count: bool = True):
    """Wrap a callable so its FIRST invocation — a program's first run,
    the one that pays what JAX pays in tracing and compiling — is
    metered: `pdt_jit_compiles_total{family}` / `pdt_jit_compile_seconds`
    under a `jit.compile` span, feeding the retrace-storm window. Later
    invocations pay one boolean check. ``count=False`` meters the
    seconds and the span alone (a program's graph capture on the card,
    the second half of its cold cost). The engine's `_program_lru` /
    `_program_singleton` seam routes every cached program through here,
    so program-cache observability cannot be bypassed."""
    state = [True]

    def _first_call_timed(*args, **kwargs):
        if not state[0]:
            return fn(*args, **kwargs)
        state[0] = False
        if not _registry.enabled():
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        with _trace.span("jit.compile", family=family,
                         key="" if key is None else str(key)):
            out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        _M_JIT_COMPILE_SECONDS.observe(dt, family=family)
        if count:
            _M_JIT_COMPILES.inc(family=family)
            _RETRACE.note(family)
        return out

    return _first_call_timed


def note_cache(family: str, entries: int, evicted: int = 0) -> None:
    """Record a keyed-LRU cache's footprint after a miss/evict pass."""
    if not _registry.enabled():
        return
    _M_JIT_CACHE.set(entries, family=family)
    if evicted:
        _M_JIT_EVICTIONS.inc(evicted, family=family)


# -- dispatch-gap sampler ---------------------------------------------

class _GapSampler:
    """Collects (op, dispatch_done_t, fence_done_t) triples from the
    `fence()` hooks of ONE eager decode body. The gap of pair A->B is
    the host wall between A's fence completing (device idle) and B's
    kernels all being launched — the launch overhead a fused kernel
    would delete. `device_s` is B's fence wait, i.e. its device compute
    once launched (0 on the CPU, where the work runs on the host before
    the fence)."""

    def __init__(self):
        self._events: List = []    # (op, t_dispatched, t_done)

    def note(self, op: str, t_dispatched: float, t_done: float):
        self._events.append((op, t_dispatched, t_done))

    def table(self) -> List[Dict[str, object]]:
        pairs: Dict[str, Dict[str, float]] = {}
        prev_op, prev_done = None, None
        for op, t_disp, t_done in self._events:
            if prev_op is not None:
                row = pairs.setdefault(
                    f"{prev_op}->{op}",
                    {"gap_s": 0.0, "device_s": 0.0, "count": 0})
                row["gap_s"] += max(t_disp - prev_done, 0.0)
                row["device_s"] += t_done - t_disp
                row["count"] += 1
            prev_op, prev_done = op, t_done
        out = [{"op_pair": k, **v} for k, v in pairs.items()]
        out.sort(key=lambda r: -r["gap_s"])
        for row in out:
            _M_GAP.set(row["gap_s"], op_pair=row["op_pair"])
        return out


_SAMPLER: Optional[_GapSampler] = None


class gap_sampler:
    """Context manager arming the op-family fences for one sampled
    round. Enter returns the sampler; call `.table()` after the round
    for the ranked gap table (it also publishes the
    `pdt_profile_gap_seconds{op_pair}` gauges)."""

    def __enter__(self) -> _GapSampler:
        global _SAMPLER
        self._sampler = _GapSampler()
        _SAMPLER = self._sampler
        return self._sampler

    def __exit__(self, *exc):
        global _SAMPLER
        _SAMPLER = None
        return False


def fence(op: str, value):
    """Op-family boundary hook (models/llama.py threads these through
    the model's forward): inert — one global check — unless a
    `gap_sampler()` is armed (only `profile_round` arms one, around an
    eager pass, never around a capture), in which case the card is
    synchronized (`torch.cuda.synchronize` on the device of the first
    CUDA tensor in ``value``; nothing on the CPU) and the
    (dispatch-done, fence-done) pair recorded. Returns `value`
    unchanged either way."""
    s = _SAMPLER
    if s is None:
        return value
    import torch
    t_disp = time.perf_counter()
    leaves = value if isinstance(value, (tuple, list)) else (value,)
    for leaf in leaves:
        if torch.is_tensor(leaf) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    s.note(op, t_disp, time.perf_counter())
    return value


def gap_table(snapshot: Dict[str, object]) -> List[Dict[str, object]]:
    """Ranked dispatch-gap rows from a saved snapshot's
    `pdt_profile_gap_seconds` gauges."""
    series = snapshot.get("gauges", {}).get("pdt_profile_gap_seconds",
                                            {})
    rows = []
    for labels, v in series.items():
        # labels: op_pair="a->b"
        pair = labels.split('"')[1] if '"' in labels else labels
        rows.append({"op_pair": pair, "gap_s": float(v)})
    rows.sort(key=lambda r: -r["gap_s"])
    return rows


# -- memory ledger -----------------------------------------------------

def _engine_pools(engine) -> Dict[str, float]:
    pools = {"kv_pool": 0.0, "kv_in_use": 0.0}
    info = engine.cache_memory_info()
    pools["kv_pool"] += float(info.get("bytes_pool", 0))
    pools["kv_in_use"] += float(info.get("bytes_in_use", 0))
    d_kv = getattr(engine, "_d_kv", None)
    if d_kv:
        pools["draft_pool"] = float(sum(
            sum(t.numel() * t.element_size() for t in entry)
            for entry in d_kv))
    return pools


def memory_ledger(engines=(), prefix_store=None,
                  model_store=None) -> Dict[str, float]:
    """Fold the engines' memory accounting into the one
    `pdt_mem_bytes{pool}` family (gauges set as a side effect when
    telemetry is on) and return the pool -> bytes dict."""
    pools: Dict[str, float] = {}
    for eng in engines:
        if eng is None:
            continue
        for name, v in _engine_pools(eng).items():
            pools[name] = pools.get(name, 0.0) + v
    if prefix_store is not None:
        pools["prefix_spill"] = float(
            prefix_store.stats().get("spilled_bytes", 0))
    if model_store is not None:
        resident = model_store.stats().get("resident_bytes", {})
        pools["model_store"] = float(sum(resident.values()))
    for name, v in pools.items():
        _M_MEM.set(v, pool=name)
    return pools


def perf_section(engines=(), prefix_store=None,
                 model_store=None) -> Dict[str, object]:
    """The `fleet_info()["perf"]` section: the memory ledger plus the
    compile-cache counters, read from the live registry (zeros when
    telemetry is off — the ledger itself is computed either way)."""
    mem = memory_ledger(engines, prefix_store=prefix_store,
                        model_store=model_store)
    jit: Dict[str, Dict[str, float]] = {}
    for fam_series, key in ((_M_JIT_COMPILES, "compiles"),
                            (_M_JIT_CACHE, "entries"),
                            (_M_JIT_EVICTIONS, "evictions")):
        for labels, v in fam_series._series.items():
            fam = labels[0] if labels else ""
            jit.setdefault(fam, {})[key] = float(v)
    return {"mem_bytes": mem, "jit": jit,
            "retrace_storms": _M_RETRACE_STORMS.get()}


# -- snapshot report rendering ----------------------------------------

def _label_value(labels: str) -> str:
    return labels.split('"')[1] if '"' in labels else labels


def round_summary(snapshot: Dict[str, object]) -> Dict[str, dict]:
    """component -> {count, total_s, median_s} from a snapshot's
    `pdt_profile_round_seconds` series."""
    from .slo import quantile_from_buckets
    out: Dict[str, dict] = {}
    series = snapshot.get("histograms", {}).get(
        "pdt_profile_round_seconds", {})
    for labels, s in series.items():
        if not s.get("count"):
            continue
        med = quantile_from_buckets(s["buckets"], 0.5)
        out[_label_value(labels)] = {
            "count": int(s["count"]), "total_s": float(s["sum"]),
            "median_s": float(med) if med is not None else None}
    return out


def compile_summary(snapshot: Dict[str, object]) -> Dict[str, dict]:
    """family -> {compiles, compile_s, entries, evictions}."""
    out: Dict[str, dict] = {}
    for labels, v in snapshot.get("counters", {}).get(
            "pdt_jit_compiles_total", {}).items():
        out.setdefault(_label_value(labels), {})["compiles"] = int(v)
    for labels, s in snapshot.get("histograms", {}).get(
            "pdt_jit_compile_seconds", {}).items():
        out.setdefault(_label_value(labels), {})["compile_s"] = \
            float(s.get("sum", 0.0))
    for labels, v in snapshot.get("gauges", {}).get(
            "pdt_jit_cache_entries", {}).items():
        out.setdefault(_label_value(labels), {})["entries"] = int(v)
    for labels, v in snapshot.get("counters", {}).get(
            "pdt_jit_cache_evictions_total", {}).items():
        out.setdefault(_label_value(labels), {})["evictions"] = int(v)
    return out


def mem_summary(snapshot: Dict[str, object]) -> Dict[str, float]:
    return {_label_value(labels): float(v)
            for labels, v in snapshot.get("gauges", {}).get(
                "pdt_mem_bytes", {}).items()}


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 0.1:
        return f"{v:.3f}s"
    return f"{v * 1e3:.3f}ms"


def _fmt_bytes(v: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024.0
    return f"{v:.1f}GiB"


def render_profile_report(snapshot: Dict[str, object],
                          top_gaps: int = 10) -> str:
    """The one profile report (waterfall + top gaps + compile table +
    memory ledger) from any saved snapshot — the `profile` command of
    the CLI. Sections with no data are omitted; an entirely empty
    report renders a one-line notice."""
    lines: List[str] = []
    rounds = round_summary(snapshot)
    if rounds:
        lines.append("decode-round decomposition")
        total = sum(r["total_s"] for r in rounds.values())
        order = [c for c in COMPONENTS if c in rounds] \
            + sorted(set(rounds) - set(COMPONENTS))
        for comp in order:
            r = rounds[comp]
            share = 100.0 * r["total_s"] / total if total > 0 else 0.0
            bar = "#" * max(int(round(share / 4)), 1)
            lines.append(
                f"  {comp:<9} median {_fmt_s(r['median_s']):>9}  "
                f"total {_fmt_s(r['total_s']):>9} ({share:5.1f}%) "
                f"{bar}")
    gaps = gap_table(snapshot)
    if gaps:
        lines.append("top dispatch gaps (last sampled round)")
        for row in gaps[:top_gaps]:
            lines.append(f"  {row['op_pair']:<28} "
                         f"{_fmt_s(row['gap_s']):>9}")
    compiles = compile_summary(snapshot)
    if compiles:
        lines.append("compile cache")
        lines.append(f"  {'family':<14} {'compiles':>8} "
                     f"{'compile_s':>10} {'entries':>8} {'evicted':>8}")
        for fam in sorted(compiles):
            c = compiles[fam]
            lines.append(
                f"  {fam:<14} {c.get('compiles', 0):>8} "
                f"{c.get('compile_s', 0.0):>10.3f} "
                f"{c.get('entries', 0):>8} {c.get('evictions', 0):>8}")
        storms = snapshot.get("counters", {}).get(
            "pdt_jit_retrace_storms_total", {}).get("")
        if storms:
            lines.append(f"  retrace storms: {int(storms)}")
    mem = mem_summary(snapshot)
    if mem:
        lines.append("memory ledger")
        for pool in sorted(mem):
            lines.append(f"  {pool:<14} {_fmt_bytes(mem[pool]):>12}")
    if not lines:
        return ("no profile data in snapshot (pdt_profile_*/pdt_jit_*/"
                "pdt_mem_* series absent)")
    return "\n".join(lines)


def snapshot_report(top_gaps: int = 10) -> str:
    """`render_profile_report` of the LIVE registry."""
    return render_profile_report(_registry.snapshot(),
                                 top_gaps=top_gaps)
