"""Runtime telemetry: metrics registry, span tracing, Prometheus / JSON
export, SLO grading and performance attribution.

≙ `paddle_tpu/observability/`, whole. Process-local, and a guaranteed
no-op unless enabled:

    import paddle_tpu_torch.observability as telemetry

    telemetry.enable()               # or PDT_TELEMETRY=1 in the env
    ...serve...
    snap = telemetry.snapshot()      # JSON-safe programmatic view
    print(telemetry.to_prometheus()) # text exposition for scrapers

The modules:

* `registry` — typed Counter / Gauge / Histogram instruments (labels,
  fixed bucket boundaries, exemplars, monotonic-clock timers) behind the
  global `REGISTRY`.
* `trace` — nestable `span()` / point `event()` -> structured JSONL in a
  bounded ring buffer and an optional file sink
  (`PDT_TELEMETRY_TRACE_FILE=`); a span also opens a
  `torch.profiler.record_function` range, so it shows in a
  `torch.profiler` trace. Request-scoped traces: `start_trace(request_id)`
  opens a trace that every span or event carrying that `request_id` attr
  joins, `request_tree()` rebuilds one request's tree, and
  `export_chrome_trace()` renders Perfetto / chrome://tracing JSON.
* `export` — Prometheus text exposition and the JSON snapshot, with the
  `parse_prometheus()` round trip and `render_prometheus(snapshot)` for
  saved snapshots.
* `slo` — streaming quantiles (le-bucket interpolation and an exact
  windowed reservoir) and the `SloMonitor` grading declarative
  objectives (TTFT / TPOT percentiles, error rate, availability) into
  pass / warn / breach with burn rates, exported as `pdt_slo_*` gauges.
* `profile` — the attribution plane: the decode-round decomposition
  (`note_round`), the dispatch-gap sampler (`gap_sampler` / `fence`,
  driven by `ContinuousBatchingEngine.profile_round()`), the program
  cache's counters (`compile_timed` / `note_cache` behind the engine's
  `_program_lru` / `_program_singleton`), the `pdt_mem_bytes{pool}`
  memory ledger and `render_profile_report(snapshot)`.
* `status` — `render_fleet_status()`, the fixed-width fleet report of a
  `fleet_info()` dict.
* `__main__` — the operator CLI (`python -m
  paddle_tpu_torch.observability snapshot|slo|profile|status|trace ...`).

Instrumented: the continuous-batching engine (TTFT, time per output
token, tokens/s, queue depth, admissions and rejections, preemptions,
page occupancy, terminal statuses, decode retries, speculative rounds,
quantized and LoRA footprints, the invariant sweep's duration), its
program cache, `generate()`, the fleet model store and fault-injection
fires (`utils.faults`). Instrument names, labels and buckets are the JAX
package's, so a dashboard reads either.
"""
from __future__ import annotations

from .registry import (DEFAULT_BUCKETS, REGISTRY, Counter, Gauge,  # noqa: F401
                       Histogram, Registry, counter, disable, enable,
                       enabled, gauge, histogram, reset, snapshot, value)
from .trace import (clear as clear_events, event, events,  # noqa: F401
                    set_trace_file, span, trace_file, start_trace,
                    end_trace, trace_of, attach as trace_attach,
                    request_tree, export_chrome_trace,
                    load_trace_jsonl)
from .export import (parse_prometheus, render_prometheus,  # noqa: F401
                     to_json, to_prometheus, write_json)
from .slo import (Reservoir, SloMonitor, SloObjective,  # noqa: F401
                  SloStatus, default_serving_objectives,
                  evaluate_snapshot, format_slo_report,
                  objectives_from_spec, quantile_from_buckets)
from .status import render_fleet_status  # noqa: F401
from . import profile  # noqa: F401
from .profile import (memory_ledger, note_round,  # noqa: F401
                      render_profile_report, snapshot_report)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "DEFAULT_BUCKETS", "counter", "gauge", "histogram",
    "enable", "disable", "enabled", "reset", "snapshot", "value",
    "span", "event", "events", "clear_events", "set_trace_file",
    "trace_file", "start_trace", "end_trace", "trace_of",
    "trace_attach", "request_tree", "export_chrome_trace",
    "load_trace_jsonl", "to_prometheus", "render_prometheus",
    "to_json", "write_json", "parse_prometheus",
    "Reservoir", "SloMonitor", "SloObjective", "SloStatus",
    "default_serving_objectives", "evaluate_snapshot",
    "format_slo_report", "objectives_from_spec",
    "quantile_from_buckets", "render_fleet_status",
    "profile", "memory_ledger", "note_round",
    "render_profile_report", "snapshot_report",
]
