"""Span tracing: nestable host-side spans -> structured JSONL events,
with REQUEST-SCOPED distributed traces across the serving fleet.

≙ `paddle_tpu/observability/trace.py`, whole, with the profiler range of
a span taken by `torch.profiler.record_function`.

Each completed span (and each point `event()`) becomes one dict —
`{"name", "attrs", "ts", "ts_mono", "dur_s", "seq", "depth", "parent",
"trace"}` — appended to a bounded in-memory ring buffer (oldest dropped
first, so a serving process can trace forever in O(1) memory) and, when
a file sink is configured (`set_trace_file()` or
`PDT_TELEMETRY_TRACE_FILE=`), written as one JSON line for offline
tooling (`jq`, pandas, the Chrome/Perfetto exporter below).

Spans NEST via a per-thread stack: `parent` (the enclosing span's seq
no) and `depth` reconstruct the local tree, and `seq` is a
process-global monotone sequence so interleaved threads stay ordered.

ONE CLOCK: every event is stamped from a single monotonic clock
(`time.perf_counter`) captured at span START (`ts_mono`); `dur_s` is
measured on the same clock, and the wall-time `ts` is DERIVED from one
process-wide (wall, mono) base pair — so timestamps from nested spans,
point events, and different requests are mutually comparable and
durations reconstruct exactly from the JSONL alone.

DISTRIBUTED TRACES (the fleet-router contract): a trace is opened per
request with `start_trace(request_id)` — the request_id is the
stable id that follows a request across replicas — which registers a
(trace id, root span) CARRIER under that key. From then on, ANY span or
event whose attrs carry that `request_id` joins the trace
automatically: it inherits the trace id and, when it has no enclosing
span, parents under the trace root. `attach(request_id)` joins
explicitly for blocks that cannot carry the attr. The router opens the
trace at submit, the replica/engine spans carry `request_id`, and
failover re-dispatch keeps the same id — so one request's dispatch,
queue wait, prefill, decode steps, preemptions, and failover form a
single causal tree (`request_tree()` rebuilds it; `export_chrome_trace`
renders it for chrome://tracing / Perfetto with pid=replica,
tid=request). `end_trace(request_id)` drops the carrier once the
request is terminal (the carrier table is LRU-bounded either way).

Interop with the profiler: when telemetry is enabled, each span also
opens a `torch.profiler.record_function` range, so the same host span
lands in a `torch.profiler` trace beside the kernels it launched. Spans
live in host code, never inside a program body; a span entered while
the current CUDA stream is capturing a graph opens no range, so a
capture records nothing of the telemetry.

Like the metrics registry, spans are a guaranteed no-op while telemetry
is disabled: `span()` returns a singleton null context manager,
`event()` / `start_trace()` return immediately.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from .registry import enabled

__all__ = ["span", "event", "events", "clear", "set_trace_file",
           "trace_file", "start_trace", "end_trace", "trace_of",
           "attach", "request_tree", "format_tree",
           "export_chrome_trace", "load_trace_jsonl"]

_RING_CAP = int(os.environ.get("PDT_TELEMETRY_TRACE_CAP", "4096"))
_LOCK = threading.Lock()
_RING: "deque[dict]" = deque(maxlen=_RING_CAP)
_SEQ = itertools.count()
_TLS = threading.local()

# -- the one clock ----------------------------------------------------
# Every stamp is perf_counter; wall time is DERIVED from this base pair
# so `ts` values across the whole ring share one timeline (the
# duration-reconstruction contract in the module docstring).
_CLOCK = time.perf_counter
_T0_MONO = _CLOCK()
_T0_WALL = time.time()


def _wall(mono: float) -> float:
    return _T0_WALL + (mono - _T0_MONO)


# -- request-scoped trace carriers ------------------------------------
_TRACE_IDS = itertools.count(1)
_CARRIER_CAP = int(os.environ.get("PDT_TELEMETRY_TRACE_CARRIERS",
                                  "4096"))
_CARRIER_LOCK = threading.Lock()
# carrier key (request_id) -> (trace id, root span seq); LRU-bounded so
# a caller that never calls end_trace cannot grow this without bound
_CARRIERS: "OrderedDict[str, tuple]" = OrderedDict()

_SINK_PATH: Optional[str] = None
_SINK_FILE = None
# True once the sink target is settled — either set_trace_file() was
# called (its choice is final, including an explicit None = off) or the
# env var has been consulted; _emit must not re-read the env after that
_SINK_RESOLVED = False

def _record_range(name: str):
    """An entered `torch.profiler.record_function` range for a span, or
    None while a CUDA graph is being captured on the current stream."""
    import torch
    if torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        return None
    rec = torch.profiler.record_function(name)
    rec.__enter__()
    return rec


def set_trace_file(path: Optional[str]):
    """Route every event to `path` as JSON lines (append). None closes
    the sink. Overrides `PDT_TELEMETRY_TRACE_FILE` either way — after
    set_trace_file(None) the env var is NOT re-consulted."""
    global _SINK_PATH, _SINK_FILE, _SINK_RESOLVED
    with _LOCK:
        if _SINK_FILE is not None:
            _SINK_FILE.close()
            _SINK_FILE = None
        _SINK_PATH = path
        _SINK_RESOLVED = True


def trace_file() -> Optional[str]:
    return _SINK_PATH


def _emit(ev: dict):
    global _SINK_PATH, _SINK_FILE, _SINK_RESOLVED
    with _LOCK:
        _RING.append(ev)
        if not _SINK_RESOLVED:
            _SINK_PATH = os.environ.get("PDT_TELEMETRY_TRACE_FILE") \
                or None
            _SINK_RESOLVED = True      # consult the env only once
        if _SINK_PATH is not None:
            if _SINK_FILE is None:
                _SINK_FILE = open(_SINK_PATH, "a", buffering=1)
            _SINK_FILE.write(json.dumps(ev) + "\n")


def events() -> List[dict]:
    """Snapshot of the ring buffer, oldest first."""
    with _LOCK:
        return list(_RING)


def clear():
    with _LOCK:
        _RING.clear()
    with _CARRIER_LOCK:
        _CARRIERS.clear()


# -- trace lifecycle ---------------------------------------------------
def start_trace(key: str, name: str = "trace.start",
                **attrs) -> Optional[int]:
    """Open a request-scoped trace: allocate a trace id, emit its root
    event (carrying `attrs` — include `request_id=key` so downstream
    joins and `request_tree()` find it), and register the carrier under
    `key`. Returns the trace id (None while telemetry is disabled).
    Re-opening a live key replaces the old carrier."""
    if not enabled():
        return None
    tid = next(_TRACE_IDS)
    seq = next(_SEQ)
    attrs.setdefault("request_id", key)
    with _CARRIER_LOCK:
        _CARRIERS[key] = (tid, seq)
        _CARRIERS.move_to_end(key)
        while len(_CARRIERS) > _CARRIER_CAP:
            _CARRIERS.popitem(last=False)
    t = _CLOCK()
    _emit({"name": name, "attrs": attrs, "ts": _wall(t), "ts_mono": t,
           "dur_s": 0.0, "seq": seq, "depth": 0, "parent": None,
           "trace": tid})
    return tid


def end_trace(key: str):
    """Drop the carrier for `key` (call once the request is terminal).
    Safe when absent; already-recorded events keep their trace id."""
    with _CARRIER_LOCK:
        _CARRIERS.pop(key, None)


def trace_of(key: str) -> Optional[int]:
    """Trace id registered for `key`, or None."""
    with _CARRIER_LOCK:
        ctx = _CARRIERS.get(key)
        return ctx[0] if ctx else None


def _carrier(key) -> Optional[tuple]:
    if not isinstance(key, str) or not _CARRIERS:
        return None
    with _CARRIER_LOCK:
        ctx = _CARRIERS.get(key)
        if ctx is not None:
            _CARRIERS.move_to_end(key)
        return ctx


@contextlib.contextmanager
def attach(key: str):
    """Join the trace registered for `key` explicitly: spans/events in
    the block parent under the trace root even without a `request_id`
    attr. Pass-through when telemetry is off or no carrier exists."""
    ctx = _carrier(key) if enabled() else None
    if ctx is None:
        yield
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    frame = (ctx[1], ctx[0])               # (parent span seq, trace id)
    stack.append(frame)
    try:
        yield
    finally:
        if stack and stack[-1] is frame:
            stack.pop()
        elif frame in stack:               # unbalanced inner spans
            stack.remove(frame)


def _resolve_links(stack, attrs):
    """(parent seq, trace id, depth) for a new span/event: local
    nesting wins for the parent; the trace id comes from the enclosing
    frame or, failing that, from the carrier named by a `request_id`
    attr (the automatic router->replica->engine propagation)."""
    parent = stack[-1][0] if stack else None
    trace = stack[-1][1] if stack else None
    depth = len(stack)
    if trace is None:
        ctx = _carrier(attrs.get("request_id"))
        if ctx is not None:
            trace = ctx[0]
            if parent is None:
                parent = ctx[1]
                depth = 1
    return parent, trace, depth


class _NullSpan:
    """Disabled-mode span: no state, no clock reads, reusable."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_t0", "_seq", "_depth",
                 "_parent", "_trace", "_rec")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self._seq = next(_SEQ)
        self._parent, self._trace, self._depth = _resolve_links(
            stack, self.attrs)
        stack.append((self._seq, self._trace))
        self._rec = _record_range(self.name)
        self._t0 = _CLOCK()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = _CLOCK() - self._t0
        if self._rec is not None:
            self._rec.__exit__(None, None, None)
        stack = _TLS.stack
        if stack and stack[-1][0] == self._seq:
            stack.pop()
        ev = {"name": self.name, "attrs": self.attrs,
              "ts": _wall(self._t0), "ts_mono": self._t0,
              "dur_s": dur, "seq": self._seq, "depth": self._depth,
              "parent": self._parent, "trace": self._trace}
        if exc_type is not None:
            ev["attrs"] = dict(self.attrs,
                               error=f"{exc_type.__name__}: {exc}")
        _emit(ev)
        return False


def span(name: str, **attrs):
    """`with span("serving.decode_step", slots=3): ...` — records one
    JSONL event on exit (duration, nesting, attrs; an escaping
    exception lands in `attrs["error"]`). A `request_id=` attr joins
    the request's distributed trace (module docstring). No-op while
    disabled."""
    if not enabled():
        return _NULL_SPAN
    return _Span(name, attrs)


def event(name: str, **attrs):
    """Point event (zero-duration span): fault fires, restarts,
    membership changes. A `request_id=` attr joins the request's
    distributed trace. No-op while disabled."""
    if not enabled():
        return
    stack = getattr(_TLS, "stack", None) or []
    parent, trace, depth = _resolve_links(stack, attrs)
    t = _CLOCK()
    _emit({"name": name, "attrs": attrs, "ts": _wall(t), "ts_mono": t,
           "dur_s": 0.0, "seq": next(_SEQ), "depth": depth,
           "parent": parent, "trace": trace})


# -- offline tooling ---------------------------------------------------
def load_trace_jsonl(path: str) -> List[dict]:
    """Read a `set_trace_file` JSONL sink back into an event list
    (blank lines skipped) for `request_tree` / `export_chrome_trace`."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def request_tree(request_id: str,
                 evts: Optional[List[dict]] = None) -> Optional[dict]:
    """Rebuild one request's span tree from the ring (or an event list
    / loaded JSONL): `{"event": root, "children": [...]}` nodes, each
    child list ordered by start time. Includes every event of the
    request's trace plus the batched decode steps that served it (a
    `serving.decode_step` span lists the request_ids it decoded for in
    its `rids` attr; those fan IN under the root). Returns None when no
    trace root for `request_id` exists in the events. With several
    roots for the same id (e.g. a refused submit retried later under a
    fresh trace), the NEWEST wins — it is the request's real serving
    timeline."""
    evts = events() if evts is None else evts
    root = None
    for e in evts:
        if e.get("parent") is None and e.get("trace") is not None \
                and (e.get("attrs") or {}).get("request_id") \
                == request_id:
            root = e                   # keep scanning: newest root wins
    if root is None:
        return None
    tid = root["trace"]
    nodes = {e["seq"]: {"event": e, "children": []}
             for e in evts if e.get("trace") == tid}
    for e in evts:
        rids = (e.get("attrs") or {}).get("rids") or ()
        if request_id in rids and e["seq"] not in nodes:
            nodes[e["seq"]] = {"event": e, "children": []}
    for seq in sorted(nodes):
        if seq == root["seq"]:
            continue
        node = nodes[seq]
        parent = nodes.get(node["event"].get("parent"))
        if parent is None or parent is node:
            parent = nodes[root["seq"]]    # fan-in (decode steps) or a
            # parent that fell off the bounded ring: keep the tree
            # connected under the root rather than dropping the node
        parent["children"].append(node)
    def _sort(node):
        node["children"].sort(
            key=lambda n: (n["event"].get("ts_mono",
                                          n["event"].get("ts", 0.0)),
                           n["event"]["seq"]))
        for c in node["children"]:
            _sort(c)
    _sort(nodes[root["seq"]])
    return nodes[root["seq"]]


def format_tree(tree: dict) -> str:
    """Human-readable rendering of a `request_tree` (operator CLI)."""
    lines: List[str] = []

    def walk(node, indent):
        e = node["event"]
        dur = e.get("dur_s", 0.0)
        tag = f" [{dur * 1e3:.2f}ms]" if dur else ""
        attrs = e.get("attrs") or {}
        extra = ""
        if "replica" in attrs and attrs["replica"] is not None:
            extra = f" replica={attrs['replica']}"
        if "error" in attrs:
            extra += f" error={attrs['error']!r}"
        lines.append(f"{'  ' * indent}{e['name']}{tag}{extra}")
        for c in node["children"]:
            walk(c, indent + 1)

    walk(tree, 0)
    return "\n".join(lines)


def export_chrome_trace(evts: Optional[List[dict]] = None,
                        path: Optional[str] = None) -> dict:
    """Render events as Chrome trace-event JSON (chrome://tracing and
    Perfetto both load it): pid = the replica that did the work (from
    the event's `replica` attr or the nearest ancestor span that has
    one), tid = the request (`request_id` attr; batched
    `serving.decode_step` spans fan OUT into one slice per request id
    in their `rids` attr). Spans are complete events (`ph="X"`, `dur`
    in microseconds), point events are instants (`ph="i"`), and
    process/thread names ride `ph="M"` metadata. Timestamps are
    microseconds on the shared monotonic base, rebased to the earliest
    event. Reads the live ring when `evts` is None; writes JSON to
    `path` when given; returns the trace document either way."""
    evts = events() if evts is None else list(evts)
    by_seq = {e["seq"]: e for e in evts if "seq" in e}

    def replica_of(e) -> Optional[object]:
        seen = set()
        while e is not None and e["seq"] not in seen:
            seen.add(e["seq"])
            r = (e.get("attrs") or {}).get("replica")
            if r is not None:
                return r
            e = by_seq.get(e.get("parent"))
        return None

    te: List[dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}

    def pid_for(label: str) -> int:
        if label not in pids:
            pids[label] = len(pids) + 1
            te.append({"ph": "M", "name": "process_name",
                       "pid": pids[label], "tid": 0,
                       "args": {"name": label}})
        return pids[label]

    def tid_for(pid: int, label: str) -> int:
        key = (pid, label)
        if key not in tids:
            tids[key] = len(tids) + 1
            te.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tids[key], "args": {"name": label}})
        return tids[key]

    base = min((e.get("ts_mono", e.get("ts", 0.0)) for e in evts),
               default=0.0)
    for e in evts:
        attrs = e.get("attrs") or {}
        replica = replica_of(e)
        pid = pid_for("host" if replica is None
                      else f"replica {replica}")
        if attrs.get("request_id") is not None:
            threads = [str(attrs["request_id"])]
        elif attrs.get("rids"):
            threads = [str(r) for r in attrs["rids"]]
        else:
            threads = ["engine"]
        args = dict(attrs)
        args.update(seq=e.get("seq"), trace=e.get("trace"),
                    parent=e.get("parent"))
        ts_us = (e.get("ts_mono", e.get("ts", 0.0)) - base) * 1e6
        dur_us = float(e.get("dur_s", 0.0)) * 1e6
        for th in threads:
            entry = {"name": e.get("name", "?"), "pid": pid,
                     "tid": tid_for(pid, th), "ts": round(ts_us, 3),
                     "args": args}
            if dur_us > 0:
                entry["ph"] = "X"
                entry["dur"] = round(dur_us, 3)
            else:
                entry["ph"] = "i"
                entry["s"] = "t"
            te.append(entry)
    doc = {"traceEvents": te, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
    return doc
