"""Exporters: Prometheus text exposition + JSON snapshot (+ parse-back).

≙ `paddle_tpu/observability/export.py`, whole; the text is byte for byte
the JAX package's for the same snapshot.

`to_prometheus()` renders the global registry in the Prometheus text
exposition format (version 0.0.4): `# HELP` / `# TYPE` headers, one
sample per series, histograms as cumulative `_bucket{le=...}` +
`_sum` + `_count`. `parse_prometheus()` reads that text back into the
exact `snapshot()` structure, so round-trip equality
(`parse_prometheus(to_prometheus()) == snapshot()` minus the `enabled`
flag) is an invariant the test suite asserts — the dump a scraper sees
IS the state the process had.

`to_json()` / `write_json()` give the same data as a machine-readable
snapshot for JSONL trajectories (bench detail, post-mortem dumps).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from .registry import (REGISTRY, Counter, Gauge, Histogram, Registry,
                       _escape_label_value, _fmt_float)

__all__ = ["to_prometheus", "render_prometheus", "to_json",
           "write_json", "parse_prometheus"]


def _sample(name: str, labels: str, v) -> str:
    body = f"{{{labels}}}" if labels else ""
    return f"{name}{body} {_fmt_float(float(v))}"


def _merge_label(labels: str, extra: str) -> str:
    return f"{labels},{extra}" if labels else extra


def to_prometheus(registry: Optional[Registry] = None) -> str:
    """Text exposition of every live series, deterministically ordered
    (by instrument name, then label string)."""
    reg = registry if registry is not None else REGISTRY
    insts = reg.instruments()
    return _render(reg.snapshot(),
                   {n: i.help for n, i in insts.items() if i.help})


def render_prometheus(snapshot: Dict[str, object]) -> str:
    """Text exposition straight from a bare `snapshot()` STRUCTURE —
    no live registry required, so offline tooling (the
    `python -m paddle_tpu_torch.observability snapshot` CLI) can convert a
    saved JSON snapshot into scrape text. `# HELP` lines are omitted
    (snapshots do not carry help strings);
    `parse_prometheus(render_prometheus(snap))` still round-trips to
    the same values."""
    return _render(snapshot, {})


def _render(snap: Dict[str, object], helps: Dict[str, str]) -> str:
    lines = []
    for kind, section in (("counter", "counters"), ("gauge", "gauges"),
                          ("histogram", "histograms")):
        for name, series in sorted(snap.get(section, {}).items()):
            if not series:
                continue
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, val in sorted(series.items()):
                if kind == "histogram":
                    exemplars = val.get("exemplars", {})
                    for le, c in val["buckets"].items():
                        line = _sample(
                            name + "_bucket",
                            _merge_label(labels, f'le="{le}"'), c)
                        ex = exemplars.get(le)
                        if ex is not None:
                            # OpenMetrics exemplar syntax:
                            #   ... 3 # {trace_id="abc"} 0.043
                            tid = _escape_label_value(
                                str(ex["trace_id"]))
                            line += (f' # {{trace_id="{tid}"}} '
                                     f'{_fmt_float(float(ex["value"]))}')
                        lines.append(line)
                    lines.append(_sample(name + "_sum", labels,
                                         val["sum"]))
                    lines.append(_sample(name + "_count", labels,
                                         val["count"]))
                else:
                    lines.append(_sample(name, labels, val))
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(registry: Optional[Registry] = None) -> Dict[str, object]:
    reg = registry if registry is not None else REGISTRY
    return reg.snapshot()


def write_json(path: str, registry: Optional[Registry] = None):
    with open(path, "w") as f:
        json.dump(to_json(registry), f, indent=2, sort_keys=True)
        f.write("\n")


def _parse_label_body(body: str, line: str) -> Dict[str, str]:
    """Quote-aware `a="x",b="y"` parser (values may contain commas);
    values are kept in their ESCAPED exposition form, matching the
    canonical label-string snapshot keys."""
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        key = body[i:eq].strip(" ,")
        assert body[eq + 1] == '"', f"unquoted label value in {line!r}"
        j = eq + 2
        while body[j] != '"':
            j += 2 if body[j] == "\\" else 1
        labels[key] = body[eq + 2:j]
        i = j + 1
    return labels


def _unescape_label_value(v: str) -> str:
    """Inverse of `_escape_label_value` (one left-to-right scan, so
    `\\\\n` decodes as backslash+n, not backslash+newline)."""
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(
                nxt, "\\" + nxt))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def _split_exemplar(line: str):
    """Strip an OpenMetrics exemplar suffix:
    `name_bucket{le="1"} 3 # {trace_id="abc"} 0.043` ->
    (`name_bucket{le="1"} 3`, {"trace_id": "abc", "value": 0.043}).
    Returns (line, None) when no exemplar is present."""
    cut = line.find(" # {")
    if cut < 0:
        return line, None
    tail = line[cut + 3:]                    # '{trace_id="..."} 0.043'
    end = tail.rfind("}")
    labels = _parse_label_body(tail[1:end], line)
    return line[:cut], {
        "trace_id": _unescape_label_value(labels.get("trace_id", "")),
        "value": float(tail[end + 1:].strip())}


def _split_sample(line: str):
    """`name{a="x",le="1"} 3` -> (name, {"a": "x", "le": "1"}, 3.0).
    Label values are parsed quote-aware (values may contain commas)."""
    brace = line.find("{")
    if brace < 0:
        name, _, num = line.rpartition(" ")
        return name.strip(), {}, float(num)
    name = line[:brace]
    endbrace = line.rfind("}")
    body, num = line[brace + 1:endbrace], line[endbrace + 1:]
    return name, _parse_label_body(body, line), float(num.strip())


def parse_prometheus(text: str) -> Dict[str, object]:
    """Parse a text exposition back into the `snapshot()` structure
    (sans the `enabled` flag). Built for round-trip verification of our
    own exporter — it understands the full sample syntax but only the
    three instrument kinds we emit."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    types: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip() if len(parts) > 3 \
                    else "untyped"
            continue
        line, exemplar = _split_exemplar(line)
        name, labels, val = _split_sample(line)
        base, suffix = name, None
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and types.get(name[:-len(sfx)]) \
                    == "histogram":
                base, suffix = name[:-len(sfx)], sfx
                break
        kind = types.get(base, "untyped")
        if kind == "histogram":
            le = labels.pop("le", None)
            lstr = ",".join(f'{k}="{v}"' for k, v in labels.items())
            series = out["histograms"].setdefault(base, {}).setdefault(
                lstr, {"count": 0, "sum": 0.0, "buckets": {}})
            if suffix == "_bucket":
                series["buckets"][le] = int(val)
                if exemplar is not None:
                    series.setdefault("exemplars", {})[le] = exemplar
            elif suffix == "_sum":
                series["sum"] = val
            elif suffix == "_count":
                series["count"] = int(val)
        elif kind in ("counter", "gauge"):
            lstr = ",".join(f'{k}="{v}"' for k, v in labels.items())
            out["counters" if kind == "counter" else "gauges"
                ].setdefault(base, {})[lstr] = val
    return out
