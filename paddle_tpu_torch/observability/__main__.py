"""Operator CLI for the observability subsystem (≙
`paddle_tpu/observability/__main__.py`, whole).

    python -m paddle_tpu_torch.observability snapshot [--from FILE]
        [--format prom|json] [--out FILE]
    python -m paddle_tpu_torch.observability slo --from SNAP.json
        [--spec SPEC.json] [--warn-burn 0.5]
    python -m paddle_tpu_torch.observability trace export IN.jsonl
        --chrome OUT.json
    python -m paddle_tpu_torch.observability trace tree IN.jsonl
        --request REQUEST_ID
    python -m paddle_tpu_torch.observability status --from FLEET.json
    python -m paddle_tpu_torch.observability profile --from SNAP.json
        [--top-gaps 10]

`profile` renders the performance-attribution report from a saved
metrics snapshot (JSON or Prometheus text): the decode-round
decomposition waterfall, the ranked `pdt_profile_gap_seconds` table
from the last `engine.profile_round()`, the per-family compile-cache
table, and the `pdt_mem_bytes{pool}` memory ledger — exits non-zero
when the snapshot carries no profile series at all.
`status` renders a saved `fleet_info()` dict as the
operator report (per-replica role + health, role aggregates,
prefix-store stats, SLO verdicts — status.render_fleet_status).
`snapshot` converts between the two export forms: load a saved JSON
snapshot (`telemetry.write_json`) or a Prometheus text dump
(`.prom` / `.txt`, parsed with `parse_prometheus`) and render it as
either form — without `--from` it dumps THIS process's registry (empty
in a fresh CLI process; useful mainly under `PDT_TELEMETRY=1` in an
embedding). `slo` grades objectives (a JSON list of `SloObjective`
fields, defaulting to the stock serving set) against a
saved snapshot and exits non-zero when any objective is in breach.
`trace export` converts a JSONL trace sink into Chrome trace-event
JSON loadable by chrome://tracing and Perfetto (pid=replica,
tid=request); `trace tree` prints one request's reconstructed span
tree.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import export as _export
from . import slo as _slo
from . import trace as _trace

__all__ = ["main"]


def _load_snapshot(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        snap = json.loads(text)
    except json.JSONDecodeError:
        snap = _export.parse_prometheus(text)
    if not isinstance(snap, dict):
        raise SystemExit(f"{path}: not a snapshot (JSON object or "
                         "Prometheus text exposition expected)")
    for key in ("counters", "gauges", "histograms"):
        snap.setdefault(key, {})
    return snap


def _write(text: str, out: Optional[str]):
    if out is None:
        sys.stdout.write(text if text.endswith("\n") or not text
                         else text + "\n")
    else:
        with open(out, "w") as f:
            f.write(text if text.endswith("\n") or not text
                    else text + "\n")


def _cmd_snapshot(args) -> int:
    if args.src is not None:
        snap = _load_snapshot(args.src)
    else:
        from .registry import snapshot
        snap = snapshot()
    if args.format == "json":
        _write(json.dumps(snap, indent=2, sort_keys=True), args.out)
    else:
        _write(_export.render_prometheus(snap), args.out)
    return 0


def _cmd_slo(args) -> int:
    snap = _load_snapshot(args.src)
    objectives = (_slo.objectives_from_spec(args.spec)
                  if args.spec else None)
    statuses = _slo.evaluate_snapshot(snap, objectives,
                                      warn_burn=args.warn_burn)
    print(_slo.format_slo_report(statuses, warn_burn=args.warn_burn))
    return 1 if any(not st.ok for st in statuses.values()) else 0


def _cmd_status(args) -> int:
    from .status import render_fleet_status
    with open(args.src) as f:
        info = json.load(f)
    if not isinstance(info, dict) or "replicas" not in info:
        raise SystemExit(f"{args.src}: not a fleet_info() snapshot "
                         "(JSON object with a 'replicas' list "
                         "expected)")
    print(render_fleet_status(info))
    return 0


def _cmd_profile(args) -> int:
    from . import profile as _profile
    snap = _load_snapshot(args.src)
    report = _profile.render_profile_report(snap,
                                            top_gaps=args.top_gaps)
    print(report)
    # mirror `slo`'s exit-code contract: non-zero when there is
    # nothing to attribute (no pdt_profile_*/pdt_jit_*/pdt_mem_*
    # series in the snapshot at all)
    empty = not (_profile.round_summary(snap)
                 or _profile.gap_table(snap)
                 or _profile.compile_summary(snap)
                 or _profile.mem_summary(snap))
    return 1 if empty else 0


def _cmd_trace_export(args) -> int:
    evts = _trace.load_trace_jsonl(args.jsonl)
    doc = _trace.export_chrome_trace(evts, path=args.chrome)
    spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    print(f"{args.chrome}: {len(doc['traceEvents'])} trace events "
          f"({spans} spans) from {len(evts)} JSONL records — load in "
          "chrome://tracing or https://ui.perfetto.dev")
    return 0


def _cmd_trace_tree(args) -> int:
    evts = _trace.load_trace_jsonl(args.jsonl)
    tree = _trace.request_tree(args.request, evts)
    if tree is None:
        print(f"no trace root for request {args.request!r} in "
              f"{args.jsonl}", file=sys.stderr)
        return 1
    print(_trace.format_tree(tree))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability",
        description="Operator surface: snapshots, SLO reports, traces.")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("snapshot",
                       help="dump/convert a metrics snapshot")
    s.add_argument("--from", dest="src", metavar="FILE", default=None,
                   help="saved JSON snapshot or Prometheus text "
                        "(default: this process's registry)")
    s.add_argument("--format", choices=("prom", "json"), default="prom")
    s.add_argument("--out", metavar="FILE", default=None,
                   help="write here instead of stdout")
    s.set_defaults(fn=_cmd_snapshot)

    s = sub.add_parser("slo", help="grade SLO objectives against a "
                                   "saved snapshot")
    s.add_argument("--from", dest="src", metavar="SNAP.json",
                   required=True)
    s.add_argument("--spec", metavar="SPEC.json", default=None,
                   help="objective spec (default: the stock serving "
                        "objectives)")
    s.add_argument("--warn-burn", type=float, default=0.5)
    s.set_defaults(fn=_cmd_slo)

    s = sub.add_parser("status", help="render a saved fleet_info() "
                                      "snapshot (roles, SLO, prefix "
                                      "store)")
    s.add_argument("--from", dest="src", metavar="FLEET.json",
                   required=True)
    s.set_defaults(fn=_cmd_status)

    s = sub.add_parser("profile", help="render the performance-"
                                       "attribution report from a "
                                       "saved snapshot")
    s.add_argument("--from", dest="src", metavar="SNAP.json",
                   required=True,
                   help="saved JSON snapshot or Prometheus text")
    s.add_argument("--top-gaps", type=int, default=10,
                   help="rows in the dispatch-gap table (default 10)")
    s.set_defaults(fn=_cmd_profile)

    t = sub.add_parser("trace", help="trace tooling")
    tsub = t.add_subparsers(dest="trace_cmd", required=True)
    s = tsub.add_parser("export", help="JSONL -> Chrome trace JSON")
    s.add_argument("jsonl")
    s.add_argument("--chrome", metavar="OUT.json", required=True)
    s.set_defaults(fn=_cmd_trace_export)
    s = tsub.add_parser("tree", help="print one request's span tree")
    s.add_argument("jsonl")
    s.add_argument("--request", required=True)
    s.set_defaults(fn=_cmd_trace_tree)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
