"""Checkpoint maintenance CLI.

≙ `paddle_tpu/distributed/checkpoint/__main__.py`:

    python -m paddle_tpu_torch.distributed.checkpoint verify <dir> [--rehash]

`<dir>` is either one committed checkpoint (a `step_N` directory with a
MANIFEST.json) or a checkpoint root — then every complete `step_*`
under it is verified. Exit code 0 iff every verified checkpoint is
clean; 1 otherwise (also when the root holds no complete checkpoint —
"nothing to resume from" is a failure for an operator asking whether a
job can restart).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from . import DONE_NAME, MANIFEST_NAME, parse_done, verify_checkpoint


def _targets(path: str) -> List[str]:
    if (os.path.exists(os.path.join(path, MANIFEST_NAME))
            or parse_done(os.path.join(path, DONE_NAME)) is not None):
        return [path]
    from ..fleet.elastic import complete_checkpoints
    return [p for _, p in complete_checkpoints(path)]


def _cmd_verify(args) -> int:
    targets = _targets(args.dir)
    if not targets:
        print(f"no checkpoint with a {MANIFEST_NAME} and no complete "
              f"step_* checkpoints under {args.dir!r}", file=sys.stderr)
        return 1
    rc = 0
    for path in targets:
        if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
            # pre-manifest checkpoint: resume() loads these unverified
            # rather than quarantining them for predating the protocol
            print(f"{'LEGACY':8s} {path}  (no {MANIFEST_NAME}; "
                  "pre-protocol checkpoint, loadable but unverifiable)")
            continue
        res = verify_checkpoint(path, rehash=args.rehash)
        status = "OK" if res.ok else "CORRUPT"
        mode = "rehash" if args.rehash else "light"
        print(f"{status:8s} {path}  (step={res.step}, "
              f"{res.arrays_checked} arrays, {mode})")
        for err in res.errors:
            print(f"         - {err}")
        if not res.ok:
            rc = 1
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.checkpoint",
        description="Durable-checkpoint maintenance "
                    "(docs/checkpointing.md)")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser(
        "verify", help="verify integrity manifests of one checkpoint "
                       "or every complete checkpoint under a root")
    v.add_argument("dir", help="step_N directory or checkpoint root")
    v.add_argument("--rehash", action="store_true",
                   help="also re-hash array contents against the "
                        "manifest checksums (reads all data; catches "
                        "silent bit flips, not just torn writes)")
    v.set_defaults(fn=_cmd_verify)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
