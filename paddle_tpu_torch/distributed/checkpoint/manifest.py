"""Integrity manifests and verification for durable checkpoints.

≙ `paddle_tpu/distributed/checkpoint/manifest.py`, whole. A checkpoint is
many files committed independently, so partial failure is the common
case. The durability protocol (``docs/checkpointing.md``) records next to
the data a ``MANIFEST.json`` of every array the writer meant to commit,
the JAX package's document key for key::

    {
      "format": "paddle-tpu-ckpt-manifest",
      "version": 1,
      "step": 42,
      "wall_time": 1722700000.0,
      "mesh": {"device_count": 1, "process_count": 1},
      "groups": {
        "model": {
          "layers.0.attn.q_proj.weight": {
            "shape": [256, 256], "dtype": "float32",
            "nbytes": 262144, "checksum": "sha256:ab12..."
          }, ...
        },
        "opt": {...}
      }
    }

(no ``sharding`` entry: an array on one card has no partition spec, as
a JAX array on one device has none).

`verify_checkpoint` replays that intent against the disk: manifest
present and parsable, the ``.done`` marker valid, every group's metadata
readable (`storage.py`), key sets equal, shapes, dtypes and nbytes
matching, the data files long enough; with ``rehash=True`` every array's
bytes are re-hashed, so silently flipped bytes are caught and not only
torn writes. The light tier (``rehash=False``) reads metadata and
``stat``s the data files, never an array byte. `ElasticManager.resume`
runs it before trusting a checkpoint; the CLI form is

    python -m paddle_tpu_torch.distributed.checkpoint verify <dir> [--rehash]
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from ... import observability as telemetry
from . import storage

__all__ = [
    "MANIFEST_NAME", "DONE_NAME", "CheckpointIntegrityError",
    "VerifyResult", "array_checksum", "describe_arrays",
    "build_manifest", "write_manifest", "read_manifest", "write_done",
    "parse_done", "verify_checkpoint",
]

MANIFEST_NAME = "MANIFEST.json"
DONE_NAME = ".done"
_FORMAT = "paddle-tpu-ckpt-manifest"
_VERSION = 1

_M_VERIFY_SECONDS = telemetry.histogram(
    "pdt_checkpoint_verify_seconds",
    "Wall time of verify_checkpoint passes.")


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint failed its integrity manifest (missing, torn, or
    content-mismatched). `errors` carries the individual findings."""

    def __init__(self, path: str, errors: List[str]):
        super().__init__(
            f"checkpoint {path!r} failed integrity verification: "
            + "; ".join(errors))
        self.path = path
        self.errors = errors


@dataclass
class VerifyResult:
    """Outcome of one `verify_checkpoint` pass."""
    path: str
    errors: List[str] = field(default_factory=list)
    arrays_checked: int = 0
    rehashed: bool = False
    step: Optional[int] = None

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_if_failed(self):
        if self.errors:
            raise CheckpointIntegrityError(self.path, self.errors)
        return self


def array_checksum(arr) -> str:
    """Content checksum of one array (a tensor on the card or the CPU, or
    a numpy array): sha256 over its row-major host bytes, bfloat16 as its
    16-bit words, so the digest equals the JAX package's for the same
    values."""
    return storage.checksums({"a": arr})["a"]


def describe_arrays(flat: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Manifest entries for a flat {dotted_key: array} dict (the arrays
    hashed in parallel)."""
    arrays = {k: storage.as_array(v) for k, v in flat.items()}
    sums = storage.checksums(arrays)
    return {key: {"shape": [int(d) for d in arr.shape],
                  "dtype": storage.dtype_name(arr.dtype),
                  "nbytes": storage.nbytes(arr),
                  "checksum": sums[key]}
            for key, arr in sorted(arrays.items())}


def _mesh() -> Dict[str, int]:
    dist = torch.distributed
    return {"device_count": max(1, torch.cuda.device_count()),
            "process_count": dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1}


def manifest_of(described: Dict[str, Dict[str, Any]],
                step: Optional[int] = None,
                wall_time: Optional[float] = None) -> Dict[str, Any]:
    """The manifest document of groups already described (entries as
    `describe_arrays` gives them, or as `storage.write_group` returns
    them: their checksum, shape, dtype and nbytes are kept)."""
    keep = ("shape", "dtype", "nbytes", "checksum")
    return {
        "format": _FORMAT,
        "version": _VERSION,
        "step": step,
        "wall_time": time.time() if wall_time is None else wall_time,
        "mesh": _mesh(),
        "groups": {g: {k: {f: e[f] for f in keep}
                       for k, e in sorted(entries.items())}
                   for g, entries in described.items()},
    }


def build_manifest(groups: Dict[str, Dict[str, Any]],
                   step: Optional[int] = None,
                   wall_time: Optional[float] = None) -> Dict[str, Any]:
    """Assemble the manifest dict for {group_name: flat_arrays}. Pass
    `wall_time` when the caller runs on an injectable clock (as
    ElasticManager does) so the manifest and the `.done` marker tell
    the same post-mortem timeline."""
    return manifest_of({g: describe_arrays(flat)
                        for g, flat in groups.items()}, step, wall_time)


def _atomic_write_text(path: str, text: str):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def write_manifest(ckpt_dir: str, manifest: Dict[str, Any]) -> str:
    """Write MANIFEST.json into `ckpt_dir` atomically (tmp + rename: a
    reader never observes a truncated manifest from a healthy writer)."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    _atomic_write_text(path, json.dumps(manifest, indent=1, sort_keys=True))
    return path


def read_manifest(ckpt_dir: str) -> Dict[str, Any]:
    """Load and structurally validate MANIFEST.json; raises
    :class:`CheckpointIntegrityError` when absent or unparsable."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except OSError:
        raise CheckpointIntegrityError(
            ckpt_dir, [f"missing {MANIFEST_NAME}"])
    except ValueError as e:
        raise CheckpointIntegrityError(
            ckpt_dir, [f"unparsable {MANIFEST_NAME}: {e}"])
    if (not isinstance(manifest, dict)
            or manifest.get("format") != _FORMAT
            or not isinstance(manifest.get("groups"), dict)):
        raise CheckpointIntegrityError(
            ckpt_dir, [f"malformed {MANIFEST_NAME}: not a "
                       f"{_FORMAT} document"])
    return manifest


def write_done(ckpt_dir: str, step: Optional[int] = None,
               wall_time: Optional[float] = None) -> str:
    """Commit marker, written atomically AFTER the data + manifest are
    in place. JSON payload so `parse_done` can reject torn markers."""
    path = os.path.join(ckpt_dir, DONE_NAME)
    payload = {"step": step,
               "time": time.time() if wall_time is None else wall_time}
    _atomic_write_text(path, json.dumps(payload))
    return path


def parse_done(done_path: str) -> Optional[Dict[str, Any]]:
    """Parse a `.done` marker. Returns its payload dict, or None when
    the marker is missing, empty, or garbage — a zero-byte `.done` from
    a non-atomic writer must read as NOT committed. Accepts the legacy
    bare-float payload (pre-manifest checkpoints)."""
    try:
        with open(done_path) as f:
            raw = f.read().strip()
    except OSError:
        return None
    if not raw:
        return None
    try:
        payload = json.loads(raw)
        if isinstance(payload, dict):
            return payload
        # bool is an int subclass: a garbage marker reading "true" must
        # NOT parse as a legacy bare-float timestamp
        if (isinstance(payload, (int, float))
                and not isinstance(payload, bool)):
            return {"step": None, "time": float(payload)}
        return None
    except ValueError:
        pass
    try:
        return {"step": None, "time": float(raw)}
    except ValueError:
        return None


def verify_checkpoint(path: str, rehash: bool = False) -> VerifyResult:
    """Integrity pass over one committed checkpoint directory (a
    `step_N` produced by the atomic commit protocol).

    Checks, accumulating every finding instead of stopping at the
    first: MANIFEST.json present/parsable, `.done` marker valid, each
    group's metadata readable, on-disk key set == manifest key set,
    per-array shape/dtype/nbytes match, and every data file at least as
    long as the arrays recorded in it. With `rehash=False` (the light
    tier) no array byte is read. With `rehash=True` every array's bytes
    are read from disk and their checksum recomputed — the only check
    that catches flipped bytes under intact metadata."""
    res = VerifyResult(path=os.path.abspath(path), rehashed=rehash)
    t0 = time.monotonic()
    try:
        with telemetry.span("checkpoint.verify", path=res.path,
                            rehash=rehash):
            _verify_into(res, path, rehash)
    finally:
        _M_VERIFY_SECONDS.observe(time.monotonic() - t0)
    return res


def _verify_into(res: VerifyResult, path: str, rehash: bool):
    if not os.path.isdir(path):
        res.errors.append("not a directory")
        return
    try:
        manifest = read_manifest(path)
    except CheckpointIntegrityError as e:
        res.errors.extend(e.errors)
        return
    res.step = manifest.get("step")
    if parse_done(os.path.join(path, DONE_NAME)) is None:
        res.errors.append(f"missing or unparsable {DONE_NAME} marker")
    for group, expected in sorted(manifest["groups"].items()):
        gdir = os.path.join(path, group)
        try:
            stored = storage.read_metadata(gdir)
        except (OSError, ValueError) as e:    # torn group, missing dir
            res.errors.append(
                f"group {group!r} unrestorable: "
                f"{type(e).__name__}: {e}")
            continue
        missing = sorted(set(expected) - set(stored))
        unexpected = sorted(set(stored) - set(expected))
        if missing:
            res.errors.append(
                f"group {group!r} missing arrays: {missing}")
        if unexpected:
            res.errors.append(
                f"group {group!r} has arrays absent from the "
                f"manifest: {unexpected}")
        res.errors.extend(f"group {group!r} {e}"
                          for e in storage.file_errors(gdir, stored))
        common = sorted(set(expected) & set(stored))
        sizes_ok = []
        for key in common:
            want, got = expected[key], stored[key]
            res.arrays_checked += 1
            if list(got["shape"]) != list(want.get("shape", [])):
                res.errors.append(
                    f"{group}/{key}: shape {got['shape']} != manifest "
                    f"{want.get('shape')}")
            if got["dtype"] != want.get("dtype"):
                res.errors.append(
                    f"{group}/{key}: dtype {got['dtype']} != manifest "
                    f"{want.get('dtype')}")
            if got["nbytes"] != want.get("nbytes"):
                res.errors.append(
                    f"{group}/{key}: nbytes {got['nbytes']} != manifest "
                    f"{want.get('nbytes')}")
            else:
                sizes_ok.append(key)
        if not rehash:
            continue
        try:
            sums = storage.stored_checksums(
                gdir, {k: stored[k] for k in sizes_ok})
        except OSError as e:
            res.errors.append(f"group {group!r} unrestorable: "
                              f"{type(e).__name__}: {e}")
            continue
        for key in sizes_ok:
            if isinstance(sums[key], Exception):
                res.errors.append(
                    f"{group}/{key}: unreadable: "
                    f"{type(sums[key]).__name__}: {sums[key]}")
            elif sums[key] != expected[key].get("checksum"):
                res.errors.append(
                    f"{group}/{key}: content checksum mismatch "
                    "(flipped bytes?)")
