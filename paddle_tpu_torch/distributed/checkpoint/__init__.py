"""Distributed checkpoint: state-dict save and restore, one card.

≙ `paddle_tpu/distributed/checkpoint/__init__.py` :1-190 (`flat_arrays`,
`save_state_dict`, `load_state_dict`, `load_state_dict_raw`) with its
fault sites and counters. The JAX package writes each state dict through
orbax as sharded tensorstores and reshards on restore; this package has
no orbax, so a state dict is written as one group directory of the
layout in `storage.py` (``metadata.json`` beside raw data files), and
restore places each array on its target tensor's device. Cross-mesh
reshard and multi-process saves wait for the distributed stack.

Durability layer (`manifest.py`; protocol in ``docs/checkpointing.md``):
integrity manifests (`build_manifest` / `write_manifest`), commit markers
(`write_done` / `parse_done`) and `verify_checkpoint`, also a CLI:
``python -m paddle_tpu_torch.distributed.checkpoint verify <dir>``. The
atomic tmp + rename commit protocol lives in `fleet.elastic.ElasticManager`.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

import torch

from ... import observability as telemetry
from ...utils.faults import fault_point
from . import storage
from .manifest import (CheckpointIntegrityError, DONE_NAME,  # noqa: F401
                       MANIFEST_NAME, VerifyResult, array_checksum,
                       build_manifest, describe_arrays, manifest_of,
                       parse_done, read_manifest, verify_checkpoint,
                       write_done, write_manifest)
from .storage import CorruptArray  # noqa: F401

__all__ = [
    "save_state_dict", "load_state_dict", "load_state_dict_raw",
    # durability layer (manifest.py; protocol in docs/checkpointing.md)
    "MANIFEST_NAME", "DONE_NAME", "CheckpointIntegrityError",
    "VerifyResult", "array_checksum", "describe_arrays",
    "build_manifest", "write_manifest", "read_manifest", "write_done",
    "parse_done", "verify_checkpoint", "flat_arrays", "CorruptArray",
]

_M_CKPT_OPS = telemetry.counter(
    "pdt_checkpoint_ops_total",
    "Completed checkpoint operations, by direction.", ("op",))
_M_CKPT_BYTES = telemetry.counter(
    "pdt_checkpoint_bytes_total",
    "Array bytes moved through checkpoint operations, by direction.",
    ("op",))


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def flat_arrays(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten a (possibly nested) state_dict of tensors, arrays and
    scalars into the {dotted_key: array} form the on-disk checkpoint
    uses — the keys `save_state_dict` writes and manifests describe."""
    return {k: storage.as_array(v)
            for k, v in _flatten(state_dict).items() if v is not None}


def _nbytes(entries) -> int:
    return sum(int(e["nbytes"]) for e in entries.values())


class AsyncSave:
    """A save whose bytes land on a thread. `wait_until_finished`
    re-raises the writer's failure, fires ``checkpoint.write`` and counts
    the save once the bytes have landed (≙ the JAX package's wrapped
    orbax checkpointer, :120-136)."""

    def __init__(self, flat, path):
        self.entries = None
        self._err = None
        self._done = False
        self._thread = threading.Thread(target=self._run,
                                        args=(flat, path), daemon=True)
        self._thread.start()

    def _run(self, flat, path):
        try:
            self.entries = storage.write_group(flat, path)
        except BaseException as e:     # re-raised in wait_until_finished
            self._err = e

    def wait_until_finished(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        if not self._done:
            fault_point("checkpoint.write")
            self._done = True
            _M_CKPT_OPS.inc(op="save")
            _M_CKPT_BYTES.inc(_nbytes(self.entries), op="save")
        return self.entries


def save_group(state_dict: Dict[str, Any], path: str,
               async_save: bool = False):
    """`save_state_dict`'s body: the written arrays' records
    (`storage.write_group`), or the `AsyncSave` of an async save."""
    path = os.path.abspath(path)
    with telemetry.span("checkpoint.save", path=path,
                        async_save=bool(async_save)):
        # chaos site: fires BEFORE any byte is written, so an injected
        # save failure leaves no partial checkpoint
        fault_point("checkpoint.save")
        flat = flat_arrays(state_dict)
        if async_save:
            # the caller may go on changing its tensors: the bytes are
            # taken to host memory now, written on the thread
            return AsyncSave({k: v.to("cpu", copy=True)
                              if isinstance(v, torch.Tensor) else v.copy()
                              for k, v in flat.items()}, path)
        entries = storage.write_group(flat, path)
        # chaos site: fires AFTER this group's bytes are on disk — an
        # injected write failure mid-protocol leaves a torn multi-group
        # checkpoint (some groups written, no manifest)
        fault_point("checkpoint.write")
        _M_CKPT_OPS.inc(op="save")
        _M_CKPT_BYTES.inc(_nbytes(entries), op="save")
    return entries


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False):
    """Write a (possibly nested) state_dict of tensors, arrays and scalars
    as a checkpoint group at `path`. Returns None, or with
    ``async_save=True`` an `AsyncSave` the caller waits on."""
    out = save_group(state_dict, path, async_save)
    return out if async_save else None


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0):
    """Restore `path` INTO state_dict (in place): every tensor receives
    the checkpoint's values on its own device. A key the checkpoint
    lacks, or a shape or dtype that differs, raises before any tensor is
    written, as does an array whose bytes fail their crc32; the targets
    are written only once every array has been read."""
    path = os.path.abspath(path)
    with telemetry.span("checkpoint.load", path=path):
        fault_point("checkpoint.load")
        targets = {k: t for k, t in _flatten(state_dict).items()
                   if isinstance(t, torch.Tensor)}
        meta = storage.read_metadata(path)
        for k, t in targets.items():
            if k not in meta:
                raise KeyError(f"checkpoint {path!r} holds no array {k!r}")
            e = meta[k]
            if list(t.shape) != list(e["shape"]) or \
                    storage.dtype_name(t.dtype) != e["dtype"]:
                raise ValueError(
                    f"{k}: checkpoint holds {e['dtype']} {e['shape']}, the "
                    f"target is {storage.dtype_name(t.dtype)} "
                    f"{list(t.shape)}")
        by_device: Dict[torch.device, list] = {}
        for k, t in targets.items():
            by_device.setdefault(t.device, []).append(k)
        staged = {}
        for device, keys in by_device.items():
            staged.update(storage.read_group(path, keys, device))
        with torch.no_grad():
            for k, t in targets.items():
                t.copy_(staged.pop(k))
        _M_CKPT_OPS.inc(op="load")
        _M_CKPT_BYTES.inc(_nbytes({k: meta[k] for k in targets}),
                          op="load")
    return state_dict


def load_state_dict_raw(path: str, device=None) -> Dict[str, Any]:
    """Restore a checkpoint WITHOUT a target structure: the flat
    {dotted_key: tensor} dict as saved, on ``device`` (the CUDA card
    unless the caller names one). For state created lazily (optimizer
    accumulators) — feed it to ``set_state_dict``."""
    from ...ops import resolve_device
    device = resolve_device(device)
    path = os.path.abspath(path)
    with telemetry.span("checkpoint.load", path=path, raw=True):
        fault_point("checkpoint.load")
        meta = storage.read_metadata(path)
        restored = storage.read_group(path, list(meta), device)
        _M_CKPT_OPS.inc(op="load")
        _M_CKPT_BYTES.inc(_nbytes(meta), op="load")
    return restored
