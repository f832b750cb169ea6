"""The on-disk layout of one checkpoint group, and the host side of moving
its arrays between the card and the disk.

The JAX package writes each group through orbax as OCDBT tensorstores;
the port has neither, so a group here is one directory of its own:

    <group>/metadata.json   {"format": "paddle-tpu-torch-ckpt-group",
                             "version": 1,
                             "arrays": {"<dotted key>": {
                                 "shape": [4096, 4096], "dtype": "bfloat16",
                                 "nbytes": 33554432, "file": "d/0",
                                 "offset": 0, "crc32": 1234567}, ...}}
    <group>/d/0, d/1, ...   the arrays' raw row-major bytes back to back,
                            each array whole in one file; a file closes
                            once it passes 1 GiB

``metadata.json`` is written last (tmp + rename), so a group whose writer
died holds no metadata and reads as unrestorable. Each array's crc32 is
the format's own check, as OCDBT carries one: every read recomputes it,
and a mismatch raises :class:`CorruptArray` before any target tensor is
written. The MANIFEST's sha256 digests (`manifest.py`) are computed in
the same pass as the write, from the same staged bytes, so nothing just
written is read back.

Arrays on the card move through a pool of pinned host buffers that lives
as long as the process (allocating pinned memory costs tens of ms a
buffer): a worker thread copies a 64 MiB chunk into its buffer on a
stream of its own, hashes it, writes it, and takes the next; several
workers run at once (the copies, ``hashlib``, ``zlib`` and the file
calls release the interpreter lock), the largest arrays handed out
first. Arrays on the CPU are hashed and written from their own memory.
Nothing is fsync'ed: the commit protocol (`fleet.elastic`) orders
renames, as the JAX package's does.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np
import torch

from ...framework.io import dtype_name, torch_dtype  # noqa: F401

GROUP_META = "metadata.json"
DATA_DIR = "d"
_FORMAT = "paddle-tpu-torch-ckpt-group"
_VERSION = 1
FILE_BYTES = 1 << 30
CHUNK = 64 << 20


class CorruptArray(ValueError):
    """A stored array whose bytes do not match the crc32 recorded beside
    them (flipped or torn bytes under intact metadata)."""


def as_array(v):
    """A state-dict leaf as an array: a tensor (detached), a numpy array,
    or a Python scalar as a 0-d tensor (bool, int64, float64: a
    scheduler's values keep every bit)."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, (np.ndarray, np.generic)):
        return np.asarray(v)
    if isinstance(v, bool):
        return torch.tensor(v)
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int64)
    if isinstance(v, float):
        return torch.tensor(v, dtype=torch.float64)
    raise TypeError(f"cannot checkpoint a {type(v).__name__}")


def nbytes(a) -> int:
    """The bytes of an array (`as_array`'s result)."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def _byte_view(a):
    """A flat uint8 view of an array's row-major bytes: a CPU numpy
    array, or a flat uint8 CUDA tensor."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    flat = a.contiguous().reshape(-1).view(torch.uint8)
    return flat if flat.is_cuda else flat.numpy()


class _PinnedPool:
    """Pinned host buffers of `CHUNK` bytes, handed to one worker at a
    time and kept for the next transfer."""

    def __init__(self):
        self._free: List[torch.Tensor] = []
        self._lock = threading.Lock()

    def get(self) -> torch.Tensor:
        with self._lock:
            if self._free:
                return self._free.pop()
        return torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)

    def put(self, buf: torch.Tensor):
        with self._lock:
            self._free.append(buf)


_PINNED = _PinnedPool()


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _chunks(view):
    """The bytes of ``view`` (`_byte_view`) in turn, as host buffers each
    valid until the next is taken: slices of the array's own memory on
    the CPU, a pinned buffer refilled from the card otherwise."""
    n = view.shape[0]
    if not isinstance(view, torch.Tensor):
        for off in range(0, n, CHUNK):
            yield view[off:off + CHUNK]
        return
    buf = _PINNED.get()
    try:
        stream = torch.cuda.Stream(device=view.device)
        host = buf.numpy()
        for off in range(0, n, CHUNK):
            m = min(CHUNK, n - off)
            with torch.cuda.stream(stream):
                buf[:m].copy_(view[off:off + m], non_blocking=True)
            stream.synchronize()
            yield host[:m]
    finally:
        _PINNED.put(buf)


def _sync_devices(arrays):
    """Wait for the work that wrote the card tensors among ``arrays``:
    the workers read them on streams of their own."""
    for dev in {a.device for a in arrays
                if isinstance(a, torch.Tensor) and a.is_cuda}:
        torch.cuda.synchronize(dev)


def _order(sizes: Dict[str, int]) -> List[str]:
    """The order tasks go to the pool: the largest first, so that no
    large array is left to one thread at the end while the others idle
    (an array's sha256 is one sequential pass)."""
    return sorted(sizes, key=lambda k: -sizes[k])


def _pool_map(fn, items: Dict[str, Any],
              sizes: Dict[str, int]) -> Dict[str, Any]:
    """``{key: fn(*args)}`` over a thread pool, the tasks handed out by
    `_order` of their ``sizes`` in bytes; the first failure raises once
    every task has ended."""
    if not items:
        return {}
    with ThreadPoolExecutor(max_workers=min(_workers(), len(items))) as ex:
        futs = {k: ex.submit(fn, *items[k]) for k in _order(sizes)}
    out, err = {}, None
    for k, f in futs.items():
        try:
            out[k] = f.result()
        except Exception as e:          # every future read, first raised
            err = err or e
    if err is not None:
        raise err
    return out


def _sha256(view) -> str:
    h = hashlib.sha256()
    for chunk in _chunks(view):
        h.update(chunk)
    return "sha256:" + h.hexdigest()


def checksums(flat: Dict[str, Any]) -> Dict[str, str]:
    """sha256 over each array's row-major host bytes (bfloat16 as its
    16-bit words: the digest of the JAX package's array of the same
    values), the arrays hashed in parallel."""
    arrays = {k: as_array(v) for k, v in flat.items()}
    _sync_devices(arrays.values())
    return _pool_map(_sha256, {k: (_byte_view(a),)
                               for k, a in arrays.items()},
                     {k: nbytes(a) for k, a in arrays.items()})


def _pwrite_all(fd: int, data, pos: int):
    mv = memoryview(data)
    while mv.nbytes:
        n = os.pwrite(fd, mv, pos)
        mv, pos = mv[n:], pos + n


def _write_array(view, fd: int, pos: int):
    h, crc = hashlib.sha256(), 0
    for chunk in _chunks(view):
        h.update(chunk)
        crc = zlib.crc32(chunk, crc)
        _pwrite_all(fd, chunk, pos)
        pos += chunk.shape[0]
    return "sha256:" + h.hexdigest(), crc & 0xFFFFFFFF


def _atomic_json(path: str, doc):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def write_group(flat: Dict[str, Any], path: str) -> Dict[str, dict]:
    """Write ``{dotted key: array}`` as a group directory at ``path``;
    returns each array's record: shape, dtype, nbytes, file, offset,
    crc32 and its sha256 ``checksum``, computed from the bytes written."""
    arrays = {k: as_array(v) for k, v in flat.items() if v is not None}
    entries, views = {}, {}
    file, size = 0, 0
    for key, a in arrays.items():
        views[key] = _byte_view(a)
        n = int(views[key].shape[0])
        if size and size + n > FILE_BYTES:
            file, size = file + 1, 0
        entries[key] = {"shape": [int(d) for d in a.shape],
                        "dtype": dtype_name(a.dtype), "nbytes": n,
                        "file": f"{DATA_DIR}/{file}", "offset": size}
        size += n
    os.makedirs(os.path.join(path, DATA_DIR), exist_ok=True)
    _sync_devices(arrays.values())
    fds = {}
    try:
        for e in entries.values():
            if e["file"] not in fds:
                fds[e["file"]] = os.open(
                    os.path.join(path, e["file"]),
                    os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        got = _pool_map(_write_array, {
            k: (views[k], fds[e["file"]], e["offset"])
            for k, e in entries.items()},
            {k: e["nbytes"] for k, e in entries.items()})
    finally:
        for fd in fds.values():
            os.close(fd)
    for key, (digest, crc) in got.items():
        entries[key]["crc32"] = crc
    _atomic_json(os.path.join(path, GROUP_META),
                 {"format": _FORMAT, "version": _VERSION,
                  "arrays": entries})
    for key, (digest, _) in got.items():
        entries[key] = dict(entries[key], checksum=digest)
    return entries


def read_metadata(path: str) -> Dict[str, dict]:
    """The ``arrays`` records of the group at ``path``; raises
    FileNotFoundError without one and ValueError for a malformed one."""
    meta_path = os.path.join(path, GROUP_META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no checkpoint metadata under {path}")
    with open(meta_path) as f:
        doc = json.load(f)
    if (not isinstance(doc, dict) or doc.get("format") != _FORMAT
            or not isinstance(doc.get("arrays"), dict)):
        raise ValueError(f"malformed {GROUP_META} under {path}")
    return doc["arrays"]


def file_errors(path: str, entries: Dict[str, dict]) -> List[str]:
    """What ``stat`` finds wrong with the group's data files: missing, or
    shorter than the arrays recorded in them. Reads no array bytes."""
    need: Dict[str, int] = {}
    for e in entries.values():
        need[e["file"]] = max(need.get(e["file"], 0),
                              int(e["offset"]) + int(e["nbytes"]))
    errors = []
    for name, n in sorted(need.items()):
        try:
            have = os.stat(os.path.join(path, name)).st_size
        except OSError:
            errors.append(f"data file {name!r} missing")
            continue
        if have < n:
            errors.append(f"data file {name!r} holds {have} bytes, its "
                          f"arrays need {n}")
    return errors


def _pread_into(fd: int, view, pos: int):
    got, n = 0, view.shape[0]
    while got < n:
        k = os.preadv(fd, [view[got:]], pos + got)
        if k == 0:
            raise EOFError(f"data file ends at byte {pos + got}, "
                           f"{n - got} bytes short")
        got += k


def _read_array(dst, fd: int, pos: int, n: int) -> int:
    """Fill ``dst`` (a flat uint8 tensor of ``n`` bytes) from the file;
    returns the bytes' crc32."""
    crc = 0
    if not dst.is_cuda:
        host = dst.numpy()
        for off in range(0, n, CHUNK):
            part = host[off:off + CHUNK]
            _pread_into(fd, part, pos + off)
            crc = zlib.crc32(part, crc)
        return crc & 0xFFFFFFFF
    buf = _PINNED.get()
    try:
        stream = torch.cuda.Stream(device=dst.device)
        host = buf.numpy()
        for off in range(0, n, CHUNK):
            m = min(CHUNK, n - off)
            _pread_into(fd, host[:m], pos + off)
            crc = zlib.crc32(host[:m], crc)
            with torch.cuda.stream(stream):
                dst[off:off + m].copy_(buf[:m], non_blocking=True)
            stream.synchronize()
    finally:
        _PINNED.put(buf)
    return crc & 0xFFFFFFFF


def _open_files(path: str, entries: Dict[str, dict]) -> Dict[str, int]:
    fds = {}
    try:
        for e in entries.values():
            if e["file"] not in fds:
                fds[e["file"]] = os.open(os.path.join(path, e["file"]),
                                         os.O_RDONLY)
    except OSError:
        for fd in fds.values():
            os.close(fd)
        raise
    return fds


def read_group(path: str, keys, device) -> Dict[str, torch.Tensor]:
    """Read the arrays ``keys`` of the group at ``path`` into new tensors
    on ``device``; raises :class:`CorruptArray` if any array's crc32
    disagrees with its record, KeyError for a key the group lacks."""
    meta = read_metadata(path)
    entries = {k: meta[k] for k in keys}
    out = {k: torch.empty([int(d) for d in e["shape"]],
                          dtype=torch_dtype(e["dtype"]), device=device)
           for k, e in entries.items()}
    fds = _open_files(path, entries)
    try:
        crcs = _pool_map(_read_array, {
            k: (out[k].reshape(-1).view(torch.uint8), fds[e["file"]],
                int(e["offset"]), int(e["nbytes"]))
            for k, e in entries.items()},
            {k: int(e["nbytes"]) for k, e in entries.items()})
    finally:
        for fd in fds.values():
            os.close(fd)
    bad = sorted(k for k, e in entries.items() if crcs[k] != e["crc32"])
    if bad:
        raise CorruptArray(f"corrupt arrays under {path} (crc32 "
                           f"mismatch): {bad}")
    return out


def _hash_stored(fd: int, pos: int, n: int) -> str:
    h = hashlib.sha256()
    buf = np.empty(min(CHUNK, max(n, 1)), np.uint8)
    for off in range(0, n, CHUNK):
        part = buf[:min(CHUNK, n - off)]
        _pread_into(fd, part, pos + off)
        h.update(part)
    return "sha256:" + h.hexdigest()


def stored_checksums(path: str, entries: Dict[str, dict]) -> Dict[str, Any]:
    """sha256 of each stored array's bytes, read from its data file (in
    parallel); an array that cannot be read maps to its exception."""
    def one(fd, pos, n):
        try:
            return _hash_stored(fd, pos, n)
        except (OSError, EOFError) as e:
            return e
    fds = _open_files(path, entries)
    try:
        return _pool_map(one, {k: (fds[e["file"]], int(e["offset"]),
                                   int(e["nbytes"]))
                               for k, e in entries.items()},
                         {k: int(e["nbytes"]) for k, e in entries.items()})
    finally:
        for fd in fds.values():
            os.close(fd)
