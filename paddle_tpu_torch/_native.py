"""The host native library: a shared-memory record ring, the tensor codec
and the BPE encoder (≙ `paddle_tpu/_native/__init__.py`).

The C++ source is the repository's ``csrc/native.cc``, the one the JAX
package builds. It is host code (no CUDA): g++ builds it at first use
with ``-O2 -shared -fPIC -std=c++17 -pthread`` into
``build/paddle_tpu_torch/libpaddle_tpu_native-<hash>.so`` (the hash over
the source and the flags, as `ops._build` names its kernels), and
`ctypes` binds it. A failed build or load raises: there is no
pure-Python stand-in, so every user of the library runs the C++ code.

- `ShmRing`: a multi-producer single-consumer ring of variable-length
  records in POSIX shared memory (the `io.DataLoader` workers' channel).
- `encode_tensor` / `decode_tensor`: ``[magic "PTD2"][crc32][dtype
  name, 16 bytes][ndim][shape i64 x ndim][payload]``, the bytes of the
  JAX codec for the same array. A dtype whose name does not fit the
  16-byte field goes as ``b"NPYF"`` + the array's ``.npy`` bytes, as in
  JAX. They take numpy arrays or CPU torch tensors; torch dtypes that
  numpy has no name for here (bfloat16, the float8s) encode from their
  raw bytes under the same names, and decode to torch tensors.
- `crc32`: the IEEE CRC-32 of the codec (equal to `zlib.crc32`).
- `bpe_encode_native`: greedy lowest-rank byte-level BPE merging.
"""
from __future__ import annotations

import ctypes
import hashlib
import io as _io
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "csrc" / "native.cc"
BUILD_DIR = ROOT / "build" / "paddle_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()

# torch dtypes without a numpy dtype here: codec name -> (torch dtype,
# the integer of its width, which carries its bytes)
_TORCH_ONLY = {
    "bfloat16": (torch.bfloat16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8),
}


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libpaddle_tpu_native-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native library "
                           f"({SRC}) cannot be built") from e
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed (g++ exit "
                           f"{e.returncode}):\n{e.stderr[-4000:]}") from e
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built at first use; raises RuntimeError (or
    OSError from the loader) when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        c_void_p, c_uint64 = ctypes.c_void_p, ctypes.c_uint64
        sig = {
            "ring_create": (c_void_p, [ctypes.c_char_p, c_uint64]),
            "ring_attach": (c_void_p, [ctypes.c_char_p]),
            "ring_push": (ctypes.c_int, [c_void_p, ctypes.c_char_p,
                                         c_uint64, ctypes.c_int]),
            "ring_next_len": (ctypes.c_int64, [c_void_p, ctypes.c_int]),
            "ring_pop": (ctypes.c_int64, [c_void_p, c_void_p, c_uint64,
                                          ctypes.c_int]),
            "ring_close": (None, [c_void_p, ctypes.c_int]),
            "codec_header_size": (c_uint64, [ctypes.c_int]),
            "codec_encode": (c_uint64, [c_void_p, c_uint64,
                                        ctypes.c_char_p, c_void_p,
                                        ctypes.c_int, c_void_p]),
            "codec_decode": (c_uint64, [c_void_p, c_uint64,
                                        ctypes.c_char_p, c_void_p,
                                        ctypes.c_int * 1, ctypes.c_int]),
            "codec_crc32": (ctypes.c_uint32, [c_void_p, c_uint64]),
            "bpe_encode": (c_uint64, [ctypes.c_char_p, c_uint64, c_void_p,
                                      c_void_p, c_uint64, c_void_p,
                                      c_uint64]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


def bpe_encode_native(text: bytes, merge_left: np.ndarray,
                      merge_right: np.ndarray) -> np.ndarray:
    """Token ids (int32) of ``text`` under the merge table (rank r
    merges ``(merge_left[r], merge_right[r])`` into id 256 + r)."""
    lib = load()
    ml = np.ascontiguousarray(merge_left, np.int32)
    mr = np.ascontiguousarray(merge_right, np.int32)
    out = np.empty(max(len(text), 1), np.int32)
    n = lib.bpe_encode(text, len(text), ml.ctypes.data, mr.ctypes.data,
                       len(ml), out.ctypes.data, len(out))
    return out[:n].copy()


class ShmRing:
    """Multi-producer single-consumer shared-memory record ring
    (≙ the JAX `ShmRing`). The creator owns the segment and unlinks it
    on `close`; workers `attach` with ``create=False``."""

    def __init__(self, name: str, capacity: int = 64 << 20,
                 create: bool = True):
        self._lib = load()
        self.name = name.encode()
        self._h = self._lib.ring_create(self.name, capacity) if create \
            else self._lib.ring_attach(self.name)
        if not self._h:
            raise OSError(f"shm ring {'create' if create else 'attach'} "
                          f"failed: {name}")
        self._owner = create

    def push(self, data: bytes, timeout_ms: int = 10000) -> bool:
        """Append one record; False on timeout, ValueError when the
        record (with its 8-byte length) exceeds the capacity."""
        rc = self._lib.ring_push(self._h, data, len(data), timeout_ms)
        if rc == -2:
            raise ValueError("record larger than ring capacity")
        return rc == 0

    def pop(self, timeout_ms: int = 10000):
        """The oldest record's bytes, or None on timeout."""
        n = self._lib.ring_next_len(self._h, timeout_ms)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.ring_pop(self._h, buf, int(n), timeout_ms)
        if got < 0:
            return None
        return buf.raw[:got]

    def close(self):
        if self._h:
            self._lib.ring_close(self._h, 1 if self._owner else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _npy_fallback(arr: np.ndarray) -> bytes:
    b = _io.BytesIO()
    np.save(b, arr, allow_pickle=False)
    return b"NPYF" + b.getvalue()


def _host_bytes(arr):
    """(contiguous numpy array of the bytes, dtype name, shape)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = str(t.dtype).split(".")[-1]
        if name in _TORCH_ONLY:
            words = t.view(_TORCH_ONLY[name][1]).numpy()
            return words, name, tuple(t.shape)
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr, str(arr.dtype), arr.shape


def encode_tensor(arr) -> bytes:
    """The codec's bytes of a numpy array or CPU tensor (crc32 over the
    payload); the ``.npy`` form for a dtype name over 15 characters."""
    lib = load()
    data, name, shape = _host_bytes(arr)
    dtype_name = name.encode()
    if len(dtype_name) > 15:
        return _npy_fallback(data)
    nd = len(shape)
    dims = (ctypes.c_int64 * max(nd, 1))(*shape)
    total = int(lib.codec_header_size(nd)) + data.nbytes
    out = ctypes.create_string_buffer(total)
    n = lib.codec_encode(data.ctypes.data, data.nbytes, dtype_name, dims,
                         nd, out)
    if n == 0:
        return _npy_fallback(data)
    return out.raw[:n]


def decode_tensor(buf: bytes):
    """The array of a codec buffer: numpy, or a CPU torch tensor for the
    dtypes of `_TORCH_ONLY`. Raises ValueError on a bad header or a
    crc32 mismatch."""
    if buf[:4] == b"NPYF":
        return np.load(_io.BytesIO(buf[4:]), allow_pickle=False)
    lib = load()
    dtype = ctypes.create_string_buffer(17)
    shape = (ctypes.c_int64 * 8)()
    ndim = (ctypes.c_int * 1)()
    off = lib.codec_decode(buf, len(buf), dtype, shape, ndim, 1)
    if off == 0:
        raise ValueError("codec: bad magic/header")
    if off == ctypes.c_uint64(-1).value:
        raise ValueError("codec: crc32 mismatch (corrupt tensor payload)")
    shp = tuple(shape[i] for i in range(ndim[0]))
    name = dtype.value.decode()
    count = int(np.prod(shp)) if shp else 1
    if name in _TORCH_ONLY:
        tdt, words = _TORCH_ONLY[name]
        raw = np.frombuffer(buf, torch.empty(0, dtype=words).numpy().dtype,
                            count, int(off)).reshape(shp)
        return torch.from_numpy(raw.copy()).view(tdt)
    return np.frombuffer(buf, np.dtype(name), count,
                         int(off)).reshape(shp).copy()


def crc32(data: bytes) -> int:
    return int(load().codec_crc32(data, len(data)))
