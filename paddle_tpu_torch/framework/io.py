"""paddle.save / paddle.load for torch tensors.

≙ `paddle_tpu/framework/io.py` :17-101, the same container: the magic
``PTPU0001``, then a pickle of the object with every tensor replaced by a
`_TensorPayload` (dtype name, shape, raw row-major bytes, their crc32,
``stop_gradient``, ``is_parameter``, ``name``). bfloat16 crosses as its
raw 16-bit words, so no numpy bfloat16 is needed; the crc is
`zlib.crc32`, the IEEE polynomial of the JAX package's native codec and
its fallback. `load` reads this package's files and the JAX package's:
it maps the JAX payload class onto this one by name, without importing
it.

Layouts differ where the two packages' modules do: a JAX ``Linear``
weight is (in, out), a torch one (out, in). A JAX file of a Llama state
dict therefore reaches a port model through
`models.convert.llama_state_from_numpy`::

    sd = load("llama.pdparams", return_numpy=True)   # JAX names, layout
    model.load_state_dict(llama_state_from_numpy(sd, model))

`load` puts tensors on the CUDA card unless the caller names a device
(``device="cpu"``); ``return_numpy=True`` gives numpy arrays instead
(bfloat16 has no numpy dtype here and is refused).
"""
from __future__ import annotations

import os
import pickle
import zlib

import numpy as np
import torch

__all__ = ["save", "load"]

_MAGIC = b"PTPU0001"
# the JAX package's payload class, as its pickles name it
_JAX_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


def dtype_name(dt) -> str:
    """The JAX package's name of a torch or numpy dtype ("bfloat16",
    "float32", "int64")."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class _TensorPayload:
    """Pickle surrogate for a tensor: its bytes and flags, under the JAX
    payload's attribute names."""

    def __init__(self, t: torch.Tensor):
        host = t.detach().cpu().contiguous()
        self.dtype = dtype_name(host.dtype)
        self.shape = tuple(host.shape)
        self.data = host.reshape(-1).view(torch.uint8).numpy().tobytes()
        self.crc = zlib.crc32(self.data) & 0xFFFFFFFF
        self.stop_gradient = not t.requires_grad
        self.is_parameter = isinstance(t, torch.nn.Parameter)
        self.name = getattr(t, "name", None)

    def restore(self, device) -> torch.Tensor:
        crc = getattr(self, "crc", None)
        if crc is not None and zlib.crc32(self.data) & 0xFFFFFFFF != crc:
            raise ValueError(f"corrupt tensor payload for {self.name!r} "
                             "(crc32 mismatch)")
        flat = torch.frombuffer(bytearray(self.data), dtype=torch.uint8)
        t = flat.view(torch_dtype(self.dtype)).reshape(self.shape).to(device)
        if self.is_parameter:
            return torch.nn.Parameter(t, requires_grad=not self.stop_gradient)
        return t


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_PAYLOAD:
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise TypeError("bfloat16 has no numpy dtype here; load with "
                        "return_numpy=False")
    return t.detach().numpy()


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        t = obj.restore("cpu" if return_numpy else device)
        return _to_numpy(t) if return_numpy else t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """≙ paddle.save: a state dict, nested containers or a tensor, to a
    path or a writable binary file object."""
    if hasattr(path, "write"):
        path.write(_MAGIC)
        pickle.dump(_pack(obj), path, protocol=protocol)
        return
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, device=None, **configs):
    """≙ paddle.load, of this package's files and the JAX package's.
    Tensors land on ``device``, the CUDA card by default."""
    if not return_numpy:
        from ..ops import resolve_device
        device = resolve_device(device)
    if hasattr(path, "read"):
        if path.read(len(_MAGIC)) != _MAGIC:
            raise ValueError("not a paddle_tpu checkpoint stream")
        return _unpack(_Unpickler(path).load(), return_numpy, device)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path} is not a paddle_tpu checkpoint")
        return _unpack(_Unpickler(f).load(), return_numpy, device)
