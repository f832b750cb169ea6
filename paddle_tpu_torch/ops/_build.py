"""Build the CUDA sources in `paddle_tpu_torch/csrc/` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (``lib<name>-<hash>.so``), loaded with
`ctypes`. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds and an unchanged
source is reused. Several sources build in parallel:
one ``nvcc`` process per source, all started together. Nothing is built
when a module is imported — only when a kernel is first launched or
`build` is called.

The build directory is ``build/paddle_tpu_torch/`` at the root of the
checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# --split-compile 0: nvcc optimises a source's many kernel instances (the
# flash sources hold 63 each) in parallel on every host core
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")

_LIBS: dict = {}


BUILD_DIR = CSRC.parents[1] / "build" / "paddle_tpu_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built only where the CUDA "
            "toolkit is installed")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names=None) -> dict:
    """Compile every named source (default: all of ``csrc/*.cu``) that
    has no library for its current hash yet, all in parallel. Returns
    ``{name: library path}``; raises RuntimeError with the compiler's
    output when a build fails."""
    names = sources() if names is None else list(names)
    out = {n: _target(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log,
                                     stderr=subprocess.STDOUT),
                    log, tmp, p)
    failed = []
    for n, (proc, log, tmp, p) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{n} (nvcc exit {rc}):\n"
                          f"{p.with_suffix('.log').read_text()[-4000:]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's output of `name`'s last build (``-Xptxas -v``
    prints registers, shared memory and spills per kernel)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def kernel_fn(name: str, symbol: str, argtypes):
    """C entry `symbol` of ``csrc/<name>.cu`` with its argument types
    declared (pointers as ``c_void_p``, so none is cut to 32 bits) and
    an int result: the entry's ``cudaGetLastError()``."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn
