"""The host side of a checkpoint on one card: how fast its bytes are
hashed, written and read, and what the order of the threads' work does.

    python3 -m paddle_tpu_torch.tools.checkpoint_io [--layers 4] [--turns 2]

Builds the training state of `recipes.llama_pretrain.train_8b_config()`
(Llama-3-8B width, ``--layers`` decoder layers) on the card without
training it: the bf16 weights, and f32 master weights, first and second
moments for every parameter, in the JAX optimizer's keys (`moment1_<i>`,
...), as `ElasticManager` writes them. Then:

* ``hash_scaling {...}``: sha256 and crc32 of 1 GiB per thread at 1, 2,
  4 and 8 threads (distinct buffers, no file), GB/s in all: how far the
  card machine's CPUs let the hashing threads scale;
* ``io {...}`` lines: `storage.write_group` (both groups), a rehash of the
  stored bytes (`storage.stored_checksums`, as the rehash verify tier
  reads them) and `storage.read_group` back onto the card, seconds and
  GB/s, under the two orders the threads can take the arrays in:
  ``largest_first`` (`storage._order`, what the package runs) and
  ``state_order`` (the state dict's own order), in turns (state,
  largest, largest, state for ``--turns 2``); every read is checked
  against the written digests. The files go to a temp directory under
  ``TMPDIR`` and are removed; reads are warm (from the page cache).

Then the card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from unittest import mock

GIB = 1 << 30


def _state(layers: int):
    import torch
    from ..models.llama import LlamaForCausalLM
    from ..recipes.llama_pretrain import train_8b_config
    cfg = train_8b_config()
    cfg.num_hidden_layers = layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    opt = {}
    params = list(model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name in ("moment1", "moment2", "master"):
        for i, p in enumerate(params):
            opt[f"{name}_{i}"] = torch.randn(p.shape, device="cuda",
                                             generator=gen)
    opt["@step"] = 3
    return {"model": dict(model.state_dict()), "opt": opt}


def _threads(n: int, work) -> float:
    """Wall seconds of ``work(i)`` on ``n`` threads at once."""
    ts = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.perf_counter() - t0


def hash_scaling():
    """GB/s of sha256 and crc32 over 1 GiB a thread (both run without
    the interpreter lock); the rates do not depend on the bytes'
    values."""
    import numpy as np
    bufs = [np.full(GIB, i, np.uint8) for i in range(8)]
    kinds = {
        "sha256": lambda i: hashlib.sha256(bufs[i]).digest(),
        "crc32": lambda i: zlib.crc32(bufs[i]),
    }
    out = {}
    for kind, fn in kinds.items():
        fn(0)                                   # warm
        out[kind] = {n: n * GIB / 1e9 / _threads(n, fn)
                     for n in (1, 2, 4, 8)}
    print("hash_scaling " + json.dumps(out), flush=True)


def io_turn(groups, order: str, root: str):
    import torch
    from ..distributed.checkpoint import storage
    patch = mock.patch.object(
        storage, "_order",
        (lambda sizes: list(sizes)) if order == "state_order"
        else storage._order)
    rec = {"order": order}
    with patch:
        for name, sd in groups.items():
            path = os.path.join(root, name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entries = storage.write_group(sd, path)
            w = time.perf_counter() - t0
            n = sum(e["nbytes"] for e in entries.values())
            t0 = time.perf_counter()
            sums = storage.stored_checksums(path,
                                            storage.read_metadata(path))
            h = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = storage.read_group(path, list(entries), "cuda")
            torch.cuda.synchronize()
            r = time.perf_counter() - t0
            ok = all(sums[k] == e["checksum"] for k, e in entries.items())
            del back
            shutil.rmtree(path)
            rec[name] = dict(bytes=n, write_s=w, write_gb_s=n / w / 1e9,
                             rehash_s=h, rehash_gb_s=n / h / 1e9,
                             read_s=r, read_gb_s=n / r / 1e9,
                             digests_equal=ok)
    print("io " + json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("checkpoint_io: needs a CUDA card", file=sys.stderr)
        return 2
    hash_scaling()
    groups = _state(args.layers)
    root = tempfile.mkdtemp(prefix="pdt_ckpt_io_")
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota = f.read().strip()
    except OSError:
        quota = None
    print(f"temp {root}: {shutil.disk_usage(root).free / 1e9:.2f} GB free; "
          f"cpus {os.cpu_count()}, usable {len(os.sched_getaffinity(0))}, "
          f"cgroup cpu.max {quota}", flush=True)
    orders = (["state_order", "largest_first", "largest_first",
               "state_order"] * args.turns)[:2 * args.turns]
    try:
        recs = [io_turn(groups, order, root) for order in orders]
        if not all(r[g]["digests_equal"] for r in recs for g in groups):
            raise AssertionError("a stored array's digest differs from "
                                 "the one written")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
