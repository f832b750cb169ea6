"""Datasets, samplers and the DataLoader (≙ `paddle_tpu/io/__init__.py`).

The loader batches numpy on the host and hands CPU `torch.Tensor`s to
the caller, who moves them to the card once a step. With
``num_workers > 0`` it forks worker processes that push codec-encoded
batches through the native shared-memory ring (`_native.ShmRing`,
``csrc/native.cc``); the parent puts them back in order and makes the
tensors. That route needs the native library and raises if it cannot be
built. The thread prefetcher is taken only where the JAX loader takes
it: ``use_shared_memory=False``, a custom ``collate_fn`` or an iterable
dataset.

Forked workers stay numpy-only: the parent may hold a CUDA context, and
a forked child that touches CUDA hangs or fails. A worker reads the
dataset, stacks numpy columns and encodes them; it makes no tensor.

Shuffling. JAX's `RandomSampler` draws from an unseeded
``np.random.default_rng()`` and drops the ``generator`` it is given. The
port does the same when ``generator`` is None and draws from the given
``np.random.Generator`` otherwise, so a caller that passes one (the
recipes pass ``np.random.default_rng(seed)``) repeats its order.
`random_split` draws its permutation from ``generator`` when given, else
from ``np.random.default_rng(torch.initial_seed())``, as JAX draws from
its global seed.
"""
from __future__ import annotations

import itertools
import math
import os
import pickle
import queue
import signal
import struct
import threading

import numpy as np
import torch

from .. import _native


def _to_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class Dataset:
    """Map-style dataset. ≙ paddle.io.Dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Item i = the i-th row of each tensor (numpy arrays become CPU
    tensors)."""

    def __init__(self, tensors):
        self.tensors = [_to_tensor(t) for t in tensors]
        n = len(self.tensors[0])
        assert all(len(t) == n for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint `Subset`s of the given lengths (or fractions summing to
    1, the remainder handed out one by one from the first)."""
    n = len(dataset)
    if all(isinstance(l, float) for l in lengths) and abs(
            sum(lengths) - 1.0) < 1e-6:
        counts = [int(math.floor(n * l)) for l in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    rng = generator if generator is not None \
        else np.random.default_rng(torch.initial_seed())
    perm = rng.permutation(n)
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l].tolist()))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, uniform draws) of the
    indices; ``generator`` is an ``np.random.Generator`` or None (an
    unseeded one each epoch, as JAX)."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self.generator if self.generator is not None \
            else np.random.default_rng()
        if self.replacement:
            yield from rng.integers(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """Indices drawn by weight from an unseeded generator, as JAX's."""

    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(
            weights.detach().cpu().numpy()
            if isinstance(weights, torch.Tensor) else weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        yield from np.random.default_rng().choice(
            len(self.weights), self.num_samples, replace=self.replacement,
            p=p).tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """≙ paddle.io.BatchSampler."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shards the index stream over data-parallel ranks (the defaults:
    the initialised process group's world size and rank, else 1 and 0).
    ≙ paddle.io.DistributedBatchSampler."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            indices = np.random.default_rng(self.epoch).permutation(n)
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stack samples into batched CPU tensors (numpy first, one
    conversion): ints as int64, floats as float32, strings as a list,
    dicts and tuples field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(list(batch))
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    return batch


class _PrefetchIterator:
    """Background-thread prefetcher (``num_workers > 0`` off the
    shared-memory route)."""

    def __init__(self, gen_fn, num_workers, prefetch_factor):
        self._q: queue.Queue = queue.Queue(maxsize=max(
            2, num_workers * prefetch_factor))
        self._done = object()
        self._exc = None

        def run():
            try:
                for item in gen_fn():
                    self._q.put(item)
            except BaseException as e:  # propagate to consumer
                self._exc = e
            finally:
                self._q.put(self._done)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


def _host_array(x):
    """A sample field as numpy, without touching a device: a torch
    tensor off the CPU raises TypeError (it goes pickled instead)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise TypeError("device tensor in a worker")
        return x.numpy()
    return np.asarray(x)


class _ShmWorkerIterator:
    """Forked workers and the native shared-memory ring (≙ the JAX
    `_ShmWorkerIterator`): worker w builds batches w, w + N, w + 2N, ...
    as numpy, encodes each field through the codec (tag 0; a field that
    does not stack goes pickled, tag 1) and pushes ``[seq u64][n
    u32]([tag u8][len u64][payload])*`` records into one ring; the
    parent reorders by seq and makes the tensors. A worker that dies is
    reported at the parent's next wait, not after the whole timeout."""

    _POLL_MS = 200

    def __init__(self, dataset, batches, num_workers, capacity_mb=64,
                 timeout_ms=60000):
        self.dataset = dataset
        self.batches = batches
        self.timeout_ms = timeout_ms
        name = f"/pdt_dl_{os.getpid()}_{id(self) & 0xFFFFFF:x}"
        self.ring = _native.ShmRing(name, capacity=capacity_mb << 20)
        self._expected = 0
        self._held = {}
        self._n = len(batches)
        self._pids = []
        self._worker_status = {}
        for w in range(num_workers):
            pid = os.fork()
            if pid == 0:
                code = 0
                try:
                    self._worker(name, w, num_workers)
                except BaseException:
                    import traceback
                    traceback.print_exc()
                    code = 1
                finally:
                    os._exit(code)
            self._pids.append(pid)

    # -- worker side ---------------------------------------------------------
    def _worker(self, name, w, num_workers):
        ring = _native.ShmRing(name, create=False)
        for seq in range(w, self._n, num_workers):
            fields = self._to_fields(
                [self.dataset[i] for i in self.batches[seq]])
            msg = [struct.pack("<Q", seq), struct.pack("<I", len(fields))]
            for tag, payload in fields:
                msg.append(struct.pack("<BQ", tag, len(payload)))
                msg.append(payload)
            ring.push(b"".join(msg), timeout_ms=self.timeout_ms)

    @staticmethod
    def _to_fields(samples):
        """Collate to numpy per field; codec-encode arrays, pickle the
        rest."""
        sample = samples[0]
        cols = list(zip(*samples)) if isinstance(sample, (tuple, list)) \
            else [samples]
        fields = []
        for col in cols:
            try:
                arr = np.stack([_host_array(c) for c in col])
                if arr.dtype == object:
                    raise TypeError
                fields.append((0, _native.encode_tensor(arr)))
            except (TypeError, ValueError):
                fields.append((1, pickle.dumps(list(col))))
        return fields

    # -- parent side ---------------------------------------------------------
    @staticmethod
    def _decode(raw):
        seq = struct.unpack_from("<Q", raw, 0)[0]
        nf = struct.unpack_from("<I", raw, 8)[0]
        off = 12
        fields = []
        for _ in range(nf):
            tag, ln = struct.unpack_from("<BQ", raw, off)
            off += 9
            payload = raw[off:off + ln]
            off += ln
            if tag == 0:
                fields.append(_to_tensor(_native.decode_tensor(payload)))
            else:
                fields.append(pickle.loads(payload))
        return seq, (fields[0] if len(fields) == 1 else tuple(fields))

    def __iter__(self):
        return self

    def _dead_worker(self):
        for pid in list(self._pids):
            done, st = os.waitpid(pid, os.WNOHANG)
            if done:
                self._pids.remove(pid)
                self._worker_status[pid] = st
                if st != 0:
                    return pid
        return None

    def _pop(self):
        waited = 0
        while waited < self.timeout_ms:
            raw = self.ring.pop(timeout_ms=self._POLL_MS)
            if raw is not None:
                return raw
            waited += self._POLL_MS
            if self._dead_worker() is not None:
                break
        self._shutdown()
        raise RuntimeError(
            "DataLoader worker timeout/death (shm ring empty); "
            f"worker exit statuses: {self._worker_status}")

    def __next__(self):
        if self._expected >= self._n:
            self._shutdown()
            raise StopIteration
        while self._expected not in self._held:
            seq, batch = self._decode(self._pop())
            self._held[seq] = batch
        out = self._held.pop(self._expected)
        self._expected += 1
        return out

    def _shutdown(self):
        # SIGTERM, then a blocking reap: a worker abandoned mid-iteration
        # may be blocked pushing into the ring
        pids, self._pids = self._pids, []
        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        for pid in pids:
            try:
                _, st = os.waitpid(pid, 0)
                self._worker_status[pid] = st
            except ChildProcessError:
                pass
        self.ring.close()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass


class DataLoader:
    """≙ paddle.io.DataLoader: batches of CPU tensors from a map-style
    dataset (through ``batch_sampler``, or a `BatchSampler` of
    ``batch_size`` / ``shuffle`` / ``drop_last``) or an iterable one.
    ``feed_list``, ``places``, ``return_list``, ``use_buffer_reader``,
    ``timeout``, ``worker_init_fn`` and ``persistent_workers`` are
    accepted and unused, as in JAX."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = prefetch_factor
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size or 1,
                drop_last=drop_last)

    def _gen(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            if self.batch_size is None:
                for item in it:
                    yield self.collate_fn([item])
                return
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers and self.num_workers > 0:
            if self.use_shared_memory and not self._iterable_mode and \
                    self.collate_fn is default_collate_fn:
                return _ShmWorkerIterator(self.dataset,
                                          list(self.batch_sampler),
                                          self.num_workers)
            return _PrefetchIterator(self._gen, self.num_workers,
                                     self.prefetch_factor)
        return self._gen()

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)


def get_worker_info():
    """None, as in JAX: workers carry no per-worker info."""
    return None


__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "default_collate_fn", "DataLoader",
           "get_worker_info"]
