"""The port's data pipeline (`paddle_tpu_torch.io`, `_native`, `text`)
against the JAX package's `paddle_tpu.io`, `paddle_tpu._native` and
`paddle_tpu.text`, on the CPU. Everything here is exact: sampler orders,
batches, codec bytes, BPE merges and ids, `.bin` bytes and Viterbi paths
are compared for equality (the Viterbi scores, f32 sums in the same
order, within 1e-6).

- samplers: lengths and orders (sequence; random from a seeded
  ``np.random.Generator``, which the JAX sampler has no way to take;
  the distributed shards against JAX's);
- `random_split` against JAX's under the same seed, the collate of dicts
  and tuples against JAX's `default_collate_fn`;
- `DataLoader` batches against JAX's for the same order: inline, with
  shared-memory workers, and on the thread route (a custom collate, an
  iterable dataset); a worker that dies is reported at once;
- the shared-memory ring: order, wraparound, timeout, a record too large;
- the codec: bytes equal to JAX's `encode_tensor` for f32 / bf16 / int64
  / 0-d / empty arrays (and a dtype name too long for the header), a
  flipped payload byte caught by the crc; a failed build raises;
- BPE: merges and ids equal to JAX's, the native encode against the
  plain one, save / load, decode;
- `encode_file` bytes equal to JAX's, `FileTokens` on ``.bin`` and
  ``.txt``; `Vocab` / `WordTokenizer`; `viterbi_decode` against JAX's.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import _native as jnative
from paddle_tpu import io as jio
from paddle_tpu import text as jtext
from paddle_tpu_torch import _native as tnative
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import text as ttext


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


class _Pairs(tio.Dataset):
    """Item i: (int32 row of 5, float32 scalar-array, python int)."""

    def __init__(self, n=23):
        rng = np.random.default_rng(0)
        self.x = rng.integers(0, 100, (n, 5)).astype(np.int32)
        self.y = rng.standard_normal(n).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i:i + 1], int(i)


def test_sampler_lengths_and_orders():
    ds = list(range(10))
    assert list(tio.SequenceSampler(ds)) == list(range(10))
    r = tio.RandomSampler(ds, generator=np.random.default_rng(3))
    assert list(r) == np.random.default_rng(3).permutation(10).tolist()
    r = tio.RandomSampler(ds, replacement=True, num_samples=4,
                          generator=np.random.default_rng(4))
    assert len(r) == 4
    assert list(r) == np.random.default_rng(4).integers(0, 10, 4).tolist()
    assert sorted(tio.RandomSampler(ds)) == list(range(10))
    w = tio.WeightedRandomSampler([0.0, 1.0, 0.0], 5)
    assert list(w) == [1] * 5 and len(w) == 5
    for drop in (False, True):
        jb = jio.BatchSampler(ds, batch_size=4, drop_last=drop)
        tb = tio.BatchSampler(ds, batch_size=4, drop_last=drop)
        assert list(tb) == list(jb) and len(tb) == len(jb)
    for shuffle in (False, True):
        for rank in (0, 1, 2):
            j = jio.DistributedBatchSampler(ds, 2, num_replicas=3,
                                            rank=rank, shuffle=shuffle)
            t = tio.DistributedBatchSampler(ds, 2, num_replicas=3,
                                            rank=rank, shuffle=shuffle)
            j.set_epoch(2)
            t.set_epoch(2)
            assert list(t) == list(j) and len(t) == len(j)
    assert tio.DistributedBatchSampler(ds, 4).nranks == 1


def test_random_split_and_datasets_match_jax():
    ds = list(range(17))
    paddle.seed(5)
    for lengths in ([10, 7], [0.5, 0.3, 0.2]):
        j = jio.random_split(ds, lengths)
        t = tio.random_split(ds, lengths,
                             generator=np.random.default_rng(5))
        assert [s.indices for s in t] == [s.indices for s in j]
    with pytest.raises(ValueError, match="sum of lengths"):
        tio.random_split(ds, [3, 3])
    a, b = _Pairs(5), _Pairs(4)
    cat = tio.ConcatDataset([a, b])
    assert len(cat) == 9 and np.array_equal(cat[6][0], b[1][0])
    assert np.array_equal(cat[-1][0], b[3][0])
    comp = tio.ComposeDataset([a, b])
    assert len(comp) == 4 and len(comp[0]) == 6
    assert [v for v in tio.ChainDataset([[1, 2], [3]])] == [1, 2, 3]
    td = tio.TensorDataset([np.arange(6).reshape(3, 2), torch.ones(3)])
    assert torch.equal(td[1][0], torch.tensor([2, 3])) and len(td) == 3
    assert tio.get_worker_info() is None


def test_collate_dicts_and_tuples_match_jax():
    batch = [{"ids": np.arange(3, dtype=np.int32) + i, "w": 0.5 * i,
              "n": i, "tag": f"s{i}", "pair": (np.float32(i), [i, i])}
             for i in range(4)]
    j = jio.default_collate_fn(batch)
    t = tio.default_collate_fn(batch)
    assert t.keys() == j.keys() and t["tag"] == j["tag"]
    for k in ("ids", "w", "n"):
        assert isinstance(t[k], torch.Tensor)
        assert np.array_equal(t[k].numpy(), _np(j[k]))
    # Python ints collate to int64, as numpy gives them (JAX's tensors
    # hold them as int32: JAX runs without 64-bit types)
    assert (t["ids"].dtype, t["w"].dtype, t["n"].dtype) == (
        torch.int32, torch.float32, torch.int64)
    assert isinstance(t["pair"], tuple)
    assert np.array_equal(_np(t["pair"][0]), _np(j["pair"][0]))
    assert all(np.array_equal(_np(a), _np(b))
               for a, b in zip(t["pair"][1], j["pair"][1]))
    ts = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert ts.shape == (2, 2)


def _jax_batches(ds, batch_size=4, **kw):
    return [tuple(_np(f) for f in b)
            for b in jio.DataLoader(ds, batch_size=batch_size, **kw)]


@pytest.mark.parametrize("workers", [0, 2], ids=["inline", "shm_workers"])
def test_loader_batches_match_jax(workers):
    """The port's batches equal JAX's inline loader's (sequence order,
    the last partial batch kept): CPU tensors, int32 / float32 / int64
    (the Python-int column; int32 in JAX's tensors)."""
    ds = _Pairs()
    want = _jax_batches(ds)
    got = list(tio.DataLoader(ds, batch_size=4, num_workers=workers))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert len(g) == 3
        assert [a.dtype for a in g] == [torch.int32, torch.float32,
                                        torch.int64]
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert np.array_equal(a.numpy(), b)


def test_shm_route_and_thread_route():
    """A seeded shuffle through 3 shared-memory workers gives the inline
    loader's batches; a custom collate and an iterable dataset take the
    thread prefetcher (as in JAX), with the inline batches too."""
    ds = _Pairs(40)

    def loader(workers, **kw):
        bs = tio.BatchSampler(sampler=tio.RandomSampler(
            ds, generator=np.random.default_rng(9)), batch_size=6,
            drop_last=True)
        return tio.DataLoader(ds, batch_sampler=bs, num_workers=workers,
                              **kw)
    inline = list(loader(0))
    it = iter(loader(3))
    assert isinstance(it, tio._ShmWorkerIterator)
    shm = list(it)
    assert len(shm) == len(inline) == 6
    for a, b in zip(shm, inline):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def collate(items):
        return tio.default_collate_fn(items)
    it = iter(loader(2, collate_fn=collate))
    assert isinstance(it, tio._PrefetchIterator)
    for a, b in zip(it, inline):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(range(7))
    got = list(tio.DataLoader(Stream(), batch_size=3, num_workers=2))
    want = [_np(b) for b in jio.DataLoader(
        jio.ChainDataset([range(7)]), batch_size=3)]
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert len(tio.DataLoader(ds, batch_size=6, drop_last=True)) == 6


class _Broken(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("no item 5")
        return np.zeros(2, np.float32)


def test_dead_worker_is_reported_at_once(capfd):
    """A worker whose dataset raises exits 1; the parent reports it at
    its next wait, not after the minute of the ring's timeout."""
    it = tio.DataLoader(_Broken(), batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="worker"):
        list(it)
    assert "no item 5" in capfd.readouterr().err


def test_ring_order_wraparound_timeout_and_size():
    name = f"/pdt_test_ring_{os.getpid()}"
    ring = tnative.ShmRing(name, capacity=64)
    try:
        # records of 8 + 20 bytes: the third wraps around the 64 bytes
        for i in range(6):
            assert ring.push(bytes([i]) * 20)
            assert ring.pop() == bytes([i]) * 20
        assert ring.push(b"a" * 20) and ring.push(b"b" * 20)
        assert not ring.push(b"c" * 20, timeout_ms=20)   # full
        assert ring.pop() == b"a" * 20 and ring.pop() == b"b" * 20
        assert ring.pop(timeout_ms=20) is None              # empty
        with pytest.raises(ValueError, match="larger than ring"):
            ring.push(b"x" * 57)
        peer = tnative.ShmRing(name, create=False)
        peer.push(b"from a peer")
        assert ring.pop() == b"from a peer"
        peer.close()
    finally:
        ring.close()
    with pytest.raises(OSError):
        tnative.ShmRing(name, create=False)


CODEC_ARRAYS = [
    ("f32", np.random.default_rng(0).standard_normal((3, 4))
     .astype(np.float32)),
    ("bf16", np.random.default_rng(1).standard_normal((2, 5))
     .astype(ml_dtypes.bfloat16)),
    ("int64", np.arange(12, dtype=np.int64).reshape(2, 2, 3)),
    ("0d", np.array(3.25, np.float32)),
    ("empty", np.zeros((0, 3), np.float32)),
    ("long_name", np.array(["2020-01-01"], dtype="datetime64[ns]")),
]


@pytest.mark.parametrize("case", CODEC_ARRAYS, ids=[c[0] for c in CODEC_ARRAYS])
def test_codec_bytes_match_jax(case):
    _, arr = case
    buf = tnative.encode_tensor(arr)
    assert buf == jnative.encode_tensor(arr)
    out = tnative.decode_tensor(buf)
    if isinstance(out, torch.Tensor):      # bfloat16: a torch tensor
        assert out.dtype == torch.bfloat16
        out = out.view(torch.int16).numpy()
        arr = arr.view(np.int16)
    assert out.tobytes() == np.ascontiguousarray(arr).tobytes()
    assert tnative.decode_tensor(jnative.encode_tensor(arr)).tobytes() \
        == np.ascontiguousarray(arr).tobytes()


def test_codec_torch_tensors_crc_and_build_failure(tmp_path, monkeypatch):
    t = torch.randn(4, 3).bfloat16()
    ref = t.float().numpy().astype(ml_dtypes.bfloat16)
    assert tnative.encode_tensor(t) == jnative.encode_tensor(ref)
    assert torch.equal(tnative.decode_tensor(tnative.encode_tensor(t)), t)
    buf = bytearray(tnative.encode_tensor(np.arange(8, dtype=np.float32)))
    buf[-3] ^= 0x10
    with pytest.raises(ValueError, match="crc32"):
        tnative.decode_tensor(bytes(buf))
    with pytest.raises(ValueError, match="magic"):
        tnative.decode_tensor(b"XXXX" + bytes(buf[4:]))
    assert tnative.crc32(b"paddle") == jnative.crc32(b"paddle")
    assert tnative.library_path().parent.parts[-2:] == ("build",
                                                        "paddle_tpu_torch")
    bad = tmp_path / "native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.load()


@pytest.fixture(scope="module")
def corpus():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "README.md"), encoding="utf-8") as f:
        return f.read()[:6000]


def test_bpe_merges_and_ids_match_jax(corpus, tmp_path):
    j = jtext.BPETokenizer.train(corpus, vocab_size=300)
    t = ttext.BPETokenizer.train(corpus, vocab_size=300)
    assert t.merges == j.merges and t.vocab_size == j.vocab_size == 300
    ids = t.encode(corpus)
    assert ids.dtype == np.int32
    assert np.array_equal(ids, j.encode(corpus))
    assert np.array_equal(ids, t._encode_py(corpus.encode("utf-8")))
    assert t.decode(ids) == corpus
    assert t.encode("").shape == (0,)
    path = str(tmp_path / "bpe.json")
    t.save(path)
    assert ttext.BPETokenizer.load(path).merges == j.merges
    assert jtext.BPETokenizer.load(path).merges == j.merges


def test_encode_file_and_file_tokens_match_jax(corpus, tmp_path):
    src = tmp_path / "c.txt"
    src.write_text(corpus + " héllo ☃", encoding="utf-8")
    tb, jb = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    n = ttext.encode_file(str(src), tb)
    assert n == jtext.encode_file(str(src), jb)
    with open(tb, "rb") as a, open(jb, "rb") as b:
        assert a.read() == b.read()
    for path in (tb, str(src)):
        t, j = ttext.FileTokens(path), jtext.FileTokens(path)
        assert np.array_equal(np.asarray(t.ids), np.asarray(j.ids))
        assert t.vocab_size == j.vocab_size
    wide = str(tmp_path / "w.bin")
    tok = ttext.BPETokenizer.train(corpus[:2000], vocab_size=280)
    ttext.encode_file(str(src), wide, tokenizer=tok, dtype=np.uint32)
    assert np.array_equal(np.asarray(ttext.FileTokens(
        wide, dtype=np.uint32).ids), tok.encode(src.read_text("utf-8")))
    lm = ttext.LMBlockDataset(ttext.FileTokens(tb), 64)
    x, y = lm[1]
    assert np.array_equal(x[1:], y[:-1]) and len(lm) == (n - 1) // 64


def test_vocab_and_word_tokenizer_match_jax():
    texts = ["The cat sat", "the cat ran", "A dog sat on the mat"]
    j = jtext.WordTokenizer.build(texts, max_vocab=5)
    t = ttext.WordTokenizer.build(texts, max_vocab=5)
    assert t.vocab.itos == j.vocab.itos and t.vocab_size == j.vocab_size
    for s in ("the dog sat", "Unknown words here"):
        assert np.array_equal(t.encode(s), j.encode(s))
        assert t.decode(t.encode(s)) == j.decode(j.encode(s))
    assert (t.pad_id, t.mask_id) == (j.pad_id, j.mask_id)
    v = ttext.Vocab(["x", "<pad>", "y"])
    assert len(v) == 7 and v["y"] == 6 and v["zz"] == v.unk_id == 1


@pytest.mark.parametrize("bos_eos", [True, False], ids=["bos_eos", "plain"])
@pytest.mark.parametrize("lengths", [None, [6, 3, 1]],
                         ids=["full", "lengths"])
def test_viterbi_matches_jax(bos_eos, lengths):
    rng = np.random.default_rng(7)
    pot = rng.standard_normal((3, 6, 5)).astype(np.float32)
    trans = rng.standard_normal((5, 5)).astype(np.float32)
    pot[0, 2] = pot[0, 2].max()                # a tie: the lowest tag
    lens = None if lengths is None else np.asarray(lengths, np.int64)
    js, jp = jtext.viterbi_decode(
        paddle.to_tensor(pot), paddle.to_tensor(trans),
        None if lens is None else paddle.to_tensor(lens), bos_eos)
    ts, tp = ttext.ViterbiDecoder(torch.from_numpy(trans), bos_eos)(
        torch.from_numpy(pot), None if lens is None else torch.from_numpy(
            lens))
    assert tp.dtype == torch.int32
    assert np.array_equal(tp.numpy(), _np(jp))
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        ttext.viterbi_decode(pot, trans[:4])
