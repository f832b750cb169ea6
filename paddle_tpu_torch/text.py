"""Token sources, a tokenizer and the LM / MLM blocks of training.

≙ `paddle_tpu/text/__init__.py` :27-69 (`ByteTokenizer`), :125-131
(`SyntheticTokens`), :166-181 (`LMBlockDataset`) and :184-218
(`MLMBlockDataset`), numpy only, kept as the port's own copies: the same
numpy generators, so the same seeds give the same ids and the same
masked blocks. The loader is `torch.utils.data.DataLoader` (the recipes
give its shuffle a seeded `torch.Generator`). `FileTokens`, `Vocab`,
`WordTokenizer` and the BPE tokenizer are not ported yet (ROADMAP.md
queue A, item 6).
"""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 are bytes, the specials
    follow (``<pad>`` 256 .. ``<mask>`` 260 by default). No files, no
    out-of-vocabulary ids, exact round trip."""

    def __init__(self, specials=("<pad>", "<unk>", "<s>", "</s>",
                                 "<mask>")):
        self.specials = list(specials)
        self._special_ids = {s: 256 + i for i, s in enumerate(specials)}

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.specials)

    @property
    def pad_id(self):
        return self._special_ids.get("<pad>")

    @property
    def mask_id(self):
        return self._special_ids.get("<mask>")

    @property
    def bos_id(self):
        return self._special_ids.get("<s>")

    @property
    def eos_id(self):
        return self._special_ids.get("</s>")

    def encode(self, text: str, add_bos=False, add_eos=False):
        ids = list(text.encode("utf-8"))
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        if add_eos and self.eos_id is not None:
            ids = ids + [self.eos_id]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in np.asarray(ids).ravel() if 0 <= i < 256)
        return bs.decode("utf-8", errors="replace")


class SyntheticTokens:
    """Deterministic synthetic token stream: ``length`` ids drawn
    uniformly from ``[0, vocab_size)`` by numpy's default generator
    seeded with ``seed`` — the JAX package's stream, id for id."""

    def __init__(self, vocab_size: int, length: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(0, vocab_size, length, dtype=np.int32)
        self.vocab_size = vocab_size


class LMBlockDataset:
    """Next-token-prediction blocks: item i = (input [S], label [S]) from
    a flat token stream, the label the input shifted by one."""

    def __init__(self, source, seq_len: int):
        self.ids = np.asarray(source.ids, np.int32)
        self.seq_len = seq_len
        self.n = max((len(self.ids) - 1) // seq_len, 0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        s = self.seq_len
        chunk = self.ids[i * s: i * s + s + 1]
        return chunk[:-1].copy(), chunk[1:].copy()


class MLMBlockDataset:
    """BERT-style masked-LM blocks: item i = (masked input [S], labels
    [S]) from a flat token stream. Each position is picked with
    probability ``mask_prob`` (at least one a block); labels are
    ``ignore_label`` except at picked positions, which hold the original
    id; a picked position becomes ``mask_id`` (80%), a random id below
    ``vocab_size`` (10%) or stays (10%). Item i draws from numpy's
    default generator seeded with ``seed * 1_000_003 + i``, as in JAX."""

    def __init__(self, source, seq_len: int, mask_id: int,
                 vocab_size=None, mask_prob: float = 0.15, seed: int = 0,
                 ignore_label: int = -100):
        self.ids = np.asarray(source.ids, np.int32)
        self.seq_len = seq_len
        self.mask_id = mask_id
        self.vocab_size = vocab_size or source.vocab_size
        self.mask_prob = mask_prob
        self.seed = seed
        self.ignore = ignore_label
        self.n = max(len(self.ids) // seq_len, 0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        s = self.seq_len
        block = self.ids[i * s:(i + 1) * s].copy()
        labels = np.full(s, self.ignore, np.int32)
        pick = rng.random(s) < self.mask_prob
        if not pick.any():
            pick[rng.integers(0, s)] = True
        labels[pick] = block[pick]
        r = rng.random(s)
        block[pick & (r < 0.8)] = self.mask_id
        rand = pick & (r >= 0.8) & (r < 0.9)
        block[rand] = rng.integers(0, self.vocab_size,
                                   rand.sum(), dtype=np.int32)
        return block, labels
