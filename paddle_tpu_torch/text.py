"""Token sources and next-token blocks for language-model training.

≙ `paddle_tpu/text/__init__.py` :125-131 (`SyntheticTokens`) and
:166-181 (`LMBlockDataset`), numpy only, kept as the port's own copies.
The loader is `torch.utils.data.DataLoader` (the recipe gives its
shuffle a seeded `torch.Generator`). `FileTokens` and the tokenizers are
not ported yet (ROADMAP.md queue A, item 16).
"""
from __future__ import annotations

import numpy as np


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
