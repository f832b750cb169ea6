"""Byte-level BPE tokenizer: train, encode, decode, save and load
(≙ `paddle_tpu/text/bpe.py`).

The base vocabulary is the 256 bytes; merge rank r makes id 256 + r, so
there is no unknown token and any bytes round-trip. Training merges the
most frequent adjacent pair, again and again (Sennrich 2016), ties to
the pair seen first, and stops at ``vocab_size`` or when no pair occurs
twice. Encoding runs on the native library (`_native.bpe_encode_native`,
``csrc/native.cc``): greedy merging of the lowest-rank pair present.
`BPETokenizer._encode_py` is the same rule in Python, kept as the
tests' reference for the native encoder.
"""
from __future__ import annotations

import json
from collections import Counter

import numpy as np

from .._native import bpe_encode_native

__all__ = ["BPETokenizer"]


class BPETokenizer:
    def __init__(self, merges=None):
        # merges: (left id, right id) pairs in rank order
        self.merges = [tuple(m) for m in (merges or [])]
        self._rank = {m: r for r, m in enumerate(self.merges)}
        self._ml = np.asarray([m[0] for m in self.merges], np.int32)
        self._mr = np.asarray([m[1] for m in self.merges], np.int32)
        self._bytes = {i: bytes([i]) for i in range(256)}
        for r, (a, b) in enumerate(self.merges):
            self._bytes[256 + r] = self._bytes[a] + self._bytes[b]

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    @classmethod
    def train(cls, corpus, vocab_size: int = 512) -> "BPETokenizer":
        """``corpus``: str, bytes or an iterable of them; learns up to
        ``vocab_size - 256`` merges."""
        if isinstance(corpus, (str, bytes)):
            corpus = [corpus]
        seqs = [list(c.encode("utf-8") if isinstance(c, str) else c)
                for c in corpus]
        merges = []
        for r in range(max(0, vocab_size - 256)):
            counts: Counter = Counter()
            for s in seqs:
                counts.update(zip(s[:-1], s[1:]))
            if not counts:
                break
            (a, b), freq = counts.most_common(1)[0]
            if freq < 2:
                break
            merges.append((int(a), int(b)))
            seqs = [_merge(s, a, b, 256 + r) for s in seqs]
        return cls(merges)

    def _encode_py(self, data: bytes) -> np.ndarray:
        toks = list(data)
        while True:
            best_r = len(self.merges)
            for pair in zip(toks[:-1], toks[1:]):
                best_r = min(best_r, self._rank.get(pair, best_r))
            if best_r == len(self.merges):
                break
            a, b = self.merges[best_r]
            toks = _merge(toks, a, b, 256 + best_r)
        return np.asarray(toks, np.int32)

    def encode(self, text) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        if not data:
            return np.zeros((0,), np.int32)
        return bpe_encode_native(data, self._ml, self._mr)

    def decode(self, ids) -> str:
        data = b"".join(self._bytes[int(i)] for i in np.asarray(ids)
                        .reshape(-1))
        return data.decode("utf-8", errors="replace")

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            return cls(json.load(f)["merges"])


def _merge(seq, a, b, new_id):
    """``seq`` with each non-overlapping (a, b), left to right, as
    ``new_id``."""
    out, i = [], 0
    while i < len(seq):
        if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out
