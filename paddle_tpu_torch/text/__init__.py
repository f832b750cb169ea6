"""Tokenizers, token sources and the LM / MLM blocks of training
(≙ `paddle_tpu/text/__init__.py` whole), numpy only, kept as the port's
own copies: the same numpy generators, so the same seeds give the same
ids and the same masked blocks.

- `ByteTokenizer` (ids 0..255 are bytes, the specials follow), `Vocab`
  and `WordTokenizer` (whitespace words over a built vocabulary), and
  the byte-level BPE of `bpe` (`BPETokenizer`, encoded by the native
  library).
- Token sources: `SyntheticTokens` (seeded uniform ids) and `FileTokens`
  (a ``.bin`` of uint16 / uint32 ids as a read-only memmap, or a text
  file tokenized on load); `encode_file` writes such a ``.bin``.
- `LMBlockDataset` / `MLMBlockDataset`: the blocks the recipes batch
  through `io.DataLoader`.
- `viterbi_decode` / `ViterbiDecoder`: the CRF max-score path in plain
  PyTorch (JAX runs it in XLA as two scans; no kernel on either side).
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, Optional

import numpy as np
import torch

from ..io import Dataset

__all__ = ["ByteTokenizer", "WordTokenizer", "Vocab", "LMBlockDataset",
           "MLMBlockDataset", "SyntheticTokens", "FileTokens",
           "encode_file", "BPETokenizer", "viterbi_decode",
           "ViterbiDecoder"]


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


class Vocab:
    """token <-> id table, the specials first."""

    def __init__(self, tokens: Iterable[str],
                 specials=("<pad>", "<unk>", "<s>", "</s>", "<mask>")):
        self.itos = list(specials) + [t for t in tokens
                                      if t not in set(specials)]
        self.stoi = {t: i for i, t in enumerate(self.itos)}
        self.unk_id = self.stoi.get("<unk>", 0)

    def __len__(self):
        return len(self.itos)

    def __getitem__(self, tok: str) -> int:
        return self.stoi.get(tok, self.unk_id)


class WordTokenizer:
    """Whitespace words over a `Vocab` (lowercased by default); `build`
    keeps the ``max_vocab`` most common words, ties in first-seen
    order."""

    def __init__(self, vocab: Vocab, lowercase: bool = True):
        self.vocab = vocab
        self.lowercase = lowercase

    @staticmethod
    def build(texts: Iterable[str], max_vocab: int = 30000,
              lowercase: bool = True) -> "WordTokenizer":
        c: Counter = Counter()
        for t in texts:
            c.update((t.lower() if lowercase else t).split())
        toks = [w for w, _ in c.most_common(max_vocab)]
        return WordTokenizer(Vocab(toks), lowercase)

    @property
    def vocab_size(self):
        return len(self.vocab)

    @property
    def pad_id(self):
        return self.vocab.stoi.get("<pad>")

    @property
    def mask_id(self):
        return self.vocab.stoi.get("<mask>")

    def encode(self, text: str):
        t = text.lower() if self.lowercase else text
        return np.asarray([self.vocab[w] for w in t.split()], np.int32)

    def decode(self, ids):
        return " ".join(self.vocab.itos[int(i)] for i in np.asarray(
            ids).ravel() if 0 <= int(i) < len(self.vocab))


class SyntheticTokens:
    """Deterministic synthetic token stream: ``length`` ids drawn
    uniformly from ``[0, vocab_size)`` by numpy's default generator
    seeded with ``seed`` — the JAX package's stream, id for id."""

    def __init__(self, vocab_size: int, length: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(0, vocab_size, length, dtype=np.int32)
        self.vocab_size = vocab_size


class FileTokens:
    """A token stream from a file. ``.bin``: a header-less flat array of
    ids (``dtype``, uint16 by default; uint32 for a vocabulary past
    65536) mapped read-only, ``vocab_size`` one past its largest id;
    any other name: text read as UTF-8 and encoded by ``tokenizer``
    (`ByteTokenizer` by default), ``vocab_size`` the tokenizer's."""

    def __init__(self, path: str, tokenizer=None, dtype=None):
        if path.endswith(".bin"):
            self.ids = np.memmap(path, dtype=dtype or np.uint16, mode="r")
            self.vocab_size = int(self.ids.max()) + 1 if len(self.ids) \
                else 0
        else:
            tok = tokenizer or ByteTokenizer()
            with open(path, "r", encoding="utf-8") as f:
                self.ids = tok.encode(f.read())
            self.vocab_size = tok.vocab_size


def encode_file(src_txt: str, dst_bin: str, tokenizer=None,
                dtype=np.uint16) -> int:
    """Tokenize a text file into a flat ``.bin`` of ``dtype`` ids (the
    JAX package's bytes); returns the token count."""
    tok = tokenizer or ByteTokenizer()
    with open(src_txt, "r", encoding="utf-8") as f:
        ids = tok.encode(f.read())
    np.asarray(ids, dtype).tofile(dst_bin)
    return len(ids)


class LMBlockDataset(Dataset):
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


class MLMBlockDataset(Dataset):
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


from .bpe import BPETokenizer  # noqa: E402


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """The CRF max-score path (≙ the JAX `viterbi_decode`).
    ``potentials`` (B, T, N) emission scores, ``transition_params`` (N,
    N) with the same tag dim. With ``include_bos_eos_tag`` the last tag
    is BOS and the one before it EOS: the start scores are
    ``transitions[-1]``, the stop scores ``transitions[:, -2]``, and the
    decode runs over all N tags. ``lengths`` (B,) stops a shorter
    sequence: past its end its score and tag stand still. Ties go to the
    lowest tag (`torch.max` returns the first maximum, as
    ``jnp.argmax``). Returns (scores (B,), paths (B, T)
    int32) on the potentials' device."""
    pot = torch.as_tensor(potentials)
    tr = torch.as_tensor(transition_params, device=pot.device)
    n_tags = pot.shape[-1]
    if tuple(tr.shape) != (n_tags, n_tags):
        raise ValueError(
            "viterbi_decode: transition_params must be square with the "
            "same tag dim as potentials (got transitions "
            f"{tuple(tr.shape)} vs potentials tag dim {n_tags}). With "
            "include_bos_eos_tag=True the tag dim includes BOS/EOS: "
            "start=transitions[-1], stop=transitions[:, -2].")
    if include_bos_eos_tag and n_tags < 3:
        raise ValueError(
            "viterbi_decode: include_bos_eos_tag=True needs at least one "
            f"real label besides BOS/EOS (got num_tags={n_tags})")
    b, t, n = pot.shape
    tr = tr.to(pot.dtype)
    if include_bos_eos_tag:
        start, stop = tr[-1, :], tr[:, -2]
    else:
        start = stop = torch.zeros(n, dtype=pot.dtype, device=pot.device)
    ln = torch.full((b,), t, dtype=torch.int32, device=pot.device) \
        if lengths is None else torch.as_tensor(
            lengths, device=pot.device).to(torch.int32)
    tags = torch.arange(n, device=pot.device)[None, :]
    alpha = pot[:, 0] + start[None, :]
    backptrs = []
    for pos in range(1, t):
        s = alpha[:, :, None] + tr[None, :, :]
        best, prev = s.max(dim=1)
        live = (pos < ln)[:, None]
        alpha = torch.where(live, best + pot[:, pos], alpha)
        backptrs.append(torch.where(live, prev, tags))
    scores, last = (alpha + stop[None, :]).max(dim=-1)
    tag, rev = last, []
    for pos, ptrs in zip(range(t - 1, 0, -1), reversed(backptrs)):
        prev = torch.gather(ptrs, 1, tag[:, None])[:, 0]
        tag = torch.where(pos < ln, prev, tag)
        rev.append(tag)
    paths = torch.stack(rev[::-1] + [last], dim=1)
    return scores, paths.to(torch.int32)


class ViterbiDecoder:
    """``ViterbiDecoder(transitions)(potentials, lengths)`` =
    `viterbi_decode` with the stored transitions."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
