"""Vocabulary + GloVe word-embedding table (SURVEY.md C7).

Loads the standard ``glove.*.300d.txt`` text format when real files exist;
in this air-gapped environment a deterministic synthetic table stands in
(hash-seeded per word, unit-norm) so tests and fixtures are reproducible
without network access.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, List, Sequence

import numpy as np

PAD, UNK = "<pad>", "<unk>"
_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> List[str]:
    """Lowercase word tokenizer: alphanumerics + apostrophes."""
    return _TOKEN_RE.findall(text.lower())


class Vocab:
    """Word <-> id map with fixed <pad>=0 and <unk>=1 slots."""

    def __init__(self, words: Iterable[str], max_size: int = 0):
        uniq: List[str] = []
        seen = set()
        for w in words:
            if w not in seen and w not in (PAD, UNK):
                seen.add(w)
                uniq.append(w)
        if max_size:
            uniq = uniq[: max(0, max_size - 2)]
        self.itos: List[str] = [PAD, UNK] + uniq
        self.stoi: Dict[str, int] = {w: i for i, w in enumerate(self.itos)}

    def __len__(self) -> int:
        return len(self.itos)

    def encode(self, tokens: Sequence[str], max_len: int):
        """-> (ids [max_len] int32 padded with 0, true length int32 >= 1)."""
        ids = [self.stoi.get(t, 1) for t in tokens][:max_len]
        if not ids:
            ids = [1]  # empty query -> single <unk>
        n = len(ids)
        out = np.zeros(max_len, dtype=np.int32)
        out[:n] = ids
        return out, np.int32(n)

    @classmethod
    def from_corpus(cls, texts: Iterable[str], max_size: int = 0) -> "Vocab":
        counts: Dict[str, int] = {}
        for t in texts:
            for w in tokenize(t):
                counts[w] = counts.get(w, 0) + 1
        ordered = sorted(counts, key=lambda w: (-counts[w], w))
        return cls(ordered, max_size=max_size)


def _word_vector(word: str, dim: int) -> np.ndarray:
    """Deterministic unit-norm pseudo-GloVe vector from a word hash."""
    seed = int.from_bytes(
        hashlib.sha256(word.encode("utf-8")).digest()[:8], "little"
    )
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dim).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-8)


def synthetic_glove(vocab: Vocab, dim: int = 300) -> np.ndarray:
    """``[V, dim]`` table: <pad> row is zeros, every other row hash-seeded."""
    table = np.stack(
        [_word_vector(w, dim) for w in vocab.itos], axis=0
    ).astype(np.float32)
    table[0] = 0.0  # <pad>
    return table


def load_glove(path: str, vocab: Vocab, dim: int = 300) -> np.ndarray:
    """Load real ``glove.6B.300d.txt``-format vectors for ``vocab``.

    Words absent from the file keep their synthetic hash vector (documented
    OOV behavior); <pad> stays zero.
    """
    table = synthetic_glove(vocab, dim)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            w = parts[0]
            idx = vocab.stoi.get(w)
            if idx is not None and idx >= 1:
                table[idx] = np.asarray(parts[1:], dtype=np.float32)
    table[0] = 0.0
    return table
