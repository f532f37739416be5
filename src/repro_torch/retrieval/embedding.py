"""Deterministic text embedder (feature hashing), no external models.

The paper embeds TriviaQA chunks with an off-the-shelf encoder; this
substrate must be self-contained, so we use signed n-gram feature hashing
into D dims + L2 normalization.  It is deterministic, fast, vectorizable,
and preserves the property retrieval needs: similar strings map to nearby
vectors (shared n-grams), so top-k search is meaningful end-to-end.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, List, Sequence

import numpy as np


class HashEmbedder:
    def __init__(self, dim: int = 256, ngram: int = 3, seed: int = 17):
        self.dim = dim
        self.ngram = ngram
        self.seed = seed

    def _hash(self, token: str) -> int:
        h = hashlib.blake2b(token.encode("utf-8"),
                            digest_size=8,
                            key=str(self.seed).encode()).digest()
        return int.from_bytes(h, "little")

    def embed_one(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, np.float32)
        t = text.lower()
        # word unigrams + char n-grams
        feats: List[str] = t.split()
        for i in range(max(len(t) - self.ngram + 1, 0)):
            feats.append(t[i:i + self.ngram])
        for f in feats:
            h = self._hash(f)
            idx = h % self.dim
            sign = 1.0 if (h >> 32) & 1 else -1.0
            v[idx] += sign
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.embed_one(t) for t in texts]).astype(np.float32)
