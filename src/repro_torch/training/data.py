"""Synthetic data pipeline: plain LM batches + RAG-augmented batches.

The port of ``repro.training.data``: numpy draws in the same order from
the same seed, so the same ``DataConfig`` gives the reference's arrays.
The RAG variant builds each sample the way the serving system builds
prompts: retrieve top-k chunks for a synthetic query from a real
``VectorStore``, concatenate, tokenize with the same hash tokenizer.
Batches are numpy ``int32`` arrays; the caller moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.generator import HashTokenizer


@dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0


class SyntheticLM:
    """Deterministic token stream with local structure (Zipf + ngram)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self.rng = np.random.default_rng(data.seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        v = self.cfg.vocab_size
        b, s = self.data.batch, self.data.seq_len
        while True:
            # zipfian unigram mixture + shifted-copy structure so the LM has
            # something learnable
            base = self.rng.zipf(1.3, size=(b, s + 1)) % v
            shift = np.roll(base, 3, axis=1)
            mask = self.rng.random((b, s + 1)) < 0.3
            toks = np.where(mask, shift, base).astype(np.int32)
            yield {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


class RagAugmented:
    """Batches whose prompts are built by real retrieval."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, store,
                 embedder, top_k: int = 3):
        self.cfg = cfg
        self.data = data
        self.store = store
        self.embedder = embedder
        self.top_k = top_k
        self.tok = HashTokenizer(cfg.vocab_size)
        self.rng = np.random.default_rng(data.seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        b, s = self.data.batch, self.data.seq_len
        n_chunks = len(self.store.chunks)
        while True:
            qids = self.rng.integers(0, n_chunks, size=b)
            queries = [self.store.chunks[i][:64] for i in qids]
            q_emb = self.embedder.embed(queries)
            _, ids = self.store.search(q_emb, self.top_k)
            prompts = [" ".join(chs) + " " + q for chs, q in
                       zip(self.store.get_chunks(np.asarray(ids)), queries)]
            toks = np.stack([self.tok.encode(p, s + 1) for p in prompts])
            yield {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


__all__ = ["DataConfig", "SyntheticLM", "RagAugmented"]
