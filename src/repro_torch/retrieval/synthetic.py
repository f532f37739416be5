"""Synthetic clustered corpora for IVF evaluation (benchmarks + tests).

Real encoder embeddings are clustered (topics); the hash embedder's are
not.  These helpers generate Gaussian blobs on the unit sphere — the
regime where cluster pruning is meaningful — shared by the fig11 sweep
and the IVF recall tests so the two can't silently diverge.
"""
from __future__ import annotations

import numpy as np


def blob_corpus(n: int, dim: int, clusters: int, seed: int = 0,
                spread: float = 0.35) -> np.ndarray:
    """Gaussian blobs on the unit sphere; ``spread`` is the expected
    *norm* of the within-cluster noise (scaled by 1/sqrt(dim) per axis so
    the cluster structure survives in high dimension)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    v = centers[rng.integers(0, clusters, size=n)]
    v = v + (spread / np.sqrt(dim)) * rng.normal(size=(n, dim))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def perturb_queries(vecs: np.ndarray, n_queries: int, seed: int = 0,
                    spread: float = 0.2) -> np.ndarray:
    """Queries as noisy copies of corpus points (non-trivial ground truth)."""
    rng = np.random.default_rng(seed)
    dim = vecs.shape[1]
    base = vecs[rng.integers(0, len(vecs), size=n_queries)]
    q = base + (spread / np.sqrt(dim)) * rng.normal(size=base.shape)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def zipf_queries(vecs: np.ndarray, groups, n_queries: int,
                 alpha: float = 1.2, seed: int = 0,
                 spread: float = 0.2) -> np.ndarray:
    """Zipf-skewed queries over partition groups.

    The group at popularity rank ``r`` (its position in ``groups``) is
    drawn with probability ∝ ``1 / r**alpha``; each query is a perturbed
    member of its group — the skewed-traffic regime a device-hot
    partition tier exploits (a few partitions absorb most probes).
    ``groups`` is a sequence of corpus-row index arrays, e.g. the
    per-partition ``doc_ids`` of a built ``VectorStore``.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(groups) + 1, dtype=np.float64)
    pmf = ranks ** -float(alpha)
    pmf /= pmf.sum()
    dim = vecs.shape[1]
    picks = rng.choice(len(groups), size=n_queries, p=pmf)
    base = np.stack([vecs[groups[g][rng.integers(len(groups[g]))]]
                     for g in picks])
    q = base + (spread / np.sqrt(dim)) * rng.normal(size=base.shape)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


class ArrayEmbedder:
    """Maps text "<i>" to row i of a precomputed matrix — lets
    ``VectorStore.build`` ingest a synthetic corpus."""

    def __init__(self, vecs: np.ndarray):
        self.vecs = vecs
        self.dim = vecs.shape[1]

    def embed(self, texts) -> np.ndarray:
        return self.vecs[[int(t) for t in texts]]
