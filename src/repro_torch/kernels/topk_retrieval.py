"""Retrieval top-k and the masked partition merge: CUDA C++ kernels for
Hopper, their launch counts and their plain versions.

Replaces ``src/repro/kernels/topk_retrieval.py::topk_pallas`` (exact
inner-product top-k of queries against one partition, global row ids,
pad rows never surfacing) and ``::topk_merge_pallas`` (fuse ``(Q, P, k)``
per-partition scoreboards under a ``(Q, P)`` probe mask, masked entries
becoming ``(-1e30, -1)``).

Both return score descending, then lower position first on ties, which
is ``jax.lax.top_k``'s order; fewer than ``k`` candidates leave a
``(-1e30, -1)`` tail.  What bounds them on the H100 (bytes: one pass
over the partition for the top-k, a few KB for the merge) and how the
design handles it is in ``csrc/topk_retrieval.cu``: the top-k is one
launch that streams the partition with wide loads straight to registers,
keeps a running list per query, and merges the blocks' lists in the last
block to finish.  That block finds itself by a ticket: one counter per query
tile, kept per CUDA stream (calls on one stream run in order) and left at
zero by every launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import topk_merge_reference as topk_merge_plain
from repro_torch.kernels.ref import topk_reference as topk_plain

MAX_K = 64          # the kernels' bound on k (a warp's list holds 64)
MERGE_ROUNDS_MAX = 512   # the merge's k-rounds selection: one row chunk
MAX_DIM = 7000      # the wrapper's bound on D (the kernel streams any)
QUERY_TILE = 8      # queries a top-k block scores: one ticket each
_P = ctypes.c_void_p
_I = ctypes.c_int
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_MAX_BLOCKS = 128   # csrc/topk_retrieval.cu's kMaxBlocks: checked at load


def _lib() -> ctypes.CDLL:
    lib = _build.library("topk_retrieval")
    if lib.retrieval_topk.argtypes is None:
        lib.topk_max_blocks.argtypes = []
        lib.topk_max_blocks.restype = _I
        lib.topk_launch_shape.argtypes = [_I, _I, _I, _P]
        lib.topk_launch_shape.restype = None
        if lib.topk_max_blocks() != _MAX_BLOCKS:
            raise RuntimeError("topk_retrieval: the library's block bound "
                               f"{lib.topk_max_blocks()} != {_MAX_BLOCKS}")
        lib.retrieval_topk.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        lib.retrieval_topk.restype = _I
        lib.retrieval_topk_merge.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.retrieval_topk_merge.restype = _I
    return lib


def launch_shape(q: int, n: int, d: int) -> Dict[str, int]:
    """The top-k kernel's launch shape for (q, d) x (n, d) on the current
    card, as the library computes it for a launch."""
    out = (ctypes.c_int * 4)()
    _lib().topk_launch_shape(q, n, d + -d % 4, ctypes.addressof(out))
    return dict(zip(("blocks", "query_tiles", "threads", "rows"), out))


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range [1, {MAX_K}]")


def topk_cuda(queries: torch.Tensor, database: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) x (N, D) fp32 on CUDA -> (Q, k) fp32 scores, int32 row ids."""
    _check_k(k)
    if not (queries.is_cuda and database.is_cuda):
        raise ValueError("topk_cuda takes CUDA tensors")
    if database.dtype != torch.float32:
        raise ValueError(f"the kernel takes a float32 database, "
                         f"got {database.dtype}")
    qn, d = queries.shape
    n = database.shape[0]
    if database.shape[1] != d or n == 0 or qn == 0 or d > MAX_DIM:
        raise ValueError(f"shapes {tuple(queries.shape)} x "
                         f"{tuple(database.shape)}")
    lib = _lib()
    q = _build.aligned16(queries.float())
    db = _build.aligned16(database)
    if d % 4:                       # the bulk copies move 16-byte spans
        q = torch.nn.functional.pad(q, (0, 4 - d % 4))
        db = torch.nn.functional.pad(db, (0, 4 - d % 4))
    stream = _build.current_stream(q.device)
    key = (q.device.index, stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() * QUERY_TILE < qn:
        tickets = torch.zeros(-(-qn // QUERY_TILE) + 7, dtype=torch.int32,
                              device=q.device)
        _TICKETS[key] = tickets
    # one allocation: scores, ids, then the blocks' (Q, k, blocks) lists
    part = qn * k * _MAX_BLOCKS
    buf = torch.empty(2 * (qn * k + part), dtype=torch.int32, device=q.device)
    out = buf.data_ptr()
    err = lib.retrieval_topk(
        q.data_ptr(), db.data_ptr(), out + 8 * qn * k,
        out + 8 * qn * k + 4 * part, tickets.data_ptr(), out,
        out + 4 * qn * k, qn, n, db.shape[1], k, stream)
    if err:
        _build.check(lib, err, "retrieval_topk")
    out_s, out_i = buf[:2 * qn * k].view(2, qn, k).unbind(0)
    topk_cuda.launches += 1
    return out_s.view(torch.float32), out_i


def _merge(part_scores: torch.Tensor, part_ids: torch.Tensor,
           mask: torch.Tensor, k: int, variant: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_k(k)
    qn, parts, kk = part_scores.shape
    if part_ids.shape != part_scores.shape or mask.shape != (qn, parts):
        raise ValueError(f"shapes {tuple(part_scores.shape)} "
                         f"{tuple(part_ids.shape)} {tuple(mask.shape)}")
    if kk != k:
        raise ValueError(f"board depth {kk} != k={k}")
    if variant == 1 and parts * k > MERGE_ROUNDS_MAX:
        raise ValueError(f"k rounds over a row of {parts * k} entries")
    if not (part_scores.is_cuda and part_ids.is_cuda and mask.is_cuda):
        raise ValueError("topk_merge_cuda takes CUDA tensors")
    lib = _lib()
    s = part_scores.float().contiguous()
    i = part_ids.to(torch.int32).contiguous()
    m = mask.to(torch.bool).contiguous().view(torch.uint8)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=s.device)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=s.device)
    err = lib.retrieval_topk_merge(
        s.data_ptr(), i.data_ptr(), m.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), qn, parts, k, variant,
        _build.current_stream(s.device))
    _build.check(lib, err, "retrieval_topk_merge")
    return out_s, out_i


def topk_merge_cuda(part_scores: torch.Tensor, part_ids: torch.Tensor,
                    mask: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, P, k) boards + (Q, P) mask on CUDA -> (Q, k) scores, int32 ids.

    The selection follows the shape: k rounds over registers for rows of
    at most ``MERGE_ROUNDS_MAX`` entries and k <= 32, else the sorted
    warp list."""
    out = _merge(part_scores, part_ids, mask, k, 0)
    topk_merge_cuda.launches += 1
    return out


def _merge_selection(part_scores: torch.Tensor, part_ids: torch.Tensor,
                     mask: torch.Tensor, k: int, rounds: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge with its selection forced (k rounds, or the warp list)
    whatever the shape: the card tests hold both against the plain
    version, ``chip_smoke.py`` times both.  Not counted as a launch."""
    return _merge(part_scores, part_ids, mask, k, 1 if rounds else 2)


topk_cuda.launches = 0
topk_merge_cuda.launches = 0

__all__ = ["topk_cuda", "topk_merge_cuda", "topk_plain", "topk_merge_plain"]
