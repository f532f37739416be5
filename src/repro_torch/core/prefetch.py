"""LLM prefetching pipeline (paper §4.3): a layer-streamed executor.

The paper replaces FlexGen's fixed next-layer prefetch with a *queue*:
future layers stream host->device continuously, bounded only by free
memory; the queue is shallow during prefill (activations occupy memory)
and deep during decode.  :class:`PrefetchPolicy` sets that depth (the
partition streamer sizes its lookahead with the same policy) and
:class:`StreamedExecutor` runs the queue.

On the card each streamed layer lives in one pinned host buffer, its
tensors at 256-byte-aligned offsets, so staging a layer is one
host-to-device copy.  A buffer is allocated at its exact size and
page-locked in place (``cudaHostRegister``): the caching host allocator
behind ``pin_memory=True`` rounds a request up to a power of two (32 GiB
for one of jamba's 20.1 GB layers) and keeps what it freed.  The copies
run on a stream of their own into a ring of ``depth + 1`` device slots,
each the size of the largest layer, allocated once, at the first pass
(so a caller whose weights sit on the card can drop them once the
executor has pinned its copy, before the ring takes their room): a
``ready`` event per slot orders each layer's compute after its copy, and
a ``freed`` event per slot, recorded on the compute stream after the
layer that read it, orders the next copy into that slot after the read.
Each layer runs through ``transformer.apply_layer``, the code the
resident ``Model`` runs, so a streamed pass gives the resident pass's
logits bit for bit.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.model import init_cache

ALIGN = 256        # byte alignment of each tensor in a packed layer


@dataclass
class PrefetchPolicy:
    """Phase-aware queue depth (conservative prefill, aggressive decode)."""

    max_depth: int = 8
    prefill_depth: int = 1

    def depth(self, phase: str, free_bytes: float,
              layer_bytes: float) -> int:
        if free_bytes == float("inf"):
            cap = self.max_depth
        else:
            cap = int(free_bytes // max(layer_bytes, 1.0))
        if phase == "prefill":
            return max(1, min(self.prefill_depth, cap))
        return max(1, min(self.max_depth, cap))


# (path of keys, shape, dtype, byte offset) of each tensor of a packed layer
Layout = List[Tuple[Tuple[str, ...], torch.Size, torch.dtype, int]]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pinned(nbytes: int) -> torch.Tensor:
    """A host byte buffer of ``nbytes``, page-locked in place; unlocked
    when the tensor is freed.  Its pages are touched first by a fill that
    runs on every intra-op thread, so registering locks pages already
    present rather than faulting each in on the one calling thread."""
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    cudart = torch.cuda.cudart()
    err = int(cudart.cudaHostRegister(buf.data_ptr(), nbytes, 0))
    if err != 0:
        raise RuntimeError(f"could not pin {nbytes} B of host memory for a "
                           f"streamed layer (cudaHostRegister: {err})")
    weakref.finalize(buf, cudart.cudaHostUnregister, buf.data_ptr())
    return buf


def _pack_layout(layer) -> Tuple[Layout, int]:
    """Byte offsets of a layer's tensors in one flat buffer; its size."""
    layout: Layout = []
    off = 0
    for path, t in _leaves(layer):
        layout.append((path, t.shape, t.dtype, off))
        off += -(-_nbytes(t) // ALIGN) * ALIGN
    return layout, off


def _views(buf: torch.Tensor, layout: Layout) -> Dict[str, Any]:
    """The layer's parameter dict as views into the flat byte buffer."""
    out: Dict[str, Any] = {}
    for path, shape, dtype, off in layout:
        n = shape.numel() * dtype.itemsize
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = buf[off:off + n].view(dtype).view(shape)
    return out


class StreamedExecutor:
    """Layer-streamed prefill/decode with a host->device prefetch queue.

    The offloading mode of the generators (``streamed=True``): ``top``
    (the token table where the frontend has one, the final norm,
    ``lm_head``) and layers ``< resident_layers``
    live on the device; every other layer stays in host memory and
    streams through the device once a pass, ``policy.depth(phase, ...)``
    layers ahead of the compute.  ``device`` defaults to CUDA and raises
    when it is absent; on the CPU staging hands over the host tensors and
    copies nothing, in the same order.  Caches are the ``Model``'s
    ``{"blocks": [...]}`` dicts, written in place; the calls return
    logits.
    """

    def __init__(self, cfg: ModelConfig, params, policy: PrefetchPolicy,
                 device: DeviceLike = None, resident_layers: int = 0,
                 free_bytes: float = float("inf")):
        transformer._check_family(cfg)
        transformer.refuse_encdec(
            cfg, "the streamed executor (the reference's streamed prefill "
            "drops enc_embeds)")
        self.cfg = cfg
        self.policy = policy
        self.device = resolve_device(device)
        self.free_bytes = free_bytes
        self._kinds: List[LayerKind] = cfg.layer_kinds()
        blocks = params["blocks"]
        self.n_layers = len(blocks)
        self.resident = min(resident_layers, self.n_layers)
        self.layer_bytes = (sum(_nbytes(t) for lp in blocks
                                for _, t in _leaves(lp))
                            / max(self.n_layers, 1))
        self.top = _to({k: v for k, v in params.items() if k != "blocks"},
                       self.device)
        self._resident = [_to(lp, self.device)
                          for lp in blocks[:self.resident]]
        streamed = blocks[self.resident:]
        self.streamed_bytes = sum(_nbytes(t) for lp in streamed
                                  for _, t in _leaves(lp))
        self.passes = 0               # layer passes run (prefill, chunk, decode)
        self.staged_bytes = 0         # bytes handed to the device by staging
        depth = max(policy.depth(p, free_bytes, self.layer_bytes)
                    for p in ("prefill", "decode"))
        self.ring_slots = min(depth + 1, len(streamed))
        self.slot_bytes = 0           # the largest packed layer, on the card
        self._cuda = self.device.type == "cuda"
        if not self._cuda:
            self._host = [_to(lp, self.device) for lp in streamed]
            return
        # pinned host copies, one flat buffer a layer
        self._layouts: List[Layout] = []
        self._host = []
        for lp in streamed:
            layout, size = _pack_layout(lp)
            buf = _pinned(size)
            for (_, t), (_, shape, dtype, off) in zip(_leaves(lp), layout):
                buf[off:off + _nbytes(t)].view(dtype).view(shape).copy_(t)
            self._layouts.append(layout)
            self._host.append(buf)
            self.slot_bytes = max(self.slot_bytes, size)
        self._ring: Optional[torch.Tensor] = None     # allocated by reserve
        self._copy = torch.cuda.Stream(device=self.device)
        self._ready = [torch.cuda.Event() for _ in range(self.ring_slots)]
        self._freed = [torch.cuda.Event() for _ in range(self.ring_slots)]

    @property
    def ring_nbytes(self) -> int:
        """Device bytes of the ring: ``ring_slots`` slots of the largest
        streamed layer (0 on the CPU, where nothing is copied)."""
        return self.ring_slots * self.slot_bytes if self._cuda else 0

    @property
    def device_nbytes(self) -> int:
        """Device bytes the executor holds while it runs: ``top``, the
        resident layers and the ring (on the CPU: ``top`` and the
        resident layers)."""
        held = sum(_nbytes(t) for _, t in _leaves(self.top))
        held += sum(_nbytes(t) for lp in self._resident
                    for _, t in _leaves(lp))
        return held + self.ring_nbytes

    def reserve(self) -> None:
        """Allocate the ring now (the first pass does it otherwise)."""
        if self._cuda and self._ring is None:
            self._ring = torch.empty((self.ring_slots, self.slot_bytes),
                                     dtype=torch.uint8, device=self.device)

    # ------------------------------------------------------------ helpers
    def _stage(self, i: int) -> Tuple[Dict[str, Any], int]:
        """Queue streamed layer ``i``'s host-to-device copy into its ring
        slot; returns its parameters (views of the slot) and the slot."""
        j = i - self.resident
        slot = j % self.ring_slots
        if not self._cuda:
            return self._host[j], slot
        host = self._host[j]
        with torch.cuda.stream(self._copy):
            # write after read: the layer that last read this slot is done
            self._copy.wait_event(self._freed[slot])
            self._ring[slot, :host.numel()].copy_(host, non_blocking=True)
            self._ready[slot].record(self._copy)
        self.staged_bytes += host.numel()
        return _views(self._ring[slot], self._layouts[j]), slot

    def _stream(self, x: torch.Tensor, caches, pos, mode: str,
                block_tab=None, kv_span=None):
        """Every layer over ``x``, staging ``depth`` layers ahead of the
        compute; returns the stream and the last layer's pending output."""
        depth = self.policy.depth(
            "prefill" if mode in ("prefill", "chunk") else "decode",
            self.free_bytes, self.layer_bytes)
        if min(depth + 1, len(self._host)) > self.ring_slots:
            raise RuntimeError(f"depth {depth} needs more than the "
                               f"{self.ring_slots} ring slots sized at "
                               "construction (policy or free_bytes changed)")
        self.reserve()
        compute = (torch.cuda.current_stream(self.device) if self._cuda
                   else None)
        staged: Dict[int, Tuple[Dict[str, Any], Optional[int]]] = {}

        def ensure(i: int) -> None:
            if i >= self.n_layers or i in staged:
                return
            staged[i] = (self._resident[i], None) if i < self.resident \
                else self._stage(i)

        for i in range(min(depth, self.n_layers)):     # warm the queue
            ensure(i)
        layer_mode = "prefill" if mode == "chunk" else mode
        delta = None
        for i in range(self.n_layers):
            ensure(i + depth)                          # keep the queue full
            lp, slot = staged.pop(i)
            if compute is not None and slot is not None:
                compute.wait_event(self._ready[slot])  # read after write
            x, delta = transformer.apply_layer(
                lp, x, delta, self.cfg, self._kinds[i], mode=layer_mode,
                cache=caches["blocks"][i], pos=pos, block_tab=block_tab,
                kv_span=kv_span)
            if compute is not None and slot is not None:
                self._freed[slot].record(compute)
        self.passes += 1
        return x, delta

    # ------------------------------------------------------------- public
    def prefill(self, inputs: torch.Tensor, caches) -> torch.Tensor:
        """Whole prompts ``inputs`` (B, S) of token ids, or (B, S, D) of
        embeddings for the ``embed`` frontend, into dense ``caches``;
        returns the last-position logits (B, V)."""
        cfg = self.cfg
        x = transformer._embed_inputs(self.top, cfg, inputs)
        x, delta = self._stream(x, caches, None, "prefill")
        x = transformer._final_norm(self.top, cfg, x[:, -1:], delta[:, -1:])
        return transformer.unembed(self.top, cfg, x)[:, 0]

    def decode(self, inputs: torch.Tensor, caches, pos: torch.Tensor,
               slot_mask=None, block_tab: Optional[torch.Tensor] = None,
               kv_span: Optional[int] = None) -> torch.Tensor:
        """One decode step; ``slot_mask`` (B,) marks live slot rows.

        A step where no slot is live returns zero logits before any layer
        streams and leaves the caches untouched.  Dead rows of a mixed
        step ride the batched compute: dense rows are overwritten by the
        next join's scatter, and paged rows' block tables point at the
        trash page (parked slots included), so their writes never land in
        a live page.
        """
        cfg = self.cfg
        if slot_mask is not None and not bool(
                torch.as_tensor(slot_mask).any()):
            return torch.zeros((inputs.shape[0], cfg.vocab_size),
                               dtype=self.top["final_norm"].dtype,
                               device=self.device)
        x = transformer._embed_inputs(self.top, cfg, inputs)
        x, delta = self._stream(x, caches, pos, "decode",
                                block_tab=block_tab, kv_span=kv_span)
        x = transformer._final_norm(self.top, cfg, x, delta)
        return transformer.unembed(self.top, cfg, x)[:, 0]

    def prefill_chunk(self, inputs: torch.Tensor, caches,
                      offset: torch.Tensor,
                      block_tab: Optional[torch.Tensor] = None,
                      kv_span: Optional[int] = None) -> torch.Tensor:
        """Prefill one prompt chunk at per-sequence start ``offset`` (B,).

        The layers stream once a chunk at the prefill depth; the chunk's
        KV lands at ``[offset, offset + C)`` and its attention spans the
        cache written by earlier chunks.  Returns the chunk's
        last-position logits (B, V)."""
        cfg = self.cfg
        x = transformer._embed_inputs(self.top, cfg, inputs)
        x, delta = self._stream(x, caches, offset, "chunk",
                                block_tab=block_tab, kv_span=kv_span)
        x = transformer._final_norm(self.top, cfg, x[:, -1:], delta[:, -1:])
        return transformer.unembed(self.top, cfg, x)[:, 0]

    def init_caches(self, batch: int, cache_len: int,
                    dtype=torch.float32) -> Dict[str, Any]:
        """Zeroed dense caches on the device (the ``Model``'s layout)."""
        return init_cache(self.cfg, batch, cache_len, dtype, self.device)

    def layer_kinds(self) -> List[LayerKind]:
        """Mixer kinds per streamed layer (for paged cache construction)."""
        return list(self._kinds)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
