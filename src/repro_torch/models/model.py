"""Model facade: init / train / prefill / chunk prefill / decode + cache
specs, and ``input_specs``, the stand-ins for every input of the steps.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import attention, ssm, transformer
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import (MeshContext, gather_params,
                                        param_pspecs, shard_params)


def _layer_cache_spec(cfg: ModelConfig, mixer: str, batch: int,
                      cache_len: int, dtype, kv_format: Optional[str],
                      enc_len: Optional[int], kv_heads: Optional[int] = None):
    if mixer == "mla":
        spec = attention.make_mla_cache_spec(cfg, batch, cache_len, dtype)
    elif mixer == "mamba":
        spec = ssm.make_mamba_cache_spec(cfg, batch, dtype)
    else:
        spec = attention.make_attn_cache_spec(cfg, batch, cache_len, dtype,
                                              kv_format, kv_heads)
    if cfg.encdec and enc_len is not None:
        spec.update(attention.make_cross_cache_spec(cfg, batch, enc_len,
                                                    dtype))
    return spec


def make_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=torch.bfloat16, kv_format: Optional[str] = None,
                     enc_len: Optional[int] = None,
                     kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """Per-layer cache shapes by the layer's mixer: ``{"blocks": [{name:
    (shape, dtype)}] * num_layers}``.  Attention layers: ``k``, ``v`` of
    ``(batch, cache_len, KV, hd)``; the layout serves both caches: a
    dense cache has a row of ``cache_len`` positions per sequence, the
    paged pool passes ``(pages, page_size)`` (``pages`` counting the trash
    page 0), and ``kv_format="int8"`` (paged pools) adds the ``(pages,
    KV)`` fp32 scale leaves.  MLA layers: ``ckv (batch, cache_len, r)``
    and ``krope (batch, cache_len, rd)``; Mamba layers: ``conv (batch,
    d_conv - 1, di + 2GN)`` and the fp32 ``state (batch, H, P, N)``.  An
    encoder-decoder's decoder layers take ``ck``, ``cv`` of ``(batch,
    enc_len, KV, hd)`` too, given ``enc_len`` (the encoder's length).
    Every leaf keeps the row (sequence or page) axis first.  ``kv_heads``
    (a rank's, over a mesh) in place of the config's kv heads."""
    return {"blocks": [_layer_cache_spec(cfg, mixer, batch, cache_len,
                                         dtype, kv_format, enc_len, kv_heads)
                       for mixer, _ in cfg.layer_kinds()]}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None,
               kv_format: Optional[str] = None,
               enc_len: Optional[int] = None,
               kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed caches of :func:`make_cache_specs` on ``device``."""
    device = resolve_device(device)
    specs = make_cache_specs(cfg, batch, cache_len, dtype, kv_format,
                             enc_len, kv_heads)
    return {"blocks": [{name: torch.zeros(shape, dtype=dt, device=device)
                        for name, (shape, dt) in layer.items()}
                       for layer in specs["blocks"]]}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta-device stand-ins (no memory) for every input of a step, by
    the reference's rules: ``train`` the batch (``inputs``, ``labels``,
    ``enc_embeds`` for an encoder-decoder), ``prefill`` the prompts and
    their cache, ``decode`` one token a row, its cache and ``pos``.  An
    encoder-decoder's decoder runs ``max(seq_len * dec_len_ratio, 16)``
    tokens against ``seq_len`` frames; the ``embed`` frontend takes
    embeddings.  Caches are the port's, a flat list of layers."""
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
    dec_len = max(int(s * cfg.dec_len_ratio), 16) if cfg.encdec else s

    def tok_or_embed(n):
        if cfg.frontend == "embed" and not cfg.encdec:
            return _meta((b, n, cfg.d_model), dtype)
        return _meta((b, n), tok)

    def cache(cache_len):
        specs = make_cache_specs(cfg, b, cache_len, dtype,
                                 enc_len=s if cfg.encdec else None)
        return {"blocks": [{k: _meta(*v) for k, v in layer.items()}
                           for layer in specs["blocks"]]}

    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["inputs"] = tok_or_embed(dec_len)
        out["labels"] = _meta((b, dec_len), tok)
    elif shape.kind == "prefill":
        out["inputs"] = tok_or_embed(dec_len)
        out["cache"] = cache(dec_len)
    elif shape.kind == "decode":
        out["inputs"] = tok_or_embed(1)
        out["cache"] = cache(dec_len if cfg.encdec else s)
        out["pos"] = _meta((b,), tok)
    else:
        raise ValueError(shape.kind)
    if cfg.encdec and shape.kind in ("train", "prefill"):
        out["enc_embeds"] = _meta((b, s, cfg.d_model), dtype)
    return out


class Model:
    """Transformer entry point of the served families (dense llama,
    gemma2's local/global layers, gemma's MHA, chatglm3's QKV bias and half
    RoPE, granite's MoE FFN, deepseek-v2-lite's MLA and shared experts,
    mamba2's SSD, jamba's hybrid, chameleon's embedding inputs,
    seamless-m4t's encoder-decoder); parameters live outside, as in JAX.

    ``device`` defaults to CUDA and raises when it is absent; ``init``
    draws random weights from a seeded ``torch.Generator`` on it (a MoE
    router and Mamba's ``A_log``, ``dt_bias`` and ``D`` in fp32 whatever
    ``dtype``).  ``remat`` recomputes each layer in the training backward
    (the reference's default is ``True``; its tests and this default take
    ``False``).

    Over a mesh (``ctx``, a ``MeshContext``): explicit tensor, sequence,
    data and (``moe_strategy="ep"``) expert parallelism over
    ``torch.distributed``, one process a device.  The parameters are each
    rank's slices by ``param_pspecs`` (``init`` draws the whole tree from
    the seed and keeps them; ``shard``/``gather`` convert); the inputs of
    ``apply_train``, ``loss_fn``, ``prefill`` and ``decode`` are the whole
    batch, alike on every rank, as the reference's global arrays.  The
    families the mesh does not run yet raise (``check_mesh_family``), and
    so do the paged and chunked paths.
    """

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 remat: bool = False, ctx: Optional[MeshContext] = None,
                 moe_strategy: str = "tp"):
        transformer._check_family(cfg)
        if ctx is not None:
            transformer.check_mesh_family(cfg)
        if moe_strategy not in ("tp", "ep"):
            raise ValueError(f"moe_strategy {moe_strategy!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat
        self.ctx = ctx
        self.moe_strategy = moe_strategy
        self._specs = None

    def init(self, seed: int = 0, dtype=torch.bfloat16) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = transformer.init_params(self.cfg, gen, dtype, self.device)
        return params if self.ctx is None else self.shard(params)

    # ---- the mesh ----
    def param_specs(self):
        """The ``PartitionSpec`` of every leaf (``param_pspecs`` of the
        whole tree's shapes)."""
        if self._specs is None:
            shapes = transformer.init_params(self.cfg, torch.Generator(),
                                             torch.float32, "meta")
            self._specs = param_pspecs(shapes, self.ctx)
        return self._specs

    def shard(self, params):
        """This rank's slices of a whole parameter tree."""
        if self.ctx is None:
            return params
        return shard_params(params, self.param_specs(), self.ctx)

    def gather(self, tree):
        """Whole leaves from every rank's slices of a parameter-shaped
        tree (collective)."""
        if self.ctx is None:
            return tree
        return gather_params(tree, self.param_specs(), self.ctx)

    def layout(self, batch: int, seq_len: int, mode: str):
        return transformer.make_layout(self.ctx, self.cfg, batch, seq_len,
                                       mode, self.moe_strategy)

    def whole_logits(self, logits: torch.Tensor, batch: int,
                     seq_len: int) -> torch.Tensor:
        """``apply_train``'s logits of a ``(batch, seq_len)`` batch made
        whole on every rank (collective)."""
        return transformer.whole_logits(
            self.cfg, logits, self.layout(batch, seq_len, "train"))

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   **kw) -> Dict[str, Any]:
        """A dense cache for ``prefill``/``decode`` of ``batch`` rows:
        over a mesh, this rank's rows and kv heads."""
        lay = self.layout(batch, cache_len, "decode")
        if lay is not None:
            batch //= lay.ctx.dp_size if lay.batch else 1
            kw["kv_heads"] = attention.local_kv_heads(self.cfg, lay)
        return init_cache(self.cfg, batch, cache_len, dtype, self.device,
                          **kw)

    # ---- training ----
    def apply_train(self, params, inputs,
                    enc_embeds: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(logits (B, S, V), aux loss)`` of the training forward (over
        a mesh: this rank's part, see ``transformer.forward``)."""
        return transformer.forward(params, self.cfg, inputs,
                                   remat=self.remat, enc_embeds=enc_embeds,
                                   ctx=self.ctx,
                                   moe_strategy=self.moe_strategy)

    def loss_fn(self, params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy plus the aux loss, in fp32, as
        the reference's: ``logsumexp(lf) - lf[label]`` over ``batch
        ["inputs"]``/``["labels"]`` (``["enc_embeds"]`` for an
        encoder-decoder).  The label's logit is gathered, not picked by a
        (B, S, V) one-hot.

        Over a mesh the logits may be this rank's vocabulary columns: the
        max and the sum of exponentials are then taken over the model
        axis, and the label's logit comes from the rank that holds it.
        The mean is over the whole batch (the batch ranks' sums added), so
        every rank returns the reference's loss; the gradient each rank
        gets is its own rows' part, which the train step sums."""
        logits, aux = self.apply_train(params, batch["inputs"],
                                       batch.get("enc_embeds"))
        labels = batch["labels"]
        lay = self.layout(labels.shape[0], labels.shape[1], "train")
        if lay is not None:
            labels = lay.rows(labels)
        labels = labels.long()
        lf = logits.float()
        if transformer.vocab_sharded(self.cfg, lay):
            g = lay.model_group
            lo, n = lay.chunk(self.cfg.vocab_size)
            top = C.all_reduce_max(lf.max(dim=-1).values, g)
            lse = top + torch.log(C.all_reduce(
                torch.exp(lf - top[..., None]).sum(dim=-1), g))
            ids = labels - lo
            mine = (ids >= 0) & (ids < n)
            ll = torch.gather(lf, -1, torch.where(
                mine, ids, torch.zeros_like(ids))[..., None])[..., 0]
            ll = C.all_reduce(torch.where(mine, ll, torch.zeros_like(ll)), g)
        else:
            lse = torch.logsumexp(lf, dim=-1)
            ll = torch.gather(lf, -1, labels[..., None])[..., 0]
        if lay is not None and lay.batch:
            xent = C.all_reduce((lse - ll).sum(), lay.ctx.batch_group) / (
                batch["labels"].numel())
        else:
            xent = torch.mean(lse - ll)
        return xent + aux, {"xent": xent, "aux": aux}

    def prefill(self, params, inputs, cache,
                enc_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        return transformer.prefill(params, self.cfg, inputs, cache,
                                   enc_embeds=enc_embeds, ctx=self.ctx,
                                   moe_strategy=self.moe_strategy)

    def decode(self, params, inputs, cache, pos, block_tab=None,
               kv_span: Optional[int] = None) -> torch.Tensor:
        return transformer.decode_step(params, self.cfg, inputs, cache, pos,
                                       block_tab=block_tab, kv_span=kv_span,
                                       ctx=self.ctx,
                                       moe_strategy=self.moe_strategy)

    def chunk_prefill(self, params, inputs, cache, offset, block_tab,
                      kv_span: Optional[int] = None) -> torch.Tensor:
        if self.ctx is not None:
            raise NotImplementedError("chunked prefill takes no mesh (no "
                                      "caller of the reference's passes one "
                                      "a ctx)")
        return transformer.chunk_prefill_step(
            params, self.cfg, inputs, cache, offset, block_tab=block_tab,
            kv_span=kv_span)
