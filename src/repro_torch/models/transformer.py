"""Transformer of the served families on a dense or a paged cache.

The mixers: ``attn`` (global) and ``local`` (sliding-window) attention,
on a dense or a paged KV cache; ``mla`` (deepseek-v2's latent attention)
and ``mamba`` (Mamba2's SSD), on a dense cache only, one-shot prefilled,
as the reference (``apply_layer`` refuses a block table or a chunk
offset for them).  The FFNs: a ``dense`` MLP (SwiGLU, GeGLU or GELU), a
``moe`` FFN (shared experts too), or ``none`` (Mamba2 blocks).  The first
``first_k_dense`` layers take a dense MLP of ``first_dense_d_ff`` where
the pattern says ``moe``, as ``cfg.layer_kinds()`` says.  QKV bias,
partial RoPE, attention and final logit softcaps, scaled and tied
embeddings as the config says.  Mixers may mix in one stack (jamba's
Mamba layers beside attention layers, each with its own cache leaves).
The ``embed`` frontend (chameleon-34b) takes float embeddings ``(B, S,
D)`` for inputs and has no token table; the encoder-decoder stack
(seamless-m4t-medium) runs a bidirectional, cacheless encoder over float
frame embeddings (``encode``), and each decoder layer attends over its
output between its mixer and its FFN (``norm_cross``, ``cross``; the
cross K and V cached in its ``ck``/``cv`` leaves at prefill).  Its
decoder takes one-shot prefill and dense decode only, as the reference
serves it.  ``forward`` is the training pass (``mode="train"`` in every
mixer: whole sequences, no cache), differentiable by autograd, with each
layer recomputed in the backward under ``remat``.

Parameters are a plain dict of tensors in the JAX package's layouts, with
``blocks`` a flat list of per-layer dicts, the ``first_k_dense`` prefix
first, each paired with ``cfg.layer_kinds()[i]`` (JAX kept the prefix
apart and stacked the rest on a leading repeats axis to scan; PyTorch
runs eagerly, so the stack is a Python loop); an encoder-decoder's
encoder is ``encoder = {"blocks": [...], "final_norm"}``, its layers
paired with the pattern repeated.  Three entry points share
them: ``prefill`` (whole prompts into a dense cache), ``decode_step``
(one token per slot at per-slot positions, dense or paged) and
``chunk_prefill_step`` (one prompt chunk at per-slot offsets, paged).
All write the caches in place.  Each residual add is fused into the norm
that follows it (``layers.add_rms_norm``): a layer hands its FFN output
(its mixer's, with no FFN) on, pending, to the next layer's first norm or
the final norm.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.parallel import Layout
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import MeshContext, constrain

Params = Dict[str, Any]

# Megatron-style sequence-parallel activations between blocks, as the
# reference's: "auto" is on for every family but MLA's (whose latent to
# per-head expansion would reshard every layer).
SEQ_SHARD_ACTIVATIONS = "auto"


def _seq_shard(cfg: ModelConfig) -> bool:
    if SEQ_SHARD_ACTIVATIONS == "auto":
        return cfg.mla is None
    return bool(SEQ_SHARD_ACTIVATIONS)


def check_mesh_family(cfg: ModelConfig) -> None:
    """Raise on a family the mesh paths do not run yet: the mesh runs
    attention mixers with dense or MoE FFNs on token ids."""
    mixers = {k for k, _ in cfg.layer_kinds()}
    if (mixers - set(ATTN_MIXERS) or cfg.encdec or cfg.frontend != "token"
            or cfg.first_k_dense):
        raise NotImplementedError(
            f"{cfg.name} over a mesh (mixers {sorted(mixers)}, "
            f"encdec={cfg.encdec}, frontend={cfg.frontend!r}) waits for "
            "the next mesh slice (MLA's w_uk/w_uv, Mamba's inner dim, "
            "jamba, seamless's cross attention, chameleon's embeddings)")


def make_layout(ctx: Optional[MeshContext], cfg: ModelConfig, batch: int,
                seq_len: int, mode: str, moe_strategy: str = "tp"
                ) -> Optional[Layout]:
    """One pass's layout over ``ctx`` (None without a mesh): the batch
    rows split over the batch axes where they divide, the stream split
    along the sequence in train and prefill where ``_seq_shard`` allows
    and the sequence divides the model axis."""
    if ctx is None:
        return None
    if moe_strategy not in ("tp", "ep"):
        raise ValueError(f"moe_strategy {moe_strategy!r}")
    check_mesh_family(cfg)
    tp = ctx.tp_size
    seq = (_seq_shard(cfg) and mode in ("train", "prefill") and tp > 1
           and seq_len % tp == 0)
    return Layout(ctx, seq=seq,
                  batch=ctx.dp_size > 1 and ctx.shard_tokens(batch),
                  moe_strategy=moe_strategy)


def vocab_sharded(cfg: ModelConfig, layout: Optional[Layout]) -> bool:
    """Whether the token table and the logits split over the model axis."""
    return layout is not None and layout.sharded(cfg.vocab_size)


ATTN_MIXERS = ("attn", "local")
MIXERS = ATTN_MIXERS + ("mla", "mamba")
FFNS = ("dense", "moe", "none")


def _check_family(cfg: ModelConfig) -> None:
    """Raise on a stack the port does not know: a mixer or FFN kind of
    none of ``MIXERS`` and ``FFNS``, a MoE FFN without its config, or a
    frontend other than token ids and stub embeddings."""
    mixers = {k for k, _ in cfg.layer_kinds()}
    ffns = {f for _, f in cfg.layer_kinds()}
    if (mixers - set(MIXERS) or ffns - set(FFNS)
            or ("moe" in ffns and cfg.moe is None)
            or cfg.frontend not in ("token", "embed")):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attn/local, mla or mamba mixers "
            f"with dense, moe or no FFNs and a token or embed frontend "
            f"(got mixers {sorted(mixers)}, ffns {sorted(ffns)}, "
            f"frontend={cfg.frontend!r})")


def serves_tokens(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` is a decoder fed token ids, which the generators
    and the paged pool take.  The reference serves an encoder-decoder
    through ``Model``'s one-shot prefill and dense decode alone (its
    prefill needs the encoder's frames; its generators crash, its pool
    refuses it), and the ``embed`` frontend through those and the
    streamed executor (no token table to feed a greedy token back
    through: its generators crash)."""
    return cfg.frontend == "token" and not cfg.encdec


def refuse_encdec(cfg: ModelConfig, path: str) -> None:
    """Raise on an encoder-decoder: ``path``, which says why, cannot give
    its cross attention the encoder's output."""
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder takes one-shot prefill and "
            f"decode over a dense cache only, not {path}")


def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: LayerKind,
               dtype, device, dense_d_ff: Optional[int] = None,
               with_cross: bool = False) -> Params:
    """One layer; a ``dense`` FFN is ``dense_d_ff`` wide (default
    ``d_ff``); ``with_cross`` adds an encoder-decoder's cross attention
    and its norm."""
    mixer, ffn = kind
    d = cfg.d_model
    p: Params = {"norm1": torch.ones((d,), dtype=dtype, device=device)}
    if mixer in ATTN_MIXERS:
        p["attn"] = attention.init_attention(gen, cfg, dtype, device)
    elif mixer == "mla":
        p["mla"] = attention.init_mla(gen, cfg, dtype, device)
    else:
        p["mamba"] = ssm.init_mamba(gen, cfg, dtype, device)
    if with_cross:
        p["norm_cross"] = torch.ones((d,), dtype=dtype, device=device)
        p["cross"] = attention.init_attention(gen, cfg, dtype, device)
    if ffn == "none":
        return p
    p["norm2"] = torch.ones((d,), dtype=dtype, device=device)
    if ffn == "moe":
        p["moe"] = moe.init_moe(gen, cfg, dtype, device)
    else:
        p["ffn"] = layers.init_mlp(gen, d, dense_d_ff or cfg.d_ff,
                                   cfg.mlp_kind, dtype, device)
    return p


def encoder_kinds(cfg: ModelConfig) -> List[LayerKind]:
    """An encoder-decoder's encoder layers: the pattern repeated over
    ``num_encoder_layers``, as the reference stacks them."""
    pat = cfg.layer_pattern
    if cfg.num_encoder_layers % len(pat):
        raise ValueError(f"{cfg.num_encoder_layers} encoder layers for a "
                         f"pattern of {len(pat)}")
    return list(pat) * (cfg.num_encoder_layers // len(pat))


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> Params:
    """The layers before ``first_k_dense`` take a dense MLP of
    ``first_dense_d_ff``, as the reference's ``prefix``.  The token table
    ``embed`` exists for token frontends and encoder-decoders (whose
    decoder reads tokens), as in the reference; the ``embed`` frontend's
    inputs are embeddings already."""
    _check_family(cfg)
    prefix_d_ff = cfg.first_dense_d_ff or cfg.d_ff
    p: Params = {}
    if cfg.frontend == "token" or cfg.encdec:
        p["embed"] = layers.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                       dtype, device)
    p["blocks"] = [init_layer(gen, cfg, kind, dtype, device,
                              prefix_d_ff if i < cfg.first_k_dense else None,
                              with_cross=cfg.encdec)
                   for i, kind in enumerate(cfg.layer_kinds())]
    p["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         dtype, device)
    if cfg.encdec:
        p["encoder"] = {
            "blocks": [init_layer(gen, cfg, kind, dtype, device)
                       for kind in encoder_kinds(cfg)],
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                     device=device)}
    return p


def ffn_forward(p: Params, h: torch.Tensor, cfg: ModelConfig, ffn: str,
                aux: Optional[list] = None,
                layout: Optional[Layout] = None) -> torch.Tensor:
    """The layer's FFN on its normed input.  The MoE's aux loss is a
    training signal: appended to ``aux`` when given (training), dropped
    otherwise, as the reference's serving passes drop it.  Over a mesh a
    dense FFN splits its columns over the model axis where ``d_ff``
    divides it (else runs whole), and the MoE runs tensor or expert
    parallel as ``layout.moe_strategy`` says."""
    if ffn == "moe":
        if layout is not None and layout.moe_strategy == "ep":
            out, a = moe.moe_forward_ep(p["moe"], h, cfg, layout=layout)
        else:
            out, a = moe.moe_forward(p["moe"], h, cfg, layout=layout)
        if aux is not None:
            aux.append(a)
        return out
    if layout is None or layout.tp == 1:
        return layers.apply_mlp(p["ffn"], h, cfg.mlp_kind)
    if layout.sharded(cfg.d_ff):
        return layout.row_out(layers.apply_mlp(p["ffn"], layout.col_in(h),
                                               cfg.mlp_kind))
    return layout.rep_out(layers.apply_mlp(p["ffn"], layout.rep_in(h),
                                           cfg.mlp_kind))


def mixer_forward(p: Params, h: torch.Tensor, cfg: ModelConfig, mixer: str,
                  *, mode: str, cache: Optional[dict],
                  pos: Optional[torch.Tensor],
                  block_tab: Optional[torch.Tensor],
                  kv_span: Optional[int], causal: bool = True,
                  layout: Optional[Layout] = None) -> torch.Tensor:
    """The layer's mixer on its normed input; writes ``cache`` in place
    (none with ``mode="train"``, or ``"encode"``)."""
    if mixer in ATTN_MIXERS:
        return attention.attention_forward(
            p["attn"], h, cfg, mixer=mixer, mode=mode, cache=cache, pos=pos,
            causal=causal, block_tab=block_tab, kv_span=kv_span,
            layout=layout)
    if mixer == "mla":
        return attention.mla_forward(p["mla"], h, cfg, mode=mode,
                                     cache=cache, pos=pos)
    return ssm.mamba_forward(p["mamba"], h, cfg, mode=mode, cache=cache,
                             pos=pos)


def apply_layer(p: Params, x: torch.Tensor, delta: Optional[torch.Tensor],
                cfg: ModelConfig, kind: LayerKind, *, mode: str,
                cache: Optional[dict], pos: Optional[torch.Tensor],
                block_tab: Optional[torch.Tensor],
                kv_span: Optional[int], causal: bool = True,
                enc_out: Optional[torch.Tensor] = None,
                enc_len: Optional[torch.Tensor] = None,
                aux: Optional[list] = None,
                layout: Optional[Layout] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer on the residual stream ``x`` with the previous layer's
    output ``delta`` still to add (None before the first layer).  Each
    residual add rides in the norm after it (``add_rms_norm``), so the
    layer returns its stream and its own FFN output (its mixer's, with no
    FFN), pending.  A decoder layer of an encoder-decoder runs its cross
    attention between the mixer and the FFN: over ``enc_out`` at prefill
    and in training (no cache), over its ``ck``/``cv`` leaves, ``enc_len``
    (B,) long, at decode.  A MoE layer appends its aux loss to ``aux``
    when given.  Over a mesh (``layout``) the norms run on the stream's
    shards and the mixer and FFN take and give the stream as it lies."""
    mixer, ffn = kind
    if mixer not in ATTN_MIXERS and (
            block_tab is not None or (mode == "prefill" and pos is not None)):
        raise NotImplementedError(
            f"paged KV / chunked prefill support attn-family mixers only "
            f"(got {mixer!r})")
    norm = (lambda w: w) if layout is None else layout.norm_weight
    if delta is None:
        h = layers.rms_norm(x, norm(p["norm1"]), cfg.norm_eps)
    else:
        x, h = layers.add_rms_norm(x, delta, norm(p["norm1"]), cfg.norm_eps)
    a = mixer_forward(p, h, cfg, mixer, mode=mode, cache=cache, pos=pos,
                      block_tab=block_tab, kv_span=kv_span, causal=causal,
                      layout=layout)
    train = mode in ("train", "encode")
    if "cross" in p:
        if not train and (cache is None or "ck" not in cache):
            raise ValueError("a decoder layer's cross attention keeps its K "
                             "and V in ck/cv cache leaves: make the cache "
                             "with enc_len")
        x, hc = layers.add_rms_norm(x, a, p["norm_cross"], cfg.norm_eps)
        a = attention.cross_attention_forward(
            p["cross"], hc, cfg, mode=mode, cache=None if train else cache,
            enc_out=enc_out, enc_len=enc_len)
    if ffn == "none":
        return x, a
    x, h2 = layers.add_rms_norm(x, a, norm(p["norm2"]), cfg.norm_eps)
    return x, ffn_forward(p, h2, cfg, ffn, aux, layout)


def _run_stack(blocks: List[Params], kinds: List[LayerKind],
               cfg: ModelConfig, x: torch.Tensor, *, mode: str,
               caches: Optional[List[dict]], pos: Optional[torch.Tensor],
               block_tab: Optional[torch.Tensor], kv_span: Optional[int],
               causal: bool = True, enc_out: Optional[torch.Tensor] = None,
               enc_len: Optional[torch.Tensor] = None,
               layout: Optional[Layout] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers over ``x``; returns the stream and the last layer's
    pending output, which the final norm adds.  ``caches`` None: no
    cache (the encoder)."""
    delta = None
    for i, (lp, kind) in enumerate(zip(blocks, kinds)):
        x, delta = apply_layer(lp, x, delta, cfg, kind, mode=mode,
                               cache=None if caches is None else caches[i],
                               pos=pos, block_tab=block_tab, kv_span=kv_span,
                               causal=causal, enc_out=enc_out,
                               enc_len=enc_len, layout=layout)
    return x, delta


def _final_norm(p: Params, cfg: ModelConfig, x: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """The last layer's pending output added in the final norm."""
    return layers.add_rms_norm(x, delta, p["final_norm"], cfg.norm_eps)[1]


def _embed_inputs(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
                  layout: Optional[Layout] = None) -> torch.Tensor:
    """Token ids (an integer tensor) are looked up in the table; a
    floating tensor is taken as embeddings ``(B, S, D)`` already (the
    reference's stub frontend).  Both scale as the config says.  Over a
    mesh whose model axis splits the table's rows, each rank looks up the
    ids among its rows (zeros for the others) and the parts are summed
    (``row_out``); a whole table is looked up alike on every rank."""
    if inputs.is_floating_point():
        x = inputs
    elif vocab_sharded(cfg, layout):
        lo, n = layout.chunk(cfg.vocab_size)
        ids = inputs.long() - lo
        mine = (ids >= 0) & (ids < n)
        x = p["embed"][torch.where(mine, ids, torch.zeros_like(ids))]
        x = layout.row_out(torch.where(mine[..., None], x,
                                       torch.zeros_like(x)))
    else:
        x = p["embed"][inputs.long()]
    if layout is not None and not vocab_sharded(cfg, layout):
        x = layout.rep_out(x)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(p: Params, cfg: ModelConfig, x: torch.Tensor,
            layout: Optional[Layout] = None) -> torch.Tensor:
    """Logits of the normed stream; over a mesh whose model axis splits
    the vocabulary, this rank's columns of them (the reference's
    ``constrain(logits, ctx, "batch", None, "model")``), else all of them
    on every rank.  Whole sequences either way."""
    if layout is not None:
        x = (layout.col_in(x) if vocab_sharded(cfg, layout)
             else layout.rep_in(x))
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, p["embed"])
    else:
        logits = x @ p["lm_head"]
    return layers.softcap(logits, cfg.final_logit_softcap)


def whole_logits(cfg: ModelConfig, logits: torch.Tensor,
                 layout: Optional[Layout]) -> torch.Tensor:
    """The whole ``(B, ..., V)`` logits from this rank's part, alike on
    every rank (a collective; no gradient)."""
    if layout is None:
        return logits
    if vocab_sharded(cfg, layout):
        logits = C.gather_into(logits, logits.dim() - 1, layout.model_group)
    return layout.whole_rows(logits)


def _last_position(x: torch.Tensor, delta: torch.Tensor,
                   layout: Optional[Layout]):
    """The stream and its pending output at the last position (gathered
    along the sequence first where it is split)."""
    if layout is not None and layout.seq:
        x, delta = (constrain(t, layout.ctx, ("batch", "seq", None),
                              ("batch", None, None)) for t in (x, delta))
    return x[:, -1:], delta[:, -1:]


def encode(p: Params, cfg: ModelConfig, enc_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """An encoder-decoder's encoder over float frame embeddings ``(B,
    S_enc, D)``: the stack at positions ``0..S_enc-1``, bidirectional and
    cacheless (``mode="train"``, as the reference's), then its final norm.
    Returns ``(B, S_enc, D)``."""
    return _train_stack(p["encoder"], encoder_kinds(cfg), cfg,
                        _embed_inputs(p, cfg, enc_embeds), causal=False,
                        remat=remat)[0]


def _train_layer(lp: Params, kind: LayerKind, cfg: ModelConfig,
                 x: torch.Tensor, delta: Optional[torch.Tensor],
                 enc_out: Optional[torch.Tensor], causal: bool,
                 layout: Optional[Layout] = None):
    """One layer of the training pass: ``(x, delta, aux)``, the aux loss
    a 0-d fp32 tensor (0 but for a MoE layer)."""
    aux: list = []
    x, delta = apply_layer(lp, x, delta, cfg, kind, mode="train", cache=None,
                           pos=None, block_tab=None, kv_span=None,
                           causal=causal, enc_out=enc_out, aux=aux,
                           layout=layout)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in aux:
        total = total + a
    return x, delta, total


def _train_stack(p: Params, kinds: List[LayerKind], cfg: ModelConfig,
                 x: torch.Tensor, *, causal: bool = True,
                 enc_out: Optional[torch.Tensor] = None,
                 remat: bool = False, layout: Optional[Layout] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``p["blocks"]`` over ``x`` in training (no cache), then
    ``p["final_norm"]``: ``(normed output, summed aux loss)``.  ``remat``
    recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
    ``nothing_saveable`` over each layer group): a layer keeps only its
    inputs for the backward, and recomputes its collectives, in the same
    order on every rank."""
    delta = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(p["blocks"], kinds):
        if remat:
            x, delta, a = torch.utils.checkpoint.checkpoint(
                _train_layer, lp, kind, cfg, x, delta, enc_out, causal,
                layout, use_reentrant=False)
        else:
            x, delta, a = _train_layer(lp, kind, cfg, x, delta, enc_out,
                                       causal, layout)
        aux = aux + a
    w = p["final_norm"] if layout is None else layout.norm_weight(
        p["final_norm"])
    if delta is None:
        return layers.rms_norm(x, w, cfg.norm_eps), aux
    return layers.add_rms_norm(x, delta, w, cfg.norm_eps)[1], aux


def forward(p: Params, cfg: ModelConfig, inputs: torch.Tensor, *,
            remat: bool = False,
            enc_embeds: Optional[torch.Tensor] = None,
            ctx: Optional[MeshContext] = None, moe_strategy: str = "tp"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over whole sequences ``inputs`` (B, S) (token
    ids, or embeddings (B, S, D) for the ``embed`` frontend) at positions
    ``0..S-1``: every layer in ``mode="train"``, the final norm and the
    unembedding.  An encoder-decoder encodes ``enc_embeds`` first.
    Returns ``(logits (B, S, V), aux loss)``, the MoE layers' aux losses
    summed in fp32.

    Over a mesh (``ctx``) ``inputs`` is the whole batch, alike on every
    rank, and ``p`` this rank's slices (``param_pspecs``); the logits are
    this rank's batch rows (``make_layout``) and, where the vocabulary
    splits over the model axis, its columns (``whole_logits`` gathers
    them)."""
    layout = make_layout(ctx, cfg, inputs.shape[0], inputs.shape[1], "train",
                         moe_strategy)
    enc_out = None
    if cfg.encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its "
                             "forward takes enc_embeds")
        enc_out = encode(p, cfg, enc_embeds, remat=remat)
    if layout is not None:
        inputs = layout.rows(inputs)
    x, aux = _train_stack(p, cfg.layer_kinds(), cfg,
                          _embed_inputs(p, cfg, inputs, layout),
                          enc_out=enc_out, remat=remat, layout=layout)
    return unembed(p, cfg, x, layout), aux


def prefill(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
            cache: dict, enc_embeds: Optional[torch.Tensor] = None, *,
            ctx: Optional[MeshContext] = None, moe_strategy: str = "tp"
            ) -> torch.Tensor:
    """Causal pass over whole prompts ``inputs`` (B, S) at positions
    ``0..S-1``; their KV lands in ``cache[:, :S]`` of every layer's dense
    ``(B, S_cache, KV, hd)`` cache (MLA: its latent rows; Mamba: its conv
    history and state), in place.  An encoder-decoder encodes
    ``enc_embeds`` (B, S_enc, D) first and caches each decoder layer's
    cross K and V in its ``ck``/``cv`` leaves.  Returns the last-position
    logits (B, V).  Over a mesh (``ctx``) ``inputs`` is the whole batch,
    ``cache`` this rank's rows and kv heads (``Model.init_cache``), and
    the logits whole on every rank."""
    layout = make_layout(ctx, cfg, inputs.shape[0], inputs.shape[1],
                         "prefill", moe_strategy)
    enc_out = None
    if cfg.encdec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its "
                             "prefill takes enc_embeds")
        enc_out = encode(p, cfg, enc_embeds)
    if layout is not None:
        inputs = layout.rows(inputs)
    x = _embed_inputs(p, cfg, inputs, layout)
    x, delta = _run_stack(p["blocks"], cfg.layer_kinds(), cfg, x,
                          mode="prefill", caches=cache["blocks"], pos=None,
                          block_tab=None, kv_span=None, enc_out=enc_out,
                          layout=layout)
    x = _final_norm(p, cfg, *_last_position(x, delta, layout))
    if layout is not None:
        layout = dataclasses.replace(layout, seq=False)
    return whole_logits(cfg, unembed(p, cfg, x, layout)[:, 0], layout)


def decode_step(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
                cache: dict, pos: torch.Tensor, *,
                block_tab: Optional[torch.Tensor] = None,
                kv_span: Optional[int] = None,
                ctx: Optional[MeshContext] = None,
                moe_strategy: str = "tp") -> torch.Tensor:
    """One decode step at per-slot positions ``pos`` (B,); ``inputs``
    (B, 1) token ids, or (B, 1, D) embeddings for the ``embed`` frontend.
    ``cache`` is dense, or pooled pages read and written through
    ``block_tab`` (B, nmax) with a ``kv_span``-token view.  Writes
    ``cache`` in place; returns logits (B, V).  Over a mesh (``ctx``,
    dense caches only) ``inputs`` and ``pos`` are the whole batch's, the
    cache this rank's, and the logits whole on every rank."""
    layout = make_layout(ctx, cfg, inputs.shape[0], 1, "decode",
                         moe_strategy)
    if layout is not None:
        if block_tab is not None:
            raise NotImplementedError("paged decode takes no mesh (no "
                                      "caller of the reference's passes "
                                      "one a ctx)")
        inputs, pos = layout.rows(inputs), layout.rows(pos)
    enc_len = None
    if cfg.encdec:
        if block_tab is not None:
            refuse_encdec(cfg, "paged decode (the paged pool refuses it, as "
                          "the reference's)")
        # every row attends over all the encoder's frames in every layer
        enc_len = torch.full((inputs.shape[0],),
                             cache["blocks"][0]["ck"].shape[1],
                             dtype=torch.int32, device=inputs.device)
    x = _embed_inputs(p, cfg, inputs, layout)
    x, delta = _run_stack(p["blocks"], cfg.layer_kinds(), cfg, x,
                          mode="decode", caches=cache["blocks"], pos=pos,
                          block_tab=block_tab, kv_span=kv_span,
                          enc_len=enc_len, layout=layout)
    x = _final_norm(p, cfg, x, delta)
    return whole_logits(cfg, unembed(p, cfg, x, layout)[:, 0], layout)


def chunk_prefill_step(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
                       cache: dict, offset: torch.Tensor, *,
                       block_tab: torch.Tensor,
                       kv_span: Optional[int] = None) -> torch.Tensor:
    """Prefill one prompt chunk ``inputs`` (B, C) at per-slot start
    ``offset`` (B,).  Its KV lands at ``[offset, offset + C)``; attention
    spans the cache written so far, viewed ``kv_span`` tokens wide.
    Returns the chunk's last-position logits (B, V)."""
    refuse_encdec(cfg, "chunked prefill (the reference's has no encoder "
                  "output)")
    x = _embed_inputs(p, cfg, inputs)
    x, delta = _run_stack(p["blocks"], cfg.layer_kinds(), cfg, x,
                          mode="prefill", caches=cache["blocks"], pos=offset,
                          block_tab=block_tab, kv_span=kv_span)
    x = _final_norm(p, cfg, x[:, -1:], delta[:, -1:])
    return unembed(p, cfg, x)[:, 0]
