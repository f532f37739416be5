"""GQA attention on a dense or a paged KV cache, and MLA on a dense one.

The branches of ``repro.models.attention.attention_forward`` that the
serving paths run (``mixer="attn"``/``"local"``):

* ``mode="prefill"``, ``pos=None``: one-shot prefill of a whole prompt at
  positions ``0..S-1``; its KV lands in ``cache[:, :S]`` of a dense
  ``(B, S_cache, KV, hd)`` cache and it attends causally over itself;
* ``mode="prefill"`` with per-row ``pos`` and a block table: a prompt
  chunk at positions ``[pos, pos + S)`` writes its KV into the pool and
  attends over the pages written so far, gathered to a dense view of
  ``kv_span`` tokens;
* ``mode="decode"``: one token per row writes its KV at ``pos`` and
  attends over the dense cache (``ops.decode_attention``) or, with a
  block table, through the pool (``ops.paged_decode_attention``);
* ``mode="train"``: the whole sequence at positions ``0..S-1``,
  ``causal`` as given, no cache; the reference's train branch, which its
  ``encode`` runs too (bidirectional).  ``mode="encode"`` is another name
  for it.  Under autograd the flash kernel's backward runs on the card
  (``ops.flash_attention``).

``cross_attention_forward`` is the encoder-decoder's cross attention
(seamless-m4t): no RoPE, never causal; train projects the encoder's output
to K and V and attends over them, no cache; prefill does the same and
writes them into the layer's ``ck``/``cv`` leaves, attending with the
flash kernel at ``Sq`` (the decoder's length) against ``Sk`` (the
encoder's); decode attends over ``ck``/``cv`` at
the encoder's length, which the decode step builds once for every layer.

An int8 pool (``cache`` has ``k_scale``/``v_scale`` leaves of ``(P, KV)``
fp32) quantizes on append (``kernels/quant.py``); chunked prefill then
attends over the fp32 dequantized gather (the flash kernel's fp32 path,
whatever the compute type), and decode hands the scales to the paged
kernel, which dequantizes as it reads.

JAX rebuilt the cache arrays on every call; here the tensors in ``cache``
are updated in place (``_row_update``, ``_paged_scatter``).  Dense
chunked prefill (a chunk offset without a block table) is not a branch:
no generator reaches it, since chunked prefill requires the paged pool.

MLA (``mla_forward``, deepseek-v2) caches the normed latent ``ckv (B, S,
r)`` and the shared rope key ``krope (B, S, rd)``.  Prefill expands the
latent to per-head keys and values and runs the flash kernel at q/k
``nope + rd`` and v ``vd`` columns; decode takes the absorbed form (q_nope
folded through ``w_uk``, scores against the latent) in fp32 torch ops,
plain ``jnp`` in the reference too, over the whole ``S_cache``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, quant, ref
from repro_torch.models import layers
from repro_torch.models.parallel import Layout
from repro_torch.sharding import collectives as C


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": layers.dense_init(gen, (d, h, hd), dtype, device, fan_in=d),
        "wk": layers.dense_init(gen, (d, kv, hd), dtype, device, fan_in=d),
        "wv": layers.dense_init(gen, (d, kv, hd), dtype, device, fan_in=d),
        "wo": layers.dense_init(gen, (h, hd, d), dtype, device,
                                fan_in=h * hd),
    }
    if cfg.qkv_bias:                 # chatglm3; zeros, as the reference
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=device)
    return p


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """MLA weights in the reference's layouts: ``w_dkv (D, r)``, ``w_krope
    (D, rd)``, ``norm_kv (r,)``, ``w_uk (r, H, nope)``, ``w_uv (r, H,
    vd)``, ``wo (H, vd, D)``, ``wq (D, H, nope + rd)``."""
    m = cfg.mla
    d, h, r = cfg.d_model, cfg.num_heads, m.kv_lora_rank
    return {
        "w_dkv": layers.dense_init(gen, (d, r), dtype, device),
        "w_krope": layers.dense_init(gen, (d, m.qk_rope_head_dim), dtype,
                                     device),
        "norm_kv": torch.ones((r,), dtype=dtype, device=device),
        "w_uk": layers.dense_init(gen, (r, h, m.qk_nope_head_dim), dtype,
                                  device, fan_in=r),
        "w_uv": layers.dense_init(gen, (r, h, m.v_head_dim), dtype, device,
                                  fan_in=r),
        "wo": layers.dense_init(gen, (h, m.v_head_dim, d), dtype, device,
                                fan_in=h * m.v_head_dim),
        "wq": layers.dense_init(gen, (d, h, m.qk_head_dim), dtype, device,
                                fan_in=d),
    }


def _project_qkv(p: dict, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def kv_heads_for(cfg: ModelConfig, layout: Optional[Layout]
                 ) -> Optional[List[int]]:
    """The kv heads this model rank's q heads read, where the q heads
    split over the model axis and the kv heads do not (the reference
    repeats K and V to every q head and splits them with q; here a rank
    takes only the kv heads its own q heads read, so decode keeps its
    head group).  Each kv head once where the rank's q heads fall in
    whole groups of it (chatglm3's 32/2 at tp 4: 8 q heads on one kv
    head); else one a q head.  None where the kv heads split too or the
    heads run whole."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if layout is None or not layout.sharded(h) or layout.sharded(kvh):
        return None
    lo, hl = layout.chunk(h)
    reads = [j // (h // kvh) for j in range(lo, lo + hl)]
    uniq = sorted(set(reads))
    per = hl // len(uniq)
    if hl % len(uniq) == 0 and all(r == uniq[i // per]
                                   for i, r in enumerate(reads)):
        return uniq
    return reads


def local_kv_heads(cfg: ModelConfig, layout: Optional[Layout]) -> int:
    """The kv heads of this rank's dense cache."""
    idx = kv_heads_for(cfg, layout)
    if idx is not None:
        return len(idx)
    if layout is not None and layout.sharded(cfg.num_heads):
        return cfg.num_kv_heads // layout.tp
    return cfg.num_kv_heads


def attention_forward(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *,
    mixer: str, mode: str, cache: Optional[dict],
    pos: Optional[torch.Tensor] = None, causal: bool = True,
    block_tab: Optional[torch.Tensor] = None,
    kv_span: Optional[int] = None,
    layout: Optional[Layout] = None,
) -> torch.Tensor:
    """Returns the attention output; ``cache`` is written in place.

    Over a mesh (``layout``): where the q heads split over the model
    axis, each rank runs its own heads (``wq``, ``wo`` and ``bq`` its
    slices; ``wk``, ``wv``, ``bk``, ``bv`` its slices where the kv heads
    split, else the heads ``kv_heads_for`` picks from the whole leaves),
    between ``col_in`` and ``row_out``; its dense cache holds those kv
    heads.  Where they do not split, attention runs whole on every model
    rank.  The paged and chunked paths take no mesh, as the reference
    reaches them from no caller with one."""
    if layout is None or layout.tp == 1:
        return _attention(p, x, cfg, mixer=mixer, mode=mode, cache=cache,
                          pos=pos, causal=causal, block_tab=block_tab,
                          kv_span=kv_span)
    if block_tab is not None or (mode == "prefill" and pos is not None):
        raise NotImplementedError("paged KV and chunked prefill take no "
                                  "mesh (no caller of the reference's "
                                  "passes one a ctx)")
    run = lambda q, h: _attention(q, h, cfg, mixer=mixer, mode=mode,
                                  cache=cache, pos=pos, causal=causal,
                                  block_tab=None, kv_span=kv_span)
    if not layout.sharded(cfg.num_heads):
        return layout.rep_out(run(p, layout.rep_in(x)))
    idx = kv_heads_for(cfg, layout)
    if idx is not None:
        p = dict(p)
        g = layout.model_group
        for name in ("wk", "wv", "bk", "bv"):
            if name in p:
                # whole leaves, each rank reading its own heads: their
                # gradients are summed over the model axis
                w = C.copy_to(p[name], g)
                p[name] = w[:, idx] if w.dim() == 3 else w[idx]
    return layout.row_out(run(p, layout.col_in(x)))


def _attention(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *,
    mixer: str,                      # "attn" | "local"
    mode: str,                       # "prefill" | "decode" | "train"
                                     #   ("encode": "train")
    cache: Optional[dict],           # {"k","v"}: dense (B, S_cache, KV, hd)
                                     #   or pooled (P, page, KV, hd);
                                     #   None with mode="train"
    pos: Optional[torch.Tensor] = None,     # (B,) chunk offsets or decode
                                            # positions; None: one-shot
    causal: bool = True,
    block_tab: Optional[torch.Tensor] = None,   # (B, nmax) page ids (paged)
    kv_span: Optional[int] = None,   # dense length of the gathered view
) -> torch.Tensor:
    if mixer not in ("attn", "local"):
        raise NotImplementedError(f"mixer {mixer!r}")
    mode = _train_mode(mode)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window if mixer == "local" else None
    softcap = cfg.attn_logit_softcap
    rot = int(hd * cfg.rope_fraction)
    q, k, v = _project_qkv(p, x)

    def rope(positions, at):
        """q and k rotated at ``positions``, the angles broadcast by
        ``at``."""
        cos, sin = layers.rope_cos_sin(positions, rot, cfg.rope_theta)
        cos, sin = at(cos), at(sin)
        return (layers.apply_rope(q, cos, sin, rot),
                layers.apply_rope(k, cos, sin, rot))

    if pos is None and mode in ("prefill", "train"):
        q, k = rope(torch.arange(s, device=x.device),
                    lambda c: c[None, :, None])
        if mode == "prefill":
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    if mode == "train":
        raise NotImplementedError("mode='train' runs whole sequences only")
    if mode == "prefill":
        if block_tab is None:
            raise NotImplementedError(
                "chunked prefill into a dense cache: no generator reaches it")
        positions = pos[:, None] + torch.arange(s, device=x.device)  # (B,S)
        q, k = rope(positions, lambda c: c[:, :, None])
        if "k_scale" in cache:
            # int8 pool: quantize the chunk on append, then attend over
            # the fp32 dequantized view, as the reference does: q goes to
            # fp32 (exact) for the kernel's fp32 path, and the output
            # comes back in q's type to meet ``wo``
            quant.paged_scatter_quant(cache["k"], cache["k_scale"], k,
                                      block_tab, positions)
            quant.paged_scatter_quant(cache["v"], cache["v_scale"], v,
                                      block_tab, positions)
            kd = ref.gather_paged_kv(cache["k"], block_tab, kv_span,
                                     scale=cache["k_scale"])
            vd = ref.gather_paged_kv(cache["v"], block_tab, kv_span,
                                     scale=cache["v_scale"])
            qa = q.float()
        else:
            _paged_scatter(cache["k"], k, block_tab, positions)
            _paged_scatter(cache["v"], v, block_tab, positions)
            kd = ref.gather_paged_kv(cache["k"], block_tab, kv_span)
            vd = ref.gather_paged_kv(cache["v"], block_tab, kv_span)
            qa = q
        out = ops.flash_attention(
            qa, kd, vd, causal=causal, window=window, softcap=softcap,
            kv_len=pos + s, q_offset=pos).to(q.dtype)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    q, k = rope(pos, lambda c: c[:, None, None])      # angles (B, rot/2)
    if block_tab is None:
        _row_update(cache["k"], k, pos)
        _row_update(cache["v"], v, pos)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos + 1,
                                   window=window, softcap=softcap)
    else:
        ks = vs = None
        if "k_scale" in cache:
            ks, vs = cache["k_scale"], cache["v_scale"]
            quant.paged_scatter_quant(cache["k"], ks, k, block_tab,
                                      pos[:, None])
            quant.paged_scatter_quant(cache["v"], vs, v, block_tab,
                                      pos[:, None])
        else:
            _paged_scatter(cache["k"], k, block_tab, pos[:, None])
            _paged_scatter(cache["v"], v, block_tab, pos[:, None])
        out = ops.paged_decode_attention(
            q[:, 0], cache["k"], cache["v"], block_tab, pos + 1,
            kv_span=kv_span, window=window, softcap=softcap,
            k_scale=ks, v_scale=vs)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]


def _train_mode(mode: str) -> str:
    """``mode`` checked, ``"encode"`` read as ``"train"``."""
    if mode not in ("prefill", "decode", "train", "encode"):
        raise NotImplementedError(f"mode {mode!r}")
    return "train" if mode == "encode" else mode


def cross_attention_forward(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
    cache: Optional[dict],           # the layer's: "ck","cv" (B, S_enc,
                                     #   KV, hd) among its leaves; None
                                     #   with mode="train"
    enc_out: Optional[torch.Tensor] = None,   # (B, S_enc, D); prefill,
                                              # train
    enc_len: Optional[torch.Tensor] = None,   # (B,) int32 S_enc; decode
) -> torch.Tensor:
    """Encoder-decoder cross attention: no RoPE, never causal.

    ``mode="train"`` projects ``enc_out`` to K and V and attends over
    them; ``mode="prefill"`` also writes them into
    ``cache["ck"]``/``cache["cv"]`` in place (cast to ``x``'s dtype on the
    way, as the reference's cache takes them; the leaf keeps its own) and
    attends over them; ``mode="decode"`` attends over the cached K and V,
    every row at ``kv_len = enc_len``.  Returns the output."""
    mode = _train_mode(mode)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if mode in ("prefill", "train"):
        if enc_out is None:
            raise ValueError(f"cross attention's {mode} takes the encoder's "
                             "output")
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"]).to(x.dtype)
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"]).to(x.dtype)
        if mode == "train":
            out = ops.flash_attention(q, k, v, causal=False)
            return torch.einsum("bshk,hkd->bsd", out, p["wo"])
        if cache["ck"].shape != k.shape:
            raise ValueError(f"cross cache {tuple(cache['ck'].shape)} for "
                             f"encoder K/V {tuple(k.shape)}: make the cache "
                             "with enc_len = the encoder's length")
        cache["ck"].copy_(k)
        cache["cv"].copy_(v)
        out = ops.flash_attention(q, k, v, causal=False)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if enc_len is None:
        raise ValueError("cross attention's decode takes the encoder's "
                         "length, enc_len (B,)")
    out = ops.decode_attention(q[:, 0], cache["ck"], cache["cv"], enc_len)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]


def mla_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[dict],   # {"ckv" (B, S_cache, r), "krope"
                                         #  (B, S_cache, rd)}, dense; None
                                         #  with mode="train"
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLA on a dense latent cache: one-shot prefill at positions
    ``0..S-1`` or one decode token a row at ``pos`` (B,); ``mode="train"``
    is prefill without a cache.  Returns the output; ``cache`` is written
    in place."""
    mode = _train_mode(mode)
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    nope, rd = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = m.qk_head_dim ** -0.5

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])          # (B,S,H,nope+rd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = layers.rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"]),
                          p["norm_kv"], cfg.norm_eps)      # (B,S,r)
    k_rope = torch.einsum("bsd,dr->bsr", x, p["w_krope"])  # one shared head

    if mode in ("prefill", "train"):
        cos, sin = layers.rope_cos_sin(torch.arange(s, device=x.device), rd,
                                       cfg.rope_theta)
        cos, sin = cos[None, :, None], sin[None, :, None]
        q_rope = layers.apply_rope(q_rope, cos, sin)
        k_rope = layers.apply_rope(k_rope[:, :, None], cos, sin)[:, :, 0]
        # the latent expanded to per-head keys and values
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, rd)],
                      dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.flash_attention(qfull, k, v, causal=True, scale=scale)
        if mode == "prefill":
            cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
            cache["krope"][:, :s] = k_rope.to(cache["krope"].dtype)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    # decode in the absorbed form
    cos, sin = layers.rope_cos_sin(pos, rd, cfg.rope_theta)   # (B, rd/2)
    cos, sin = cos[:, None, None], sin[:, None, None]
    q_rope = layers.apply_rope(q_rope, cos, sin)
    k_rope = layers.apply_rope(k_rope[:, :, None], cos, sin)[:, :, 0]
    _row_update(cache["ckv"], ckv, pos)
    _row_update(cache["krope"], k_rope, pos)
    ckv_c, kr_c = cache["ckv"].float(), cache["krope"].float()
    s_cache = ckv_c.shape[1]
    # q_nope folded through w_uk: scores straight against the latent
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"])
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv_c)
              + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), kr_c)
              ) * scale
    mask = (torch.arange(s_cache, device=x.device)[None, :]
            < (pos + 1)[:, None])
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, ref.NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs, ckv_c)        # latent context
    out = torch.einsum("bhr,rhk->bhk", ctx.to(x.dtype), p["w_uv"])
    return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]


def _row_update(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """cache (B, S, ...), new (B, 1, ...), pos (B,): row b's token lands at
    ``pos[b]``, in place.  A position past the end is clamped to the last
    row, as ``jax.lax.dynamic_update_slice`` clamps its start (no
    generator writes there; checking would cost a device sync a step)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.long().clamp(0, cache.shape[1] - 1)
    cache[rows, at] = new[:, 0].to(cache.dtype)


def _paged_scatter(pool: torch.Tensor, new: torch.Tensor,
                   block_tab: torch.Tensor, positions: torch.Tensor) -> None:
    """pool (P, page, ...), new (B, S, ...), positions (B, S): in place.

    Writes each token's KV at ``(block_tab[b, p // page], p % page)``.
    Freed slots' tables point every block at the trash page (id 0), so
    writes from dead or still-prefilling rows never touch a live page.
    """
    page = pool.shape[1]
    pages = torch.gather(block_tab.long(), 1, (positions // page).long())
    pool[pages, (positions % page).long()] = new.to(pool.dtype)


def make_mla_cache_spec(cfg: ModelConfig, batch: int, cache_len: int,
                        dtype) -> dict:
    """Per-layer shapes ``{"ckv": ((batch, cache_len, r), dtype),
    "krope": ((batch, cache_len, rd), dtype)}``: the latent and the
    shared rope key."""
    m = cfg.mla
    return {"ckv": ((batch, cache_len, m.kv_lora_rank), dtype),
            "krope": ((batch, cache_len, m.qk_rope_head_dim), dtype)}


def make_cross_cache_spec(cfg: ModelConfig, batch: int, enc_len: int,
                          dtype) -> dict:
    """A decoder layer's cross K and V: ``{"ck","cv": ((batch, enc_len,
    KV, hd), dtype)}``."""
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"ck": (shape, dtype), "cv": (shape, dtype)}


def make_attn_cache_spec(cfg: ModelConfig, batch: int, cache_len: int,
                         dtype, kv_format: Optional[str] = None,
                         kv_heads: Optional[int] = None) -> dict:
    """Per-layer shapes ``{"k","v": ((batch, cache_len, KV, hd), dtype)}``
    (a paged pool: ``(pages, page, KV, hd)``).  ``kv_format="int8"``
    (paged pools only) gives int8 ``k``/``v`` and fp32 ``(pages, KV)``
    ``k_scale``/``v_scale`` leaves.  ``kv_heads`` (a rank's heads over a
    mesh) in place of the config's."""
    kv = cfg.num_kv_heads if kv_heads is None else kv_heads
    shape = (batch, cache_len, kv, cfg.resolved_head_dim)
    if kv_format == "int8":
        sshape = (batch, kv)
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (sshape, torch.float32),
                "v_scale": (sshape, torch.float32)}
    return {"k": (shape, dtype), "v": (shape, dtype)}
