"""Model facade: init / train / prefill / chunk prefill / decode + cache
specs."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, ssm, transformer


def _layer_cache_spec(cfg: ModelConfig, mixer: str, batch: int,
                      cache_len: int, dtype, kv_format: Optional[str],
                      enc_len: Optional[int]):
    if mixer == "mla":
        spec = attention.make_mla_cache_spec(cfg, batch, cache_len, dtype)
    elif mixer == "mamba":
        spec = ssm.make_mamba_cache_spec(cfg, batch, dtype)
    else:
        spec = attention.make_attn_cache_spec(cfg, batch, cache_len, dtype,
                                              kv_format)
    if cfg.encdec and enc_len is not None:
        spec.update(attention.make_cross_cache_spec(cfg, batch, enc_len,
                                                    dtype))
    return spec


def make_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=torch.bfloat16, kv_format: Optional[str] = None,
                     enc_len: Optional[int] = None) -> Dict[str, Any]:
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
    Every leaf keeps the row (sequence or page) axis first."""
    return {"blocks": [_layer_cache_spec(cfg, mixer, batch, cache_len,
                                         dtype, kv_format, enc_len)
                       for mixer, _ in cfg.layer_kinds()]}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None,
               kv_format: Optional[str] = None,
               enc_len: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed caches of :func:`make_cache_specs` on ``device``."""
    device = resolve_device(device)
    specs = make_cache_specs(cfg, batch, cache_len, dtype, kv_format,
                             enc_len)
    return {"blocks": [{name: torch.zeros(shape, dtype=dt, device=device)
                        for name, (shape, dt) in layer.items()}
                       for layer in specs["blocks"]]}


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
    ``False``).  A mesh (``ctx``) raises: it waits for the meshes slice.
    """

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 remat: bool = False, ctx: Optional[object] = None):
        transformer._check_family(cfg)
        if ctx is not None:
            raise NotImplementedError("Model over a mesh (ctx) waits for the "
                                      "meshes slice")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat

    def init(self, seed: int = 0, dtype=torch.bfloat16) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return transformer.init_params(self.cfg, gen, dtype, self.device)

    # ---- training ----
    def apply_train(self, params, inputs,
                    enc_embeds: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(logits (B, S, V), aux loss)`` of the training forward."""
        return transformer.forward(params, self.cfg, inputs,
                                   remat=self.remat, enc_embeds=enc_embeds)

    def loss_fn(self, params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy plus the aux loss, in fp32, as
        the reference's: ``logsumexp(lf) - lf[label]`` over ``batch
        ["inputs"]``/``["labels"]`` (``["enc_embeds"]`` for an
        encoder-decoder).  The label's logit is gathered, not picked by a
        (B, S, V) one-hot."""
        logits, aux = self.apply_train(params, batch["inputs"],
                                       batch.get("enc_embeds"))
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, batch["labels"].long()[..., None])[..., 0]
        xent = torch.mean(lse - ll)
        return xent + aux, {"xent": xent, "aux": aux}

    def prefill(self, params, inputs, cache,
                enc_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        return transformer.prefill(params, self.cfg, inputs, cache,
                                   enc_embeds=enc_embeds)

    def decode(self, params, inputs, cache, pos, block_tab=None,
               kv_span: Optional[int] = None) -> torch.Tensor:
        return transformer.decode_step(params, self.cfg, inputs, cache, pos,
                                       block_tab=block_tab, kv_span=kv_span)

    def chunk_prefill(self, params, inputs, cache, offset, block_tab,
                      kv_span: Optional[int] = None) -> torch.Tensor:
        return transformer.chunk_prefill_step(
            params, self.cfg, inputs, cache, offset, block_tab=block_tab,
            kv_span=kv_span)
