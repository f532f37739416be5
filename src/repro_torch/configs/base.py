"""Unified model configuration covering every assigned architecture family.

One ``ModelConfig`` instantiates dense transformers, GQA/MQA/MLA attention,
MoE (with shared experts), Mamba2/SSD blocks, hybrid interleaves (Jamba),
and encoder-decoder stacks (Seamless).  The per-layer structure is expressed
as a repeating ``layer_pattern`` of ``(mixer, ffn)`` kinds so the model core
can scan over pattern repeats (HLO size stays O(pattern length), not O(depth)).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0          # per-shared-expert hidden dim
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01

    @property
    def active_experts(self) -> int:
        return self.top_k + self.num_shared_experts


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: Optional[int] = None  # V2-Lite uses a full q projection

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


# Mixer kinds: "attn" (global), "local" (sliding window attn), "mla", "mamba"
# FFN kinds:   "dense", "moe", "none"
LayerKind = Tuple[str, str]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # attention details
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # chatglm applies rotary to half the dims
    sliding_window: int = 4096     # used by "local" mixer layers
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qkv_bias: bool = False         # chatglm3 uses qkv bias

    # FFN
    mlp_kind: str = "swiglu"       # swiglu | geglu | gelu

    # structure
    layer_pattern: Tuple[LayerKind, ...] = (("attn", "dense"),)
    first_k_dense: int = 0         # deepseek: first k layers use a dense FFN
    first_dense_d_ff: int = 0      # hidden dim of those dense layers

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # encoder-decoder (seamless)
    encdec: bool = False
    num_encoder_layers: int = 0
    dec_len_ratio: float = 0.125   # decoder text length = seq_len * ratio

    # frontends: "token" -> int ids; "embed" -> precomputed embeddings (stub)
    frontend: str = "token"
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    # gemma multiplies embeddings by sqrt(d_model)
    scale_embeddings: bool = False

    # sub-quadratic? (controls long_500k eligibility)
    subquadratic: bool = False

    # ----------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def pattern_repeats(self) -> int:
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.layer_pattern)}")
        return self.num_layers // len(self.layer_pattern)

    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        """Fully unrolled per-layer kinds (length == num_layers)."""
        kinds = []
        for i in range(self.num_layers):
            mixer, ffn = self.layer_pattern[i % len(self.layer_pattern)]
            if i < self.first_k_dense and ffn == "moe":
                ffn = "dense"
            kinds.append((mixer, ffn))
        return tuple(kinds)

    # ------------------------------------------------------------ param count
    def _attn_params(self, mixer: str) -> int:
        d, h = self.d_model, self.resolved_head_dim
        if mixer == "mla":
            m = self.mla
            nh = self.num_heads
            p = d * m.kv_lora_rank                     # kv down-proj
            p += d * m.qk_rope_head_dim                # shared k rope
            p += m.kv_lora_rank * nh * (m.qk_nope_head_dim + m.v_head_dim)
            if m.q_lora_rank:
                p += d * m.q_lora_rank + m.q_lora_rank * nh * m.qk_head_dim
            else:
                p += d * nh * m.qk_head_dim
            p += nh * m.v_head_dim * d                 # o proj
            return p
        if mixer == "mamba":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            p = d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
            p += s.d_conv * (di + 2 * s.n_groups * s.d_state)   # conv1d
            p += nh * 2                                          # A_log, dt_bias
            p += di                                              # norm gate
            p += di * d                                          # out proj
            return p
        # attn / local
        q = d * self.num_heads * h
        kv = 2 * d * self.num_kv_heads * h
        o = self.num_heads * h * d
        bias = (self.num_heads + 2 * self.num_kv_heads) * h if self.qkv_bias else 0
        return q + kv + o + bias

    def _ffn_params(self, ffn: str, active_only: bool = False) -> int:
        d = self.d_model
        n_mat = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        if ffn == "none":
            return 0
        if ffn == "dense":
            dff = self.first_dense_d_ff or self.d_ff
            return n_mat * d * dff
        if ffn == "moe":
            m = self.moe
            per_exp = n_mat * d * m.d_ff_expert
            shared = m.num_shared_experts * n_mat * d * (m.d_ff_shared or m.d_ff_expert)
            router = d * m.num_experts
            n_exp = m.top_k if active_only else m.num_experts
            return n_exp * per_exp + shared + router
        raise ValueError(ffn)

    def param_count(self, active_only: bool = False) -> int:
        """Total (or activated, for MoE) parameter count. Used for 6ND."""
        p = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model
        kinds = self.layer_kinds()
        for mixer, ffn in kinds:
            p += self._attn_params(mixer)
            p += self._ffn_params(ffn, active_only=active_only)
            p += 2 * self.d_model  # two rmsnorms per layer
        if self.encdec:
            # encoder: dense attention + dense FFN, num_encoder_layers deep
            enc = self.num_encoder_layers * (
                self._attn_params("attn") + self._ffn_params("dense")
                + 2 * self.d_model)
            # decoder cross-attention (one per decoder layer)
            cross = self.num_layers * (self._attn_params("attn") + self.d_model)
            p += enc + cross
        p += self.d_model  # final norm
        return int(p)

    # --------------------------------------------------------------- reduced
    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pat_len = len(self.layer_pattern)
        small: dict = dict(
            name=self.name + "-reduced",
            num_layers=max(pat_len, 2 * pat_len if pat_len <= 4 else pat_len),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=503,
            sliding_window=16,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=32,
                d_ff_shared=32 if self.moe.num_shared_experts else 0)
        if self.mla is not None:
            small["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                     qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=8)
        if self.first_k_dense:
            small["first_dense_d_ff"] = 128
        if self.encdec:
            small["num_encoder_layers"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)

    # ------------------------------------------------------------- byte sizes
    def weight_bytes(self, dtype_bytes: int = 2) -> int:
        return self.param_count() * dtype_bytes

    def kv_cache_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Per-sequence-token recurrent-state bytes across all layers."""
        total = 0
        for mixer, _ in self.layer_kinds():
            if mixer in ("attn", "local"):
                total += 2 * self.num_kv_heads * self.resolved_head_dim * dtype_bytes
            elif mixer == "mla":
                total += (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim) * dtype_bytes
            # mamba state is O(1) in sequence length: not per-token
        if self.encdec:
            total += self.num_layers * 2 * self.num_kv_heads * \
                self.resolved_head_dim * dtype_bytes  # cross-attn cache
        return total

    def kv_scale_bytes_per_page(self, scale_bytes: int = 4) -> int:
        """Per-KV-page quantization-scale bytes across all layers.

        int8 KV pools keep one fp32 scale per (page, kv_head) for each of
        k and v (``kernels/quant.py``); this is the per-page overhead the
        byte market must price on top of the int8 payload.  Only
        attention-family mixers page (and hence quantize) their KV.
        """
        total = 0
        for mixer, _ in self.layer_kinds():
            if mixer in ("attn", "local"):
                total += 2 * self.num_kv_heads * scale_bytes
        return total

    def ssm_state_bytes(self, dtype_bytes: int = 4) -> int:
        """Per-sequence constant state (mamba conv + ssd state)."""
        if self.ssm is None:
            return 0
        s = self.ssm
        di = s.d_inner(self.d_model)
        nh = s.num_heads(self.d_model)
        n_mamba = sum(1 for m, _ in self.layer_kinds() if m == "mamba")
        conv = (di + 2 * s.n_groups * s.d_state) * s.d_conv
        state = nh * s.head_dim * s.d_state
        return n_mamba * (conv + state) * dtype_bytes


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000:
            return f"{n:.2f}{unit}"
        n /= 1000
    return f"{n:.2f}Q"
