"""Analytic + calibrated cost model for offloading-based RAG serving.

Ported from ``repro.core.costmodel``: the formulas are the reference's,
term for term, so the port computes the same floats from the same
profiles.  One object feeds the placement optimizer, the active profiler
and (in later slices) the simulator, so their numbers are consistent by
construction.

The generation model follows FlexGen's formulation: per layer, compute and
weight/KV transfer overlap, so layer time = max(compute, transfer) times a
jitter penalty that shrinks with prefetch-queue depth (RAGDoll §4.3: fixed
next-layer prefetch suffers scheduling jitter; a deep queue absorbs it).

``H100_HOST`` is the port's own platform: one NVIDIA H100 and its host,
each field measured on the card by ``chip_smoke.py``'s serve-placement
phase.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.configs.base import ModelConfig

GB = 1024 ** 3


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    gpu_flops: float            # effective accelerator FLOP/s (bf16)
    gpu_mem: float              # bytes
    gpu_hbm_bw: float           # bytes/s
    cpu_mem: float              # bytes
    pcie_bw: float              # host<->device bytes/s (effective)
    disk_read_bw: float         # partition-load bytes/s (incl. DB overhead)
    cpu_flops: float            # host FLOP/s for retrieval matmuls
    disk_raw_bw: float = 3.0e9  # raw NVMe streaming (weight tensors)
    jitter: float = 0.35        # scheduling jitter fraction (paper §4.3)
    mem_headroom: float = 0.92  # usable fraction of each memory
    # cross-host interconnect for the sharded-retrieval (Q, k) all-gather
    # (per-link effective; ethernet-class on the PF hosts)
    interconnect_bw: float = 12.5e9


# Paper platforms (§6.1). gpu_flops are *effective* (derated from peak);
# disk_read_bw is the effective partition-load rate including Milvus
# deserialization/collection-load overhead — calibrated so one 8 GB
# partition takes ~25 s on PF-High, reproducing the ~300 s retrieval
# phase of Table 1 (loads dominate search, paper section 4.4).
PF_HIGH = HardwareProfile(
    name="PF-High", gpu_flops=82e12, gpu_mem=24 * GB, gpu_hbm_bw=933e9,
    cpu_mem=256 * GB, pcie_bw=20e9, disk_read_bw=0.32e9, cpu_flops=1.1e12,
    disk_raw_bw=3.5e9)
PF_LOW = HardwareProfile(
    name="PF-Low", gpu_flops=30e12, gpu_mem=12 * GB, gpu_hbm_bw=768e9,
    cpu_mem=176 * GB, pcie_bw=10e9, disk_read_bw=0.30e9, cpu_flops=0.9e12,
    disk_raw_bw=2.0e9)
# One NVIDIA H100 80GB HBM3 (power limit 700.00 W) and its host (8 cores),
# as ``chip_smoke.py``'s serve-placement phase measures them (its
# ``[profile-hw]`` lines): a bf16 ``torch.matmul`` of (8192, 4096) by
# (4096, 14336); a device-to-device copy of 1 GiB (bytes read + written);
# ``total_memory``; ``os.sysconf`` physical pages; a pinned host-to-device
# copy of 256 MiB; cold loads of four spilled partitions after
# ``POSIX_FADV_DONTNEED``, median rate (``disk_read_bw`` through
# ``VectorStore.load``, ``disk_raw_bw`` the bare ``np.load``); a numpy fp32
# (8, 768) x (768, 15625) product, median of 50.  ``jitter``,
# ``mem_headroom`` and ``interconnect_bw`` keep the defaults.
H100_HOST = HardwareProfile(
    name="H100-host", gpu_flops=8.03961e14, gpu_mem=8.50175e10,
    gpu_hbm_bw=3.0292e12, cpu_mem=1.08448e11, pcie_bw=3.73401e10,
    disk_read_bw=1.90806e9, cpu_flops=1.3217e11, disk_raw_bw=2.3958e9)


# bytes per stored KV element for each pool format (mirrors
# serving.kvpool.KV_FORMAT_BYTES; kept literal here so the cost model
# has no dependency on the serving layer)
KV_FORMAT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


@dataclass(frozen=True)
class ModelProfile:
    """Byte/FLOP footprint of one model, derived from its config.

    ``kv_format`` is the live pool format bytes-per-token is derived
    from — the 2x accounting bug this layer used to have was pricing KV
    with a hard-coded 2-byte dtype while the engines allocated fp32
    pools.  ``kv_scale_bytes_per_page`` is the per-page fp32
    dequantization-scale overhead; :meth:`kv_page_bytes` adds it only
    when the format is int8.
    """
    name: str
    n_params: int
    n_active: int
    n_layers: int
    weight_bytes: int
    kv_bytes_per_token: int     # across all layers
    ssm_state_bytes: int        # per sequence (constant in ctx len)
    d_model: int
    vocab_size: int
    kv_format: str = "bf16"
    kv_scale_bytes_per_page: int = 0

    @classmethod
    def from_config(cls, cfg: ModelConfig, dtype_bytes: int = 2,
                    kv_format: Optional[str] = None) -> "ModelProfile":
        """Derive the profile; ``kv_format`` names the actual KV pool
        format (fp32/bf16/int8) and overrides ``dtype_bytes`` for the
        KV terms.  ``kv_format=None`` keeps the legacy ``dtype_bytes``
        pricing for callers that manage their own accounting."""
        if kv_format is not None:
            if kv_format not in KV_FORMAT_BYTES:
                raise ValueError(f"unknown kv_format {kv_format!r}")
            kv_dtype_bytes = KV_FORMAT_BYTES[kv_format]
        else:
            kv_dtype_bytes = dtype_bytes
            kv_format = {4: "fp32", 2: "bf16", 1: "int8"}.get(
                dtype_bytes, "bf16")
        return cls(
            name=cfg.name,
            n_params=cfg.param_count(),
            n_active=cfg.param_count(active_only=True),
            n_layers=cfg.num_layers,
            weight_bytes=cfg.weight_bytes(dtype_bytes),
            kv_bytes_per_token=cfg.kv_cache_bytes_per_token(kv_dtype_bytes),
            ssm_state_bytes=cfg.ssm_state_bytes(),
            d_model=cfg.d_model,
            vocab_size=cfg.vocab_size,
            kv_format=kv_format,
            kv_scale_bytes_per_page=cfg.kv_scale_bytes_per_page(),
        )

    def with_kv_format(self, kv_format: str) -> "ModelProfile":
        """Reprice the KV terms for a different pool format (same model).

        The per-token byte count rescales exactly (it is linear in the
        element size); the scale overhead only bites for int8 via
        :meth:`kv_page_bytes`.  This is how the placement market prices
        the bits-per-token dimension without re-deriving from config.
        """
        if kv_format not in KV_FORMAT_BYTES:
            raise ValueError(f"unknown kv_format {kv_format!r}")
        if kv_format == self.kv_format:
            return self
        old = KV_FORMAT_BYTES[self.kv_format]
        new = KV_FORMAT_BYTES[kv_format]
        return replace(self, kv_format=kv_format,
                       kv_bytes_per_token=self.kv_bytes_per_token
                       * new // old)

    @property
    def layer_bytes(self) -> float:
        return self.weight_bytes / max(self.n_layers, 1)

    def kv_bytes(self, batch: int, ctx_len: int) -> float:
        return batch * (ctx_len * self.kv_bytes_per_token
                        + self.ssm_state_bytes)

    def workspace_bytes(self, batch: int, seq_len: int) -> float:
        """H(B): peak activation workspace for one layer's compute."""
        # hidden states + attention workspace, bf16, x4 safety for fusion temps
        return 4 * batch * seq_len * self.d_model * 2

    def kv_page_bytes(self, page_size: int) -> float:
        """Bytes of one KV page across all layers (placement's paging
        unit).  int8 pages carry their fp32 dequantization scales, so
        the market prices the real leaf bytes, not just the payload."""
        scale = (self.kv_scale_bytes_per_page
                 if self.kv_format == "int8" else 0)
        return page_size * self.kv_bytes_per_token + scale

    def flops_per_token(self) -> float:
        return 2 * self.n_active          # forward pass, per token


@dataclass
class GenCosts:
    prefill: float
    per_token: float


class CostModel:
    def __init__(self, hw: HardwareProfile, mp: ModelProfile,
                 partition_bytes: float, num_partitions: int,
                 db_dim: int = 768, chunks_per_partition: float = 2e7,
                 partition_mem_overhead: float = 1.45,
                 partition_load_overhead: float = 1.0,
                 retrieval_shards: int = 1):
        self.hw = hw
        self.mp = mp
        self.partition_bytes = partition_bytes
        self.num_partitions = num_partitions
        self.db_dim = db_dim
        self.chunks_per_partition = chunks_per_partition
        # RAM footprint of a resident partition exceeds its serialized
        # size (index structures, allocator overhead) — paper's DiskANN
        # case study flips this trade (smaller footprint, slower load).
        self.partition_mem_overhead = partition_mem_overhead
        self.partition_load_overhead = partition_load_overhead
        # sharded IVF retrieval: each of S hosts owns a disjoint subset
        # of the partitions with its own disk, so loads and searches run
        # S-wide in parallel at the cost of one (Q, k) all-gather
        self.retrieval_shards = max(1, retrieval_shards)

    @property
    def partition_mem_bytes(self) -> float:
        return self.partition_bytes * self.partition_mem_overhead

    # ----------------------------------------------------------- retrieval
    def partition_load_time(self) -> float:
        return (self.partition_bytes * self.partition_load_overhead
                / self.hw.disk_read_bw)

    def partition_search_time(self, batch: int) -> float:
        flops = 2.0 * batch * self.chunks_per_partition * self.db_dim
        return flops / self.hw.cpu_flops

    @property
    def hot_partition_dev_bytes(self) -> float:
        """Device bytes of one promoted hot partition: the raw float32
        embedding matrix, without the host-side index/allocator overhead
        (the hot tier uploads exactly what the top-k kernel reads)."""
        return self.chunks_per_partition * self.db_dim * 4.0

    def device_search_time(self, batch: int) -> float:
        """Scoring one *device-resident* (hot) partition: the same top-k
        matmul the host sweep runs, on accelerator FLOPs, plus one HBM
        read of the partition — the price the device-byte market weighs
        against ``partition_load_time`` when arbitrating promotions."""
        flops = 2.0 * batch * self.chunks_per_partition * self.db_dim
        return (flops / self.hw.gpu_flops
                + self.hot_partition_dev_bytes / self.hw.gpu_hbm_bw)

    def topk_allgather_time(self, batch: int, top_k: int = 10,
                            shards: Optional[int] = None) -> float:
        """Cross-shard scoreboard fusion: every shard contributes a
        ``(Q, k)`` board of (f32 score, i32 id) pairs; a ring all-gather
        moves ``(S-1)/S`` of the total payload per link, plus a per-hop
        launch latency.  Zero for the single-host deployment."""
        s = max(1, self.retrieval_shards if shards is None else shards)
        if s <= 1:
            return 0.0
        payload = s * batch * top_k * 8
        return (payload * (s - 1) / s / self.hw.interconnect_bw
                + 2e-5 * (s - 1))

    def retrieval_time(self, batch: int, resident: int,
                       nprobe: Optional[int] = None,
                       shards: Optional[int] = None,
                       hot_partitions: int = 0,
                       hot_hit_rate: Optional[float] = None) -> float:
        """One retrieval batch over the probed partitions.

        ``nprobe=None`` is the exact all-partition sweep; an IVF placement
        prunes to ``nprobe`` clusters, so both the loads and the searches
        shrink.  The cache keeps the hottest partitions, so probed
        partitions hit residents first.  Non-resident partitions stream
        from disk; loading dominates (paper §4.4), and search of a loaded
        partition overlaps the next load (double-buffered streamer), so
        total ~ max(loads, search) + small residual.

        With ``shards`` (default: the model's ``retrieval_shards``) the
        probed partitions split across S hosts — each host drives its own
        disk and CPU, so the per-host critical path is ``ceil(work / S)``
        — and the shard-local boards fuse with one (Q, k) all-gather.

        ``hot_partitions``/``hot_hit_rate`` price the device-resident hot
        tier: the expected ``hot_hit_rate`` fraction of probes (default:
        the uniform ``hot_partitions / num_partitions``) skips the disk
        load *and* the host matmul, landing on the accelerator instead;
        device sweeps run on their own processor, so they join the
        ``max`` as a third overlapped term.
        """
        s = max(1, self.retrieval_shards if shards is None else shards)
        n_probe = (self.num_partitions if nprobe is None
                   else max(1, min(nprobe, self.num_partitions)))
        n_hot = 0.0
        if hot_partitions > 0:
            frac = (hot_hit_rate if hot_hit_rate is not None
                    else hot_partitions / max(self.num_partitions, 1))
            n_hot = n_probe * min(max(frac, 0.0), 1.0)
        host_probe = n_probe - n_hot
        n_load = max(host_probe - resident, 0.0)
        load = math.ceil(n_load / s) * self.partition_load_time()
        search = math.ceil(host_probe / s) * self.partition_search_time(batch)
        device = n_hot * self.device_search_time(batch)
        return (max(load, search, device) + 0.1 * min(load, search)
                + self.topk_allgather_time(batch, shards=s))

    # ---------------------------------------------------------- generation
    def _layer_time(self, flops: float, pcie_bytes: float,
                    disk_bytes: float, hbm_bytes: float,
                    depth: int) -> float:
        compute = flops / self.hw.gpu_flops + hbm_bytes / self.hw.gpu_hbm_bw
        transfer = (pcie_bytes / self.hw.pcie_bw
                    + disk_bytes / self.hw.disk_raw_bw)
        jitter_penalty = self.hw.jitter / max(depth, 1)
        if depth == 0:   # no prefetch at all (AccRAG-style): serial
            return compute + transfer
        return max(compute, transfer) * (1.0 + jitter_penalty)

    def prefill_time(self, batch: int, in_len: int, w_gpu: float,
                     c_gpu: float, depth: int = 1,
                     w_cpu: Optional[float] = None,
                     cached_len: int = 0) -> float:
        """One prefill pass.  ``cached_len`` tokens of the prompt are
        already resident as shared KV pages (radix prefix cache) — they
        cost no FLOPs and no KV offload traffic, only the suffix
        ``in_len - cached_len`` is computed, which is exactly the TTFT
        collapse the prefix cache buys (fig8 shared-prefix row)."""
        mp = self.mp
        w_cpu = (1 - w_gpu) if w_cpu is None else w_cpu
        w_disk = max(0.0, 1 - w_gpu - w_cpu)
        live = max(in_len - max(cached_len, 0), 1)
        tokens = batch * live
        flops_l = mp.flops_per_token() * tokens / mp.n_layers
        # quadratic attention term (rough: included via 10% margin)
        kv_off = (1 - c_gpu) * mp.kv_bytes(batch, in_len) / mp.n_layers
        hbm = mp.layer_bytes + 2 * tokens * mp.d_model * 2
        t = mp.n_layers * self._layer_time(
            flops_l * 1.1, w_cpu * mp.layer_bytes + kv_off,
            w_disk * mp.layer_bytes, hbm, depth)
        return t

    def decode_time_per_token(self, batch: int, ctx_len: int, w_gpu: float,
                              c_gpu: float, depth: int = 4,
                              w_cpu: Optional[float] = None) -> float:
        mp = self.mp
        w_cpu = (1 - w_gpu) if w_cpu is None else w_cpu
        w_disk = max(0.0, 1 - w_gpu - w_cpu)
        flops_l = mp.flops_per_token() * batch / mp.n_layers
        kv_traffic = (1 - c_gpu) * mp.kv_bytes(batch, ctx_len) / mp.n_layers
        hbm = mp.layer_bytes + c_gpu * mp.kv_bytes(batch, ctx_len) / mp.n_layers
        return mp.n_layers * self._layer_time(
            flops_l, w_cpu * mp.layer_bytes + kv_traffic,
            w_disk * mp.layer_bytes, hbm, depth)

    def generation_time(self, batch: int, in_len: int, out_len: int,
                        w_gpu: float, c_gpu: float,
                        depth_prefill: int = 1, depth_decode: int = 4,
                        w_cpu: Optional[float] = None,
                        cached_len: int = 0) -> GenCosts:
        pre = self.prefill_time(batch, in_len, w_gpu, c_gpu, depth_prefill,
                                w_cpu=w_cpu, cached_len=cached_len)
        tok = self.decode_time_per_token(batch, in_len + out_len // 2,
                                         w_gpu, c_gpu, depth_decode,
                                         w_cpu=w_cpu)
        return GenCosts(prefill=pre, per_token=tok)

    def batch_generation_time(self, batch: int, in_len: int, out_len: int,
                              w_gpu: float, c_gpu: float,
                              depth_prefill: int = 1,
                              depth_decode: int = 4,
                              w_cpu: Optional[float] = None,
                              cached_len: int = 0) -> float:
        g = self.generation_time(batch, in_len, out_len, w_gpu, c_gpu,
                                 depth_prefill, depth_decode, w_cpu=w_cpu,
                                 cached_len=cached_len)
        return g.prefill + out_len * g.per_token

    # ------------------------------------------------------------- weights
    def placement_shift_time(self, moved_bytes: float) -> float:
        """Lazy dynamic transfer of weights between tiers (background)."""
        return moved_bytes / self.hw.pcie_bw

    # ---------------------------------------------------------------- swap
    def kv_swap_time(self, pages: int, page_size: int,
                     kv_format: Optional[str] = None,
                     overlap: bool = False,
                     hidden_s: float = 0.0) -> float:
        """One whole-page KV swap, either direction: ``pages`` pages of
        ``page_size`` tokens across all layers over the measured PCIe
        bandwidth (the simulator's preemption latency model).  Priced
        from the profile's own pool format — the same source the page
        budget uses — so DMA and capacity can never disagree about the
        bytes of a page; ``kv_format`` reprices for a different live
        format (int8 swaps move ~4x fewer bytes).

        ``overlap=True`` models swap/decode overlap: the copy rides an
        async transfer worker while unaffected slots keep decoding, so
        only the copy time NOT hidden behind ``hidden_s`` of concurrent
        compute stalls the pipeline (inline mode stalls for the whole
        copy)."""
        mp = (self.mp if kv_format is None
              else self.mp.with_kv_format(kv_format))
        raw = pages * mp.kv_page_bytes(page_size) / self.hw.pcie_bw
        if overlap:
            return max(raw - hidden_s, 0.0)
        return raw
