"""Mixture-of-experts FFN: sort-based dispatch and a grouped GEMM.

The port of ``repro.models.moe`` without a mesh (``ctx=None``): route
each token to its top-k experts, sort the ``T * K`` (token, expert) rows
by expert (a stable sort, as ``jnp.argsort``), run each expert's FFN on
its rows, and add the weighted rows back to their tokens.  Two grouped
GEMMs, as in the reference:

* exact (``_grouped_ffn``, below ``CAPACITY_THRESHOLD`` rows): every row
  goes through its expert.  ``lax.ragged_dot`` becomes batched products
  over a zero-padded ``(E, T * K, D)`` buffer, so no group size is read
  back to the host: a decode step issues the same few launches whatever
  the routing.  The products go through in runs of experts, as few as
  keep a run's fp32 intermediates under ``EXACT_RUN_BYTES`` (one run at a
  decode step and at deepseek's 6144-row join; jamba's 16 experts of
  24576 take two runs of 8 at a 1024-token join, where one would need
  12 GiB);
* capacity (``_grouped_ffn_capacity``, at or above it): each expert takes
  a window of ``cap`` rows from its group's start, clamped to ``tk - cap``
  and masked to its own group, so rows past an expert's capacity are
  dropped, exactly the rows the reference drops.

The products are plain matrix products outside any Pallas kernel in the
reference, and stay ``torch.bmm`` here: the exact path's in fp32 from
bf16 operands, as ``ragged_dot(..., preferred_element_type=f32)``
(``_mm_f32``), the capacity path's in the operands' type, as the
reference's ``blk @ w``.  Under autograd (training) the exact path's
products take ``_MmF32``, whose backward is fp32 products too.  Over a mesh
(``ctx``), ``moe_forward`` is the reference's tensor-parallel
``shard_map`` and ``moe_forward_ep`` its expert-parallel all-to-all.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers
from repro_torch.models.parallel import Layout
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import MeshContext, _pspec_for

# rows (tokens x top-k) at or above this switch to the capacity path
CAPACITY_THRESHOLD = 8192
CAPACITY_FACTOR = 1.25
# the exact path's fp32 intermediates (gate, up, activation, product) a
# run of experts may hold at once
EXACT_RUN_BYTES = 10 << 30
# the tensor-parallel MoE's sum over the model axis in this type (None:
# fp32), as the reference's ``PSUM_DTYPE``
PSUM_DTYPE = None


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Router in fp32 whatever ``dtype``, as the reference creates it."""
    m = cfg.moe
    d = cfg.d_model
    e, f = m.num_experts, m.d_ff_expert
    p = {
        "router": layers.dense_init(gen, (d, e), torch.float32, device),
        "w_gate": layers.dense_init(gen, (e, d, f), dtype, device, fan_in=d),
        "w_up": layers.dense_init(gen, (e, d, f), dtype, device, fan_in=d),
        "w_down": layers.dense_init(gen, (e, f, d), dtype, device, fan_in=f),
    }
    if m.num_shared_experts:
        f_sh = (m.d_ff_shared or f) * m.num_shared_experts
        p["shared"] = layers.init_mlp(gen, d, f_sh, cfg.mlp_kind, dtype,
                                      device)
    return p


def _route(p: dict, x2: torch.Tensor, m: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (T, D) -> weights (T, K), ids (T, K), probs (T, E), fp32.

    ``jax.lax.top_k`` returns the lower index first among equal values: a
    stable descending sort does the same."""
    logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :m.top_k], ids[:, :m.top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, ids, probs


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each of ``n`` ids (``bincount`` without its read
    of the largest id back to the host)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _act(g: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    return F.silu(g) if mlp_kind == "swiglu" else layers.gelu(g)


def _group_index(gs: torch.Tensor, tk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-sorted rows' expert and position in their group."""
    e = gs.shape[0]
    expert = torch.repeat_interleave(
        torch.arange(e, device=gs.device), gs, output_size=tk)
    starts = torch.cumsum(gs, 0) - gs
    return expert, torch.arange(tk, device=gs.device) - starts[expert]


def _mm_f32(a: torch.Tensor, b: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bmm`` of same-typed operands with an fp32 result.  On the card
    ``out_dtype`` accumulates bf16 operands into fp32 output; the CPU build
    has no kernel for it, so there the operands go to fp32 first (exact:
    a product of two bf16 values fits in fp32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b, out=out)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32, out=out)
    return torch.bmm(a.float(), b.float(), out=out)


class _MmF32(torch.autograd.Function):
    """``_mm_f32`` for training: the forward as serving runs it, and a
    backward of fp32 products of operands in the forward's type (the
    incoming fp32 gradient rounded to it), each gradient in its operand's
    type.  ``out_dtype``'s own derivative is not relied on, and the CPU's
    fp32 products keep their fp32 gradients."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.to(a.dtype)
        da = _mm_f32(dy, b.transpose(1, 2).contiguous()).to(a.dtype)
        db = _mm_f32(a.transpose(1, 2).contiguous(), dy).to(b.dtype)
        return da, db


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def exact_run(tk: int, num_experts: int, d_ff: int) -> int:
    """Experts a run of the exact path takes at ``tk`` rows: the fewest
    runs that keep four fp32 ``(tk, d_ff)`` intermediates an expert under
    ``EXACT_RUN_BYTES``, the experts spread evenly over them."""
    most = max(1, EXACT_RUN_BYTES // max(4 * tk * d_ff * 4, 1))
    runs = -(-num_experts // most)
    return -(-num_experts // runs)


def _grouped_ffn(p: dict, xs: torch.Tensor, gs: torch.Tensor,
                 mlp_kind: str) -> torch.Tensor:
    """(T*K, D) rows sorted by expert, group sizes (E,) -> (T*K, D) fp32.

    Exact: every row meets its expert's weights; the products in fp32
    (``_mm_f32``), the activation in fp32, the hidden rows rounded to
    ``xs``'s type before ``w_down``, as the reference's ``ragged_dot``
    with ``preferred_element_type=f32``.  The experts go through
    ``exact_run`` at a time (from shapes alone), each run's down product
    written into its experts' slice of one output.  Under autograd
    (training) the products go through ``_MmF32`` and the runs' outputs
    are concatenated instead: autograd refuses ``out=``."""
    tk, d = xs.shape
    e = gs.shape[0]
    expert, at = _group_index(gs, tk)
    buf = xs.new_zeros((e, tk, d))
    buf[expert, at] = xs
    run = exact_run(tk, e, p["w_gate"].shape[-1])
    if _wants_grad(xs, p["w_gate"], p["w_up"], p["w_down"]):
        ys = []
        for e0 in range(0, e, run):
            r = slice(e0, e0 + run)
            g = _MmF32.apply(buf[r], p["w_gate"][r])
            u = _MmF32.apply(buf[r], p["w_up"][r])
            h = (_act(g, mlp_kind) * u).to(xs.dtype)
            ys.append(_MmF32.apply(h, p["w_down"][r]))
        return torch.cat(ys)[expert, at]
    y = None
    for e0 in range(0, e, run):
        r = slice(e0, e0 + run)
        g = _mm_f32(buf[r], p["w_gate"][r])
        u = _mm_f32(buf[r], p["w_up"][r])
        h = (_act(g, mlp_kind) * u).to(xs.dtype)
        del g, u
        if y is None:        # once the first run's intermediates are gone
            y = torch.empty((e, tk, d), dtype=torch.float32,
                            device=xs.device)
        _mm_f32(h, p["w_down"][r], out=y[r])
    return y[expert, at]


def capacity(tk: int, num_experts: int,
             capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Rows an expert takes on the capacity path."""
    cap = -(-int(capacity_factor * tk) // num_experts)
    return min(max(8, -(-cap // 8) * 8), tk)


def _capacity_windows(gs: torch.Tensor, tk: int, cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each expert's window of rows (E, cap) and which of them are its own."""
    starts = torch.cumsum(gs, 0) - gs
    clamped = torch.clamp(starts, max=tk - cap)
    idx = clamped[:, None] + torch.arange(cap, device=gs.device)
    valid = (idx >= starts[:, None]) & (idx < (starts + gs)[:, None])
    return idx, valid


def capacity_drops(gs: torch.Tensor, tk: int,
                   capacity_factor: float = CAPACITY_FACTOR) -> torch.Tensor:
    """Rows the capacity path drops, from the group sizes (a 0-d tensor)."""
    _, valid = _capacity_windows(gs, tk, capacity(tk, gs.shape[0],
                                                  capacity_factor))
    return gs.sum() - valid.sum()


def _grouped_ffn_capacity(p: dict, xs: torch.Tensor, gs: torch.Tensor,
                          mlp_kind: str,
                          capacity_factor: float = CAPACITY_FACTOR
                          ) -> torch.Tensor:
    """Fixed-capacity grouped GEMM: every expert runs its (cap, D) window
    of the sorted rows (all experts in one batched product, where the
    reference scans them); rows outside an expert's window are dropped
    and come back as zeros.  Products in ``xs``'s type, as the
    reference's ``blk @ w``; the activation in fp32."""
    tk, d = xs.shape
    cap = capacity(tk, gs.shape[0], capacity_factor)
    idx, valid = _capacity_windows(gs, tk, cap)
    blk = xs[idx]                                    # (E, cap, D)
    g = torch.bmm(blk, p["w_gate"])
    u = torch.bmm(blk, p["w_up"])
    h = (_act(g.float(), mlp_kind) * u.float()).to(xs.dtype)
    out = torch.bmm(h, p["w_down"]).float()
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    # each row is valid in one window at most: the adds meet zeros only
    y = torch.zeros((tk, d), dtype=torch.float32, device=xs.device)
    return y.index_add_(0, idx.reshape(-1), out.reshape(-1, d))


def grouped_ffn(p: dict, xs: torch.Tensor, gs: torch.Tensor, mlp_kind: str,
                impl: str = "auto") -> torch.Tensor:
    if impl == "ragged" or (impl == "auto"
                            and xs.shape[0] < CAPACITY_THRESHOLD):
        return _grouped_ffn(p, xs, gs, mlp_kind)
    if impl not in ("auto", "capacity"):
        raise ValueError(f"unknown grouped GEMM {impl!r}")
    return _grouped_ffn_capacity(p, xs, gs, mlp_kind)


def _moe_local(p: dict, x2: torch.Tensor, cfg: ModelConfig,
               gemm_impl: str = "auto", group=None, shared: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dropless (below the threshold) MoE of (T, D) tokens: returns
    (out (T, D) fp32, load (E,), importance (E,)).

    The reference adds the weighted rows back with a scatter-add in sorted
    order, so each token sums its experts' rows in ascending expert id;
    the same order here, as K adds, gives the same bits on either device
    (no atomics).  ``group``: the experts' F is split over it (tensor
    parallel), so ``out`` is this rank's partial sum, and the tokens and
    routing weights meet it through ``copy_to`` (their gradients summed
    over the group).  ``shared=False`` leaves the shared experts out."""
    m = cfg.moe
    t, d = x2.shape
    w, ids, probs = _route(p, x2, m)
    xe = x2
    if group is not None:
        xe, w = C.copy_to(x2, group), C.copy_to(w, group)
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    tok = order // m.top_k
    xs = xe[tok]
    gs = _counts(flat_ids, m.num_experts)
    y = grouped_ffn(p, xs, gs, cfg.mlp_kind, gemm_impl)
    wsort = w.reshape(-1)[order].float()
    rows = torch.empty_like(y)
    rows[order] = y * wsort[:, None]                 # back to (t, k) order
    out = _sum_by_id(rows.reshape(t, m.top_k, d), ids)
    if shared and "shared" in p:
        out = out + layers.apply_mlp(p["shared"], xe, cfg.mlp_kind).float()
    load = gs.float()
    importance = probs.sum(dim=0)
    return out, load, importance


def _sum_by_id(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(T, K, D) rows summed over K in ascending id order, from zero."""
    t, k, d = rows.shape
    by_id = torch.argsort(ids, dim=-1)               # ids differ in a row
    out = torch.zeros((t, d), dtype=torch.float32, device=rows.device)
    for j in range(k):
        out = out + torch.gather(
            rows, 1, by_id[:, j, None, None].expand(t, 1, d))[:, 0]
    return out


def _aux(m: MoEConfig, load: torch.Tensor, imp: torch.Tensor,
         t: int) -> torch.Tensor:
    return m.num_experts * torch.sum(
        (load / (t * m.top_k)) * (imp / t)) * m.aux_loss_coef


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: Optional[MeshContext] = None, gemm_impl: str = "auto",
                layout: Optional[Layout] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's type, aux_loss scalar).

    Over a mesh, tensor parallel (the reference's ``shard_map``): each
    rank runs every expert on its slice of F (``w_gate``/``w_up`` columns,
    ``w_down`` rows, as ``param_pspecs`` splits them over the model axis),
    the expert dim all-gathered over the batch axes it is split on; the
    partial outputs are summed over the model axis in ``PSUM_DTYPE``
    (fp32 when None), and ``load`` and importance over the batch axes,
    the token count ``bl * sl * dp_size``.  ``p`` is this rank's slices;
    with ``ctx`` alone ``x`` is the whole batch, alike on every rank, and
    so is the output; inside the model ``layout`` says how ``x`` lies."""
    if ctx is None and layout is None:
        b, s, d = x.shape
        out, load, imp = _moe_local(p, x.reshape(-1, d), cfg, gemm_impl)
        return (out.reshape(b, s, d).to(x.dtype),
                _aux(cfg.moe, load, imp, b * s))
    return _over_mesh(_moe_tp, p, x, cfg, ctx, layout, gemm_impl)


def moe_forward_ep(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   ctx: Optional[MeshContext] = None,
                   capacity_factor: float = CAPACITY_FACTOR,
                   layout: Optional[Layout] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallel (the reference's ``moe_forward_ep``): the experts
    split over the model axis, ``num_experts / tp`` a rank; every model
    rank routes all its batch rows (as the reference's ``shard_map`` hands
    them each), sends each routed row to its expert's owner through a
    buffer of ``cap = int(capacity_factor * T * K / tp)`` rows a
    destination, the rows past it dropped (the trash slot), and gets the
    outputs back by a second exchange.  The rows dropped, and so the
    output, are the reference's.  ``load`` and importance are summed over
    the batch axes, as the tensor-parallel path sums them (the
    reference's keeps each batch shard's own).  ``p`` and ``x`` as
    ``moe_forward`` takes them."""
    return _over_mesh(_moe_ep, p, x, cfg, ctx, layout, capacity_factor)


def _over_mesh(fn, p, x, cfg, ctx, layout, arg):
    """``fn`` on this rank's rows; with ``ctx`` alone, from and back to
    the whole batch."""
    if layout is not None:
        return fn(p, x, cfg, layout, arg)
    if ctx.dp_size > 1 and ctx.shard_tokens(x.shape[0]):
        lay = Layout(ctx, seq=False, batch=True)
        out, aux = fn(p, lay.rows(x), cfg, lay, arg)
        return C.gather_replicated(out, 0, ctx.batch_group), aux
    return fn(p, x, cfg, Layout(ctx, seq=False, batch=False), arg)


def _leaf_spec(name: str, cfg: ModelConfig, ctx: MeshContext):
    m = cfg.moe
    e, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    shape = (e, f, d) if name == "w_down" else (e, d, f)
    return _pspec_for(f"moe/{name}", shape, ctx)


def _whole_experts(p: dict, cfg: ModelConfig, lay: Layout) -> dict:
    """The expert leaves with their expert dim whole: all-gathered over
    the batch axes the rules split it on (its gradient reduce-scattered
    back where the batch rows split, each rank's own slice kept where
    every batch rank routes the same rows)."""
    ctx = lay.ctx
    q = dict(p)
    for name in ("w_gate", "w_up", "w_down"):
        axes = ctx.live_axes(_leaf_spec(name, cfg, ctx)[0])
        if axes:
            gather = C.all_gather if lay.batch else C.gather_replicated
            q[name] = gather(p[name], 0, ctx.axes_group(axes))
    return q


def _batch_stats(lay: Layout, load, imp, t: int):
    """``load``, importance and the token count over the batch axes."""
    if lay.batch:
        g = lay.ctx.batch_group
        return (C.all_reduce(load, g), C.all_reduce(imp, g),
                t * lay.ctx.dp_size)
    return load, imp, t


def _shared_whole(p: dict, x2: torch.Tensor, cfg: ModelConfig,
                  lay: Layout) -> torch.Tensor:
    """The shared experts on tokens every model rank holds alike, by the
    dense FFN's rules; the whole output, fp32."""
    m = cfg.moe
    f_sh = (m.d_ff_shared or m.d_ff_expert) * m.num_shared_experts
    if lay.sharded(f_sh):
        g = lay.model_group
        return C.all_reduce(layers.apply_mlp(
            p["shared"], C.copy_to(x2, g), cfg.mlp_kind).float(), g)
    return layers.apply_mlp(p["shared"], x2, cfg.mlp_kind).float()


def _moe_tp(p: dict, x: torch.Tensor, cfg: ModelConfig, lay: Layout,
            gemm_impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    xr = lay.rep_in(x)                     # whole sequences, alike
    bl, sl, d = xr.shape
    x2 = xr.reshape(-1, d)
    split_f = lay.sharded(m.d_ff_expert)
    out, load, imp = _moe_local(
        _whole_experts(p, cfg, lay), x2, cfg, gemm_impl,
        group=lay.model_group if split_f else None, shared=False)
    whole = None
    if "shared" in p:
        whole = _shared_whole(p, x2, cfg, lay)
    out = out.reshape(bl, sl, d)
    if split_f:
        out = lay.row_out(out.to(PSUM_DTYPE or torch.float32))
    else:
        out = lay.rep_out(out)
    if whole is not None:
        out = out + lay.rep_out(whole.reshape(bl, sl, d))
    load, imp, t = _batch_stats(lay, load, imp, bl * sl)
    return out.to(x.dtype), _aux(m, load, imp, t)


def _moe_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, lay: Layout,
            capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    ctx, tp, g = lay.ctx, lay.tp, lay.model_group
    if m.num_experts % tp:
        raise ValueError(f"EP needs num_experts % tp == 0 "
                         f"({m.num_experts} experts, tp {tp})")
    e_local = m.num_experts // tp
    xr = lay.rep_in(x)
    bl, sl, d = xr.shape
    t, k = bl * sl, m.top_k
    x2 = xr.reshape(t, d)
    w, ids, probs = _route(p, x2, m)
    cap = int(capacity_factor * t * k / tp) or 1
    flat_dest = (ids // e_local).reshape(-1)
    # each routed row's place in its destination's bucket, in row order
    onehot = F.one_hot(flat_dest, tp)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(1) - 1
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap))   # trash slot
    src = torch.arange(t * k, device=x.device) // k
    buf = x2.new_zeros((tp, cap + 1, d)).index_put(
        (flat_dest, slot), x2[src], accumulate=True)[:, :cap]
    eids = torch.zeros((tp, cap + 1), dtype=torch.int64,
                       device=x.device).index_put(
        (flat_dest, slot), ids.reshape(-1) % e_local,
        accumulate=True)[:, :cap]
    # every model rank sends the same rows: their gradients are summed
    recv = C.all_to_all(C.copy_to(buf, g).reshape(tp * cap, d), g)
    reids = C.all_to_all(eids.reshape(-1), g)
    rorder = torch.argsort(reids, stable=True)
    gs = _counts(reids, e_local)
    y = grouped_ffn(_ep_experts(p, cfg, lay), recv[rorder], gs,
                    cfg.mlp_kind)
    y = torch.zeros_like(y).index_put((rorder,), y)
    back = C.all_to_all(y.to(x.dtype), g).reshape(tp, cap, d)
    # each row's outputs came back to every model rank: each copy takes
    # its share of the experts' gradient
    back = C.scale_grad(back, 1.0 / tp)
    got = back[flat_dest, torch.where(keep, pos, torch.full_like(pos,
                                                                 cap - 1))]
    got = torch.where(keep[:, None], got, torch.zeros_like(got))
    rows = (got.float() * w.reshape(-1).float()[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):                   # in k order, as the reference adds
        out = out + rows[:, j]
    if "shared" in p:
        out = out + _shared_whole(p, x2, cfg, lay)
    load = _counts(ids.reshape(-1), m.num_experts).float()
    load, imp, tt = _batch_stats(lay, load, probs.sum(dim=0), t)
    out = lay.rep_out(out.reshape(bl, sl, d).to(x.dtype))
    return out, _aux(m, load, imp, tt)


def _ep_experts(p: dict, cfg: ModelConfig, lay: Layout) -> dict:
    """This model rank's experts, whole in F: the leaves made whole (F
    all-gathered over the model axis, its gradient reduce-scattered
    back), then the rank's ``num_experts / tp``."""
    q = _whole_experts(p, cfg, lay)
    lo, n = lay.chunk(cfg.moe.num_experts)
    for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        w = q[name]
        if lay.sharded(cfg.moe.d_ff_expert):
            w = C.all_gather(w, dim, lay.model_group)
        q[name] = w[lo:lo + n]
    return q
