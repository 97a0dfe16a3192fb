"""Feed-forward blocks (gated SwiGLU/GeGLU, plain, squared-ReLU) and
``SparseLinear``: the paper's RgCSR format as a weight store.

The PyTorch counterpart of ``repro.models.ffn``.  ``SparseLinear`` keeps a
pruned weight matrix ``W (d_out, d_in)`` in the RgCSR kernel plan's
slot-major layout — ``values2d (S, G)`` and the frozen ``columns2d (S, G)``,
``chunk_group``, ``chunk_first`` (one entry per 8 slot rows) — and computes
``y = x @ Wᵀ``:

- ``impl="kernel"``: through ``kernels.ops.rgcsr_spmm``, i.e. K2 — the CUDA
  kernel on a card, its plain PyTorch version for CPU tensors.  The module
  builds its :class:`~repro_torch.kernels.ops.RgCSRPlan` once (at load, by
  ``Engine``, or at first use) and keeps it; the plan is rebuilt only when
  the values tensor is replaced or written in place.  K2 skips slots that
  look like padding — value 0 at column 0 — so a weight that is exactly 0
  at column 0 is skipped too, which changes nothing while x is finite.
- ``impl="ref"``: an ``index_add_`` segment sum over the slot-major storage,
  the counterpart of the reference's ``segment_sum`` oracle, taken in
  chunks of slot rows by :class:`SegmentSum`, whose backward gives the
  gradients of the values and of ``x`` and which keeps only ``x``, the
  values and the structure for it.  Training runs this path, as the
  reference's ``launch/train.py --sparse-ffn`` does: K2 has no backward.

``ffn_apply_stacked`` is the MoE experts' FFN over expert-stacked weights:
batched matmuls in plain torch, as the reference computes these products
outside any Pallas kernel.

Tensor-parallel training (``models.shardlib.unit`` gives the FFN the mode
``split``): the input is copied in over ``model``, ``w_in`` and ``w_gate``
are column-parallel (this rank's ``d_ff / n`` columns), and ``w_out`` is
row-parallel with a reduce-out, or, stored in RgCSR, computes on its lane
slice (:meth:`SparseLinear.lanes`): ``values2d`` and ``columns2d``
``[:, r·G/n : (r+1)·G/n]``, whose rows are ``group·G + lane``; its input
is first gathered over ``model`` along ``d_ff`` and its rows gathered
back into row order.  Training takes the lanes through the segment sum
(``impl="ref"``); serving with ``impl="kernel"`` takes them through K2 on
a plan of the rank's lanes (:meth:`SparseLinear.lane_plan`: the same step
table, ``group_size`` G/n), which K2's 32-lane segments need a multiple
of 32.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_plain
from repro_torch.models import shardlib
from repro_torch.models.layers import Dense, ParamModule, dense_spec
from repro_torch.models.spec import P
from repro_torch.sharding import layout

__all__ = ["ffn_spec", "ffn_apply", "gated_ffn_apply", "ffn_apply_stacked",
           "sparse_linear_spec", "sparse_linear_init_mask",
           "sparse_linear_apply", "SparseLinear", "SegmentSum", "FFN"]

SUBLANES = 8
# elements of x gathered at once by SegmentSum (slot rows · G · T)
_GATHER_ELEMS = 1 << 26


def _activation(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":
        # the reference's jax.nn.gelu defaults to the tanh approximation
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":                      # Nemotron-4 squared ReLU
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def ffn_spec(cfg, d_ff: int | None = None):
    d = cfg.d_model
    d_ff = d_ff or cfg.d_ff
    spec = {
        "w_in": dense_spec(d, d_ff, ("embed", "mlp")),
    }
    if cfg.sparsity.enabled and "ffn" in cfg.sparsity.targets:
        # the paper's technique in the LM: the FFN down-projection weight
        # (d_model × d_ff) is stored in RgCSR with a frozen structure
        spec["w_out"] = sparse_linear_spec(cfg, d_ff, d)
    else:
        spec["w_out"] = dense_spec(d_ff, d, ("mlp", "embed"))
    if cfg.gated_ffn:
        spec["w_gate"] = dense_spec(d, d_ff, ("embed", "mlp"))
    return spec


def _ffn_out(layer: "FFN", h, tp):
    """``w_out`` of ``h``: whole, or on this rank's slice (``tp``)."""
    if tp is None:
        return layer.w_out(h)
    if isinstance(layer.w_out, SparseLinear):
        return layer.w_out.lanes(h, tp[0])
    return layer.w_out.row(h, tp[0])


def _ffn_in(layer: "FFN", x):
    """``(tp, x)``: x copied in when the FFN computes tensor-parallel."""
    tp = shardlib.unit(layer)
    if tp is not None:
        x = layout.copy_in(x, tp[0].mesh, tp[0].mesh_dim)
    return tp, x


def ffn_apply(layer: "FFN", cfg, x):
    act = _activation(cfg.activation)
    tp, x = _ffn_in(layer, x)
    h = layer.w_in(x)
    if layer.w_gate is not None:
        h = act(layer.w_gate(x)) * h
    else:
        h = act(h)
    return _ffn_out(layer, h, tp)


def gated_ffn_apply(layer: "FFN", cfg, x):
    """Shared-expert FFN on flat tokens (w_in/w_gate/w_out)."""
    act = _activation(cfg.activation)
    tp, x = _ffn_in(layer, x)
    return _ffn_out(layer, act(layer.w_gate(x)) * layer.w_in(x), tp)


def ffn_apply_stacked(layer: ParamModule, cfg, x):
    """Expert-stacked FFN: ``layer`` holds ``w_in``, ``w_gate`` (E, d, f)
    and ``w_out`` (E, f, d), used in x's dtype; x (E, C, d) -> (E, C, d)."""
    act = _activation(cfg.activation)
    h_in = torch.bmm(x, layer.cast("w_in", x.dtype))
    h_gate = torch.bmm(x, layer.cast("w_gate", x.dtype))
    return torch.bmm(act(h_gate) * h_in, layer.cast("w_out", x.dtype))


# ---------------------------------------------------------------------------
# SparseLinear — RgCSR weights
# ---------------------------------------------------------------------------


def _sparse_dims(cfg, d_in: int, d_out: int):
    """(G, n_groups, K): K slot rows per group, density·d_in rounded to
    whole 8-row chunks."""
    g = cfg.sparsity.group_size
    n_groups = -(-d_out // g)
    k = max(SUBLANES, int(round(cfg.sparsity.density * d_in)))
    return g, n_groups, -(-k // SUBLANES) * SUBLANES


def _chunk_tables(n_groups: int, k: int, device):
    """chunk_group / chunk_first: group g owns chunks [g·K/8, (g+1)·K/8)."""
    per = k // SUBLANES
    group = torch.arange(n_groups, dtype=torch.int32,
                         device=device).repeat_interleave(per)
    first = torch.zeros(n_groups * per, dtype=torch.int32, device=device)
    first[torch.arange(n_groups, device=device) * per] = 1
    return group, first


def sparse_linear_spec(cfg, d_in: int, d_out: int):
    """Parameter spec for an RgCSR-stored weight matrix W ∈ (d_out, d_in).

    Every group gets K = density·d_in slot rows (rounded to 8): static
    shapes.  The structure buffers' inits draw each lane's K sorted columns
    from the generator, so ``init_from_spec`` alone yields a valid layer.
    """
    g, n_groups, k = _sparse_dims(cfg, d_in, d_out)
    s_total = n_groups * k

    def init_columns(gen, shape, dtype, device):
        # random sorted column sets per (group, lane), slot-major
        scores = torch.rand((n_groups, g, d_in), generator=gen, device=device)
        cols = torch.argsort(scores, dim=-1)[..., :k]
        cols = torch.sort(cols, dim=-1).values.to(torch.int32)
        return cols.transpose(-1, -2).reshape(s_total, g).contiguous()

    def init_chunk_group(gen, shape, dtype, device):
        return _chunk_tables(n_groups, k, device)[0]

    def init_chunk_first(gen, shape, dtype, device):
        return _chunk_tables(n_groups, k, device)[1]

    n_chunks = s_total // SUBLANES
    return {
        "values2d": P((s_total, g), (None, "sparse_rows"), init="fan_in",
                      scale=(d_in / max(1, k)) ** 0.5),  # variance-corrected
        "columns2d": P((s_total, g), (None, "sparse_rows"),
                       init=init_columns, dtype=torch.int32),
        "chunk_group": P((n_chunks,), (None,), init=init_chunk_group,
                         dtype=torch.int32),
        "chunk_first": P((n_chunks,), (None,), init=init_chunk_first,
                         dtype=torch.int32),
    }


def sparse_linear_init_mask(seed: int, cfg, d_in: int, d_out: int,
                            device="cuda"):
    """The frozen structure buffers (columns2d, chunk_group, chunk_first),
    drawn on the host with numpy's generator from the integer ``seed``: the
    reference draws the same columns from the same integer."""
    g, n_groups, k = _sparse_dims(cfg, d_in, d_out)
    rng = np.random.default_rng(int(seed))
    cols = np.stack([
        np.sort(rng.choice(d_in, size=k, replace=False)).astype(np.int32)
        for _ in range(n_groups * g)
    ])                                                    # (n_groups*g, k)
    cols = cols.reshape(n_groups, g, k).transpose(0, 2, 1)  # slot-major
    columns2d = torch.from_numpy(
        np.ascontiguousarray(cols.reshape(n_groups * k, g))).to(device)
    return (columns2d, *_chunk_tables(n_groups, k, columns2d.device))


def _slot_chunks(chunk_group, g: int, n_slot_rows: int, t: int):
    """``(slot rows [a, b), output row of each of their entries)`` in
    chunks of at most ``_GATHER_ELEMS`` gathered elements, in order."""
    group_of_slotrow = chunk_group.long().repeat_interleave(SUBLANES)
    lanes = torch.arange(g, device=chunk_group.device)
    step = max(1, _GATHER_ELEMS // max(g * t, 1))
    for a in range(0, n_slot_rows, step):
        b = min(n_slot_rows, a + step)
        yield a, b, (group_of_slotrow[a:b, None] * g + lanes).reshape(-1)


class SegmentSum(torch.autograd.Function):
    """``Y[r] = Σ_{i: row(i) = r} values[i] · X[columns[i]]`` over the
    slot-major storage, ``Y`` of ``n_out`` rows: ``values2d (S, G)`` in the
    compute dtype, ``X = xt (d_in, T)``, ``columns2d (S, G)`` and
    ``chunk_group`` (one group per 8 slot rows) the frozen structure.

    It gathers ``X`` in chunks of slot rows, each summed into ``Y`` with
    ``index_add_`` in slot order (on the CPU the same sums in the same
    order as one whole gather).  It keeps ``values2d``, ``xt`` and the
    structure for the backward, which gathers again in chunks: the
    gradient of each value is its output row of ``dY`` times its gathered
    row of ``X``, and ``dX`` is the values times the gathered rows of
    ``dY``, summed into the columns.  Nothing ``(S·G, T)`` is kept, where
    autograd of the plain product would keep every gathered row."""

    @staticmethod
    def forward(ctx, values2d, xt, columns2d, chunk_group, n_out: int):
        ctx.save_for_backward(values2d, xt, columns2d, chunk_group)
        s, g = values2d.shape
        y = xt.new_zeros((n_out, xt.shape[1]))
        for a, b, rows in _slot_chunks(chunk_group, g, s, xt.shape[1]):
            vals = values2d[a:b].reshape(-1)
            y.index_add_(0, rows, vals[:, None]
                         * xt[columns2d[a:b].reshape(-1).long()])
        return y

    @staticmethod
    def backward(ctx, dy):
        values2d, xt, columns2d, chunk_group = ctx.saved_tensors
        s, g = values2d.shape
        want_v, want_x = ctx.needs_input_grad[:2]
        dv = torch.empty_like(values2d) if want_v else None
        dx = torch.zeros_like(xt) if want_x else None
        for a, b, rows in _slot_chunks(chunk_group, g, s, xt.shape[1]):
            cols = columns2d[a:b].reshape(-1).long()
            dyr = dy[rows]
            if want_v:
                dv[a:b] = (dyr * xt[cols]).sum(-1).reshape(b - a, g)
            if want_x:
                dx.index_add_(0, cols,
                              values2d[a:b].reshape(-1)[:, None] * dyr)
        return dv, dx, None, None, None


def sparse_linear_apply(params, cfg, x, d_out: int, *, plan=None):
    """y = x @ Wᵀ with W in RgCSR. x: (..., d_in) -> (..., d_out).

    ``params`` maps ``values2d``/``columns2d``/``chunk_group``/
    ``chunk_first`` to tensors.  With ``impl="kernel"``, ``plan`` is the
    kept plan (:class:`SparseLinear` passes its own); without one a plan is
    built for this call.  K2 reads X as a contiguous ``(d_in, T)``: the
    transposed view below is copied once, by ``ops.rgcsr_spmm``.
    """
    g = cfg.sparsity.group_size
    lead = x.shape[:-1]
    d_in = x.shape[-1]
    xt = x.reshape(-1, d_in).T                            # (d_in, T)
    n_groups = -(-d_out // g)
    if cfg.sparsity.impl_is_kernel():
        if plan is None:
            plan = ops.plan_from_params(params, x.dtype, d_out=d_out,
                                        d_in=d_in, group_size=g)
        y = ops.rgcsr_spmm(plan, xt)                      # (d_out, T)
    else:
        y = SegmentSum.apply(params["values2d"].to(x.dtype), xt,
                             params["columns2d"], params["chunk_group"],
                             n_groups * g)
    return y[:d_out].T.reshape(*lead, d_out)


class SparseLinear(ParamModule):
    """One RgCSR-stored weight: ``values2d`` a parameter, ``columns2d``,
    ``chunk_group`` and ``chunk_first`` buffers, and the kernel plan kept
    per compute dtype (``plan_builds`` counts the plans built)."""

    def __init__(self, params, cfg, *, d_in: int, d_out: int):
        super().__init__(params)
        self.cfg, self.d_in, self.d_out = cfg, d_in, d_out
        self._plans = {}
        self._lane_plans = {}
        self.plan_builds = 0

    def plan_for(self, dtype) -> "ops.RgCSRPlan":
        """The K2 plan at compute dtype ``dtype``, built at the first call
        and kept until ``values2d`` is replaced or written in place."""
        src = self.values2d
        version = 0 if src.is_inference() else src._version
        hit = self._plans.get(dtype)
        if hit is not None and hit[0] is src and hit[1] == version:
            return hit[2]
        values = self.cast("values2d", dtype)
        plan = ops.plan_from_params(
            {"values2d": values, "columns2d": self.columns2d,
             "chunk_group": self.chunk_group,
             "chunk_first": self.chunk_first}, dtype,
            d_out=self.d_out, d_in=self.d_in,
            group_size=self.cfg.sparsity.group_size)
        self._plans[dtype] = (src, version, plan)
        self.plan_builds += 1
        return plan

    def lane_plan(self, dtype, view) -> "ops.RgCSRPlan":
        """The K2 plan of this rank's lanes at compute dtype ``dtype``:
        ``values2d``/``columns2d`` bound to the lane slice ``(S, G/n)``,
        the module's step table, ``group_size`` G/n, rows ``(group, local
        lane)``.  One per (dtype, view size, rank), built at the first
        call and kept while the bound slice's storage and version stay
        (``plan_builds`` counts it)."""
        src = self.values2d
        lanes = src.shape[1]
        if lanes % ops.SEGMENT:
            raise ValueError(
                f"K2 on a rank's lanes: G/n = {lanes} lanes (G = "
                f"{self.cfg.sparsity.group_size} over {view.size} model "
                f"ranks) is not a multiple of K2's {ops.SEGMENT}-lane "
                f"segment")
        key = (dtype, view.size, view.rank)
        stamp = (src.data_ptr(), tuple(src.shape),
                 0 if src.is_inference() else src._version)
        hit = self._lane_plans.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        n_groups = -(-self.d_out // self.cfg.sparsity.group_size)
        plan = ops.plan_from_params(
            {"values2d": self.cast("values2d", dtype).contiguous(),
             "columns2d": self.columns2d.contiguous(),
             "chunk_group": self.chunk_group,
             "chunk_first": self.chunk_first}, dtype,
            d_out=n_groups * lanes, d_in=self.d_in, group_size=lanes)
        self._lane_plans[key] = (stamp, plan)
        self.plan_builds += 1
        return plan

    def forward(self, x):
        if self.cfg.sparsity.impl_is_kernel() and torch.is_grad_enabled() \
                and self.values2d.requires_grad:
            raise NotImplementedError(
                "K2 has no backward: train a SparseLinear with "
                "impl='ref', as the reference's launch/train.py does")
        params = {"values2d": self.cast("values2d", x.dtype),
                  "columns2d": self.columns2d,
                  "chunk_group": self.chunk_group,
                  "chunk_first": self.chunk_first}
        plan = (self.plan_for(x.dtype)
                if self.cfg.sparsity.impl_is_kernel() else None)
        return sparse_linear_apply(params, self.cfg, x, self.d_out,
                                   plan=plan)

    def lanes(self, h, view):
        """Tensor-parallel ``y = x @ Wᵀ`` with ``values2d`` and
        ``columns2d`` bound to this rank's lanes ``[r·G/n, (r+1)·G/n)``:
        ``h`` (``(..., d_in / n)``, this rank's slice) is gathered along
        ``d_in`` (its gradient reduce-scattered: each rank's lanes read
        every column), the segment sum gives the rank's rows ``group·G +
        lane`` in ``(group, local lane)`` order, and the ranks' rows are
        gathered and put back into row order: ``(..., d_out)`` on every
        rank.  ``impl="ref"``: the segment sum (training's: K2 has no
        backward); ``impl="kernel"``: K2 on :meth:`lane_plan` (a meta
        tensor — the dry run's shapes — takes K2's plain version on the
        arrays, which needs no plan)."""
        kernel = self.cfg.sparsity.impl_is_kernel()
        if kernel and torch.is_grad_enabled() and self.values2d.requires_grad:
            raise NotImplementedError(
                "K2 has no backward: train tensor-parallel lanes with "
                "impl='ref'")
        mesh, md, n = view.mesh, view.mesh_dim, view.size
        x = layout.gather_dim(h, -1, mesh, md, grad="sum")
        lead = x.shape[:-1]
        xt = x.reshape(-1, self.d_in).T                   # (d_in, T)
        lanes = self.values2d.shape[1]
        n_groups = -(-self.d_out // self.cfg.sparsity.group_size)
        if kernel and x.is_meta:
            if lanes % ops.SEGMENT:
                self.lane_plan(x.dtype, view)             # raises
            y = rgcsr_spmm_plain(self.cast("values2d", x.dtype),
                                 self.columns2d, self.chunk_group,
                                 xt.contiguous(), n_groups=n_groups)
        elif kernel:
            y = ops.rgcsr_spmm(self.lane_plan(x.dtype, view), xt)
        else:
            y = SegmentSum.apply(self.cast("values2d", x.dtype), xt,
                                 self.columns2d, self.chunk_group,
                                 n_groups * lanes)        # (rows / n, T)
        y = layout.gather_dim(y.T, -1, mesh, md)          # rank-major
        y = y.reshape(-1, n, n_groups, lanes).transpose(1, 2)
        return y.reshape(-1, n * n_groups * lanes)[:, :self.d_out] \
            .reshape(*lead, self.d_out)


class FFN(nn.Module):
    """``w_in``, optional ``w_gate`` (Dense) and ``w_out``: a Dense, or a
    :class:`SparseLinear` when the subtree holds RgCSR arrays."""

    def __init__(self, params, cfg):
        super().__init__()
        self.w_in = Dense(params["w_in"])
        self.w_gate = Dense(params["w_gate"]) if "w_gate" in params else None
        if "values2d" in params["w_out"]:
            d_ff = params["w_in"]["kernel"].shape[1]
            self.w_out = SparseLinear(params["w_out"], cfg, d_in=d_ff,
                                      d_out=cfg.d_model)
        else:
            self.w_out = Dense(params["w_out"])
