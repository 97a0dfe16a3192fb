"""Recurrent sequence mixers: Mamba-2 (SSD) and RG-LRU (Griffin /
RecurrentGemma).

The PyTorch counterpart of ``repro.models.recurrent``.  Both mixers keep a
decode state that is O(1) in sequence length: a conv tail of the last
``d_conv - 1`` (Mamba-2) or 3 (RG-LRU) raw inputs, in ``cfg.dtype``, plus
a float32 SSM state ``(B, H, P, N)`` or LRU state ``(B, d)``.

* Mamba-2 runs the SSD chunked algorithm [arXiv:2405.21060]: quadratic
  attention-like products inside each chunk of ``cfg.ssm.chunk`` tokens
  and a recurrence over the chunks' states (a loop over the
  ``ceil(L / chunk)`` chunks), all in float32 as the reference's.
* RG-LRU follows Griffin [arXiv:2402.19427]:
  ``h_t = a_t·h_{t-1} + sqrt(1 - a_t²)·(i_t ⊙ x_t)`` with
  ``a_t = exp(-8·softplus(Λ)·r_t)``; the full-sequence path runs the
  recurrence as a log-depth (Hillis–Steele) scan over time in
  ``ceil(log2 L)`` rounds of elementwise products, where the reference
  calls ``lax.associative_scan``.

One change from the reference: with ``return_state=True`` a prompt
shorter than the conv tail hands on a tail of full length, right-aligned
with zeros before the prompt — the causal conv's own zero padding, which
is what the decode step's window needs.  The reference's slice hands on a
shorter tail there, which its decode step cannot take.

The modules (:class:`Mamba2`, :class:`RGLRU`) hold one layer's parameters
in the tree's names (``in_proj``, ``conv``, ``dt_bias``, ...); the
functions do the arithmetic.  Weights are used in the compute dtype
through :meth:`~repro_torch.models.layers.ParamModule.cast`; the 1-D
recurrence parameters are read in float32 (float64 inputs stay float64:
an exact reference run of the same code).

Tensor-parallel training (``models.shardlib.unit`` gives a mixer the
mode ``split``; the step binds each cut leaf's ``model`` slice, and the
replicated ``dt_bias``, ``a_log``, ``d_skip`` and ``out_norm`` scale
whole, of which a rank reads its heads' part):

* Mamba-2 splits its SSD heads: rank ``r`` of ``n`` runs heads
  ``[r·H/n, (r+1)·H/n)``.  Its ``in_proj`` columns (a contiguous cut of
  z | x | B | C | dt) line up with neither its heads nor its conv
  channels, so their column-parallel product is gathered whole over
  ``model``; the rank convolves its own ``conv_ch`` slice of xBC, and
  the conv's output is gathered again (both gathers reduce-scatter their
  gradient: each rank reads its own columns of the whole).  The rank
  then takes its heads' z, x and dt and the whole B and C; the gated
  norm sums its squares over the ranks (``d_inner`` is split), and
  ``out_proj`` is row-parallel.
* RG-LRU splits its ``d_rnn`` channels: ``gate_proj``, ``x_proj``, the
  conv, ``lam`` and ``out_proj``'s rows are cut alike, so the conv, the
  gates' elementwise work and the scan run on the rank's channels.
  ``rg_w`` and ``in_w`` hold the rank's rows of every column: their
  products are partial sums over every channel, reduce-scattered to the
  rank's channels together, in one collective (its backward
  all-gathers).

Serving on a mesh (the same split with a state: a prefill's
``return_state`` and the decode steps): the state is this rank's slice
in the layout of ``Partitioner.cache_shardings`` — Mamba-2's ``conv``
tail its ``conv_ch`` channels and ``ssm`` its heads, RG-LRU's ``conv``
and ``h`` its ``d_rnn`` channels.  A rank convolves its own channels
with its own tail (a decode step gathers the conv's products to the
rank's heads, as training does) and updates its heads' or channels'
state; the step returns the next state and never writes the given one.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import shardlib
from repro_torch.models.layers import (Dense, ParamModule, RMSNorm,
                                       at_least_f32, dense_spec,
                                       rmsnorm_spec)
from repro_torch.models.shardlib import constrain
from repro_torch.models.spec import P
from repro_torch.sharding import layout

__all__ = [
    "mamba2_spec", "mamba2_apply", "init_mamba2_state", "mamba2_decode",
    "rglru_spec", "rglru_apply", "init_rglru_state", "rglru_decode",
    "Mamba2", "RGLRU", "STATE_KEYS",
]

# the cache keys of a recurrent layer's state
STATE_KEYS = ("conv", "ssm", "h")


def _gelu(x):
    # the reference's jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# causal depthwise conv1d (shared by both mixers)
# ---------------------------------------------------------------------------


def _conv_spec(channels: int, width: int):
    return {"w": P((width, channels), (None, "conv_ch"), init="fan_in"),
            "b": P((channels,), ("conv_ch",), init="zeros")}


def _causal_conv(w, b, x):
    """x: (B, L, C) depthwise causal conv; w: (W, C), b: (C,)."""
    w = w.to(x.dtype)
    width, seq = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i: i + seq, :] * w[i] for i in range(width))
    return out + b.to(x.dtype)


def _conv_step(w, b, state, x_t):
    """state: (B, W-1, C); x_t: (B, C) -> (y_t, new_state)."""
    w = w.to(x_t.dtype)
    hist = torch.cat([state, x_t[:, None, :]], dim=1)
    y = (hist * w).sum(1) + b.to(x_t.dtype)
    return y, hist[:, 1:, :]


def _conv_tail(raw, width: int, dtype):
    """The last ``width`` rows of ``raw`` (B, L, C), right-aligned, zeros
    before the first row when L < width."""
    short = width - raw.shape[1]
    if short > 0:
        raw = F.pad(raw, (0, 0, short, 0))
    return raw[:, raw.shape[1] - width:, :].to(dtype)


class _Conv(ParamModule):
    """A depthwise causal conv: ``w`` (W, C) and ``b`` (C,)."""

    def weights(self, dtype):
        return self.cast("w", dtype), self.cast("b", dtype)


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------


def _mamba_dims(cfg):
    d_inner = cfg.ssm.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm.head_dim
    d_xbc = d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return d_inner, n_heads, d_xbc


def _init_a_log(gen, shape, dtype, device):
    # log(1..16) spaced over the heads of each layer
    n = shape[-1]
    a = torch.log(torch.linspace(1.0, 16.0, n, device=device))
    return a.expand(shape).to(dtype).clone()


def mamba2_spec(cfg):
    d = cfg.d_model
    d_inner, n_heads, d_xbc = _mamba_dims(cfg)
    return {
        "in_proj": dense_spec(d, 2 * d_inner + 2 * cfg.ssm.n_groups
                              * cfg.ssm.d_state + n_heads, ("embed", "mlp")),
        "conv": _conv_spec(d_xbc, cfg.ssm.d_conv),
        "dt_bias": P((n_heads,), ("ssm_heads",), init="zeros"),
        "a_log": P((n_heads,), ("ssm_heads",), init=_init_a_log),
        "d_skip": P((n_heads,), ("ssm_heads",), init="ones"),
        "out_norm": rmsnorm_spec(d_inner),
        "out_proj": dense_spec(d_inner, d, ("mlp", "embed")),
    }


def _segsum(x):
    """Stable segment sum: out[..., i, j] = sum_{j<k<=i} x[..., k] (i>=j),
    -inf above the diagonal."""
    t = x.shape[-1]
    x_cum = torch.cumsum(x, dim=-1)
    diff = x_cum[..., :, None] - x_cum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, float("-inf"))


def _ssd_chunked(x, dt, a, b, c, chunk: int):
    """SSD forward.  x: (B,L,H,P) dt: (B,L,H) a: (H,) b,c: (B,L,G,N).

    Returns y: (B,L,H,P) and the final state (B,H,P,N).
    """
    bsz, l_orig, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    # pad to a chunk multiple: dt = 0 padding is exact (decay 1, input 0 —
    # the state passes through unchanged)
    pad = (-l_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    l = l_orig + pad
    nc = l // chunk
    rep = h // g

    def chunks(t):                  # (B, L, ...) -> (B, nc, chunk, ...)
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)
    bc = chunks(b).repeat_interleave(rep, dim=3)     # (B,nc,Q,H,N)
    cc = chunks(c).repeat_interleave(rep, dim=3)
    da = dtc * a                                     # (B,nc,Q,H) negative
    da_cs = torch.cumsum(da, dim=2)                  # within-chunk cumsum
    da_total = da_cs[:, :, -1, :]                    # (B,nc,H)

    # intra-chunk (quadratic inside the chunk only)
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))         # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)       # (B,nc,H,Q,Q)
    weights = scores * lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", weights, xc)

    # per-chunk input states
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cs)  # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          bc * (decay_to_end * dtc)[..., None], xc)

    # inter-chunk recurrence over the nc chunks
    h_prev = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    prevs = []
    for ci in range(nc):
        prevs.append(h_prev)
        h_prev = torch.exp(da_total[:, ci])[..., None, None] * h_prev \
            + states[:, ci]
    h_prevs = torch.stack(prevs, dim=1)                        # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           cc * torch.exp(da_cs)[..., None], h_prevs)
    y = (y_intra + y_inter).reshape(bsz, l, h, p)[:, :l_orig]
    return y, h_prev


def _mamba_gates(layer: "Mamba2", cfg, dt_raw, heads=slice(None)):
    dt = F.softplus(at_least_f32(dt_raw)
                    + at_least_f32(layer.dt_bias)[heads])
    a = -torch.exp(at_least_f32(layer.a_log)[heads])
    return dt, a


def _parallel(layer, with_state: bool):
    """``(view, mode)`` of a mixer computing tensor-parallel, or None; one
    that keeps a state runs in a serving step on a mesh."""
    tp = shardlib.unit(layer)
    if tp is not None and with_state and shardlib.cache_layout(layer) is None:
        raise ValueError("a tensor-parallel mixer with a state runs in a "
                         "serving step on a mesh "
                         "(launch.steps.make_prefill_step / make_decode_step "
                         "with partitioner=)")
    return tp


def mamba2_apply(layer: "Mamba2", cfg, x, *, return_state: bool = False):
    """Full-sequence Mamba-2 mixer.  x: (B, L, d) -> (B, L, d); with
    ``return_state`` also the end-of-sequence state (conv tail + SSM
    state) for the decode steps.  Tensor-parallel on this rank's heads
    (the module's note)."""
    tp = _parallel(layer, return_state)
    if tp is not None:
        return _mamba2_split(layer, cfg, x, tp[0], return_state)
    bsz, l, _ = x.shape
    d_inner, n_heads, d_xbc = _mamba_dims(cfg)
    ssm = cfg.ssm
    n_bc = ssm.n_groups * ssm.d_state

    zxbcdt = layer.in_proj(x)
    z = zxbcdt[..., :d_inner]
    xbc_raw = zxbcdt[..., d_inner: d_inner + d_xbc]
    dt_raw = zxbcdt[..., d_inner + d_xbc:]

    xbc = F.silu(_causal_conv(*layer.conv.weights(x.dtype), xbc_raw))
    xs = xbc[..., :d_inner].reshape(bsz, l, n_heads, ssm.head_dim)
    b = xbc[..., d_inner: d_inner + n_bc].reshape(bsz, l, ssm.n_groups,
                                                   ssm.d_state)
    c = xbc[..., d_inner + n_bc:].reshape(bsz, l, ssm.n_groups, ssm.d_state)
    # the SSD heads over TP, as the reference hints them
    if n_heads % 8 == 0:
        xs = constrain(cfg, xs, "batch", None, "model", None)
    dt, a = _mamba_gates(layer, cfg, dt_raw)

    xs32 = at_least_f32(xs)
    y, h_last = _ssd_chunked(xs32, dt, a, at_least_f32(b),
                             at_least_f32(c), ssm.chunk)
    y = y + at_least_f32(layer.d_skip)[None, None, :, None] * xs32
    y = y.reshape(bsz, l, d_inner).to(x.dtype)
    y = layer.out_norm(y * F.silu(z))
    out = layer.out_proj(y)
    if return_state:
        tail = _conv_tail(xbc_raw, ssm.d_conv - 1, getattr(torch, cfg.dtype))
        return out, {"conv": tail, "ssm": h_last}
    return out


def _mamba2_split(layer: "Mamba2", cfg, x, view, return_state=False):
    """:func:`mamba2_apply` on ``view``'s rank's heads (the module's
    note): ``x`` replicated along ``model``, the output the whole
    ``(B, L, d)`` on every rank; with ``return_state`` also the rank's
    slice of the end state (its conv channels' tail, its heads' SSM
    state)."""
    bsz, l, _ = x.shape
    d_inner, n_heads, d_xbc = _mamba_dims(cfg)
    ssm = cfg.ssm
    n_bc = ssm.n_groups * ssm.d_state
    mesh, md, n, r = view.mesh, view.mesh_dim, view.size, view.rank
    heads = slice(r * n_heads // n, (r + 1) * n_heads // n)
    cols = slice(heads.start * ssm.head_dim, heads.stop * ssm.head_dim)
    ch = d_xbc // n

    zxbcdt = layout.gather_dim(layer.in_proj.column(x, view), -1, mesh, md,
                               grad="sum")
    z = zxbcdt[..., cols]
    xbc_raw = zxbcdt[..., d_inner + r * ch: d_inner + (r + 1) * ch]
    dt_raw = zxbcdt[..., d_inner + d_xbc:][..., heads]

    xbc = F.silu(_causal_conv(*layer.conv.weights(x.dtype), xbc_raw))
    xbc = layout.gather_dim(xbc, -1, mesh, md, grad="sum")
    xs = xbc[..., cols].reshape(bsz, l, -1, ssm.head_dim)
    b = xbc[..., d_inner: d_inner + n_bc].reshape(bsz, l, ssm.n_groups,
                                                   ssm.d_state)
    c = xbc[..., d_inner + n_bc:].reshape(bsz, l, ssm.n_groups, ssm.d_state)
    if ssm.n_groups > 1:        # each of the rank's heads with its group
        rep = n_heads // ssm.n_groups
        b = b.repeat_interleave(rep, dim=2)[:, :, heads]
        c = c.repeat_interleave(rep, dim=2)[:, :, heads]
    dt, a = _mamba_gates(layer, cfg, dt_raw, heads)

    xs32 = at_least_f32(xs)
    y, h_last = _ssd_chunked(xs32, dt, a, at_least_f32(b), at_least_f32(c),
                             ssm.chunk)
    y = y + at_least_f32(layer.d_skip)[heads][None, None, :, None] * xs32
    y = y.reshape(bsz, l, -1).to(x.dtype)
    y = layer.out_norm.split(y * F.silu(z), view, cols, d_inner)
    out = layer.out_proj.row(y, view)
    if return_state:
        tail = _conv_tail(xbc_raw, ssm.d_conv - 1, getattr(torch, cfg.dtype))
        return out, {"conv": tail, "ssm": h_last}
    return out


def _mamba2_decode_split(layer: "Mamba2", cfg, state, x_t, view):
    """:func:`mamba2_decode` on ``view``'s rank's heads with its slice of
    the state (the module's note)."""
    bsz = x_t.shape[0]
    d_inner, n_heads, d_xbc = _mamba_dims(cfg)
    ssm = cfg.ssm
    n_bc = ssm.n_groups * ssm.d_state
    mesh, md, n, r = view.mesh, view.mesh_dim, view.size, view.rank
    heads = slice(r * n_heads // n, (r + 1) * n_heads // n)
    cols = slice(heads.start * ssm.head_dim, heads.stop * ssm.head_dim)
    ch = d_xbc // n
    zxbcdt = layout.gather_dim(layer.in_proj.column(x_t, view), -1, mesh,
                               md)
    z = zxbcdt[..., cols]
    xbc = zxbcdt[..., d_inner + r * ch: d_inner + (r + 1) * ch]
    dt_raw = zxbcdt[..., d_inner + d_xbc:][..., heads]
    xbc, conv_state = _conv_step(*layer.conv.weights(x_t.dtype),
                                 state["conv"], xbc)
    xbc = layout.gather_dim(F.silu(xbc), -1, mesh, md)
    xs = xbc[..., cols].reshape(bsz, -1, ssm.head_dim)
    rep = n_heads // ssm.n_groups
    b = xbc[..., d_inner: d_inner + n_bc].reshape(
        bsz, ssm.n_groups, ssm.d_state).repeat_interleave(rep, dim=1)[:, heads]
    c = xbc[..., d_inner + n_bc:].reshape(
        bsz, ssm.n_groups, ssm.d_state).repeat_interleave(rep, dim=1)[:, heads]
    dt, a = _mamba_gates(layer, cfg, dt_raw, heads)
    da = torch.exp(dt * a)
    xs32 = at_least_f32(xs)
    h = da[..., None, None] * state["ssm"] \
        + (dt[..., None] * xs32)[..., None] * at_least_f32(b)[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", at_least_f32(c), h)
    y = y + at_least_f32(layer.d_skip)[heads][None, :, None] * xs32
    y = y.reshape(bsz, -1).to(x_t.dtype)
    y = layer.out_norm.split(y * F.silu(z), view, cols, d_inner)
    return layer.out_proj.row(y, view), {"conv": conv_state, "ssm": h}


def init_mamba2_state(cfg, batch: int,
                      device="cuda") -> Dict[str, torch.Tensor]:
    d_inner, n_heads, d_xbc = _mamba_dims(cfg)
    ssm = cfg.ssm
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, d_xbc),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "ssm": torch.zeros((batch, n_heads, ssm.head_dim, ssm.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(layer: "Mamba2", cfg, state, x_t):
    """One-token step.  x_t: (B, d) -> (y_t, new state); O(1) in the
    sequence.  The state is read, never written: the new one is returned.
    On a mesh, the rank's heads (the module's note)."""
    tp = _parallel(layer, True)
    if tp is not None:
        return _mamba2_decode_split(layer, cfg, state, x_t, tp[0])
    bsz = x_t.shape[0]
    d_inner, n_heads, d_xbc = _mamba_dims(cfg)
    ssm = cfg.ssm
    n_bc = ssm.n_groups * ssm.d_state

    zxbcdt = layer.in_proj(x_t)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: d_inner + d_xbc]
    dt_raw = zxbcdt[..., d_inner + d_xbc:]

    xbc, conv_state = _conv_step(*layer.conv.weights(x_t.dtype),
                                 state["conv"], xbc)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(bsz, n_heads, ssm.head_dim)
    rep = n_heads // ssm.n_groups
    b = xbc[..., d_inner: d_inner + n_bc].reshape(
        bsz, ssm.n_groups, ssm.d_state).repeat_interleave(rep, dim=1)
    c = xbc[..., d_inner + n_bc:].reshape(
        bsz, ssm.n_groups, ssm.d_state).repeat_interleave(rep, dim=1)
    dt, a = _mamba_gates(layer, cfg, dt_raw)                  # (B,H), (H,)
    da = torch.exp(dt * a)

    xs32 = at_least_f32(xs)
    h = da[..., None, None] * state["ssm"] \
        + (dt[..., None] * xs32)[..., None] \
        * at_least_f32(b)[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", at_least_f32(c), h)
    y = y + at_least_f32(layer.d_skip)[None, :, None] * xs32
    y = y.reshape(bsz, d_inner).to(x_t.dtype)
    y = layer.out_norm(y * F.silu(z))
    return layer.out_proj(y), {"conv": conv_state, "ssm": h}


class Mamba2(ParamModule):
    """One Mamba-2 mixer: ``dt_bias``, ``a_log``, ``d_skip`` (H,) and the
    ``in_proj``, ``conv``, ``out_norm`` and ``out_proj`` submodules."""

    def __init__(self, params):
        super().__init__({k: params[k] for k in ("dt_bias", "a_log",
                                                 "d_skip")})
        self.in_proj = Dense(params["in_proj"])
        self.conv = _Conv(params["conv"])
        self.out_norm = RMSNorm(params["out_norm"])
        self.out_proj = Dense(params["out_proj"])


# ---------------------------------------------------------------------------
# RG-LRU (Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_RGLRU_CONV = 4


def _init_lam(gen, shape, dtype, device):
    # Griffin: a in [0.9, 0.999] at r = 1 → Λ = softplus⁻¹(-log a / c),
    # spaced over the channels of each layer
    a = torch.linspace(0.9, 0.999, shape[-1], device=device)
    lam = torch.log(torch.expm1(-torch.log(a) / _RGLRU_C))
    return lam.expand(shape).to(dtype).clone()


def rglru_spec(cfg):
    d = cfg.d_model
    d_rnn = d  # RecurrentGemma: lru width == d_model
    return {
        "gate_proj": dense_spec(d, d_rnn, ("embed", "mlp")),
        "x_proj": dense_spec(d, d_rnn, ("embed", "mlp")),
        "conv": _conv_spec(d_rnn, _RGLRU_CONV),
        "rg_w": dense_spec(d_rnn, d_rnn, ("mlp", "mlp2")),   # recurrence gate
        "in_w": dense_spec(d_rnn, d_rnn, ("mlp", "mlp2")),   # input gate
        "lam": P((d_rnn,), ("mlp",), init=_init_lam),
        "out_proj": dense_spec(d_rnn, d, ("mlp", "embed")),
    }


def _rglru_scan(a, b, h0: Optional[torch.Tensor] = None):
    """h_t = a_t·h_{t-1} + b_t over axis 1, as a Hillis–Steele scan: round
    k combines each position with the one 2^k before it, (a1, b1) then
    (a2, b2) → (a1·a2, a2·b1 + b2), in ceil(log2 L) rounds."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    seq, shift = a.shape[1], 1
    while shift < seq:
        b = torch.cat([b[:, :shift],
                       a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def _rglru_gates(layer: "RGLRU", u, pre=None):
    """(a, the gated input) in float32 from the conv output ``u``;
    ``pre``: the two gates' pre-activations stacked, when given."""
    rg, inp = (layer.rg_w(u), layer.in_w(u)) if pre is None else pre
    r = torch.sigmoid(at_least_f32(rg))
    i = torch.sigmoid(at_least_f32(inp))
    a = torch.exp(-_RGLRU_C * F.softplus(at_least_f32(layer.lam)) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-6)) \
        * (i * at_least_f32(u))
    return a, gated


def rglru_apply(layer: "RGLRU", cfg, x, *, return_state: bool = False):
    """Griffin recurrent block over the full sequence.  x: (B, L, d).
    Tensor-parallel on this rank's channels (the module's note)."""
    tp = _parallel(layer, return_state)
    if tp is not None:
        return _rglru_split(layer, cfg, x, tp[0], return_state)
    gate = _gelu(layer.gate_proj(x))
    u_raw = layer.x_proj(x)
    u = _causal_conv(*layer.conv.weights(x.dtype), u_raw)
    a, gated = _rglru_gates(layer, u)
    h = _rglru_scan(a, gated)
    out = layer.out_proj(h.to(x.dtype) * gate)
    if return_state:
        tail = _conv_tail(u_raw, _RGLRU_CONV - 1, getattr(torch, cfg.dtype))
        return out, {"conv": tail, "h": h[:, -1, :]}
    return out


def _rglru_split(layer: "RGLRU", cfg, x, view, return_state=False):
    """:func:`rglru_apply` on ``view``'s rank's ``d_rnn / n`` channels
    (the module's note): ``x`` replicated along ``model``, the output the
    whole ``(B, L, d)`` on every rank; with ``return_state`` also the
    rank's channels of the end state."""
    mesh, md = view.mesh, view.mesh_dim
    x = layout.copy_in(x, mesh, md)
    gate = _gelu(layer.gate_proj(x))
    u_raw = layer.x_proj(x)
    u = _causal_conv(*layer.conv.weights(x.dtype), u_raw)
    pre = layout.reduce_scatter_dim(torch.stack([layer.rg_w(u),
                                                 layer.in_w(u)]), -1,
                                    mesh, md)
    a, gated = _rglru_gates(layer, u, pre)
    h = _rglru_scan(a, gated)
    out = layer.out_proj.row(h.to(x.dtype) * gate, view)
    if return_state:
        tail = _conv_tail(u_raw, _RGLRU_CONV - 1, getattr(torch, cfg.dtype))
        return out, {"conv": tail, "h": h[:, -1, :]}
    return out


def init_rglru_state(cfg, batch: int,
                     device="cuda") -> Dict[str, torch.Tensor]:
    d_rnn = cfg.d_model
    return {
        "conv": torch.zeros((batch, _RGLRU_CONV - 1, d_rnn),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
    }


def rglru_decode(layer: "RGLRU", cfg, state, x_t):
    """One-token step.  x_t: (B, d) -> (y_t, new state).  On a mesh, the
    rank's channels (the module's note)."""
    tp = _parallel(layer, True)
    if tp is not None:
        x_t = layout.copy_in(x_t, tp[0].mesh, tp[0].mesh_dim)
    gate = _gelu(layer.gate_proj(x_t))
    u = layer.x_proj(x_t)
    u, conv_state = _conv_step(*layer.conv.weights(x_t.dtype), state["conv"],
                               u)
    pre = None
    if tp is not None:
        pre = layout.reduce_scatter_dim(torch.stack([layer.rg_w(u),
                                                     layer.in_w(u)]), -1,
                                        tp[0].mesh, tp[0].mesh_dim)
    a, gated = _rglru_gates(layer, u, pre)
    h = a * state["h"] + gated
    y = h.to(x_t.dtype) * gate
    y = layer.out_proj(y) if tp is None else layer.out_proj.row(y, tp[0])
    return y, {"conv": conv_state, "h": h}


class RGLRU(ParamModule):
    """One RG-LRU block: ``lam`` (d,) and the ``gate_proj``, ``x_proj``,
    ``conv``, ``rg_w``, ``in_w`` and ``out_proj`` submodules."""

    def __init__(self, params):
        super().__init__({"lam": params["lam"]})
        for name in ("gate_proj", "x_proj", "rg_w", "in_w", "out_proj"):
            setattr(self, name, Dense(params[name]))
        self.conv = _Conv(params["conv"])
