"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both packages; results
and arrays come back to numpy for comparison.
"""
import dataclasses

import numpy as np
import torch


def rand_sparse(seed, n, m, density):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(n, m)) < density).astype(np.float32)
    a *= rng.uniform(0.5, 1.5, size=(n, m)).astype(np.float32)
    return a


def skewed(seed, n=300, m=280):
    """A few near-dense rows over a sparse background (Table 6 pathology)."""
    a = rand_sparse(seed, n, m, 0.02)
    rng = np.random.default_rng(seed + 1)
    for r in rng.choice(n, size=3, replace=False):
        cols = rng.choice(m, size=int(0.7 * m), replace=False)
        a[r, cols] = rng.uniform(0.5, 1.5, size=len(cols)).astype(np.float32)
    return a


def ell_counts_csr(seed, k_max, n_segments):
    """CSR arrays ``(values, columns, row_ptr, shape)`` of a square matrix
    whose 32-row segments hold, in turn, every live-slot count from 0 to
    ``k_max`` — rows of random lengths up to the segment's count, one row
    of exactly that length — and the counts, one per segment."""
    rng = np.random.default_rng(seed)
    n = n_segments * 32
    counts = np.arange(n_segments) % (k_max + 1)
    lens = rng.integers(0, np.repeat(counts, 32) + 1)
    lens[np.arange(n_segments) * 32 + rng.integers(0, 32, n_segments)] = counts
    row_ptr = np.concatenate([[0], np.cumsum(lens)])
    slot = np.arange(row_ptr[-1]) - np.repeat(row_ptr[:-1], lens)
    step = n // (k_max + 1)     # slot s of a row in [s·step, (s + 1)·step)
    columns = (slot * step + rng.integers(0, step, len(slot))).astype(np.int32)
    values = rng.standard_normal(len(slot)).astype(np.float32)
    return (values, columns, row_ptr, (n, n)), counts


def paged_case(seed, lengths, hkv, group, dim, page_size=16, pages=4,
               store=torch.float32, value=torch.float32, device="cpu"):
    """A paged decode attention input: pools ``(n_pages, page_size, hkv,
    dim)`` of ``store``, a block table of ``pages`` columns and the
    ``index`` of each slot, and a roped query ``(B, 1, hkv·group, dim)``
    of ``value``.  ``lengths[b]`` is slot b's index + 1 (past
    ``pages · page_size``: an index that ran past the table); ``None`` is
    a free slot, its table on the null page 0 at index 0 — ``0`` the same
    slot with an index that has grown (free slots keep decoding).  Live
    slots own distinct random pages, whole tables."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n_pages = 1 + b * pages
    shape = (n_pages, page_size, hkv, dim)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    table = (1 + rng.permutation(b * pages)).reshape(b, pages)
    index = np.zeros(b, np.int64)
    for i, n in enumerate(lengths):
        if n is None or n == 0:
            table[i] = 0
            index[i] = 0 if n is None else int(rng.integers(1, 3 * pages
                                                            * page_size))
        else:
            index[i] = n - 1
    q = rng.standard_normal((b, 1, hkv * group, dim)).astype(np.float32)
    return (torch.from_numpy(q).to(device=device, dtype=value),
            k.to(device=device, dtype=store), v.to(device=device, dtype=store),
            torch.from_numpy(table.astype(np.int32)).to(device),
            torch.from_numpy(index.astype(np.int32)).to(device))


def autotune_cost(plan) -> float:
    """The reference's ``deterministic_autotune`` cost model
    (tests/conftest.py), for either package's plan: a per-step cost, a
    stored-elements term and an adaptive epilogue penalty."""
    us = 100.0 * plan.num_steps + 1e-3 * plan.stored_elements
    if plan.ordering == "adaptive":
        us += 20.0 + 5e-3 * plan.n_spilled_elements
    return us


def model_inputs(cfg, seed, b=2, s=8, enc_len=12):
    """A prompt batch for ``cfg`` as numpy arrays from ``seed``: ``tokens``
    (b, s), and ``frames`` (b, enc_len, d_frontend) for the
    encoder-decoder family or ``patch_embeds`` (b, frontend_tokens,
    d_frontend) for the vision frontend."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (b, enc_len, cfg.d_frontend)).astype(np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return out


def host(v):
    """numpy view of a jax array, a torch tensor, or a plain value."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    if hasattr(v, "__array__") and not isinstance(v, (tuple, list)):
        return np.array(v)        # a writable copy
    return v


def numpy_fields(obj):
    """The dataclass fields of a reference object, arrays as numpy."""
    return {f.name: host(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def assert_same_fields(ref, port):
    """Every field of the reference dataclass equals the port's — arrays in
    dtype, shape and every byte."""
    for f in dataclasses.fields(ref):
        r, p = host(getattr(ref, f.name)), host(getattr(port, f.name))
        if isinstance(r, np.ndarray):
            assert isinstance(p, np.ndarray), f.name
            assert r.dtype == p.dtype, (f.name, r.dtype, p.dtype)
            assert r.shape == p.shape, (f.name, r.shape, p.shape)
            assert r.tobytes() == p.tobytes(), f.name
        elif f.name == "shape":
            assert tuple(r) == tuple(p), f.name
        else:
            assert r == p, (f.name, r, p)


def row_shards(layer, cfg, x_flat, n):
    """``n`` row shards of the tokens ``x_flat`` for the port's MoE layer,
    each with a ``models.moe.RowShard`` whose ``gather`` returns every
    shard's routed-copy counts (what the all-gather gives on a mesh),
    after checking that the shard gave its own: ``(parts, shards)``."""
    from repro_torch.models import moe
    parts = list(x_flat.chunk(n))
    counts = torch.stack([
        moe._one_hot(moe._routing(layer, cfg, p)[0], cfg.moe.n_experts,
                     torch.int32).sum((0, 1), dtype=torch.int32)
        for p in parts])

    def gather(c, i):
        assert torch.equal(c, counts[i].to(c.device))
        return counts.to(c.device)

    return parts, [moe.RowShard(n, i, lambda c, i=i: gather(c, i))
                   for i in range(n)]
