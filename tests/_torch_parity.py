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
