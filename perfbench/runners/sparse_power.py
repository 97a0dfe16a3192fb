"""Repeated sparse products, as an iterative solver makes them.

``x ← A · x`` (``vectors: 1``, through ``repro_torch.core.spmv``) or
``X ← A · X`` (``vectors: d``, through ``spmm``), the matrix in the port's
RgCSR built from the configuration's CSR arrays by the port's own
``from_csr`` and plan, the kernels forced (``impl="kernel"``).  Every
``renorm_every`` products the vectors are renormalised on the card (each
column to unit length), as a power iteration does; nothing in the loop
synchronizes, so the card runs as far ahead of the host as its queue lets
it.

- ``sparse_gflop_s``: ``2 · nnz · d`` a product, over every product
  enqueued in the window and the whole window (which ends when the card
  has finished them).
- Checked: a sample of the window's products, drawn from the seed (a
  reservoir of ``samples``, with the first and the last), each against
  the float64 reference from the same input vectors, as the largest error
  relative to the element's ``Σ |a_ij x_j|``.
- Traced (``--trace 1``): ``trace_seconds`` of products from ``trace_at``
  of the window, between two synchronizations; and, after the window, the
  host's time to enqueue ``enqueue_products`` products while a spin
  kernel holds the card (so no launch waits for the queue).
"""
from __future__ import annotations

import math
import random

import torch

from perfbench import counts
from perfbench.harness import now
from perfbench.reference import csr as ref
from perfbench.trace import Slice

SPIN_CYCLES_PER_S = 2.0e9     # above the card's clock: the hold outlasts


class State:
    pass


def setup(run):
    from repro_torch import core
    st = State()
    cfg, tr, dev = run.config, run.traffic, run.device
    run.mark("imports")
    values, columns, row_ptr, shape = run.maker.make_csr(cfg)
    run.mark("csr")
    fmt = cfg["format"]
    a = core.from_csr(values, columns, row_ptr, shape, fmt["name"],
                      group_size=fmt["group_size"],
                      slot_pad=fmt["slot_pad"], device=dev)
    run.mark("from_csr")
    d = int(tr["vectors"])
    st.nnz, st.shape, st.d, st.matrix = len(values), shape, d, a
    st.csr = (values, columns, row_ptr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    size = (shape[1],) if d == 1 else (shape[1], d)
    st.x0 = torch.randn(size, generator=gen, device=dev,
                        dtype=torch.float32)
    st.x0 /= torch.linalg.vector_norm(st.x0, dim=0)
    if run.substitute is not None:
        st.product = run.substitute(st)
    elif d == 1:
        st.product = lambda x: core.spmv(a, x, impl="kernel")
    else:
        st.product = lambda x: core.spmm(a, x, impl="kernel")
    # warm: the plan, the kernels, and the allocator's blocks for as many
    # live vectors as the window's sample holds
    x = st.x0
    keep = []
    for i in range(int(tr["samples"]) + 3):
        y = st.product(x)
        if i == 0:
            _sync(dev)
            run.mark("first product")
        keep.append((x, y))
        x = _renorm(y)
    del keep, x, y
    if run.trace:
        Slice.warm(dev)
    _sync(dev)
    run.mark("warm")
    return st


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _renorm(x):
    return x / torch.linalg.vector_norm(x, dim=0)


class _Reservoir:
    """A uniform sample of ``m`` of a stream's items, drawn from the seed
    (Li's algorithm L: the next index to take is drawn ahead, so most
    items cost one comparison)."""

    def __init__(self, m: int, seed: int):
        self.m, self.rng = m, random.Random(seed)
        self.items = {}
        self.w = 1.0
        self.next = m - 1
        self._advance()

    def _u(self):
        return self.rng.random() or 1e-300

    def offer(self, i: int, item) -> None:
        if i < self.m:
            self.items[i] = item
        elif i == self.next:
            del self.items[self.rng.choice(sorted(self.items))]
            self.items[i] = item
            self._advance()

    def _advance(self) -> None:
        self.w *= math.exp(math.log(self._u()) / self.m)
        self.next += 1 + int(math.log(self._u())
                             / math.log1p(-min(self.w, 1 - 1e-16)))


def window(run, st):
    tr, dev = run.traffic, run.device
    every = int(tr["renorm_every"])
    sample = _Reservoir(int(tr["samples"]), run.seed)
    t_trace = run.seconds * float(tr["trace_at"])
    traced = False
    x = st.x0
    k = 0
    first = last = None
    run.window_t0 = t0 = now()
    while True:
        if run.trace and not traced and now() - t0 >= t_trace:
            x, n = _traced_block(run, st, x, every)
            k += n
            traced = True
        for _ in range(every):
            y = st.product(x)
            last = (x, y)
            first = first or last
            sample.offer(k, last)
            k += 1
            x = y
        x = _renorm(x)
        if now() - t0 >= run.seconds:
            break
    _sync(dev)
    run.window_s = now() - t0
    run.attempted = k
    run.e2e["sparse_gflop_s"] = (counts.product_flops(st.nnz, st.d) * k
                                 / run.window_s / 1e9)
    st.samples = [first, last, *sample.items.values()]
    if run.trace:
        run.host["enqueue_s_per_product"] = _enqueue_seconds(run, st, x)


def _traced_block(run, st, x, every):
    """Products for ``trace_seconds`` between two synchronizations, under
    the profiler; returns the vector after them and their count."""
    sl = Slice(run.device)
    sl.start()
    t = now()
    n = 0
    with torch.profiler.record_function("bench.products"):
        while now() - t < float(run.traffic["trace_seconds"]):
            for _ in range(every):
                x = st.product(x)
                n += 1
            x = _renorm(x)
    sl.stop()
    run.slice = sl
    run.host["traced_products"] = n
    return x, n


def _enqueue_seconds(run, st, x):
    """Host seconds to enqueue one product while the card is held busy."""
    n = int(run.traffic["enqueue_products"])
    if run.device.type != "cuda":
        return None
    _sync(run.device)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * 0.5))
    t = now()
    for _ in range(n):
        st.product(x)
    dt = now() - t
    _sync(run.device)
    return dt / n


def release(run, st):
    """Free the program's matrix and plans; keep the sampled vectors."""
    from repro_torch.kernels import ops
    st.matrix = st.product = None
    ops.PLAN_CACHE.clear()


def _csr_on(st, dev):
    """The benchmark's CSR arrays on ``dev``, and each nonzero's row."""
    v, c, p = (torch.from_numpy(t).to(dev) for t in st.csr)
    return v, c, p, ref.row_ids(p)


def _worst(run, st, output) -> float:
    """The largest relative error over the sampled products of
    ``output(x, y)`` (``y`` the program's product of ``x``)."""
    v, c, p, rows = _csr_on(st, run.device)
    worst = 0.0
    for x, y in st.samples:
        want, scale = ref.product(v, c, p, x, rows)
        worst = max(worst, ref.relative_error(output(x, y), want, scale))
        del want, scale
    return worst


def check(run, st):
    """The largest relative error of the sampled products."""
    limit = float(run.config["limits"]["rel_err"])
    return [("rel_err", _worst(run, st, lambda x, y: y), limit)]


def control(st):
    """A substitute for the program's product: the reference computed from
    inputs rounded to TF32, in float32."""
    v, c, p, rows = _csr_on(st, st.x0.device)
    return lambda x: ref.product_tf32(v, c, p, x, rows)


def control_reading(run, st) -> float:
    """The control's reading: the sampled inputs through :func:`control`,
    judged as the program's products are."""
    low = control(st)
    return _worst(run, st, lambda x, y: low(x))
