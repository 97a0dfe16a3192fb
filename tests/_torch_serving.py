"""Helpers shared by the port's serving parity tests
(``tests/test_torch_paging.py``, ``test_torch_serve.py``,
``test_torch_router.py``, ``test_torch_export.py``,
``test_torch_launch.py``).

Both packages serve smoke granite-3-2b (or another family's smoke
config, ``arch=``) in float32 (compute and KV cache) from the same
weights: the reference's, carried across with ``params_from_numpy``.  The reference compiles its prefill per prompt
length and its fused loop per configuration; to keep the tests inside
their time, one reference engine per (weights, ``max_seq``) is built and
shallow-copied for every other ``ServeConfig``, each copy taking the
configuration's own fused loop (built once per loop setting) behind the
reference's trace hook.  The copy runs the reference's own ``serve`` code;
only the compiled functions are shared.  A fleet (``fleet``) of either
package is a router over such engines on one fake clock; ``REF`` and
``PORT`` name each package's router, fault and checkpoint classes.
"""
import copy
import dataclasses
import time
import types

import jax
import numpy as np

from repro.configs import get_smoke as ref_get_smoke
from repro.models import LanguageModel as RefModel
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import Router as RefRouter
from repro.serve import RouterConfig as RefRouterConfig
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import device_loop as ref_device_loop
from repro.train import checkpoint as ref_checkpoint
from repro.train.fault import FaultConfig as RefFaultConfig
from repro.train.fault import FaultInjector as RefInjector
from repro.train.fault import ProcessKilled as RefProcessKilled
from repro_torch.configs import get_smoke
from repro_torch.configs.base import SparsityConfig
from repro_torch.models import params_from_numpy
from repro_torch.serve import (Engine, Request, Router, RouterConfig,
                               ServeConfig)
from repro_torch.train import checkpoint
from repro_torch.train.fault import FaultConfig, FaultInjector, ProcessKilled

SPARSE = SparsityConfig(enabled=True, density=0.25, group_size=128,
                        impl="kernel")
FP32 = dict(dtype="float32", kv_cache_dtype="float32")

_PAIRS = {}
_REF_BASE = {}
_REF_LOOPS = {}


class FakeClock:
    """Deterministic engine clock: time advances only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def tick_decode(eng, clock, dt=1.0, slow_at=()):
    """Wrap an engine's decode seams (either package's) so each decode
    STEP advances ``clock`` by ``dt`` (``slow_at``: step indices that take
    10×): ``_fused_decode`` advances by the steps it ran (position 1 of its
    result), ``_decode`` by one."""
    orig, orig_fused = eng._decode, eng._fused_decode
    count = [0]

    def cost():
        c = dt * (10.0 if count[0] in slow_at else 1.0)
        count[0] += 1
        return c

    def wrapped(*a):
        clock.advance(cost())
        return orig(*a)

    def wrapped_fused(*a):
        out = orig_fused(*a)
        clock.advance(sum(cost() for _ in range(int(out[1]))))
        return out

    eng._decode = wrapped
    eng._fused_decode = wrapped_fused


def pair(sparse=False, arch="granite-3-2b"):
    """(reference cfg, reference params, port cfg, port parameter tree)
    for ``arch``'s smoke config in float32, built once per process."""
    if (sparse, arch) not in _PAIRS:
        over = dict(FP32, **({"sparsity": SPARSE} if sparse else {}))
        ref_cfg = dataclasses.replace(ref_get_smoke(arch), **over)
        cfg = dataclasses.replace(get_smoke(arch), **over)
        ref_params = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
        tree = params_from_numpy(cfg, jax.device_get(ref_params),
                                 device="cpu")
        _PAIRS[sparse, arch] = (ref_cfg, ref_params, cfg, tree)
    return _PAIRS[sparse, arch]


def ref_engine(sparse=False, fault_cfg=None, arch="granite-3-2b",
               **serve_kw):
    ref_cfg, ref_params, _, _ = pair(sparse, arch)
    scfg = RefServeConfig(**serve_kw)
    key = (sparse, arch, scfg.max_seq)
    if key not in _REF_BASE:
        _REF_BASE[key] = RefEngine(ref_cfg, RefServeConfig(
            max_seq=scfg.max_seq), params=ref_params)
    base = _REF_BASE[key]
    loop = key + (scfg.decode_chunk, scfg.eos_id, scfg.temperature,
                  scfg.top_k)
    if loop not in _REF_LOOPS:
        _REF_LOOPS[loop] = ref_device_loop.build_fused_decode(base.model,
                                                              scfg)
    eng = copy.copy(base)
    eng.cfg = scfg
    fused = _REF_LOOPS[loop]

    def fused_with_hook(*args):          # the reference's trace hook
        out = fused(*args)
        eng._on_fused_dispatch(out)
        return out

    eng._fused_decode = fused_with_hook
    eng._key = jax.random.PRNGKey(scfg.seed)
    eng.fault_cfg = fault_cfg if fault_cfg is not None else RefFaultConfig()
    eng.fault_injector = None
    eng.clock = time.time
    eng.tracer = None
    eng.paging_stats = None
    return eng


def port_engine(sparse=False, fault_cfg=None, arch="granite-3-2b",
                **serve_kw):
    _, _, cfg, tree = pair(sparse, arch)
    return Engine(cfg, ServeConfig(**serve_kw), params=tree, device="cpu",
                  fault_cfg=fault_cfg)


def engines(sparse=False, clock=True, fault_cfg=None, slow_at=(),
            arch="granite-3-2b", **serve_kw):
    """A reference engine and a port engine on the same weights and
    configuration; with ``clock`` (the default), each on its own FakeClock
    advanced one second per decode step.  The stats snapshots that the
    tests compare read the engine's clock (the straggler watchdog counts
    decode steps slower than twice its running mean), so on the wall clock
    one stalled dispatch under load flags a straggler on one side only;
    ``clock=False`` keeps the wall clock for a test that compares no
    stats."""
    pair_ = (ref_engine(sparse, arch=arch, **serve_kw),
             port_engine(sparse, fault_cfg=fault_cfg, arch=arch,
                         **serve_kw))
    if fault_cfg is not None:
        pair_[0].fault_cfg = RefFaultConfig(**dataclasses.asdict(fault_cfg))
    if clock:
        for eng in pair_:
            eng.clock = FakeClock()
            tick_decode(eng, eng.clock, slow_at=slow_at)
    return pair_


def requests(seed, lens, max_new, deadlines=None, vocab=512):
    """Two lists of equal requests (reference, port) from one seed."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, vocab, (ln,)).astype(np.int32) for ln in lens]
    max_new = max_new if isinstance(max_new, (list, tuple)) \
        else [max_new] * len(lens)
    deadlines = deadlines or [None] * len(lens)
    return tuple([cls(tokens=t.copy(), max_new_tokens=m, deadline_s=d)
                  for t, m, d in zip(toks, max_new, deadlines)]
                 for cls in (RefRequest, Request))


_TIMING = ("request_timing", "latency_percentiles")


def assert_same_serving(ref_reqs, reqs, ref_stats=None, stats=None,
                        timing=False):
    """Streams, statuses and errors equal request by request; the stats
    snapshots equal key by key (their timing too when ``timing``: the
    engines then run on fake clocks)."""
    for r, p in zip(ref_reqs, reqs, strict=True):
        assert p.out == r.out, (p.out, r.out)
        assert (p.done, p.status, p.preemptions) == \
            (r.done, r.status, r.preemptions)
        assert (p.error is None) == (r.error is None)
        if r.error is not None and "injected" in r.error:
            assert p.error == r.error
        if timing:
            assert (p.queue_s, p.latency_s, p.prefill_s) == \
                (r.queue_s, r.latency_s, r.prefill_s)
    if ref_stats is not None:
        drop = () if timing else _TIMING
        want = {k: v for k, v in ref_stats.items() if k not in drop}
        got = {k: v for k, v in stats.items() if k not in drop}
        assert got == want


def oracle(eng, req):
    """``generate()`` of one request alone (either package)."""
    return [int(t) for t in eng.generate(np.asarray(req.tokens)[None, :],
                                         max_new_tokens=req.max_new_tokens
                                         )[0]]



# ------------------------------------------------------------------ fleets

REF = types.SimpleNamespace(
    Router=RefRouter, RouterConfig=RefRouterConfig,
    FaultConfig=RefFaultConfig, FaultInjector=RefInjector,
    ProcessKilled=RefProcessKilled, checkpoint=ref_checkpoint)
PORT = types.SimpleNamespace(
    Router=Router, RouterConfig=RouterConfig, FaultConfig=FaultConfig,
    FaultInjector=FaultInjector, ProcessKilled=ProcessKilled,
    checkpoint=checkpoint)
SIDES = (REF, PORT)


def replicas(side, n, sparse=False, fault_cfg=None, params=None,
             **serve_kw):
    """``n`` engines of one package sharing one model's weights (port:
    ``params=first.params``, or ``params`` itself, a port model, when
    given; reference: copies of one compiled engine).  Serving defaults:
    ``max_seq`` 64, 2 slots, 4-token pages."""
    kw = dict(max_seq=64, n_slots=2, page_size=4)
    kw.update(serve_kw)
    if side is REF:
        return [ref_engine(sparse, fault_cfg=fault_cfg, **kw)
                for _ in range(n)]
    first = port_engine(sparse, fault_cfg=fault_cfg, **kw) \
        if params is None else Engine(params.cfg, ServeConfig(**kw),
                                      params=params, fault_cfg=fault_cfg)
    return [first] + [Engine(first.model.cfg, first.cfg,
                             params=first.params, fault_cfg=fault_cfg)
                      for _ in range(n - 1)]


def fleet(side, n, clock, fault_cfg=None, router_cfg=None, injectors=None,
          sparse=False, params=None, tracer=None, **serve_kw):
    """A router over ``n`` replicas on ``clock`` (each decode step one
    second; the router sleeps by advancing it).  ``injectors``: {replica
    index: FaultInjector}, attached before the router opens sessions."""
    es = replicas(side, n, sparse, fault_cfg, params, **serve_kw)
    for idx, inj in (injectors or {}).items():
        es[idx].fault_injector = inj
    for e in es:
        e.clock = clock
        tick_decode(e, clock)
    return es, side.Router(es, cfg=router_cfg, fault_cfg=fault_cfg,
                           clock=clock, sleep=clock.advance, tracer=tracer)


def both(scenario, seed, lens, max_new, deadlines=None):
    """Run ``scenario(side, reqs)`` on each package with equal requests;
    returns its two results, reference first."""
    return [scenario(side, reqs) for side, reqs in
            zip(SIDES, requests(seed, lens, max_new, deadlines))]
