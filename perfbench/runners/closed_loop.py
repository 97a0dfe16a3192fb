"""Closed-loop serving through the port's continuous-batching session.

``clients`` clients each send a request, wait for its last token, and
send the next at once, into one ``EngineSession`` of an ``Engine`` with
``slots`` decode slots (``Engine.start_session`` / ``submit`` / ``step``).
The model comes from the configuration's maker, its weights drawn from
the seed on the card and handed to ``Engine(..., params=)``.  Greedy
decoding, no EOS: every request yields exactly its budget of tokens.

Requests are dealt from a deck: ``deck`` (prompt, answer) length pairs,
the log-normal quantiles of the mix's ``prompt`` and ``output`` laws
(median, sigma, clipped to min and max) paired in a fixed order, each
block of ``deck`` requests a permutation of the same pairs drawn from the
seed.  So every seed serves the same sizes, in another order, and any
stretch of requests has nearly the same mix.  Prompt tokens are drawn
from the seed.

Set-up warms the decode graph and a prefill at each of the deck's prompt
lengths, then starts the loop: every client sends its first request, and
the loop runs until ``open_after`` requests have completed, so that the
clients' synchronized start lies before the window.  The caller sees
tokens when ``step(decode_chunk)`` returns (one admission pass, then one
fused dispatch of up to ``decode_chunk`` decode steps), and the host's
clock is read there:

- ``tokens_per_s``: tokens delivered in the window over the window;
- ``tpot_p90_ms``: (last token − first token) / (tokens − 1) of each
  request completed in the window.

Checked: a sample of the finished requests drawn from the seed, the
longest among them, until ``check_tokens`` served tokens (at most
``check_max_requests`` requests): the reference's full forward pass over
each prompt and its served tokens, and the widest gap by which a served
token's logit lies below the reference's best at its position.
"""
from __future__ import annotations

import math
import random
from statistics import NormalDist

import numpy as np
import torch

from perfbench import counts
from perfbench.harness import free_device_memory, now, percentile
from perfbench.reference import gqa_lm as ref
from perfbench.trace import Slice


class State:
    pass


class Tracked:
    """One request of the window, as its client sees it."""

    def __init__(self, req):
        self.req = req
        self.first = self.done = None
        self.call = None          # index of the step call that prefilled it
        self.at_open = 0          # tokens delivered by the window's open
        self.at_close = 0         # tokens delivered by the window's close


def length_pairs(traffic: dict) -> list:
    """The deck's (prompt, answer) lengths, in a fixed order."""
    n = int(traffic["deck"])

    def quantiles(law):
        z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
        return [int(min(max(round(law["median"] * math.exp(law["sigma"] * zi)),
                            law["min"]), law["max"])) for zi in z]

    prompts, outputs = quantiles(traffic["prompt"]), quantiles(traffic["output"])
    order = list(range(n))
    random.Random(0).shuffle(order)        # a fixed pairing for every seed
    return [(prompts[i], outputs[order[i]]) for i in range(n)]


class Deck:
    """Requests dealt in blocks, each a seed's permutation of the pairs."""

    def __init__(self, pairs, vocab: int, seed: int):
        self.pairs, self.vocab = pairs, vocab
        self.rng = np.random.default_rng(seed)
        self.block = []

    def next(self):
        from repro_torch.serve import Request
        if not self.block:
            self.block = [self.pairs[i] for i in
                          self.rng.permutation(len(self.pairs))]
        prompt, new = self.block.pop()
        tokens = self.rng.integers(0, self.vocab, prompt).astype(np.int32)
        return Request(tokens=tokens, max_new_tokens=int(new))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Loop:
    """The clients and the session: submissions, the session's calls, and
    what each client sees at each call's return."""

    def __init__(self, engine, deck, chunk: int):
        self.sess = engine.start_session()
        self.deck, self.chunk = deck, chunk
        self.requests, self.live, self.calls = [], [], []

    def submit(self) -> None:
        r = Tracked(self.deck.next())
        self.sess.submit(r.req)
        self.requests.append(r)
        self.live.append(r)

    def step(self, traced: bool = False) -> float:
        """One ``step(decode_chunk)`` call, recorded; returns its end."""
        steps0 = self.sess.stats["decode_steps"]
        a = now()
        with torch.profiler.record_function("bench.step"):
            self.sess.step(self.chunk)
        t = now()
        self.calls.append({"wall": t - a, "traced": traced,
                           "steps": self.sess.stats["decode_steps"] - steps0})
        return t

    def scan(self, t: float, call, resubmit: bool) -> None:
        """Stamp the first and last tokens seen at ``t``; a client whose
        request completed sends its next one while ``resubmit``."""
        for r in list(self.live):
            if r.first is None and r.req.out:
                r.first, r.call = t, call
            if r.req.done:
                r.done = t
                self.live.remove(r)
                if resubmit:
                    self.submit()


def setup(run):
    from repro_torch.serve import Engine, Request, ServeConfig
    st = State()
    cfg, tr, dev = run.config, run.traffic, run.device
    st.model_cfg = run.maker.model_config(cfg)
    run.mark("imports")
    weights = run.maker.make_weights(cfg, run.seed, dev)
    _sync(dev)
    run.mark("weights")
    serving = cfg["serving"]
    st.engine = Engine(st.model_cfg, ServeConfig(
        max_seq=int(tr["max_seq"]), n_slots=int(tr["slots"]),
        decode_chunk=int(tr["decode_chunk"]), kv_layout=serving["kv_layout"],
        page_size=int(serving["page_size"]), temperature=0.0, eos_id=-1),
        params=weights, device=dev)
    del weights
    _sync(dev)
    run.mark("engine")
    if run.substitute is not None:
        run.substitute(st.engine)
    st.pairs = length_pairs(tr)
    # warm: the decode graph (captured at the first session) and a prefill
    # at every prompt length the deck holds (K2's work list at each width)
    warm_rng = np.random.default_rng([run.seed, 1])
    st.engine.serve([Request(tokens=warm_rng.integers(
        0, cfg["vocab_size"], p).astype(np.int32), max_new_tokens=2)
        for p in sorted({p for p, _ in st.pairs})])
    if run.trace:
        Slice.warm(dev)
    _sync(dev)
    run.mark("graph and prefill widths")
    st.loop = loop = Loop(st.engine, Deck(st.pairs, cfg["vocab_size"],
                                          run.seed), int(tr["decode_chunk"]))
    for _ in range(int(tr["clients"])):
        loop.submit()
    while sum(r.done is not None for r in loop.requests) \
            < int(tr["open_after"]):
        loop.scan(loop.step(), len(loop.calls) - 1, True)
    run.mark("loop started")
    return st


def window(run, st):
    tr, dev, loop = run.traffic, run.device, st.loop
    t_trace = run.seconds * float(tr["trace_at"])
    sl = None
    traced_done = False
    for r in loop.requests:
        r.at_open = len(r.req.out or ())
    st.first_call = len(loop.calls)
    run.window_t0 = t0 = now()
    while True:
        if run.trace and sl is None and not traced_done \
                and now() - t0 >= t_trace:
            sl = Slice(dev)
            sl.start()
            trace_t0 = now()
        t = loop.step(traced=sl is not None)
        loop.scan(t, len(loop.calls) - 1, t - t0 < run.seconds)
        if sl is not None and t - trace_t0 >= float(tr["trace_seconds"]):
            sl.stop()
            run.slice, sl, traced_done = sl, None, True
        if t - t0 >= run.seconds:
            break
    if sl is not None:
        sl.stop()
        run.slice = sl
    t_end = t
    run.window_s = t_end - t0
    for r in loop.requests:
        r.at_close = len(r.req.out or ())
    # the window's requests: those live at its open and those sent in it
    st.requests = [r for r in loop.requests
                   if r.done is None or r.done > t0]
    _measure(run, st, loop.calls[st.first_call:], st.first_call, t_end)


def _measure(run, st, calls, first_call, t_end):
    """The end-to-end metrics and what the readers need; ``calls`` are
    the window's step calls, the first of them call ``first_call``."""
    cfg = run.config
    reqs = st.requests
    run.attempted = len(reqs)
    run.failed = sum(1 for r in reqs if r.req.done and not r.req.ok_like)
    run.e2e["tokens_per_s"] = sum(r.at_close - r.at_open
                                  for r in reqs) / run.window_s
    tpot = [(r.done - r.first) / (len(r.req.out) - 1) for r in reqs
            if r.done is not None and r.done <= t_end and r.req.ok_like
            and len(r.req.out) > 1]
    if tpot:
        run.e2e["tpot_p90_ms"] = percentile(tpot, 90) * 1e3
    # model operations of the window's tokens: each prefill whose first
    # token came in the window, and each token decoded in it
    flops = 0
    for r in reqs:
        p = len(r.req.tokens)
        if r.at_close and not r.at_open:
            flops += counts.prefill_flops(cfg, p)
        flops += sum(counts.decode_flops(cfg, p + j)
                     for j in range(max(1, r.at_open), r.at_close))
    prefilled = {}
    for r in reqs:
        if r.call is not None and r.call >= first_call:
            prefilled.setdefault(r.call - first_call, []).append(r)
    plain = [i for i, c in enumerate(calls) if not c["traced"]]
    prefill_s = [r.req.prefill_s for i in plain for r in prefilled.get(i, ())]
    traced = [i for i, c in enumerate(calls) if c["traced"]]
    run.host.update(
        model_flops=flops,
        decode_steps=sum(calls[i]["steps"] for i in plain),
        decode_wall_s=sum(calls[i]["wall"] for i in plain) - sum(prefill_s),
        traced_decode_steps=sum(calls[i]["steps"] for i in traced),
        slots=int(run.traffic["slots"]),
        serving_dtype=cfg["serving"]["dtype"])


def release(run, st):
    """Free the program: its engine, session, caches, graph and plans."""
    st.engine = st.loop = None
    free_device_memory()


def sample(run, st):
    """The finished requests to check: the longest, then others in an
    order drawn from the seed, until ``check_tokens`` served tokens."""
    done = [r for r in st.requests if r.req.ok_like and r.req.out]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.req.tokens) + len(r.req.out))
    rng = np.random.default_rng([run.seed, 2])
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    picked, served = [longest], len(longest.req.out)
    for r in rest:
        if served >= int(run.traffic["check_tokens"]) or \
                len(picked) >= int(run.traffic["check_max_requests"]):
            break
        picked.append(r)
        served += len(r.req.out)
    return picked


def served_gaps(run, st, quant=None):
    """The reference's float32 logits at each served position of the
    sample: ``(the widest gap below the best of a served token, the same
    of the token the reference in ``quant`` puts first or None, tokens
    compared)``."""
    dev = run.device
    picked = sample(run, st)
    if not picked:
        return math.inf, None, 0
    weights = run.maker.make_weights(run.config, run.seed, dev)
    seqs, pos, served = [], [], []
    for r in picked:
        prompt = np.asarray(r.req.tokens, np.int64)
        out = np.asarray(r.req.out, np.int64)
        seq = np.concatenate([prompt, out[:-1]])
        seqs.append(torch.from_numpy(seq).to(dev))
        pos.append(torch.arange(len(prompt) - 1, len(seq), device=dev))
        served.append(torch.from_numpy(out).to(dev))
    want = ref.logits_at(weights, run.config, seqs, pos)
    gap = max(float((w.max(-1).values
                     - w.gather(-1, s[:, None])[:, 0]).max())
              for w, s in zip(want, served))
    low = None
    if quant is not None:
        got = ref.logits_at(weights, run.config, seqs, pos, quant=quant)
        low = max(float((w.max(-1).values
                         - w.gather(-1, g.argmax(-1)[:, None])[:, 0]).max())
                  for w, g in zip(want, got))
    return gap, low, sum(len(s) for s in served)


def check(run, st):
    gap, _, _ = served_gaps(run, st)
    return [("logit_gap", gap, float(run.config["limits"]["logit_gap"]))]


def control_reading(run, st):
    """The control's reading: the widest gap of the tokens the reference
    in fp8 puts first, at each served position of the sample."""
    return served_gaps(run, st, quant="fp8")[1]
