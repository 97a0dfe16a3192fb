"""The sampler, the decode-step factory and the fused decode loop.

The PyTorch counterpart of ``repro.serve.device_loop``:

* :func:`sample_tokens` — ``(logits, generator) → tokens``: greedy argmax
  in float32, or temperature / top-k sampling from an explicit
  ``torch.Generator``.  Sampled streams differ from the reference's (the
  generators differ); greedy ones do not.
* :func:`make_decode_step` — the one definition of "one decode step".
* :func:`build_fused_decode` — the fused chunk runner the serving session
  dispatches: up to ``decode_chunk`` decode + sample + mask steps between
  two syncs with the host.

The reference fuses a chunk into one ``lax.while_loop``.  Here one step of
that loop's body is captured once in a ``torch.cuda.CUDAGraph``, and a
chunk replays the graph ``n_steps`` times and syncs once, when it reads
back the token block, the steps that ran and the logit screen.  A replay
cannot end early, so every state update of the body is gated on a flag
the card computes at the start of each step,
``live = (steps_ran < n_steps) & any(active)`` — the reference's loop
predicate: a step that is not live leaves ``steps_ran``, ``remaining``,
``active``, ``cur_tok``, the token block, every cache's ``index`` and
every recurrent state as they were.  Its KV writes land at each slot's
unadvanced ``index``, a position that no mask admits yet and that the
next live step overwrites before it attends.  A recurrent state update is
not idempotent, so the decode step returns the next state (``conv``,
``ssm``, ``h``) and the runner writes it in place as
``where(live, new, old)``: a dead step leaves each state bit for bit.
The host asks for ``min(chunk, max remaining)`` steps, so without EOS
every replay is live.

Every cache's ``index`` advances in lockstep (in RecurrentGemma layer 0
is recurrent and holds none); a stack with no index at all (mamba2) has
no position to advance: no layer of it reads one.

State the graph reads (all of it is written in place, never replaced: the
graph reads every tensor at the address it had when it was captured):

    inputs   (1 + 2n,)        int32  n_steps, remaining (n), active (n) —
                                     one copy from the host per chunk
    outputs  (1 + 2·k_max·n,) int32  steps_ran, block (k_max, n), logit_ok
                                     (k_max, n) — one copy to the host
    cur_tok  (n, 1)           int32  last sampled token per slot
    caches                           the session's KV caches and
                                     recurrent states

:class:`FusedDecode` records the address of each of those tensors and of
the model's parameters and buffers, and each weight's version, when it is
built, and raises before a chunk if any has changed: a weight written in
place would leave the graph reading its old compute-dtype copy and K2
plan, which the layers rebuild at new addresses.  On the card the graph is captured when the runner is built,
after three warm-up steps on a side stream that run with no slot active
(nothing live); a capture that fails raises, and the card never steps
eagerly in its place.  On the CPU the same one-step function runs eagerly
while it is live, at most ``n_steps`` times: that is its plain version.

The kernels' launch counters (``kernels._build.launches``) count where a
wrapper launches.  Under capture nothing launches, so the runner takes the
counts its capture added, puts them back, and adds them once per replay:
the counters stay what the card ran.  Sampling with ``temperature > 0``
draws from the engine's generator, registered with the graph, one draw of
exponentials per step, in the graph and out of it alike.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.models.recurrent import STATE_KEYS
from repro_torch.obs import trace as obs_trace

__all__ = ["sample_tokens", "make_decode_step", "build_fused_decode",
           "FusedDecode"]

WARMUP_STEPS = 3


def sample_tokens(logits, generator: Optional[torch.Generator],
                  temperature: float, top_k: int) -> torch.Tensor:
    """``logits`` (b, s, V): the last position is sampled in float32 →
    int32 tokens (b,).  ``temperature <= 0`` is greedy argmax (first of
    equal maxima, as the reference's) and draws nothing; otherwise top-k
    keeps the ``top_k`` largest logits (``top_k`` clamped to the vocab:
    ``>= vocab`` keeps every token, ``<= 0`` disables filtering) and the
    token is ``argmax(p / E)`` over exponential draws ``E`` — a draw from
    ``p``, with no host sync (``torch.multinomial`` checks its input on
    the host), so it runs inside a CUDA graph."""
    logits = logits[:, -1, :].float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    k = min(int(top_k), logits.shape[-1])
    if 0 < k < logits.shape[-1]:
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, logits.new_full((), -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def make_decode_step(model, shape_kind: str = "decode", partitioner=None):
    """``(caches, tokens) → (logits, caches)`` for ``model``.  With
    ``partitioner`` the step runs tensor-parallel on its mesh, eagerly
    (``launch.steps``'s serving note): the engine and :class:`FusedDecode`
    serve on one card, and gloo collectives cannot be captured in a CUDA
    graph."""
    if partitioner is not None:
        from repro_torch.launch.steps import _Serving
        serving = _Serving(model, partitioner, shape_kind)
        return serving.decode

    def decode_step(caches, tokens):
        return model.decode_step(caches, tokens, shape_kind=shape_kind)
    return decode_step


class FusedDecode:
    """The fused chunk runner of one engine (see the module's note).

    ``fused(caches, cur_tok, remaining, active, n_steps) → (block,
    steps_ran, cur_tok, generator, caches, logit_ok)``: ``caches`` and
    ``cur_tok`` must be the runner's own (:attr:`caches`,
    :attr:`cur_tok`), ``remaining`` and ``active`` are host sequences of
    ``n_slots``, ``n_steps`` is clamped to ``[0, decode_chunk]``.
    ``block`` and ``logit_ok`` come back as numpy arrays of ``steps_ran``
    rows: row i holds the tokens sampled at step i and whether every
    last-position logit of that step was finite, per slot.

    With a tracer active (``obs.trace.recording``) a call is the span
    ``decode.dispatch`` on :attr:`host_track` (its session's), with
    ``decode.wait`` inside from the first replay's launch on: the later
    replays, which wait for queue space behind the card, the output copy
    and the sync (without a graph, the read-back after the eager steps).
    It ends with the steps that ran and the kernel launches of its replays
    (:attr:`launches_per_replay` times the replays).
    """

    host_track = ("replica0", "host")

    def __init__(self, model, cfg, caches, generator=None):
        self.model = model
        self.caches = caches
        self.generator = generator
        self.eos = int(cfg.eos_id)
        self.temperature = float(cfg.temperature)
        self.top_k = int(cfg.top_k)
        self.k_max = k = max(1, int(cfg.decode_chunk))
        self.n = n = int(cfg.n_slots)
        self.device = dev = model.device
        self._decode = make_decode_step(model)
        self.inputs = torch.zeros(1 + 2 * n, dtype=torch.int32, device=dev)
        self.outputs = torch.zeros(1 + 2 * k * n, dtype=torch.int32,
                                   device=dev)
        self.n_steps = self.inputs[:1]
        self.remaining = self.inputs[1:1 + n]
        self.active = self.inputs[1 + n:]
        self.steps_ran = self.outputs[:1]
        self.block = self.outputs[1:1 + k * n].view(k, n)
        self.logit_ok = self.outputs[1 + k * n:].view(k, n)
        self.cur_tok = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        # the indices every live step advances (none in a stack of states)
        self._indexes = [c["index"] for c in caches if "index" in c]
        self.graph = None
        self.launches_per_replay = {}
        self.replays = 0
        self._ptrs = self._pointers()
        if dev.type == "cuda":
            self._host_in = torch.zeros(self.inputs.shape, dtype=torch.int32,
                                        pin_memory=True)
            self._host_out = torch.zeros(self.outputs.shape,
                                         dtype=torch.int32, pin_memory=True)
            self._capture()

    # ------------------------------------------------------------- the step
    def _step(self) -> None:
        """One step of the fused loop's body, every update gated on
        ``live``; reads and writes only the runner's tensors."""
        act = self.active != 0
        live = (self.steps_ran[0] < self.n_steps[0]) & act.any()
        logits, new_caches = self._decode(self.caches, self.cur_tok)
        # the new caches' rebound index tensors are dropped: the index
        # advances here, in place, when the step is live; so does each
        # recurrent state, which the step returned anew
        for cache, new in zip(self.caches, new_caches, strict=True):
            for key in STATE_KEYS:
                if key in cache:
                    cache[key].copy_(torch.where(live, new[key],
                                                 cache[key]))
        if self._indexes:
            index = self._indexes[0]
            new_index = torch.where(live, index + 1, index)
            for t in self._indexes:
                t.copy_(new_index)
        # per-slot finiteness of the sampled position's logits — NaN/Inf
        # here means the KV pages this slot read are poisoned
        fin = torch.isfinite(logits[:, -1, :].float()).all(-1)
        nxt = sample_tokens(logits, self.generator, self.temperature,
                            self.top_k)
        row = torch.clamp(self.steps_ran, max=self.k_max - 1).long()
        for out, val in ((self.block, nxt), (self.logit_ok, fin.int())):
            out.index_copy_(0, row, torch.where(
                live, val, out.index_select(0, row)[0])[None])
        rem = torch.where(act, self.remaining - 1, self.remaining)
        done = rem <= 0
        if self.eos >= 0:
            done = done | (nxt == self.eos)
        self.remaining.copy_(torch.where(live, rem, self.remaining))
        self.active.copy_(torch.where(live, (act & ~done).int(),
                                      self.active))
        self.cur_tok.copy_(torch.where(live, nxt[:, None], self.cur_tok))
        self.steps_ran.add_(live.int())

    def _live(self) -> bool:
        return bool(self.steps_ran[0] < self.n_steps[0]) \
            and bool(self.active.any())

    def _capture(self) -> None:
        """Warm up and capture one step on the card.  Nothing is live
        while it runs (no slot active), so the state stays as it was."""
        dev = self.device
        launches = _build.launches
        self.inputs.zero_()
        self.steps_ran.zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.inference_mode(), torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = dict(launches)
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0.0 and self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.inference_mode(), torch.cuda.graph(graph):
            self._step()
        self.launches_per_replay = {k: launches[k] - before[k]
                                    for k in launches
                                    if launches[k] != before[k]}
        launches.update(before)
        self.graph = graph

    # ------------------------------------------------------------ addresses
    def _pointers(self):
        """``(name, address, version)`` of every tensor the step reads.  The
        model's weights carry their version too: the step reads each
        weight's compute-dtype copy and K2 plan, which the layers rebuild
        at new addresses when the weight is written in place.  (Inference
        tensors keep no version, as in ``ParamModule.cast``.)"""
        state = [("inputs", self.inputs), ("outputs", self.outputs),
                 ("cur_tok", self.cur_tok)]
        for i, cache in enumerate(self.caches):
            state += [(f"caches[{i}][{key!r}]", t)
                      for key, t in cache.items()]
        weights = [(f"model.{name}", t) for name, t in
                   [*self.model.named_parameters(),
                    *self.model.named_buffers()]]
        return ([(name, t.data_ptr(), 0) for name, t in state]
                + [(name, t.data_ptr(), 0 if t.is_inference() else t._version)
                   for name, t in weights])

    def _check_pointers(self) -> None:
        now = self._pointers()
        if now == self._ptrs:
            return
        was = {name: (ptr, ver) for name, ptr, ver in self._ptrs}
        what = "the set of tensors the decode graph reads has changed"
        for name, ptr, ver in now:
            if was.get(name, (None,))[0] != ptr:
                what = (f"{name} is no longer the tensor the decode graph "
                        f"was captured on")
                break
            if was[name][1] != ver:
                what = (f"{name} was written in place after the decode graph "
                        f"was captured (the graph would go on reading its "
                        f"old compute-dtype copy and K2 plan)")
                break
        raise RuntimeError(
            f"fused decode: {what}; a cache or state tensor must be written "
            f"in place, never replaced, and the weights must not change "
            f"while the engine serves")

    # ------------------------------------------------------------- dispatch
    def __call__(self, caches, cur_tok, remaining, active, n_steps):
        if caches is not self.caches or cur_tok is not self.cur_tok:
            raise RuntimeError("fused decode: pass the runner's own caches "
                               "and cur_tok")
        spans = obs_trace.active()
        track = self.host_track
        if spans.enabled:
            spans.begin("decode.dispatch", track)
        self._check_pointers()
        n_steps = min(max(int(n_steps), 0), self.k_max)
        host = np.concatenate([[n_steps], np.asarray(remaining, np.int64),
                               np.asarray(active, np.int64)]).astype(np.int32)
        if self.graph is not None:
            self._host_in.numpy()[:] = host
            self.inputs.copy_(self._host_in, non_blocking=True)
            self.steps_ran.zero_()
            if n_steps:
                self.graph.replay()
            if spans.enabled:
                spans.begin("decode.wait", track)
            for _ in range(n_steps - 1):
                self.graph.replay()
            self.replays += n_steps
            for name, count in self.launches_per_replay.items():
                _build.launches[name] += count * n_steps
            self._host_out.copy_(self.outputs, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = self._host_out.numpy()
        else:
            self.inputs.copy_(torch.from_numpy(host))
            self.steps_ran.zero_()
            with torch.inference_mode():
                for _ in range(n_steps):
                    if not self._live():
                        break
                    self._step()
            if spans.enabled:
                spans.begin("decode.wait", track)
            out = self.outputs.cpu().numpy()
        steps = int(out[0])
        if spans.enabled:
            spans.end("decode.wait", track)
        k, n = self.k_max, self.n
        block = out[1:1 + k * n].reshape(k, n)[:steps].copy()
        ok = out[1 + k * n:].reshape(k, n)[:steps].astype(bool)
        if spans.enabled:
            spans.end("decode.dispatch", track, steps=steps, launches={
                name: count * n_steps
                for name, count in self.launches_per_replay.items()})
        return block, steps, self.cur_tok, self.generator, self.caches, ok


def build_fused_decode(model, cfg, caches, generator=None) -> FusedDecode:
    """The fused chunk runner for one engine config over ``caches`` (see
    :class:`FusedDecode`; on the card this captures its graph).  The
    engine's trace hook runs around it (``Engine._run_fused``), not in
    it; the active tracer's ``decode.*`` spans are recorded in it."""
    return FusedDecode(model, cfg, caches, generator)
