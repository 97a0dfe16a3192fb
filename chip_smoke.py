#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each
prints ``phase <n> <name> start:`` and ``... end:`` lines, flushed, with
the seconds into the run and the card's free and total memory, and a run
that raises ends with ``chip_smoke: stopped in phase ...``, the phase and
the card's memory):

1. print the card (``nvidia-smi``) and build the three CUDA kernels from
   ``src/repro_torch/kernels/csrc/`` — one ``nvcc`` per source, all at once;
2. build two matrices at their published sizes from CSR arrays:
   ``fem2d_2048`` (2-D 5-point Laplacian on a 2048×2048 grid: 4,194,304
   rows, 20,963,328 nonzeros) and ``raj1_full`` (the Raj1 twin of
   ``suite.paper_twins`` at scale 1: 263,743 rows, 4 rows at 15 % density);
3. hold each kernel against its plain PyTorch version on the card, on the
   same inputs: fp32 within 1e-5, bf16 within 3e-2 (both sum in fp32; they
   differ only in summation order and one final rounding) — K1 and K2 also
   with the split of long groups forced at small piece sizes, and K2 on one
   ``w_out`` layer of granite-3-2b (16 groups × 2,048 slot rows of 128
   lanes, d_in 8,192) at the serving widths d ∈ {1, 4, 512}.  K1/K2 skip
   padding (value 0 at column 0), which the plain versions sum as 0·x[0]:
   with the finite x used here the two agree;
4. the main path: ``spmv``/``spmm`` on both RgCSR matrices with the default
   ``impl`` (and K3 for the Hybrid comparison format), held against a
   float64 scipy product within 1e-4, with the launch counters set to 0
   just before and read just after, and the plan cache showing one miss
   per matrix and hits after;
5. times (``core/timing.py``: one pair of CUDA events around many
   back-to-back launches, over their count; median of repeats after
   warmup) of each kernel, its plain version and one PyTorch sparse call
   computing the same function (CSR with int64 and with int32 indices;
   ``library_ms`` is the faster) — the card's time with the host's enqueue
   hidden behind a spin kernel (``ms``), the same after an L2 flush before
   each call (``cold_ms``), and what a caller of the launcher waits per
   call in a loop (``wait_ms``); whole calls of the main path with what
   their caller waits, their card time and their host time; all
   beside the least time the card could take (bytes over 3.35 TB/s, flops
   over 67 TFLOP/s fp32): ``bound_ms`` for what the kernel must read — for
   K1/K2 the slot rows of live segments that the plan's ``seg_slots``
   counts, for K3 the plan's stored slots — plus x, y and the plan's
   metadata, and ``nnz_bound_ms`` for the matrix's nonzeros alone;
6. serve: granite-3-2b at its published width and depth (40 layers) with
   the RgCSR FFN (density 0.25, G = 128, ``impl="kernel"``), random weights
   from ``SEED``, through ``Engine.generate`` — 4 prompts of 128 tokens, 32
   new tokens, ``max_seq`` 256.  K2's launch counter, set to 0 just before
   and read just after, must show one launch per layer for the prefill and
   for each of the 31 decode steps (40 × 32) and no other kernel of the
   port; each layer's plan is built once, at load.  In float32 (compute
   and KV cache) the same weights with every ``w_out`` as its dense
   equivalent (``torch.matmul``, TF32 off) must give prefill logits within
   1e-4 · (1 + max|logit|) and the same greedy tokens up to the first step
   whose top-2 margin in the dense run is below 1e-3 · max|logit|.  Then,
   in bfloat16 (the config's compute dtype): the prefill and decode times,
   tokens/s, what a caller of one decode step waits, the card's busy time
   of a prefill and of a decode step (``torch.profiler``), K2's share of
   it and the card's idle share of what the caller waits; K2 per layer at
   d = 4 and d = 512 against its bound, its plain version, the dense bf16
   product and the PyTorch CSR product; peak device memory;
7. session: the same model through ``Engine.serve`` — continuous batching
   on paged caches (16-token pages), the decode step one captured CUDA
   graph replayed up to ``decode_chunk`` (8) times per host sync.  (a) In
   float32 (compute and KV cache), 6 requests on 4 slots (prompts of
   48–200 tokens, 24–40 new, ``max_seq`` 320, 41 pages, so the prompt
   policy recompute-preempts) at chunk 8 and at chunk 1: every stream
   equal to ``Engine.generate`` of its request alone under the margin
   rule above, all completed, a preemption, fewer dispatches than steps
   at chunk 8.  (b) In bfloat16, 16 requests on 8 slots (prompts of
   64–256 tokens, 64 new, ``max_seq`` 512): K2's launch counter, set to 0
   just before and read just after, must show 40 launches per graph
   replay and per prefill, tallied apart around each fused dispatch and
   each prefill, with replays = decode steps; tokens/s, what a caller
   waits per decode step and per prefill, the card's busy time per decode
   step over one profiled chunk and its idle share, a 257-token prefill's
   times; K2 held against its plain version (fp32 and bf16) on layer 0's
   kept plan at d = 8 and at every prompt and recompute length the
   sessions prefilled; K2 at d = 8 against its bound; peak memory;
8. router: two replicas of the same model behind ``Router``, built with
   ``params=first.params`` (one model: weights, compute-dtype copies and
   K2 plans shared).  (a) In float32 (compute and KV cache), 2 replicas ×
   2 slots, 6 requests (prompts of 48–160 tokens, 16–24 new), replica 1
   killed by an injected fault at its decode step 2: every stream equal
   to ``Engine.generate`` of its request alone under the margin rule, one
   fault, a migration and a restart (the restarted replica keeps its
   graph); K2's launch counter, set to 0 just before and read just
   after, must show 40 launches per prefill and per graph replay of
   either replica; the fleet builds 40 plans; the second replica adds
   only its KV pool and loop state plus its graph's memory.  (b) In
   bfloat16, phase 7(b)'s 16 requests on 2 replicas × 4 slots: tokens/s
   beside phase 7(b)'s, per replica decode steps, dispatches and replays,
   what a caller waits per decode step, K2 launches as in (a); K2 held
   against its plain version at every width this phase ran that phase 7
   did not.  (c) ``launch.serve.main`` in-process on dense granite-3-2b:
   the failover drill with its Chrome trace validated and cross-checked
   against its metrics, the crash drill (every dead engine collected
   before the fleet is rebuilt, the rebuilt fleet's live tensors equal to
   the first's) and the page-corruption drill (one page quarantined, no
   failure), each returning 0;
9. tune: ``autotune_spmv`` on ``fem2d_2048`` and ``raj1_full`` and
   ``autotune_spmm`` on ``raj1_full`` at d = 64, from CSR, with the default
   candidate sets, every candidate timed on the card by ``torch.profiler``
   (one session per search): candidates, plans built, pruned and timed,
   the winner, ``baseline_us`` and ``speedup``, the search's host seconds,
   each candidate's time; the winner within 1e-4 of float64 scipy, its
   ``time_us(hold=True)`` beside its profiler time; a second search a memo
   hit with no K1/K2 launch; ``Engine.warm_spmv_plans([raj1_full])`` and
   then ``tuned_plan`` with no plan build.  The phase fails if any search
   is timed by anything but the profiler;
10. train (the reference trains its RgCSR FFN through the segment sum,
   ``impl="ref"``, and so does the port: no K2 runs here).  (a) One
   ``SparseLinear`` at granite-3-2b's ``w_out`` shape in fp32, 64 tokens:
   the gradients of ``values2d`` and of x within 1e-4 · (1 + Σ|·|) of the
   float64 dense equivalent's.  (b) ``launch/train.py --sparse-ffn`` on
   granite-3-2b at full width and depth: bf16 compute, fp32 parameters,
   AdamW, 4 steps of 4 × 128 tokens, every loss finite; per step the host
   ms (ending in a synchronize), tokens/s and peak memory; one more step
   under ``torch.profiler``: the card's busy time, its idle share and the
   top kernels.  (c) The fault drill at full width, depth cut to 2 layers,
   5 steps: checkpoints every 2 steps, a fault at step 3, just after the
   first checkpoint's asynchronous write; every loss within 5e-2 of
   an uninterrupted run from the same seed (``index_add_`` on CUDA is not
   bitwise repeatable), the last checkpoint restored into a new
   ``Trainer`` with parameters and moments bitwise equal;
11. mla: minicpm3-4b at its published width, depth cut from 62 to
   ``MLA_LAYERS`` = 4 layers (for the time limit; d_model
   2,560, 40 heads; MLA with q_lora 768, kv_lora 256, nope 64, rope 32,
   v 64; d_ff 6,400, vocab 73,448) with the RgCSR FFN (density 0.25,
   G = 128, ``impl="kernel"``: ``w_out`` is 20 groups of 1,600 slot rows),
   random weights from ``SEED``.  (a) ``Engine.generate`` of 4 prompts of
   128 tokens, 32 new, ``max_seq`` 256: K2's counter reads exactly layers
   × 32 and no other kernel of the port launches; in float32 (caches too) the
   prefill logits within 1e-4 · (1 + max|logit|) of the same weights with
   a dense-equivalent ``w_out`` (TF32 off) and greedy tokens identical
   under the margin rule; paged MLA decode (``ckv``/``krope`` pages, one
   slot) within 1e-5 · (1 + max|logit|) of the dense-layout decode for
   prompts of 49 and 48 tokens (16-token pages); in bfloat16 the prefill
   and decode times, tokens/s, the card's busy time of a prefill and of a
   decode step (``torch.profiler``) and K2's share; K2 at ``w_out`` held
   against its plain version and timed at d = 4, 8 and 512 against its
   bound, its plain version, the dense bf16 product and the CSR call;
   peak memory.  (b) ``Engine.serve`` on paged MLA caches, the decode step
   a CUDA graph, bf16: 16 requests on 8 slots (prompts of 64–256 tokens
   drawn from four lengths, 64 new each, ``max_seq`` 512): K2 reads
   exactly layers × (decode steps + prefills), replays = decode steps, every
   stream equal to ``generate`` of its prompt (each length's prompts as
   one batch) up to the first step whose top-2 margin in generate's run is
   below 3e-2 · max|logit| (the bf16 bar: a bf16 logit carries 8
   significant bits, and batch composition changes the rounding); grep
   ``^mla``;
12. moe: granite-moe-1b-a400m at its published width, its serving depth
   cut from 24 to ``MOE_LAYERS`` = 6 (for the time limit; its three
   AdamW steps run all 24) (d_model 1,024, 16/8 heads of 64, 32 experts top-8 of 512,
   einsum dispatch; the reference sparsifies no MoE FFN, so no K1–K3
   runs).  (a) float32: ``generate`` with phase 11's shapes through the
   einsum and the scatter dispatch, prefill logits within 1e-4 · (1 +
   max|logit|) and greedy tokens under the margin rule, no kernel of the
   port launched; at 2 layers of full width the card within 1e-4 · (1 +
   max|logit|) of the port's own CPU run on the same weights; bfloat16
   times, and one MoE layer's and its dispatch's (routing, dispatch and
   combine, without the experts' FFN) share of a decode step's busy time.
   (b) ``serve``: 16 requests on 8 slots with the graph, replays = decode
   steps, streams against ``generate`` as in 11(b).  (c) Three AdamW
   steps of 4 × 128 tokens through ``launch/train.py``, bf16 compute:
   ``ce``, ``load_balance`` and ``router_z`` finite, peak memory.  (d)
   deepseek-v3-671b at its smoke size only (its experts alone exceed one
   card): the dense prefix layer, sigmoid routing with a nonzero bias,
   the shared expert, MLA and MTP; the card's fp32 logits and loss terms
   within 1e-4 of the port's CPU run; grep ``^moe``;
13. recurrent: (a) recurrentgemma-9b at its published width, depth cut
   from 38 layers (two ``rec`` then 12 × (``attn_local``, ``rec``,
   ``rec``)) to ``RG_LAYERS`` = 5 (the two, then 1 period, for the
   time limit);
   d_model 4,096, MQA with 16 heads of 256, window 2,048, GeGLU d_ff
   12,288, vocab 256,000) with the RgCSR FFN (``w_out`` is 32 groups of
   3,072 slot rows), random weights from ``SEED``: in float32 (caches too)
   ``generate``'s prefill logits within 1e-4 · (1 + max|logit|) of the
   same weights with a dense-equivalent ``w_out`` and greedy tokens under
   the margin rule, and a 300-token prefill plus 8 decode steps within
   1e-4 · (1 + max|logit|) of one forward over the 308 tokens (the
   log-depth scan and the ring against the step recurrence); in bfloat16
   ``generate`` of 4 × 128 tokens, 32 new, with K2's counter at exactly
   layers × 32 and no other kernel of the port, its times, the card's busy
   time and K2's share; ``serve`` with the graph as in 11(b) (K2 = layers ×
   (decode steps + prefills), replays = decode steps, streams against
   ``generate``); a dead replay of the graph leaving every state bit for
   bit; K2 on layer 0's kept plan against its plain version at d ∈ {1,
   4, 8, 512} (fp32, bf16, and fp32 with the split forced at 8-row
   pieces) and timed at d = 4, 8, 512.  (b) mamba2-780m at its published
   width, depth cut from 48 SSD layers to ``MAMBA_LAYERS`` = 12 (for the
   time limit; d_model 1,536, 48 heads of 64, d_state 128, chunk
   256; no FFN, so no K1–K3): at 2 layers of full width the card's fp32
   prefill and decode logits within 1e-4 · (1 + max|logit|) of the port's
   CPU run; at that depth the 300 + 8 check above; bfloat16 ``generate``
   times and ``serve`` with the graph (no layer holds an index), every
   stream held to ``generate`` under the bf16 margin rule, and the dead
   replay, all at the reference's draw of the weights (each body layer's
   ``fan_in`` weights 1/√48 of the port's per-layer draw, as the
   reference's stacked init gives them); the gap between a prompt's
   prefill logits alone and in a batch of 4, at both draws in bf16 and
   fp32; the same sessions in float32 at the port's draw, every stream
   held to ``generate`` under the fp32 margin rule;
   three AdamW steps of 4 × 128 tokens through ``launch/train.py``,
   losses finite, peak memory; grep ``^recurrent``;
14. encdec: the encoder-decoder family and the vision frontend at their
   published sizes with the RgCSR FFN (phase 6's sparsity), random
   weights from ``SEED``, served as the reference serves them:
   ``Engine._prefill`` with the whole batch (frames or patch embeddings
   beside the tokens), then ``_sample`` and ``_decode`` per token, 32
   greedy tokens.  (a) seamless-m4t-medium (12 encoder + 12 decoder
   layers, d_model 1,024, 16 heads of 64, GeGLU d_ff 4,096, vocab 256,206
   padded to 256,256, tied; every ``w_out``, the encoder's too, 8 groups
   of 1,024 slot rows), 4 requests of 512 frames and 16 tokens: in
   float32 (caches too) the prefill logits within 1e-4 · (1 + max|logit|)
   of the same weights with dense-equivalent ``w_out``s and greedy tokens
   under the margin rule; a prefill of 16 tokens and 8 decode steps
   against one forward over the 24; at 2 + 2 layers of full width the
   card against the port's CPU run; in bfloat16 K2's counter at exactly
   24 for the prefill and 12 per decode step (396) and no other kernel,
   the prefill's and a decode step's times for a caller and on the card
   (``torch.profiler``) with K2's share; three AdamW steps of 4 × 128
   frames and tokens through ``launch/train.py --sparse-ffn``.  (b)
   pixtral-12b (40 layers, cut to ``VLM_LAYERS`` = 5; d_model 5,120,
   32/8 heads of 128, SwiGLU d_ff
   14,336, vocab 131,072, ``frontend_proj`` 1,024 → 5,120; ``w_out`` 40
   groups of 3,584 slot rows), 2 requests of 1,024 patches and 64 tokens,
   ``max_seq`` 1,120: its memory plan reckoned from the spec and logged
   before anything is allocated; the float32 check against the
   dense-equivalent ``w_out`` at full depth when the reckoned peak stays
   under 72 GiB, else at 4 layers; in bfloat16 K2 at exactly 5 × 32 =
   160, times and K2's share as in (a); peak memory.  K2 on layer 0's
   kept plan against its plain version (fp32, bf16, and fp32 with the
   split forced at 8-row pieces) at seamless's d ∈ {1, 4, 64, 2,048} and
   pixtral's d ∈ {1, 2, 2,176}, then timed at the widths the main paths
   ran beside its bound, its plain version, the CSR call and the dense
   bf16 product; grep ``^encdec``;
15. shard: row-sharded SpMV/SpMM over ``torch.distributed``
   (``core.spmv``/``spmm`` with ``mesh=``).  (a) One rank on NCCL in this
   process, a ``("model",)`` mesh of 1: both matrices, both x modes,
   block and adaptive spill64, SpMV and SpMM at d = 64 — the one-shard
   plan's arrays equal the single-device plan's, K1/K2's outputs and
   the block results equal the single-device ones bit for bit (the
   adaptive ones within 1e-5: the spill tail adds with atomics), one
   launch per call, no exchange.  (b) ``SHARD_WORLD`` = 4 ranks spawned
   (``torch.multiprocessing``, ``spawn``) on cuda:0 over gloo — the card's
   machine shows one card and NCCL refuses two ranks on one device;
   the kernels were built here first, the ranks load them.  On a
   ``("model",)`` mesh of 4, fem2d_2048 (1,048,576 rows a shard) and
   raj1_full (65,936 rows a shard, the last 65,935) in both x modes with
   block and per-shard configs: the launch counters, set to 0 just before
   each matrix's runs, read 4 K1 and 4 K2 launches on every rank; each
   shard's rows within 1e-4 of float64 scipy and 1e-5 of the single-device
   K1/K2 (the SpMV and raj1's SpMM also gathered across the ranks); each
   kernel against its plain version on every shard's plan; fem2d's exact
   geometry (8,388,608 stored slots a shard replicated; 2,048 / 4,096 /
   4,096 / 2,048 remote columns, ``e_max`` 2,048, 8,192 / 16,384 fp32
   exchange bytes split); per shard its stored slots, steps, live slot
   rows, remote columns and received entries; the bytes the rank holds
   on the card (its shard's view alone: the sharded matrices and the
   stacked plans stay on the host); each rank's K1/K2 times with the card
   to itself (one rank at a time) against the bound of the shard's live
   slots (``bound_ms``), that of its nonzeros alone (``nnz_bound_ms``)
   and the CSR call on its rows; the gloo exchange's
   wall time (host-staged on one card: no multi-card figure).  (c) On the
   same ranks, ``Engine.warm_spmv_plans(mesh=)`` of raj1_full in split
   mode on the profiler's clock (the ranks' searches one at a time): the
   shard winners logged, the four plans' fingerprints equal; on a (2, 2)
   ``("data", "model")`` mesh (without per-shard searches) a new 2-shard
   plan, equal on every rank.
   fem2d's per-shard configs come from ``autotune_spmv_per_shard``
   across the ranks; grep ``^shard``;
16. train16: sharded training, no kernel on its path (the RgCSR FFN
   trains through the segment sum, as the reference's does).
   granite-3-2b at full width (d_model 2,048, vocab 49,155), depth cut
   to ``TRAIN16_LAYERS`` = 2, fp32, three AdamW steps of 4 × 128 tokens
   with ``micro=2``: first on one device here, then on a ``(2, 2)``
   ``("data", "model")`` mesh of 4 ranks spawned on cuda:0 over gloo
   (``Trainer(mesh=, partitioner=)``; lines ``train16 rN:`` are rank
   N's).  (a) every loss within 1e-4 relative of one device; (b) each
   rank's bytes at rest (parameters and both moments) equal to what its
   placements predict, beside one device's, and the leaves that fall back
   to replicated; (c) the final checkpoint restored onto ``(1, 4)`` on
   the same ranks and onto a ``(2,)`` mesh of 2 new ranks, every slice
   bitwise; (d) per step the host seconds, the collectives' wall share
   and tokens/s (gloo host-staged on one card: no multi-card figure);
   (e) ``launch/train.py --mesh 2x2 --sparse-ffn --layers 2`` on 4
   processes of its own (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
   ``--backend gloo``) to its ``done:`` line; (f) in the same ranks,
   granite-moe-1b-a400m at full width (d_model 1,024, 32 experts top-8 of
   512, vocab 49,155), depth cut to ``TRAIN16_MOE_LAYERS`` = 2, fp32, the
   same three AdamW steps: each rank routes its rows with the whole
   microbatch's capacity, positions and aux terms (its per-expert counts
   all-gathered as int32); losses, ``ce``, ``load_balance`` and
   ``grad_norm``, and on the first batch the final model's load-balance
   and z-loss terms within 1e-5 relative of one device and its expert
   fractions within 1e-5; each rank's bytes at rest against its
   placements; per step the collectives' share; (g) in the same ranks,
   tensor-parallel compute over ``model`` (``act_shard``: each rank
   holds and computes its slice of the heads, FFN lanes, experts and
   vocabulary): granite-3-2b with the RgCSR FFN on (2, 2) (``heads``),
   again under remat ``full``, and on ``(1, 4)``, and granite-moe on
   (2, 2) (expert-parallel), the same three steps: losses within
   ``TRAIN16_TOL`` (granite) and ``TRAIN16_MOE_TOL`` (MoE) relative of
   one device; per rank ``max_memory_allocated`` over a step for (a)'s
   gather-at-use and for each tensor-parallel run, the phase failing
   unless the (2, 2) tensor-parallel peak is below gather-at-use's on
   every rank; per step the collectives' bytes by kind (all-gather,
   reduce-scatter, all-reduce; by mesh axis), host seconds and tokens/s;
   (e)'s launcher now runs tensor-parallel; grep ``^train16``; (h) a
   spawn of its own after those: the recurrent mixers tensor-parallel
   (Mamba-2's SSD heads, RG-LRU's channels split over ``model``) on the
   same mesh, fp32, AdamW, the same three steps, each run's memory
   released before the next: mamba2-780m at full width (d_model 1,536,
   48 SSD heads of 64), depth cut to ``TRAIN16H_MAMBA_LAYERS``, its
   losses and ``grad_norm`` within ``TRAIN16_TOL`` relative of one device
   (run in this process first) and its peak below gather-at-use's (run in
   the same ranks) on every rank; recurrentgemma-9b at full width
   (d_model 4,096, vocab 256,000), depth cut to ``TRAIN16H_RG_LAYERS``
   (``rec``, ``rec``) with the RgCSR FFN, tensor-parallel only (one
   device and gather-at-use do not fit four ranks on one card), its
   losses finite; after the steps each rank holds layer 0's mixer of
   both models, split, against itself whole (its leaves gathered for the
   check alone) on a full-width (4, 128, d_model) input: the output and
   the gradients of the input and every leaf within
   ``TRAIN16H_UNIT_TOL`` of the whole's largest value; for the
   tensor-parallel runs each rank's peak within the dry run's prediction
   (``launch/dryrun.py::step_cost`` on a fake (2, 2) rank 0, run on the
   host after phase 10) + ``TRAIN16H_PEAK_SLACK``, rank 0's collective
   bytes by kind and mesh axis equal to the fake rank 0's, and no
   parameter all-gathered over ``model`` (a spy on the step's parameter
   gathers); before the spawn the card's free memory against four ranks'
   largest predicted peak plus a CUDA context each, the phase failing
   (never skipping) where they do not fit; grep ``^train16 (h)``;
17. remat: phase 16's granite-3-2b on one device, 4 × 256 tokens a
   batch, from the same seed under each of ``remat`` ``none``, ``full``
   and ``dots`` (the matrix products' outputs kept, the rest
   recomputed), with the RgCSR FFN (its segment sum is no matrix
   product) and then with the dense FFN: the first batch's loss and
   backward, their losses equal within 1e-6 relative, the memory the
   forward holds for the backward (the activations remat trades) and
   their peak, then two AdamW steps, the whole step's peak and the
   second, warm step's host ms; grep ``^remat``;
18. twins: ``examples/torch_quickstart.py``, ``torch_spmv_suite.py``
   (without ``--full``), ``torch_serve_lm.py`` and ``torch_train_lm.py
   --steps 20`` dense then ``--sparse``, each through its ``main(argv)``
   with ``--device cuda`` in this process, their own asserts holding
   (the kernel against the CSR oracle, every request done, the loss
   falling); the launch counters, set to 0 just before and read just
   after, show K1 and K3 launched; grep ``^twins``;
19. dryrun: the dry run (``launch/dryrun.py``: one training step on
   ``meta`` tensors over a fake process group, counted by
   ``launch/hlo_cost.py``; no kernel, no card), its processes started
   on the host after phase 10 and collected here.  (a) granite-3-2b
   ``train_4k`` on (16, 16) and granite-moe-1b-a400m ``train_4k`` on
   (2, 16, 16) through ``python -m repro_torch.launch.dryrun``: each
   record ``ok`` with finite, positive roofline terms (predictions from
   ``launch.mesh.HW``'s H100 figures), its seconds and HBM GiB a device.
   (b) Phase 16 (g)'s tensor-parallel cell (granite-3-2b, 2 layers, (2,
   2), ``micro=2``, 4 × 128 tokens) on a fake (2, 2) mesh: rank 0's
   collective bytes by kind and mesh axis equal to what phase 16 (g)'s
   rank 0 measured in this run, exactly (both read the sharding layer's
   collective log); the predicted peak a rank beside the measured one;
   the roofline's lower bound not above the fastest measured step.  (c)
   The same for phase 10's one-device granite-3-2b step (peak and step
   time from phase 10 (b)).  (d) Phase 20's granite-3-2b serving cell on
   a fake (2, 2) mesh (``launch/dryrun.py::serve_cost``): its prefill's
   and a decode step's collective bytes on rank 0, by kind and mesh
   axis, equal to what phase 20's gloo rank 0 moved, exactly; grep
   ``^dryrun``;
20. serve20, serving on a mesh (``launch.steps.make_prefill_step`` /
   ``make_decode_step`` with ``partitioner=``), in phase 16 (h)'s spawn
   after its training runs (the same four gloo ranks sharing cuda:0 on
   a (2, 2) ``("data", "model")`` mesh; one-device runs in this process
   before the spawn), checked here after phase 19: granite-3-2b at full
   width (d_model 2,048, 32 heads / 8 kv of 64, vocab 49,155), depth cut
   to ``SERVE20_LAYERS`` = 2, the RgCSR FFN through K2 on each rank's
   64-lane plan (``impl="kernel"``), fp32 (caches too): a prefill of
   ``SERVE20_BATCH`` × ``SERVE20_PROMPT`` = 4 × 128 tokens and
   ``SERVE20_STEPS`` = 8 decode steps fed the one-device greedy tokens;
   each rank's rows of the logits within 1e-4 · (1 + max|logit|) of
   ``make_prefill_step`` / ``make_decode_step`` on one device, its greedy
   tokens equal under the margin rule, its cache slices (after the
   prefill and after the last step) within 1e-4 of the matching slices
   of the one-device caches; K2's counter, set to 0 just before and read
   just after, at exactly layers × (1 + steps) on every rank and one
   lane plan a layer; each rank's lane plan against K2's plain version
   (fp32 1e-5, bf16 3e-2) at the prefill's d = 2 · 128 and a decode
   step's d = 2.  On the same ranks mamba2-780m (2 layers) and
   recurrentgemma-9b (``rec``, ``rec``, K2 lanes) at full width: a
   prefill of 4 × 32 tokens and 4 decode steps with their states split
   (``ssm`` over heads, ``conv`` over channels, ``h`` over ``d_rnn``),
   held the same way.  Then, with the card to this process, K2 on rank
   0's lane plan (64 of 128 lanes) of granite's ``w_out`` at both widths
   beside its bound, its plain version and the CSR call; grep
   ``^serve20``;
21. a ``{"kernels": [...]}`` line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Every tolerance ``tol`` above is applied per output element as
``|got - want| <= tol · (1 + Σ_j |a_ij · x_j|)``: the rounding error of a
sum grows with the size of its terms, not with the size of the result, and
Raj1's dense rows sum 39,567 terms whose total cancels to a fraction of
their size.  Where no cancellation happens this is rtol = atol = tol.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import weakref
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
DEVICE = "cuda"
# torch.profiler sessions tried before a run without device kernels fails
PROFILER_SESSIONS = 3
SEED = 0
D_SPMM = 64
FP32_TOL, BF16_TOL, MAIN_TOL = 1e-5, 3e-2, 1e-4
# the serve phase: granite-3-2b with the RgCSR FFN
SERVE_ARCH = "granite-3-2b"
SERVE_SPARSITY = dict(enabled=True, density=0.25, group_size=128,
                      impl="kernel")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 4, 128, 32, 256
# the session phase: (n requests, prompt lengths lo, hi, new lo, hi)
SESS_PAGE, SESS_CHUNK = 16, 8
SESS_A_MIX, SESS_A_SLOTS, SESS_A_MAX_SEQ, SESS_A_PAGES = (
    (6, 48, 200, 24, 40), 4, 320, 41)
SESS_B_MIX, SESS_B_SLOTS, SESS_B_MAX_SEQ = (16, 64, 256, 64, 64), 8, 512
# the router phase: (a) fp32 failover drill, (b) bf16 fleet (phase 7(b)'s
# requests; 2 replicas x 4 slots match its 8 slots)
ROUTER_A_MIX, ROUTER_A_SLOTS, ROUTER_A_MAX_SEQ = (6, 48, 160, 16, 24), 2, 192
ROUTER_B_SLOTS = 4
LOGIT_TOL, MARGIN_TOL = 1e-4, 1e-3
# the training phase: the launcher's --sparse-ffn (the segment sum, as the
# reference trains), granite-3-2b at full width and depth; the fault drill
# at full width, depth cut to DRILL_LAYERS
TRAIN_SPARSITY = dict(SERVE_SPARSITY, impl="ref")
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_T = 4, 128, 4, 64
# (steps cut from 7 with the fault from step 5, and depth, for the time
# limit)
DRILL_LAYERS, DRILL_STEPS, DRILL_FAULT, DRILL_CKPT = 2, 5, 3, 2
REPLAY_TOL = 5e-2
# phase 11: minicpm3-4b (MLA) with the RgCSR FFN; phase 12: granite-moe
# and deepseek-v3's smoke config.  Sessions: FAM_MIX = (requests, new
# tokens), prompt lengths drawn from FAM_LENS, FAM_SLOTS slots.
MLA_ARCH, MOE_ARCH, DEEPSEEK_ARCH = ("minicpm3-4b", "granite-moe-1b-a400m",
                                     "deepseek-v3-671b")
# minicpm3-4b's depth, cut from 62 so that the script keeps its time limit
# with phases 15 and 16; granite-moe-1b-a400m's serving depth from 24
MLA_LAYERS, MOE_LAYERS = 4, 6
FAM_MIX, FAM_LENS, FAM_SLOTS, FAM_MAX_SEQ = (16, 64), (64, 128, 192, 256), \
    8, 512
FAM_K2_WIDTHS = (SERVE_BATCH, FAM_SLOTS, SERVE_BATCH * SERVE_PROMPT)
FAM_PAGED_LENS = (SESS_PAGE * 3 + 1, SESS_PAGE * 3)
FAM_PAGED_STEPS, FAM_PAGED_MAX_SEQ = 4, 64
MOE_CPU_LAYERS, MOE_TRAIN_STEPS = 2, 3
# phase 13: recurrentgemma-9b with the RgCSR FFN and mamba2-780m; a
# prefill of REC_LONG tokens (two SSD chunks, the second ragged) then
# REC_STEPS decode steps against one forward; K2 at recurrentgemma's w_out
# also with the split forced at REC_PIECE_ROWS
REC_RG_ARCH, REC_MAMBA_ARCH = "recurrentgemma-9b", "mamba2-780m"
# recurrentgemma-9b's depth, cut from 38 (rec, rec + 12 × (attn_local, rec,
# rec)) to the prefix and 1 period, and mamba2-780m's from 48, for the
# time limit
RG_LAYERS, MAMBA_LAYERS = 5, 12
REC_LONG, REC_STEPS, REC_CPU_LAYERS, REC_TRAIN_STEPS = 300, 8, 2, 3
REC_K2_WIDTHS = (1,) + FAM_K2_WIDTHS
REC_PIECE_ROWS = 8
# phase 14: seamless-m4t-medium (ENC_BATCH requests of ENC_FRAMES frames and
# ENC_PROMPT tokens; a prefill of ENC_PROMPT then ENC_STEPS decode steps
# against one forward; ENC_CPU_LAYERS + ENC_CPU_LAYERS layers against the
# CPU) and pixtral-12b (VLM_BATCH requests of its 1,024 patches and
# VLM_PROMPT tokens), each SERVE_NEW greedy tokens.  pixtral's fp32 check
# runs at full depth when its reckoned peak (VLM_ACT_BYTES for activations)
# stays under VLM_PEAK_GIB, else at VLM_CUT_LAYERS layers
ENC_ARCH, VLM_ARCH = "seamless-m4t-medium", "pixtral-12b"
ENC_BATCH, ENC_FRAMES, ENC_PROMPT, ENC_MAX_SEQ = 4, 512, 16, 64
ENC_STEPS, ENC_CPU_LAYERS, ENC_TRAIN_STEPS = 8, 2, 3
VLM_BATCH, VLM_PROMPT = 2, 64
VLM_PEAK_GIB, VLM_ACT_BYTES, VLM_CUT_LAYERS = 72, 4 * 2**30, 4
# pixtral-12b's depth, cut from 40 so that the script keeps its time limit
# with phase 16
VLM_LAYERS = 5
# phase 15: SHARD_WORLD ranks share the card over gloo; a rank's collective
# gives up after SHARD_TIMEOUT_S, the phase after SHARD_DEADLINE_S
SHARD_WORLD, SHARD_TIMEOUT_S, SHARD_DEADLINE_S = 4, 240, 360
# phase 16: sharded training of granite-3-2b at full width, its depth cut
# to TRAIN16_LAYERS, on a TRAIN16_MESH (data, model) mesh of gloo ranks
# sharing the card; losses within TRAIN16_TOL relative of one device
TRAIN16_MESH, TRAIN16_LAYERS, TRAIN16_STEPS, TRAIN16_MICRO = (2, 2), 2, 3, 2
TRAIN16_TOL, TRAIN16_DEADLINE_S = 1e-4, 540
# phase 16 also trains granite-moe-1b-a400m at full width, its depth cut to
# TRAIN16_MOE_LAYERS, in the same ranks: losses and aux terms within
# TRAIN16_MOE_TOL relative of one device
TRAIN16_MOE_LAYERS, TRAIN16_MOE_TOL = 2, 1e-5
# phase 16 (h): the recurrent mixers tensor-parallel on TRAIN16_MESH, a
# spawn of its own ended after TRAIN16H_DEADLINE_S: mamba2-780m at full
# width, depth cut to TRAIN16H_MAMBA_LAYERS (against one device within
# TRAIN16_TOL, and gather-at-use), recurrentgemma-9b at full width, depth
# cut to TRAIN16H_RG_LAYERS (its pattern's prefix, rec and rec); each
# layer-0 mixer split against whole within TRAIN16H_UNIT_TOL, each rank's
# peak within the dry run's prediction + TRAIN16H_PEAK_SLACK
TRAIN16H_MAMBA_LAYERS, TRAIN16H_RG_LAYERS, TRAIN16H_DEADLINE_S = 4, 2, 360
TRAIN16H_UNIT_TOL, TRAIN16H_PEAK_SLACK = 1e-5, 0.10
# (h)'s Adam eps, as the tensor-parallel parity tests run it: at 1e-8 an
# element whose gradient is rounding noise (~1e-7) takes a first update of
# ~lr whose sign follows that noise, and later steps part from one device
TRAIN16H_EPS = 1e-5
# phase 20: serving on TRAIN16_MESH in phase 16 (h)'s ranks: granite-3-2b
# at full width cut to SERVE20_LAYERS with K2 on each rank's lanes, a
# prefill of SERVE20_BATCH x SERVE20_PROMPT tokens and SERVE20_STEPS decode
# steps; mamba2-780m (SERVE20_LAYERS) and recurrentgemma-9b (rec, rec), a
# prefill of SERVE20_BATCH x SERVE20_REC_PROMPT and SERVE20_REC_STEPS
# steps; logits and caches within MAIN_TOL of one device
SERVE20_LAYERS, SERVE20_BATCH, SERVE20_PROMPT, SERVE20_STEPS = 2, 4, 128, 8
SERVE20_REC_PROMPT, SERVE20_REC_STEPS = 32, 4
# phase 17: one train step of phase 16's granite-3-2b on one device under
# each remat, TRAIN17_BATCH x TRAIN17_SEQ tokens, after a warm step
TRAIN17_BATCH, TRAIN17_SEQ, TRAIN17_TOL = 4, 256, 1e-6
# phase 18: the four example twins, in process: (example, arguments)
TWIN_TRAIN_STEPS = 20
TWIN_RUNS = (("torch_quickstart", ()), ("torch_spmv_suite", ()),
             ("torch_serve_lm", ()),
             ("torch_train_lm", ("--steps", str(TWIN_TRAIN_STEPS))),
             ("torch_train_lm", ("--steps", str(TWIN_TRAIN_STEPS),
                                 "--sparse")))

# phase 19: the dry run's production cells (arch, multi-pod); each of its
# subprocesses, started after phase 10, is killed DRYRUN_TIMEOUT_S after
# its start
DRYRUN_CELLS = (("granite-3-2b", False), ("granite-moe-1b-a400m", True))
DRYRUN_TIMEOUT_S = 600

KERNEL_META = {
    "rgcsr_spmv": ("src/repro_torch/kernels/csrc/rgcsr_spmv.cu",
                   "src/repro/kernels/rgcsr_spmv.py:82"),
    "rgcsr_spmm": ("src/repro_torch/kernels/csrc/rgcsr_spmm.cu",
                   "src/repro/kernels/rgcsr_spmm.py:44"),
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:25"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


_PHASE = {"name": None, "start": 0.0, "run": None}


def card_memory() -> str:
    """The card's free and total memory (``torch.cuda.mem_get_info``)."""
    try:
        import torch
        free, total = torch.cuda.mem_get_info()
    except Exception as err:          # noqa: BLE001 — a line, not a check
        return f"card memory unknown ({type(err).__name__})"
    return f"card {free / 2**30:.2f} GiB free of {total / 2**30:.2f}"


def phase(name=None) -> None:
    """End the running phase with its end line and start ``name`` (None:
    no other) with its start line, each flushed with the seconds since the
    run's first phase and the card's free memory: a run that stops names
    the phase it stopped in (:func:`stopped`)."""
    now = time.perf_counter()
    if _PHASE["run"] is None:
        _PHASE["run"] = now
    run = now - _PHASE["run"]
    if _PHASE["name"] is not None:
        log(f"phase {_PHASE['name']} end: {now - _PHASE['start']:.1f} s, "
            f"{run:.1f} s into the run; {card_memory()}")
    _PHASE.update(name=name, start=now)
    if name is not None:
        log(f"phase {name} start: {run:.1f} s into the run; "
            f"{card_memory()}")


def stopped() -> str:
    """Where the run stopped: the running phase, its seconds and the
    card's free memory."""
    if _PHASE["name"] is None:
        return "before any phase started"
    now = time.perf_counter()
    return (f"in phase {_PHASE['name']}, {now - _PHASE['start']:.1f} s "
            f"into it and {now - _PHASE['run']:.1f} s into the run; "
            f"{card_memory()}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


# ------------------------------------------------------------------ matrices


def fem2d_csr(nx: int, ny: int):
    """5-point Laplacian on an nx×ny grid (``suite._fem2d``'s recipe)."""
    import scipy.sparse as sp
    n = nx * ny
    r = np.arange(n, dtype=np.int64)
    i, j = r // ny, r % ny
    parts = [(r, r, np.full(n, 4.0, np.float32))]
    for ok, off in ((i > 0, -ny), (i < nx - 1, ny), (j > 0, -1),
                    (j < ny - 1, 1)):
        parts.append((r[ok], r[ok] + off, np.full(ok.sum(), -1.0, np.float32)))
    rows, cols, vals = (np.concatenate(p) for p in zip(*parts))
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    a.sort_indices()
    return a


def raj1_csr(n: int = 263743, seed: int = 1, n_dense_rows: int = 4,
             dense_frac: float = 0.15, base_deg: int = 4):
    """Near-diagonal rows plus a few 15 %-dense rows (``suite._circuit``'s
    recipe with the ``raj1_twin`` parameters, drawn vectorised)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    lo = np.maximum(0, i - 3 * base_deg)
    width = np.minimum(n, i + 3 * base_deg) - lo
    k = np.minimum(np.maximum(1, rng.poisson(base_deg, n)), width)
    w = 6 * base_deg
    keys = rng.random((n, w))
    keys[np.arange(w)[None, :] >= width[:, None]] = 2.0   # outside the window
    pick = np.argsort(keys, axis=1)[np.arange(w)[None, :] < k[:, None]]
    rows = np.repeat(i, k)
    cols = lo[rows] + pick
    vals = rng.uniform(0.1, 1.0, len(rows)).astype(np.float32)
    off_diag = cols != rows
    rows = np.concatenate([rows[off_diag], i])
    cols = np.concatenate([cols[off_diag], i])
    vals = np.concatenate([vals[off_diag], np.ones(n, np.float32)])
    for r in rng.choice(n, size=n_dense_rows, replace=False):
        dc = rng.choice(n, size=int(dense_frac * n), replace=False)
        keep = ~((rows == r) & np.isin(cols, dc))
        rows = np.concatenate([rows[keep], np.full(len(dc), r)])
        cols = np.concatenate([cols[keep], dc])
        vals = np.concatenate([vals[keep], rng.uniform(0.1, 1.0, len(dc))
                               .astype(np.float32)])
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    a.sort_indices()
    return a


def main_inputs(fem_csr, raj_csr):
    """``(rng, x, X)``: the main path's x ``(n,)`` and X ``(n, D_SPMM)`` per
    matrix, float32, drawn from ``SEED``, and the generator, whose later
    draws go on from there."""
    rng = np.random.default_rng(SEED)
    x_np = {"fem2d_2048": rng.standard_normal(fem_csr.shape[1])
            .astype(np.float32),
            "raj1_full": rng.standard_normal(raj_csr.shape[1])
            .astype(np.float32)}
    xm_np = {k: rng.standard_normal((len(v), D_SPMM)).astype(np.float32)
             for k, v in x_np.items()}
    return rng, x_np, xm_np


def ell_head_csr(a, k1: int):
    """The first ``k1`` entries of every row (the ELL part of Hybrid)."""
    import scipy.sparse as sp
    lens = np.diff(a.indptr)
    slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], lens)
    keep = slot < k1
    ptr = np.concatenate([[0], np.cumsum(np.minimum(lens, k1))])
    return sp.csr_matrix((a.data[keep], a.indices[keep], ptr), shape=a.shape)


def dense_equivalent(layer):
    """W (d_out, d_in) float32 of a ``SparseLinear`` layer, from its
    slot-major arrays (slot row k of group g holds W[g·G + lane,
    columns[k, lane]])."""
    import torch
    s, g = layer.values2d.shape
    rows = (layer.chunk_group.long().repeat_interleave(8)[:, None] * g
            + torch.arange(g, device=layer.values2d.device)).reshape(-1)
    w = torch.zeros((-(-layer.d_out // g) * g, layer.d_in),
                    dtype=torch.float32, device=layer.values2d.device)
    w.index_put_((rows, layer.columns2d.reshape(-1).long()),
                  layer.values2d.detach().reshape(-1).float(),
                  accumulate=True)
    return w[: layer.d_out]


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def device_kernels(fn, calls: int):
    """``torch.profiler`` over ``calls`` calls of ``fn`` (after one
    warmup): per kernel name, launches and device µs per call.  A session
    that records no device kernel at all (the card's CUPTI does so now
    and then) is run again, up to ``PROFILER_SESSIONS`` in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue                       # host-side ops and API calls
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            out[ev.key] = (ev.count / calls, us / calls)
        if out:
            return out
        log(f"torch.profiler recorded no device kernel in a session of "
            f"{calls} calls; profiling again")
    raise RuntimeError(f"torch.profiler recorded no device kernel in "
                       f"{PROFILER_SESSIONS} sessions")


def live_cuda(top: int = 4) -> str:
    """The card's allocated memory and its largest live storages, grouped
    by (shape, dtype) of a tensor that holds each: what one phase leaves
    to the next."""
    import torch
    gc.collect()
    seen, groups = set(), collections.Counter()
    for obj in gc.get_objects():
        try:
            if not (torch.is_tensor(obj) and obj.is_cuda):
                continue
            st = obj.untyped_storage()
        except Exception:                  # noqa: BLE001 — a stray object
            continue
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            groups[(tuple(obj.shape), str(obj.dtype))] += st.nbytes()
    big = ", ".join(f"{n / 2**30:.2f} GiB as {shape} {dt}"
                    for (shape, dt), n in groups.most_common(top))
    owners = collections.Counter()
    for obj in gc.get_objects():
        if type(obj).__name__ in ("LanguageModel", "Engine",
                                  "EngineSession", "Router"):
            refs = [type(r).__name__ for r in gc.get_referrers(obj)
                    if type(r).__name__ != "frame"]
            owners[f"{type(obj).__name__} <- {','.join(sorted(refs))}"] += 1
    return (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
            f"largest live storages: {big}; live models and engines: "
            f"{dict(owners) or 'none'}")


def greedy_trace(model, tokens, s_max: int, n_new: int, vocab: int):
    """Greedy decoding of ``model`` (prefill + ``n_new - 1`` decode steps)
    with, per step, the tokens, the smallest top-2 logit margin over the
    batch and the largest |logit|."""
    import torch
    toks, margins, peaks = [], [], []
    with torch.inference_mode():
        logits, caches = model.prefill({"tokens": tokens}, s_max)
        for step in range(n_new):
            last = logits[:, -1, :vocab].float()
            top2 = torch.topk(last, 2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).min().item())
            peaks.append(last.abs().max().item())
            tok = last.argmax(-1).int()[:, None]
            toks.append(tok)
            if step + 1 < n_new:
                logits, caches = model.decode_step(caches, tok)
    return torch.cat(toks, 1).cpu().numpy(), margins, peaks


def card_ms(fn, calls, dev, **kw):
    """Per call of ``fn``: the time a caller waits (no keyword), the card's
    time with the host hidden (``hold=True``), or from HBM after an L2
    flush (``cold=True``) — see ``core/timing.py``."""
    from repro_torch.core.timing import time_us
    return time_us(fn, calls=calls, device=dev, **kw) / 1e3


def bound(nbytes, flops, peak=FP32_FLOPS_PER_S):
    """The least time in ms for ``nbytes`` of memory traffic and ``flops``
    operations, and which of the two bounds it."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def sparse_csr(a, dev, index_dtype=np.int64):
    import torch
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(index_dtype)),
        torch.from_numpy(a.indices.astype(index_dtype)),
        torch.from_numpy(a.data), size=a.shape).to(dev)


def library_times(a, operand, calls, dev):
    """The PyTorch CSR product on ``a`` with int64 and int32 indices: card
    time warm and cold, per index type."""
    out = {}
    for tag, dt in (("int64", np.int64), ("int32", np.int32)):
        a_t = sparse_csr(a, dev, dt)
        try:
            out[tag] = (card_ms(lambda: a_t @ operand, calls, dev, hold=True),
                        card_ms(lambda: a_t @ operand, calls, dev, cold=True))
        except RuntimeError as err:     # a yardstick only
            log(f"library {tag} indices: {err}")
        del a_t
    return out


# ------------------------------------------------- phase 15: sharded ranks


def _float64_rows(a, xv, lo, hi):
    """``(a[lo:hi] @ xv, |a[lo:hi]| @ |xv|)`` in float64, on the host,
    reading only the rows of ``xv`` that the rows' columns reference."""
    import scipy.sparse as sp
    rows = a[lo:hi]
    cols = np.unique(rows.indices)
    sub = sp.csr_matrix((rows.data.astype(np.float64),
                         np.searchsorted(cols, rows.indices), rows.indptr),
                        shape=(rows.shape[0], len(cols)))
    x64 = xv[cols].astype(np.float64)
    return sub @ x64, abs(sub) @ abs(x64)


def _shard_checks(say, failures, label, got, want, scale, single):
    """``got`` (card tensor): rows of ``a @ x`` held against float64 scipy
    (``want``) within MAIN_TOL and against the single-device K1/K2 rows
    ``single`` within FP32_TOL, each per element as ``tol · (1 + scale)``,
    ``scale`` = Σ_j |a_ij x_j|."""
    g = got.double().cpu().numpy()
    for what, ref, tol in (("float64 scipy", want, MAIN_TOL),
                           ("single-device", np.asarray(single), FP32_TOL)):
        ok = g.shape == ref.shape and bool(np.all(
            np.abs(g - ref) <= tol * (1 + scale)))
        err = float(np.abs(g - ref).max()) if g.size else 0.0
        say(f"{label}: max_abs_err vs {what} {err:.3e} (tol {tol:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} vs {what}")


def shard_rank(rank, world, tmp, timeout_s):
    """Phase 15 (b) and (c): rank ``rank`` of ``world`` ranks that share
    cuda:0 over gloo, spawned by :func:`sharded_phase` after the kernels
    were built; writes its entries and failures to
    ``tmp/rank<rank>.json``."""
    import datetime
    import logging
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke
    from repro_torch.core import ShardedRgCSR, spmm, spmv
    from repro_torch.kernels import (autotune, launch_counts, ops,
                                     reset_launch_counts)
    from repro_torch.kernels.rgcsr_spmm import (rgcsr_spmm_launch,
                                                rgcsr_spmm_plain)
    from repro_torch.kernels.rgcsr_spmv import (rgcsr_spmv_launch,
                                                rgcsr_spmv_plain)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import Engine, ServeConfig

    def say(msg):     # one write per line: the ranks share stdout
        os.write(1, f"shard r{rank}: {msg}\n".encode())

    warnings.filterwarnings("ignore", message="Sparse")   # beta notices
    warnings.filterwarnings("ignore", message="Warning: Profiler clears")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(f"shard r{rank}: %(message)s"))
    logging.getLogger("repro_torch").addHandler(handler)
    logging.getLogger("repro_torch").setLevel(logging.INFO)
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    failures, out = [], {"entries": {}, "launches": {}, "errs": {}}
    t0 = time.perf_counter()
    try:     # a rank that raises fails the spawn, which ends the others
        # the profiler's probe (its first session starts CUPTI, slowly) on
        # every rank at once; the searches below take turns
        source = autotune.timing_source()
        csr = {"fem2d_2048": fem2d_csr(2048, 2048), "raj1_full": raj1_csr()}
        _, x_np, xm_np = main_inputs(csr["fem2d_2048"], csr["raj1_full"])
        x = {k: torch.from_numpy(v).to(dev) for k, v in x_np.items()}
        xm = {k: torch.from_numpy(v).to(dev) for k, v in xm_np.items()}
        tuples = {k: (a.data, a.indices, a.indptr, a.shape)
                  for k, a in csr.items()}
        mesh = make_mesh((world,), ("model",))
        shard, group = ops.mesh_shard(mesh, "model")
        if shard != rank:
            failures.append(f"rank {rank} holds shard {shard}")

        def agree(what, value):
            """Every rank's ``value`` equal (gathered over all ranks)."""
            got = [None] * world
            dist.all_gather_object(got, value)
            ok = len(set(got)) == 1
            say(f"{what} {'agree' if ok else 'DIFFER'} on all ranks: "
                f"{got[0] if ok else got}")
            if not ok:
                failures.append(f"{what} differ across ranks")

        # ---- (c) Engine.warm_spmv_plans on the mesh: raj1_full, split
        t1 = time.perf_counter()
        if source != "profiler":
            failures.append(f"the searches' clock is {source}")
        eng = Engine(get_smoke("granite-3-2b"), ServeConfig(max_seq=32),
                     device=dev)
        winners = eng.warm_spmv_plans([tuples["raj1_full"]], mesh=mesh,
                                      x_mode="split")
        st = eng.sharded_spmv_shard_stats[0]
        (_, raj_plan), = eng._warm_sharded.values()
        clocks = {r.timing_source for r in autotune._MEMO.values()}
        say(f"warm raj1_full split on ({world},) model: global winner "
            f"{winners[0]}, shard winners {st['shard_winners']}, kernel "
            f"cps {st['kernel_chunks_per_step']}, stored slot rows "
            f"{st['stored_slots']}, steps {st['num_steps']}, remote "
            f"columns {st['remote_cols']}, exchange bytes "
            f"{st['exchange_bytes']}; searches timed by {sorted(clocks)}; "
            f"{time.perf_counter() - t1:.1f} s")
        if clocks != {"profiler"}:
            failures.append(f"warm-up searches timed by {clocks}")
        agree("warm raj1_full 4-shard plan fingerprints",
              raj_plan.fingerprint())
        mesh2 = make_mesh((2, world // 2), ("data", "model"))
        eng.warm_spmv_plans([tuples["raj1_full"]], mesh=mesh2,
                            x_mode="split", per_shard_tune=False)
        st2 = eng.sharded_spmv_shard_stats[1]
        cache = eng.plan_cache_stats()["sharded_plan_cache"]
        plan2 = [p for _, p in eng._warm_sharded.values()
                 if p.n_shards == world // 2]
        say(f"re-warm on (2, {world // 2}) data x model, no per-shard "
            f"search: {st2['n_shards']} shards, configs "
            f"{st2['shard_winners']}, sharded plan "
            f"cache {cache}, {len(eng._warm_sharded)} plans kept")
        if st2["n_shards"] != world // 2 or len(plan2) != 1 \
                or len(eng._warm_sharded) != 2 or cache["entries"] < 2:
            failures.append("the re-warm on a resized mesh built no new "
                            "plan")
        agree("re-warm 2-shard plan fingerprints",
              plan2[0].fingerprint() if plan2 else None)
        say(f"warm-ups in {time.perf_counter() - t1:.1f} s")
        cfgs = {"raj1_full": raj_plan.shard_configs}
        del eng, raj_plan, plan2
        # per-shard configs of fem2d: each rank tunes its own split block
        t1 = time.perf_counter()
        res = autotune.autotune_spmv_per_shard(
            tuples["fem2d_2048"], world, group_size=128, repeats=1,
            x_mode="split", device=dev, group=group)
        cfgs["fem2d_2048"] = tuple(
            (c.chunks_per_step, c.ordering, c.spill_threshold)
            for c in autotune.harmonize_shard_winners(res))
        say(f"fem2d_2048 per-shard search (split blocks): winners "
            f"{[tuple(vars(r.config).values()) for r in res]}, harmonized "
            f"{cfgs['fem2d_2048']}; {time.perf_counter() - t1:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (b) the sharded main path: both matrices, both x modes,
        # block and per-shard configs, SpMV and SpMM
        t1 = time.perf_counter()
        # the sharded matrices and stacked plans stay on the host: each
        # rank moves only its own shard's view to the card
        sms = {k: ShardedRgCSR.from_csr(*t, world, device="cpu")
               for k, t in tuples.items()}
        modes, plans = {}, {}
        for name, sm in sms.items():
            labels = [("block", {})]
            if set(cfgs[name]) == {(1, "block", 0)}:
                say(f"{name}: the per-shard configs are the block plan's; "
                    f"it runs once")
            else:
                labels.append(("tuned", {"shard_configs": cfgs[name]}))
            modes[name] = [(xmode, label, kw)
                           for xmode in ("replicated", "split")
                           for label, kw in labels]
            for xmode, label, kw in modes[name]:
                plans[name, xmode, label] = (ops.get_sharded_plan(
                    sm, x_mode=xmode, **kw), kw)
        torch.cuda.synchronize()
        say(f"sharded matrices and {len(plans)} plans built in "
            f"{time.perf_counter() - t1:.1f} s")
        results = {}
        for name, sm in sms.items():
            reset_launch_counts()
            for xmode, label, _ in modes[name]:
                plan, kw = plans[name, xmode, label]
                xs, xms = x[name], xm[name]
                if xmode == "split":
                    xs = ops.split_x(plan, xs, shard)
                    xms = ops.split_x(plan, xms, shard)
                y = spmv(sm, xs, mesh=mesh, x_mode=xmode, **kw)
                ym = spmm(sm, xms, mesh=mesh, mesh_axis="model",
                          x_mode=xmode, **kw)
                results[name, xmode, label] = (y, ym, xs, xms)
            torch.cuda.synchronize()
            counts = launch_counts()
            out["launches"][name] = counts
            want = {"rgcsr_spmv": len(modes[name]),
                    "rgcsr_spmm": len(modes[name]), "ell_spmv": 0}
            say(f"main {name}: launches {counts} (want {want})")
            if counts != want:
                failures.append(f"{name} sharded launches {counts}")

        # what each shard holds and exchanges; fem2d's exact geometry
        for name, sm in sms.items():
            lo, hi = sm.shard_rows(shard)
            for xmode, label, _ in modes[name]:
                plan, _ = plans[name, xmode, label]
                view = plan.local(shard, dev)
                say(f"{name} {xmode} {label}: shard {shard} rows [{lo}, "
                    f"{hi}) of {sm.rows_per_shard} per shard, configs "
                    f"{plan.shard_configs[shard]} (kernel cps "
                    f"{plan.chunks_per_step}), stored slots "
                    f"{plan.shard_stored_slots[shard] * plan.group_size}, "
                    f"grid steps {plan.shard_num_steps[shard]} of "
                    f"{plan.num_steps_max}, live slot rows "
                    f"{int(view.plan.seg_slots.sum())} x 32, remote "
                    f"columns {plan.shard_remote_cols[shard]}, exchange "
                    f"bytes {plan.shard_exchange_bytes[shard]}, received "
                    f"{view.recv_cols}, e_max {plan.e_max}")
                if view.recv_cols != plan.shard_remote_cols[shard]:
                    failures.append(f"{name} {xmode} {label}: receives "
                                    f"{view.recv_cols} entries")
                on_host = plan.values3d.device.type == "cpu"
                say(f"{name} {xmode} {label}: shard {shard} holds "
                    f"{view.nbytes} bytes on the card; the stacked plan "
                    f"holds {plan.nbytes} bytes on the "
                    f"{'host' if on_host else 'CARD'}")
                if not on_host or view.nbytes >= plan.nbytes:
                    failures.append(f"{name} {xmode} {label}: the rank "
                                    f"holds more than its shard")
        fem_rep = plans["fem2d_2048", "replicated", "block"][0]
        fem_split = plans["fem2d_2048", "split", "block"][0]
        geometry = {
            "replicated stored slots": (tuple(
                s * fem_rep.group_size for s in fem_rep.shard_stored_slots),
                (33554432 // world,) * world),
            "split remote columns": (fem_split.shard_remote_cols,
                                     (2048, 4096, 4096, 2048)),
            "e_max": (fem_split.e_max, 2048),
            "fp32 exchange bytes": (fem_split.shard_exchange_bytes,
                                    (8192, 16384, 16384, 8192)),
        }
        for what, (got, want) in geometry.items():
            ok = got == want
            say(f"fem2d_2048 geometry {what}: {got} (want {want}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"fem2d_2048 geometry {what} {got}")
        raj = sms["raj1_full"]
        if raj.rows_per_shard != 65936 or raj.shard_rows(world - 1) != (
                (world - 1) * 65936, 263743):
            failures.append(f"raj1_full shard layout {raj.rows_per_shard}")

        # correctness: each shard's rows; the gathered SpMV and raj1's
        # gathered SpMM (fem2d's, 1 GiB, by its rows alone)
        refs = {}
        for (name, xmode, label), (y, ym, _, _) in results.items():
            a, n = csr[name], csr[name].shape[0]
            lo, hi = sms[name].shard_rows(shard)
            plan = plans[name, xmode, label][0]
            for kind, got, xv in (("spmv", y, x_np[name]),
                                  ("spmm", ym, xm_np[name])):
                single = np.load(Path(tmp) / f"single_{name}_{kind}.npy",
                                 mmap_mode="r")
                tag = f"{name} {xmode} {label} {kind}"
                if (name, kind) not in refs:
                    refs[name, kind] = _float64_rows(a, xv, lo, hi)
                _shard_checks(say, failures, f"{tag} rows [{lo}, {hi})",
                              got, *refs[name, kind], single[lo:hi])
                if kind == "spmv" or name == "raj1_full":
                    full = ops.gather_sharded_rows(plan, got, mesh=mesh,
                                                   axis="model")
                    if (name, kind, "full") not in refs:
                        refs[name, kind, "full"] = _float64_rows(a, xv, 0, n)
                    _shard_checks(say, failures, f"{tag} gathered", full,
                                  *refs[name, kind, "full"], single)
        del results, refs
        gc.collect()
        say(f"runs and checks in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()

        # each kernel against its plain version on the shard's plan (not
        # counted: the main path's counts were read above)
        errs = out["errs"]
        for (name, xmode, label), (plan, _) in plans.items():
            view = plan.local(shard, dev)
            p = view.plan
            xs, xms = x[name], xm[name]
            if xmode == "split":
                xs = ops.split_x(plan, xs, shard)
                xms = ops.split_x(plan, xms, shard)
            for kernel, launch, plain, xv in (
                    ("rgcsr_spmv", rgcsr_spmv_launch, rgcsr_spmv_plain, xs),
                    ("rgcsr_spmm", rgcsr_spmm_launch, rgcsr_spmm_plain,
                     xms)):
                got = launch(p, xv).float()
                want, scale = (plain(v, p.columns2d, p.step_group, xa,
                                     n_groups=p.n_groups,
                                     chunks_per_step=p.chunks_per_step)
                               .float().reshape(got.shape)
                               for v, xa in ((p.values2d, xv),
                                             (p.values2d.abs(), xv.abs())))
                diff = (got - want).abs()
                err = diff.max().item()
                ok = bool((diff <= FP32_TOL * (1 + scale)).all())
                key = f"{kernel}|{name}"
                errs[key] = max(errs.get(key, 0.0), err)
                say(f"check {kernel} {name} {xmode} {label} shard "
                    f"{shard}: max_abs_err {err:.3e} tol {FP32_TOL:g} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{kernel} {name} {xmode} {label}")
                del got, want, scale, diff

        # times: each rank's K1/K2 on its replicated block plan, one rank
        # at a time (the others wait at a barrier): a quarter of the
        # matrix on a card of its own; then the exchange, all together
        for turn in range(world):
            if turn == shard:
                for name in sms:
                    plan = plans[name, "replicated", "block"][0]
                    p = plan.local(shard, dev).plan
                    lo, hi = sms[name].shard_rows(shard)
                    rows = csr[name][lo:hi]
                    live = int(p.seg_slots.sum()) * 32
                    real = int(((p.values2d != 0)
                                | (p.columns2d != 0)).sum())
                    x_rows = len(np.unique(rows.indices))
                    g_rows = p.n_groups * p.group_size
                    n_sm = torch.cuda.get_device_properties(
                        dev).multi_processor_count
                    for kernel, d, launch, plain, xv, calls in (
                            ("rgcsr_spmv", 1, rgcsr_spmv_launch,
                             rgcsr_spmv_plain, x[name], 50),
                            ("rgcsr_spmm", D_SPMM, rgcsr_spmm_launch,
                             rgcsr_spmm_plain, xm[name], 10)):
                        w = p.work_list(kernel, n_sm=n_sm,
                                        part_bytes=p.group_size * d * 4)
                        meta = (p.seg_slots.nbytes + w.items.nbytes
                                + w.combine.nbytes)
                        flops = 2 * (live if d == 1 else real * d)
                        # x: the rows of x the shard's columns reference
                        b_ms, b_by = bound(live * 8 + x_rows * d * 4
                                           + g_rows * d * 4 + meta, flops)
                        # the function alone: the shard's nonzeros (fp32
                        # value + int32 column), those x rows, its own y
                        nnz_ms = bound(rows.nnz * 8 + x_rows * d * 4
                                       + (hi - lo) * d * 4,
                                       2 * rows.nnz * d)[0]
                        lib = library_times(rows, xv, calls, dev)
                        run = (lambda p=p, xv=xv, launch=launch:
                               launch(p, xv))
                        e = {"ms": card_ms(run, calls, dev, hold=True),
                             "cold_ms": card_ms(run, calls, dev, cold=True),
                             "plain_ms": card_ms(
                                 lambda p=p, xv=xv, plain=plain: plain(
                                     p.values2d, p.columns2d, p.step_group,
                                     xv, n_groups=p.n_groups,
                                     chunks_per_step=p.chunks_per_step),
                                 2, dev, hold=True),
                             "bound_ms": b_ms, "bound_by": b_by,
                             "nnz_bound_ms": nnz_ms,
                             "library_ms": min(v[0] for v in lib.values()),
                             "library_cold_ms": min(v[1]
                                                    for v in lib.values())}
                        out["entries"][f"{kernel}|{name}"] = e
                        say(f"time {kernel}@{name} shard {shard}: kernel "
                            f"{e['ms']:.4f} ms (cold {e['cold_ms']:.4f}), "
                            f"plain {e['plain_ms']:.4f} ms, bound "
                            f"{b_ms:.4f} ms ({b_by}), nnz bound "
                            f"{nnz_ms:.4f} ms, library "
                            f"{e['library_ms']:.4f} ms (cold "
                            f"{e['library_cold_ms']:.4f}) — the card to "
                            f"this rank alone")
            dist.barrier()
        for name in sms:
            plan = plans[name, "split", "block"][0]
            if not plan.has_exchange:
                continue
            view = plan.local(shard, dev)
            xs = ops.split_x(plan, x[name], shard)
            for _ in range(3):
                work, _r = ops._exchange(view, xs, group)
                work.wait()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(20):
                work, _r = ops._exchange(view, xs, group)
                work.wait()
            torch.cuda.synchronize()
            say(f"exchange {name} split: {view.recv_cols} real of "
                f"{plan.exchange_padded_recv_cols} slots received, "
                f"{(time.perf_counter() - t1) / 20 * 1e3:.3f} ms wall per "
                f"all_to_all_single — gloo, host-staged, {world} ranks on "
                f"one card: no multi-card figure")
        say(f"rank done in {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    out["failures"] = failures
    with open(Path(tmp) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def sharded_phase(dev, mats, x, xm, entries, failures, tag):
    """Phase 15, row-sharded SpMV/SpMM over ``torch.distributed``: (a) one
    rank on NCCL in this process, its results held to the single-device
    K1/K2 bit for bit; (b) and (c) ``SHARD_WORLD`` spawned ranks that share
    the card over gloo (:func:`shard_rank`).  ``mats``: name → (RgCSR,
    scipy CSR); ``x``/``xm``: the main path's inputs on the card."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.core import ShardedRgCSR, spmm, spmv
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels.rgcsr_spmm import rgcsr_spmm_launch
    from repro_torch.kernels.rgcsr_spmv import rgcsr_spmv_launch
    from repro_torch.launch.mesh import make_mesh
    t15 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_shards_"))
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(tmp / "store1"), 1), rank=0,
            world_size=1)
        try:
            mesh1 = make_mesh((1,), ("model",))
            for name, (m, a) in mats.items():
                sm = ShardedRgCSR.from_csr(a.data, a.indices, a.indptr,
                                           a.shape, 1, device="cpu")
                for label, kw in (("block", {}),
                                  ("adaptive spill64",
                                   {"ordering": "adaptive",
                                    "spill_threshold": 64})):
                    single = ops.make_plan(m, **kw)
                    want = (ops.rgcsr_spmv(single, x[name]),
                            ops.rgcsr_spmm(single, xm[name]))
                    raw = (rgcsr_spmv_launch(single, x[name]),
                           rgcsr_spmm_launch(single, xm[name]))
                    for x_mode in ("replicated", "split"):
                        plan = ops.get_sharded_plan(sm, x_mode=x_mode, **kw)
                        p1 = plan.local(0, dev).plan
                        reset_launch_counts()
                        got = (spmv(sm, x[name], mesh=mesh1, x_mode=x_mode,
                                    **kw),
                               spmm(sm, xm[name], mesh=mesh1,
                                    mesh_axis="model", x_mode=x_mode, **kw))
                        torch.cuda.synchronize()
                        c = launch_counts()
                        full = ops.gather_sharded_rows(plan, got[0],
                                                       mesh=mesh1,
                                                       axis="model")
                        same_plan = all(torch.equal(getattr(p1, f),
                                                    getattr(single, f))
                                        for f in ("values2d", "columns2d",
                                                  "step_group",
                                                  "step_first"))
                        same_raw = (torch.equal(
                            rgcsr_spmv_launch(p1, x[name]), raw[0])
                            and torch.equal(rgcsr_spmm_launch(
                                p1, xm[name]), raw[1]))
                        if not single.n_spilled_elements:
                            how = "bitwise equal"
                            same = all(torch.equal(g, w)
                                       for g, w in zip(got, want))
                        else:   # the spill tail's index_add_ uses atomics
                            how = "within 1e-5 · (1 + Σ|a·x|)"
                            a64 = abs(a.astype(np.float64))
                            same = all(bool(((g - w).abs() <= FP32_TOL * (
                                1 + torch.from_numpy(a64 @ abs(
                                    v.double().cpu().numpy())).to(dev)))
                                .all())
                                for g, w, v in zip(got, want,
                                                   (x[name], xm[name])))
                        ok = (same_plan and same_raw and same
                              and torch.equal(full, got[0])
                              and c == {"rgcsr_spmv": 1, "rgcsr_spmm": 1,
                                        "ell_spmv": 0}
                              and plan.e_max == 0)
                        log(f"sharded {name} {label} {x_mode} on one NCCL "
                            f"rank: plan arrays equal to the single-device "
                            f"plan's {same_plan}, K1/K2 outputs bitwise "
                            f"equal {same_raw}, result {how} {same}, "
                            f"launches {c}, e_max {plan.e_max} "
                            f"{'ok' if ok else 'FAIL'}")
                        if not ok:
                            failures.append(f"sharded one rank {name} "
                                            f"{label} {x_mode}")
                    del single, want, raw, plan, p1, got, full
                del sm
        finally:
            dist.destroy_process_group()
        log(f"sharded one rank in {time.perf_counter() - t15:.1f} s")

        # the single-device K1/K2 results the ranks hold their rows to
        for name, (m, _) in mats.items():
            for kind, fn, operand in (("spmv", spmv, x[name]),
                                      ("spmm", spmm, xm[name])):
                np.save(tmp / f"single_{name}_{kind}.npy",
                        fn(m, operand).cpu().numpy())
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ctx = mp.start_processes(shard_rank, args=(SHARD_WORLD, str(tmp),
                                                   SHARD_TIMEOUT_S),
                                 nprocs=SHARD_WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t1 > SHARD_DEADLINE_S:
                    raise TimeoutError(f"ranks still running after "
                                       f"{SHARD_DEADLINE_S} s")
        except Exception as err:            # noqa: BLE001 — fail the phase
            failures.append(f"sharded ranks: {err}")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        if not any(f.startswith("sharded ranks") for f in failures):
            ranks = []
            for r in range(SHARD_WORLD):
                with open(tmp / f"rank{r}.json") as f:
                    ranks.append(json.load(f))
            for r, res in enumerate(ranks):
                failures.extend(f"sharded rank {r}: {f}"
                                for f in res["failures"])
            for key in ranks[0]["entries"]:
                kernel, name = key.split("|")
                per = [res["entries"][key] for res in ranks]
                slow = max(range(SHARD_WORLD), key=lambda i: per[i]["ms"])
                e = {"name": f"{kernel}@{name}/{SHARD_WORLD}shards",
                     "route": "cuda", "source": KERNEL_META[kernel][0],
                     "replaces": KERNEL_META[kernel][1],
                     "launches": sum(res["launches"][name][kernel]
                                     for res in ranks),
                     "max_abs_err": max(res["errs"][key] for res in ranks),
                     **per[slow], "slowest_shard": slow,
                     **{f"shard_{k}": [p[k] for p in per]
                        for k in ("ms", "cold_ms", "bound_ms",
                                  "nnz_bound_ms", "library_ms")}}
                entries.append(e)
                log(f"time {e['name']}: slowest shard {slow} "
                    f"{e['ms']:.4f} ms; per shard {e['shard_ms']} ms, "
                    f"bound {e['shard_bound_ms']} ms, nnz bound "
                    f"{e['shard_nnz_bound_ms']} ms, library "
                    f"{e['shard_library_ms']} ms; launches {e['launches']} "
                    f"{tag}")
        log(f"sharded ranks in {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 15 in {time.perf_counter() - t15:.1f} s")


# ------------------------------------------- phase 16: sharded training


def _phase16_cfg(cfg_kw):
    """granite-3-2b at full width with the RgCSR FFN through the segment
    sum, in float32, its depth cut to ``TRAIN16_LAYERS`` (``cfg_kw``
    overrides, e.g. a CPU rehearsal's narrow model)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SparsityConfig
    return dataclasses.replace(get_config(SERVE_ARCH), **dict(dict(
        n_layers=TRAIN16_LAYERS, dtype="float32", kv_cache_dtype="float32",
        sparsity=SparsityConfig(**TRAIN_SPARSITY)), **cfg_kw))


def _phase16_train_config(ckpt_dir=None, **opt_kw):
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig
    return TrainConfig(steps=TRAIN16_STEPS, microbatches=TRAIN16_MICRO,
                       log_every=100, ckpt_dir=ckpt_dir, ckpt_every=100,
                       seed=SEED, opt=OptimizerConfig(
                           warmup_steps=2, decay_steps=TRAIN16_STEPS,
                           **opt_kw))


_TIMED = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")


class _TimedDist:
    """``torch.distributed`` with the wall time of every collective the
    sharding layer calls summed in ``seconds`` (a synchronize before and
    after each, so the card's queued work is not counted in it)."""

    def __init__(self, dist, sync):
        self._dist, self._sync, self.seconds, self.calls = dist, sync, 0.0, 0

    def __getattr__(self, name):
        fn = getattr(self._dist, name)
        if name not in _TIMED:
            return fn

        def timed(*a, **kw):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self._sync()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        return timed


def _count_collectives(tr, timed, dev):
    """Wrap ``tr``'s step so that each step's seconds in collectives
    (``comm_s``), the bytes of the whole tensors its collectives moved by
    kind and mesh axis (``moved``: the sharding layer's collective log,
    which the dry run reads too) and, on the card, its
    ``max_memory_allocated`` (``peak``; the counter reset just before)
    are appended to the returned lists."""
    import torch
    from repro_torch.launch.hlo_stats import moved_bytes
    from repro_torch.sharding import layout
    step_fn = tr.train_step
    stats = {"comm_s": [], "moved": [], "peak": []}
    cuda = dev.type == "cuda"

    def counted(*a):
        seconds = timed.seconds
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with layout.collective_log() as entries:
            res = step_fn(*a)
        stats["comm_s"].append(timed.seconds - seconds)
        stats["moved"].append(moved_bytes(entries))
        stats["peak"].append(torch.cuda.max_memory_allocated(dev) if cuda
                             else None)
        return res
    tr.train_step = counted
    return stats


def _say_steps(say, what, history, comm):
    tokens = TRAIN_SEQ * TRAIN_BATCH
    for h, c in zip(history, comm):
        lb = f", load_balance {h['load_balance']:.6f}" \
            if "load_balance" in h else ""
        say(f"{what}step {h['step']}: loss {h['loss']:.6f}{lb}, grad_norm "
            f"{h['grad_norm']:.6f}, {h['step_time_s']:.3f} s host "
            f"(ending in a synchronize), collectives {c:.3f} s "
            f"({c / h['step_time_s']:.1%}), "
            f"{tokens / h['step_time_s']:.1f} tokens/s")


def _bytes_at_rest(tr, part, state, say, failures, rank, what=""):
    """Phase 16 (b): the bytes this rank holds of the parameters and
    AdamW's two moments, against what the placements predict and one
    device's; the leaves that fall back to replicated."""
    from repro_torch.sharding.partitioner import _candidates, _filter_axis
    from repro_torch.train.trainer import _flat
    mesh = part.mesh
    params, opt_state = state
    flat_opt = {}
    for name in ("m", "v"):
        flat_opt.update({f"{name}/{k}": t
                         for k, t in opt_state[name].items()})
    held = predicted = whole = 0
    for key, t in list(params.items()) + list(flat_opt.items()):
        n_full = t.numel() * t.element_size()
        pieces = 1
        for i, pl in enumerate(t.placements):
            pieces *= mesh.size(i) if pl.is_shard() else 1
        local = t.to_local()
        held += local.numel() * local.element_size()
        predicted += n_full // pieces
        whole += n_full
    fallback = []
    rules = part.rules.params
    for key, p in _flat(tr.model.spec()).items():
        s = part._leaf_spec(p)
        named = [n for n, e in zip(p.axes, s) if e is None and any(
            _filter_axis(mesh, c) is not None
            for c in _candidates(rules.get(n))[:-1])]
        if named:
            fallback.append(f"{key} {tuple(p.shape)} {named}")
    say(f"{what}bytes at rest (fp32 parameters and AdamW's two moments): "
        f"{held} held on this rank, {predicted} by the placements, "
        f"{whole} on one device ({held / whole:.2%}); "
        f"{len(fallback)} leaves replicated where a rule named an "
        f"axis (no axis divides them, or the leaf's axis was taken)")
    if held != predicted:
        failures.append(f"rank {rank} {what}holds {held} B, placements "
                        f"predict {predicted}")
    return {"held": held, "predicted": predicted, "whole": whole,
            "fallback": fallback}


def _phase16_moe_cfg(moe_kw):
    """granite-moe-1b-a400m at full width in float32, its depth cut to
    ``TRAIN16_MOE_LAYERS`` (``moe_kw`` overrides for a CPU rehearsal)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), **dict(dict(
        n_layers=TRAIN16_MOE_LAYERS, dtype="float32",
        kv_cache_dtype="float32"), **moe_kw))


def routing_stats(model, batch, part=None):
    """``launch.steps.routing_stats`` (on ``part``'s mesh when given) as
    lists and floats."""
    from repro_torch.launch.steps import routing_stats as stats
    aux = stats(model, batch, part)
    return {"expert_fraction": aux["expert_fraction"].cpu().tolist(),
            "load_balance": float(aux["load_balance"]),
            "router_z": float(aux["router_z"])}


def _moe_rank(mesh, part, dev, timed, say, failures, rank, moe_kw):
    """Phase 16 (f) on one rank: granite-moe-1b-a400m on the mesh."""
    from repro_torch.train.trainer import Trainer
    cfg = _phase16_moe_cfg(moe_kw)
    tr = Trainer(cfg, _phase16_train_config(), mesh=mesh, partitioner=part,
                 device=dev)
    state = tr.init_state(TRAIN_SEQ, TRAIN_BATCH)
    calls = timed.calls
    stats = _count_collectives(tr, timed, dev)
    t1 = time.perf_counter()
    state, _ = tr.run(state)
    run_s = time.perf_counter() - t1
    _say_steps(say, f"{MOE_ARCH} ", tr.history, stats["comm_s"])
    say(f"{MOE_ARCH} {len(tr.history)} steps in {run_s:.1f} s "
        f"({timed.calls - calls} collectives)")
    out = {"history": tr.history, **stats,
           "bytes": _bytes_at_rest(tr, part, state, say, failures, rank,
                                   f"{MOE_ARCH} ")}
    out["routing"] = routing_stats(tr.model, tr._batch(0), part)
    return out


def _tp_runs(part, dev, timed, say, world, cfg, moe_kw):
    """Phase 16 (g) on one rank: the tensor-parallel runs (the module's
    note), each rank's history, attention mode, per step collective
    seconds and bytes, and peak."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import Partitioner
    from repro_torch.train.trainer import Trainer
    mesh14 = make_mesh((1, world), ("data", "model"), device_type=dev.type)
    part14 = Partitioner(mesh14, "train")
    tp = dict(act_shard=True)
    runs = (("tp", dataclasses.replace(cfg, **tp), part),
            ("tp_full", dataclasses.replace(cfg, remat="full", **tp), part),
            ("tp_1x4", dataclasses.replace(cfg, **tp), part14),
            ("moe_tp", dataclasses.replace(_phase16_moe_cfg(moe_kw), **tp),
             part))
    out = {}
    for name, c, p in runs:
        tr = Trainer(c, _phase16_train_config(), mesh=p.mesh,
                     partitioner=p, device=dev)
        state = tr.init_state(TRAIN_SEQ, TRAIN_BATCH)
        stats = _count_collectives(tr, timed, dev)
        t1 = time.perf_counter()
        tr.run(state)
        mode = tr.model_cfg.attn_shard_mode
        _say_steps(say, f"(g) {name} ({mode}) ", tr.history,
                   stats["comm_s"])
        say(f"(g) {name} {len(tr.history)} steps in "
            f"{time.perf_counter() - t1:.1f} s; peak per step "
            f"{stats['peak']} B; step 0's collective bytes "
            f"{stats['moved'][0]}")
        out[name] = {"history": tr.history, "mode": mode, **stats}
        del tr, state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def train_rank(rank, world, tmp, timeout_s, device, cfg_kw, moe_kw):
    """Phase 16 (a)–(d), (f), (g): rank ``rank`` of ``world`` ranks sharing
    the card over gloo, spawned by :func:`sharded_train_phase`; writes its
    results and failures to ``tmp/train<rank>.json``."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import Partitioner, layout
    from repro_torch.train.trainer import Trainer

    def say(msg):     # one write per line: the ranks share stdout
        os.write(1, f"train16 r{rank}: {msg}\n".encode())

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store16"), world),
        rank=rank, world_size=world, timeout=timeout)
    timed = _TimedDist(dist, sync)
    layout.dist = timed
    failures, out = [], {}
    cfg = _phase16_cfg(cfg_kw)
    ckpt = str(Path(tmp) / "ckpt16")
    t0 = time.perf_counter()
    try:     # a rank that raises fails the spawn, which ends the others
        mesh = make_mesh(TRAIN16_MESH, ("data", "model"),
                         device_type=dev.type)
        part = Partitioner(mesh, "train")
        tr = Trainer(cfg, _phase16_train_config(ckpt), mesh=mesh,
                     partitioner=part, device=dev)
        state = tr.init_state(TRAIN_SEQ, TRAIN_BATCH)
        stats = _count_collectives(tr, timed, dev)
        t1 = time.perf_counter()
        state, _ = tr.run(state)
        run_s = time.perf_counter() - t1
        out["history"] = tr.history
        out.update(stats)
        _say_steps(say, "", tr.history, stats["comm_s"])
        say(f"{len(tr.history)} steps and the final checkpoint in "
            f"{run_s:.1f} s ({timed.calls} collectives, "
            f"{timed.seconds:.1f} s in them)")
        # (b) bytes at rest: each rank's slices against the placements'
        # prediction and the single-device total
        params, opt_state = state
        out["bytes"] = _bytes_at_rest(tr, part, state, say, failures, rank)
        # (c) the checkpoint (step TRAIN16_STEPS - 1) onto (1, world):
        # every slice bitwise the (2, 2) state's, gathered leaf by leaf
        mesh2 = make_mesh((1, world), ("data", "model"),
                          device_type=dev.type)
        tr2 = Trainer(cfg, _phase16_train_config(ckpt), mesh=mesh2,
                      partitioner=Partitioner(mesh2, "train"), device=dev)
        tr2.init_state(TRAIN_SEQ, TRAIN_BATCH)
        t1 = time.perf_counter()
        (params2, opt2), nxt = tr2.restore_latest()
        restore_s = time.perf_counter() - t1
        bad = []
        pairs = [(f"params/{k}", params[k], params2[k]) for k in params]
        for name in ("m", "v"):
            pairs += [(f"{name}/{k}", opt_state[name][k], opt2[name][k])
                      for k in opt_state[name]]
        for key, saved, got in pairs:
            want = layout.local_chunk(layout.gather(saved), mesh2,
                                      got.placements)
            if not torch.equal(want, got.to_local()):
                bad.append(key)
        ok = not bad and nxt == TRAIN16_STEPS
        say(f"checkpoint of {TRAIN16_MESH} restored onto (1, {world}) in "
            f"{restore_s:.1f} s: {len(pairs)} parameters and moments "
            f"bitwise equal {not bad}, next step {nxt} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"restore onto (1, {world}): {bad[:4]}")
        del tr2, params2, opt2, pairs, want, tr, state, params, opt_state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # (f) granite-moe-1b-a400m on the same mesh: each rank routes its
        # rows with the whole microbatch's capacity, positions and aux
        out["moe"] = _moe_rank(mesh, part, dev, timed, say, failures, rank,
                               moe_kw)
        # (g) tensor-parallel compute over `model`, on the same ranks
        out["tp"] = _tp_runs(part, dev, timed, say, world, cfg, moe_kw)
        out["phase_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    out["failures"] = failures
    with open(Path(tmp) / f"train{rank}.json", "w") as f:
        json.dump(out, f)


def restore_rank(rank, world, tmp, timeout_s, device, cfg_kw):
    """Phase 16 (c): the (2, 2) checkpoint restored by ``world`` ranks on
    a ``(world,)`` mesh, each slice bitwise the checkpoint file's."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import port_layout
    from repro_torch.sharding import Partitioner, layout
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer, _shape_only

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store16r"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    failures, out = [], {}
    cfg = _phase16_cfg(cfg_kw)
    ckpt = str(Path(tmp) / "ckpt16")
    try:
        mesh = make_mesh((world,), ("model",), device_type=dev.type)
        tr = Trainer(cfg, _phase16_train_config(ckpt), mesh=mesh,
                     partitioner=Partitioner(mesh, "train"), device=dev)
        tr.init_state(TRAIN_SEQ, TRAIN_BATCH)
        t1 = time.perf_counter()
        (params, opt), nxt = tr.restore_latest()
        out["restore_s"] = time.perf_counter() - t1
        meta = {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
                for k, t in params.items()}
        host, _ = checkpoint.restore(ckpt, tr._checkpoint_tree(
            (meta, tr.opt_init(meta)), _shape_only))
        bad, n = [], 0
        saved = {"params": port_layout(cfg, host["params"])}
        for name in ("m", "v"):
            saved[name] = port_layout(cfg, host["opt_state"][name])
        live = {"params": params, "m": opt["m"], "v": opt["v"]}
        for group, tree in live.items():
            for k, t in tree.items():
                want = layout.local_chunk(torch.from_numpy(np.asarray(
                    saved[group][k])), mesh, t.placements)
                n += 1
                if not torch.equal(want, t.to_local().cpu()):
                    bad.append(f"{group}/{k}")
        out.update(n=n, bad=bad, next_step=nxt)
        if bad or nxt != TRAIN16_STEPS:
            failures.append(f"restore onto ({world},): {bad[:4]}, next "
                            f"step {nxt}")
    finally:
        dist.destroy_process_group()
    out["failures"] = failures
    with open(Path(tmp) / f"restore{rank}.json", "w") as f:
        json.dump(out, f)


def _spawn_ranks(fn, world, tmp, deadline_s, args):
    """``fn(rank, world, tmp, ...)`` on ``world`` spawned ranks; an error
    message, or None.  Every process is ended before it returns."""
    import torch.multiprocessing as mp
    t1 = time.perf_counter()
    ctx = mp.start_processes(fn, args=(world, str(tmp)) + args,
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t1 > deadline_s:
                raise TimeoutError(f"ranks still running after "
                                   f"{deadline_s} s")
    except Exception as err:            # noqa: BLE001 — fail the phase
        return str(err)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return None


def _launcher_ranks(world, tmp, deadline_s, device, argv):
    """``python -m repro_torch.launch.train`` on ``world`` processes of
    their own, the default group from the launcher environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) over gloo: (rank 0's standard
    output, an error message or None)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, outs, errs = [], [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT / "src") + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        outs.append(open(Path(tmp) / f"launcher{rank}.out", "w+"))
        errs.append(open(Path(tmp) / f"launcher{rank}.err", "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train",
             "--backend", "gloo", "--device", device] + argv,
            env=env, stdout=outs[-1], stderr=errs[-1], cwd=str(tmp)))
    t1, err = time.perf_counter(), None
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t1 > deadline_s:
                err = f"launcher ranks still running after {deadline_s} s"
                break
            if any(p.poll() not in (None, 0) for p in procs):
                err = "a launcher rank failed: " + ", ".join(
                    f"rank {r} exit {p.poll()}" for r, p in enumerate(procs))
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts, tails = [], []
    for f, e in zip(outs, errs):
        f.seek(0)
        e.seek(0)
        texts.append(f.read())
        tails.append(e.read()[-1500:])
        f.close()
        e.close()
    if err is None and any(p.returncode for p in procs):
        err = f"launcher exit codes {[p.returncode for p in procs]}"
    if err:
        for r, t in enumerate(tails):
            log(f"train16 launcher rank {r} stderr tail: {t}")
    return texts[0], err


def _moe_one_device(dev, moe_kw):
    """Phase 16 (f) on one device: granite-moe-1b-a400m's history and
    routing statistics on the first batch."""
    import torch
    from repro_torch.train.trainer import Trainer
    t1 = time.perf_counter()
    single = Trainer(_phase16_moe_cfg(moe_kw), _phase16_train_config(),
                     device=dev)
    single.run(single.init_state(TRAIN_SEQ, TRAIN_BATCH))
    n_params = sum(t.numel() for t in single.model.tensors().values()
                   if t.is_floating_point())
    want = {"history": single.history,
            "routing": routing_stats(single.model, single._batch(0))}
    log(f"train16 (f) {MOE_ARCH} one device: {n_params} float parameters, "
        f"losses {[round(h['loss'], 6) for h in single.history]}, "
        f"load_balance {[round(h['load_balance'], 6) for h in single.history]}"
        f", host s per step "
        f"{[round(h['step_time_s'], 3) for h in single.history]} in "
        f"{time.perf_counter() - t1:.1f} s")
    del single
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return want


def _moe_compare(ranks, want, failures, world, tag):
    """Phase 16 (f): the ranks' MoE steps and routing against one
    device's."""
    rel = lambda g, w: abs(g - w) / max(abs(w), 1e-30)      # noqa: E731
    gaps = collections.defaultdict(float)
    for res in ranks:
        got = res["moe"]
        for g, w in zip(got["history"], want["history"], strict=True):
            for k in ("loss", "ce", "load_balance", "grad_norm"):
                gaps[k] = max(gaps[k], rel(g[k], w[k]))
        for k in ("load_balance", "router_z"):
            gaps[f"routing {k}"] = max(gaps[f"routing {k}"], rel(
                got["routing"][k], want["routing"][k]))
        frac = np.asarray(got["routing"]["expert_fraction"])
        gaps["expert_fraction (abs)"] = max(
            gaps["expert_fraction (abs)"], float(np.abs(
                frac - np.asarray(want["routing"]["expert_fraction"])).max()))
    ok = all(v <= TRAIN16_MOE_TOL for v in gaps.values())
    log(f"train16 (f) {MOE_ARCH} on {world} ranks against one device: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f" (relative unless marked; tol {TRAIN16_MOE_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"train16 {MOE_ARCH}: gaps {dict(gaps)}")
    frac = np.asarray(ranks[0]["moe"]["routing"]["expert_fraction"])
    log(f"train16 (f) {MOE_ARCH} expert_fraction on the first batch, per "
        f"layer (min, max over {frac.shape[1]} experts; 1/{frac.shape[1]} "
        f"= {1 / frac.shape[1]:.4f} is balanced): "
        f"{[(round(float(r.min()), 4), round(float(r.max()), 4)) for r in frac]}"
        f"; load_balance {ranks[0]['moe']['routing']['load_balance']:.6f}, "
        f"router_z {ranks[0]['moe']['routing']['router_z']:.6f}")
    steps = ranks[0]["moe"]["history"]
    host = [h["step_time_s"] for h in steps]
    comm = [max(res["moe"]["comm_s"][i] for res in ranks)
            for i in range(len(steps))]
    log(f"train16 (f) {MOE_ARCH} per step: host "
        f"{[round(x, 3) for x in host]} s, collectives "
        f"{[round(x, 3) for x in comm]} s "
        f"({[f'{c / h:.0%}' for c, h in zip(comm, host)]}), "
        f"{[round(TRAIN_SEQ * TRAIN_BATCH / h, 1) for h in host]} tokens/s "
        f"{tag}")
    b = [res["moe"]["bytes"] for res in ranks]
    log(f"train16 (f) {MOE_ARCH} bytes at rest per rank: "
        f"{[x['held'] for x in b]} held, {[x['predicted'] for x in b]} by "
        f"the placements, {b[0]['whole']} on one device "
        f"({b[0]['held'] / b[0]['whole']:.2%}); replicated by the "
        f"fallback: {b[0]['fallback'] or 'none'}")


def _gib(n):
    return "n/a" if n is None else f"{n / 2**30:.3f}"


def _bytes_line(per_step):
    """A step's collective bytes by kind, in MB, and their total."""
    parts = ", ".join(f"{k} {v / 1e6:.2f}" for k, v in sorted(
        per_step.items()))
    return f"{sum(per_step.values()) / 1e6:.2f} MB ({parts})"


def _tp_compare(ranks, want, moe_want, failures, world, tag):
    """Phase 16 (g): the tensor-parallel runs against one device, their
    peaks against (a)'s gather-at-use and their collective bytes."""
    rel = lambda g, w: abs(g - w) / max(abs(w), 1e-30)      # noqa: E731
    for name, ref, tol, keys in (
            ("tp", want, TRAIN16_TOL, ("loss", "grad_norm")),
            ("tp_full", want, TRAIN16_TOL, ("loss", "grad_norm")),
            ("tp_1x4", want, TRAIN16_TOL, ("loss", "grad_norm")),
            ("moe_tp", moe_want["history"], TRAIN16_MOE_TOL,
             ("loss", "ce", "load_balance", "grad_norm"))):
        gaps = collections.defaultdict(float)
        for res in ranks:
            for g, w in zip(res["tp"][name]["history"], ref, strict=True):
                for k in keys:
                    gaps[k] = max(gaps[k], rel(g[k], w[k]))
        ok = gaps["loss"] <= tol
        run = ranks[0]["tp"][name]
        host = [h["step_time_s"] for h in run["history"]]
        comm = [max(res["tp"][name]["comm_s"][i] for res in ranks)
                for i in range(len(host))]
        log(f"train16 (g) {name} (attention {run['mode']}) on {world} "
            f"ranks against one device: "
            + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
            + f" relative (loss tol {tol:g}); host "
            f"{[round(x, 3) for x in host]} s a step, collectives "
            f"{[round(x, 3) for x in comm]} s, "
            f"{[round(TRAIN_SEQ * TRAIN_BATCH / h, 1) for h in host]} "
            f"tokens/s {tag} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train16 (g) {name}: gaps {dict(gaps)}")
    def peak(steps):        # a run's largest step peak (None off the card)
        return None if None in steps else max(steps)
    peaks = {"gather-at-use": [peak(r["peak"]) for r in ranks]}
    for name in ("tp", "tp_full", "tp_1x4", "moe_tp"):
        peaks[name] = [peak(r["tp"][name]["peak"]) for r in ranks]
    peaks["moe gather-at-use"] = [peak(r["moe"]["peak"]) for r in ranks]
    lower = all(t is not None and g is not None and t < g for t, g in
                zip(peaks["tp"], peaks["gather-at-use"]))
    on_card = peaks["tp"][0] is not None
    log(f"train16 (g) per rank max_memory_allocated over a step, GiB: "
        + "; ".join(f"{k} {[_gib(x) for x in v]}" for k, v in peaks.items())
        + f"; (2, 2) tensor-parallel below gather-at-use on every rank "
        f"{lower if on_card else 'n/a (no card)'} {tag} "
        f"{'ok' if lower or not on_card else 'FAIL'}")
    if on_card and not lower:
        failures.append(f"train16 (g) tensor-parallel peak "
                        f"{peaks['tp']} not below gather-at-use "
                        f"{peaks['gather-at-use']}")
    for name, steps in (("gather-at-use", ranks[0]["moved"]),
                        ("tp", ranks[0]["tp"]["tp"]["moved"]),
                        ("tp_full", ranks[0]["tp"]["tp_full"]["moved"]),
                        ("tp_1x4", ranks[0]["tp"]["tp_1x4"]["moved"]),
                        ("moe gather-at-use", ranks[0]["moe"]["moved"]),
                        ("moe_tp", ranks[0]["tp"]["moe_tp"]["moved"])):
        log(f"train16 (g) rank 0's collective bytes a step, {name}: "
            f"{_bytes_line(steps[0])} {tag}")


def sharded_train_phase(dev, failures, tag, cfg_kw=None, moe_kw=None):
    """Phase 16, sharded training on a ``TRAIN16_MESH`` mesh of gloo
    ranks sharing the card (see the module's note); the ranks' results
    (phase 19 reads rank 0's tensor-parallel run), None when they
    failed."""
    import torch
    from repro_torch.train.trainer import Trainer
    cfg_kw = dict(cfg_kw or {})
    moe_kw = dict(moe_kw or {})
    t16 = time.perf_counter()
    device = dev.type
    world = int(np.prod(TRAIN16_MESH))
    cfg = _phase16_cfg(cfg_kw)
    log(f"train16: {cfg.name} d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.n_layers} layers (cut from {SERVE_ARCH}'s published depth), "
        f"RgCSR FFN through the segment sum, fp32, AdamW, "
        f"{TRAIN16_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens with "
        f"micro={TRAIN16_MICRO}, on a {TRAIN16_MESH} (data, model) mesh of "
        f"{world} gloo ranks sharing {tag}")
    # (a) the port's single-device trainer on the same card, same seed
    t1 = time.perf_counter()
    single = Trainer(cfg, _phase16_train_config(), device=dev)
    state = single.init_state(TRAIN_SEQ, TRAIN_BATCH)
    single.run(state)
    want = single.history
    n_params = sum(t.numel() for t in single.model.tensors().values()
                   if t.is_floating_point())
    log(f"train16 one device: {n_params} float parameters, losses "
        f"{[round(h['loss'], 6) for h in want]}, host s per step "
        f"{[round(h['step_time_s'], 3) for h in want]} in "
        f"{time.perf_counter() - t1:.1f} s")
    del single, state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    moe_want = _moe_one_device(dev, moe_kw)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train16_"))
    try:
        t1 = time.perf_counter()
        err = _spawn_ranks(train_rank, world, tmp, TRAIN16_DEADLINE_S,
                           (SHARD_TIMEOUT_S, device, cfg_kw, moe_kw))
        if err:
            failures.append(f"train16 ranks: {err}")
            return None
        ranks = []
        for r in range(world):
            with open(tmp / f"train{r}.json") as f:
                ranks.append(json.load(f))
        for r, res in enumerate(ranks):
            failures.extend(f"train16 rank {r}: {f}"
                            for f in res["failures"])
        worst = 0.0
        for res in ranks:
            for g, w in zip(res["history"], want, strict=True):
                worst = max(worst, abs(g["loss"] - w["loss"])
                            / abs(w["loss"]))
        ok = worst <= TRAIN16_TOL
        gn = max(abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
                 for g, w in zip(ranks[0]["history"], want))
        log(f"train16 (a) {world} ranks against one device: largest loss "
            f"gap {worst:.3e} relative (tol {TRAIN16_TOL:g}), grad_norm "
            f"{gn:.3e}; the ranks in {time.perf_counter() - t1:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train16: loss gap {worst:.3e}")
        _tp_compare(ranks, want, moe_want, failures, world, tag)
        steps = ranks[0]["history"]
        host = [h["step_time_s"] for h in steps]
        comm = [max(res["comm_s"][i] for res in ranks)
                for i in range(len(steps))]
        log(f"train16 (d) per step (rank 0's host s, the slowest rank's "
            f"collectives): host {[round(x, 3) for x in host]} s, "
            f"collectives {[round(x, 3) for x in comm]} s "
            f"({[f'{c / h:.0%}' for c, h in zip(comm, host)]}), "
            f"{[round(TRAIN_SEQ * TRAIN_BATCH / h, 1) for h in host]} "
            f"tokens/s — gloo, host-staged, {world} ranks on one card: no "
            f"multi-card figure")
        b = [res["bytes"] for res in ranks]
        log(f"train16 (b) bytes at rest per rank: "
            f"{[x['held'] for x in b]} held, {[x['predicted'] for x in b]} "
            f"by the placements, {b[0]['whole']} on one device; replicated "
            f"by the fallback: {b[0]['fallback'] or 'none'}")
        _moe_compare(ranks, moe_want, failures, world, tag)
        # (c) the same checkpoint onto a 2-rank (2,) mesh
        t1 = time.perf_counter()
        err = _spawn_ranks(restore_rank, 2, tmp, TRAIN16_DEADLINE_S,
                           (SHARD_TIMEOUT_S, device, cfg_kw))
        if err:
            failures.append(f"train16 restore ranks: {err}")
        else:
            res2 = []
            for r in range(2):
                with open(tmp / f"restore{r}.json") as f:
                    res2.append(json.load(f))
            for r, res in enumerate(res2):
                failures.extend(f"train16 restore rank {r}: {f}"
                                for f in res["failures"])
            ok = not any(res["failures"] for res in res2)
            log(f"train16 (c) checkpoint of {TRAIN16_MESH} onto 2 ranks "
                f"(2,): {res2[0]['n']} parameters and moments a rank, "
                f"bitwise the file's {ok}, restore "
                f"{max(r['restore_s'] for r in res2):.1f} s, with the "
                f"spawn {time.perf_counter() - t1:.1f} s "
                f"{'ok' if ok else 'FAIL'}")
        # (e) the launcher's --mesh through its own ranks
        t1 = time.perf_counter()
        argv = ["--arch", SERVE_ARCH, "--sparse-ffn", "--mesh",
                "x".join(map(str, TRAIN16_MESH)), "--layers",
                str(cfg.n_layers), "--steps", str(TRAIN16_STEPS), "--seq",
                str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--micro",
                str(TRAIN16_MICRO)]
        text, err = _launcher_ranks(world, tmp, TRAIN16_DEADLINE_S, device,
                                    argv + _launcher_cfg_argv(cfg_kw))
        last = text.strip().splitlines()[-1] if text.strip() else ""
        ok = err is None and last.startswith(
            f"done: {TRAIN16_STEPS} steps, final loss ")
        log(f"train16 (e) launch/train.py {' '.join(argv)} on {world} "
            f"ranks of its own (tensor-parallel): last line {last!r} in "
            f"{time.perf_counter() - t1:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train16 launcher: {err or last}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 16 in {time.perf_counter() - t16:.1f} s")
    return ranks


# ------------------------- phase 16 (h): the recurrent mixers split


def _recurrent_cfgs(mamba_kw, rec_kw):
    """Phase 16 (h)'s two models at full width in float32 (``*_kw``
    overrides, a CPU rehearsal's narrow models): mamba2-780m cut to
    ``TRAIN16H_MAMBA_LAYERS`` and recurrentgemma-9b to the first
    ``TRAIN16H_RG_LAYERS`` layers of its pattern (``rec``, ``rec``) with
    the RgCSR FFN through the segment sum."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SparsityConfig
    fp32 = dict(dtype="float32", kv_cache_dtype="float32")
    mamba = dataclasses.replace(get_config(REC_MAMBA_ARCH), **dict(dict(
        n_layers=TRAIN16H_MAMBA_LAYERS, **fp32), **(mamba_kw or {})))
    rg = dataclasses.replace(get_config(REC_RG_ARCH), **dict(dict(
        n_layers=TRAIN16H_RG_LAYERS,
        sparsity=SparsityConfig(**TRAIN_SPARSITY), **fp32),
        **(rec_kw or {})))
    return mamba, rg


def _recurrent_runs(mamba_kw, rec_kw):
    """``(name, config)`` of phase 16 (h)'s runs, in the order the ranks
    take them."""
    mamba, rg = _recurrent_cfgs(mamba_kw, rec_kw)
    return (("rg tp", dataclasses.replace(rg, act_shard=True)),
            ("mamba2 tp", dataclasses.replace(mamba, act_shard=True)),
            ("mamba2 gather-at-use", mamba))


def dryrun_recurrent(out: str, mamba_kw_json: str, rec_kw_json: str):
    """Phase 16 (h)'s runs on rank 0 of a fake ``TRAIN16_MESH``, in a
    process of its own (the dry run's fake process group needs one): each
    run's predicted arguments and temporaries and its collective bytes by
    kind and mesh axis, as JSON in ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    res = {}
    for name, cfg in _recurrent_runs(json.loads(mamba_kw_json),
                                     json.loads(rec_kw_json)):
        r = dryrun.step_cost(cfg, TRAIN16_MESH, ("data", "model"),
                             seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                             microbatches=TRAIN16_MICRO, optimizer="adamw")
        mem = r["memory"]
        res[name] = {"args": mem["argument_size_in_bytes"],
                     "temps": mem["temp_size_in_bytes"],
                     "moved": r["cost"].collective_bytes_by_axis,
                     "seconds": r["build_s"] + r["run_s"]}
    with open(out, "w") as f:
        json.dump(res, f)


@contextlib.contextmanager
def _spy_model_gathers(model_ranks):
    """Counts, while open, the all-gathers on the ``model`` group (the
    group of ``model_ranks``): ``param`` — the elements gathered inside
    the tensor-parallel step's parameter gathers
    (``launch.steps._Binding.gather``), ``calls`` — every all-gather on
    that group (the activations' too)."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.sharding import layout
    seen = {"param": 0, "calls": 0}
    inside = [False]
    gather, dist_mod = steps._Binding.gather, layout.dist
    model_ranks = list(model_ranks)

    def counted(binding, name):
        inside[0] = True
        try:
            return gather(binding, name)
        finally:
            inside[0] = False

    class Dist:
        def __getattr__(self, name):
            fn = getattr(dist_mod, name)
            if name != "all_gather_into_tensor":
                return fn

            def all_gather(out, t, group=None, **kw):
                if dist.get_process_group_ranks(group) == model_ranks:
                    seen["calls"] += 1
                    if inside[0]:
                        seen["param"] += t.numel()
                return fn(out, t, group=group, **kw)
            return all_gather
    steps._Binding.gather, layout.dist = counted, Dist()
    try:
        yield seen
    finally:
        steps._Binding.gather, layout.dist = gather, dist_mod


def recurrent_rank(rank, world, tmp, timeout_s, device, mamba_kw, rec_kw,
                   serve_kw=None):
    """Phase 16 (h) on rank ``rank`` of ``world`` ranks sharing the card
    over gloo, spawned by :func:`recurrent_tp_phase`: each run of
    :func:`_recurrent_runs` in turn, its memory released before the
    next, then phase 20's serving runs (:func:`serve20_rank`; ``serve_kw``
    narrows granite in a CPU rehearsal); writes its results to
    ``tmp/rec<rank>.json``."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import mixer_gaps
    from repro_torch.sharding import Partitioner, layout
    from repro_torch.train.trainer import Trainer

    def say(msg):     # one write per line: the ranks share stdout
        os.write(1, f"train16 (h) r{rank}: {msg}\n".encode())

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store16h"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    timed = _TimedDist(dist, sync)
    layout.dist = timed
    out = {}
    t0 = time.perf_counter()
    try:     # a rank that raises fails the spawn, which ends the others
        mesh = make_mesh(TRAIN16_MESH, ("data", "model"),
                         device_type=dev.type)
        part = Partitioner(mesh, "train")
        model_ranks = dist.get_process_group_ranks(mesh.get_group(
            mesh.mesh_dim_names.index("model")))
        for name, cfg in _recurrent_runs(mamba_kw, rec_kw):
            tr = Trainer(cfg, _phase16_train_config(eps=TRAIN16H_EPS),
                         mesh=mesh, partitioner=part, device=dev)
            state = tr.init_state(TRAIN_SEQ, TRAIN_BATCH)
            stats = _count_collectives(tr, timed, dev)
            t1 = time.perf_counter()
            with _spy_model_gathers(model_ranks) as spy:
                tr.run(state)
            _say_steps(say, f"{name} ", tr.history, stats["comm_s"])
            say(f"{name}: {len(tr.history)} steps in "
                f"{time.perf_counter() - t1:.1f} s; peak per step "
                f"{stats['peak']} B; step 0's collective bytes "
                f"{stats['moved'][0]}; all-gathers over model: "
                f"{spy['calls']} calls, {spy['param']} parameter elements")
            res = {"history": tr.history, "spy": spy, **stats}
            if cfg.act_shard:
                # layer 0's mixer split against itself whole, at the step's
                # full-width shape, outside the step
                gen = torch.Generator().manual_seed(SEED)
                x, up = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model,
                                     generator=gen).to(dev)
                         for _ in range(2))
                t1 = time.perf_counter()
                res["unit"] = mixer_gaps(tr.model, part, "layers/0", x, up)
                say(f"{name}: layer 0's mixer split against whole on "
                    f"{tuple(x.shape)} in {time.perf_counter() - t1:.1f} s:"
                    f" {res['unit']}")
                del x, up
            out[name] = res
            del tr, state
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out["phase_s"] = time.perf_counter() - t0
        out["serve20"] = serve20_rank(mesh, dev, Path(tmp), _serve20_runs(
            serve_kw, mamba_kw, rec_kw), say)
    finally:
        dist.destroy_process_group()
    with open(Path(tmp) / f"rec{rank}.json", "w") as f:
        json.dump(out, f)


def _await_dryrun(procs, tmp: Path, name: str):
    """The JSON that dry run ``name`` of :func:`start_dryruns` wrote, once
    it ended (None when it failed or timed out)."""
    p, t0 = procs[name]
    try:
        p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                           - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    path = tmp / f"{name}.json"
    if p.returncode != 0 or not path.exists():
        log(f"train16 (h) dry run {name}: exit {p.returncode}: "
            f"{(tmp / f'{name}.log').read_text()[-1500:]}")
        return None
    return json.loads(path.read_text())


def _memory_plan(dev, pred, world, failures, tag):
    """Before the spawn: the card's free memory against ``world`` ranks'
    largest predicted peak plus a CUDA context each (this process's
    memory outside PyTorch's allocator); True when they fit."""
    import torch
    peaks = {k: v["args"] + v["temps"] for k, v in pred.items()}
    worst = max(peaks.values())
    text = ", ".join(f"{k} {v / 2**30:.3f}" for k, v in peaks.items())
    if dev.type != "cuda":
        log(f"train16 (h) memory plan: predicted peaks a rank, GiB: {text};"
            f" no card")
        return True
    free, total = torch.cuda.mem_get_info(dev)
    reserved = torch.cuda.memory_reserved(dev)
    context = max(total - free - reserved, 0)
    need = world * (worst + context)
    ok = need <= free
    log(f"train16 (h) memory plan: the card {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} (this process: {reserved / 2**30:.2f} GiB "
        f"reserved by PyTorch, {context / 2**30:.2f} GiB beside it, taken "
        f"as each rank's CUDA context); predicted peaks a rank, GiB: "
        f"{text}; {world} ranks x ({worst / 2**30:.3f} + "
        f"{context / 2**30:.3f}) = {need / 2**30:.2f} GiB "
        f"{'fit' if ok else 'do not fit'} {tag} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"train16 (h): {world} ranks need {need / 2**30:.2f}"
                        f" GiB, the card has {free / 2**30:.2f} free")
    return ok


def _recurrent_compare(ranks, want, pred, failures, world, tag):
    """Phase 16 (h)'s checks on the ranks' results (the module's note)."""
    rel = lambda g, w: abs(g - w) / max(abs(w), 1e-30)      # noqa: E731

    def fail(ok, what):
        if not ok:
            failures.append(f"train16 (h) {what}")
        return "ok" if ok else "FAIL"
    # mamba2 tensor-parallel against one device
    gaps = collections.defaultdict(float)
    for res in ranks:
        for g, w in zip(res["mamba2 tp"]["history"], want, strict=True):
            for k in ("loss", "grad_norm"):
                gaps[k] = max(gaps[k], rel(g[k], w[k]))
    ok = all(v <= TRAIN16_TOL for v in gaps.values())
    log(f"train16 (h) {REC_MAMBA_ARCH} tensor-parallel on {world} ranks "
        f"against one device: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                            gaps.items())
        + f" relative (tol {TRAIN16_TOL:g}) {tag} "
        + fail(ok, f"mamba2 against one device: {dict(gaps)}"))
    losses = [h["loss"] for h in ranks[0]["rg tp"]["history"]]
    ok = all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
             for res in ranks for h in res["rg tp"]["history"])
    log(f"train16 (h) {REC_RG_ARCH} tensor-parallel losses "
        f"{[round(x, 6) for x in losses]}, finite on every rank "
        + fail(ok, f"recurrentgemma losses {losses}"))
    # each mixer split against whole at full width, both against the
    # float64 whole: the float64 split the same function, the float32
    # split within the tolerance of the float32 whole's own rounding
    for name in ("rg tp", "mamba2 tp"):
        units = [res[name]["unit"] for res in ranks]
        worst = {k: {lab: max(u[k][lab] for u in units)
                     for lab in ("exact", "split", "whole")}
                 for k in units[0]}
        ok = all(v["exact"] <= TRAIN16H_UNIT_TOL
                 and v["split"] <= v["whole"] + TRAIN16H_UNIT_TOL
                 for v in worst.values())
        log(f"train16 (h) {name} layer 0's mixer split against whole on "
            f"({TRAIN_BATCH}, {TRAIN_SEQ}, d_model), the largest over the "
            f"ranks of |a - b| / max|b|, b the float64 whole, a the float64 "
            f"split / the float32 split / the float32 whole: "
            + ", ".join(f"{k} {v['exact']:.1e} / {v['split']:.2e} / "
                        f"{v['whole']:.2e}" for k, v in worst.items())
            + f"; float64 within {TRAIN16H_UNIT_TOL:g}, float32 within "
            f"{TRAIN16H_UNIT_TOL:g} of the whole's own {tag} "
            + fail(ok, f"{name} unit gaps {worst}"))

    def peak(steps):        # a run's largest step peak (None off the card)
        return None if None in steps else max(steps)
    peaks = {name: [peak(res[name]["peak"]) for res in ranks]
             for name in pred}
    on_card = peaks["rg tp"][0] is not None
    lower = on_card and all(t < g for t, g in zip(
        peaks["mamba2 tp"], peaks["mamba2 gather-at-use"]))
    log(f"train16 (h) per rank max_memory_allocated over a step, GiB: "
        + "; ".join(f"{k} {[_gib(x) for x in v]}" for k, v in peaks.items())
        + f"; {REC_MAMBA_ARCH} tensor-parallel below gather-at-use on every "
        f"rank {lower if on_card else 'n/a (no card)'} {tag} "
        + fail(lower or not on_card, f"mamba2 tensor-parallel peak "
               f"{peaks['mamba2 tp']} not below gather-at-use "
               f"{peaks['mamba2 gather-at-use']}"))
    for name, p in pred.items():
        want_b = p["args"] + p["temps"]
        ratio = [None if x is None else x / want_b for x in peaks[name]]
        ok = not on_card or all(r <= 1 + TRAIN16H_PEAK_SLACK for r in ratio)
        log(f"train16 (h) {name} peak a rank against the dry run's "
            f"{want_b / 2**30:.3f} GiB (arguments {p['args'] / 2**30:.3f} "
            f"+ temporaries {p['temps'] / 2**30:.3f}, on meta tensors): "
            f"measured/predicted "
            f"{[None if r is None else round(r, 4) for r in ratio]} "
            f"(at most {1 + TRAIN16H_PEAK_SLACK:g}) {tag} "
            + fail(ok, f"{name} peaks {peaks[name]} above the dry run's "
                   f"{want_b} + {TRAIN16H_PEAK_SLACK:.0%}"))
    for name in ("rg tp", "mamba2 tp", "mamba2 gather-at-use"):
        run = ranks[0][name]["moved"][0]
        if name in ("rg tp", "mamba2 tp"):
            same = pred[name]["moved"] == run
            log(f"train16 (h) {name} rank 0's collective bytes a step "
                f"{_bytes_line(run)}; a fake {TRAIN16_MESH} rank 0's "
                f"{_bytes_line(pred[name]['moved'])}; equal {same} {tag} "
                + fail(same, f"{name} bytes {run} against the dry run's "
                       f"{pred[name]['moved']}"))
        else:
            log(f"train16 (h) {name} rank 0's collective bytes a step "
                f"{_bytes_line(run)} {tag}")
    for name in ("rg tp", "mamba2 tp"):
        spied = [res[name]["spy"] for res in ranks]
        ok = all(s["param"] == 0 for s in spied)
        log(f"train16 (h) {name}: parameter elements all-gathered over "
            f"model {[s['param'] for s in spied]}, all-gathers over model "
            f"in the steps {[s['calls'] for s in spied]} (the mixers' "
            f"activations) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train16 (h) {name}: parameters gathered over "
                            f"model {spied}")
    for name in pred:
        host = [h["step_time_s"] for h in ranks[0][name]["history"]]
        comm = [max(res[name]["comm_s"][i] for res in ranks)
                for i in range(len(host))]
        log(f"train16 (h) {name} per step: host {[round(x, 3) for x in host]}"
            f" s, collectives {[round(x, 3) for x in comm]} s "
            f"({[f'{c / h:.0%}' for c, h in zip(comm, host)]}), "
            f"{[round(TRAIN_SEQ * TRAIN_BATCH / h, 1) for h in host]} "
            f"tokens/s {tag}")


def recurrent_tp_phase(dev, failures, tag, procs, dry_tmp, mamba_kw=None,
                       rec_kw=None, serve_kw=None):
    """Phase 16 (h), the recurrent mixers tensor-parallel on a
    ``TRAIN16_MESH`` mesh of gloo ranks sharing the card, a spawn of its
    own after phase 16's (see the module's note); ``procs``/``dry_tmp``:
    :func:`start_dryruns`'s, whose ``h`` run predicts the ranks'
    memory and collectives.  The same ranks then run phase 20's serving
    (its one-device runs here first): returns ``(phase 20's one-device
    results, each rank's phase 20 results)``, None where it failed."""
    import torch
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.train.trainer import Trainer
    th = time.perf_counter()
    device = dev.type
    world = int(np.prod(TRAIN16_MESH))
    mamba, rg = _recurrent_cfgs(mamba_kw, rec_kw)
    log(f"train16 (h): {REC_MAMBA_ARCH} d_model {mamba.d_model}, "
        f"{mamba.n_layers} layers, and {REC_RG_ARCH} d_model {rg.d_model}, "
        f"layers {layer_kinds(rg)} with the RgCSR FFN through the segment "
        f"sum (depths cut from their published ones), fp32, AdamW, "
        f"{TRAIN16_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens with "
        f"micro={TRAIN16_MICRO}, on a {TRAIN16_MESH} (data, model) mesh of "
        f"{world} gloo ranks sharing {tag}; {os.cpu_count()} host cores "
        f"(phase 19's dry runs may share them)")
    t1 = time.perf_counter()
    single = Trainer(mamba, _phase16_train_config(eps=TRAIN16H_EPS),
                     device=dev)
    single.run(single.init_state(TRAIN_SEQ, TRAIN_BATCH))
    want = single.history
    log(f"train16 (h) {REC_MAMBA_ARCH} one device: losses "
        f"{[round(h['loss'], 6) for h in want]}, grad_norm "
        f"{[round(h['grad_norm'], 6) for h in want]}, host s per step "
        f"{[round(h['step_time_s'], 3) for h in want]} in "
        f"{time.perf_counter() - t1:.1f} s")
    del single
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train16h_"))
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    try:
        t1 = time.perf_counter()
        serve_ref = serve20_reference(dev, tmp, _serve20_runs(
            serve_kw, mamba_kw, rec_kw))
        log(f"serve20 one-device runs in {time.perf_counter() - t1:.1f} s;"
            f" {card_memory()}")
        pred = _await_dryrun(procs, dry_tmp, "h")
        if pred is None:
            failures.append("train16 (h): no dry run")
            return None, None
        log(f"train16 (h) dry run of the runs on a fake {TRAIN16_MESH} "
            f"rank 0 in {sum(v['seconds'] for v in pred.values()):.1f} s")
        if not _memory_plan(dev, pred, world, failures, tag):
            return None, None
        # the ranks' allocator grows its segments in place: four
        # full-width ranks share one card
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t1 = time.perf_counter()
        err = _spawn_ranks(recurrent_rank, world, tmp, TRAIN16H_DEADLINE_S,
                           (SHARD_TIMEOUT_S, device, mamba_kw, rec_kw,
                            serve_kw))
        log(f"train16 (h) the ranks in {time.perf_counter() - t1:.1f} s")
        if err:
            failures.append(f"train16 (h) ranks: {err}")
            return None, None
        ranks = []
        for r in range(world):
            with open(tmp / f"rec{r}.json") as f:
                ranks.append(json.load(f))
        _recurrent_compare(ranks, want, pred, failures, world, tag)
        return serve_ref, [r["serve20"] for r in ranks]
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"phase 16 (h) in {time.perf_counter() - th:.1f} s")


# ------------------------------------------- phase 20: serving on a mesh


def _serve20_runs(cfg_kw=None, mamba_kw=None, rec_kw=None):
    """``(name, config, prompt, steps)`` of phase 20's runs, tensor-parallel
    in float32 (caches too): granite-3-2b at full width cut to
    ``SERVE20_LAYERS`` with the RgCSR FFN through K2, then phase 16 (h)'s
    two recurrent models, mamba2-780m cut to ``SERVE20_LAYERS`` and
    recurrentgemma-9b (``rec``, ``rec``) with K2 lanes (``*_kw``: a CPU
    rehearsal's narrow models)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SparsityConfig
    k2 = SparsityConfig(**SERVE_SPARSITY)
    granite = dataclasses.replace(get_config(SERVE_ARCH), **dict(dict(
        n_layers=SERVE20_LAYERS, sparsity=k2, act_shard=True,
        dtype="float32", kv_cache_dtype="float32"), **(cfg_kw or {})))
    mamba, rg = _recurrent_cfgs(mamba_kw, rec_kw)
    mamba = dataclasses.replace(mamba, n_layers=SERVE20_LAYERS,
                                act_shard=True)
    rg = dataclasses.replace(rg, sparsity=k2, act_shard=True)
    return (("granite", granite, SERVE20_PROMPT, SERVE20_STEPS),
            ("mamba2", mamba, SERVE20_REC_PROMPT, SERVE20_REC_STEPS),
            ("recurrentgemma", rg, SERVE20_REC_PROMPT, SERVE20_REC_STEPS))


def serve20_reference(dev, tmp: Path, runs):
    """Phase 20's one-device runs, in this process before the spawn: each
    run's prefill and greedy decode steps through ``make_prefill_step`` /
    ``make_decode_step`` on one device, saved for the ranks under
    ``tmp`` (the batch, every step's logits, the tokens fed, the caches
    after the prefill and after the last step); returns each run's top-2
    margins and largest logits per step and its times.  Each run's
    memory is released before the next and at the end (16 (h)'s memory
    plan reads the card after this)."""
    import torch
    out = {}
    for name, cfg, prompt, steps in runs:
        out[name] = _serve20_one_device(dev, tmp, name, cfg, prompt, steps)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _serve20_one_device(dev, tmp: Path, name, cfg, prompt, steps):
    """One run of :func:`serve20_reference` (its tensors die with this
    call)."""
    import torch
    from repro_torch.configs import concrete_inputs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import LanguageModel
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = LanguageModel(cfg, device=dev, seed=SEED)
    batch = concrete_inputs(cfg, batch=SERVE20_BATCH, seq=prompt,
                            kind="prefill", seed=SEED, device=dev)
    s_max = prompt + steps + 1
    prefill = make_prefill_step(model, s_max, "prefill")
    decode = make_decode_step(model, "decode")
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill(batch)
        sync()
        t_pre = time.perf_counter() - t0
        # the logits' real columns (the padding's are -1e30); copies of
        # the caches, which the decode steps write in place
        saved = {"batch": tree_to(batch, "cpu"),
                 "logits": [logits[..., :cfg.vocab].cpu()], "tokens": [],
                 "caches": [_copy_tree(caches)]}
        margins, peaks, t_dec = [], [], []
        for _ in range(steps):
            last = logits[:, -1, :cfg.vocab].float()
            top2 = torch.topk(last, 2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).min().item())
            peaks.append(last.abs().max().item())
            tok = torch.argmax(last, -1).to(torch.int32)[:, None]
            saved["tokens"].append(tok.cpu())
            t0 = time.perf_counter()
            logits, caches = decode(caches, tok)
            sync()
            t_dec.append(time.perf_counter() - t0)
            saved["logits"].append(logits[..., :cfg.vocab].cpu())
        saved["caches"].append(_copy_tree(caches))
    torch.save(saved, tmp / f"serve20_{name}.pt")
    log(f"serve20 {name} one device: prefill {SERVE20_BATCH} x {prompt} "
        f"in {t_pre * 1e3:.1f} ms, {steps} decode steps "
        f"{[round(t * 1e3, 2) for t in t_dec]} ms (host, synchronized)")
    return {"margins": margins, "peaks": peaks, "prefill_s": t_pre,
            "decode_s": t_dec}


def _copy_tree(tree):
    """A cache tree's tensors copied to the host (a copy on the host too:
    the decode steps write the caches in place)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def _flat_tensors(tree, prefix=""):
    """A cache tree's tensors keyed by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat_tensors(v, f"{prefix}{k}/"))
    return out


def serve20_rank(mesh, dev, tmp: Path, runs, say):
    """Phase 20 on one rank of phase 16 (h)'s spawn: each run of
    :func:`_serve20_runs` on the mesh, fed the one-device tokens
    (:func:`serve20_reference`'s file); per run this rank's gaps, token
    matches, cache gaps, launch counts and lane plans, host times, the
    prefill's and the last decode step's collective bytes by kind and
    axis, and its lane plans against K2's plain version."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.rgcsr_spmm import (rgcsr_spmm_launch,
                                                rgcsr_spmm_plain)
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.steps import (_Binding, make_decode_step,
                                          make_prefill_step,
                                          shard_for_serving)
    from repro_torch.models import LanguageModel
    from repro_torch.models.ffn import SparseLinear
    from repro_torch.sharding import Partitioner, layout
    from repro_torch.train.trainer import _attention_on
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    part_p, part_d = Partitioner(mesh, "prefill"), Partitioner(mesh, "decode")
    out = {}
    for name, cfg, prompt, steps in runs:
        t_run = time.perf_counter()
        ref = torch.load(tmp / f"serve20_{name}.pt")
        cfg = _attention_on(cfg, mesh)
        model = shard_for_serving(LanguageModel(cfg, device=dev, seed=SEED),
                                  part_p, device=dev)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        batch = tree_to(ref["batch"], dev)
        rows = part_p.batch_shardings(batch)["tokens"].placements()
        s_max = prompt + steps + 1
        prefill = make_prefill_step(model, s_max, "prefill",
                                    partitioner=part_p)
        decode = make_decode_step(model, "decode", partitioner=part_d)

        def mine(t):
            return layout.local_chunk(t.to(dev), mesh, rows)

        def gap(got, want):         # the real columns of the vocabulary
            want = mine(want).float()
            got = got[..., :cfg.vocab].float()
            return float((got - want).abs().max()
                         / (1.0 + want.abs().max()))

        def cache_gap(local, whole):
            want = _flat_tensors(part_p.local_caches(tree_to(whole, dev)))
            got = _flat_tensors(local)
            assert sorted(got) == sorted(want)
            return max(float((got[k].float() - want[k].float()).abs().max()
                             / (1.0 + want[k].float().abs().max()))
                       for k in got if got[k].numel())

        def match(logits, want):
            return bool(torch.equal(logits[:, -1, :cfg.vocab].argmax(-1),
                                    mine(want[:, -1].argmax(-1))))
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        with layout.collective_log() as log_p:
            logits, caches = prefill(batch)
        sync()
        res = {"prefill_s": time.perf_counter() - t0, "decode_s": [],
               "mode": cfg.attn_shard_mode,
               "moved_prefill": hlo_stats.moved_bytes(log_p)}
        res["gaps"] = [gap(logits, ref["logits"][0])]
        res["match"] = [match(logits, ref["logits"][0])]
        res["cache_gaps"] = [cache_gap(caches, ref["caches"][0])]
        for i, tok in enumerate(ref["tokens"]):
            t0 = time.perf_counter()
            with layout.collective_log() as log_d:
                logits, caches = decode(caches, tok.to(dev))
            sync()
            res["decode_s"].append(time.perf_counter() - t0)
            res["gaps"].append(gap(logits, ref["logits"][i + 1]))
            res["match"].append(match(logits, ref["logits"][i + 1]))
        res["moved_decode"] = hlo_stats.moved_bytes(log_d)
        res["counts"] = launch_counts()
        res["cache_gaps"].append(cache_gap(caches, ref["caches"][1]))
        res["lane_plans"] = [m.plan_builds for m in model.modules()
                             if isinstance(m, SparseLinear)]
        res["lanes"] = {}
        if res["lane_plans"]:
            # layer 0's lane plans against K2's plain version, at the
            # prefill's and a decode step's widths (not on the main path)
            view = part_p.tensor_parallel(model.spec())
            binding = _Binding(model, view, True)
            rows_here = mine(batch["tokens"]).shape[0]
            gen = torch.Generator().manual_seed(SEED)
            with torch.no_grad(), binding.step(model.tensors()), \
                    binding.bind(model.layers[0]):
                lay = model.layers[0].ffn.w_out
                for dtype, tol in ((torch.float32, FP32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    plan = lay.lane_plan(dtype, view)
                    for d in (rows_here * prompt, rows_here):
                        x = torch.randn(lay.d_in, d, generator=gen).to(
                            dev, dtype)
                        got = rgcsr_spmm_launch(plan, x)
                        args = (plan.values2d, plan.columns2d,
                                plan.step_group)
                        want = rgcsr_spmm_plain(*args, x,
                                                n_groups=plan.n_groups)
                        scale = rgcsr_spmm_plain(
                            plan.values2d.float().abs(), plan.columns2d,
                            plan.step_group, x.float().abs(),
                            n_groups=plan.n_groups)
                        diff = (got.float() - want.float()).abs()
                        res["lanes"][f"{str(dtype)[6:]} d{d}"] = (
                            float(diff.max()),
                            bool((diff <= tol * (1 + scale)).all()),
                            plan.group_size)
        res["run_s"] = time.perf_counter() - t_run
        say(f"serve20 {name}: attention {res['mode']}, prefill "
            f"{res['prefill_s'] * 1e3:.1f} ms, decode steps "
            f"{[round(t * 1e3, 1) for t in res['decode_s']]} ms (host, "
            f"gloo on one card), largest logit gap {max(res['gaps']):.3e},"
            f" cache gaps {res['cache_gaps']}, K2 launches "
            f"{res['counts']['rgcsr_spmm']}, lane plans "
            f"{res['lane_plans']}, lanes {res['lanes']}, in "
            f"{res['run_s']:.1f} s")
        out[name] = res
        del model, caches, logits, prefill, decode, ref
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _serve20_entries(dev, granite, ranks, tag):
    """K2 on rank 0's lane plan of granite-3-2b's ``w_out`` (its first
    ``G/2`` lanes, a layer drawn as the model draws it), with the card to
    this process: at the prefill's and a decode step's widths a rank,
    fp32, beside its bound, its plain version and the PyTorch CSR product
    of the same lanes; kernel entries for the result line."""
    import torch
    from repro_torch.kernels.rgcsr_spmm import (rgcsr_spmm_launch,
                                                rgcsr_spmm_plain)
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models.spec import init_from_spec
    n = TRAIN16_MESH[1]
    d_in, d_out = granite.d_ff, granite.d_model
    params = init_from_spec(ffn_mod.sparse_linear_spec(granite, d_in, d_out),
                            torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    lanes = granite.sparsity.group_size // n
    part = {k: (v[:, :lanes].contiguous() if k in ("values2d", "columns2d")
                else v) for k, v in params.items()}
    lay = ffn_mod.SparseLinear(part, granite, d_in=d_in, d_out=d_out)
    view = type("View", (), {"size": n, "rank": 0})()
    plan = lay.lane_plan(torch.float32, view)
    live = int(plan.seg_slots.sum()) * 32
    real = int(((plan.values2d != 0) | (plan.columns2d != 0)).sum())
    rows = torch.arange(plan.values2d.shape[0], device=dev)
    grp = plan.step_group.long().repeat_interleave(8)[rows]
    out_row = (grp[:, None] * lanes + torch.arange(lanes, device=dev)
               ).reshape(-1)
    dense = torch.zeros((plan.n_rows, d_in), device=dev)
    dense.index_put_((out_row, plan.columns2d.reshape(-1).long()),
                     plan.values2d.reshape(-1), accumulate=True)
    csr = dense.to_sparse_csr()
    del dense
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 1
    r0 = ranks[0]["granite"]
    entries = []
    rng = np.random.default_rng(SEED)
    for what, d in (("prefill", SERVE20_BATCH // TRAIN16_MESH[0]
                     * SERVE20_PROMPT),
                    ("decode", SERVE20_BATCH // TRAIN16_MESH[0])):
        x = torch.from_numpy(rng.standard_normal((d_in, d)).astype(
            np.float32)).to(dev)
        w = plan.work_list("rgcsr_spmm", n_sm=n_sm, part_bytes=lanes * d * 4)
        meta = plan.seg_slots.nbytes + w.items.nbytes + w.combine.nbytes
        nbytes = live * 8 + x.nbytes + plan.n_rows * d * 4 + meta
        b_ms, b_by = bound(nbytes, 2 * real * d)
        run = lambda: rgcsr_spmm_launch(plan, x)        # noqa: E731
        e = {"name": f"rgcsr_spmm@{SERVE_ARCH} w_out lanes {lanes}/"
                     f"{granite.sparsity.group_size} d{d} fp32 (serve20 "
                     f"{what}, rank 0 of {TRAIN16_MESH})",
             "route": "cuda", "source": KERNEL_META["rgcsr_spmm"][0],
             "replaces": KERNEL_META["rgcsr_spmm"][1],
             "launches": r0["counts"]["rgcsr_spmm"],
             "max_abs_err": r0["lanes"][f"float32 d{d}"][0],
             "ms": card_ms(run, 20, dev, hold=True),
             "cold_ms": card_ms(run, 20, dev, cold=True),
             "wait_ms": card_ms(run, 20, dev),
             "plain_ms": card_ms(lambda: rgcsr_spmm_plain(
                 plan.values2d, plan.columns2d, plan.step_group, x,
                 n_groups=plan.n_groups), 2, dev, hold=True),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": card_ms(lambda: csr @ x, 10, dev, hold=True),
             "library_cold_ms": card_ms(lambda: csr @ x, 10, dev,
                                        cold=True),
             "live_slots": live, "real_slots": real}
        log(f"time {e['name']}: kernel {e['ms']:.4f} ms (cold "
            f"{e['cold_ms']:.4f}, caller waits {e['wait_ms']:.4f}), plain "
            f"{e['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {live} "
            f"live slots, {real} real), csr fp32 {e['library_ms']:.4f} ms "
            f"(cold {e['library_cold_ms']:.4f}), {e['launches']} launches "
            f"on rank 0's main path {tag}")
        entries.append(e)
    return entries


def serve20_phase(dev, failures, tag, ref, ranks, runs, entries):
    """Phase 20's checks on the ranks' results (the module's note), then
    K2's times on rank 0's lane plan."""
    t20 = time.perf_counter()
    if ref is None or ranks is None:
        failures.append("serve20: no run (phase 16 (h) failed first)")
        return

    def fail(ok, what):
        if not ok:
            failures.append(f"serve20 {what}")
        return "ok" if ok else "FAIL"
    for name, cfg, prompt, steps in runs:
        res = [r[name] for r in ranks]
        worst = max(max(x["gaps"]) for x in res)
        log(f"serve20 {name} on {TRAIN16_MESH} against one device: "
            f"attention {res[0]['mode']}, the largest gap of a rank's "
            f"logits over the prefill and {steps} steps {worst:.3e} · (1 + "
            f"max|logit|) (tol {MAIN_TOL:g}) {tag} "
            + fail(worst <= MAIN_TOL, f"{name} logits {worst}"))
        margins, peaks = ref[name]["margins"], ref[name]["peaks"]
        close = [i for i, (m, p) in enumerate(zip(margins, peaks))
                 if m < MARGIN_TOL * p]
        upto = close[0] if close else steps
        ok = all(all(x["match"][:upto + 1]) for x in res)
        log(f"serve20 {name} greedy tokens equal on every rank up to step "
            f"{upto} (the first top-2 margin below {MARGIN_TOL:g} · "
            f"max|logit| in the one-device run, or the last) "
            f"{[x['match'] for x in res]} "
            + fail(ok, f"{name} tokens {[x['match'] for x in res]}"))
        cg = max(max(x["cache_gaps"]) for x in res)
        log(f"serve20 {name} cache slices after the prefill and the last "
            f"step against the one-device caches' slices: largest gap "
            f"{cg:.3e} (tol {MAIN_TOL:g}) "
            + fail(cg <= MAIN_TOL, f"{name} caches {cg}"))
        sparse = cfg.sparsity.enabled
        want_k2 = cfg.n_layers * (1 + steps) if sparse else 0
        k2 = [x["counts"]["rgcsr_spmm"] for x in res]
        others = [x["counts"][k] for x in res for k in x["counts"]
                  if k != "rgcsr_spmm"]
        plans = [x["lane_plans"] for x in res]
        ok = k2 == [want_k2] * len(res) and not any(others) and all(
            p == [1] * (cfg.n_layers if sparse else 0) for p in plans)
        log(f"serve20 {name} K2 launches a rank {k2} (want {want_k2} = "
            f"{cfg.n_layers} layers x (1 prefill + {steps} steps)), no "
            f"other kernel, lane plans a rank {plans} "
            + fail(ok, f"{name} launches {k2} plans {plans}"))
        if sparse:
            checks = [v for x in res for v in x["lanes"].values()]
            ok = bool(checks) and all(v[1] for v in checks)
            log(f"serve20 {name} each rank's lane plan "
                f"({checks[0][2] if checks else '?'} lanes) against K2's "
                f"plain version at {sorted(res[0]['lanes'])} (fp32 "
                f"{FP32_TOL:g}, bf16 {BF16_TOL:g}): largest |diff| "
                f"{max((v[0] for v in checks), default=float('nan')):.3e} "
                + fail(ok, f"{name} lane plans against plain"))
        host_p = [x["prefill_s"] for x in res]
        host_d = [sum(x["decode_s"]) / steps for x in res]
        log(f"serve20 {name} host times on the mesh (gloo on one card, "
            f"not a multi-card figure): prefill {max(host_p) * 1e3:.1f} ms,"
            f" decode {max(host_d) * 1e3:.1f} ms a step; one device "
            f"{ref[name]['prefill_s'] * 1e3:.1f} / "
            f"{sum(ref[name]['decode_s']) / steps * 1e3:.1f} ms; rank 0's "
            f"collective bytes: prefill {_bytes_line(res[0]['moved_prefill'])}"
            f", a decode step {_bytes_line(res[0]['moved_decode'])} {tag}")
    entries.extend(_serve20_entries(dev, runs[0][1], ranks, tag))
    ran = max(sum(x["run_s"] for x in r.values()) for r in ranks)
    log(f"phase 20 checks in {time.perf_counter() - t20:.1f} s (its ranks "
        f"ran in phase 16 (h)'s spawn: {ran:.1f} s a rank)")


# ------------------------------------------------------ phase 17: remat


def _remat_steps(dev, base, batches, what, tag):
    """``base`` under each remat, from the seed: the loss and backward of
    the first batch, with the memory the forward leaves held for the
    backward (what remat trades) and their peak, both above what was
    allocated before (AdamW's update of the 403 MB embedding sets a whole
    step's peak), then two train steps, the second timed: {remat: (loss,
    step-2 loss, peak B, before B, step peak B, warm step ms, held B)}."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LanguageModel
    from repro_torch.train.optimizer import OptimizerConfig
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    peak_now = torch.cuda.max_memory_allocated if cuda else (lambda: 0)
    res = {}
    for remat in ("none", "full", "dots"):
        model = LanguageModel(dataclasses.replace(base, remat=remat),
                              device=dev, seed=SEED).requires_grad_(True)
        sync()
        resident = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batches[0].items()}
        loss, _ = model.loss(batch)
        sync()
        held = (torch.cuda.memory_allocated() if cuda else 0) - resident
        loss.backward()
        first = float(loss)
        sync()
        peak = peak_now()
        del loss
        for p in model.parameters():
            p.grad = None
        step, init = make_train_step(model, OptimizerConfig(
            warmup_steps=2, decay_steps=TRAIN16_STEPS))
        params = model.tensors()
        state = init(params)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        params, state, _ = step(params, state, batches[0])
        sync()
        step_peak = peak_now()
        t1 = time.perf_counter()
        params, state, m2 = step(params, state, batches[1])
        second = float(m2["loss"])
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        res[remat] = (first, second, peak, resident, step_peak, ms, held)
        log(f"remat {what} {remat}: loss {first:.6f}; the forward holds "
            f"{held / 2**30:.3f} GiB for the backward, forward and backward "
            f"peak {(peak - resident) / 2**30:.3f} GiB, above the "
            f"{resident / 2**30:.3f} GiB allocated before; a train step's "
            f"peak {step_peak / 2**30:.3f} GiB (AdamW's moments and update "
            f"in it); warm step {ms:.1f} ms (host, ending in a "
            f"synchronize), its loss {second:.6f} {tag}")
        del model, step, params, state, m2, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return res


def remat_phase(dev, failures, tag, cfg_kw=None):
    """Phase 17: one train step of phase 16's granite-3-2b on one device
    under each remat, from the same seed on the same batch, then a warm
    step that is timed; with the RgCSR FFN (the segment sum, not a matrix
    product) and with the dense FFN."""
    from repro_torch.configs.base import SparsityConfig
    from repro_torch.train.data import DataConfig, make_batch
    t17 = time.perf_counter()
    sparse = _phase16_cfg(dict(cfg_kw or {}))
    batches = [make_batch(DataConfig(vocab=sparse.vocab, seq_len=TRAIN17_SEQ,
                                     global_batch=TRAIN17_BATCH, seed=SEED),
                          i) for i in range(2)]
    log(f"remat: {sparse.name} d_model {sparse.d_model}, {sparse.n_layers} "
        f"layers (phase 16's cut), fp32, AdamW, one device, "
        f"{TRAIN17_BATCH} x {TRAIN17_SEQ} tokens a step; the FFN in RgCSR "
        f"through the segment sum (sparse), then dense")
    for what, base in (("sparse", sparse), ("dense", dataclasses.replace(
            sparse, sparsity=SparsityConfig()))):
        res = _remat_steps(dev, base, batches, what, tag)
        want = res["none"][0]
        gap = max(abs(r[0] - want) / abs(want) for r in res.values())
        ok = gap <= TRAIN17_TOL and all(np.isfinite(r[1])
                                        for r in res.values())
        held = {k: round(r[6] / 2**30, 3) for k, r in res.items()}
        peaks = {k: round((r[2] - r[3]) / 2**30, 3) for k, r in res.items()}
        times = {k: round(r[5], 1) for k, r in res.items()}
        log(f"remat {what}: losses equal within {gap:.3e} relative "
            f"(tol {TRAIN17_TOL:g}) {'ok' if ok else 'FAIL'}; GiB held "
            f"for the backward {held}; forward and backward peak GiB "
            f"{peaks}; warm step ms {times}; dots between none and full: "
            f"held {held['full'] <= held['dots'] <= held['none']}, time "
            f"{times['none'] <= times['dots'] <= times['full']}")
        if not ok:
            failures.append(f"remat {what}: loss gap {gap:.3e}")
    log(f"phase 17 in {time.perf_counter() - t17:.1f} s")


# ------------------------------------------- phase 18: the example twins


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twins_phase(dev, failures, tag):
    """Phase 18: the four example twins through their ``main(argv)`` on
    ``dev``, their output logged line by line; the launch counters, set to
    0 just before and read just after, show K1 and K3."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t18 = time.perf_counter()
    reset_launch_counts()
    for name, argv in TWIN_RUNS:
        argv = list(argv) + ["--device", dev.type]
        buf = io.StringIO()
        t1 = time.perf_counter()
        err = None
        try:
            with contextlib.redirect_stdout(buf):
                _load_example(name).main(argv)
        except Exception as exc:      # noqa: BLE001 — fail the phase
            err = f"{type(exc).__name__}: {exc}"
        for line in buf.getvalue().splitlines():
            log(f"twins {name}: {line}")
        log(f"twins {name} {' '.join(argv)} in "
            f"{time.perf_counter() - t1:.1f} s "
            f"{'ok' if err is None else 'FAIL ' + err}")
        if err is not None:
            failures.append(f"twins {name} {' '.join(argv)}: {err}")
    counts = launch_counts()
    ok = counts["rgcsr_spmv"] > 0 and counts["ell_spmv"] > 0
    log(f"twins launch counts {counts}: K1 and K3 launched "
        f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        failures.append(f"twins launch counts {counts}")
    log(f"phase 18 in {time.perf_counter() - t18:.1f} s")


# ----------------------------------------------------- phase 19: dry run


def _dryrun_parts(cfg_kw):
    """Phase 19 (b) and (c): ``(name, config, mesh shape, axes,
    microbatches)`` of phase 16 (g)'s tensor-parallel cell and of phase
    10's one-device step (``cfg_kw`` narrows both in a CPU rehearsal)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SparsityConfig
    tp = dataclasses.replace(_phase16_cfg(cfg_kw), act_shard=True)
    one = dataclasses.replace(get_config(SERVE_ARCH), **dict(dict(
        sparsity=SparsityConfig(**TRAIN_SPARSITY)), **cfg_kw))
    return (("b", tp, TRAIN16_MESH, ("data", "model"), TRAIN16_MICRO),
            ("c", one, (1,), ("model",), 1))


def dryrun_small(out: str, cfg_kw_json: str) -> None:
    """Phase 19 (b) and (c) in a process of their own (the dry run's fake
    process group needs one): each step's cost and memory as JSON in
    ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    res = {}
    for name, cfg, mesh, axes, micro in _dryrun_parts(
            json.loads(cfg_kw_json)):
        r = dryrun.step_cost(cfg, mesh, axes, seq=TRAIN_SEQ,
                             batch=TRAIN_BATCH, microbatches=micro,
                             optimizer="adamw")
        cost = r["cost"]
        res[name] = {"flops": cost.flops, "bytes": cost.bytes,
                     "moved": cost.collective_bytes_by_axis,
                     "memory": r["memory"], "roofline": r["roofline"],
                     "bottleneck": r["bottleneck"],
                     "attn_shard_mode": r["attn_shard_mode"],
                     "seconds": r["build_s"] + r["run_s"]}
    # (d) phase 20's granite serving cell: its prefill and a decode step
    granite = _serve20_runs(json.loads(cfg_kw_json) or None)[0][1]
    for name, kind, seq in (("d prefill", "prefill", SERVE20_PROMPT),
                            ("d decode", "decode",
                             SERVE20_PROMPT + SERVE20_STEPS + 1)):
        r = dryrun.serve_cost(granite, TRAIN16_MESH, ("data", "model"),
                              shape_kind=kind, seq=seq, batch=SERVE20_BATCH)
        res[name] = {"moved": r["cost"].collective_bytes_by_axis,
                     "flops": r["cost"].flops,
                     "attn_shard_mode": r["attn_shard_mode"],
                     "seconds": r["build_s"] + r["run_s"]}
    with open(out, "w") as f:
        json.dump(res, f)


_BACKGROUND = []


def _stop_background():
    """Kill what :func:`start_dryruns` started and still runs."""
    for p in _BACKGROUND:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_dryruns(tmp: Path, cfg_kw=None, mamba_kw=None, rec_kw=None):
    """Start phase 19's dry runs in the background, each a process of its
    own on the host alone (no card): the cells of ``DRYRUN_CELLS`` through
    ``python -m repro_torch.launch.dryrun``, :func:`dryrun_small` and
    phase 16 (h)'s :func:`dryrun_recurrent` (``h``).  Returns ``{name:
    (process, start time)}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = {}
    for arch, multi in DRYRUN_CELLS:
        runs[arch] = [sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", arch, "--shape", "train_4k", "--out",
                      str(tmp / f"{arch}.json")] + (["--multi-pod"]
                                                     if multi else [])
    runs["bc"] = [sys.executable, "-c",
                  f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                  f"import chip_smoke; chip_smoke.dryrun_small("
                  f"{str(tmp / 'bc.json')!r}, "
                  f"{json.dumps(cfg_kw or {})!r})"]
    runs["h"] = [sys.executable, "-c",
                 f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                 f"import chip_smoke; chip_smoke.dryrun_recurrent("
                 f"{str(tmp / 'h.json')!r}, {json.dumps(mamba_kw or {})!r}, "
                 f"{json.dumps(rec_kw or {})!r})"]
    procs = {}
    for name, argv in runs.items():
        with open(tmp / f"{name}.log", "w") as f:
            p = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=f,
                                 stderr=subprocess.STDOUT)
        _BACKGROUND.append(p)
        procs[name] = (p, time.perf_counter())
    return procs


def _terms_ok(rl):
    return all(np.isfinite(v) and v > 0 for v in rl.values())


def _predicted_line(what, part, measured_peak, step_s, failures, tag):
    """Phase 19 (b)/(c): the predicted peak beside the measured one, and
    the roofline's lower bound, which must not exceed the step's time."""
    mem = part["memory"]
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    bound = max(part["roofline"][k] for k in ("compute_s", "memory_s",
                                              "collective_s"))
    ok = bound <= step_s
    log(f"dryrun ({what}) peak a rank: predicted {peak / 2**30:.3f} GiB "
        f"(arguments {mem['argument_size_in_bytes'] / 2**30:.3f} + "
        f"temporaries {mem['temp_size_in_bytes'] / 2**30:.3f}, counted "
        f"on meta tensors), measured {_gib(measured_peak)} GiB {tag}; "
        f"roofline lower bound "
        f"{bound * 1e3:.3f} ms ({part['bottleneck']}; compute "
        f"{part['roofline']['compute_s'] * 1e3:.3f}, memory "
        f"{part['roofline']['memory_s'] * 1e3:.3f}, collective "
        f"{part['roofline']['collective_s'] * 1e3:.3f} ms, a prediction "
        f"from launch.mesh.HW) against the fastest measured step "
        f"{step_s * 1e3:.1f} ms {tag} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"dryrun ({what}): bound {bound} s above the "
                        f"measured step {step_s} s")


def dryrun_phase(procs, tmp: Path, train16, train10, failures, tag,
                 serve20=None):
    """Phase 19: collect the dry runs started after phase 10 and hold
    them against what phases 10, 16 and 20 (``serve20``: its ranks'
    results) measured (the module's note)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    t19 = time.perf_counter()
    for name, (p, t0) in procs.items():
        try:
            p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                               - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        tail = (tmp / f"{name}.log").read_text()[-1500:]
        log(f"dryrun {name}: exit {p.returncode}, collected "
            f"{time.perf_counter() - t0:.1f} s after its start")
        if p.returncode != 0:
            failures.append(f"dryrun {name}: exit {p.returncode}: {tail}")
    # (a) production cells
    for arch, multi in DRYRUN_CELLS:
        path = tmp / f"{arch}.json"
        recs = json.loads(path.read_text()) if path.exists() else []
        rec = recs[0] if recs else {"status": "missing"}
        ok = rec.get("status") == "ok" and _terms_ok(rec["roofline"])
        mesh = "2x16x16" if multi else "16x16"
        if rec.get("status") == "ok":
            rl = rec["roofline"]
            log(f"dryrun (a) {arch} train_4k on {mesh}: "
                f"{rec['build_s'] + rec['run_s']:.1f} s (build "
                f"{rec['build_s']} + step {rec['run_s']}), "
                f"{rec['microbatches']} microbatches, attention "
                f"{rec['attn_shard_mode']}; a prediction from "
                f"launch.mesh.HW: compute {rl['compute_s']:.4f} s, memory "
                f"{rl['memory_s']:.4f} s, collective "
                f"{rl['collective_s']:.4f} s, bottleneck "
                f"{rec['bottleneck']}, MODEL_FLOPs/HLO "
                f"{rec['model_flops_ratio']:.3f}, HBM "
                f"{dryrun.hbm_gib(rec):.2f} GiB a device "
                f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"dryrun (a) {arch} on {mesh}: "
                            f"{rec.get('error', rec.get('status'))}")
    path = tmp / "bc.json"
    parts = json.loads(path.read_text()) if path.exists() else {}
    # (b) phase 16 (g)'s tensor-parallel cell on a fake (2, 2) mesh
    b = parts.get("b")
    if b is None or train16 is None:
        failures.append("dryrun (b): no dry run or no phase 16 run")
    else:
        run = train16[0]["tp"]["tp"]
        same = b["moved"] == run["moved"][0]
        log(f"dryrun (b) phase 16 (g)'s cell on a fake {TRAIN16_MESH} "
            f"(attention {b['attn_shard_mode']}, {b['seconds']:.1f} s): "
            f"rank 0's collective bytes a step {_bytes_line(b['moved'])}; "
            f"measured {_bytes_line(run['moved'][0])}; equal {same} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"dryrun (b): bytes {b['moved']} against "
                            f"{run['moved'][0]}")
        peaks = [x for x in run["peak"] if x is not None]
        _predicted_line("b", b, max(peaks) if peaks else None,
                        min(h["step_time_s"] for h in run["history"]),
                        failures, tag)
    # (c) phase 10's one-device step
    c = parts.get("c")
    if c is None or train10 is None:
        failures.append("dryrun (c): no dry run or no phase 10 run")
    else:
        log(f"dryrun (c) phase 10's one-device step ({c['seconds']:.1f} "
            f"s): {c['flops']:.4e} product FLOPs, {c['bytes']:.4e} bytes")
        _predicted_line("c", c, train10["peak"], min(train10["step_s"]),
                        failures, tag)
    # (d) phase 20's granite serving cell against its gloo rank 0
    for what, key in (("prefill", "moved_prefill"),
                      ("decode", "moved_decode")):
        d = parts.get(f"d {what}")
        if d is None or serve20 is None:
            failures.append(f"dryrun (d) {what}: no dry run or no phase 20 "
                            f"run")
            continue
        run = serve20[0]["granite"][key]
        same = d["moved"] == run
        log(f"dryrun (d) phase 20's {SERVE_ARCH} {what} on a fake "
            f"{TRAIN16_MESH} (attention {d['attn_shard_mode']}, "
            f"{d['seconds']:.1f} s): rank 0's collective bytes "
            f"{_bytes_line(d['moved'])}; phase 20's gloo rank 0 "
            f"{_bytes_line(run)}; equal {same} {'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"dryrun (d) {what}: bytes {d['moved']} against "
                            f"{run}")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 19 in {time.perf_counter() - t19:.1f} s (the dry runs "
        f"started after phase 10)")


def _launcher_cfg_argv(cfg_kw):
    """The launcher's flags for a CPU rehearsal's narrow model (none on
    the card)."""
    return ["--smoke"] if cfg_kw else []


# --------------------------------------------------------------------- main


def main() -> int:
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found beside this script)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import SparsityConfig
    from repro_torch.core import COO, ELLPACK, from_csr, spmm, spmv
    from repro_torch.core import timing
    from repro_torch.core.timing import time_us
    from repro_torch.kernels import (PLAN_CACHE, _build, autotune,
                                     launch_counts, ops, reset_launch_counts)
    from repro_torch.kernels.ell_spmv import ell_spmv_launch, ell_spmv_plain
    from repro_torch.kernels.rgcsr_spmm import (rgcsr_spmm_launch,
                                                rgcsr_spmm_plain)
    from repro_torch.kernels.rgcsr_spmv import (rgcsr_spmv_launch,
                                                rgcsr_spmv_plain)
    from repro_torch.models import LanguageModel
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models import model_spec
    from repro_torch.models.spec import (P, count_params, init_from_spec,
                                         spec_leaves)
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.obs import export as obs_export
    from repro_torch.serve import (Engine, Request, Router, RouterConfig,
                                   ServeConfig)
    from repro_torch.serve import paging
    from repro_torch.serve import router as router_mod
    from repro_torch.train import data as train_data
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.fault import FaultConfig, FaultInjector
    from repro_torch.train.optimizer import OptimizerConfig

    dev = torch.device(DEVICE)
    failures = []

    phase("1 card and build")
    # ---- 1. card and build
    smi = card_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_logs = _build.build(force=True)
    log(f"build: {len(build_logs)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase("2 matrices")
    # ---- 2. matrices
    t0 = time.perf_counter()
    fem_csr = fem2d_csr(2048, 2048)
    raj_csr = raj1_csr()
    cut_csr = fem2d_csr(32, 2048)
    log(f"csr: fem2d_2048 {fem_csr.shape[0]} rows {fem_csr.nnz} nnz; "
        f"raj1_full {raj_csr.shape[0]} rows {raj_csr.nnz} nnz, max row "
        f"{np.diff(raj_csr.indptr).max()}; built in "
        f"{time.perf_counter() - t0:.1f} s")

    def build(a, fmt, **kw):
        return from_csr(a.data, a.indices, a.indptr, a.shape, fmt,
                        device=dev, **kw)

    t0 = time.perf_counter()
    fem = build(fem_csr, "rgcsr")
    raj = build(raj_csr, "rgcsr")
    cut = build(cut_csr, "rgcsr")
    fem_ell = build(fem_csr, "ellpack")
    raj_hyb = build(raj_csr, "hybrid")
    torch.cuda.synchronize()
    log(f"formats on the card in {time.perf_counter() - t0:.1f} s: "
        f"fem2d rgcsr {fem.stored_elements} slots, ellpack "
        f"{tuple(fem_ell.values.shape)}; raj1 rgcsr {raj.stored_elements} "
        f"slots, hybrid k1={raj_hyb.k1} + {raj_hyb.coo_values.shape[0]} coo")

    rng, x_np, xm_np = main_inputs(fem_csr, raj_csr)
    x = {k: torch.from_numpy(v).to(dev) for k, v in x_np.items()}
    xm = {k: torch.from_numpy(v).to(dev) for k, v in xm_np.items()}
    raj_ell = ELLPACK(values=raj_hyb.ell_values, columns=raj_hyb.ell_columns,
                      shape=raj_hyb.shape)
    raj_coo = COO(values=raj_hyb.coo_values, rows=raj_hyb.coo_rows,
                  columns=raj_hyb.coo_columns, shape=raj_hyb.shape)

    phase("3 kernels against their plain versions")
    # ---- 3. each kernel against its plain version, on the card
    t0 = time.perf_counter()

    errs = {}     # (kernel, matrix) -> max_abs_err at the main path's shapes

    def hold(kernel, label, got, want, scale, tol, key=None):
        """``scale``: Σ_j |a_ij · x_j| per output element."""
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= tol * (1 + scale)).all())
        if key:
            errs[(kernel, key)] = err
        log(f"check {kernel} {label}: max_abs_err {err:.3e} tol {tol:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {label}")

    def k1_check(label, plan, xv, dtype=torch.float32, tol=FP32_TOL,
                 x_tile=None, key=None, piece_rows=None):
        plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
        xp = xv.to(dtype)
        want, scale = (rgcsr_spmv_plain(
            v, plan.columns2d, plan.step_group, xs, n_groups=plan.n_groups,
            chunks_per_step=plan.chunks_per_step).float()
            for v, xs in ((plan.values2d, xp),
                          (plan.values2d.float().abs(), xp.float().abs())))
        if x_tile is None:
            got = rgcsr_spmv_launch(plan, xp, piece_rows=piece_rows)
        else:   # the reference's x column tile; K1 reads x whole
            got = ops.rgcsr_spmv(plan, xp, x_tile=x_tile)
            want = want.reshape(-1)[: plan.n_rows]
            scale = scale.reshape(-1)[: plan.n_rows]
        hold("rgcsr_spmv", label, got, want, scale, tol, key)

    def k2_check(label, plan, xv, dtype=torch.float32, tol=FP32_TOL,
                 key=None, piece_rows=None):
        plan = dataclasses.replace(plan, values2d=plan.values2d.to(dtype))
        vals = plan.values2d
        xv = xv.to(dtype)
        got = rgcsr_spmm_launch(plan, xv, piece_rows=piece_rows)
        want, scale = (rgcsr_spmm_plain(
            v, plan.columns2d, plan.step_group, xs, n_groups=plan.n_groups,
            chunks_per_step=plan.chunks_per_step).float()
            for v, xs in ((vals, xv), (vals.float().abs(), xv.float().abs())))
        hold("rgcsr_spmm", label, got, want, scale, tol, key)

    def k3_check(label, plan, xv, dtype=torch.float32, tol=FP32_TOL,
                 key=None):
        vals = plan.values2d.to(dtype)
        xp = xv.to(dtype)
        got = ell_spmv_launch(vals, plan.columns2d, xp)
        want = ell_spmv_plain(vals, plan.columns2d, xp)
        scale = ell_spmv_plain(vals.float().abs(), plan.columns2d,
                               xp.float().abs())
        hold("ell_spmv", label, got, want, scale, tol, key)

    t1 = time.perf_counter()
    fem_plan = ops.make_plan(fem)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    raj_plan = ops.make_plan(raj)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for p in (fem_plan, raj_plan):   # the work lists of the main path
        p.work_list("rgcsr_spmv", n_sm=n_sm, part_bytes=p.group_size * 4)
        p.work_list("rgcsr_spmm", n_sm=n_sm,
                    part_bytes=p.group_size * D_SPMM * 4)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    raj_adapt = ops.make_plan(raj, ordering="adaptive", spill_threshold=64)
    log(f"host build: block plans with seg_slots fem2d_2048 {t2 - t1:.3f} s, "
        f"raj1_full {t3 - t2:.3f} s; K1+K2 work lists of both "
        f"{t4 - t3:.3f} s ({n_sm} SMs)")
    for name, p in (("fem2d_2048", fem_plan), ("raj1_full", raj_plan)):
        for kernel, part in (("rgcsr_spmv", 4), ("rgcsr_spmm", 4 * D_SPMM)):
            w = p.work_list(kernel, n_sm=n_sm,
                            part_bytes=p.group_size * part)
            what = ("units" if kernel == "rgcsr_spmv" else
                    f"pieces ({w.n_direct} of one-piece groups), d{D_SPMM}")
            log(f"  {name} {kernel}: piece_rows {w.piece_rows}, "
                f"{w.items.shape[0]} {what}, "
                f"{w.combine.shape[0]} split groups, {w.n_parts} partial "
                f"rows; live slot rows "
                f"{int(p.seg_slots.sum())} x 32 of {p.stored_slots} x "
                f"{p.group_size} stored")
    fem_ell_plan = ops.make_ell_plan(fem_ell)
    raj_ell_plan = ops.make_ell_plan(raj_ell)
    x_cut = torch.from_numpy(rng.standard_normal(cut_csr.shape[1])
                             .astype(np.float32)).to(dev)

    k1_check("fem2d_2048 block cps1 fp32", fem_plan, x["fem2d_2048"],
             key="fem2d_2048")
    k1_check("fem2d_2048 block cps1 bf16", fem_plan, x["fem2d_2048"],
             torch.bfloat16, BF16_TOL)
    k1_check("raj1_full block cps1 fp32", raj_plan, x["raj1_full"],
             key="raj1_full")
    k1_check("raj1_full adaptive spill64 fp32", raj_adapt, x["raj1_full"])
    for cps in (2, 4, 8):
        k1_check(f"fem2d_cut65536 block cps{cps} fp32",
                 ops.make_plan(cut, chunks_per_step=cps), x_cut)
    k1_check("fem2d_cut65536 block cps1 x_tile1024 fp32",
             ops.make_plan(cut), x_cut, x_tile=1024)
    k3_check("fem2d_2048 ellpack fp32", fem_ell_plan, x["fem2d_2048"],
             key="fem2d_2048")
    k3_check("fem2d_2048 ellpack bf16", fem_ell_plan, x["fem2d_2048"],
             torch.bfloat16, BF16_TOL)
    k3_check("raj1_full hybrid-ell fp32", raj_ell_plan, x["raj1_full"],
             key="raj1_full")
    k2_check(f"fem2d_2048 block cps1 d{D_SPMM} fp32", fem_plan,
             xm["fem2d_2048"], key="fem2d_2048")
    k2_check(f"fem2d_2048 block cps1 d{D_SPMM} bf16", fem_plan,
             xm["fem2d_2048"], torch.bfloat16, BF16_TOL)
    k2_check(f"raj1_full block cps1 d{D_SPMM} fp32", raj_plan,
             xm["raj1_full"], key="raj1_full")
    k2_check(f"raj1_full adaptive spill64 d{D_SPMM} fp32", raj_adapt,
             xm["raj1_full"])
    # the split forced at small pieces (fem2d's groups are one step deep,
    # so there every piece size keeps the direct path)
    for p in (8, 64):
        k1_check(f"fem2d_2048 block cps1 pieces{p} fp32", fem_plan,
                 x["fem2d_2048"], piece_rows=p)
        k1_check(f"raj1_full block cps1 pieces{p} fp32", raj_plan,
                 x["raj1_full"], piece_rows=p)
        k1_check(f"raj1_full block cps1 pieces{p} bf16", raj_plan,
                 x["raj1_full"], torch.bfloat16, BF16_TOL, piece_rows=p)
        k1_check(f"raj1_full adaptive spill64 pieces{p} fp32", raj_adapt,
                 x["raj1_full"], piece_rows=p)
        k2_check(f"fem2d_2048 block cps1 pieces{p} d{D_SPMM} fp32",
                 fem_plan, xm["fem2d_2048"], piece_rows=p)
        k2_check(f"raj1_full block cps1 pieces{p} d{D_SPMM} fp32", raj_plan,
                 xm["raj1_full"], piece_rows=p)
        k2_check(f"raj1_full block cps1 pieces{p} d{D_SPMM} bf16", raj_plan,
                 xm["raj1_full"], torch.bfloat16, BF16_TOL, piece_rows=p)
        k2_check(f"raj1_full adaptive spill64 pieces{p} d{D_SPMM} fp32",
                 raj_adapt, xm["raj1_full"], piece_rows=p)
    # K2 at the serving widths, on one w_out layer of the served model's
    # shape (its own draw: the model's layers come in phase 6)
    serve_cfg = dataclasses.replace(get_config(SERVE_ARCH),
                                    sparsity=SparsityConfig(**SERVE_SPARSITY))
    w_params = init_from_spec(
        ffn_mod.sparse_linear_spec(serve_cfg, serve_cfg.d_ff,
                                   serve_cfg.d_model),
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    w_plan = ops.plan_from_params(w_params, torch.float32,
                                  d_out=serve_cfg.d_model,
                                  d_in=serve_cfg.d_ff, group_size=128)
    # K2's d: decode of one row and of the batch, the batch's prefill
    for d in (1, SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT):
        xw = torch.from_numpy(rng.standard_normal((serve_cfg.d_ff, d))
                              .astype(np.float32)).to(dev)
        k2_check(f"granite w_out d{d} fp32", w_plan, xw)
        k2_check(f"granite w_out d{d} bf16", w_plan, xw, torch.bfloat16,
                 BF16_TOL, key=f"w_out d{d}")
    del w_params, w_plan
    log(f"phase 3 in {time.perf_counter() - t0:.1f} s")

    phase("4 main path")
    # ---- 4. the main path
    t0 = time.perf_counter()
    PLAN_CACHE.clear()
    torch.cuda.reset_peak_memory_stats()
    ell_plans = {"fem2d_2048": fem_ell_plan, "raj1_full": raj_ell_plan}
    mats = {"fem2d_2048": (fem, fem_csr), "raj1_full": (raj, raj_csr)}
    launches = {}
    reset_launch_counts()
    for name, (m, a) in mats.items():
        before = launch_counts()
        y = spmv(m, x[name])
        y_again = spmv(m, x[name])
        ym = spmm(m, xm[name])
        y_hyb = ops.ell_spmv(ell_plans[name], x[name])
        if name == "raj1_full":
            y_hyb = y_hyb + spmv(raj_coo, x[name])
        torch.cuda.synchronize()
        after = launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        a64, abs64 = a.astype(np.float64), abs(a.astype(np.float64))
        x64, xm64 = x_np[name].astype(np.float64), xm_np[name].astype(
            np.float64)
        ref, scale = a64 @ x64, abs64 @ abs(x64)
        refm, scalem = a64 @ xm64, abs64 @ abs(xm64)
        for what, got, want, sc in (("spmv", y, ref, scale),
                                    ("spmm", ym, refm, scalem),
                                    ("hybrid spmv", y_hyb, ref, scale)):
            got = got.double().cpu().numpy()
            ok = got.shape == want.shape and bool(np.all(
                np.abs(got - want) <= MAIN_TOL * (1 + sc)))
            err = float(np.abs(got - want).max())
            log(f"main {name} {what}: shape {got.shape} max_abs_err vs "
                f"float64 scipy {err:.3e} (tol {MAIN_TOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"main {name} {what}")
        if not torch.equal(y, y_again):
            failures.append(f"main {name}: K1 not deterministic")
        log(f"main {name} launches {launches[name]}; K1 repeat bitwise "
            f"equal: {torch.equal(y, y_again)}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = PLAN_CACHE.stats()
    log(f"main path launch counts {counts}; plan cache {stats}; "
        f"peak memory {peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    if counts != {"rgcsr_spmv": 4, "rgcsr_spmm": 2, "ell_spmv": 2}:
        failures.append(f"main path launch counts {counts}")
    if stats["misses"] != 2 or stats["hits"] != 4:
        failures.append(f"plan cache {stats}: want 2 misses then 4 hits")

    phase("5 times")
    # ---- 5. times at the main path's shapes
    t0 = time.perf_counter()
    entries = []

    warnings.filterwarnings("ignore", message="Sparse")   # beta notices

    def ms(fn, calls, **kw):
        return card_ms(fn, calls, dev, **kw)

    def entry(kernel, shape, run, plain, library, nbytes, flops, nnz_bytes,
              nnz_flops, calls=50):
        """``nbytes``/``flops``: what the kernel must read and compute;
        ``nnz_bytes``/``nnz_flops``: the matrix's nonzeros alone;
        ``library``: times of the PyTorch CSR call by index type.  ``ms``
        and ``library_ms`` are card times with the host hidden (inputs warm
        in L2 where they fit), ``cold_ms`` and ``library_cold_ms`` the same
        after an L2 flush, ``wait_ms`` what a caller of the launcher waits
        per call in a loop."""
        b_ms, b_by = bound(nbytes, flops)
        torch.cuda.reset_peak_memory_stats()
        e = {"name": f"{kernel}@{shape}", "route": "cuda",
             "source": KERNEL_META[kernel][0],
             "replaces": KERNEL_META[kernel][1],
             "launches": launches[shape][kernel],
             "max_abs_err": errs[(kernel, shape)],
             "ms": ms(run, calls, hold=True),
             "cold_ms": ms(run, calls, cold=True),
             "wait_ms": ms(run, calls),
             "plain_ms": ms(plain, 2, hold=True),
             "bound_ms": b_ms, "bound_by": b_by,
             "nnz_bound_ms": bound(nnz_bytes, nnz_flops)[0],
             "library_ms": min(v[0] for v in library.values()),
             "library_cold_ms": min(v[1] for v in library.values()),
             **{f"library_{k}_ms": v[0] for k, v in library.items()}}
        e["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"time {e['name']}: kernel {e['ms']:.4f} ms (cold "
            f"{e['cold_ms']:.4f}, caller waits {e['wait_ms']:.4f}), plain "
            f"{e['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), nnz "
            f"bound {e['nnz_bound_ms']:.4f} ms, library "
            + ", ".join(f"{k} {v[0]:.4f} ms (cold {v[1]:.4f})"
                        for k, v in library.items())
            + f", peak {e['peak_gib']:.2f} GiB")
        entries.append(e)

    def live_slots(plan):
        """Slots of the live segments (what K1 and K2 must read) and slots
        that are not padding (the products the result needs)."""
        live = int(plan.seg_slots.sum()) * 32
        real = int(((plan.values2d != 0) | (plan.columns2d != 0)).sum())
        return live, real

    def metadata_bytes(plan, part_bytes, kernel):
        """The work list K1 (units) or K2 (tiles) reads, its combine list
        and the segment counts the combine reads."""
        w = plan.work_list(kernel, n_sm=n_sm, part_bytes=part_bytes)
        return plan.seg_slots.nbytes + w.items.nbytes + w.combine.nbytes

    for name, (m, a) in mats.items():
        plan = fem_plan if name == "fem2d_2048" else raj_plan
        vals, cols, sg = plan.values2d, plan.columns2d, plan.step_group
        cps = plan.chunks_per_step
        live, real = live_slots(plan)
        g_rows = plan.n_groups * plan.group_size
        xv, xmv = x[name], xm[name]
        nnz_bytes = a.nnz * 8                     # fp32 value + int32 column
        entry("rgcsr_spmv", name,
              lambda: rgcsr_spmv_launch(plan, xv),
              lambda: rgcsr_spmv_plain(vals, cols, sg, xv,
                                       n_groups=plan.n_groups,
                                       chunks_per_step=cps),
              library_times(a, xv, 50, dev),
              live * 8 + xv.nbytes + g_rows * 4
              + metadata_bytes(plan, plan.group_size * 4, "rgcsr_spmv"),
              2 * live, nnz_bytes + xv.nbytes + a.shape[0] * 4, 2 * a.nnz)
        entry("rgcsr_spmm", name,
              lambda: rgcsr_spmm_launch(plan, xmv),
              lambda: rgcsr_spmm_plain(vals, cols, sg, xmv,
                                       n_groups=plan.n_groups,
                                       chunks_per_step=cps),
              library_times(a, xmv, 10, dev),
              live * 8 + xmv.nbytes + g_rows * D_SPMM * 4
              + metadata_bytes(plan, plan.group_size * D_SPMM * 4,
                               "rgcsr_spmm"),
              2 * real * D_SPMM,
              nnz_bytes + xmv.nbytes + a.shape[0] * D_SPMM * 4,
              2 * a.nnz * D_SPMM, calls=10)
        ep = ell_plans[name]
        head = a if name == "fem2d_2048" else ell_head_csr(a, raj_hyb.k1)
        entry("ell_spmv", name,
              lambda: ell_spmv_launch(ep.values2d, ep.columns2d, xv),
              lambda: ell_spmv_plain(ep.values2d, ep.columns2d, xv),
              library_times(head, xv, 50, dev),
              ep.values2d.nbytes + ep.columns2d.nbytes + xv.nbytes
              + ep.values2d.shape[1] * 4,
              2 * ep.values2d.numel(),
              head.nnz * 8 + xv.nbytes + a.shape[0] * 4, 2 * head.nnz)
    def host_ms(fn, calls):
        """Host time per call to enqueue ``calls`` back-to-back calls."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        t = (time.perf_counter() - t) * 1e3 / calls
        torch.cuda.synchronize()
        return t

    # whole calls as a user makes them (plan-cache lookup and the adaptive
    # epilogue included): what a caller waits per call in a loop, the card's
    # time with the host hidden, and the host's time to enqueue each; and
    # Raj1's adaptive plan with spill — the remedy for its pathology, not
    # on the default path
    def call_line(what, fn, calls):
        log(f"call {what}: caller waits {ms(fn, calls):.4f} ms, card "
            f"{ms(fn, calls, hold=True):.4f} ms, host "
            f"{host_ms(fn, calls):.4f} ms per call")

    for name, (m, _) in mats.items():
        call_line(f"spmv {name}", lambda: spmv(m, x[name]), 50)
        call_line(f"spmm d{D_SPMM} {name}", lambda: spmm(m, xm[name]), 10)
    p, xr, xmr = raj_adapt, x["raj1_full"], xm["raj1_full"]
    epilogue_bytes = sum(t.nbytes for t in (
        p.gather_idx, p.grouped_mask, p.spill_values, p.spill_rows,
        p.spill_columns))
    b_ms = bound(live_slots(p)[0] * 8
                 + metadata_bytes(p, p.group_size * 4, "rgcsr_spmv")
                 + epilogue_bytes + xr.nbytes
                 + p.n_groups * p.group_size * 4 + p.n_rows * 4, 0)[0]
    fn = lambda: rgcsr_spmv_launch(p, xr)   # noqa: E731
    log(f"time rgcsr_spmv@raj1_full adaptive spill64: kernel "
        f"{ms(fn, 50, hold=True):.4f} ms (cold {ms(fn, 50, cold=True):.4f}"
        f"), bound of the whole call {b_ms:.4f} ms")
    call_line("rgcsr_spmv raj1_full adaptive spill64",
              lambda: ops.rgcsr_spmv(p, xr), 50)
    fn = lambda: rgcsr_spmm_launch(p, xmr)   # noqa: E731
    log(f"time rgcsr_spmm@raj1_full adaptive spill64 d{D_SPMM}: kernel "
        f"{ms(fn, 20, hold=True):.4f} ms")
    call_line(f"rgcsr_spmm raj1_full adaptive spill64 d{D_SPMM}",
              lambda: ops.rgcsr_spmm(p, xmr), 20)
    log(f"phase 5 in {time.perf_counter() - t0:.1f} s")

    phase("6 serve")
    # ---- 6. serve granite-3-2b with the RgCSR FFN through K2
    t0 = time.perf_counter()
    tag = f"[{smi}]"
    if torch.backends.cuda.matmul.allow_tf32:
        failures.append("TF32 matmuls are on: the fp32 check needs them off")
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n_layers = serve_cfg.n_layers
    tree = init_params(serve_cfg,
                       torch.Generator(device=dev).manual_seed(SEED))
    sc = ServeConfig(max_seq=SERVE_MAX_SEQ)
    engine = Engine(serve_cfg, sc, params=tree, device=dev)
    torch.cuda.synchronize()
    sparse_layers = [b.ffn.w_out for b in engine.model.layers]
    log(f"serve: {serve_cfg.name} {n_layers} layers, d_model "
        f"{serve_cfg.d_model}, d_ff {serve_cfg.d_ff}, vocab {serve_cfg.vocab}"
        f", {engine.model.n_params()} parameters, w_out in RgCSR (density "
        f"{serve_cfg.sparsity.density}, G {serve_cfg.sparsity.group_size}, "
        f"{sparse_layers[0].values2d.shape[0]} slot rows); init and "
        f"{engine.plans_warmed} plans in {time.perf_counter() - t0:.1f} s")
    if engine.plans_warmed != n_layers:
        failures.append(f"serve: {engine.plans_warmed} plans warmed, want "
                        f"{n_layers}")
    prompts = np.random.default_rng(SEED).integers(
        0, serve_cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    engine.generate(prompts, SERVE_NEW)        # warm-up (casts, work lists)

    # the main path: K2 launches per layer and token, counted by width
    widths = collections.Counter()

    def count_width(module, args):
        widths[args[0].numel() // args[0].shape[-1]] += 1

    hooks = [lay.register_forward_pre_hook(count_width)
             for lay in sparse_layers]
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = engine.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    serve_counts = launch_counts()
    for h in hooks:
        h.remove()
    want_counts = {"rgcsr_spmv": 0, "rgcsr_spmm": n_layers * SERVE_NEW,
                   "ell_spmv": 0}
    want_widths = {SERVE_BATCH * SERVE_PROMPT: n_layers,
                   SERVE_BATCH: n_layers * (SERVE_NEW - 1)}
    builds = {lay.plan_builds for lay in sparse_layers}
    log(f"serve main path: generate {SERVE_BATCH} x {SERVE_PROMPT} tokens, "
        f"{SERVE_NEW} new: launch counts {serve_counts}, K2 calls by width "
        f"{dict(widths)}, plan builds per layer {sorted(builds)}")
    if serve_counts != want_counts:
        failures.append(f"serve launch counts {serve_counts}, want "
                        f"{want_counts}")
    if dict(widths) != want_widths:
        failures.append(f"serve K2 calls by width {dict(widths)}, want "
                        f"{want_widths}")
    if builds != {1}:
        failures.append(f"serve: plan builds per layer {sorted(builds)}")
    if out.shape != (SERVE_BATCH, SERVE_NEW) or not (
            (out >= 0) & (out < serve_cfg.vocab)).all():
        failures.append(f"serve: tokens of shape {out.shape} outside the "
                        f"vocab")

    # float32 (the KV cache too): the same weights through K2 against
    # w_out as dense matmuls
    t1 = time.perf_counter()
    cfg32 = dataclasses.replace(serve_cfg, dtype="float32",
                                kv_cache_dtype="float32")
    eng32 = Engine(cfg32, sc, params=tree, device=dev)
    dense_tree = dict(tree, layers=[
        dict(layer, ffn=dict(layer["ffn"], w_out={
            "kernel": dense_equivalent(lay).T.contiguous()}))
        for layer, lay in zip(tree["layers"], sparse_layers)])
    eng32d = Engine(dataclasses.replace(cfg32, sparsity=SparsityConfig()),
                    sc, params=dense_tree, device=dev)
    with torch.inference_mode():
        ls = eng32.model.prefill({"tokens": tokens}, SERVE_MAX_SEQ)[0]
        ld = eng32d.model.prefill({"tokens": tokens}, SERVE_MAX_SEQ)[0]
    ls, ld = (v[..., :serve_cfg.vocab].float() for v in (ls, ld))
    peak_logit = ld.abs().max().item()
    err = (ls - ld).abs().max().item()
    ok = bool(torch.isfinite(ls).all()) and err <= LOGIT_TOL * (1 + peak_logit)
    log(f"serve fp32 prefill logits, K2 vs dense w_out: max_abs_err "
        f"{err:.3e}, max|logit| {peak_logit:.3f} (tol {LOGIT_TOL:g} · (1 + "
        f"max|logit|)) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("serve fp32 prefill logits")
    got32 = eng32.generate(prompts, SERVE_NEW)
    want32, margins, peaks = greedy_trace(eng32d.model, tokens,
                                          SERVE_MAX_SEQ, SERVE_NEW,
                                          serve_cfg.vocab)
    close = [i for i, (m, p) in enumerate(zip(margins, peaks))
             if m < MARGIN_TOL * p]
    upto = close[0] if close else SERVE_NEW
    same = bool((got32[:, :upto] == want32[:, :upto]).all())
    log(f"serve fp32 greedy tokens, K2 vs dense w_out: identical through "
        f"step {upto} of {SERVE_NEW}: {same}; "
        + (f"first step with a top-2 margin below {MARGIN_TOL:g} · "
           f"max|logit|: {upto} (margin {margins[upto]:.3e}, max|logit| "
           f"{peaks[upto]:.3f}); " if close else "no top-2 margin below "
           f"{MARGIN_TOL:g} · max|logit|; ")
        + f"smallest margin {min(margins):.3e}; all {SERVE_NEW} steps "
        f"identical: {bool((got32 == want32).all())}; "
        f"{time.perf_counter() - t1:.1f} s")
    if not same:
        failures.append("serve fp32 greedy tokens")
    del eng32, eng32d, dense_tree, ls, ld

    # bfloat16 times: prefill, generate, one decode step
    with torch.inference_mode():
        def prefill():
            return engine.model.prefill({"tokens": tokens}, SERVE_MAX_SEQ)

        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = prefill()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        prefill_ms = float(np.median(walls)) * 1e3
        finite = bool(torch.isfinite(logits[..., :serve_cfg.vocab]).all())
        decode_ms = (gen_s * 1e3 - prefill_ms) / (SERVE_NEW - 1)
        log(f"serve bf16: prefill {prefill_ms:.3f} ms ({SERVE_BATCH} x "
            f"{SERVE_PROMPT} tokens), generate {gen_s * 1e3:.3f} ms for "
            f"{SERVE_NEW} new tokens, decode {decode_ms:.3f} ms per token, "
            f"{SERVE_BATCH * SERVE_NEW / gen_s:.1f} tokens/s; prefill logits "
            f"finite: {finite} {tag}")
        if not finite:
            failures.append("serve bf16 prefill logits not finite")
        # one decode step at context 128, each call writing the same slot
        tok = torch.from_numpy(out[:, :1]).to(dev)
        index0 = caches[0]["index"].clone()

        def step():
            engine._decode([dict(c, index=index0) for c in caches], tok)

        # The held timer does not hide the host of a decode step (~3,500
        # launches): its reading came out near what a caller waits, far
        # above the card's busy time (PERF.md §7).  The card's time of a
        # step is the profiler's busy time below.
        step_wait, step_held = ms(step, 5), ms(step, 1, hold=True)
        step_host = host_ms(step, 5)
        log(f"serve bf16 decode step: caller waits {step_wait:.3f} ms, held "
            f"timer {step_held:.3f} ms (not the card's time, see the "
            f"profiler's), host enqueue "
            f"{step_host:.3f} ms {tag}")
        for what, fn, calls in (("prefill", prefill, 2),
                                ("decode step", step, 5)):
            k = device_kernels(fn, calls)
            busy = sum(us for _, us in k.values())
            k2 = sum(us for name, (_, us) in k.items()
                     if "rgcsr_spmm" in name or "combine_partials" in name)
            wall = prefill_ms if what == "prefill" else step_wait
            idle = 100 * (1 - busy / 1e3 / wall)
            top = sorted(k.items(), key=lambda kv: -kv[1][1])[:4]
            log(f"serve bf16 {what} (profiler, {calls} calls): "
                f"{sum(n for n, _ in k.values()):.0f} kernels, card busy "
                f"{busy / 1e3:.3f} ms per call, K2 {k2 / 1e3:.3f} ms "
                f"({100 * k2 / busy:.1f} %), idle share of the "
                f"{wall:.3f} ms a caller waits {idle:.1f} %; largest: "
                + "; ".join(f"{name[:60]} x{n:.0f} {us / 1e3:.3f} ms"
                            for name, (n, us) in top) + f" {tag}")

    # K2 per layer at the serving widths, bf16, on layer 0's kept plan
    def k2_serving_entry(lay, d, launches, max_err, where="",
                         arch=SERVE_ARCH):
        """Times of K2 at width ``d`` on ``lay``'s kept bf16 plan, beside
        its bound, its plain version, the PyTorch CSR product and the
        dense bf16 product of the layer's dense equivalent; ``arch`` and
        ``where`` (the phase) name the entry."""
        plan = lay.plan_for(torch.bfloat16)
        w32 = dense_equivalent(lay)
        w16 = w32.bfloat16()
        live, real = live_slots(plan)
        xk = torch.from_numpy(rng.standard_normal((lay.d_in, d))
                              .astype(np.float32)).to(dev, torch.bfloat16)
        run = lambda: rgcsr_spmm_launch(plan, xk)   # noqa: E731
        nbytes = (live * (2 + 4) + xk.nbytes + plan.n_rows * d * 2
                  + metadata_bytes(plan, plan.group_size * d * 4,
                                   "rgcsr_spmm"))
        flops = 2 * real * d
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        lib = {}
        for ltag, a_csr, xl in (("bf16", w16, xk),
                                ("fp32", w32, xk.float())):
            try:
                a_csr = a_csr.to_sparse_csr()
                lib[ltag] = (ms(lambda: a_csr @ xl, 10, hold=True),
                             ms(lambda: a_csr @ xl, 10, cold=True))
            except RuntimeError as err:     # a yardstick only
                log(f"library csr {ltag}: {err}")
            del a_csr
        lib_tag = "bf16" if "bf16" in lib else "fp32"
        e = {"name": f"rgcsr_spmm@{arch} w_out d{d} bf16{where}",
             "route": "cuda", "source": KERNEL_META["rgcsr_spmm"][0],
             "replaces": KERNEL_META["rgcsr_spmm"][1],
             "launches": launches, "max_abs_err": max_err,
             "ms": ms(run, 20, hold=True),
             "cold_ms": ms(run, 20, cold=True),
             "wait_ms": ms(run, 20),
             "plain_ms": ms(lambda: rgcsr_spmm_plain(
                 plan.values2d, plan.columns2d, plan.step_group, xk,
                 n_groups=plan.n_groups), 2, hold=True),
             "bound_ms": b_ms, "bound_by": b_by,
             "cuda_core_bound_ms": bound(nbytes, flops)[0],
             "library_ms": lib[lib_tag][0] if lib else None,
             "library_cold_ms": lib[lib_tag][1] if lib else None,
             "library_dtype": lib_tag if lib else None,
             "dense_bf16_ms": ms(lambda: w16 @ xk, 20, hold=True),
             "dense_bf16_cold_ms": ms(lambda: w16 @ xk, 20, cold=True)}
        log(f"time {e['name']}: kernel {e['ms']:.4f} ms (cold "
            f"{e['cold_ms']:.4f}, caller waits {e['wait_ms']:.4f}), plain "
            f"{e['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{e['cuda_core_bound_ms']:.4f} ms at the fp32 CUDA-core rate), "
            f"csr {lib_tag} {e['library_ms']} ms (cold "
            f"{e['library_cold_ms']}), dense bf16 matmul "
            f"{e['dense_bf16_ms']:.4f} ms (cold {e['dense_bf16_cold_ms']:.4f}"
            f"), {e['launches']} launches on the main path {tag}")
        return e

    for d in (SERVE_BATCH, SERVE_BATCH * SERVE_PROMPT):
        entries.append(k2_serving_entry(sparse_layers[0], d, widths[d],
                                        errs[("rgcsr_spmm", f"w_out d{d}")]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"serve peak device memory {peak / 2**30:.2f} GiB ({held_before / 2**30:.2f} GiB held by the earlier phases) "
        f"{tag}; phase 6 in {time.perf_counter() - t0:.1f} s")

    phase("7 session")
    # ---- 7. serve sessions: continuous batching on paged caches, the
    # fused decode loop a CUDA graph, K2 in every prefill and graph replay
    t0 = time.perf_counter()
    del engine, sparse_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vocab = serve_cfg.vocab

    def session_requests(n, lo, hi, new_lo, new_hi):
        """``n`` requests from seed ``SEED``: prompt lengths in [lo, hi],
        budgets in [new_lo, new_hi], random tokens."""
        r = np.random.default_rng(SEED)
        lens = r.integers(lo, hi + 1, n)
        news = r.integers(new_lo, new_hi + 1, n)
        return [Request(tokens=r.integers(0, vocab, int(ln)).astype(
            np.int32), max_new_tokens=int(m)) for ln, m in zip(lens, news)]

    def session_engine(cfg, **kw):
        return Engine(cfg, ServeConfig(page_size=SESS_PAGE, **kw),
                      params=tree, device=dev)

    # (a) float32 (compute and KV cache): every stream against generate()
    # of its request alone, on the dense layout, up to the first step
    # whose top-2 margin is below MARGIN_TOL · max|logit|
    t1 = time.perf_counter()
    prefill_widths = set()      # K2's d in the sessions' prefills

    def tally_prefills(eng, k2=None, widths=None):
        """Wrap ``eng._prefill``: record each prompt length (in
        ``widths``, default the session phase's set) and, given a list
        ``k2``, the K2 launches each prefill made."""
        orig = eng._prefill
        widths = prefill_widths if widths is None else widths

        def prefill(batch):
            widths.add(int(batch["tokens"].shape[1]))
            before = launch_counts()["rgcsr_spmm"]
            out = orig(batch)
            if k2 is not None:
                k2.append(launch_counts()["rgcsr_spmm"] - before)
            return out

        eng._prefill = prefill

    def same_streams(eng, reqs, oracles, s_max):
        """Per request: its stream equals ``oracles`` (``generate`` of it
        alone) up to the first step whose top-2 margin is below
        ``MARGIN_TOL`` · max|logit| in ``eng``'s own greedy run."""
        same = []
        for r, want in zip(reqs, oracles):
            got = np.asarray(r.out)
            diff = np.flatnonzero(got != want) if len(got) == len(want) \
                else [0]
            if len(diff):
                _, margins, peaks = greedy_trace(
                    eng.model, torch.from_numpy(r.tokens[None, :]).to(dev),
                    s_max, r.max_new_tokens, vocab)
                close = [i for i, (m, pk) in enumerate(zip(margins, peaks))
                         if m < MARGIN_TOL * pk]
                same.append(bool(close) and diff[0] >= close[0])
            else:
                same.append(True)
        return same

    oracles = None
    for chunk in (SESS_CHUNK, 1):
        eng = session_engine(cfg32, max_seq=SESS_A_MAX_SEQ,
                             n_slots=SESS_A_SLOTS, n_pages=SESS_A_PAGES,
                             decode_chunk=chunk)
        if oracles is None:
            oracles = [eng.generate(r.tokens[None, :], r.max_new_tokens)[0]
                       for r in session_requests(*SESS_A_MIX)]
        reqs = session_requests(*SESS_A_MIX)
        tally_prefills(eng)
        eng.serve(reqs)
        st = eng.paging_stats
        same = same_streams(eng, reqs, oracles, SESS_A_MAX_SEQ)
        ok = (all(same) and st["completed"] == len(reqs)
              and all(r.ok_like for r in reqs))
        if chunk > 1:
            ok = ok and st["preemptions"] >= 1 and \
                st["decode_dispatches"] < st["decode_steps"]
        log(f"session fp32 chunk {chunk}: {len(reqs)} requests on "
            f"{SESS_A_SLOTS} slots, prompts {[len(r.tokens) for r in reqs]}"
            f", new {[r.max_new_tokens for r in reqs]}, {st['n_pages']} "
            f"pages of {SESS_PAGE}: completed {st['completed']}, "
            f"preemptions {st['preemptions']}, recompute tokens "
            f"{st['recompute_tokens']}, decode steps {st['decode_steps']}, "
            f"dispatches {st['decode_dispatches']}, graph replays "
            f"{eng._loop.replays}, page high water {st['page_high_water']};"
            f" streams equal to generate (margin rule): {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"session fp32 chunk {chunk}")
        del eng
    log(f"session fp32 phase in {time.perf_counter() - t1:.1f} s")

    # (b) bfloat16 as configured: times, launches, the card's busy time
    eng = session_engine(serve_cfg, max_seq=SESS_B_MAX_SEQ,
                         n_slots=SESS_B_SLOTS, decode_chunk=SESS_CHUNK)
    eng.serve([Request(tokens=r.tokens[:64], max_new_tokens=8)
               for r in session_requests(*SESS_B_MIX)[:SESS_B_SLOTS]])
    def tally_dispatches(fleet):
        """Wrap each engine's fused dispatch; per engine a list of
        (seconds, steps, K2 launches) per dispatch."""
        per = []
        for e in fleet:
            seen, fused = [], e._fused_decode

            def timed(*args, fused=fused, seen=seen):
                before = launch_counts()["rgcsr_spmm"]
                t = time.perf_counter()
                out = fused(*args)      # ends in the chunk's one host sync
                seen.append((time.perf_counter() - t, out[1],
                             launch_counts()["rgcsr_spmm"] - before))
                return out

            e._fused_decode = timed
            per.append(seen)
        return per

    prefill_k2 = []                    # K2 launches of each prefill
    fused = eng._fused_decode
    dispatches = tally_dispatches([eng])[0]   # (s, steps, K2 launches)
    tally_prefills(eng, prefill_k2)
    reqs = session_requests(*SESS_B_MIX)
    replays0 = eng._loop.replays
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    sess_counts = launch_counts()
    eng._fused_decode = fused
    st = eng.paging_stats
    prefills = eng._session.prefill_count
    replays = eng._loop.replays - replays0
    tokens = sum(len(r.out) for r in reqs)
    want_k2 = n_layers * (st["decode_steps"] + prefills)
    k2_decode = sum(k for _, _, k in dispatches)   # launches at d = slots
    step_wait = sum(dt for dt, _, _ in dispatches) / max(
        1, sum(n for _, n, _ in dispatches)) * 1e3
    prefill_wait = float(np.mean([r.prefill_s for r in reqs])) * 1e3
    ok = (sess_counts == {"rgcsr_spmv": 0, "rgcsr_spmm": want_k2,
                          "ell_spmv": 0}
          and k2_decode == n_layers * st["decode_steps"]
          and prefill_k2 == [n_layers] * prefills
          and replays == st["decode_steps"]
          and len(dispatches) == st["decode_dispatches"]
          and st["completed"] == len(reqs)
          and all(0 <= tk < vocab for r in reqs for tk in r.out))
    log(f"session bf16: {len(reqs)} requests on {SESS_B_SLOTS} slots "
        f"(prompts {SESS_B_MIX[1]}-{SESS_B_MIX[2]}, {SESS_B_MIX[3]} new), "
        f"{st['n_pages']} pages of {SESS_PAGE}: {tokens} tokens, "
        f"{prefills} prefills, decode steps {st['decode_steps']}, "
        f"dispatches {st['decode_dispatches']} (one host sync each), graph "
        f"replays {replays}; launch counts {sess_counts}, K2 want "
        f"{n_layers} x ({st['decode_steps']} steps + {prefills} prefills) "
        f"= {want_k2}; K2 launched in the fused dispatches {k2_decode}, in "
        f"the prefills {sum(prefill_k2)} ({sorted(set(prefill_k2))} each) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("session bf16 launches, replays or completions")
    session_tps = tokens / wall
    log(f"session bf16: {wall:.3f} s for {tokens} tokens, "
        f"{session_tps:.1f} tokens/s; a caller waits {step_wait:.3f} ms "
        f"per decode step (fused dispatches, {SESS_CHUNK} steps each) and "
        f"{prefill_wait:.3f} ms per prefill (mean) {tag}")

    # one chunk of a full batch under the profiler: the card's busy time
    # per decode step against what a caller waits for it
    sess = eng.start_session(session_requests(*SESS_B_MIX)[:SESS_B_SLOTS])
    sess.step(1)                           # admit all, one step
    t = time.perf_counter()
    sess.step(SESS_CHUNK)
    chunk_ms = (time.perf_counter() - t) * 1e3
    marks = []

    def one_chunk():
        before = sess.stats["decode_steps"]
        sess.step(SESS_CHUNK)
        marks.append(sess.stats["decode_steps"] - before)

    try:
        k = device_kernels(one_chunk, 1)
        steps = marks[-1]
        busy = sum(us for _, us in k.values()) / 1e3 / steps
        k2 = sum(us for name, (_, us) in k.items()
                 if "rgcsr_spmm" in name or "combine_partials" in name
                 ) / 1e3 / steps
        wait = chunk_ms / SESS_CHUNK
        top = sorted(k.items(), key=lambda kv: -kv[1][1])[:4]
        log(f"session bf16 decode step (profiler, one chunk of {steps} "
            f"steps, {SESS_B_SLOTS} slots): "
            f"{sum(n for n, _ in k.values()) / steps:.0f} kernels, card "
            f"busy {busy:.3f} ms per step, K2 {k2:.3f} ms "
            f"({100 * k2 / busy:.1f} %); a caller waits {wait:.3f} ms per "
            f"step of a chunk, idle share {100 * (1 - busy / wait):.1f} %; "
            f"largest: " + "; ".join(
                f"{name[:60]} x{n:.0f} {us / 1e3:.3f} ms"
                for name, (n, us) in top) + f" {tag}")
    except RuntimeError as err:
        failures.append(f"session bf16 decode step: card busy time not "
                        f"measured ({err})")
    sess.drain()

    # one prefill as the session runs it (prefill, then the first token to
    # the host): at a prompt length no request had, which builds K2's work
    # list for that width on the host first, at the same length again, and
    # the card's busy time
    toks = torch.from_numpy(rng.integers(
        0, vocab, (1, SESS_B_MIX[2] + 1)).astype(np.int32)).to(dev)

    def one_prefill():
        with torch.inference_mode():
            logits, _ = eng._prefill({"tokens": toks})
            return int(eng._sample(logits)[0])

    walls = []
    for _ in range(2):
        t = time.perf_counter()
        one_prefill()
        walls.append((time.perf_counter() - t) * 1e3)
    k = device_kernels(one_prefill, 1)
    busy = sum(us for _, us in k.values()) / 1e3
    k2 = sum(us for name, (_, us) in k.items()
             if "rgcsr_spmm" in name or "combine_partials" in name) / 1e3
    log(f"session bf16 prefill of {toks.shape[1]} tokens: a caller waits "
        f"{walls[0]:.3f} ms at a new length, {walls[1]:.3f} ms again; card "
        f"busy {busy:.3f} ms ({sum(n for n, _ in k.values()):.0f} kernels),"
        f" K2 {k2:.3f} ms {tag}")

    # K2 against its plain version on layer 0's kept plan, at the decode
    # width of these sessions and at every width they prefilled (prompts,
    # recompute lengths, the 257-token prefill above), fp32 and bf16
    lay = eng.model.layers[0].ffn.w_out
    plan = lay.plan_for(torch.bfloat16)
    t1 = time.perf_counter()
    for d in [SESS_B_SLOTS] + sorted(prefill_widths):
        xw = torch.from_numpy(rng.standard_normal(
            (serve_cfg.d_ff, d)).astype(np.float32)).to(dev)
        k2_check(f"granite w_out d{d} fp32 (kept plan)", plan, xw)
        k2_check(f"granite w_out d{d} bf16 (kept plan)", plan, xw,
                 torch.bfloat16, BF16_TOL, key=f"w_out d{d}")
    log(f"K2 held against its plain version at the sessions' "
        f"{1 + len(prefill_widths)} widths in "
        f"{time.perf_counter() - t1:.1f} s")
    entries.append(k2_serving_entry(
        lay, SESS_B_SLOTS, k2_decode,
        errs[("rgcsr_spmm", f"w_out d{SESS_B_SLOTS}")]))
    del eng, sess, fused      # fused: a bound method of eng
    torch.cuda.synchronize()
    log(f"session peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"{tag}; phase 7 in {time.perf_counter() - t0:.1f} s")

    phase("8 router")
    # ---- 8. the router: two replicas of one model behind Router — the
    # failover drill in fp32, a bf16 fleet, the launcher's drills
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    router_widths = set()                     # K2's d in the fleets' prefills
    checked = {SESS_B_SLOTS} | prefill_widths  # held in phase 7 already

    def state_bytes(loop):
        """An engine's serving state: its KV caches and the fused loop's
        tensors."""
        ts = [t for c in loop.caches for t in c.values()]
        ts += [loop.inputs, loop.outputs, loop.cur_tok]
        return sum(t.numel() * t.element_size() for t in ts)

    def live_bytes():
        """Live bytes of the caching allocator: (tensors on the default
        stream in the default pool — KV caches, loop state, weights —,
        everything else: CUDA graph pools and what the capture's streams
        keep, each stream's cuBLAS workspace)."""
        plain = other = 0
        for seg in torch.cuda.memory_snapshot():
            n = sum(b["size"] for b in seg["blocks"]
                    if b["state"] == "active_allocated")
            if seg["stream"] == 0 and not any(
                    seg.get("segment_pool_id", (0, 0))):
                plain += n
            else:
                other += n
        return plain, other

    def per_replica(router, key):
        """``key`` summed over each replica's retired and live sessions."""
        return [sum(s.get(key, 0) for s in rep.retired_stats)
                + (rep.session.stats_snapshot()[key] if rep.session else 0)
                for rep in router.replicas]

    # (a) float32 failover drill: replica 1 dies at its decode step 2
    t1 = time.perf_counter()
    fc = FaultConfig(max_restarts=3, backoff_s=0.1)
    scfg_a = ServeConfig(max_seq=ROUTER_A_MAX_SEQ, n_slots=ROUTER_A_SLOTS,
                         page_size=SESS_PAGE, decode_chunk=SESS_CHUNK)
    first = Engine(cfg32, scfg_a, params=tree, device=dev, fault_cfg=fc)
    first._loop                      # its caches and its captured graph
    torch.cuda.synchronize()
    mem1, (plain1, other1) = torch.cuda.memory_allocated(), live_bytes()
    second = Engine(cfg32, scfg_a, params=first.params, fault_cfg=fc)
    second.fault_injector = FaultInjector(fail_at_steps=(("replica", 2),))
    torch.cuda.synchronize()
    at_init = torch.cuda.memory_allocated() - mem1
    second._loop
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - mem1
    plain2, other2 = live_bytes()
    kv2, graph2 = state_bytes(second._loop), other2 - other1
    builds = sum(m.plan_builds for m in first.model.modules()
                 if isinstance(m, ffn_mod.SparseLinear))
    # the state's tensors sit in blocks rounded up to 512 bytes
    ok = (at_init == 0 and plain2 - plain1 <= kv2 + 2**20
          and grew <= kv2 + 2**20 + graph2 and builds == n_layers
          and second.model is first.model and second.plans_warmed == 0)
    log(f"router fp32 fleet: 2 replicas of one model; plan builds for the "
        f"fleet {builds} (want {n_layers}), second replica warmed "
        f"{second.plans_warmed}; memory_allocated grew "
        f"{grew / 2**20:.1f} MiB from one engine to two ({at_init} bytes "
        f"when the second was built, the rest at its first session): "
        f"{(plain2 - plain1) / 2**20:.1f} MiB of tensors against its KV "
        f"pool and loop state of {kv2 / 2**20:.1f} MiB, and "
        f"{graph2 / 2**20:.1f} MiB for its graph (its private pool and "
        f"its capture stream's cuBLAS workspace) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("router: the second replica did not share the "
                        "model or allocated more than its own state")
    fleet = [first, second]
    oracles = [first.generate(r.tokens[None, :], r.max_new_tokens)[0]
               for r in session_requests(*ROUTER_A_MIX)]
    router = Router(fleet, cfg=RouterConfig(n_replicas=2), fault_cfg=fc)
    runners = [e._runner for e in fleet]
    prefill_k2 = []
    for e in fleet:
        tally_prefills(e, prefill_k2, router_widths)
    per = tally_dispatches(fleet)
    reqs = session_requests(*ROUTER_A_MIX)
    replays0 = [e._loop.replays for e in fleet]
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    router.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    fleet_counts = launch_counts()
    st = router.stats()
    steps = st["decode_steps"]
    replays = sum(e._loop.replays - r0 for e, r0 in zip(fleet, replays0))
    k2_decode = sum(k for seen in per for _, _, k in seen)
    same = same_streams(first, reqs, oracles, ROUTER_A_MAX_SEQ)
    ok = (all(same) and all(r.ok_like for r in reqs)
          and st["replica_faults"] == 1 and st["migrations"] >= 1
          and st["replica_restarts"] == 1
          and fleet_counts == {"rgcsr_spmv": 0, "ell_spmv": 0,
                               "rgcsr_spmm": n_layers * (steps
                                                         + len(prefill_k2))}
          and prefill_k2 == [n_layers] * len(prefill_k2)
          and k2_decode == n_layers * steps and replays == steps
          and [e._runner for e in fleet] == runners
          and all(r.graph is not None for r in runners))
    log(f"router fp32 failover: {len(reqs)} requests on 2 replicas x "
        f"{ROUTER_A_SLOTS} slots (prompts {[len(r.tokens) for r in reqs]}, "
        f"new {[r.max_new_tokens for r in reqs]}), replica 1 killed at its "
        f"decode step 2: statuses {[r.status for r in reqs]}, retries "
        f"{[r.retries for r in reqs]}; replica faults "
        f"{st['replica_faults']}, migrations {st['migrations']}, restarts "
        f"{st['replica_restarts']}, states {st['replica_states']}; decode "
        f"steps per replica {per_replica(router, 'decode_steps')}, "
        f"dispatches {per_replica(router, 'decode_dispatches')}, graph "
        f"replays {replays}, one graph per engine kept across the restart: "
        f"{[e._runner for e in fleet] == runners}; K2 launches "
        f"{fleet_counts['rgcsr_spmm']} = {n_layers} x ({steps} steps + "
        f"{len(prefill_k2)} prefills), in the fused dispatches {k2_decode};"
        f" streams equal to generate (margin rule): {same}; degraded marks "
        f"{st['degraded_marks']}, straggler steps "
        f"{st['straggler_decode_steps_per_replica']} (wall clock, not "
        f"checked); {wall:.3f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("router fp32 failover drill")
    del router, fleet, first, second, runners, per, e
    gc.collect()
    torch.cuda.empty_cache()
    log(f"router fp32 phase in {time.perf_counter() - t1:.1f} s")

    # (b) bfloat16 fleet: phase 7(b)'s requests on 2 replicas of 4 slots
    t1 = time.perf_counter()
    scfg_b = ServeConfig(max_seq=SESS_B_MAX_SEQ, n_slots=ROUTER_B_SLOTS,
                         page_size=SESS_PAGE, decode_chunk=SESS_CHUNK)
    router = Router.build(serve_cfg, scfg_b, 2, params=tree, device=dev)
    fleet = [rep.engine for rep in router.replicas]
    router.serve([Request(tokens=r.tokens[:64], max_new_tokens=8)
                  for r in session_requests(*SESS_B_MIX)[:SESS_B_SLOTS]])
    prefill_k2 = []
    for e in fleet:
        tally_prefills(e, prefill_k2, router_widths)
    per = tally_dispatches(fleet)
    steps0 = per_replica(router, "decode_steps")
    disp0 = per_replica(router, "decode_dispatches")
    replays0 = [e._loop.replays for e in fleet]
    reqs = session_requests(*SESS_B_MIX)
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    router.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    fleet_counts = launch_counts()
    steps = [a - b for a, b in zip(per_replica(router, "decode_steps"),
                                   steps0)]
    disp = [a - b for a, b in zip(per_replica(router, "decode_dispatches"),
                                  disp0)]
    replays = [e._loop.replays - r0 for e, r0 in zip(fleet, replays0)]
    k2_decode = sum(k for seen in per for _, _, k in seen)
    tokens = sum(len(r.out) for r in reqs)
    step_wait = sum(dt for seen in per for dt, _, _ in seen) / max(
        1, sum(n for seen in per for _, n, _ in seen)) * 1e3
    ok = (fleet_counts == {"rgcsr_spmv": 0, "ell_spmv": 0,
                           "rgcsr_spmm": n_layers * (sum(steps)
                                                     + len(prefill_k2))}
          and k2_decode == n_layers * sum(steps) and replays == steps
          and prefill_k2 == [n_layers] * len(prefill_k2)
          and all(r.ok_like for r in reqs)
          and all(0 <= tk < vocab for r in reqs for tk in r.out))
    log(f"router bf16 fleet: {len(reqs)} requests (phase 7(b)'s) on 2 "
        f"replicas x {ROUTER_B_SLOTS} slots: {tokens} tokens in "
        f"{wall:.3f} s, {tokens / wall:.1f} tokens/s (phase 7(b), one "
        f"engine of {SESS_B_SLOTS} slots, this run: {session_tps:.1f}); "
        f"per replica decode steps {steps}, dispatches {disp}, graph "
        f"replays {replays}; a caller waits {step_wait:.3f} ms per decode "
        f"step (fused dispatches); {len(prefill_k2)} prefills; K2 launches "
        f"{fleet_counts['rgcsr_spmm']} = {n_layers} x ({sum(steps)} steps "
        f"+ {len(prefill_k2)} prefills), in the fused dispatches "
        f"{k2_decode} {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        failures.append("router bf16 fleet launches, replays or statuses")
    # K2 against its plain version on the fleet's kept plan at every width
    # this phase ran that phase 7 did not: each replica's slots, the
    # prompts and the recompute lengths after the migration
    lay = fleet[0].model.layers[0].ffn.w_out
    plan = lay.plan_for(torch.bfloat16)
    new = sorted(({ROUTER_A_SLOTS, ROUTER_B_SLOTS} | router_widths)
                 - checked)
    for d in new:
        xw = torch.from_numpy(rng.standard_normal(
            (serve_cfg.d_ff, d)).astype(np.float32)).to(dev)
        k2_check(f"granite w_out d{d} fp32 (router, kept plan)", plan, xw)
        k2_check(f"granite w_out d{d} bf16 (router, kept plan)", plan, xw,
                 torch.bfloat16, BF16_TOL, key=f"w_out d{d} router")
    log(f"router: K2 held against its plain version at {len(new)} new "
        f"widths {new}")
    entries.append(k2_serving_entry(
        lay, ROUTER_B_SLOTS, k2_decode,
        errs[("rgcsr_spmm", f"w_out d{ROUTER_B_SLOTS} router")],
        where=" router"))
    del router, fleet, lay, plan, per, e   # e: the loop's last engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"router bf16 phase in {time.perf_counter() - t1:.1f} s")

    # (c) the launcher's drills in-process, dense granite-3-2b (the
    # launcher serves what get_config gives), every file in a temporary
    # directory
    t1 = time.perf_counter()
    del tree

    def launch(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launch_serve.main(["--arch", SERVE_ARCH] + argv)
        out = buf.getvalue()
        for line in out.splitlines():
            log(f"router launcher: {line}")
        gc.collect()
        torch.cuda.empty_cache()
        return rc, out

    def line_of(out, prefix):
        return next((ln for ln in out.splitlines()
                     if ln.startswith(prefix)), "")

    with tempfile.TemporaryDirectory() as tmp:
        trace_path = str(Path(tmp) / "trace.json")
        metrics_path = str(Path(tmp) / "metrics.json")
        rc, out = launch(["--replicas", "2", "--kill-replica", "1",
                          "--kill-at-step", "2", "--mixed-lengths",
                          "--trace-out", trace_path,
                          "--metrics-json", metrics_path])
        problems = ["no trace"]
        if rc == 0:
            doc = json.loads(Path(trace_path).read_text())
            stats = json.loads(Path(metrics_path).read_text())
            problems = (obs_export.validate_chrome_trace(doc)
                        + obs_export.cross_check_counters(doc, stats))
        ok = rc == 0 and problems == []
        log(f"router launcher failover drill: exit {rc}; trace validated "
            f"and cross-checked against the metrics: {problems or 'clean'}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("router launcher failover drill")

        # the dead fleet must be collected before the rebuilt one is up:
        # weak references to every engine, read when the launcher has
        # released the dead ones, and the live tensors with each fleet up
        built, made, alive = [], [], []
        init, eng_init = router_mod.Router.__init__, Engine.__init__
        release = launch_serve._release

        def recording_init(self, *args, **kw):
            init(self, *args, **kw)
            torch.cuda.synchronize()
            built.append((torch.cuda.memory_allocated(), live_bytes()[0],
                          time.perf_counter()))

        def tracked_init(self, *args, **kw):
            eng_init(self, *args, **kw)
            made.append(weakref.ref(self))

        def counting_release():
            release()
            alive.append(sum(r() is not None for r in made))
            built.append((None, None, time.perf_counter()))

        router_mod.Router.__init__ = recording_init
        Engine.__init__ = tracked_init
        launch_serve._release = counting_release
        try:
            t = time.perf_counter()
            rc, out = launch(["--replicas", "2", "--snapshot-every", "1",
                              "--snapshot-dir", str(Path(tmp) / "snaps"),
                              "--kill-process-at", "6"])
            drill_s = time.perf_counter() - t
        finally:
            router_mod.Router.__init__ = init
            Engine.__init__ = eng_init
            launch_serve._release = release
        drill = line_of(out, "crash drill: restored")
        up = [b for b in built if b[0] is not None]
        rebuild_s = built[-1][2] - built[1][2] if len(built) == 3 else -1
        ok = (rc == 0 and drill.endswith(" 0 not ok") and alive == [0]
              and len(up) == 2 and up[1][1] <= up[0][1] + 2**20)
        log(f"router launcher crash drill: exit {rc}; {drill!r}; dead "
            f"engines alive after the release {alive}; with the first "
            f"fleet up / the rebuilt one: memory_allocated "
            + " / ".join(f"{b[0] / 2**30:.3f}" for b in up)
            + " GiB, of it tensors on the default stream "
            + " / ".join(f"{b[1] / 2**30:.3f}" for b in up)
            + f" GiB; rebuild (release to the new fleet's graphs captured) "
            f"{rebuild_s:.2f} s; drill {drill_s:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("router launcher crash drill")

        rc, out = launch(["--kv-integrity", "--corrupt-page", "2"])
        integrity = line_of(out, "integrity:")
        overload = line_of(out, "overload:")
        ok = (rc == 0 and " 1 pages quarantined" in integrity
              and " 0 failed" in overload)
        log(f"router launcher page-corruption drill: exit {rc}; "
            f"{integrity!r} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("router launcher page-corruption drill")
    torch.cuda.synchronize()
    log(f"router launcher drills in {time.perf_counter() - t1:.1f} s")
    log(f"router peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}; "
        f"phase 8 in {time.perf_counter() - t0:.1f} s")

    phase("9 tune")
    # ---- 9. the autotuner on the card: K1 and K2 timed by torch.profiler
    # across every candidate plan, the default candidate sets
    t0 = time.perf_counter()
    autotune.clear_memo()
    PLAN_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"tune: held from the earlier phases: {live_cuda()}")

    def winner_plan(a, cfg_):
        m = from_csr(a.data, a.indices, a.indptr, a.shape, "rgcsr",
                     group_size=cfg_.group_size, device=dev)
        return m, ops.get_plan(m, chunks_per_step=cfg_.chunks_per_step,
                               ordering=cfg_.ordering,
                               spill_threshold=cfg_.spill_threshold)

    for kind, name, a, d in (("spmv", "fem2d_2048", fem_csr, None),
                             ("spmv", "raj1_full", raj_csr, None),
                             ("spmm", "raj1_full", raj_csr, D_SPMM)):
        what = f"{kind} {name}" + ("" if d is None else f" d{d}")
        n_cand = len(autotune.candidate_configs(
            d_tiles=autotune.DEFAULT_D_TILES if d else (128,),
            orderings=autotune.DEFAULT_ORDERINGS,
            spill_thresholds=autotune.spill_threshold_candidates(
                np.diff(a.indptr))))

        def search():
            if d is None:
                return autotune.autotune_spmv(a, device=dev)
            return autotune.autotune_spmm(a, d, device=dev)

        misses = PLAN_CACHE.stats()["misses"]
        reset_launch_counts()
        t1 = time.perf_counter()
        res = search()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t1
        built = PLAN_CACHE.stats()["misses"] - misses
        left_out = (f" ({timing.windows_left_out} of "
                    f"{3 * len(res.timings)} windows left out as "
                    f"incomplete)" if res.timing_source == "profiler"
                    else "")
        log(f"tune {what}: {n_cand} candidates, {built} plans built, "
            f"{n_cand - len(res.timings)} pruned, {len(res.timings)} timed "
            f"by {res.timing_source}{left_out}; winner {res.config} "
            f"{res.us_per_call:.2f} us, baseline {res.baseline_us:.2f} us, "
            f"speedup {res.speedup:.3f}; launches {launch_counts()}; "
            f"search {host_s:.1f} s host")
        for (c, us), st in zip(res.timings, res.plan_stats):
            log(f"  tune {what} {c.group_size} cps{c.chunks_per_step} "
                f"d_tile {c.d_tile} {c.ordering} spill{c.spill_threshold}: "
                f"{us:.2f} us, {st[1]} stored elements")
        if res.timing_source != "profiler":
            log(f"tune {what}: the profiler gave nothing: "
                f"{timing.profiler_failure}")
            failures.append(f"tune {what}: timed by {res.timing_source}")
        # the winner against float64 scipy, and its held time
        if d is None:
            plan, _ = autotune.tuned_plan(a, device=dev)
            operand, op64 = x[name], x_np[name].astype(np.float64)
            run = lambda: ops.rgcsr_spmv(plan, operand)   # noqa: E731
        else:
            mat, plan = winner_plan(a, res.config)
            operand, op64 = xm[name], xm_np[name].astype(np.float64)
            run = lambda: ops.rgcsr_spmm(    # noqa: E731
                plan, operand, d_tile=res.config.d_tile)
        got = run().double().cpu().numpy()
        a64 = a.astype(np.float64)
        want, scale = a64 @ op64, abs(a64) @ abs(op64)
        err = float(np.abs(got - want).max())
        ok = got.shape == want.shape and bool(np.all(
            np.abs(got - want) <= MAIN_TOL * (1 + scale)))
        held = time_us(run, calls=20, device=dev, hold=True)
        log(f"tune {what} winner: max_abs_err vs float64 scipy {err:.3e} "
            f"(tol {MAIN_TOL:g}) {'ok' if ok else 'FAIL'}; profiler "
            f"{res.us_per_call:.2f} us, time_us(hold=True) {held:.2f} us")
        if not ok:
            failures.append(f"tune {what}: winner off float64 scipy")
        reset_launch_counts()
        again = search()
        if not again.from_memo or any(launch_counts().values()):
            failures.append(f"tune {what}: second search not a memo hit "
                            f"without launches ({launch_counts()})")
        del plan, run
    # the serving engine's warm-up of an auxiliary matrix, anew
    autotune.clear_memo()
    aux = Engine(get_smoke(SERVE_ARCH), ServeConfig(max_seq=32), device=dev)
    t1 = time.perf_counter()
    winners = aux.warm_spmv_plans([raj_csr])
    warm_s = time.perf_counter() - t1
    misses = PLAN_CACHE.stats()["misses"]
    _, res = autotune.tuned_plan(raj_csr, device=dev)
    builds = PLAN_CACHE.stats()["misses"] - misses
    ok = builds == 0 and res.from_memo and winners == [res.config]
    log(f"tune Engine.warm_spmv_plans(raj1_full): winner {winners[0]} in "
        f"{warm_s:.1f} s; tuned_plan after it: memo hit {res.from_memo}, "
        f"{builds} plan builds {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("tune: warm_spmv_plans then tuned_plan built plans")
    del aux
    autotune.clear_memo()
    PLAN_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 in {time.perf_counter() - t0:.1f} s")

    phase("10 train")
    # ---- 10. training: the segment sum's backward at granite's w_out
    # shape, launch/train.py on full granite-3-2b, the fault drill
    t0 = time.perf_counter()
    train_cfg = dataclasses.replace(get_config(SERVE_ARCH),
                                    sparsity=SparsityConfig(**TRAIN_SPARSITY))
    # (a) one SparseLinear, fp32, T tokens: gradients of values2d and x
    # against the float64 dense equivalent
    lin_cfg = dataclasses.replace(train_cfg, dtype="float32")
    d_in, d_out = lin_cfg.d_ff, lin_cfg.d_model
    layer = ffn_mod.SparseLinear(init_from_spec(
        ffn_mod.sparse_linear_spec(lin_cfg, d_in, d_out),
        torch.Generator(device=dev).manual_seed(SEED + 10), device=dev),
        lin_cfg, d_in=d_in, d_out=d_out).requires_grad_(True)
    xl = torch.from_numpy(rng.standard_normal((TRAIN_T, d_in)).astype(
        np.float32)).to(dev).requires_grad_(True)
    dyl = torch.from_numpy(rng.standard_normal((TRAIN_T, d_out)).astype(
        np.float32)).to(dev)
    reset_launch_counts()
    gv, gx = torch.autograd.grad(layer(xl), (layer.values2d, xl), dyl)
    torch.cuda.synchronize()
    lin_launches = dict(launch_counts())
    g_size = layer.values2d.shape[1]
    rows = (layer.chunk_group.long().repeat_interleave(8)[:, None] * g_size
            + torch.arange(g_size, device=dev))
    cols = layer.columns2d.long()
    w64 = dense_equivalent(layer).double()
    x64, dy64 = xl.detach().double(), dyl.double()
    checks = (("values2d", gv, (dy64.T @ x64)[rows, cols],
               (dy64.abs().T @ x64.abs())[rows, cols]),
              ("x", gx, dy64 @ w64, dy64.abs() @ w64.abs()))
    for what, got, want, scale in checks:
        diff = (got.double() - want).abs()
        ok = bool((diff <= MAIN_TOL * (1 + scale)).all())
        log(f"train SparseLinear {d_out}x{d_in} T{TRAIN_T} fp32 grad of "
            f"{what}: max_abs_err vs float64 dense {diff.max().item():.3e} "
            f"(tol {MAIN_TOL:g}·(1 + Σ|·|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train: SparseLinear grad of {what}")
    log(f"train SparseLinear launches {lin_launches} (the segment sum is "
        f"plain PyTorch, as the reference trains)")
    del layer, xl, dyl, gv, gx, rows, cols, w64, x64, dy64, checks, got, \
        want, scale, diff

    # (b) the launcher's path: granite-3-2b, --sparse-ffn, bf16 compute,
    # fp32 parameters, AdamW
    peaks = []
    make_step = trainer_mod.make_train_step

    def measured_step(*args, **kw):
        fn, init = make_step(*args, **kw)

        def step(*a):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            return out
        return step, init

    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    log(f"train: held from the earlier phases: {live_cuda()}")
    trainer_mod.make_train_step = measured_step
    reset_launch_counts()
    try:
        t1 = time.perf_counter()
        tr, state = launch_train.main([
            "--arch", SERVE_ARCH, "--sparse-ffn", "--steps",
            str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH), "--device", str(dev)])
        run_s = time.perf_counter() - t1
    finally:
        trainer_mod.make_train_step = make_step
    params, opt_state = state
    n_params = sum(t.numel() for t in params.values()
                   if t.is_floating_point())
    log(f"train {SERVE_ARCH} --sparse-ffn: {tr.model_cfg.n_layers} layers, "
        f"d_model {tr.model_cfg.d_model}, {n_params} float parameters "
        f"({next(iter(params.values())).dtype}), compute "
        f"{tr.model_cfg.dtype}, seq {TRAIN_SEQ} x batch {TRAIN_BATCH}; "
        f"{len(tr.history)} steps in {run_s:.1f} s (init included); "
        f"launches {launch_counts()}; {held_before / 2**30:.2f} GiB held "
        f"before {tag}")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    for h, peak in zip(tr.history, peaks):
        log(f"train step {h['step']}: loss {h['loss']:.4f}, grad_norm "
            f"{h['grad_norm']:.4f}, {h['step_time_s'] * 1e3:.1f} ms host "
            f"(ending in a synchronize), {tokens / h['step_time_s']:.1f} "
            f"tokens/s, peak {peak / 2**30:.2f} GiB {tag}")
    losses = [h["loss"] for h in tr.history]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        failures.append(f"train: losses {losses}")
    if any(t.dtype != torch.float32 for t in params.values()
           if t.is_floating_point()) or tr.model_cfg.dtype != "bfloat16":
        failures.append("train: parameters not fp32 or compute not bf16")
    if tr.model.device.type != "cuda":
        failures.append(f"train: the model is on {tr.model.device}")
    # one step under the profiler (after one more warm step)
    holder = {"state": opt_state, "step": TRAIN_STEPS}

    def train_once():
        _, holder["state"], m = tr.train_step(params, holder["state"],
                                              tr._batch(holder["step"]))
        holder["step"] += 1
        losses.append(float(m["loss"]))

    kern = device_kernels(train_once, 1)
    busy_ms = sum(us for _, us in kern.values()) / 1e3
    step_ms = float(np.median([h["step_time_s"] for h in tr.history[1:]])
                    ) * 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"train profiled step: card busy {busy_ms:.1f} ms in "
        f"{sum(n for n, _ in kern.values()):.0f} kernels, against "
        f"{step_ms:.1f} ms host per step: idle "
        f"{max(0.0, 1 - busy_ms / step_ms):.1%} {tag}")
    for name, (n, us) in top:
        log(f"  train kernel {us / 1e3:.2f} ms x{n:.0f}: {name[:100]}")
    if not all(np.isfinite(losses)):
        failures.append(f"train: losses {losses}")
    train10 = {"peak": max(peaks),
               "step_s": [h["step_time_s"] for h in tr.history]}
    del tr, state, params, opt_state, holder, kern
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the fault drill at full width, DRILL_LAYERS layers: checkpoints
    # every DRILL_CKPT steps, a fault at step DRILL_FAULT; the steps after
    # the restore against an uninterrupted run of the same seed, and the
    # last checkpoint restored bitwise into a new Trainer
    drill_cfg = dataclasses.replace(train_cfg, n_layers=DRILL_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        def drill(sub, fault=None):
            # the uninterrupted run (sub None) writes no checkpoint
            tc = trainer_mod.TrainConfig(
                steps=DRILL_STEPS, ckpt_every=DRILL_CKPT, log_every=100,
                ckpt_dir=f"{tmp}/{sub}" if sub else None,
                opt=OptimizerConfig(warmup_steps=5, decay_steps=DRILL_STEPS))
            return trainer_mod.Trainer(drill_cfg, tc, fault_injector=fault,
                                       device=dev)

        t1 = time.perf_counter()
        clean = drill(None)
        clean.run(clean.init_state(TRAIN_SEQ, TRAIN_BATCH))
        fault = FaultInjector(fail_at_steps=[DRILL_FAULT])
        faulty = drill("faulty", fault)
        final, _ = faulty.run(faulty.init_state(TRAIN_SEQ, TRAIN_BATCH))
        clean_loss = {h["step"]: h["loss"] for h in clean.history}
        worst = max(abs(h["loss"] - clean_loss[h["step"]])
                    for h in faulty.history)
        steps_run = [h["step"] for h in faulty.history]
        again = drill("faulty")
        again.init_state(TRAIN_SEQ, TRAIN_BATCH)
        (params2, opt2), nxt = again.restore_latest()
        bitwise = nxt == DRILL_STEPS and all(
            torch.equal(params2[k], t) for k, t in final[0].items()) and all(
            torch.equal(opt2["m"][k], t) for k, t in final[1]["m"].items())
        ok = (len(fault.fired) == 1 and steps_run == list(range(DRILL_STEPS))
              and worst <= REPLAY_TOL and bitwise
              and all(np.isfinite(list(clean_loss.values()))))
        log(f"train fault drill ({DRILL_LAYERS} layers, ckpt every "
            f"{DRILL_CKPT}, fault at step {DRILL_FAULT}): faults fired "
            f"{fault.fired}, steps {steps_run}, largest loss gap to the "
            f"uninterrupted run {worst:.2e} (tol {REPLAY_TOL:g}), last "
            f"checkpoint (step {nxt - 1}) restored bitwise {bitwise} in "
            f"{time.perf_counter() - t1:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("train: fault drill")
        del clean, faulty, again, final, params2, opt2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10 in {time.perf_counter() - t0:.1f} s")
    # phase 19's dry runs run on the host, each a process of its own,
    # while the card runs phases 11-18
    dry_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dry_procs = start_dryruns(dry_tmp)

    # ---- shared by phases 11 and 12: a family's model at published width
    # and depth through generate and serve
    def family_requests(vocab, seed):
        """``FAM_MIX``'s requests from ``seed``: prompt lengths drawn from
        ``FAM_LENS`` (so that generate() can run each length's prompts as
        one batch), random tokens."""
        r = np.random.default_rng(seed)
        n, new = FAM_MIX
        return [Request(tokens=r.integers(0, vocab, int(ln)).astype(
            np.int32), max_new_tokens=new) for ln in r.choice(FAM_LENS, n)]

    def greedy_rows(model, tokens, s_max, n_new, vocab):
        """Greedy decoding as ``Engine.generate`` runs it (prefill, then
        decode steps, argmax of the float32 logits), with per row and step
        the top-2 margin and the largest |logit|."""
        toks, margins, peaks = [], [], []
        with torch.inference_mode():
            logits, caches = model.prefill({"tokens": tokens}, s_max)
            for step in range(n_new):
                last = logits[:, -1, :vocab].float()
                top2 = torch.topk(last, 2, dim=-1).values
                margins.append((top2[:, 0] - top2[:, 1]).cpu())
                peaks.append(last.abs().amax(-1).cpu())
                tok = last.argmax(-1).int()[:, None]
                toks.append(tok)
                if step + 1 < n_new:
                    logits, caches = model.decode_step(caches, tok)
        return (torch.cat(toks, 1).cpu().numpy(),
                torch.stack(margins, 1).numpy(), torch.stack(peaks, 1).numpy())

    def streams_vs_generate(eng, reqs, vocab, margin_tol):
        """Each request's stream against ``eng.generate`` of its prompt
        (the prompts of one length as one batch).  A stream may leave
        generate's only at or after a step whose top-2 margin in generate's
        own run is below ``margin_tol`` · max|logit| (the margin rule).
        Returns (streams equal, streams within the rule, first steps that
        differ)."""
        by_len = collections.defaultdict(list)
        for i, r in enumerate(reqs):
            by_len[len(r.tokens)].append(i)
        exact, ok, first = [False] * len(reqs), [False] * len(reqs), []
        for ln, idx in sorted(by_len.items()):
            prompts = np.stack([reqs[i].tokens for i in idx])
            n_new = reqs[idx[0]].max_new_tokens
            want = eng.generate(prompts, n_new)
            trace = None
            for j, i in enumerate(idx):
                got = np.asarray(reqs[i].out)
                diff = np.flatnonzero(got != want[j]) \
                    if got.shape == want[j].shape else np.array([0])
                if not len(diff):
                    exact[i] = ok[i] = True
                    continue
                first.append(int(diff[0]))
                if trace is None:
                    trace = greedy_rows(eng.model, torch.from_numpy(
                        prompts).to(dev), eng.cfg.max_seq, n_new, vocab)
                    if not (trace[0] == want).all():
                        log(f"  generate and its greedy trace differ at "
                            f"prompt length {ln}")
                        continue
                _, m, pk = trace
                close = np.flatnonzero(m[j] < margin_tol * pk[j])
                ok[i] = bool(len(close)) and diff[0] >= close[0]
        return exact, ok, first

    def family_session(eng, vocab, seed, what):
        """``FAM_MIX`` through ``eng.serve`` with the decode step a CUDA
        graph (a warm-up session first): K2 launches tallied around each
        prefill and fused dispatch, the session's stats, tokens/s and what
        a caller waits per decode step; returns (reqs, stats, prefills,
        replays, launch counts, K2 in the prefills, K2 in the dispatches,
        wall seconds)."""
        eng.serve([Request(tokens=r.tokens[:64], max_new_tokens=4)
                   for r in family_requests(vocab, seed)[:FAM_SLOTS]])
        if eng._loop.graph is None:
            failures.append(f"{what}: no CUDA graph was captured")
        prefill_k2, widths_seen = [], set()
        fused = eng._fused_decode
        seen = tally_dispatches([eng])[0]
        tally_prefills(eng, prefill_k2, widths_seen)
        reqs = family_requests(vocab, seed)
        replays0 = eng._loop.replays
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts_ = launch_counts()
        eng._fused_decode = fused
        del eng._prefill                    # tally_prefills' wrapper
        st = eng.paging_stats
        prefills = eng._session.prefill_count
        replays = eng._loop.replays - replays0
        step_wait = sum(dt for dt, _, _ in seen) / max(
            1, sum(n for _, n, _ in seen)) * 1e3
        k2_decode = sum(k for _, _, k in seen)
        tokens_ = sum(len(r.out) for r in reqs)
        log(f"{what}: {len(reqs)} requests on {FAM_SLOTS} slots (prompts "
            f"{sorted(len(r.tokens) for r in reqs)}, {FAM_MIX[1]} new), "
            f"{st['n_pages']} pages of {SESS_PAGE}: {tokens_} tokens in "
            f"{wall:.3f} s, {tokens_ / wall:.1f} tokens/s; {prefills} "
            f"prefills, decode steps {st['decode_steps']}, dispatches "
            f"{st['decode_dispatches']}, graph replays {replays}, completed "
            f"{st['completed']}; a caller waits {step_wait:.3f} ms per "
            f"decode step; launch counts {counts_} {tag}")
        # one chunk of a full batch under the profiler: the card's busy
        # time per graph step against what a caller waits for it
        sess = eng.start_session(family_requests(vocab, seed)[:FAM_SLOTS])
        sess.step(1)                        # admit all, one step
        t = time.perf_counter()
        sess.step(SESS_CHUNK)
        wait = (time.perf_counter() - t) * 1e3 / SESS_CHUNK
        marks = []

        def one_chunk():
            before = sess.stats["decode_steps"]
            sess.step(SESS_CHUNK)
            marks.append(sess.stats["decode_steps"] - before)

        try:
            k = device_kernels(one_chunk, 1)
            if not marks[-1]:
                raise RuntimeError("the profiled chunk ran no decode step")
            busy = sum(us for _, us in k.values()) / 1e3 / marks[-1]
            k2_ms = sum(us for name, (_, us) in k.items()
                        if "rgcsr_spmm" in name or "combine_partials" in name
                        ) / 1e3 / marks[-1]
            top = sorted(k.items(), key=lambda kv: -kv[1][1])[:4]
            log(f"{what} decode step (profiler, one chunk of {marks[-1]} "
                f"graph steps, {FAM_SLOTS} slots): "
                f"{sum(n for n, _ in k.values()) / marks[-1]:.0f} kernels, "
                f"card busy {busy:.3f} ms per step, K2 {k2_ms:.3f} ms; a "
                f"caller waits {wait:.3f} ms per step of a chunk, idle share "
                f"{100 * (1 - busy / wait):.1f} %; largest: " + "; ".join(
                    f"{name[:60]} x{n:.0f} {us / 1e3:.3f} ms"
                    for name, (n, us) in top) + f" {tag}")
        except RuntimeError as err:
            failures.append(f"{what} decode step: card busy time not "
                            f"measured ({err})")
        sess.drain()
        return (reqs, st, prefills, replays, counts_, prefill_k2, k2_decode,
                wall)

    def profile_line(what, fn, calls, wall_ms, k2=True):
        """The card's busy time per call of ``fn`` (``torch.profiler``),
        K2's share and the idle share of ``wall_ms``; returns busy ms."""
        k = device_kernels(fn, calls)
        busy = sum(us for _, us in k.values())
        k2_us = sum(us for name, (_, us) in k.items()
                    if "rgcsr_spmm" in name or "combine_partials" in name)
        top = sorted(k.items(), key=lambda kv: -kv[1][1])[:4]
        log(f"{what} (profiler, {calls} calls): "
            f"{sum(n for n, _ in k.values()):.0f} kernels, card busy "
            f"{busy / 1e3:.3f} ms per call"
            + (f", K2 {k2_us / 1e3:.3f} ms ({100 * k2_us / busy:.1f} %)"
               if k2 else "")
            + f", idle share of the {wall_ms:.3f} ms a caller waits "
            f"{100 * (1 - busy / 1e3 / wall_ms):.1f} %; largest: "
            + "; ".join(f"{name[:60]} x{n:.0f} {us / 1e3:.3f} ms"
                        for name, (n, us) in top) + f" {tag}")
        return busy / 1e3

    def timed_generate(eng, prompts, s_max, what):
        """bf16 ``generate`` times: the prefill (median of 3), generate,
        decode ms per token, tokens/s; returns (prefill ms, decode ms,
        caches of the last prefill, generate's tokens)."""
        tokens_ = torch.from_numpy(prompts).to(dev)
        eng.generate(prompts, SERVE_NEW)            # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_ = eng.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t) * 1e3
        walls = []
        with torch.inference_mode():
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, caches = eng.model.prefill({"tokens": tokens_}, s_max)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
        pre_ms = float(np.median(walls))
        dec_ms = (gen_ms - pre_ms) / (SERVE_NEW - 1)
        finite = bool(torch.isfinite(logits[..., :eng.model.cfg.vocab]).all())
        log(f"{what}: prefill {pre_ms:.3f} ms ({prompts.shape[0]} x "
            f"{prompts.shape[1]} tokens), generate {gen_ms:.3f} ms for "
            f"{SERVE_NEW} new tokens, decode {dec_ms:.3f} ms per token, "
            f"{prompts.shape[0] * SERVE_NEW / gen_ms * 1e3:.1f} tokens/s; "
            f"prefill logits finite: {finite} {tag}")
        if not finite:
            failures.append(f"{what}: prefill logits not finite")
        return pre_ms, dec_ms, caches, out_

    def fp32_against(eng_a, eng_b, prompts, what):
        """Prefill logits of two fp32 engines within LOGIT_TOL · (1 +
        max|logit|), and ``eng_a.generate``'s greedy tokens against
        ``eng_b``'s greedy trace under the margin rule."""
        tokens_ = torch.from_numpy(prompts).to(dev)
        vocab_ = eng_b.model.cfg.vocab
        with torch.inference_mode():
            la = eng_a.model.prefill({"tokens": tokens_},
                                     eng_a.cfg.max_seq)[0]
            lb = eng_b.model.prefill({"tokens": tokens_},
                                     eng_b.cfg.max_seq)[0]
        la, lb = (v[..., :vocab_].float() for v in (la, lb))
        peak_ = lb.abs().max().item()
        err_ = (la - lb).abs().max().item()
        ok_ = bool(torch.isfinite(la).all()) and \
            err_ <= LOGIT_TOL * (1 + peak_)
        got_ = eng_a.generate(prompts, SERVE_NEW)
        want_, margins_, peaks_ = greedy_trace(
            eng_b.model, tokens_, eng_b.cfg.max_seq, SERVE_NEW, vocab_)
        close_ = [i for i, (m, p) in enumerate(zip(margins_, peaks_))
                  if m < MARGIN_TOL * p]
        upto = close_[0] if close_ else SERVE_NEW
        same_ = bool((got_[:, :upto] == want_[:, :upto]).all())
        log(f"{what}: prefill logits max_abs_err {err_:.3e}, max|logit| "
            f"{peak_:.3f} (tol {LOGIT_TOL:g} · (1 + max|logit|)) "
            f"{'ok' if ok_ else 'FAIL'}; greedy tokens identical through "
            f"step {upto} of {SERVE_NEW}: {same_} (smallest top-2 margin "
            f"{min(margins_):.3e}; all steps identical: "
            f"{bool((got_ == want_).all())})")
        if not ok_:
            failures.append(f"{what}: prefill logits")
        if not same_:
            failures.append(f"{what}: greedy tokens")

    def stream_line(what, eng, reqs, vocab, tol=BF16_TOL):
        """Streams against ``generate`` under the margin rule at ``tol``."""
        exact, ok_, first = streams_vs_generate(eng, reqs, vocab, tol)
        log(f"{what}: streams equal to generate() of their prompts: "
            f"{sum(exact)} of {len(reqs)}; the others leave it at steps "
            f"{sorted(first)}, each at or after a top-2 margin below "
            f"{tol:g} · max|logit| in generate's run: "
            f"{all(ok_)} {'ok' if all(ok_) else 'FAIL'}")
        if not all(ok_):
            failures.append(f"{what}: streams against generate")

    phase("11 mla")
    # ---- 11. MLA: minicpm3-4b at its published width and depth, the
    # RgCSR FFN through K2 — generate, then sessions on paged MLA caches
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"mla: held from the earlier phases: {live_cuda()}")
    torch.cuda.reset_peak_memory_stats()
    mla_cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS,
                                  sparsity=SparsityConfig(**SERVE_SPARSITY))
    n_mla = mla_cfg.n_layers
    mla_tree = init_params(mla_cfg,
                           torch.Generator(device=dev).manual_seed(SEED))
    mla_sc = ServeConfig(max_seq=SERVE_MAX_SEQ)
    engine = Engine(mla_cfg, mla_sc, params=mla_tree, device=dev)
    torch.cuda.synchronize()
    mla_layers = [b.ffn.w_out for b in engine.model.layers]
    m = mla_cfg.mla
    log(f"mla: {mla_cfg.name} {n_mla} layers, d_model {mla_cfg.d_model}, "
        f"{mla_cfg.n_heads} heads, MLA q_lora {m.q_lora_rank} kv_lora "
        f"{m.kv_lora_rank} nope {m.qk_nope_head_dim} rope "
        f"{m.qk_rope_head_dim} v {m.v_head_dim}, d_ff {mla_cfg.d_ff}, vocab "
        f"{mla_cfg.vocab}, {engine.model.n_params()} parameters, w_out in "
        f"RgCSR ({mla_layers[0].values2d.shape[0]} slot rows of "
        f"{mla_layers[0].values2d.shape[1]} lanes, "
        f"{-(-mla_cfg.d_model // 128)} groups); init and "
        f"{engine.plans_warmed} plans in {time.perf_counter() - t0:.1f} s")
    if engine.plans_warmed != n_mla:
        failures.append(f"mla: {engine.plans_warmed} plans warmed, want "
                        f"{n_mla}")
    prompts = np.random.default_rng(SEED + 11).integers(
        0, mla_cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    engine.generate(prompts, SERVE_NEW)        # warm-up (casts, work lists)
    widths = collections.Counter()
    hooks = [lay.register_forward_pre_hook(count_width)
             for lay in mla_layers]
    reset_launch_counts()
    out = engine.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    mla_counts = launch_counts()
    for h in hooks:
        h.remove()
    want_counts = {"rgcsr_spmv": 0, "rgcsr_spmm": n_mla * SERVE_NEW,
                   "ell_spmv": 0}
    want_widths = {SERVE_BATCH * SERVE_PROMPT: n_mla,
                   SERVE_BATCH: n_mla * (SERVE_NEW - 1)}
    builds = {lay.plan_builds for lay in mla_layers}
    ok = (mla_counts == want_counts and dict(widths) == want_widths
          and builds == {1} and out.shape == (SERVE_BATCH, SERVE_NEW)
          and bool(((out >= 0) & (out < mla_cfg.vocab)).all()))
    log(f"mla main path: generate {SERVE_BATCH} x {SERVE_PROMPT} tokens, "
        f"{SERVE_NEW} new: launch counts {mla_counts} (want {want_counts}),"
        f" K2 calls by width {dict(widths)}, plan builds per layer "
        f"{sorted(builds)} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("mla: generate's launches, widths or tokens")

    # float32 (the caches too): K2 against w_out as dense matmuls
    t1 = time.perf_counter()
    mla32 = dataclasses.replace(mla_cfg, dtype="float32",
                                kv_cache_dtype="float32")
    eng32 = Engine(mla32, mla_sc, params=mla_tree, device=dev)
    dense_tree = dict(mla_tree, layers=[
        dict(layer, ffn=dict(layer["ffn"], w_out={
            "kernel": dense_equivalent(lay).T.contiguous()}))
        for layer, lay in zip(mla_tree["layers"], mla_layers)])
    eng32d = Engine(dataclasses.replace(mla32, sparsity=SparsityConfig()),
                    mla_sc, params=dense_tree, device=dev)
    fp32_against(eng32, eng32d, prompts, "mla fp32, K2 vs dense w_out")
    del eng32d, dense_tree
    # paged MLA decode against the dense-layout decode, fp32, one slot
    geom = paging.geometry(FAM_PAGED_MAX_SEQ, SESS_PAGE, n_slots=1)
    model32 = eng32.model
    for ln in FAM_PAGED_LENS:
        alloc = paging.PageAllocator(geom, 1)
        alloc.admit(0, ln, alloc.pages_for(ln + FAM_PAGED_STEPS))
        tok = torch.from_numpy(np.random.default_rng(ln).integers(
            0, mla_cfg.vocab, (1, ln)).astype(np.int32)).to(dev)
        worst = 0.0
        with torch.inference_mode():
            caches = model32.init_cache(1, FAM_PAGED_MAX_SEQ, paging=geom)
            logits, dense = model32.prefill({"tokens": tok},
                                            FAM_PAGED_MAX_SEQ)
            paging.commit_prefill(caches, dense, 0, ln, alloc.table,
                                  SESS_PAGE)
            nxt = logits[:, -1, :mla_cfg.vocab].argmax(-1).int()[:, None]
            for step in range(FAM_PAGED_STEPS):
                if alloc.ensure(0, ln + step + 1):
                    paging.sync_block_tables(caches, alloc.table)
                got, _ = model32.decode_step(caches, nxt)
                for c in caches:
                    c["index"] += 1
                want, dense = model32.decode_step(dense, nxt)
                got, want = (v[..., :mla_cfg.vocab].float()
                             for v in (got, want))
                worst = max(worst, (got - want).abs().max().item()
                            / (1 + want.abs().max().item()))
                nxt = want[:, -1].argmax(-1).int()[:, None]
        ok = worst <= FP32_TOL and set(caches[0]) == {
            "ckv", "krope", "block_table", "index"}
        log(f"mla fp32 paged decode vs dense, prompt {ln} ({ln % SESS_PAGE}"
            f" into a page of {SESS_PAGE}), {FAM_PAGED_STEPS} steps: "
            f"largest |paged - dense| / (1 + max|logit|) {worst:.3e} (tol "
            f"{FP32_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"mla fp32 paged decode, prompt {ln}")
    del eng32, model32, caches, dense, logits, got, want
    log(f"mla fp32 checks in {time.perf_counter() - t1:.1f} s")

    # bfloat16 times, the card's busy time, K2's share
    pre_ms, dec_ms, caches, _ = timed_generate(engine, prompts,
                                               SERVE_MAX_SEQ, "mla bf16")
    with torch.inference_mode():
        tok = torch.from_numpy(out[:, :1]).to(dev)
        index0 = caches[0]["index"].clone()

        def step():
            engine._decode([dict(c, index=index0) for c in caches], tok)

        step_wait = ms(step, 5)
        profile_line("mla bf16 prefill", lambda: engine.model.prefill(
            {"tokens": tokens}, SERVE_MAX_SEQ), 2, pre_ms)
        profile_line("mla bf16 decode step", step, 5, step_wait)
    del caches

    # (b) sessions on paged MLA caches, the decode step a CUDA graph
    t1 = time.perf_counter()
    sess_eng = Engine(mla_cfg, ServeConfig(
        max_seq=FAM_MAX_SEQ, n_slots=FAM_SLOTS, page_size=SESS_PAGE,
        decode_chunk=SESS_CHUNK), params=engine.params)
    reqs, st, prefills, replays, sess_counts, prefill_k2, k2_decode, _ = \
        family_session(sess_eng, mla_cfg.vocab, SEED + 12, "mla session bf16")
    want_k2 = n_mla * (st["decode_steps"] + prefills)
    ok = (sess_counts == {"rgcsr_spmv": 0, "rgcsr_spmm": want_k2,
                          "ell_spmv": 0}
          and k2_decode == n_mla * st["decode_steps"]
          and prefill_k2 == [n_mla] * prefills
          and replays == st["decode_steps"]
          and st["completed"] == len(reqs)
          and set(sess_eng._loop.caches[0]) == {"ckv", "krope",
                                                "block_table", "index"})
    log(f"mla session bf16: K2 want {n_mla} x ({st['decode_steps']} steps + "
        f"{prefills} prefills) = {want_k2}, in the fused dispatches "
        f"{k2_decode}, in the prefills {sum(prefill_k2)}; replays "
        f"{replays} = decode steps; paged caches {sorted(sess_eng._loop.caches[0])} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("mla session: launches, replays or completions")
    stream_line("mla session bf16", sess_eng, reqs, mla_cfg.vocab)
    # K2 at minicpm3's w_out against its plain version, then its times
    lay = mla_layers[0]
    plan = lay.plan_for(torch.bfloat16)
    for d in FAM_K2_WIDTHS:
        xw = torch.from_numpy(rng.standard_normal(
            (lay.d_in, d)).astype(np.float32)).to(dev)
        k2_check(f"minicpm3 w_out d{d} fp32 (kept plan)", plan, xw)
        k2_check(f"minicpm3 w_out d{d} bf16 (kept plan)", plan, xw,
                 torch.bfloat16, BF16_TOL, key=f"minicpm3 w_out d{d}")
    mla_launches = {SERVE_BATCH: widths[SERVE_BATCH], FAM_SLOTS: k2_decode,
                    SERVE_BATCH * SERVE_PROMPT: widths[SERVE_BATCH
                                                       * SERVE_PROMPT]}
    for d in FAM_K2_WIDTHS:
        entries.append(k2_serving_entry(
            lay, d, mla_launches[d], errs[("rgcsr_spmm",
                                           f"minicpm3 w_out d{d}")],
            arch=MLA_ARCH))
    torch.cuda.synchronize()
    log(f"mla peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}; "
        f"sessions and K2 in {time.perf_counter() - t1:.1f} s; phase 11 in "
        f"{time.perf_counter() - t0:.1f} s")
    del engine, sess_eng, mla_layers, mla_tree, lay, plan, reqs
    gc.collect()
    torch.cuda.empty_cache()

    phase("12 moe")
    # ---- 12. MoE: granite-moe-1b-a400m at its published width and depth
    # (no K1–K3: its experts are dense stacked products, and the reference
    # sparsifies no MoE FFN), then deepseek-v3-671b at its smoke size
    t0 = time.perf_counter()
    log(f"moe: held from the earlier phases: {live_cuda()}")
    torch.cuda.reset_peak_memory_stats()
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    mo = moe_cfg.moe
    moe_tree = init_params(moe_cfg,
                           torch.Generator(device=dev).manual_seed(SEED))
    moe_sc = ServeConfig(max_seq=SERVE_MAX_SEQ)
    prompts = np.random.default_rng(SEED + 13).integers(
        0, moe_cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    # (a) float32, full depth: the einsum dispatch against the scatter one
    t1 = time.perf_counter()
    moe32 = dataclasses.replace(moe_cfg, dtype="float32",
                                kv_cache_dtype="float32")
    e32 = Engine(moe32, moe_sc, params=moe_tree, device=dev)
    s32 = Engine(dataclasses.replace(moe32, moe=dataclasses.replace(
        mo, dispatch="scatter")), moe_sc, params=moe_tree, device=dev)
    log(f"moe: {moe_cfg.name} {moe_cfg.n_layers} layers, d_model "
        f"{moe_cfg.d_model}, {moe_cfg.n_heads}/{moe_cfg.n_kv_heads} heads of "
        f"{moe_cfg.head_dim}, {mo.n_experts} experts top-{mo.top_k} of "
        f"{mo.d_ff_expert}, vocab {moe_cfg.vocab}: {e32.model.n_params()} "
        f"parameters, {e32.model.n_active_params()} active a token")
    reset_launch_counts()
    fp32_against(e32, s32, prompts, "moe fp32, einsum vs scatter dispatch")
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        failures.append(f"moe: kernels of the port launched "
                        f"{launch_counts()}")
    del e32, s32
    # two layers at full width: the card against the port's CPU run
    cfg2 = dataclasses.replace(moe32, n_layers=MOE_CPU_LAYERS)
    tree2 = init_params(cfg2, torch.Generator(device=dev).manual_seed(SEED))
    outs = []
    for device_ in (dev, torch.device("cpu")):
        model = LanguageModel(cfg2, tree_to(tree2, device_))
        tk = torch.from_numpy(prompts).to(device_)
        with torch.inference_mode():
            logits, caches = model.prefill({"tokens": tk}, SERVE_MAX_SEQ)
            step_logits, _ = model.decode_step(caches, tk[:, :1])
        outs.append([v[..., :moe_cfg.vocab].float().cpu()
                     for v in (logits, step_logits)])
    worst = max((g - w).abs().max().item() / (1 + w.abs().max().item())
                for g, w in zip(*outs))
    ok = worst <= LOGIT_TOL
    log(f"moe fp32, {MOE_CPU_LAYERS} layers at full width: the card against "
        f"the port's CPU run on the same weights, prefill and one decode "
        f"step: largest |card - cpu| / (1 + max|logit|) {worst:.3e} (tol "
        f"{LOGIT_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("moe: the card against the CPU")
    del tree2, model, outs, caches, logits, step_logits
    log(f"moe fp32 checks in {time.perf_counter() - t1:.1f} s")

    # bfloat16 times, and the MoE layer's and its dispatch's share of a
    # decode step's card time
    engine = Engine(moe_cfg, moe_sc, params=moe_tree, device=dev)
    pre_ms, dec_ms, caches, out = timed_generate(engine, prompts,
                                                 SERVE_MAX_SEQ, "moe bf16")
    tokens = torch.from_numpy(prompts).to(dev)
    with torch.inference_mode():
        tok = torch.from_numpy(out[:, :1]).to(dev)
        index0 = caches[0]["index"].clone()

        def step():
            engine._decode([dict(c, index=index0) for c in caches], tok)

        step_wait = ms(step, 5)
        profile_line("moe bf16 prefill", lambda: engine.model.prefill(
            {"tokens": tokens}, SERVE_MAX_SEQ), 2, pre_ms, k2=False)
        busy_step = profile_line("moe bf16 decode step", step, 5,
                                 step_wait, k2=False)
        block = engine.model.layers[0]
        hx = torch.from_numpy(rng.standard_normal(
            (SERVE_BATCH, 1, moe_cfg.d_model)).astype(np.float32)).to(
                dev, torch.bfloat16)
        cap = moe_mod._capacity(moe_cfg, SERVE_BATCH, dropless=True)
        xe = torch.from_numpy(rng.standard_normal(
            (mo.n_experts, cap, moe_cfg.d_model)).astype(np.float32)).to(
                dev, torch.bfloat16)
        busy_moe = sum(us for _, us in device_kernels(
            lambda: moe_mod.moe_apply(block.ffn, moe_cfg, hx, dropless=True),
            20).values()) / 1e3
        busy_exp = sum(us for _, us in device_kernels(
            lambda: ffn_mod.ffn_apply_stacked(block.ffn.experts, moe_cfg, xe),
            20).values()) / 1e3
    n_moe = moe_cfg.n_layers
    log(f"moe bf16 decode step, {SERVE_BATCH} tokens: one MoE layer "
        f"{busy_moe:.4f} ms of card (its experts' stacked FFN at capacity "
        f"{cap} {busy_exp:.4f} ms, routing + dispatch + combine "
        f"{busy_moe - busy_exp:.4f} ms); x {n_moe} layers: the MoE "
        f"{100 * n_moe * busy_moe / busy_step:.1f} % and its dispatch "
        f"{100 * n_moe * (busy_moe - busy_exp) / busy_step:.1f} % of the "
        f"step's {busy_step:.3f} ms busy {tag}")
    del caches, block, hx, xe

    # (b) sessions on paged caches, the decode step a CUDA graph
    t1 = time.perf_counter()
    sess_eng = Engine(moe_cfg, ServeConfig(
        max_seq=FAM_MAX_SEQ, n_slots=FAM_SLOTS, page_size=SESS_PAGE,
        decode_chunk=SESS_CHUNK), params=engine.params)
    reqs, st, prefills, replays, sess_counts, _, _, _ = family_session(
        sess_eng, moe_cfg.vocab, SEED + 14, "moe session bf16")
    ok = (not any(sess_counts.values()) and replays == st["decode_steps"]
          and st["completed"] == len(reqs))
    log(f"moe session bf16: replays {replays} = decode steps "
        f"{st['decode_steps']}, no kernel of the port launched, completed "
        f"{st['completed']} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("moe session: launches, replays or completions")
    stream_line("moe session bf16", sess_eng, reqs, moe_cfg.vocab)
    log(f"moe sessions in {time.perf_counter() - t1:.1f} s; serving peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB {tag}")
    del engine, sess_eng, moe_tree, reqs
    gc.collect()
    torch.cuda.empty_cache()

    # (c) three AdamW steps through the launcher, bf16 compute
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tr, state = launch_train.main([
        "--arch", MOE_ARCH, "--steps", str(MOE_TRAIN_STEPS), "--seq",
        str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in tr._batch(MOE_TRAIN_STEPS).items()}
        aux = tr.model(batch, mode="train")[2]
    hist = tr.history
    finite = all(np.isfinite([h[k] for h in hist
                              for k in ("ce", "load_balance", "loss")])) \
        and all(torch.isfinite(v).all().item() for v in aux.values())
    ok = finite and len(hist) == MOE_TRAIN_STEPS \
        and tr.model.device.type == "cuda"
    for h in hist:
        log(f"moe train step {h['step']}: loss {h['loss']:.4f}, ce "
            f"{h['ce']:.4f}, load_balance {h['load_balance']:.4f}, "
            f"grad_norm {h['grad_norm']:.4f}, {h['step_time_s'] * 1e3:.1f} "
            f"ms host (ending in a synchronize), "
            f"{TRAIN_SEQ * TRAIN_BATCH / h['step_time_s']:.1f} tokens/s "
            f"{tag}")
    log(f"moe train: {MOE_TRAIN_STEPS} AdamW steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, bf16 compute, fp32 parameters; after them "
        f"load_balance {aux['load_balance'].item():.4f}, router_z "
        f"{aux['router_z'].item():.4f} (summed over {n_moe} layers), all "
        f"finite {finite}; peak {peak / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t1:.1f} s {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        failures.append("moe train: losses or aux not finite")
    del tr, state, batch, aux
    gc.collect()
    torch.cuda.empty_cache()

    # (d) deepseek-v3-671b at its smoke size: the dense prefix layer,
    # sigmoid routing with a nonzero bias, the shared expert, MLA and MTP
    ds_cfg = dataclasses.replace(get_smoke(DEEPSEEK_ARCH), dtype="float32",
                                 kv_cache_dtype="float32")
    full = get_config(DEEPSEEK_ARCH)
    log(f"moe {DEEPSEEK_ARCH}: reduced to its smoke config ({ds_cfg.n_layers}"
        f" layers of d_model {ds_cfg.d_model}, {ds_cfg.moe.n_experts} experts"
        f" top-{ds_cfg.moe.top_k}; published: {full.n_layers} layers of "
        f"{full.d_model}, {full.moe.n_experts} experts, whose MoE layers "
        f"alone exceed one card): a correctness check, no number recorded")
    ds_tree = init_params(ds_cfg, torch.Generator().manual_seed(SEED))
    for layer in ds_tree["layers"]:
        if "router" in layer["ffn"]:
            layer["ffn"]["router"]["bias"].uniform_(
                -0.3, 0.3, generator=torch.Generator().manual_seed(SEED + 1))
    batch = {k: torch.from_numpy(v) for k, v in train_data.make_batch(
        train_data.DataConfig(vocab=ds_cfg.vocab, seq_len=32,
                              global_batch=4, seed=SEED), 0).items()}
    outs = []
    for device_ in (dev, torch.device("cpu")):
        model = LanguageModel(ds_cfg, tree_to(ds_tree, device_))
        b = {k: v.to(device_) for k, v in batch.items()}
        with torch.no_grad():
            logits = model(b)[0][..., :ds_cfg.vocab].float().cpu()
            loss, metrics = model.loss(b)
        outs.append((logits, {k: v.item() for k, v in metrics.items()}))
    err = (outs[0][0] - outs[1][0]).abs().max().item() / (
        1 + outs[1][0].abs().max().item())
    loss_err = max(abs(outs[0][1][k] - outs[1][1][k]) for k in outs[1][1])
    ok = err <= LOGIT_TOL and loss_err <= LOGIT_TOL \
        and set(outs[0][1]) == {"ce", "load_balance", "mtp", "loss"}
    log(f"moe {DEEPSEEK_ARCH} smoke fp32, the card against the CPU: logits "
        f"largest |card - cpu| / (1 + max|logit|) {err:.3e}, loss terms "
        f"{outs[0][1]} (largest gap {loss_err:.3e}; tol {LOGIT_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"moe {DEEPSEEK_ARCH} smoke: card against the CPU")
    del ds_tree, model, outs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12 in {time.perf_counter() - t0:.1f} s")

    phase("13 recurrent")
    # ---- 13. the recurrent families at published width and depth:
    # recurrentgemma-9b (RG-LRU + local attention, the RgCSR FFN through
    # K2) and mamba2-780m (Mamba-2 SSD; no FFN, so no K1–K3)
    def state_tensors(loop):
        return [t for c in loop.caches for k, t in c.items()
                if k in ("conv", "ssm", "h")]

    def prefill_decode_vs_forward(model, vocab, what):
        """fp32: a prefill of REC_LONG tokens, then REC_STEPS decode steps,
        against one forward over all REC_LONG + REC_STEPS tokens."""
        n = REC_LONG + REC_STEPS
        toks = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
            0, vocab, (1, n)).astype(np.int32)).to(dev)
        with torch.inference_mode():
            full = model({"tokens": toks})[0][0, REC_LONG - 1:, :vocab]
            logits, caches = model.prefill({"tokens": toks[:, :REC_LONG]}, n)
            got = [logits[0, -1, :vocab]]
            for i in range(REC_LONG, n):
                logits, caches = model.decode_step(caches, toks[:, i:i + 1])
                got.append(logits[0, -1, :vocab])
        got, full = torch.stack(got).float(), full.float()
        err = ((got - full).abs().max() / (1 + full.abs().max())).item()
        ok = bool(torch.isfinite(got).all()) and err <= LOGIT_TOL
        log(f"{what} fp32: a prefill of {REC_LONG} tokens and {REC_STEPS} "
            f"decode steps against one forward over {n}: largest |step - "
            f"forward| / (1 + max|logit|) {err:.3e} (tol {LOGIT_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{what}: prefill + decode against a forward")

    def reference_draw(cfg, tree):
        """``tree`` (the port's draw) scaled to the reference's: its
        ``fan_in`` init counts a body layer's stacked axis
        (``src/repro/models/spec.py:66``), so each body layer's
        ``fan_in`` weight is 1/√R of one layer's draw, R =
        ``cfg.pattern_repeats``; nothing else changes."""
        scale = cfg.pattern_repeats ** -0.5

        def walk(spec, t):
            if isinstance(spec, P):
                return t * scale if spec.init == "fan_in" else t
            if isinstance(spec, dict):
                return {k: walk(spec[k], t[k]) for k in spec}
            return [walk(a, b) for a, b in zip(spec, t, strict=True)]

        n_prefix = len(cfg.prefix_pattern)
        layers = [walk(sp, t) if i >= n_prefix else t for i, (sp, t) in
                  enumerate(zip(model_spec(cfg)["layers"], tree["layers"],
                                strict=True))]
        return {**tree, "layers": layers}

    def batch_gap(cfg, tree, tokens):
        """Each prompt's prefill logits alone against the batch's: the
        largest |alone - batch| / max|logit| over the prompts."""
        model_ = LanguageModel(cfg, tree)
        with torch.inference_mode():
            together = model_.prefill({"tokens": tokens}, SERVE_MAX_SEQ)[0]
            alone = torch.cat([model_.prefill(
                {"tokens": tokens[i:i + 1]}, SERVE_MAX_SEQ)[0]
                for i in range(tokens.shape[0])])
        together, alone = (v[:, -1, :cfg.vocab].float()
                           for v in (together, alone))
        return ((together - alone).abs().amax(-1)
                / together.abs().amax(-1)).max().item()

    def dead_replay_check(eng, vocab, seed, what):
        """One replay of the captured step after a chunk (``steps_ran ==
        n_steps``: not live) leaves every recurrent state and index bit
        for bit."""
        sess = eng.start_session(family_requests(vocab, seed)[:FAM_SLOTS])
        sess.step(SESS_CHUNK)
        loop = eng._loop
        states = state_tensors(loop)
        held = states + [c["index"] for c in loop.caches if "index" in c]
        before = [t.clone() for t in held]
        with torch.inference_mode():   # no graph: a failure already
            (loop.graph.replay if loop.graph is not None else loop._step)()
        torch.cuda.synchronize()
        same = all(torch.equal(t, b) for t, b in zip(held, before))
        sess.step(1)
        moved = all(not torch.equal(t, b) for t, b in zip(states, before))
        sess.drain()
        ok = same and moved
        log(f"{what}: a replay past n_steps leaves {len(states)} state "
            f"tensors ({sum(t.numel() for t in states)} values) and "
            f"{len(held) - len(states)} indices bit-identical: {same}; the "
            f"next live step moves "
            f"every one: {moved} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{what}: dead replay")

    # (a) recurrentgemma-9b with the RgCSR FFN
    t0 = t13 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"recurrent: held from the earlier phases: {live_cuda()}")
    torch.cuda.reset_peak_memory_stats()
    rg_cfg = dataclasses.replace(get_config(REC_RG_ARCH), n_layers=RG_LAYERS,
                                 sparsity=SparsityConfig(**SERVE_SPARSITY))
    n_rg = rg_cfg.n_layers
    rg_tree = init_params(rg_cfg,
                          torch.Generator(device=dev).manual_seed(SEED))
    rg_sc = ServeConfig(max_seq=SERVE_MAX_SEQ)
    engine = Engine(rg_cfg, rg_sc, params=rg_tree, device=dev)
    torch.cuda.synchronize()
    rg_layers = [b.ffn.w_out for b in engine.model.layers
                 if hasattr(b, "ffn")]
    n_float = sum(t.numel() for t in engine.model.tensors().values()
                  if t.is_floating_point())
    n_dense = count_params(model_spec(dataclasses.replace(
        get_config(REC_RG_ARCH), n_layers=RG_LAYERS)))
    kinds = "".join(k[0] for k in tfm.layer_kinds(rg_cfg))
    log(f"recurrent: {rg_cfg.name} {n_rg} layers ({kinds}: r = rec, a = "
        f"attn_local), d_model {rg_cfg.d_model}, "
        f"{rg_cfg.n_heads}/{rg_cfg.n_kv_heads} heads of {rg_cfg.head_dim}, "
        f"window {rg_cfg.window}, d_ff {rg_cfg.d_ff}, vocab {rg_cfg.vocab}: "
        f"{n_dense} parameters counted dense, {n_float} float ones held "
        f"with w_out in RgCSR ({rg_layers[0].values2d.shape[0]}"
        f" slot rows of {rg_layers[0].values2d.shape[1]} lanes, "
        f"{-(-rg_cfg.d_model // 128)} groups); init and "
        f"{engine.plans_warmed} plans in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if engine.plans_warmed != n_rg or len(rg_layers) != n_rg:
        failures.append(f"recurrent: {engine.plans_warmed} plans warmed, "
                        f"want {n_rg}")
    prompts = np.random.default_rng(SEED + 16).integers(
        0, rg_cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)

    # float32 (the caches too): K2 against w_out as dense matmuls, then
    # prefill + decode against one forward
    t1 = time.perf_counter()
    rg32 = dataclasses.replace(rg_cfg, dtype="float32",
                               kv_cache_dtype="float32")
    eng32 = Engine(rg32, rg_sc, params=rg_tree, device=dev)
    dense_tree = dict(rg_tree, layers=[
        dict(layer, ffn=dict(layer["ffn"], w_out={
            "kernel": dense_equivalent(lay).T.contiguous()}))
        for layer, lay in zip(rg_tree["layers"], rg_layers)])
    eng32d = Engine(dataclasses.replace(rg32, sparsity=SparsityConfig()),
                    rg_sc, params=dense_tree, device=dev)
    torch.cuda.synchronize()
    log(f"recurrent fp32: with the dense-equivalent w_out of every layer "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    fp32_against(eng32, eng32d, prompts, "recurrent rg fp32, K2 vs dense "
                 "w_out")
    del eng32d, dense_tree
    prefill_decode_vs_forward(eng32.model, rg_cfg.vocab, "recurrent rg")
    del eng32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"recurrent rg fp32 checks in {time.perf_counter() - t1:.1f} s")

    # the main path, bfloat16: K2 launches per layer and token by width
    engine.generate(prompts, SERVE_NEW)        # warm-up (casts, work lists)
    widths = collections.Counter()
    hooks = [lay.register_forward_pre_hook(count_width)
             for lay in rg_layers]
    reset_launch_counts()
    out = engine.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    rg_counts = launch_counts()
    for h in hooks:
        h.remove()
    want_counts = {"rgcsr_spmv": 0, "rgcsr_spmm": n_rg * SERVE_NEW,
                   "ell_spmv": 0}
    want_widths = {SERVE_BATCH * SERVE_PROMPT: n_rg,
                   SERVE_BATCH: n_rg * (SERVE_NEW - 1)}
    builds = {lay.plan_builds for lay in rg_layers}
    ok = (rg_counts == want_counts and dict(widths) == want_widths
          and builds == {1} and out.shape == (SERVE_BATCH, SERVE_NEW)
          and bool(((out >= 0) & (out < rg_cfg.vocab)).all()))
    log(f"recurrent rg main path: generate {SERVE_BATCH} x {SERVE_PROMPT} "
        f"tokens, {SERVE_NEW} new: launch counts {rg_counts} (want "
        f"{want_counts}), K2 calls by width {dict(widths)}, plan builds per "
        f"layer {sorted(builds)} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recurrent rg: generate's launches, widths or "
                        "tokens")
    pre_ms, dec_ms, caches, _ = timed_generate(engine, prompts,
                                               SERVE_MAX_SEQ,
                                               "recurrent rg bf16")
    with torch.inference_mode():
        tok = torch.from_numpy(out[:, :1]).to(dev)
        index0 = next(c["index"] for c in caches if "index" in c).clone()

        def step():
            engine._decode([dict(c, index=index0) if "index" in c else c
                            for c in caches], tok)

        step_wait = ms(step, 5)
        profile_line("recurrent rg bf16 prefill", lambda: engine.model.prefill(
            {"tokens": tokens}, SERVE_MAX_SEQ), 2, pre_ms)
        profile_line("recurrent rg bf16 decode step", step, 5, step_wait)
    del caches
    log(f"recurrent rg bf16: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated with the compute-dtype copies, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB so far {tag}")

    # (a') sessions: rings and recurrent states, the decode step a graph
    t1 = time.perf_counter()
    sess_eng = Engine(rg_cfg, ServeConfig(
        max_seq=FAM_MAX_SEQ, n_slots=FAM_SLOTS, page_size=SESS_PAGE,
        decode_chunk=SESS_CHUNK), params=engine.params)
    reqs, st, prefills, replays, sess_counts, prefill_k2, k2_decode, _ = \
        family_session(sess_eng, rg_cfg.vocab, SEED + 17,
                       "recurrent rg session bf16")
    want_k2 = n_rg * (st["decode_steps"] + prefills)
    keys = [sorted(c) for c in sess_eng._loop.caches[:3]]
    ok = (sess_counts == {"rgcsr_spmv": 0, "rgcsr_spmm": want_k2,
                          "ell_spmv": 0}
          and k2_decode == n_rg * st["decode_steps"]
          and prefill_k2 == [n_rg] * prefills
          and replays == st["decode_steps"]
          and st["completed"] == len(reqs)
          and keys == [["conv", "h"], ["conv", "h"], ["index", "k", "v"]])
    log(f"recurrent rg session bf16: K2 want {n_rg} x ({st['decode_steps']} "
        f"steps + {prefills} prefills) = {want_k2}, in the fused dispatches "
        f"{k2_decode}, in the prefills {sum(prefill_k2)}; replays "
        f"{replays} = decode steps; the first layers' caches {keys} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recurrent rg session: launches, replays or "
                        "completions")
    stream_line("recurrent rg session bf16", sess_eng, reqs, rg_cfg.vocab)
    dead_replay_check(sess_eng, rg_cfg.vocab, SEED + 18,
                      "recurrent rg dead step")
    # K2 at recurrentgemma's w_out against its plain version, then times
    lay = rg_layers[0]
    plan = lay.plan_for(torch.bfloat16)
    for d in REC_K2_WIDTHS:
        xw = torch.from_numpy(rng.standard_normal(
            (lay.d_in, d)).astype(np.float32)).to(dev)
        k2_check(f"recurrentgemma w_out d{d} fp32 (kept plan)", plan, xw)
        k2_check(f"recurrentgemma w_out d{d} bf16 (kept plan)", plan, xw,
                 torch.bfloat16, BF16_TOL, key=f"recurrentgemma w_out d{d}")
        k2_check(f"recurrentgemma w_out d{d} fp32 pieces{REC_PIECE_ROWS} "
                 f"(kept plan)", plan, xw, piece_rows=REC_PIECE_ROWS)
    rg_launches = {SERVE_BATCH: widths[SERVE_BATCH], FAM_SLOTS: k2_decode,
                   SERVE_BATCH * SERVE_PROMPT: widths[SERVE_BATCH
                                                      * SERVE_PROMPT]}
    for d in FAM_K2_WIDTHS:
        entries.append(k2_serving_entry(
            lay, d, rg_launches[d], errs[("rgcsr_spmm",
                                          f"recurrentgemma w_out d{d}")],
            arch=REC_RG_ARCH))
    torch.cuda.synchronize()
    log(f"recurrent rg peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}; "
        f"sessions and K2 in {time.perf_counter() - t1:.1f} s; "
        f"recurrentgemma in {time.perf_counter() - t0:.1f} s")
    del engine, sess_eng, rg_layers, rg_tree, lay, plan, reqs
    gc.collect()
    torch.cuda.empty_cache()

    # (b) mamba2-780m
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mb_cfg = dataclasses.replace(get_config(REC_MAMBA_ARCH),
                                 n_layers=MAMBA_LAYERS)
    sm = mb_cfg.ssm
    mb_tree = init_params(mb_cfg,
                          torch.Generator(device=dev).manual_seed(SEED))
    mb_sc = ServeConfig(max_seq=SERVE_MAX_SEQ)
    prompts = np.random.default_rng(SEED + 19).integers(
        0, mb_cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    mb32 = dataclasses.replace(mb_cfg, dtype="float32",
                               kv_cache_dtype="float32")
    model = LanguageModel(mb32, mb_tree)
    log(f"recurrent: {mb_cfg.name} {mb_cfg.n_layers} SSD layers, d_model "
        f"{mb_cfg.d_model}, {sm.expand * mb_cfg.d_model // sm.head_dim} heads "
        f"of {sm.head_dim}, d_state {sm.d_state}, chunk {sm.chunk}, vocab "
        f"{mb_cfg.vocab} (padded {mb_cfg.padded_vocab}): "
        f"{model.n_params()} parameters")
    prefill_decode_vs_forward(model, mb_cfg.vocab, "recurrent mamba2")
    del model
    # two layers at full width: the card against the port's CPU run
    cfg2 = dataclasses.replace(mb32, n_layers=REC_CPU_LAYERS)
    tree2 = init_params(cfg2, torch.Generator(device=dev).manual_seed(SEED))
    outs = []
    for device_ in (dev, torch.device("cpu")):
        model = LanguageModel(cfg2, tree_to(tree2, device_))
        tk = torch.from_numpy(prompts).to(device_)
        with torch.inference_mode():
            logits, caches = model.prefill({"tokens": tk}, SERVE_MAX_SEQ)
            step_logits, _ = model.decode_step(caches, tk[:, :1])
        outs.append([v[..., :mb_cfg.vocab].float().cpu()
                     for v in (logits, step_logits)])
    worst = max((g - w).abs().max().item() / (1 + w.abs().max().item())
                for g, w in zip(*outs))
    ok = worst <= LOGIT_TOL
    log(f"recurrent mamba2 fp32, {REC_CPU_LAYERS} layers at full width: the "
        f"card against the port's CPU run on the same weights, prefill and "
        f"one decode step: largest |card - cpu| / (1 + max|logit|) "
        f"{worst:.3e} (tol {LOGIT_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recurrent mamba2: the card against the CPU")
    del tree2, model, outs, caches, logits, step_logits
    # The port draws each layer's fan_in weights at 1/sqrt(d_in); the
    # reference's stacked draw is 1/sqrt(R) smaller in the body.  At the
    # port's draw this depth amplifies rounding: the same prompt's bf16
    # logits move with the batch they are computed in.  Measured at both
    # draws, each prompt alone against the batch of 4, in bf16 and fp32.
    mb_ref = reference_draw(mb_cfg, mb_tree)
    tokens = torch.from_numpy(prompts).to(dev)
    gaps = {(draw, what): batch_gap(cfg_, tree_, tokens)
            for draw, tree_ in (("port", mb_tree), ("reference", mb_ref))
            for what, cfg_ in (("bf16", mb_cfg), ("fp32", mb32))}
    log(f"recurrent mamba2 prefill logits, each prompt alone against the "
        f"batch of {SERVE_BATCH}: largest |alone - batch| / max|logit| at "
        f"the port's draw {gaps['port', 'bf16']:.3e} in bf16, "
        f"{gaps['port', 'fp32']:.3e} in fp32; at the reference's draw "
        f"(body fan_in weights / sqrt({mb_cfg.pattern_repeats})) "
        f"{gaps['reference', 'bf16']:.3e} in bf16, "
        f"{gaps['reference', 'fp32']:.3e} in fp32 (the bf16 bar is "
        f"{BF16_TOL:g}) {tag}")
    # bfloat16 times, then sessions with the graph, at the reference's draw
    engine = Engine(mb_cfg, mb_sc, params=mb_ref, device=dev)
    reset_launch_counts()
    pre_ms, dec_ms, caches, out = timed_generate(engine, prompts,
                                                 SERVE_MAX_SEQ,
                                                 "recurrent mamba2 bf16")
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        failures.append(f"recurrent mamba2: kernels of the port launched "
                        f"{launch_counts()}")
    with torch.inference_mode():
        tok = torch.from_numpy(out[:, :1]).to(dev)
        profile_line("recurrent mamba2 bf16 prefill",
                     lambda: engine.model.prefill({"tokens": tokens},
                                                  SERVE_MAX_SEQ),
                     2, pre_ms, k2=False)
        step_wait = ms(lambda: engine._decode(caches, tok), 5)
        profile_line("recurrent mamba2 bf16 decode step",
                     lambda: engine._decode(caches, tok), 5, step_wait,
                     k2=False)
    del caches
    sess_eng = Engine(mb_cfg, ServeConfig(
        max_seq=FAM_MAX_SEQ, n_slots=FAM_SLOTS, page_size=SESS_PAGE,
        decode_chunk=SESS_CHUNK), params=engine.params)
    reqs, st, prefills, replays, sess_counts, _, _, _ = family_session(
        sess_eng, mb_cfg.vocab, SEED + 20, "recurrent mamba2 session bf16")
    loop = sess_eng._loop
    ok = (not any(sess_counts.values()) and replays == st["decode_steps"]
          and st["completed"] == len(reqs)
          and all(sorted(c) == ["conv", "ssm"] for c in loop.caches))
    log(f"recurrent mamba2 session bf16: replays {replays} = decode steps "
        f"{st['decode_steps']}, no kernel of the port launched, completed "
        f"{st['completed']}, every cache a state (conv, ssm), no index "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recurrent mamba2 session: launches, replays or "
                        "completions")
    stream_line("recurrent mamba2 session bf16", sess_eng, reqs,
                mb_cfg.vocab)
    dead_replay_check(sess_eng, mb_cfg.vocab, SEED + 21,
                      "recurrent mamba2 dead step")
    # float32 (the states too), at the port's draw: the same sessions
    # through the graph, every stream held to generate under the fp32
    # margin rule
    sess32 = Engine(mb32, ServeConfig(
        max_seq=FAM_MAX_SEQ, n_slots=FAM_SLOTS, page_size=SESS_PAGE,
        decode_chunk=SESS_CHUNK), params=mb_tree, device=dev)
    reqs = family_requests(mb_cfg.vocab, SEED + 20)
    sess32.serve(reqs)
    st = sess32.paging_stats
    ok = (sess32._loop.graph is not None and st["completed"] == len(reqs)
          and sess32._loop.replays == st["decode_steps"])
    log(f"recurrent mamba2 session fp32, the port's draw: {len(reqs)} "
        f"requests on "
        f"{FAM_SLOTS} slots, decode steps {st['decode_steps']}, graph "
        f"replays {sess32._loop.replays}, completed {st['completed']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("recurrent mamba2 session fp32: replays or "
                        "completions")
    stream_line("recurrent mamba2 session fp32", sess32, reqs, mb_cfg.vocab,
                tol=MARGIN_TOL)
    del sess32
    log(f"recurrent mamba2 serving peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
    del engine, sess_eng, mb_tree, mb_ref, reqs, loop
    gc.collect()
    torch.cuda.empty_cache()

    # three AdamW steps through the launcher, bf16 compute
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tr, state = launch_train.main([
        "--arch", REC_MAMBA_ARCH, "--steps", str(REC_TRAIN_STEPS), "--seq",
        str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    hist = tr.history
    ok = (len(hist) == REC_TRAIN_STEPS and tr.model.device.type == "cuda"
          and all(np.isfinite([h[k] for h in hist for k in ("ce", "loss",
                                                             "grad_norm")])))
    for h in hist:
        log(f"recurrent mamba2 train step {h['step']}: loss "
            f"{h['loss']:.4f}, grad_norm {h['grad_norm']:.4f}, "
            f"{h['step_time_s'] * 1e3:.1f} ms host (ending in a "
            f"synchronize), {TRAIN_SEQ * TRAIN_BATCH / h['step_time_s']:.1f} "
            f"tokens/s {tag}")
    log(f"recurrent mamba2 train: {REC_TRAIN_STEPS} AdamW steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, bf16 compute, fp32 parameters: "
        f"all finite {ok}; peak {peak / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t1:.1f} s {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        failures.append("recurrent mamba2 train: losses not finite")
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"recurrent mamba2 in {time.perf_counter() - t0:.1f} s")
    log(f"phase 13 in {time.perf_counter() - t13:.1f} s")

    phase("14 encdec")
    # ---- 14. the encoder-decoder family and the vision frontend at
    # published width and depth, the RgCSR FFN through K2: seamless-m4t-
    # medium (its encoder's FFNs too) and pixtral-12b, served as the
    # reference serves them (Engine._prefill with the frames or patches,
    # then _sample and _decode per token)
    def frontend_batch(cfg, b, prompt, seed, frames=0):
        """``prompt`` random tokens per request and the frontend's input
        from ``seed``: ``frames`` (b, frames, d_frontend) for the encoder,
        or ``patch_embeds`` (b, frontend_tokens, d_frontend)."""
        r = np.random.default_rng(seed)
        out = {"tokens": r.integers(0, cfg.vocab, (b, prompt)).astype(
            np.int32)}
        shape = (b, frames if cfg.enc_dec else cfg.frontend_tokens,
                 cfg.d_frontend)
        out["frames" if cfg.enc_dec else "patch_embeds"] = \
            r.standard_normal(shape).astype(np.float32)
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}

    def serve_frontend(eng, batch, n_new, trace=False):
        """Greedy tokens (B, n_new) through ``eng._prefill(batch)``, then
        ``_sample`` and ``_decode`` per token (the reference's
        ``test_encdec_generate``); with ``trace`` per step the smallest
        top-2 margin over the batch and the largest |logit|."""
        vocab_ = eng.model.cfg.vocab
        toks, margins_, peaks_ = [], [], []
        with torch.inference_mode():
            logits, caches_ = eng._prefill(batch)
            for i in range(n_new):
                if trace:
                    last = logits[:, -1, :vocab_].float()
                    top2 = torch.topk(last, 2, dim=-1).values
                    margins_.append((top2[:, 0] - top2[:, 1]).min().item())
                    peaks_.append(last.abs().max().item())
                tok_ = eng._sample(logits)[:, None]
                toks.append(tok_)
                if i + 1 < n_new:
                    logits, caches_ = eng._decode(caches_, tok_)
        return torch.cat(toks, 1).cpu().numpy(), margins_, peaks_

    def frontend_against(eng_a, eng_b, batch, what):
        """fp32: prefill logits of two engines within LOGIT_TOL · (1 +
        max|logit|), ``eng_a``'s greedy tokens against ``eng_b``'s under
        the margin rule."""
        vocab_ = eng_b.model.cfg.vocab
        with torch.inference_mode():
            la, lb = (e._prefill(batch)[0][..., :vocab_].float()
                      for e in (eng_a, eng_b))
        peak_ = lb.abs().max().item()
        err_ = (la - lb).abs().max().item()
        ok_ = bool(torch.isfinite(la).all()) and \
            err_ <= LOGIT_TOL * (1 + peak_)
        got_ = serve_frontend(eng_a, batch, SERVE_NEW)[0]
        want_, margins_, peaks_ = serve_frontend(eng_b, batch, SERVE_NEW,
                                                 trace=True)
        close_ = [i for i, (m, p) in enumerate(zip(margins_, peaks_))
                  if m < MARGIN_TOL * p]
        upto = close_[0] if close_ else SERVE_NEW
        same_ = bool((got_[:, :upto] == want_[:, :upto]).all())
        log(f"{what}: prefill logits max_abs_err {err_:.3e}, max|logit| "
            f"{peak_:.3f} (tol {LOGIT_TOL:g} · (1 + max|logit|)) "
            f"{'ok' if ok_ else 'FAIL'}; greedy tokens identical through "
            f"step {upto} of {SERVE_NEW}: {same_} (smallest top-2 margin "
            f"{min(margins_):.3e}; all steps identical: "
            f"{bool((got_ == want_).all())})")
        if not ok_:
            failures.append(f"{what}: prefill logits")
        if not same_:
            failures.append(f"{what}: greedy tokens")

    def dense_w_out(tree_, layers_, key):
        """``tree_`` with the ``key`` stack's (``"layers"`` or
        ``"encoder"``) ``w_out`` as its dense equivalent; every other
        tensor shared."""
        return dict(tree_, **{key: [
            dict(layer, ffn=dict(layer["ffn"], w_out={
                "kernel": dense_equivalent(lay).T.contiguous()}))
            for layer, lay in zip(tree_[key], layers_, strict=True)]})

    def rewound(caches_, index_):
        """Caches whose every position index is ``index_`` (a decoder
        layer's in its ``self`` cache): a timed decode step never runs
        past the cache."""
        return [dict(c, self=dict(c["self"], index=index_)) if "self" in c
                else dict(c, index=index_) for c in caches_]

    def frontend_main_path(eng, batch, k2_layers, want_counts, want_widths,
                           what):
        """K2's launches over one ``serve_frontend`` run (a warm-up run
        first), counted by width; returns (tokens, counts, widths)."""
        warm = serve_frontend(eng, batch, SERVE_NEW)[0]        # warm-up
        widths.clear()
        hooks_ = [lay.register_forward_pre_hook(count_width)
                  for lay in k2_layers]
        reset_launch_counts()
        out_ = serve_frontend(eng, batch, SERVE_NEW)[0]
        torch.cuda.synchronize()
        counts_ = launch_counts()
        for h in hooks_:
            h.remove()
        builds_ = {lay.plan_builds for lay in k2_layers}
        ok_ = (counts_ == want_counts and dict(widths) == want_widths
               and builds_ == {1} and bool((out_ == warm).all())
               and bool(((out_ >= 0)
                         & (out_ < eng.model.cfg.vocab)).all()))
        log(f"{what} main path: _prefill + {SERVE_NEW - 1} x (_sample, "
            f"_decode), {out_.shape[0]} requests: launch counts {counts_} "
            f"(want {want_counts}), K2 calls by width {dict(widths)} (want "
            f"{want_widths}), plan builds per layer {sorted(builds_)}, the "
            f"warm-up's tokens again: {bool((out_ == warm).all())} "
            f"{'ok' if ok_ else 'FAIL'}")
        if not ok_:
            failures.append(f"{what}: launches, widths or tokens")
        return out_, counts_, dict(widths)

    def frontend_times(eng, batch, out_, what):
        """bf16: what a caller waits for ``_prefill`` (median of 3) and
        per decode step of a ``serve_frontend`` run, the card's busy time
        of each (``torch.profiler``) and K2's share."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        serve_frontend(eng, batch, SERVE_NEW)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) * 1e3
        walls = []
        with torch.inference_mode():
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, caches_ = eng._prefill(batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            pre = float(np.median(walls))
            dec = (run_ms - pre) / (SERVE_NEW - 1)
            b_, n_ = batch["tokens"].shape
            front = (f"{batch['frames'].shape[1]} frames" if "frames" in batch
                     else f"{batch['patch_embeds'].shape[1]} patches")
            finite = bool(torch.isfinite(
                logits[..., :eng.model.cfg.vocab]).all())
            log(f"{what}: prefill {pre:.3f} ms for a caller ({b_} requests "
                f"of {front} and {n_} tokens), {SERVE_NEW} tokens in "
                f"{run_ms:.3f} ms, decode {dec:.3f} ms per token, "
                f"{b_ * SERVE_NEW / run_ms * 1e3:.1f} tokens/s; prefill "
                f"logits finite: {finite} {tag}")
            if not finite:
                failures.append(f"{what}: prefill logits not finite")
            tok_ = torch.from_numpy(out_[:, :1]).to(dev)
            first = caches_[0]
            index_ = (first["self"] if "self" in first else first)[
                "index"].clone()

            def step_():
                eng._decode(rewound(caches_, index_), tok_)

            step_wait_ = ms(step_, 5)
            profile_line(f"{what} prefill", lambda: eng._prefill(batch), 2,
                         pre)
            profile_line(f"{what} decode step", step_, 5, step_wait_)
        return pre, dec

    def frontend_k2(lay, widths_, arch, launches):
        """K2 on ``lay``'s kept plan against its plain version at each of
        ``widths_`` (fp32, bf16, and fp32 with the split forced at
        REC_PIECE_ROWS-row pieces), then timed at the widths the main path
        ran (``launches``: width -> its launches there)."""
        plan_ = lay.plan_for(torch.bfloat16)
        name_ = arch.split("-")[0]
        for d in widths_:
            xw = torch.from_numpy(rng.standard_normal(
                (lay.d_in, d)).astype(np.float32)).to(dev)
            k2_check(f"{name_} w_out d{d} fp32 (kept plan)", plan_, xw)
            k2_check(f"{name_} w_out d{d} bf16 (kept plan)", plan_, xw,
                     torch.bfloat16, BF16_TOL, key=f"{name_} w_out d{d}")
            k2_check(f"{name_} w_out d{d} fp32 pieces{REC_PIECE_ROWS} "
                     f"(kept plan)", plan_, xw, piece_rows=REC_PIECE_ROWS)
        for d, n in sorted(launches.items()):
            entries.append(k2_serving_entry(
                lay, d, n, errs[("rgcsr_spmm", f"{name_} w_out d{d}")],
                arch=arch))

    # (a) seamless-m4t-medium with the RgCSR FFN
    t0 = t14 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"encdec: held from the earlier phases: {live_cuda()}")
    torch.cuda.reset_peak_memory_stats()
    s_cfg = dataclasses.replace(get_config(ENC_ARCH),
                                sparsity=SparsityConfig(**SERVE_SPARSITY))
    n_dec, n_enc = s_cfg.n_layers, s_cfg.n_enc_layers
    s_tree = init_params(s_cfg, torch.Generator(device=dev).manual_seed(SEED))
    s_sc = ServeConfig(max_seq=ENC_MAX_SEQ)
    s32 = dataclasses.replace(s_cfg, dtype="float32",
                              kv_cache_dtype="float32")
    eng32 = Engine(s32, s_sc, params=s_tree, device=dev)
    enc_layers = [b.ffn.w_out for b in eng32.model.encoder]
    dec_layers = [b.ffn.w_out for b in eng32.model.layers]
    n_float = sum(t.numel() for t in eng32.model.tensors().values()
                  if t.is_floating_point())
    log(f"encdec: {s_cfg.name} {n_enc} encoder + {n_dec} decoder layers, "
        f"d_model {s_cfg.d_model}, {s_cfg.n_heads} heads of "
        f"{s_cfg.head_dim}, {s_cfg.activation} gated d_ff {s_cfg.d_ff}, vocab "
        f"{s_cfg.vocab} (padded {s_cfg.padded_vocab}), frontend "
        f"{s_cfg.d_frontend} -> {s_cfg.d_model}: "
        f"{count_params(model_spec(get_config(ENC_ARCH)))} parameters "
        f"counted dense, {eng32.model.n_params()} with w_out in RgCSR "
        f"({n_float} floats; {dec_layers[0].values2d.shape[0]} slot rows of "
        f"{dec_layers[0].values2d.shape[1]} lanes); {eng32.plans_warmed} "
        f"plans warmed (want {n_enc + n_dec}); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if eng32.plans_warmed != n_enc + n_dec:
        failures.append(f"encdec: {eng32.plans_warmed} plans warmed, want "
                        f"{n_enc + n_dec}")
    s_batch = frontend_batch(s_cfg, ENC_BATCH, ENC_PROMPT, SEED + 22,
                             frames=ENC_FRAMES)
    # float32 (the caches too): K2 against every w_out as its dense
    # equivalent, encoder's included; then prefill + decode against one
    # forward over the same tokens and frames
    t1 = time.perf_counter()
    dense_tree = dense_w_out(dense_w_out(s_tree, dec_layers, "layers"),
                             enc_layers, "encoder")
    eng32d = Engine(dataclasses.replace(s32, sparsity=SparsityConfig()),
                    s_sc, params=dense_tree, device=dev)
    frontend_against(eng32, eng32d, s_batch,
                     "encdec seamless fp32, K2 vs dense w_out")
    del eng32d, dense_tree
    long_batch = frontend_batch(s_cfg, ENC_BATCH, ENC_PROMPT + ENC_STEPS,
                                SEED + 23, frames=ENC_FRAMES)
    with torch.inference_mode():
        model = eng32.model
        full = model(long_batch)[0][:, ENC_PROMPT - 1:, :s_cfg.vocab]
        logits, caches = model.prefill(dict(long_batch, tokens=long_batch[
            "tokens"][:, :ENC_PROMPT]), ENC_MAX_SEQ)
        got = [logits[:, -1, :s_cfg.vocab]]
        for i in range(ENC_PROMPT, ENC_PROMPT + ENC_STEPS):
            logits, caches = model.decode_step(
                caches, long_batch["tokens"][:, i:i + 1])
            got.append(logits[:, -1, :s_cfg.vocab])
    got, full = torch.stack(got, 1).float(), full.float()
    err = ((got - full).abs().max() / (1 + full.abs().max())).item()
    ok = bool(torch.isfinite(got).all()) and err <= LOGIT_TOL
    log(f"encdec seamless fp32: a prefill of {ENC_PROMPT} tokens and "
        f"{ENC_STEPS} decode steps against one forward over "
        f"{ENC_PROMPT + ENC_STEPS} ({ENC_FRAMES} frames each): largest "
        f"|step - forward| / (1 + max|logit|) {err:.3e} (tol "
        f"{LOGIT_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("encdec seamless: prefill + decode against a "
                        "forward")
    del eng32, model, caches, logits, got, full, long_batch
    # two encoder and two decoder layers at full width: the card against
    # the port's CPU run on the same weights (one request)
    cfg2 = dataclasses.replace(s32, n_layers=ENC_CPU_LAYERS,
                               n_enc_layers=ENC_CPU_LAYERS)
    tree2 = init_params(cfg2, torch.Generator(device=dev).manual_seed(SEED))
    one = {k: v[:1] for k, v in s_batch.items()}
    outs = []
    for device_ in (dev, torch.device("cpu")):
        model = LanguageModel(cfg2, tree_to(tree2, device_))
        with torch.inference_mode():
            logits, caches = model.prefill(tree_to(one, device_),
                                           ENC_MAX_SEQ)
            step_logits, _ = model.decode_step(
                caches, tree_to(one["tokens"][:, :1], device_))
        outs.append([v[..., :s_cfg.vocab].float().cpu()
                     for v in (logits, step_logits)])
    worst = max((g - w).abs().max().item() / (1 + w.abs().max().item())
                for g, w in zip(*outs))
    ok = worst <= LOGIT_TOL
    log(f"encdec seamless fp32, {ENC_CPU_LAYERS} + {ENC_CPU_LAYERS} layers "
        f"at full width: the card against the port's CPU run on the same "
        f"weights, prefill ({ENC_FRAMES} frames, {ENC_PROMPT} tokens) and "
        f"one decode step: largest |card - cpu| / (1 + max|logit|) "
        f"{worst:.3e} (tol {LOGIT_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("encdec seamless: the card against the CPU")
    del tree2, model, outs, caches, logits, step_logits
    gc.collect()
    torch.cuda.empty_cache()
    log(f"encdec seamless fp32 checks in {time.perf_counter() - t1:.1f} s")

    # the main path, bfloat16: K2 in every encoder and decoder layer
    engine = Engine(s_cfg, s_sc, params=s_tree, device=dev)
    enc_layers = [b.ffn.w_out for b in engine.model.encoder]
    dec_layers = [b.ffn.w_out for b in engine.model.layers]
    want_counts = {"rgcsr_spmv": 0,
                   "rgcsr_spmm": n_enc + n_dec * SERVE_NEW, "ell_spmv": 0}
    want_widths = {ENC_BATCH * ENC_FRAMES: n_enc,
                   ENC_BATCH * ENC_PROMPT: n_dec,
                   ENC_BATCH: n_dec * (SERVE_NEW - 1)}
    out, s_counts, s_widths = frontend_main_path(
        engine, s_batch, enc_layers + dec_layers, want_counts, want_widths,
        "encdec seamless bf16")
    frontend_times(engine, s_batch, out, "encdec seamless bf16")
    log(f"encdec seamless bf16: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated with the compute-dtype copies, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB so far {tag}")
    frontend_k2(dec_layers[0], (1, ENC_BATCH, ENC_BATCH * ENC_PROMPT,
                                ENC_BATCH * ENC_FRAMES), ENC_ARCH,
                s_widths)
    torch.cuda.synchronize()
    log(f"encdec seamless serving peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
    del engine, s_tree, enc_layers, dec_layers, s_batch
    gc.collect()
    torch.cuda.empty_cache()
    # three AdamW steps through the launcher (frames and tokens), bf16
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tr, state = launch_train.main([
        "--arch", ENC_ARCH, "--sparse-ffn", "--steps", str(ENC_TRAIN_STEPS),
        "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--device",
        str(dev)])
    torch.cuda.synchronize()
    hist = tr.history
    ok = (len(hist) == ENC_TRAIN_STEPS and tr.model.device.type == "cuda"
          and tr.model.encoder is not None
          and all(np.isfinite([h[k] for h in hist for k in ("ce", "loss",
                                                             "grad_norm")])))
    for h in hist:
        log(f"encdec seamless train step {h['step']}: loss {h['loss']:.4f}, "
            f"grad_norm {h['grad_norm']:.4f}, {h['step_time_s'] * 1e3:.1f} "
            f"ms host (ending in a synchronize) {tag}")
    log(f"encdec seamless train: {ENC_TRAIN_STEPS} AdamW steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} frames and tokens, --sparse-ffn, bf16 "
        f"compute, fp32 parameters: all finite {ok}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t1:.1f} s {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        failures.append("encdec seamless train: losses not finite")
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"encdec seamless in {time.perf_counter() - t0:.1f} s")

    # (b) pixtral-12b with the RgCSR FFN.  Its memory plan, reckoned from
    # the spec before anything is allocated: float32 parameters, int32
    # columns, the bf16 copies the bf16 engine casts, and the fp32 check's
    # dense-equivalent w_out; the fp32 check runs first, before any cast
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p_cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS,
                                sparsity=SparsityConfig(**SERVE_SPARSITY))
    n_p = p_cfg.n_layers
    leaves = list(spec_leaves(model_spec(p_cfg)))
    floats = sum(int(np.prod(p.shape)) for p in leaves if p.dtype is None)
    ints = sum(int(np.prod(p.shape)) for p in leaves if p.dtype is not None)
    dense_eq = n_p * p_cfg.d_ff * p_cfg.d_model * 4
    held = torch.cuda.memory_allocated()
    fp32_need = held + floats * 4 + ints * 4 + dense_eq + VLM_ACT_BYTES
    bf16_need = held + floats * 4 + ints * 4 + floats * 2 + VLM_ACT_BYTES
    cut = fp32_need > VLM_PEAK_GIB * 2**30
    log(f"encdec pixtral memory plan: {held / 2**30:.2f} GiB held from the "
        f"earlier phases; {floats} float parameters ({floats * 4 / 2**30:.2f} "
        f"GiB in fp32), {ints} int32 structure entries "
        f"({ints * 4 / 2**30:.2f} GiB), bf16 copies up to "
        f"{floats * 2 / 2**30:.2f} GiB, the fp32 check's dense-equivalent "
        f"w_out {dense_eq / 2**30:.2f} GiB, {VLM_ACT_BYTES / 2**30:.1f} GiB "
        f"for activations: fp32 check {fp32_need / 2**30:.2f} GiB, bf16 "
        f"serving {bf16_need / 2**30:.2f} GiB (limit {VLM_PEAK_GIB} GiB): "
        f"the fp32 check at "
        f"{f'{VLM_CUT_LAYERS} layers (cut)' if cut else 'full depth'}")
    p_tree = init_params(p_cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"encdec: {p_cfg.name} {n_p} layers, d_model {p_cfg.d_model}, "
        f"{p_cfg.n_heads}/{p_cfg.n_kv_heads} heads of {p_cfg.head_dim}, "
        f"{p_cfg.activation} gated d_ff {p_cfg.d_ff}, vocab {p_cfg.vocab}, "
        f"frontend_proj {p_cfg.d_frontend} -> {p_cfg.d_model} over "
        f"{p_cfg.frontend_tokens} patches: "
        f"{count_params(model_spec(get_config(VLM_ARCH)))} parameters "
        f"counted dense, {floats + ints} with w_out in RgCSR; init in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    p_batch = frontend_batch(p_cfg, VLM_BATCH, VLM_PROMPT, SEED + 24)
    p_sc = ServeConfig(max_seq=p_cfg.frontend_tokens + VLM_PROMPT
                       + SERVE_NEW)
    # float32 (the caches too): K2 against the dense-equivalent w_out
    t1 = time.perf_counter()
    p32 = dataclasses.replace(p_cfg, dtype="float32", kv_cache_dtype="float32")
    c_tree = p_tree
    if cut:
        p32 = dataclasses.replace(p32, n_layers=VLM_CUT_LAYERS)
        c_tree = dict(p_tree, layers=p_tree["layers"][:VLM_CUT_LAYERS])
    eng32 = Engine(p32, p_sc, params=c_tree, device=dev)
    eng32d = Engine(dataclasses.replace(p32, sparsity=SparsityConfig()),
                    p_sc, params=dense_w_out(c_tree, [
                        b.ffn.w_out for b in eng32.model.layers], "layers"),
                    device=dev)
    torch.cuda.synchronize()
    log(f"encdec pixtral fp32: {p32.n_layers} layers, with the "
        f"dense-equivalent w_out {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated")
    frontend_against(eng32, eng32d, p_batch,
                     f"encdec pixtral fp32 ({p32.n_layers} layers), K2 vs "
                     f"dense w_out")
    del eng32, eng32d, c_tree
    gc.collect()
    torch.cuda.empty_cache()
    log(f"encdec pixtral fp32 check in {time.perf_counter() - t1:.1f} s; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
    # the main path, bfloat16, full depth
    engine = Engine(p_cfg, p_sc, params=p_tree, device=dev)
    p_layers = [b.ffn.w_out for b in engine.model.layers]
    if engine.plans_warmed != n_p:
        failures.append(f"encdec pixtral: {engine.plans_warmed} plans "
                        f"warmed, want {n_p}")
    n_seq = p_cfg.frontend_tokens + VLM_PROMPT
    want_counts = {"rgcsr_spmv": 0, "rgcsr_spmm": n_p * SERVE_NEW,
                   "ell_spmv": 0}
    want_widths = {VLM_BATCH * n_seq: n_p,
                   VLM_BATCH: n_p * (SERVE_NEW - 1)}
    out, p_counts, p_widths = frontend_main_path(
        engine, p_batch, p_layers, want_counts, want_widths,
        "encdec pixtral bf16")
    frontend_times(engine, p_batch, out, "encdec pixtral bf16")
    log(f"encdec pixtral bf16: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated with the compute-dtype copies, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
    # K2 on layer 0 alone, the rest of the model freed first: the split
    # forced at 8-row pieces at d = 2,176 writes 17,920 partial tiles
    # (18.6 GiB of fp32 workspace)
    lay = p_layers[0]
    del engine, p_tree, p_layers, p_batch
    gc.collect()
    torch.cuda.empty_cache()
    frontend_k2(lay, (1, VLM_BATCH, VLM_BATCH * n_seq), VLM_ARCH, p_widths)
    torch.cuda.synchronize()
    log(f"encdec pixtral K2 checks and times: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}; "
        f"pixtral in {time.perf_counter() - t0:.1f} s")
    del lay
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14 in {time.perf_counter() - t14:.1f} s")

    phase("15 shard")
    # ---- 15. row-sharded SpMV/SpMM
    sharded_phase(dev, mats, x, xm, entries, failures, tag)

    # ---- 16. sharded training
    gc.collect()
    torch.cuda.empty_cache()
    phase("16 train16")
    train16 = sharded_train_phase(dev, failures, tag)

    # ---- 16 (h). the recurrent mixers tensor-parallel, a spawn of its own
    gc.collect()
    torch.cuda.empty_cache()
    phase("16 (h) recurrent mixers tensor-parallel")
    serve20_ref, serve20 = recurrent_tp_phase(dev, failures, tag, dry_procs,
                                              dry_tmp)

    phase("17 remat")
    # ---- 17. remat none / full / dots
    gc.collect()
    torch.cuda.empty_cache()
    remat_phase(dev, failures, tag)

    phase("18 twins")
    # ---- 18. the example twins
    gc.collect()
    torch.cuda.empty_cache()
    twins_phase(dev, failures, tag)

    phase("19 dryrun")
    # ---- 19. the dry run against phases 10 and 16
    dryrun_phase(dry_procs, dry_tmp, train16, train10, failures, tag,
                 serve20)

    phase("20 serve on a mesh")
    # ---- 20. serving on a mesh: the ranks ran in 16 (h)'s spawn
    serve20_phase(dev, failures, tag, serve20_ref, serve20, _serve20_runs(),
                  entries)

    phase()
    for kernel in KERNEL_META:
        if counts[kernel] <= 0:
            failures.append(f"{kernel} was not launched on the main path")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL: {f}", file=sys.stderr)
        return 1
    log(f"all phases in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BaseException as err:
        if not isinstance(err, SystemExit):
            traceback.print_exc()
            where = f"chip_smoke: stopped {stopped()}"
            log(where)
            print(where, file=sys.stderr, flush=True)
            sys.exit(1)
        raise
    finally:
        _stop_background()
