#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

Phases, each printed as it runs:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for float32 matmuls and convolutions;
2. build — the CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   with nvcc, and the Triton kernels compile at their first launch; the
   fp8 GEMM's and the flash kernel's registers and spills are logged (no
   spill allowed) and their SASS must hold warpgroup MMAs (``cuobjdump``):
   on e4m3 operands for the fp8 GEMM, on bf16 ones (HGMMA) for flash; every
   instantiation of the decode kernel (paged and dense libraries) is named
   from ptxas's report and none may spill, and the widths of the serving
   instantiations' loads are counted in the SASS (qwen3-1.7b's GQA group
   of 2 over every pool, llama3-8b's group of 4 over its bf16 and fp8
   pools, qwen2-moe-a2.7b's group of 1 over its bf16, fp8 and f32 pools
   and its bf16 cache, gemma3-12b's group of 2 at head dim 256 over its
   bf16 and fp8 pools and its bf16 and f32 caches, whisper-base's group
   of 1 at head dim 64 over its bf16 and f32 caches, phi-3-vision-4.2b's
   group of 1 at head dim 96 over its bf16 and f32 caches, minicpm-2b's
   group of 1 at head dim 64 over its bf16, fp8, int8 and f32 pools,
   grok-1-314b's group of 6 (the MG = 8 instantiations, rows 6-7 of each
   group empty) over its bf16, fp8, int8 and f32 pools and its bf16 and
   f32 caches); the flash library must hold a tensor-core instantiation
   for every head dim its route takes, d 96 among them;
3. kernels — every kernel of the serving paths against its plain PyTorch
   version at the serving shapes of qwen3-1.7b (H=16, KVH=8, d=128;
   paged decode: page 16, 8 seats with lengths from 1 to 2048; dense
   decode: 8 slots of 545 keys, lengths 1 to 545, split over the sequence;
   flash prefill: one causal prompt of 511 tokens; RMSNorm at D=2048 and
   D=128; the fused add + RMSNorm at M=8, D=2048, whose sum must be
   bit-equal to torch's add; the q/k norm in one launch at 128 + 64 rows
   of D=128), with its time, the plain version's time, one PyTorch
   library call's time as a yardstick (``F.scaled_dot_product_attention``
   pinned to one backend, ``F.rms_norm``; none for the fused norms), and
   the least time the card could take (times are torch.profiler's spans;
   where it loses most of them, CUDA events behind a spin kernel, which
   the bf16 paged decode kernel is also timed by in every run); untimed,
   the norms at the k-norm and prefill-chunk shapes, flash prefill at 64
   and 37 tokens, and paged (every pool type) and dense (bf16 and f32)
   decode at the edges of their split-K plans (lengths chunk - 1, chunk,
   chunk + 1, seats whose later splits are all empty, the full width; the
   tickets must be back at zero after the launches); then the same checks
   off those shapes (f32 queries, pools and caches, GQA groups 1, 4 and 6
   (48 heads over 8 of 128: paged over bf16, fp8 and f32 pools, dense in
   bf16 and f32, flash causal on both routes), head dims 16 to 256, odd
   cache lengths, sliding-window and non-causal flash on both routes,
   f32 RMSNorm; at d 96 dense decode over lengths
   1, 9, 64 and 200 and tensor-core flash causal at 77 and non-causal at
   96 x 200);
4. serve — ``serve_paged`` at the full width of qwen3-1.7b (28 layers,
   d_model 2048, vocab 151936, bf16 compute, weights from a seeded
   torch.Generator), 16 requests with prompts of 64-511 tokens and 32
   new tokens each, served with a bf16, an fp8 and an int8 KV pool;
   checks for each run that every request finished, every token is in
   the vocabulary, no logit was NaN, and that the kernels carried the
   path (launch counts, set to 0 before the run and read after it; the
   engine replays the fused tick and the prefill chunk as CUDA graphs
   captured at construction, and each replay adds the launches its
   capture recorded); the same requests through the ``fused=False``
   engine (eager, host-side sampling), whose greedy streams and trace
   must equal the graphed run's; each graph replayed against the
   function it captured, run eagerly on the same inputs and a copy of
   the pool, bit for bit (tokens, logits, pool bytes, the advanced
   state); the split tickets back at 0; then one fused tick on the same
   state with the kernels and with the plain versions, whose logits must
   agree, and the steady tick's wall time, device busy time, kernels and
   top kernels (torch.profiler; bf16 and fp8 pools), run eagerly and as
   a graph replay;
5. serve-fixed — the fixed-slot path at the same width: ``serve`` (the
   static batch behind ``--engine batch``: 4 prompts of 128 tokens, 16
   new tokens each), then a ``ServingEngine`` (8 slots, max_len 544) over
   the same 16 requests as the paged runs, with the same checks and the
   launch counts of the dense decode and flash kernels (the decode step
   a graph replay, the whole-prompt prefill eager); one decode step
   with the kernels and with the plain versions, whose logits must agree;
   the captured decode step against the eager one, bit for bit (logits,
   cache); the split tickets back at 0; the steady decode step's wall
   time, device busy time and idle share, eager and as a graph replay;
   and, as information, how many greedy tokens the fixed-slot and bf16
   paged engines share;
6. telemetry — the serving telemetry plane on the graphed paged engine
   at the same width, over the same 16 requests and weights, with a bf16
   and an fp8 pool: the engine with ``telemetry=None``,
   ``Telemetry(ring=4096)`` and ``Telemetry(profile=True)`` gives the
   streams and flat trace of phase 4's run and its launch counts; in a
   steady window (every request seated and decoding) the three give the
   same kernels and copies per tick under torch.profiler (a window now
   and then counts a few kernels more or fewer than another run of the
   same ticks, so a mode that never counted what most runs did is run
   again, up to three runs, logging the kernels that differ; one value
   must be counted by a run of every mode) and the same
   synchronizing calls per tick under
   ``torch.cuda.set_sync_debug_mode("warn")``, and only the profiled one
   has ``fused_decode_tick`` ranges; the recorder's events project onto
   the flat trace and its Perfetto export validates; a ``MetricsServer``
   on port 0 serves the engine's metric families; a forced stall writes a
   postmortem naming every stalled rid with a consistent page partition;
   then five interleaved runs of each mode on fresh engines give the
   on/off tokens/s ratio and the tick profiler's phase table
   (information);
7. fleet — the multi-model fleet router (``runtime.router.ModelFleet``)
   at full width: qwen3-1.7b x2 and llama3-8b x1 (32 layers, d_model
   4096, GQA group 4, untied 128256-row head), weights from generators
   seeded 0 and 1 on the card, each cast for compute before the next is
   drawn and shared by its replicas; 8 seats, page 16, prefill chunk 128,
   max_seq_len 544.  Run A: bf16 pools, least-loaded selection, a budget
   of 840 pages (no engine can preempt), 24 requests of 64-511 prompt
   tokens and 32 new tokens at temperature 0.9 alternating between the
   models: every request finished in its model's vocabulary, logits
   finite, no preemption, the launch counts equal to the sum over
   engines of layers x graph replays, each rid's stream bit-equal to a
   solo graphed engine's fed the same (rid, prompt, budget), both
   qwen3-1.7b replicas on one tree's storage, the llama3-8b replica's
   graphs bit-equal to eager, the split tickets back at 0; K1 and K2 at
   llama3-8b's shapes (GQA group 4, the tick's 8 seats of 41-543 tokens)
   over bf16 and fp8 pools against their plain versions; llama3-8b's bf16
   tick with the kernels no further from the f32 tick of the same weights
   and pool than 1.5x the plain versions' bf16 tick (per seat and at the
   largest logit; a planted fault, the last page dropped, must fail
   both);
   llama3-8b's kernels against the plain versions in f32 (its weights
   widened), 8 of its prompts teacher-forced as in phase f32.  Run B:
   qwen3-1.7b bf16 and llama3-8b fp8 under a budget of the two floors and
   40 pages, SLO-aware selection and SLO admission, a third of the
   requests premium: every request finished, live bytes within the
   budget after every fleet tick, some engine borrowing, K2 launched.
   Run A again under ``Telemetry(ring=4096)``: the same streams, a
   ``fleet_tick`` event per engine at every heartbeat stride, a valid
   Perfetto export; a forced stall's message and postmortem (every
   engine, the budget block);
   then, as information, a steady fleet step (all 24 seats decoding)
   under torch.profiler, the llama3-8b tick's device busy time against
   its byte bound, and ``python -m repro_torch.launch.serve --fleet``
   with its defaults (reduced configs);
8. moe — qwen2-moe-a2.7b at full width (24 layers, d_model 2048, 16/16
   heads of 128, 60 routed experts top-4 of d_ff 1408 and 4 shared of
   5632 behind a sigmoid gate, untied 151936-row head), drawn on the
   card from a generator seeded 0 with each matmul leaf cast to bf16 as
   it is drawn (the f32 tree never exists; tree size and drawing peak
   logged).  Run A: the paged engine (8 seats, page 16, 560 pages, chunk
   128, bf16 pool) over 24 requests of 64-511 prompt tokens and 32 new
   tokens at temperature 0.9, 12 submitted at once and then one every 4
   engine steps, so that some ticks have idle seats below decoding ones:
   every request finished in the vocabulary, logits finite, no
   preemption, launch counts equal to layers x graph replays, such ticks
   seen; the tick and a prefill chunk replayed against the functions
   run eagerly, bit for bit; the split tickets back at 0; the same
   requests and arrivals through the ``fused=False`` engine, whose
   streams and trace must equal Run A's, with the capacity path's
   dropped (token, expert) pairs logged per prefill chunk and per tick;
   K1 and K2 at this model's shapes (GQA group 1, d 128, the tick's 8
   seats of 41-543 tokens) over bf16 and fp8 pools against their plain
   versions; the steady graphed tick (wall, busy, kernels, idle share,
   GEMM and sort time) against its byte bound, and the expert products'
   share of it (CUDA events); in 5 steady engine ticks one synchronizing
   call each, the token pull; on the model's first 2 layers widened to
   f32 (widths unchanged), the bf16 tick with the kernels no further
   from the f32 tick than 1.5x the plain versions', every bf16 tick
   routed to the experts the f32 tick chose (a planted fault, the last
   page dropped, must fail both the per-seat and the largest-difference
   limit), then on its first 12 layers the kernels against the plain
   versions in f32,
   teacher-forced as in phase f32, with the router's top-k flips between
   the two counted (information).  Run B: the same requests on an fp8
   pool, greedy: every request finished, K2 carried it.  The fixed-slot
   ``ServingEngine`` over 8 of the prompts (K5 prefill, K4 decode at GQA
   group 1), launch counts exact, its decode graph against eager, and K4
   and K5 at its shapes (bf16, 16 heads over 16, d 128; K4 over 8 slots
   of 545 keys at the lengths its slots reach and an idle slot walking
   the whole cache, K5 causal at the longest and 3 of its prompt
   lengths) against their plain versions, tickets back at 0; then
   ``python -m
   repro_torch.launch.serve --arch qwen2-moe-a2.7b`` on the paged and
   the static-batch engines with their defaults (reduced config);
9. gemma — gemma3-12b at full width (48 layers, 40 of them in a sliding
   window of 1024 and every sixth global, d_model 3840, 16/8 heads of
   256, d_ff 15360, tied 262144-row embedding), drawn cast on the card
   from a generator seeded 0.  Run A: the paged engine (8 seats, page 16,
   760 pages, chunk 128, bf16 pool) over 16 requests of 980-1400 prompt
   tokens and 48 new at temperature 0.9, every one passing position 1024
   (12 in a prefill chunk, 4 in decode ticks): all finished in the
   vocabulary, logits finite, no preemption, launch counts exact (K1 on
   the 8 global layers and windowed K1 on the 40 local ones, per graph
   replay), the tick and a prefill chunk across the window replayed
   against eager bit for bit, the ``fused=False`` engine's streams and
   trace equal, tickets back at 0; K1 and K2 at this model's shapes
   (group 2, d 256, seats of 1-1448 tokens) over bf16 and fp8 pools,
   windowed and not, against their plain versions, timed beside SDPA
   with the same mask; the steady graphed tick against its byte bound;
   on the first 6 layers (one period) the bf16 tick held to the f32
   tick as in phase fleet, the planted fault failing both limits.  Run
   B: the same requests on an fp8 pool, greedy, carried by windowed K2.
   The fixed-slot ``ServingEngine`` over 8 of the prompts (K5 windowed
   and causal, K4 windowed and global), launch counts exact, its decode
   graph against eager, K4 and K5 at its shapes against plain, timed;
   K3 and the fused add + norm at D = 3840 (the row's block 4096 wide,
   its tail masked) against plain at every row count of the phase.  The
   ring-buffer local cache at full width in f32 (``prefill`` of an
   1100-token prompt, 32 ``decode_step``s with ``ring_local_cache`` off,
   greedy, and on, fed the same tokens): every K4 call (full cache,
   global and windowed; the 1024-row ring) and every K5 call (f32 CUDA
   cores at d 256, causal and windowed) held to its plain version, the
   ring's logits held to the full cache's at every decided step (the
   largest |Δlogit| per step logged) and its top-1 equal up to the
   first top-2 gap <= 1e-3, launches exact, the local layers' cache
   bytes logged; ``serve --arch gemma3-12b`` on both engines (reduced);
10. ssm — mamba2-130m at full width (24 Mamba-2 layers, no attention and
   no MLP, d_model 768, d_inner 1536 in 24 heads of 64, d_state 128,
   conv width 4, chunk 256, tied 50280-row embedding), drawn cast on the
   card from a generator seeded 0, on the fixed-slot ``ServingEngine``
   (the reference serves SSM archs there only).  Run A: 8 slots, max_len
   4160, 24 requests of 100-4000 prompt tokens (below, at and past a
   chunk, multiples of it and not) and 64 new, every second at
   temperature 0.9: all finished in the vocabulary, logits finite,
   launch counts exact (per decode step and per prefill one K3 at D =
   768, 24 fused add + norms at 768 and 24 gated norms at D = 1536: no
   other kernel), the captured decode step against eager bit for bit
   (logits, conv and SSM states); K3 and the fused add + norm at D = 768
   and 1536 against plain (bf16 at 8 rows and the longest prompt, f32 at
   8 and 4000 rows; ``s`` bit-equal), timed; the bf16 decode step with
   the kernels no further from the f32 step of the same weights and
   states than 1.5x the plain versions' on the first 6 layers (a planted
   fault, the gated norm's rows one slot down, must fail both limits);
   in f32 at full width prefill(S) against prefill(S - 1) + one
   ``decode_step`` at S = 255, 256, 1000, 4000 within 1e-3 of the
   largest logit; the O(1) state: an engine at max_len 32833 holds the
   same 146 MiB as Run A's (the config's arithmetic) and serves a prompt
   of 32768 tokens (TTFT, peak memory), its steady decode step profiled
   beside Run A's; ``serve()`` at full width and ``serve --arch
   mamba2-130m`` (reduced), and ``--engine paged`` exiting with the
   paged engine's refusal;
11. whisper — whisper-base at full width (6 encoder and 6 decoder
   layers, d_model 512, 8/8 heads of 64, d_ff 2048, untied 51865-row
   head, 1500 encoder frames of 80 from the frontend stub), drawn cast
   on the card from a generator seeded 0, on the fixed-slot
   ``ServingEngine`` (the reference serves encoder-decoder archs there
   only).  Run A: 8 slots, max_len 448 (whisper's text context), 24
   requests of 8-384 prompt tokens and 32-64 new, every second at
   temperature 0.9, each prefill on the reference's stub frames (zeros):
   all finished in the vocabulary, logits finite, launch counts exact
   (per prefill K5 non-causal on the 6 encoder layers at 1500 x 1500
   and the 6 cross layers at P x 1500, K5 causal on the 6 decoder
   layers, and both stacks' norms; per decode step 12 K4, self and
   cross, and the decoder's norms); every slot's ``ck``/``cv`` then
   filled with random values, the captured decode step against eager
   bit for bit and ``ck``/``cv`` unchanged by it; the steady step
   profiled.  The zero frames zero every cross output, so the kernels
   are held to their plain versions on frames and prompts from a numpy
   seed: in bf16 each K4/K5 call of a ``prefill`` of 383 tokens and a
   ``decode_step`` on its own inputs (scaled by powers of two, the
   scores near one-hot at random weights); in f32
   prefill(S) against prefill(S - 1) + one ``decode_step`` at S - 1 =
   1, 64, 383 within 1e-3 of the largest logit, where a planted fault
   (each slot's cross K/V handed to the next slot) must fail; K5
   non-causal over the 1500 frames and 384 x 1500 and K4 over 8 slots
   of 1500 cross rows against plain, timed beside SDPA; ``serve()`` at
   full width and ``serve --arch whisper-base`` (reduced), and
   ``--engine paged`` exiting with the paged engine's refusal;
12. vision — phi-3-vision-4.2b at full width and depth (32 layers,
   d_model 3072, 32/32 heads of 96, d_ff 8192, untied 32064-row head,
   256 patch embeddings of 1024 from the frontend stub through
   ``frontend_proj``), drawn cast on the card from a generator seeded 0,
   on the fixed-slot ``ServingEngine`` (the reference serves frontend
   archs there only).  Run A: 8 slots, max_len 1056, 16 greedy requests
   of 256-1024 prompt tokens and 32 new, each prefill on the reference's
   stub patches (zeros): all finished in the vocabulary, logits finite,
   launch counts exact (per prefill K5 causal on the 32 layers, on its
   tensor-core route at d 96; per decode step 32 K4 at d 96; the
   norms); the K5 calls of its longest and shortest prefill and the K4
   calls of a decode step on its cache held to plain (inputs scaled by
   powers of two); graph == eager; tokens/s, mean TTFT and the steady
   graphed step (wall, busy, kernels).  On patches drawn from a numpy
   seed: the embedding's patch rows bit-equal to the projection; in bf16
   every K4/K5 call of a prefill of 700 tokens and a decode step held to
   plain; in f32 8 prompts with their patches teacher-forced through
   prefill and 31 decode steps, the kernels against the plain versions
   on decided positions; with wq/wk at their true fan-in, the bf16
   kernels no further from the f32 run than 1.5x the plain versions.
   K5 causal at 1024 (beside its old CUDA-core route) and K4 over 8 x
   1056 keys timed beside SDPA; K3 and ``add_rmsnorm`` at D = 3072 against
   plain and timed; ``serve()`` at full width and ``serve --arch
   phi-3-vision-4.2b`` (reduced), and ``--engine paged`` exiting with the
   paged engine's refusal;
13. hybrid — jamba-v0.1-52b at full width, cut in depth only to 16 of
   its 32 layers (two whole periods of 4 Mamba-2 layers, 1 attention
   layer and 3 Mamba-2 layers; d_model 4096, 32/8 heads of 128, SSM
   d_inner 8192 in 128 heads of 64 with d_state 16, an MLP on every
   layer: dense SwiGLU of 14336 on even positions, 16 experts top-2 of
   14336 with no shared expert on odd ones; untied 65536-row head;
   25.998 B parameters, 48.43 GiB), drawn cast on the card from a
   generator seeded 0, on the fixed-slot ``ServingEngine`` (the
   reference serves hybrid archs there only; the paged engine refuses
   it on the card as it does in the reference).  Run
   A: 8 slots, max_len 1056, 16 requests of 255-1024 prompt tokens and
   32 new, every second at temperature 0.9: all finished in the
   vocabulary, logits finite, launch counts exact (per prefill K5 causal
   on the 2 attention layers; per decode step K4 on them at group 4;
   per step one K3 at D = 4096, 32 fused add + norms at 4096 and 14
   gated norms at D = 8192), the capacity path's dropped (token, expert)
   pairs per prefill and over the decode steps (an add captured into the
   graph), tokens/s and TTFT; the first prefill's K5 and norm calls and
   one decode step's K4 and norm calls held to plain on their own
   inputs (K4/K5 scaled by powers of two); the captured decode step
   against eager bit for bit (logits, K/V and SSM states); the steady
   step on a fresh engine (wall, busy, kernels, idle share, busy time by
   kernel group) against its byte bound; K5 causal at 1024 and K4 over
   8 x 1057 keys at group 4, K3 at D = 4096 and 8192 and the fused add +
   norm at 4096 against plain, timed beside SDPA / ``F.rms_norm``; the
   bf16 tree freed, one period (8 layers, 13.268 B parameters) drawn in
   f32 and 8 prompts teacher-forced with the kernels against the plain
   versions on decided positions; ``serve --arch jamba-v0.1-52b``
   (reduced) and ``--engine paged`` exiting with the paged engine's
   refusal (``serve()`` at full width would build all 32 layers);
14. minicpm — minicpm-2b at full width and depth (40 layers, d_model
   2304, 36/36 heads of 64, d_ff 5760, a tied 122753-row embedding: an
   odd vocabulary; 2.725 B parameters), drawn cast on the card from a
   generator seeded 0.  Run A on the paged engine (ENGINE_KW) over the
   request stream phase 4's ``serve_paged`` draws at seed 0 for this
   vocabulary (16 prompts of 64-511 tokens, 32 new, every second at
   temperature 0.9), once each over a bf16, an fp8 and an int8 pool:
   all finished in the vocabulary, logits finite, launch counts exact
   (K1/K2 on their head-dim-64 instantiations once per layer per tick,
   the norms per model step); the ``fused=False`` engine's greedy
   streams and trace equal, the K1/K2 and norm calls of its 21st tick
   held to plain on their own inputs (K1/K2 scaled by powers of two);
   each graph replayed against eager bit for bit; tickets back at 0.
   The same requests on the fixed-slot ``ServingEngine`` (8 slots,
   max_len 544): launch counts exact (K4 once per layer per step, K5
   once per layer per prompt), the first prefill's K5 and norm calls
   and a decode step's K4 and norm calls held to plain (scaled), graph
   == eager, the steady step profiled, the greedy tokens shared with
   the bf16 paged run logged.  The steady graphed tick on the bf16 and
   fp8 pools (wall, busy, kernels, idle share, the top kernels and those
   named as the tied LM head's GEMM at N = 122753, timed alone) against
   its byte bound; K1 and K2 (fp8, int8) at phase 3's seat lengths, K5
   causal at 511 and K4 over 8 x 545 keys (36 heads of 64) against plain
   and timed beside SDPA; K3 and the fused add + norm at D = 2304 against
   plain and timed; the first 4 layers drawn in f32, 8 prompts
   teacher-forced through chunked prefill and fused ticks over an f32
   pool with the kernels and the plain versions, and the paged engine
   against ``ServingEngine`` on them (phase f32's methods);
15. grok — grok-1-314b at full width, cut in depth only to 4 of its 64
   layers (d_model 6144, 48/8 heads of 128: a GQA group of 6, 8 experts
   top-2 of d_ff 32768 on every layer with no shared expert at capacity
   factor 1.25, untied 131072-row head; 21.29 B parameters, 39.66 GiB),
   drawn cast on the card from a generator seeded 0.  Run A on the paged
   engine (ENGINE_KW) over phase 14's request stream drawn for this
   vocabulary, once each over a bf16, an fp8 and an int8 pool: all
   finished in the vocabulary, logits finite, launch counts exact (K1/K2
   on their MG = 8 instantiations 4 a tick, the norms per model step),
   each graph replayed against eager bit for bit, tickets back at 0; on
   the bf16 and fp8 pools the ``fused=False`` engine's greedy streams and
   trace equal, the capacity path's dropped (token, expert) pairs logged
   per chunk and per tick, and its 21st tick's K1/K2 and norm calls held
   to plain (scaled); on the int8 pool one fused tick's K2 and norm calls
   held to plain.  The first 8 requests on the fixed-slot
   ``ServingEngine`` (8 slots, max_len 544): K4 4 a step and K5 4 a
   prompt exactly, the first prefill's and a decode step's K4/K5 and norm
   calls held to plain, graph == eager, the steady step profiled against
   its byte bound.  The steady graphed tick on the bf16 and fp8 pools
   (wall, busy, kernels, idle share, busy time by kernel group, the
   expert products alone) against its byte bound; the first layer
   widened to f32: the bf16 tick with the kernels no further from the f32
   tick than 1.5x the plain versions' (routed as the f32 tick; the
   planted dropped page failing both limits), then 8 prompts
   teacher-forced with the kernels and the plain versions in f32 (router
   top-2 flips logged).  K1 and K2 (fp8, int8) at phase 3's seat lengths,
   K5 causal at 511 and K4 over 8 x 545 keys at 48 heads over 8 against
   plain, timed beside SDPA with K/V repeated; K3 and the fused add +
   norm at D = 6144 against plain, timed; ``serve --arch grok-1-314b`` on
   both engines (reduced; ``serve()`` at full width would build all 64
   layers);
16. f32 — qwen3-1.7b computing in f32 (f32 weights, pool and cache;
   flash prefill on its CUDA-core route): 8 greedy streams teacher-forced
   through the fused tick and through ``prefill`` + ``decode_step``, each
   with the kernels and with the plain versions, whose top-1 must agree
   at every decided position (the plain top-2 gap above twice the largest
   logit difference there) with at least 90% of the positions decided;
   then the paged engine and ``ServingEngine`` on the same 8 requests,
   whose streams must be equal up to their first top-2 gap <= 1e-3;
17. train — the training path, which runs the plain PyTorch versions on
   purpose (no kernel has a backward, in the port or in the reference):
   ``train()`` on qwen3-1.7b at its published width (f32 master weights
   and AdamW state, bf16 compute, remat, batch 8 x seq 1024 from the
   token pipeline, 30 steps), whose losses must be finite and fall by
   the reference's criterion (mean of the last 5 below the mean of the
   first 5 by 0.05) with every kernel launch counter at 0, reporting
   wall time and peak memory; then steady steps through the train cell
   (step time by CUDA events, tokens/s), one of them profiled (device
   busy time, idle share, kernel groups) and its parts timed (forward,
   forward + backward, AdamW); mamba2-130m, whisper-base and
   phi-3-vision-4.2b at full width, and qwen2-moe-a2.7b at full width
   cut to 4 of its 24 layers (10 steps on one batch of 8 x 1024, its
   ``wq``/``wk`` and MoE blocks at their true fan-in; each step's loss,
   xent, aux loss and grad norm, the dropped (token, expert) pairs of
   each MoE layer at the first and last step, AdamW's time), each with
   falling losses, 0 launches, a profiled steady step and the peak
   memory; qwen3-1.7b's step time and peak memory under
   ``remat_policy="nothing"`` and ``"dots"`` (losses bit-equal); three
   train steps of each reduced f32 config of
   ``TRAIN_VS_CPU`` (the three MoE configs at capacity factor 0.5, so
   that pairs drop) on the card and on the CPU from the same params and
   batches, held to the CPU parity tests' tolerances; a checkpoint
   restart on the
   card (an injected failure at step 6 after the step-4 checkpoint, the
   resumed losses and final params, mu, nu and count against an
   uninterrupted run, and a ``save_async`` whose restored tensors equal
   the saved ones bit for bit);
18. dist — the train step over a mesh at world size 1 (one card: NCCL
   refuses two ranks on one GPU): a NCCL process group on a
   ``FileStore`` of the phase's own, the (1, 1, 1) pod × data × model
   mesh, qwen3-1.7b at full width with phase train's batch (8 × 1024)
   and ``train()``'s options: 3 ``"auto"`` steps of
   ``build_cell(mesh=)`` bit-equal to 3 meshless steps from the same
   state (losses, grad norms, every param leaf); 3 ``"compressed"``
   steps, each step's synced leaves bit-equal to the plain int8
   quantize-dequantize of ``g + ef`` and the new ``ef`` to ``g + ef -
   deq``; at full width cut to 2 layers, a checkpoint saved from the
   mesh run after 2 steps and restored into a meshless state, whose
   step 3 loss equals the uninterrupted one bit for bit; the step time
   (CUDA events) and peak memory of the meshless, ``"auto"`` and
   ``"compressed"`` steps, 0 launches; the group destroyed at the end;
19. cells — the serving cells over a mesh at world size 1: a NCCL group on
   a ``FileStore`` of its own, the (1, 1, 1) mesh, qwen3-1.7b at full
   width in bf16: the prefill cell at 1 x 4096 (logits and cache
   bit-equal to the meshless prefill); the decode cell with
   ``decode_kv_seq_axis`` (the cache's sequence on "model", its
   attention through K4 with ``lse=`` and the ranks' merge of
   ``parallel.sequence``) for 3 greedy steps of 8 seats over 16 384
   drawn rows, logits, tokens and cache bit-equal to the meshless
   decode from a copy of the cache, K4 ``lse=`` launches exactly 28 a
   step; K4 with ``lse=`` over a (8, 32 768, 8, 128) bf16 cache cut
   into 4 slices (some seats' slices empty), merged, held to K4 and to
   plain over the whole cache, also with windows (``starts=``) that cross
   the slices' edges, each slice's output and lse held to plain; K4
   ``lse=`` timed at full length beside plain and SDPA;
20. hpc — the fp8 GEMM kernel (K6) against its plain version, held to
   ``fp8_matmul.error_bound`` (f32 sums plus the tensor-core term of sums
   promoted every 128 products), through ``ops.fp8_matmul`` (aligned,
   ragged, bm/bn != 128) and through the per-tensor call at the n = 256,
   nb = 64 LU's first update (M = N = 192, K = 64), at a K the wrapper
   pads to 16, on one-sign operands and at a mid-run HPL trailing-update
   shape (M = N = 32768, K = 1024), timed there with the plain version
   and ``torch._scaled_mm``; planted faults (a scale of the wrong block,
   a dropped k-step, sums never promoted) must fail the same bound;
   HPL fp32 and HPL-MxP fp8 and bf16 (8 refinement iterations) at N =
   65536, NB = 1024 through ``run_hpl``/``run_hplmxp``, with the residual
   criterion (< 16), the falling refinement history and the launch counts
   of K6 checked; the fp8 factor without refinement against the fp32
   factor at n = 256 (> 5x its residual, the reference's test) and,
   logged, at larger n; the fp8 factorization at N = 8192 with the
   kernel and with the plain version (first trailing update and refined
   solutions held); HPCG at 256³ (50 iterations, the true residual
   recomputed) and at 48³ (90 iterations, converged);
21. cli — ``python -m repro_torch.launch.serve`` as phases 7-15 queued it
   (``--fleet``; ``--arch <arch>`` on both engines for qwen2-moe-a2.7b,
   gemma3-12b and grok-1-314b; for mamba2-130m, whisper-base,
   phi-3-vision-4.2b and jamba-v0.1-52b ``--engine batch`` and
   ``--engine paged``, which must exit with the paged engine's refusal),
   six processes at a time, each checked as its phase asked;
22. summary — one JSON line listing the kernels, the card's name and power
    limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no ``ok`` line.
It never runs on the CPU: without CUDA it stops before any phase.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
FP8_FLOPS = 1979e12            # H100 SXM dense fp8 tensor-core rate
ARCH = "qwen3-1.7b"
H, KVH, HEAD_DIM, PAGE, D_MODEL = 16, 8, 128, 16, 2048
LLAMA = "llama3-8b"            # the fleet's second model: 32 heads over 8
LLAMA_H = 32
MOE = "qwen2-moe-a2.7b"        # phase moe: 16 heads over 16 (MHA)
MOE_H = MOE_KVH = 16
GEMMA = "gemma3-12b"           # phase gemma: 16 heads over 8 of 256,
GEMMA_H, GEMMA_HEAD_DIM = 16, 256   # 40 of 48 layers in a window of 1024
WHISPER = "whisper-base"       # phase whisper: 8 heads over 8 of 64 (MHA),
WHISPER_HEAD_DIM = 64          # 6 encoder and 6 decoder layers
VISION = "phi-3-vision-4.2b"   # phase vision: 32 heads over 32 of 96 (MHA),
VISION_HEAD_DIM = 96           # 32 layers, 256 patch rows per prompt
MINICPM = "minicpm-2b"         # phase minicpm: 36 heads over 36 of 64 (MHA),
MINICPM_HEAD_DIM = 64          # 40 layers, a tied 122 753-row embedding
GROK = "grok-1-314b"           # phase grok: 48 heads over 8 of 128 (GQA
GROK_H = 48                    # group 6), 8 experts top-2 on every layer
SEAT_LENGTHS = (1, 16, 17, 255, 700, 1024, 1531, 2048)
N_TABLE = 2048 // PAGE
PREFILL_CHUNK = 128
MAX_LEN = 544                  # fixed-slot max_len: prompt <= 511 + 32 new
# dense decode lengths: a fresh prompt, the spread of a serving wave, a
# full slot, and an idle slot parked on the scratch index (max_len + 1)
SLOT_LENGTHS = (1, 64, 65, 200, 333, 511, 544, MAX_LEN + 1)
PREFILL_S = 511                # the widest prompt of the serving runs
ITERS = 20
SDPA_EFF = "sdpa[EFFICIENT_ATTENTION]"    # yardstick names, with backend
SDPA_FLASH = "sdpa[FLASH_ATTENTION]"
# HPC phase: HPL at NB = 1024, the repo's production HPL block
# (launch/dryrun.py), and N = 65536, half its N for one card (the 16 GiB
# matrix, its working copy and the first trailing product fill ~48 GiB)
HPL_N, HPL_NB = 65536, 1024
K6_M = K6_N = 32768            # a mid-run trailing update of that HPL
HPL_CHECK_N = 8192             # whole-path kernel-vs-plain factorization
HPCG_EDGE = 256                # HPCG's customary per-GPU local grid
# the paged engines of the serving phases: 8 seats, pages of 16 tokens,
# room for 16 requests of up to 544 tokens plus 16 pages of headroom
ENGINE_KW = dict(page_size=PAGE, num_pages=16 * 34 + 16, max_seats=8,
                 max_seq_len=512 + 32, prefill_chunk=PREFILL_CHUNK)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, flush: torch.Tensor, iters: int = ITERS) -> float:
    """Device time of one ``fn()`` in ms, with the 50 MB L2 cache flushed
    before every call (the serving path reads each layer's pool cold):
    the median over ``iters`` calls of the span torch.profiler records
    on the device for each call's ``record_function`` range (from its
    first kernel's start to its last kernel's end).  Where the profiler
    loses most ranges in PROFILE_TRIES tries, the calls are timed by
    ``held_event_ms`` instead, and the log says so."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def timed():
        for _ in range(iters):
            flush.zero_()
            with torch.profiler.record_function(TIMED):
                fn()
    try:
        return statistics.median(profiled(timed, TIMED)[1]) / 1e3
    except ProfilerLostTime as e:
        log("profile", f"{e}; timing by CUDA events behind a spin kernel")
        return held_event_ms(fn, flush, iters)


def event_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Time of one ``fn()`` in ms by CUDA events around each call (L2
    flushed before it), the median over ``iters`` calls: for calls of
    milliseconds, whose launch takes microseconds, the events bracket the
    kernels.  ``cuda_ms`` (the profiler) is for the short kernels, where
    events would time the host instead; torch 2.11's profiler misreads
    long ones (it put the fp8 GEMM at 29–31 ms in two runs, faster than
    the card's f32 peak allows, and at 51–52 ms in two others)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


TIMED = "chip_smoke.timed"
PROFILE_TRIES = 3
SPIN_CYCLES = 1 << 20          # ~0.5 ms at the card's 1.98 GHz
SPIN_DOUBLINGS = 8


class ProfilerLostTime(RuntimeError):
    """torch.profiler kept too little device time in PROFILE_TRIES tries."""


def held_event_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Time of one ``fn()`` in ms by CUDA events around it (L2 flushed
    before it), the median over ``iters`` calls, for calls too short for
    ``event_ms``: a spin kernel (``torch.cuda._sleep``) enqueued before
    each call holds the card while the host enqueues the flush, the
    events and the call, so the events bracket the card's work and not
    the host's launches.  Where the spin ended before the host had
    enqueued the call (an event recorded after it has completed), the
    call is timed again with a spin twice as long, up to SPIN_DOUBLINGS
    times; a call that still outruns it (one that waits on the card
    itself) is timed as it is, host included, as the profiler's span
    from its first kernel to its last would time it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles, doublings, times = SPIN_CYCLES, 0, []
    while len(times) < iters:
        held = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        held.record()
        flush.zero_()
        start.record()
        fn()
        end.record()
        outrun = held.query()
        end.synchronize()
        if outrun and doublings < SPIN_DOUBLINGS:
            cycles, doublings = 2 * cycles, doublings + 1
            continue
        times.append(start.elapsed_time(end))
    if doublings == SPIN_DOUBLINGS:
        log("profile", f"the host outran a spin of {cycles} cycles; these "
            "times include the host's")
    return statistics.median(times)


def profiled(work, key=None):
    """``torch.profiler`` over ``work()`` (CPU and CUDA activity, ending in
    a synchronize).  With ``key``, ``work`` marks each unit with a
    ``record_function(key)`` range, and the device span (µs) of each
    range is returned beside the profile.  torch 2.11's profiler now and
    then loses ranges on the device side: the ones lost are counted in
    the log, and a profile that lost half or more of them (or, without
    ``key``, recorded no device time) is taken again, up to
    PROFILE_TRIES times.

    Raises:
      ProfilerLostTime: no profile in PROFILE_TRIES kept enough device
        time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cpu = torch.autograd.DeviceType.CPU
    for attempt in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            work()
            torch.cuda.synchronize()
        events = prof.events()
        if key is None:
            if any(e.device_type != cpu and e.device_time_total > 0
                   for e in events):
                return prof, []
            ranges, spans = 1, []
        else:
            ranges = sum(1 for e in events
                         if e.name == key and e.device_type == cpu)
            spans = [e.device_time_total for e in events
                     if e.name == key and e.device_type != cpu
                     and e.device_time_total > 0]
            if 2 * len(spans) > ranges:
                if len(spans) < ranges:
                    log("profile", f"torch.profiler lost {ranges - len(spans)}"
                        f" of {ranges} ranges on the device; they are left "
                        "out")
                return prof, spans
        log("profile", f"attempt {attempt + 1}: torch.profiler kept device "
            f"time for {len(spans)} of {ranges} ranges; profiling again")
    raise ProfilerLostTime(f"torch.profiler lost most device time in "
                           f"{PROFILE_TRIES} attempts")


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    """Least time in ms: bytes over the memory rate or operations over
    ``rate``, whichever is larger, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa(backend: SDPBackend, *args, **kw):
    """The yardstick: ``F.scaled_dot_product_attention`` pinned to one
    backend, so a backend PyTorch cannot take raises instead of falling
    back to another."""
    with sdpa_kernel(backend):
        return F.scaled_dot_product_attention(*args, **kw)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float) -> float:
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max |kernel - plain| "
                             f"{err.max().item():.3e} beyond atol {atol} + "
                             f"rtol {rtol}·|plain|")
    return err.max().item()


# bf16 outputs: both sides compute in f32 and round once to bf16, so they
# may differ by one bf16 rounding step (2^-8 relative, up to 2^-7 just
# under a power of two) plus f32 summation-order noise near zero
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7
# f32 outputs: online vs dense softmax, sums in another order
F32_TOL = (2e-5, 1e-4)


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_device() -> str:
    line = smi_line()
    log("device", f"nvidia-smi: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log("device", "allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return line


DECODE_LIBS = ("paged_decode_attention", "decode_attention")


def phase_build() -> None:
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()
    logs = _build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, text in logs.items():
        if name in DECODE_LIBS:             # _check_decode_build names them
            continue
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log("build", f"{name}: {ln.strip()}")
    _check_fp8_build(logs)
    _check_flash_build(logs)
    _check_decode_build(logs)
    t1 = time.perf_counter()
    for d in (2048, HEAD_DIM):
        x = torch.ones((2, d), dtype=torch.bfloat16, device="cuda")
        ops.rmsnorm(x, torch.zeros(d, device="cuda"), impl="kernel")
    torch.cuda.synchronize()
    log("build", f"nvcc {t_nvcc:.1f} s ({len(logs)} sources), "
        f"triton {time.perf_counter() - t1:.1f} s")


def _sass(name: str) -> str:
    """The SASS of the built library of ``csrc/<name>.cu``."""
    from repro_torch.kernels import _build
    path = _build.library(name)._name
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "--dump-sass", path], check=True,
                          capture_output=True, text=True).stdout


def _check_fp8_build(logs: dict) -> None:
    """K6's build: ptxas (``-Xptxas=-v``) must report no spill, and its
    warnings are logged; the library's SASS (``cuobjdump --dump-sass``)
    must hold warpgroup MMAs on e4m3 operands (``QGMMA ... .E4M3.E4M3``;
    HGMMA is the 16-bit form), the fp8 tensor-core path.

    Raises:
      AssertionError: a spill, or no e4m3 warpgroup MMA in the SASS."""
    text = logs["fp8_matmul"]
    for ln in text.splitlines():
        if "warning" in ln.lower():
            log("build", f"fp8_matmul: {ln.strip()}")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
    assert spills and not any(spills), \
        f"fp8_matmul: ptxas reports spills {spills}"
    sass = _sass("fp8_matmul")
    # the warpgroup MMAs: HGMMA for 16-bit operands, QGMMA for fp8
    gmma = [ln.strip() for ln in sass.splitlines()
            if re.search(r"\b[HQ]GMMA\.", ln)]
    e4m3 = [ln for ln in gmma if ".E4M3.E4M3" in ln]
    log("build", f"fp8_matmul SASS: {len(gmma)} warpgroup MMAs, "
        f"{len(e4m3)} on E4M3 operands; first: {e4m3[0] if e4m3 else None}")
    assert e4m3, "fp8_matmul: no warpgroup MMA on E4M3 operands in the SASS"


def _check_flash_build(logs: dict) -> None:
    """K5's build: ptxas must report no spill in any of its kernels, and
    the registers of the tensor-core kernel (``flash_tc_kernel``, one
    instantiation per head dim of ``flash_attention.TC_HEAD_DIMS``, d 96
    included) are logged; the library's SASS must hold bf16 warpgroup
    MMAs (``HGMMA ... .BF16``), the tensor-core route.

    Raises:
      AssertionError: a spill, a tensor-core head dim not instantiated,
          or no bf16 warpgroup MMA in the SASS."""
    text = logs["flash_attention"]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
    assert spills and not any(spills), \
        f"flash_attention: ptxas reports spills {spills}"
    entry, regs = "", {}
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "registers" in ln and "flash_tc_kernel" in entry:
            d = re.search(r"flash_tc_kernelILi(\d+)E", entry)
            regs[int(d.group(1))] = re.search(r"Used (\d+) registers",
                                              ln).group(1)
    log("build", "flash_attention tensor cores, registers by head dim: "
        + ", ".join(f"d={d}: {r}" for d, r in sorted(regs.items())))
    from repro_torch.kernels import flash_attention as fa
    assert sorted(regs) == sorted(fa.TC_HEAD_DIMS), \
        f"flash_attention: tensor-core instantiations {sorted(regs)}, the " \
        f"route takes {fa.TC_HEAD_DIMS}"
    sass = _sass("flash_attention")
    hgmma = sorted({m for m in re.findall(r"\bHGMMA\.[\w.]+", sass)
                    if m.endswith(".BF16")})
    log("build", f"flash_attention SASS: bf16 warpgroup MMAs {hgmma}")
    assert hgmma, "flash_attention: no bf16 warpgroup MMA in the SASS"


def _ptxas_entries(text: str) -> dict:
    """Each entry function of a ptxas ``-v`` report, by mangled name:
    its registers and its spill bytes (stores, loads)."""
    entries, entry, props = {}, None, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            entries.setdefault(entry, {"regs": None, "spill": (0, 0)})
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and props in entries:
            entries[props]["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            entries[entry]["regs"] = int(m.group(1))
    return entries


_MANGLED_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "h": "uint8",
                  "a": "int8"}


def _decode_instantiation(name: str):
    """``(q type, storage type, E, layout, MG)`` of a mangled
    ``repro_decode::decode_kernel<QT, KT, E, Addr, MG>``, or None for
    another function.  A storage type equal to bf16 q is mangled as a
    substitution (``S1_``); only bf16 is substituted (f32 is a builtin)."""
    m = re.search(r"decode_kernelI(f|13__nv_bfloat16)"
                  r"(f|13__nv_bfloat16|S\d*_|h|a)Li(\d+)E.*?"
                  r"(PagedAddr|DenseAddr)ELi(\d+)E", name)
    if m is None:
        return None
    q, kv, e, addr, mg = m.groups()
    kv = "bf16" if kv.startswith("S") else _MANGLED_TYPES[kv]
    return _MANGLED_TYPES[q], kv, int(e), addr, int(mg)


def group_arrays(g: int) -> int:
    """MG, the group size the register arrays of group g are sized for."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def serving_decode_instantiations() -> set:
    """The decode-kernel instantiations the serving paths of this script
    run, by library: at qwen3-1.7b's head dim and group, bf16 queries over
    the bf16, fp8 (uint8 bits) and int8 pools and f32 over an f32 pool
    (phase f32) in the paged library, bf16 and f32 caches in the dense;
    at llama3-8b's group of 4 (phase fleet, the same head dim), bf16
    queries over its bf16 and fp8 pools in the paged library; at
    qwen2-moe-a2.7b's group of 1 (phase moe, the same head dim), bf16
    queries over its bf16 and fp8 pools and f32 over an f32 pool in the
    paged library, and a bf16 cache in the dense; at gemma3-12b's head dim
    of 256 (E = 8) and group of 2 (phase gemma), bf16 queries over its
    bf16 and fp8 pools in the paged library, a bf16 cache and an f32 one
    (its ring-cache check) in the dense; at whisper-base's head dim of 64
    (E = 2) and group of 1 (phase whisper), a bf16 cache and an f32 one
    (its prefill/decode check) in the dense; at phi-3-vision-4.2b's head
    dim of 96 (E = 4, lanes 24-31 of each warp empty) and group of 1
    (phase vision), a bf16 cache and an f32 one (its teacher-forced
    checks) in the dense; at minicpm-2b's head dim of 64 (E = 2) and
    group of 1 (phase minicpm), bf16 queries over its bf16, fp8 and int8
    pools and f32 over an f32 pool (its teacher-forced check) in the
    paged library; at grok-1-314b's group of 6 (MG = 8, rows 6-7 of each
    group empty; phase grok, head dim 128), bf16 queries over its bf16,
    fp8 and int8 pools and f32 over an f32 pool (its f32 checks) in the
    paged library, a bf16 cache and an f32 one (phase variants) in the
    dense."""
    from repro_torch.kernels import decode_attention as da
    e, e_gemma = da.lane_elems(HEAD_DIM), da.lane_elems(GEMMA_HEAD_DIM)
    e_whisper = da.lane_elems(WHISPER_HEAD_DIM)
    e_vision = da.lane_elems(VISION_HEAD_DIM)
    mg, mg_llama = group_arrays(H // KVH), group_arrays(LLAMA_H // KVH)
    mg_moe = group_arrays(MOE_H // MOE_KVH)
    mg_gemma = group_arrays(GEMMA_H // KVH)
    paged = [("bf16", kv, e, mg) for kv in ("bf16", "uint8", "int8")]
    paged += [("f32", "f32", e, mg), ("bf16", "bf16", e, mg_llama),
              ("bf16", "uint8", e, mg_llama)]
    paged += [("bf16", "bf16", e, mg_moe), ("bf16", "uint8", e, mg_moe),
              ("f32", "f32", e, mg_moe)]
    paged += [("bf16", "bf16", e_gemma, mg_gemma),
              ("bf16", "uint8", e_gemma, mg_gemma)]
    e_minicpm = da.lane_elems(MINICPM_HEAD_DIM)
    paged += [("bf16", kv, e_minicpm, group_arrays(1))
              for kv in ("bf16", "uint8", "int8")]
    paged += [("f32", "f32", e_minicpm, group_arrays(1))]
    mg_grok = group_arrays(GROK_H // KVH)
    paged += [("bf16", kv, e, mg_grok) for kv in ("bf16", "uint8", "int8")]
    paged += [("f32", "f32", e, mg_grok)]
    dense = [("bf16", "bf16", e, mg), ("f32", "f32", e, mg),
             ("bf16", "bf16", e, mg_moe), ("bf16", "bf16", e_gemma, mg_gemma),
             ("f32", "f32", e_gemma, mg_gemma),
             ("bf16", "bf16", e_whisper, group_arrays(1)),
             ("f32", "f32", e_whisper, group_arrays(1)),
             ("bf16", "bf16", e_vision, group_arrays(1)),
             ("f32", "f32", e_vision, group_arrays(1)),
             ("bf16", "bf16", e, mg_grok), ("f32", "f32", e, mg_grok)]
    return ({(lib, (q, kv, el, addr, g))
             for lib, addr, insts in (
                 ("paged_decode_attention", "PagedAddr", paged),
                 ("decode_attention", "DenseAddr", dense))
             for q, kv, el, g in insts})


def _check_decode_build(logs: dict) -> None:
    """K1/K2's and K4's builds: every instantiation of the shared decode
    kernel is read from ptxas's report by name, and none may spill: the
    phases of this script launch instantiations of every head dim (E),
    group (MG) and storage type, and the wrappers reach all of them.  In
    the SASS of the serving instantiations (``serving_decode_
    instantiations``) the loads are counted by width (a lane reads its
    4 bf16 elements of a K/V row as one 64-bit load).

    Raises:
      AssertionError: an entry that is not a decode kernel, a serving
          instantiation missing from the report, or any that spills."""
    serving = serving_decode_instantiations()
    spills = []
    for lib in DECODE_LIBS:
        found = {}
        for name, ent in _ptxas_entries(logs[lib]).items():
            inst = _decode_instantiation(name)
            assert inst is not None, f"{lib}: unexpected entry {name}"
            found[inst] = dict(ent, name=name)
        spilled = sorted(i for i, ent in found.items() if any(ent["spill"]))
        regs = sorted(ent["regs"] for ent in found.values())
        log("build", f"{lib}: {len(found)} instantiations, {len(spilled)} "
            f"spill; registers {regs[0]}-{regs[-1]}")
        for i in spilled:
            ent = found[i]
            log("build", f"{lib}: spill {ent['spill'][0]}/{ent['spill'][1]} "
                f"bytes (stores/loads) at {ent['regs']} registers: q {i[0]}, "
                f"storage {i[1]}, E={i[2]}, {i[3]}, MG={i[4]}")
            spills.append((lib, i))
        mine = sorted(i for lb, i in serving if lb == lib)
        for i in mine:
            assert i in found, f"{lib}: no instantiation {i} in the report"
        sass = _sass_functions(lib, {found[i]["name"] for i in mine})
        for i in mine:
            ent = found[i]
            loads = Counter(re.findall(r"\bLDG\.[\w.]+", sass[ent["name"]]))
            log("build", f"{lib} serving instantiation q {i[0]}, storage "
                f"{i[1]}, E={i[2]}, MG={i[4]}: {ent['regs']} registers; "
                f"loads {dict(sorted(loads.items()))}")
    assert not spills, f"decode instantiations spill: {spills}"


def _sass_functions(lib: str, names: set) -> dict:
    """The SASS of the named functions of ``csrc/<lib>.cu``'s library."""
    out, cur = {}, None
    for ln in _sass(lib).splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            cur = m.group(1) if m.group(1) in names else None
            if cur is not None:
                out[cur] = ""
        elif cur is not None:
            out[cur] += ln + "\n"
    missing = names - set(out)
    assert not missing, f"{lib}: no SASS for {sorted(missing)}"
    return out


def _paged_inputs(gen: torch.Generator, seat_lengths=SEAT_LENGTHS,
                  n_table: int = N_TABLE, heads: int = H,
                  head_dim: int = HEAD_DIM):
    """Seats of ``seat_lengths`` tokens (8 at the serving shapes) in
    tables of ``n_table`` pages, pages scattered over the pool, and bf16
    queries of ``heads`` heads of ``head_dim``."""
    need = [-(-n // PAGE) for n in seat_lengths]
    P = 1 + sum(need)
    perm = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).int()
    table = torch.zeros((len(need), n_table), dtype=torch.int32,
                        device="cuda")
    at = 0
    for a, k in enumerate(need):
        table[a, :k] = perm[at:at + k]
        at += k
    lengths = torch.tensor(seat_lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((len(need), 1, heads, head_dim), generator=gen,
                    device="cuda").bfloat16()
    return P, table, lengths, q


def phase_kernels(flush: torch.Tensor) -> dict:
    from repro_torch.core.mixed_precision import quantize_kv_page
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    P, table, lengths, q = _paged_inputs(gen)
    valid = sum(SEAT_LENGTHS)
    A = len(SEAT_LENGTHS)
    results = {}

    shape = (P, PAGE, KVH, HEAD_DIM)
    pools = {"bf16": (torch.randn(shape, generator=gen, device="cuda")
                      .bfloat16(), torch.randn(shape, generator=gen,
                                               device="cuda").bfloat16(),
                      None, None)}
    for dt in ("fp8", "int8"):
        kq, ks = quantize_kv_page(
            torch.randn(shape, generator=gen, device="cuda"), dt)
        vq, vs = quantize_kv_page(
            torch.randn(shape, generator=gen, device="cuda"), dt)
        pools[dt] = (kq, vq, ks, vs)

    # yardstick: SDPA on the already-gathered cache (gather, dequantize
    # and GQA expansion excluded), every seat padded to 2048 keys
    t = torch.arange(N_TABLE * PAGE, device="cuda")
    mask = (t[None, :] < lengths[:, None].long())[:, None, None, :]
    qs = q.transpose(1, 2)                                 # (A, H, 1, d)

    for dt, (k, v, ks, vs) in pools.items():
        name = ("paged_decode_attention" if ks is None
                else "quantized_paged_decode_attention")

        def run(impl, k=k, v=v, ks=ks, vs=vs):
            return ops.paged_decode_attention(q, k, v, table, lengths,
                                              k_scale=ks, v_scale=vs,
                                              impl=impl)
        got = run("kernel")
        torch.cuda.synchronize()
        want = run("plain")
        err = check_close(f"{name}[{dt}]", got, want, BF16_ATOL, BF16_RTOL)
        ms = cuda_ms(lambda: run("kernel"), flush)
        plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
        if dt == "bf16":
            # cuda_ms's fallback, timed in every run beside the profiler
            held = held_event_ms(lambda: run("kernel"), flush, ITERS)
            log("kernels", f"{name}[{dt}] by CUDA events behind a spin "
                f"kernel (cuda_ms's fallback) {held:.4f} ms, by the "
                f"profiler's span {ms:.4f} ms")

        pt = table.long()
        if ks is None:
            kg, vg = k[pt], v[pt]
        else:
            from repro_torch.core.mixed_precision import dequantize_kv_page
            kg = dequantize_kv_page(k[pt], ks[pt]).bfloat16()
            vg = dequantize_kv_page(v[pt], vs[pt]).bfloat16()
        kg = kg.reshape(A, -1, KVH, HEAD_DIM).transpose(1, 2)
        vg = vg.reshape(A, -1, KVH, HEAD_DIM).transpose(1, 2)
        kg = kg.repeat_interleave(H // KVH, dim=1).contiguous()
        vg = vg.repeat_interleave(H // KVH, dim=1).contiguous()
        lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, kg,
                                      vg, attn_mask=mask), flush)

        item = k.element_size()
        nbytes = (2 * valid * KVH * HEAD_DIM * item
                  + (2 * valid * KVH * 4 if ks is not None else 0)
                  + 2 * q.numel() * q.element_size()
                  + table.numel() * 4 + lengths.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * valid * H * HEAD_DIM)
        log("kernels", f"{name}[{dt}] max|err| {err:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
        results[f"{name}[{dt}]"] = dict(
            name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library=SDPA_EFF)

    # every shape K3 takes on qwen3-1.7b's serving path (gemma3-12b's
    # D=3840 in phase gemma): ln1/ln2/final at D=2048, q-norm (x H) and
    # k-norm (x KVH) at D=128, over A decode rows or PREFILL_CHUNK
    # prefill rows; the decode shapes of ln and q-norm are timed, the
    # others checked only
    for rows, d, timed in ((A, 2048, True), (A * H, HEAD_DIM, True),
                           (A * KVH, HEAD_DIM, False),
                           (PREFILL_CHUNK, 2048, False),
                           (PREFILL_CHUNK * H, HEAD_DIM, False),
                           (PREFILL_CHUNK * KVH, HEAD_DIM, False)):
        x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
        w = 0.1 * torch.randn((d,), generator=gen, device="cuda")
        got = ops.rmsnorm(x, w, impl="kernel")
        torch.cuda.synchronize()
        err = check_close(f"rmsnorm[D={d}, M={rows}]", got,
                          ops.rmsnorm(x, w, impl="plain"),
                          BF16_ATOL, BF16_RTOL)
        if not timed:
            log("kernels", f"rmsnorm[D={d}, M={rows}] max|err| {err:.3e}")
            continue
        w_lib = (1.0 + w).bfloat16()
        ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="kernel"), flush)
        plain_ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="plain"), flush)
        lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), weight=w_lib, eps=1e-6),
                         flush)
        b_ms, b_by = bound(2 * x.numel() * 2 + d * 4, 4.0 * x.numel())
        log("kernels", f"rmsnorm[D={d}, M={rows}] max|err| {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms F.rms_norm "
            f"{lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
        results[f"rmsnorm[D={d}]"] = dict(
            name="rmsnorm", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.rms_norm")
    results.update(_norm_kernels(gen, flush))
    _paged_split_edges(gen)
    results.update(_dense_decode_kernel(gen, flush))
    _dense_split_edges(gen)
    results.update(_flash_kernel(gen, flush))
    return results


def _paged_split_edges(gen: torch.Generator) -> None:
    """K1/K2 with every pool type at the edges of the split-K plan of the
    timed shape (8 seats, 8 kv heads, a table of N_TABLE pages): lengths
    chunk - 1, chunk and chunk + 1, seats whose later splits are all empty
    (1, 17), 2·chunk + 1, 3·chunk - 1 and the full table, each against the
    plain version; after the launches every ticket must be back at 0."""
    from repro_torch.core.mixed_precision import quantize_kv_page
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    splits, chunk = da.split_plan(len(SEAT_LENGTHS), KVH, N_TABLE * PAGE,
                                  _sms())
    lens = (chunk - 1, chunk, chunk + 1, 1, 2 * chunk + 1, N_TABLE * PAGE,
            17, 3 * chunk - 1)
    P, table, lengths, q = _paged_inputs(gen, lens)
    shape = (P, PAGE, KVH, HEAD_DIM)
    for dt in ("bf16", "fp8", "int8"):
        k = torch.randn(shape, generator=gen, device="cuda")
        v = torch.randn(shape, generator=gen, device="cuda")
        ks = vs = None
        if dt == "bf16":
            k, v = k.bfloat16(), v.bfloat16()
        else:
            (k, ks), (v, vs) = (quantize_kv_page(k, dt),
                                quantize_kv_page(v, dt))
        got, want = (ops.paged_decode_attention(
            q, k, v, table, lengths, k_scale=ks, v_scale=vs, impl=impl)
            for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        err = check_close(f"paged split edges[{dt}]", got, want, BF16_ATOL,
                          BF16_RTOL)
        tickets = da._tickets[q.device]
        assert not bool(tickets.any()), \
            f"paged split edges[{dt}]: tickets left at {tickets.nonzero()}"
        log("kernels", f"paged decode split edges [{dt}]: {splits} splits "
            f"of {chunk} tokens, lengths {lens}: max|err| {err:.3e}; "
            "tickets back at 0")


def _dense_decode_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K4 at the fixed-slot decode shapes: 8 slots of MAX_LEN + 1 keys,
    lengths SLOT_LENGTHS (the last an idle slot on the scratch index),
    split over the cache width as ``split_plan`` says."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    B, T = len(SLOT_LENGTHS), MAX_LEN + 1
    lengths = torch.tensor(SLOT_LENGTHS, dtype=torch.int32, device="cuda")
    q = torch.randn((B, 1, H, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((B, T, KVH, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn((B, T, KVH, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()

    def run(impl):
        return ops.decode_attention(q, k, v, lengths, impl=impl)
    got = run("kernel")
    torch.cuda.synchronize()
    err = check_close("decode_attention[bf16]", got, run("plain"),
                      BF16_ATOL, BF16_RTOL)
    ms = cuda_ms(lambda: run("kernel"), flush)
    plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
    # yardstick: SDPA on the GQA-expanded cache (expansion excluded)
    kg = k.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    vg = v.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :]
            < lengths[:, None].long())[:, None, None, :]
    qs = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, kg, vg,
                                  attn_mask=mask), flush)
    valid = sum(SLOT_LENGTHS)
    nbytes = (2 * valid * KVH * HEAD_DIM * 2 + 2 * q.numel() * 2
              + lengths.numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * valid * H * HEAD_DIM)
    splits, chunk = da.split_plan(B, KVH, T, _sms())
    log("kernels", f"decode_attention[bf16] max|err| {err:.3e} kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms "
        f"bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB; idle slot "
        f"walks {MAX_LEN + 1} of {valid} keys; {splits} splits of {chunk})")
    # the cost of the idle slots' scratch-index walk at a wave's tail: 4
    # short live slots beside 4 idle ones, which walk their whole cache
    # (the reference's mask) or, for comparison only, one key
    tail = []
    for idle_len in (MAX_LEN + 1, 1):
        lens = torch.tensor((97, 120, 131, 142) + (idle_len,) * 4,
                            dtype=torch.int32, device="cuda")
        tail.append(cuda_ms(lambda: ops.decode_attention(
            q, k, v, lens, impl="kernel"), flush))
    log("kernels", f"decode_attention[bf16] wave tail (live 97-142 keys, "
        f"4 idle slots): {tail[0]:.4f} ms with the idle slots walking "
        f"{MAX_LEN + 1} keys, {tail[1]:.4f} ms if they walked 1")
    return {"decode_attention[bf16]": dict(
        name="decode_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=SDPA_EFF)}


def _dense_split_edges(gen: torch.Generator) -> None:
    """K4 with bf16 and f32 caches at the edges of the split-K plan of
    the fixed-slot shape (8 slots, 8 kv heads, MAX_LEN + 1 keys): lengths
    chunk - 1, chunk and chunk + 1, slots whose later splits are all
    empty (1, 17), 2·chunk + 1, 3·chunk - 1 and an idle slot walking the
    whole cache, each against the plain version at the tolerance of its
    dtype; after the launches every ticket must be back at 0."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    B, T = 8, MAX_LEN + 1
    splits, chunk = da.split_plan(B, KVH, T, _sms())
    lens = (chunk - 1, chunk, chunk + 1, 1, 2 * chunk + 1, T, 17,
            3 * chunk - 1)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dt, tol in ((torch.bfloat16, (BF16_ATOL, BF16_RTOL)),
                    (torch.float32, F32_TOL)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((B, 1, H, HEAD_DIM), (B, T, KVH, HEAD_DIM),
                                 (B, T, KVH, HEAD_DIM)))
        got, want = (ops.decode_attention(q, k, v, lengths, impl=impl)
                     for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        err = check_close(f"dense split edges[{dt}]", got, want, *tol)
        tickets = da._tickets[q.device]
        assert not bool(tickets.any()), \
            f"dense split edges[{dt}]: tickets left at {tickets.nonzero()}"
        log("kernels", f"dense decode split edges [{dt}]: {splits} splits of "
            f"{chunk} tokens, lengths {lens}: max|err| {err:.3e}; tickets "
            "back at 0")


def _norm_kernels(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K3's fused forms against their plain versions, bf16: ``add_rmsnorm``
    at the decode rows (M = 8, D = 2048) and the prefill-chunk rows (M =
    PREFILL_CHUNK), where ``s`` must be bit-equal to torch's own add and
    the norm within the bf16 tolerance; ``rmsnorm_qk`` at the decode
    rows (q 8·H and k 8·KVH rows of D = 128) and the prefill-chunk rows.
    The decode shapes are timed beside K3 on the same rows (for q and k,
    the two K3 launches they replace, each timed alone and summed) with
    their bound; no single PyTorch call computes either, so no library
    time."""
    from repro_torch.kernels import ops
    out = {}
    for rows, timed in ((len(SEAT_LENGTHS), True), (PREFILL_CHUNK, False)):
        x, y = (torch.randn((rows, D_MODEL), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        w = 0.1 * torch.randn((D_MODEL,), generator=gen, device="cuda")
        (s, n), (s_p, n_p) = (ops.add_rmsnorm(x, y, w, impl=impl)
                              for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        same = (s.view(torch.int16) == (x + y).view(torch.int16)).all()
        assert bool(same) and torch.equal(s_p, x + y), \
            f"add_rmsnorm[M={rows}]: s is not bit-equal to x + y"
        err = check_close(f"add_rmsnorm[D={D_MODEL}, M={rows}]", n, n_p,
                          BF16_ATOL, BF16_RTOL)
        if not timed:
            log("kernels", f"add_rmsnorm[D={D_MODEL}, M={rows}] s bit-equal, "
                f"max|err| {err:.3e}")
            continue
        ms = cuda_ms(lambda: ops.add_rmsnorm(x, y, w, impl="kernel"), flush)
        plain_ms = cuda_ms(lambda: ops.add_rmsnorm(x, y, w, impl="plain"),
                           flush)
        k3_ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="kernel"), flush)
        # read x, y and w, write s and the norm; add, square, sum, scale
        # and weight per element
        b_ms, b_by = bound(4 * x.numel() * 2 + D_MODEL * 4, 5.0 * x.numel())
        log("kernels", f"add_rmsnorm[D={D_MODEL}, M={rows}] s bit-equal, "
            f"max|err| {err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"(K3 alone on the same rows {k3_ms:.4f} ms) bound {b_ms:.5f} ms "
            f"({b_by})")
        out[f"add_rmsnorm[D={D_MODEL}]"] = dict(
            name="add_rmsnorm", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
    for rows, timed in ((len(SEAT_LENGTHS), True), (PREFILL_CHUNK, False)):
        q = torch.randn((rows, H, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((rows, KVH, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        wq, wk = (0.1 * torch.randn((HEAD_DIM,), generator=gen,
                                    device="cuda") for _ in range(2))
        (qn, kn), (qp, kp) = (ops.rmsnorm_qk(q, k, wq, wk, impl=impl)
                              for impl in ("kernel", "plain"))
        torch.cuda.synchronize()
        tag = f"rmsnorm_qk[D={HEAD_DIM}, q {rows * H} + k {rows * KVH} rows]"
        err = max(check_close(tag + " q", qn, qp, BF16_ATOL, BF16_RTOL),
                  check_close(tag + " k", kn, kp, BF16_ATOL, BF16_RTOL))
        if not timed:
            log("kernels", f"{tag} max|err| {err:.3e}")
            continue
        ms = cuda_ms(lambda: ops.rmsnorm_qk(q, k, wq, wk, impl="kernel"),
                     flush)
        plain_ms = cuda_ms(lambda: ops.rmsnorm_qk(q, k, wq, wk,
                                                  impl="plain"), flush)
        k3_ms = (cuda_ms(lambda: ops.rmsnorm(q, wq, impl="kernel"), flush)
                 + cuda_ms(lambda: ops.rmsnorm(k, wk, impl="kernel"), flush))
        elems = q.numel() + k.numel()
        b_ms, b_by = bound(2 * elems * 2 + 2 * HEAD_DIM * 4, 4.0 * elems)
        log("kernels", f"{tag} max|err| {err:.3e} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms (K3 on q and K3 on k, the sum of the two "
            f"kernels' times, {k3_ms:.4f} ms) bound {b_ms:.5f} ms ({b_by})")
        out[f"rmsnorm_qk[D={HEAD_DIM}]"] = dict(
            name="rmsnorm_qk", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, library=None)
    return out


def _flash_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K5 at the prefill shapes: one causal prompt of PREFILL_S tokens
    timed; 64 and 37 tokens checked."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    assert fa.route(torch.bfloat16, HEAD_DIM) == "tensor cores", \
        "the prefill shape does not take the tensor-core route"
    out = {}
    for S in (PREFILL_S, 64, 37):
        q = torch.randn((1, S, H, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((1, S, KVH, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((1, S, KVH, HEAD_DIM), generator=gen,
                        device="cuda").bfloat16()

        def run(impl, q=q, k=k, v=v):
            return ops.flash_attention(q, k, v, causal=True, impl=impl)
        got = run("kernel")
        torch.cuda.synchronize()
        err = check_close(f"flash_attention[causal, S={S}]", got,
                          run("plain"), BF16_ATOL, BF16_RTOL)
        if S != PREFILL_S:
            log("kernels", f"flash_attention[causal, S={S}] max|err| "
                f"{err:.3e}")
            continue
        ms = cuda_ms(lambda: run("kernel"), flush)
        plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
        qs = q.transpose(1, 2).contiguous()
        kg = k.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
        vg = v.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
        lib_ms = cuda_ms(lambda: sdpa(SDPBackend.FLASH_ATTENTION, qs, kg, vg,
                                      is_causal=True), flush)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        kept = S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, 4.0 * HEAD_DIM * H * kept, BF16_FLOPS)
        log("kernels", f"flash_attention[causal, S={S}] max|err| {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {SDPA_FLASH} "
            f"{lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by}, "
            f"{nbytes / 1e6:.2f} MB, {4.0 * HEAD_DIM * H * kept / 1e9:.2f} "
            "GFLOP at the bf16 tensor-core rate)")
        out["flash_attention[causal]"] = dict(
            name="flash_attention", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library=SDPA_FLASH)
    return out


def phase_variants() -> None:
    """The kernels against their plain versions off the main path's
    shapes: f32 queries and pools, GQA groups 1, 4 (llama3-8b) and 6
    (grok-1-314b: bf16 queries over bf16 and fp8 pools and f32 over f32,
    dense decode in bf16 and f32, flash causal on both routes), smaller
    head dims (the reduced configs), f32 RMSNorm; and at d 96
    (phi-3-vision-4.2b), where a lane or descriptor fault shows at a size
    a log can hold: dense decode over lengths 1, 9, 64 and 200 (E = 4,
    the last 8 lanes of every warp empty), and flash on the tensor cores
    causal at 77 and non-causal at 96 x 200 (a ragged last key tile)."""
    from repro_torch.core.mixed_precision import quantize_kv_page
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # (H, KVH, d, q dtype, pool)
        (16, 8, 128, torch.float32, "f32"), (16, 8, 128, torch.bfloat16, "f32"),
        (32, 8, 128, torch.bfloat16, "bf16"), (8, 8, 64, torch.float32, "fp8"),
        (4, 4, 16, torch.float32, "int8"), (4, 2, 16, torch.float32, "bf16"),
        # grok-1-314b's group of 6 on the MG = 8 instantiations
        (GROK_H, 8, 128, torch.bfloat16, "bf16"),
        (GROK_H, 8, 128, torch.bfloat16, "fp8"),
        (GROK_H, 8, 128, torch.float32, "f32")]
    lengths = torch.tensor([1, 9, 64, 200], dtype=torch.int32, device="cuda")
    n = 16
    table = (torch.randperm(4 * n, generator=gen, device="cuda") + 1).int()
    table = table.reshape(4, n)
    for H_, KVH_, d, qdt, pool in cases:
        q = torch.randn((4, 1, H_, d), generator=gen, device="cuda").to(qdt)
        shape = (4 * n + 1, PAGE, KVH_, d)
        k = torch.randn(shape, generator=gen, device="cuda")
        v = torch.randn(shape, generator=gen, device="cuda")
        ks = vs = None
        if pool in ("fp8", "int8"):
            (k, ks), (v, vs) = (quantize_kv_page(k, pool),
                                quantize_kv_page(v, pool))
        elif pool == "bf16":
            k, v = k.bfloat16(), v.bfloat16()
        got, want = (ops.paged_decode_attention(
            q, k, v, table, lengths, k_scale=ks, v_scale=vs, impl=impl)
            for impl in ("kernel", "plain"))
        tol = F32_TOL if qdt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"paged[H={H_},KVH={KVH_},d={d},{qdt},{pool}]",
                          got, want, *tol)
        log("variants", f"paged decode H={H_} KVH={KVH_} d={d} q={qdt} "
            f"pool={pool}: max|err| {err:.3e}")
    for d in (64, 2048):
        x = torch.randn((5, d), generator=gen, device="cuda")
        w = torch.randn((d,), generator=gen, device="cuda")
        err = check_close(f"rmsnorm[f32,D={d}]",
                          ops.rmsnorm(x, w, impl="kernel"),
                          ops.rmsnorm(x, w, impl="plain"), *F32_TOL)
        log("variants", f"rmsnorm f32 D={d}: max|err| {err:.3e}")
    dense = [  # (B, T, H, KVH, d, q dtype, cache dtype)
        (4, 37, 4, 2, 16, torch.float32, torch.float32),
        (3, 160, 8, 2, 64, torch.float32, torch.float32),
        (3, 96, 4, 1, 32, torch.bfloat16, torch.bfloat16),
        (4, 255, 32, 8, 128, torch.bfloat16, torch.bfloat16),
        (2, 545, 16, 8, 128, torch.float32, torch.bfloat16),
        (2, 100, 8, 8, 256, torch.float32, torch.float32),
        (3, 545, GROK_H, 8, 128, torch.bfloat16, torch.bfloat16),
        (2, 200, GROK_H, 8, 128, torch.float32, torch.float32)]
    for B, T, H_, KVH_, d, qdt, kdt in dense:
        q = torch.randn((B, 1, H_, d), generator=gen, device="cuda").to(qdt)
        k = torch.randn((B, T, KVH_, d), generator=gen, device="cuda").to(kdt)
        v = torch.randn((B, T, KVH_, d), generator=gen, device="cuda").to(kdt)
        lengths = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
        got, want = (ops.decode_attention(q, k, v, lengths, impl=impl)
                     for impl in ("kernel", "plain"))
        tol = F32_TOL if qdt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"dense[B={B},T={T},H={H_},KVH={KVH_},d={d},"
                          f"{qdt},{kdt}]", got, want, *tol)
        log("variants", f"dense decode T={T} H={H_} KVH={KVH_} d={d} "
            f"q={qdt} cache={kdt}: max|err| {err:.3e}")
    d96 = torch.tensor([1, 9, 64, 200], dtype=torch.int32, device="cuda")
    q = torch.randn((4, 1, 4, 96), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((4, 200, 4, 96), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    got, want = (ops.decode_attention(q, k, v, d96, impl=impl)
                 for impl in ("kernel", "plain"))
    err = check_close("dense[B=4,T=200,H=4,KVH=4,d=96,bf16]", got, want,
                      BF16_ATOL, BF16_RTOL)
    log("variants", f"dense decode T=200 H=4 KVH=4 d=96 bf16, lengths "
        f"{d96.tolist()}: max|err| {err:.3e}")
    flash = [  # (B, Sq, Skv, H, KVH, d, dtype, causal, window)
        (2, 100, 100, 16, 8, 128, torch.float32, True, None),
        (1, 511, 511, 16, 8, 128, torch.bfloat16, True, 128),
        (2, 77, 77, 8, 2, 64, torch.float32, True, 32),
        (2, 64, 64, 4, 4, 32, torch.float32, False, None),
        (2, 96, 200, 4, 1, 32, torch.bfloat16, False, None),
        (1, 37, 37, 4, 2, 16, torch.float32, True, None),
        (1, 300, 300, 4, 4, 256, torch.bfloat16, True, None),
        (2, 77, 77, 4, 4, 96, torch.bfloat16, True, None),
        (2, 96, 200, 4, 2, 96, torch.bfloat16, False, None),
        (1, 300, 300, GROK_H, 8, 128, torch.bfloat16, True, None),
        (1, 77, 77, GROK_H, 8, 128, torch.float32, True, None)]
    for B, Sq, Skv, H_, KVH_, d, dt, causal, window in flash:
        q = torch.randn((B, Sq, H_, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Skv, KVH_, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Skv, KVH_, d), generator=gen, device="cuda").to(dt)
        got, want = (ops.flash_attention(q, k, v, causal=causal,
                                         window=window, impl=impl)
                     for impl in ("kernel", "plain"))
        tol = F32_TOL if dt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"flash[B={B},Sq={Sq},Skv={Skv},H={H_},"
                          f"KVH={KVH_},d={d},{dt},causal={causal},"
                          f"window={window}]", got, want, *tol)
        log("variants", f"flash Sq={Sq} Skv={Skv} H={H_} KVH={KVH_} d={d} "
            f"{dt} causal={causal} window={window} "
            f"({fa.route(dt, d)}): max|err| {err:.3e}")
    torch.cuda.synchronize()


def norm_launches(cfg, steps: int) -> dict:
    """The norm kernels' launches over ``steps`` model steps: per step
    layer 0's ln1 alone (K3), per layer the mixer's add fused into ln2
    and the MLP add into the next ln1 or the final norm (``add_rmsnorm``),
    and, in a model with qk-norm, the q- and k-norm in one launch
    (``rmsnorm_qk``).  A layer without an MLP (mamba2-130m's) fuses its
    mixer's add into the next norm: one ``add_rmsnorm``.  An SSM layer
    adds its gated norm at d_inner (K3)."""
    L, D = cfg.num_layers, cfg.d_model
    periods = L // cfg.scan_period()
    with_mlp = periods * sum(k != "none" for k in cfg.mlp_kinds())
    n_ssm = periods * cfg.layer_kinds().count("ssm")
    out = {f"rmsnorm[D={D}]": steps,
           f"add_rmsnorm[D={D}]": (L + with_mlp) * steps}
    if n_ssm:
        out[f"rmsnorm[D={cfg.ssm.expand * D}]"] = n_ssm * steps
    if cfg.qk_norm:
        out[f"rmsnorm_qk[D={cfg.head_dim}]"] = L * steps
    return out


def layer_counts(cfg) -> tuple:
    """(global, sliding-window) attention layers of ``cfg`` (a hybrid's
    SSM layers are neither)."""
    periods = cfg.num_layers // cfg.scan_period()
    kinds = cfg.layer_kinds()
    return periods * kinds.count("attn"), periods * kinds.count("attn_local")


def attention_launches(cfg, kernel: str, steps: int) -> dict:
    """A decode kernel's launches over ``steps`` model steps: per step
    once per global layer under ``kernel[tag]`` and once per
    sliding-window layer under ``kernel[tag,window]``."""
    n_global, n_local = layer_counts(cfg)
    out = {kernel: n_global * steps}
    if n_local:
        out[kernel[:-1] + ",window]"] = n_local * steps
    return out


def _check_run(tag: str, r: dict, cfg, counts: dict,
               phase: str = "serve", requests: int = 16,
               gen: int = 32) -> None:
    """Checks one serving run of ``requests`` requests of ``gen`` new
    tokens with a ``tag`` pool against the kernel launches ``counts``
    read just after it."""
    eng = r["engine"]
    kernel = ("paged_decode_attention" if tag == "bf16"
              else "quantized_paged_decode_attention") + f"[{tag}]"
    done = r["finished"]
    assert len(done) == requests, \
        f"{tag}: {len(done)} of {requests} requests finished"
    for req in done:
        assert len(req.generated) == req.max_new_tokens == gen, (tag, req.rid)
        assert all(0 <= t < cfg.vocab_size for t in req.generated), \
            f"{tag}: rid {req.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), f"{tag}: a logit was not finite"
    ticks = eng.policy.decode_ticks
    chunks = sum(1 for _, ev, _ in eng.trace if ev == "prefill_chunk")
    # the attention kernel of the pool once per layer per decode tick (a
    # sliding-window layer's under its own key); per model step (decode
    # tick or prefill chunk) the norms
    want = {**attention_launches(cfg, kernel, ticks),
            **norm_launches(cfg, ticks + chunks)}
    assert counts == want, \
        f"{tag}: launches {counts}, expected {want} for {ticks} decode " \
        f"ticks and {chunks} prefill chunks"
    m = r["metrics"]
    log(phase, f"{tag}: {m['completed']:.0f} requests "
        f"{m['generated_tokens']:.0f} tokens, {ticks} decode ticks, "
        f"{chunks} prefill chunks, {m['tokens_per_s']:.1f} tokens/s, "
        f"mean TTFT {m['ttft_avg_s'] * 1e3:.1f} ms, wall "
        f"{m['wall_s']:.2f} s; launches {json.dumps(dict(counts))}")


def _tick_state(eng):
    """A decode state of every seat of ``eng`` at spread positions, on
    pages of its pool (their contents are what serving left there)."""
    pol = eng.policy
    A = pol.max_seats
    gen = torch.Generator(device="cuda").manual_seed(2)
    pages = (torch.randperm(pol.bm.capacity, generator=gen,
                            device="cuda")[:A * pol.n_tables] + 1).int()
    return dict(
        last=torch.randint(0, eng.cfg.vocab_size, (A,), generator=gen,
                           device="cuda", dtype=torch.int32),
        pos=torch.linspace(40, pol.n_tables * PAGE - 2, A).int().cuda(),
        table=pages.reshape(A, pol.n_tables),
        nv=torch.ones(A, dtype=torch.int32, device="cuda"),
        temp=torch.zeros(A, device="cuda"),
        top_k=torch.zeros(A, dtype=torch.int32, device="cuda"),
        top_p=torch.ones(A, device="cuda"),
        seed=torch.zeros(A, dtype=torch.int64, device="cuda"),
        rid=torch.arange(A, dtype=torch.int64, device="cuda"),
        step=torch.zeros(A, dtype=torch.int64, device="cuda"))


def _tick(eng, cache, state, impl, params=None, cfg=None):
    """One fused tick of ``eng``'s model (or of ``params``/``cfg``) from
    a copy of ``state`` over ``cache``; returns (tokens, logits)."""
    from repro_torch.models import model as M
    s = {k: t.clone() for k, t in state.items()}
    return M.fused_decode_tick(
        eng.policy.params if params is None else params,
        eng.cfg if cfg is None else cfg, cache, s["last"], s["pos"],
        s["table"], s["nv"], s["temp"], s["top_k"], s["top_p"], s["seed"],
        s["rid"], s["step"], impl=impl)


def _clone(cache):
    return {p: {k: t.clone() for k, t in ent.items()}
            for p, ent in cache.items()}


def _check_logits(phase: str, what: str, lk: torch.Tensor,
                  lp: torch.Tensor) -> float:
    """Holds one model step's (rows, V) logits with the kernels ``lk``
    against the plain versions' ``lp``; returns max |difference|."""
    assert bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    # bf16 rounding differences of the kernels compound over 28 layers:
    # allow 5% of the largest logit
    assert diff <= 0.05 * scale + 1e-3, \
        f"{what}: logits kernel vs plain differ by {diff:.3e} (largest " \
        f"logit {scale:.3e})"
    same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    log(phase, f"{what} kernel vs plain: max|Δlogit| {diff:.3e} (largest "
        f"|logit| {scale:.3e}), greedy tokens equal {same}/{len(lk)}")
    return diff


SERVING_GROUPS = (("norm kernels (K3 and its fused forms)",
                   lambda key: "rmsnorm" in key),
                  ("decode attention (K1/K2/K4)",
                   lambda key: "decode_kernel" in key))


def _profile_steady(phase: str, what: str, step, steps: int = 5,
                    groups=SERVING_GROUPS, top: int = 6) -> tuple:
    """Wall time of a steady model ``step()`` (which ends by bringing its
    tokens to the host, as the engine does), its device busy time (the
    kernels' time under torch.profiler), the kernels that take it, and
    the time of each of ``groups`` (label, pick(kernel name)).
    The idle share compares the busy time with the wall time measured
    without the profiler, whose host overhead it would otherwise count.
    Returns (wall, busy) in ms per step."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall = (time.perf_counter() - t0) / steps * 1e3

    def work():
        for _ in range(steps):
            step()
    kernels = [a for a in profiled(work)[0].key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA
               and a.self_device_time_total > 0]
    busy = sum(a.self_device_time_total for a in kernels) / steps / 1e3
    kernels.sort(key=lambda a: a.self_device_time_total, reverse=True)
    log(phase, f"{what}: wall {wall:.2f} ms, device busy {busy:.3f} ms "
        f"({sum(a.count for a in kernels) // steps} kernels), idle share "
        f"{1 - busy / wall:.3f}")
    for a in kernels[:top]:
        log(phase, f"{what}:   {a.self_device_time_total / steps / 1e3:.4f} "
            f"ms x{a.count // steps} {a.key[:110]}")
    for label, pick in groups:
        sel = [a for a in kernels if pick(a.key)]
        log(phase, f"{what}: {label} "
            f"{sum(a.self_device_time_total for a in sel) / steps / 1e3:.4f} "
            f"ms x{sum(a.count for a in sel) // steps}")
    return wall, busy


def _tick_kernel_vs_plain(tag: str, eng) -> float:
    """One fused tick on one state, with the kernels and with the plain
    versions; returns max |logits difference|."""
    state = _tick_state(eng)
    out = {}
    for impl in ("kernel", "plain"):
        out[impl] = _tick(eng, _clone(eng.policy.cache), state, impl)[1]
        torch.cuda.synchronize()
    return _check_logits("serve", f"{tag}: fused tick", out["kernel"],
                         out["plain"])


def _profile_tick(tag: str, eng) -> None:
    """The steady fused tick (8 seats, kernels), run eagerly, under
    ``_profile_steady``."""
    state = _tick_state(eng)
    cache = _clone(eng.policy.cache)
    _profile_steady("serve", f"{tag}: steady fused tick, eager",
                    lambda: _tick(eng, cache, state, "kernel")[0].cpu())


def _profile_graph_tick(tag: str, eng, phase: str = "serve",
                        groups=SERVING_GROUPS) -> tuple:
    """The engine's captured fused tick replayed from the state of
    ``_profile_tick`` under ``_profile_steady``; ``pos`` and ``step`` are
    put back before each replay (two copies of 32 and 64 bytes among the
    kernels counted), so no seat runs past its table.  Returns (wall,
    busy) in ms per tick."""
    pol = eng.policy
    state = _tick_state(eng)
    for key, t in state.items():
        pol._dev[key].copy_(t)

    def step():
        pol._dev["pos"].copy_(state["pos"])
        pol._dev["step"].copy_(state["step"])
        return pol._tick_fn()[0].cpu()
    return _profile_steady(phase, f"{tag}: steady fused tick, graph replay",
                           step, groups=groups)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def _assert_bits(what: str, pairs: dict) -> None:
    """Every ``name: (replayed, eager)`` pair must be bit-equal."""
    torch.cuda.synchronize()
    bad = [name for name, (got, want) in pairs.items()
           if not _bits_equal(got, want)]
    assert not bad, f"{what}: graph replay and eager run differ in {bad}"


def _pools(cache, skip_scratch: bool = False) -> dict:
    """Every pool tensor of a paged cache by name; ``skip_scratch`` drops
    page 0, which takes the padding's writes in no fixed order."""
    return {f"{p}.{k}": t[:, 1:] if skip_scratch else t
            for p, ent in cache.items() for k, t in ent.items()}


def _graph_vs_eager(tag: str, eng, phase: str = "serve",
                    start: int = 200) -> None:
    """The paged engine's two graphs replayed against the functions they
    captured, run eagerly on the same inputs and a copy of the same pool:
    the fused tick (8 seats at spread lengths, greedy, temperature,
    top-k and top-p) in its tokens, logits, every pool byte and the
    advanced ``last``, ``pos`` and ``step``; the prefill chunk (77 of
    128 tokens from position ``start``) in its logits and every pool
    byte outside the scratch page.  All must be bit-equal."""
    from repro_torch.models import model as M
    pol, cfg = eng.policy, eng.cfg
    state = _tick_state(eng)
    state["temp"][1::2] = 0.8
    state["top_k"][1::4] = 50
    state["top_p"][3::4] = 0.9
    state["seed"][:] = 7
    eager = {k: t.clone() for k, t in state.items()}
    cache = _clone(pol.cache)
    toks, logits = M.fused_decode_tick(
        pol.params, cfg, cache, eager["last"], eager["pos"], eager["table"],
        eager["nv"], eager["temp"], eager["top_k"], eager["top_p"],
        eager["seed"], eager["rid"], eager["step"], impl=pol.impl)
    for key, t in state.items():
        pol._dev[key].copy_(t)
    g_toks, g_logits = pol._tick_fn()
    pairs = {"tokens": (g_toks, toks), "logits": (g_logits, logits),
             **{key: (pol._dev[key], eager[key])
                for key in ("last", "pos", "step")}}
    got_pool, want_pool = _pools(pol.cache), _pools(cache)
    pairs.update({k: (got_pool[k], want_pool[k]) for k in got_pool})
    _assert_bits(f"{tag}: fused tick", pairs)
    stochastic = int((state["temp"] > 0).sum())
    log(phase, f"{tag}: fused tick graph replay == eager, bit for bit "
        f"(tokens, logits, {len(got_pool)} pool tensors, last/pos/step; "
        f"{stochastic} of {len(toks)} seats sampling)")

    gen = torch.Generator(device="cuda").manual_seed(5)
    C, c = pol.prefill_chunk, 77
    tok = torch.zeros((1, C), dtype=torch.int32, device="cuda")
    tok[0, :c] = torch.randint(0, cfg.vocab_size, (c,), generator=gen,
                               device="cuda", dtype=torch.int32)
    meta = torch.tensor([start, c], dtype=torch.int32, device="cuda")
    row = state["table"][:1].clone()
    cache = _clone(pol.cache)
    logits, _ = M.paged_decode_step(pol.params, cfg, cache, tok, meta[:1],
                                    row, meta[1:], impl=pol.impl)
    buf = pol._prefill.dev
    buf["tokens"].copy_(tok)
    buf["meta"].copy_(meta)
    buf["row"].copy_(row)
    g_logits = pol._prefill_fn()
    got_pool = _pools(pol.cache, skip_scratch=True)
    want_pool = _pools(cache, skip_scratch=True)
    pairs = {"logits": (g_logits, logits),
             **{k: (got_pool[k], want_pool[k]) for k in got_pool}}
    _assert_bits(f"{tag}: prefill chunk", pairs)
    log(phase, f"{tag}: prefill chunk graph replay == eager, bit for bit "
        f"({c} of {C} tokens from position {start}: logits, "
        f"{len(got_pool)} pool tensors outside the scratch page)")


def _check_tickets(what: str, tickets) -> None:
    """The decode kernels' split tickets must all be back at 0."""
    for buf in tickets:
        assert not bool(buf.any()), \
            f"{what}: tickets left at {buf.nonzero().flatten().tolist()}"


def _eager_engine(tag: str, r: dict, cfg, phase: str = "serve",
                  record=None) -> None:
    """The paged engine with ``fused=False`` (eager model step, host-side
    sampling, no graph) over the requests of the graphed run ``r`` (each
    with its sampling), on the same weights: the greedy streams and the
    traces must be equal; how many sampled streams are equal is logged.
    With ``record`` (a list), the ``ops.paged_decode_attention`` and norm
    calls made while the engine's decode tick count reads 20 (its 21st
    tick and any prefill chunk of that engine step) are appended to it
    (``_recording``)."""
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(
        cfg, r["engine"].params, kv_dtype=None if tag == "bf16" else tag,
        fused=False, device="cuda", **ENGINE_KW)
    reqs = sorted(r["finished"], key=lambda q: q.rid)
    for q in reqs:
        eng.submit(q.prompt, max_new_tokens=q.max_new_tokens,
                   sampling=q.sampling)
    calls = [] if record is None else record
    with (_recording(calls, lambda: eng.policy.decode_ticks == 20,
                     ("paged_decode_attention",) + NORM_OPS)
          if record is not None else contextlib.nullcontext()):
        eager = {q.rid: q.generated for q in eng.run()}
    graphed = {q.rid: q.generated for q in r["finished"]}
    greedy = [q.rid for q in reqs if q.sampling.temperature <= 0]
    diff = [rid for rid in greedy if eager.get(rid) != graphed[rid]]
    assert not diff and len(eager) == len(graphed), \
        f"{tag}: fused=True and fused=False greedy streams differ for " \
        f"rids {diff}"
    assert eng.trace == r["engine"].trace, f"{tag}: traces differ"
    sampled = [rid for rid in graphed if rid not in greedy]
    same = sum(eager[rid] == graphed[rid] for rid in sampled)
    m = eng.metrics.snapshot()
    log(phase, f"{tag}: fused=False engine (eager, host sampling) over "
        f"the same {len(reqs)} requests: greedy streams ({len(greedy)}) and "
        f"trace equal to the graphed run's"
        + (f", sampled streams equal {same}/{len(sampled)}" if sampled
           else "")
        + f"; {eng.policy.decode_ticks} decode ticks, "
        f"{m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} s "
        f"(graphed: {r['metrics']['tokens_per_s']:.1f} tokens/s, wall "
        f"{r['metrics']['wall_s']:.2f} s)")


def phase_serve():
    """Serves the same 16 requests (prompts of 64-511 tokens, 32 new
    tokens each) with a bf16, an fp8 and an int8 pool; returns the runs
    and the kernel launches of each run, read just after it, by pool."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_paged
    cfg = get_config(ARCH)
    kw = dict(reduced=False, device="cuda", requests=16, gen=32, min_gen=32,
              min_prompt_len=64, seed=0, **ENGINE_KW)
    runs, counts = {}, {}
    for tag in ("bf16", "fp8", "int8"):
        ops.reset_launches()                   # the main path starts here
        runs[tag] = serve_paged(ARCH, kv_dtype=None if tag == "bf16"
                                else tag, **kw)
        counts[tag] = dict(ops.launches)       # ... and ends here
        _check_run(tag, runs[tag], cfg, counts[tag])
        _eager_engine(tag, runs[tag], cfg)
        gc.collect()
        torch.cuda.empty_cache()
        _graph_vs_eager(tag, runs[tag]["engine"])
        _check_tickets(f"{tag}: after the graphed runs",
                       [runs[tag]["engine"].policy._tickets,
                        *da._tickets.values()])
    for tag, r in runs.items():
        _tick_kernel_vs_plain(f"{tag} pool", r["engine"])
        if tag != "int8":
            _profile_tick(f"{tag} pool", r["engine"])
            _profile_graph_tick(f"{tag} pool", r["engine"])
    return runs, counts


def _decode_state(eng):
    """Inputs of one fixed-slot decode step: a token per slot and write
    positions spread from 40 to the scratch index (an idle slot)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    return (torch.randint(0, eng.cfg.vocab_size, (eng.B, 1), generator=gen,
                          device="cuda", dtype=torch.int32),
            torch.linspace(40, eng.max_len, eng.B).int().cuda())


def _decode_kernel_vs_plain(eng) -> float:
    """One decode step on the engine's cache with the kernels and with
    the plain versions; returns max |logits difference|."""
    from repro_torch.models import model as M
    tok, pos = _decode_state(eng)
    out = {}
    for impl in ("kernel", "plain"):
        logits, _ = M.decode_step(eng.params, eng.cfg, _clone(eng.cache),
                                  tok, pos, impl=impl)
        torch.cuda.synchronize()
        out[impl] = logits[:, -1]
    return _check_logits("serve-fixed", "decode step", out["kernel"],
                         out["plain"])


def _profile_decode_step(eng) -> None:
    """The steady fixed-slot decode step (8 slots, kernels, greedy tokens
    to the host) under ``_profile_steady``."""
    from repro_torch.models import model as M
    tok, pos = _decode_state(eng)
    cache = _clone(eng.cache)

    def step():
        logits, _ = M.decode_step(eng.params, eng.cfg, cache, tok, pos)
        return torch.argmax(logits[:, -1], dim=-1).cpu()
    _profile_steady("serve-fixed", "steady decode step, eager", step)


def _fixed_graph_vs_eager(eng, phase: str = "serve-fixed") -> None:
    """The fixed-slot engine's captured decode step replayed against
    ``M.decode_step`` run eagerly on the inputs of
    ``_decode_kernel_vs_plain`` and a copy of the same cache: logits and
    every cache byte must be bit-equal."""
    from repro_torch.models import model as M
    pol = eng.policy
    tok, pos = _decode_state(eng)
    cache = _clone(pol.cache)
    logits, _ = M.decode_step(pol.params, eng.cfg, cache, tok, pos)
    pol._feed.dev["tokens"].copy_(tok[:, 0])
    pol._feed.dev["pos"].copy_(pos)
    got = pol._decode_fn()
    pairs = {"logits": (got, logits[:, -1])}
    pairs.update({f"{p}.{k}": (pol.cache[p][k], cache[p][k])
                  for p in cache for k in cache[p]})
    _assert_bits("fixed-slot decode step", pairs)
    log(phase, f"decode step graph replay == eager, bit for bit "
        f"(logits, {len(pairs) - 1} cache tensors)")


def _profile_graph_decode_step(eng, phase: str = "serve-fixed",
                               what: str = "steady decode step",
                               groups=SERVING_GROUPS) -> tuple:
    """The fixed-slot engine's captured decode step replayed on the inputs
    of ``_profile_decode_step`` under ``_profile_steady`` (its busy time
    split over ``groups``).  Returns (wall, busy) in ms per step."""
    pol = eng.policy
    tok, pos = _decode_state(eng)
    pol._feed.dev["tokens"].copy_(tok[:, 0])
    pol._feed.dev["pos"].copy_(pos)
    return _profile_steady(
        phase, f"{what}, graph replay",
        lambda: torch.argmax(pol._decode_fn(), dim=-1).cpu(), groups=groups)


def phase_serve_fixed(paged: dict) -> dict:
    """The fixed-slot path at full width: the static batch of ``serve``,
    then a ``ServingEngine`` over the requests of the bf16 paged run
    ``paged`` (same weights, prompts and budgets).  Returns the kernel
    launches of the engine run, read just after it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.runtime.serving import ServingEngine
    cfg = get_config(ARCH)
    r = serve(ARCH, batch=4, prompt_len=128, gen=16, reduced=False,
              device="cuda")
    g = r["generated"]
    assert g.shape == (4, 16), g.shape
    assert ((g >= 0) & (g < cfg.vocab_size)).all(), \
        "serve: a token outside the vocabulary"
    log("serve-fixed", f"[serve] prefill={r['prefill_s'] * 1e3:.0f}ms "
        f"decode={r['decode_s'] * 1e3:.0f}ms "
        f"throughput={r['tokens_per_s']:.1f} tok/s (batch 4, prompt 128, "
        "16 new tokens)")

    reqs = sorted(paged["finished"], key=lambda q: q.rid)
    eng = ServingEngine(cfg, paged["engine"].params, slots=8,
                        max_len=MAX_LEN, device="cuda")
    for q in reqs:
        eng.submit(q.prompt, max_new_tokens=q.max_new_tokens)
    ops.reset_launches()                       # the main path starts here
    done = eng.run()
    counts = dict(ops.launches)                # ... and ends here
    assert len(done) == 16, f"fixed-slot: {len(done)} of 16 finished"
    for q in done:
        assert len(q.generated) == q.max_new_tokens == 32, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), \
            f"fixed-slot: rid {q.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), "fixed-slot: a logit was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    # per decode step the dense decode kernel once per layer; per prefill
    # the flash kernel once per layer; per model call the norms; no other
    # kernel
    L = cfg.num_layers
    want = {"decode_attention[bf16]": ticks * L,
            "flash_attention[causal]": prefills * L,
            **norm_launches(cfg, ticks + prefills)}
    assert counts == want, \
        f"fixed-slot: launches {counts}, expected {want} for {ticks} " \
        f"decode steps and {prefills} prefills"
    m = eng.metrics.snapshot()
    log("serve-fixed", f"engine: {m['completed']:.0f} requests "
        f"{m['generated_tokens']:.0f} tokens, {ticks} decode steps, "
        f"{prefills} prefills, {m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} s; "
        f"launches {json.dumps(counts)}")
    _decode_kernel_vs_plain(eng)
    _fixed_graph_vs_eager(eng)
    _check_tickets("fixed-slot: after the graphed run",
                   [eng.policy._tickets, *da._tickets.values()])
    _profile_decode_step(eng)
    _profile_graph_decode_step(eng)
    # information, not a gate: whole-prompt and chunked prefill round
    # bf16 differently, so greedy streams part at near-ties
    paged_gen = {q.rid: q.generated for q in reqs}
    equal = sum(a == b for q in done
                for a, b in zip(q.generated, paged_gen[q.rid]))
    lead = [next((i for i, (a, b) in enumerate(
        zip(q.generated, paged_gen[q.rid])) if a != b), 32) for q in done]
    log("serve-fixed", f"greedy tokens shared with the bf16 paged engine: "
        f"{equal}/512 position-wise, {sum(x == 32 for x in lead)}/16 "
        f"streams identical, first divergence at mean token "
        f"{sum(lead) / 16:.1f}")
    return counts


# ---------------------------------------------------------------------------
# phase telemetry
# ---------------------------------------------------------------------------

TEL_MODES = ("off", "on", "profiled")
TEL_REPS = 5                   # interleaved engine runs per mode and pool
STEADY_TICKS = 5               # ticks in each profiled / sync-counted window
TEL_DIR = ROOT / "build" / "telemetry"     # the trace export, the postmortem


def _telemetry(mode: str):
    from repro_torch.runtime.telemetry import Telemetry
    return {"off": None, "on": Telemetry(ring=4096),
            "profiled": Telemetry(profile=True)}[mode]


def _tel_engine(cfg, params, tag: str, mode: str, requests):
    """A graphed paged engine with the phase-4 configuration and a ``tag``
    pool, ``mode`` telemetry, and ``requests`` submitted."""
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, kv_dtype=None if tag == "bf16"
                             else tag, telemetry=_telemetry(mode),
                             device="cuda", **ENGINE_KW)
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    return eng


def _to_steady(eng) -> None:
    """Step ``eng`` until its next tick admits and prefills nothing: every
    request is seated and decoding."""
    while eng.queue or any(r.prefill_pos < len(r.prefill_src)
                           for r in eng.seats.values()):
        eng.step()


def _window_kernels(eng) -> tuple:
    """(kernels by name, memory copies, ``fused_decode_tick`` ranges) of
    STEADY_TICKS engine ticks under torch.profiler.  The profiler lists
    each range's span on the device (a user annotation) among the device
    events; it is not a kernel and is not counted as one."""
    torch.cuda.synchronize()           # nothing of earlier ticks in flight
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEADY_TICKS):
            assert eng.seats, "the steady window outlived the requests"
            eng.step()
        torch.cuda.synchronize()
    dev = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA
           and a.self_device_time_total > 0]
    copies = sum(a.count for a in dev if a.key.startswith(("Memcpy",
                                                           "Memset")))
    names = Counter()
    for a in dev:
        if a.key != "fused_decode_tick" and not a.key.startswith(
                ("Memcpy", "Memset")):
            names[a.key] += a.count
    ranges = sum(1 for e in prof.events() if e.name == "fused_decode_tick"
                 and e.device_type == torch.autograd.DeviceType.CPU)
    return names, copies, ranges


def _name_diff(a: Counter, b: Counter) -> dict:
    """Kernels whose counts differ between windows ``a`` and ``b``, as
    a's count less b's, by name cut to 60 characters."""
    return {k[:60]: a[k] - b[k] for k in sorted(set(a) | set(b))
            if a[k] != b[k]}


def _window_syncs(eng) -> Counter:
    """Synchronizing CUDA calls made by STEADY_TICKS engine ticks, counted
    under ``torch.cuda.set_sync_debug_mode("warn")`` by the file and line
    that made them.  Only calls inside the ticks count: the first switch
    into the mode makes one of its own."""
    import traceback
    import warnings
    seen = Counter()
    inside = False

    def record(message, category, filename, lineno, file=None, line=None):
        if inside and "synchroniz" in str(message):
            f = [f for f in traceback.extract_stack()[:-1]
                 if Path(f.filename).name != "warnings.py"][-1]
            seen[f"{Path(f.filename).name}:{f.lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(STEADY_TICKS):
                assert eng.seats, "the steady window outlived the requests"
                inside = True
                eng.step()
                inside = False
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return seen


def _tel_identity(cfg, params, tag: str, requests, want) -> dict:
    """The 16 requests through graphed engines with telemetry off, on and
    profiling: tokens and flat traces equal to each other and to phase
    4's run ``want`` (streams, trace), launch counts as phase 4's, and in
    a steady window the same kernels, copies and synchronizing calls per
    tick, with the ``fused_decode_tick`` ranges only when profiling.
    torch.profiler's window now and then counts a few kernels more or
    fewer than another run of the same ticks: while no (kernels, copies)
    was counted by some run of every mode, each mode that never counted
    the value most modes counted is run again, up to PROFILE_TRIES runs
    of a mode in all.  A real difference recurs on every run and fails the
    check; a mode that is run again logs the kernels, by name, that part
    it from that value.  Returns the telemetry-on engine."""
    from repro_torch.kernels import ops
    # each mode's runs: (kernels, copies, syncs, ranges, kernels by name)
    runs = {m: [] for m in TEL_MODES}

    def measure(mode: str):
        ops.reset_launches()                   # the main path starts here
        eng = _tel_engine(cfg, params, tag, mode, requests)
        _to_steady(eng)
        # no collection of an earlier engine's graphs inside a window
        gc.collect()
        syncs = _window_syncs(eng)
        gc.collect()
        names, copies, ranges = _window_kernels(eng)
        done = eng.run()
        counts = dict(ops.launches)            # ... and ends here
        _check_run(tag, {"engine": eng, "finished": done,
                         "metrics": eng.metrics.snapshot()}, cfg, counts,
                   phase="telemetry")
        streams = {q.rid: q.generated for q in done}
        assert streams == want[0], f"{tag}/{mode}: streams differ from " \
            "phase 4's run"
        assert eng.trace == want[1], f"{tag}/{mode}: trace differs from " \
            "phase 4's run"
        kernels = sum(names.values())
        runs[mode].append((kernels, copies, syncs, ranges, names))
        log("telemetry", f"{tag}/{mode}: streams and flat trace equal to "
            f"phase 4's; steady window of {STEADY_TICKS} ticks: "
            f"{kernels / STEADY_TICKS:.1f} kernels, "
            f"{copies / STEADY_TICKS:.1f} copies, "
            f"{sum(syncs.values()) / STEADY_TICKS:.1f} synchronizing calls "
            f"per tick ({json.dumps(dict(syncs))}), {ranges} "
            "fused_decode_tick ranges")
        return eng

    def agreed():
        """The (kernels, copies) some run of every mode counted, or None."""
        common = set.intersection(*({w[:2] for w in runs[m]}
                                    for m in TEL_MODES))
        return max(common) if common else None

    for mode in TEL_MODES:
        eng = measure(mode)
        if mode == "on":
            on = eng
        del eng
    for _ in range(PROFILE_TRIES - 1):
        if agreed() is not None:
            break
        tally = Counter(c for m in TEL_MODES
                        for c in {w[:2] for w in runs[m]})
        top = max(tally, key=lambda c: (tally[c], c))
        names = next(w[4] for m in TEL_MODES for w in runs[m]
                     if w[:2] == top)
        for mode in TEL_MODES:
            last = runs[mode][-1]
            if any(w[:2] == top for w in runs[mode]):
                continue
            log("telemetry", f"{tag}/{mode}: counted (kernels, copies) "
                f"{last[:2]} where other runs counted {top}; kernels "
                f"counted more (+) or fewer (-): "
                f"{json.dumps(_name_diff(last[4], names))}; running it again")
            eng = measure(mode)
            if mode == "on":
                on = eng
            del eng
    assert agreed() is not None, \
        f"{tag}: no (kernels, copies) over {STEADY_TICKS} ticks counted " \
        "by a run of every mode: " + "; ".join(
            f"{m} {[w[:2] for w in runs[m]]}, kernels against off's first "
            f"run {json.dumps(_name_diff(runs[m][-1][4], runs['off'][0][4]))}"
            for m in TEL_MODES)
    syncs = runs["off"][0][2]
    for mode in TEL_MODES:
        for w in runs[mode]:
            assert w[2] == syncs, f"{tag}: {mode} synchronizing calls " \
                f"{dict(w[2])} != off's {dict(syncs)} over {STEADY_TICKS} " \
                "ticks"
    assert sum(syncs.values()) >= STEADY_TICKS, \
        f"{tag}: {dict(syncs)} synchronizing calls counted over " \
        f"{STEADY_TICKS} ticks; the token pull alone is one per tick"
    assert all(w[3] == 0 for m in ("off", "on") for w in runs[m])
    assert all(w[3] == STEADY_TICKS for w in runs["profiled"]), \
        f"{tag}: {[w[3] for w in runs['profiled']]} fused_decode_tick " \
        f"ranges in {STEADY_TICKS} profiled ticks"
    return on


def _tel_export(tag: str, eng) -> None:
    """The recorder of the telemetry-on engine: its events project onto
    the flat trace, and its Perfetto export validates and holds a
    prefill and a decode span for every request."""
    from repro_torch.runtime.telemetry import (build_spans,
                                               validate_chrome_trace,
                                               write_perfetto)
    tel = eng.telemetry
    events = tel.events()
    assert tel.recorder.dropped == 0, f"{tag}: the ring dropped events"
    assert [(e.tick, e.kind, e.rid) for e in events
            if e.kind != "submit"] == eng.trace, \
        f"{tag}: recorder events do not project onto the flat trace"
    path = TEL_DIR / f"trace_{tag}.json"
    write_perfetto(str(path), events)
    doc = json.loads(path.read_text())
    errors = validate_chrome_trace(doc)
    assert errors == [], f"{tag}: Perfetto export invalid: {errors[:5]}"
    spans = build_spans(events)["spans"]
    for name in ("prefill", "decode"):
        rids = {s["rid"] for s in spans if s["name"] == name}
        assert rids == set(range(16)), f"{tag}: {name} spans for {rids}"
    log("telemetry", f"{tag}: {len(events)} events, none dropped; Perfetto "
        f"export {path.relative_to(ROOT)} valid ({len(doc['traceEvents'])} "
        f"trace events, {len(spans)} spans)")


def _tel_metrics_server(eng) -> None:
    """A ``MetricsServer`` on port 0 over the engine's metrics serves
    every family of the exposition."""
    import urllib.request
    from repro_torch.runtime.telemetry import MetricsServer, prometheus_text
    srv = MetricsServer(lambda: prometheus_text({ARCH: eng.metrics}), port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            text = resp.read().decode()
    finally:
        srv.close()
    assert text == prometheus_text({ARCH: eng.metrics})
    families = [ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")]
    for fam in ("repro_requests_completed_total", "repro_tokens_decode_total",
                "repro_ticks_total", "repro_pages_in_use",
                "repro_ttft_seconds", "repro_tbt_seconds"):
        assert fam in families, f"metrics server: no {fam}"
    assert f'repro_requests_completed_total{{engine="{ARCH}"}} 16' in text
    log("telemetry", f"metrics server on port {srv.port}: {len(families)} "
        f"families, {len(text.splitlines())} lines, equal to "
        "prometheus_text")


def _tel_stall(cfg, params, requests) -> None:
    """A forced stall (3 ticks for 16 requests) raises and writes a
    postmortem that names every stalled rid and holds a consistent
    ``BlockManager`` partition."""
    from repro_torch.runtime.serving import (PagedServingEngine,
                                             SchedulerStallError)
    from repro_torch.runtime.telemetry import Telemetry
    path = TEL_DIR / "postmortem.json"
    eng = PagedServingEngine(cfg, params, device="cuda", telemetry=Telemetry(
        ring=4096, postmortem_path=str(path)), **ENGINE_KW)
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    try:
        eng.run(max_ticks=3)
    except SchedulerStallError:
        pass
    else:
        raise AssertionError("run(max_ticks=3) did not stall")
    pm = json.loads(path.read_text())
    pending = sorted(q.rid for q in [*eng.queue, *eng.seats.values()])
    state = pm["engines"]["engine"]
    named = sorted({r["rid"] for r in state["queue"]}
                   | {r["rid"] for r in state["seats"].values()})
    assert named == pending and pending, (named, pending)
    for rid in pending:
        assert f"{rid}(standard)" in pm["reason"], rid
    bm = state["block_manager"]
    assert bm["partition_ok"] is True, "postmortem: pages not partitioned"
    assert len(bm["free"]) + len(bm["reclaimable"]) + \
        len(bm["live_refcounts"]) == bm["capacity"]
    log("telemetry", f"forced stall: postmortem {path.relative_to(ROOT)} "
        f"names the {len(pending)} stalled rids ({len(state['seats'])} "
        f"seated, {len(state['queue'])} queued), {bm['in_use']} pages in "
        f"use, partition consistent, "
        f"{pm['flight_recorder']['total']} events recorded")


def _tel_reps(cfg, params, tag: str, requests) -> None:
    """TEL_REPS interleaved runs of each mode on fresh engines: tokens/s
    with telemetry on over off (information, not a gate) and the tick
    profiler's phase table, summed over the profiled runs."""
    from repro_torch.runtime.telemetry import TickProfiler
    tps = {mode: [] for mode in TEL_MODES}
    prof = TickProfiler()
    for rep in range(TEL_REPS):
        for mode in TEL_MODES if rep % 2 == 0 else TEL_MODES[::-1]:
            eng = _tel_engine(cfg, params, tag, mode, requests)
            done = eng.run()
            assert len(done) == 16
            tps[mode].append(eng.metrics.snapshot()["tokens_per_s"])
            if mode == "profiled":
                p = eng.telemetry.profiler
                for phase, t in p.totals.items():
                    prof.totals[phase] = prof.totals.get(phase, 0.0) + t
                    prof.calls[phase] = prof.calls.get(phase, 0) + \
                        p.calls[phase]
                prof.ticks += p.ticks
            del eng, done
            gc.collect()
    med = {mode: statistics.median(v) for mode, v in tps.items()}
    pair = statistics.median(on / off for on, off in zip(tps["on"],
                                                         tps["off"]))
    log("telemetry", f"{tag}: tokens/s over {TEL_REPS} interleaved runs "
        + "; ".join(f"{mode} {', '.join(f'{x:.1f}' for x in v)}"
                    for mode, v in tps.items()))
    log("telemetry", f"{tag}: on/off tokens/s ratio {med['on'] / med['off']:.4f}"
        f" (medians; median of paired ratios {pair:.4f}), profiled/off "
        f"{med['profiled'] / med['off']:.4f} (information, not a gate)")
    snap = prof.snapshot()
    decode_ticks = snap["phases"]["decode/dispatch"]["calls"]
    log("telemetry", f"{tag}: tick-phase profile over {snap['ticks']} ticks "
        f"({decode_ticks} fused decode ticks) of {TEL_REPS} runs:")
    for phase, ph in snap["phases"].items():
        log("telemetry", f"{tag}:   {phase:<16} {ph['total_s'] * 1e3:9.2f} ms"
            f" total {ph['total_s'] * 1e3 / ph['calls']:7.3f} ms per call "
            f"x{ph['calls']:<5} {ph['share'] * 100:5.1f}%")


def phase_telemetry(params, requests, want: dict) -> None:
    """The telemetry plane on the graphed paged engine at full width, with
    a bf16 and an fp8 pool: ``params`` and ``requests`` (prompt, budget)
    are phase 4's, ``want`` its streams and traces by pool."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    TEL_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for tag in ("bf16", "fp8"):
        on = _tel_identity(cfg, params, tag, requests, want[tag])
        _tel_export(tag, on)
        if tag == "bf16":
            _tel_metrics_server(on)
        del on
        gc.collect()
        torch.cuda.empty_cache()
    _tel_stall(cfg, params, requests)
    gc.collect()
    t1 = time.perf_counter()
    for tag in ("bf16", "fp8"):
        _tel_reps(cfg, params, tag, requests)
    torch.cuda.empty_cache()
    log("telemetry", f"phase times: checks {t1 - t0:.1f} s, interleaved runs "
        f"{time.perf_counter() - t1:.1f} s")


# ---------------------------------------------------------------------------
# phase fleet
# ---------------------------------------------------------------------------

# the fleet's engines take the paged engines' knobs; the pools come from
# the fleet's budget.  Run A's budget holds 3 engines x 8 seats x 34 pages
# (no engine can preempt); Run B's the two floors and 40 pages more
FLEET_KW = {k: v for k, v in ENGINE_KW.items() if k != "num_pages"}
FLEET_A = ((ARCH, 2, None), (LLAMA, 1, None))
FLEET_B = ((ARCH, 1, None), (LLAMA, 1, "fp8"))
FLEET_PAGES_A = 840
FLEET_SURPLUS_B = 40
FLEET_REQUESTS = 24
FLEET_DIR = ROOT / "build" / "fleet"      # the trace export, the postmortem


def _fleet_weights() -> dict:
    """qwen3-1.7b and llama3-8b at full width, model ``i`` from a
    ``torch.Generator`` seeded with ``i`` on the card (``serve_fleet``'s
    seeding at seed 0, so qwen3-1.7b has phase 4's weights), each drawn
    in f32 and cast for compute before the next is drawn: no f32 tree
    outlives its turn.  Returns arch -> (cfg, the cast tree)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import cast_for_compute
    out = {}
    for i, arch in enumerate((ARCH, LLAMA)):
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(i)
        out[arch] = (cfg, cast_for_compute(
            M.init_params(M.param_specs(cfg), gen, device="cuda"),
            M.compute_dtype(cfg)))
        gc.collect()
    return out


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _fleet_requests(weights) -> list:
    """FLEET_REQUESTS requests alternating between the two models:
    prompts of 64-511 tokens, exactly 32 new tokens each."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(FLEET_REQUESTS):
        arch = (ARCH, LLAMA)[i % 2]
        vocab = weights[arch][0].vocab_size
        out.append((arch, rng.integers(0, vocab, int(rng.integers(
            64, 512))).astype(np.int32), 32))
    return out


def _fleet(weights, spec, total_pages: int, **kw):
    """A ``ModelFleet`` on the card of ``spec`` (arch, replicas, kv dtype)
    over the cast trees of ``weights``, with the paged engines' knobs."""
    from repro_torch.runtime.router import FleetModel, ModelFleet
    return ModelFleet([FleetModel(arch, *weights[arch], replicas=n,
                                  kv_dtype=dt) for arch, n, dt in spec],
                      total_pages=total_pages, device="cuda", **FLEET_KW,
                      **kw)


def _fleet_submit(fleet, requests, sampling, premium_every: int = 0):
    for i, (arch, prompt, n) in enumerate(requests):
        prem = premium_every and i % premium_every == 0
        fleet.submit(model=arch, prompt=prompt, max_new_tokens=n,
                     sampling=sampling,
                     priority="premium" if prem else "standard")


def _fleet_tickets(fleet) -> list:
    from repro_torch.kernels import decode_attention as da
    return [eng.policy._tickets for _, _, eng in fleet._engines()] + \
        list(da._tickets.values())


def _fleet_launches(fleet) -> dict:
    """The launches a fleet run must have made, summed over its engines:
    each engine's attention kernel (by its pool) once per layer per
    replay of its tick graph, and per replay of either graph (a decode
    tick or a prefill chunk) its model's norms."""
    want = Counter()
    for _, _, eng in fleet._engines():
        cfg, ticks = eng.cfg, eng.policy.decode_ticks
        chunks = sum(1 for _, ev, _ in eng.trace if ev == "prefill_chunk")
        kv = eng.kv_dtype
        want["paged_decode_attention[bf16]" if kv == "bf16"
             else f"quantized_paged_decode_attention[{kv}]"] += \
            ticks * cfg.num_layers
        want.update(norm_launches(cfg, ticks + chunks))
    return dict(want)


def _check_fleet_run(tag: str, fleet, requests, counts: dict) -> dict:
    """Every request finished on a replica of its model with its budget
    of tokens, all in its model's vocabulary; every engine's logits
    finite; the launches ``counts`` read just after the run equal the
    sum over engines of its graph replays' (``_fleet_launches``); the
    split tickets back at 0.  Returns rid -> generated."""
    done = fleet.finished()
    assert sorted(done) == list(range(len(requests))), \
        f"{tag}: {len(done)} of {len(requests)} requests finished"
    for rid, (arch, _, n) in enumerate(requests):
        assert fleet.route(rid)[0] == arch, (tag, rid)
        gen = done[rid].generated
        vocab = fleet.group(arch).cfg.vocab_size
        assert len(gen) == n, (tag, rid, len(gen))
        assert all(0 <= t < vocab for t in gen), \
            f"{tag}: rid {rid} emitted a token outside {arch}'s vocabulary"
    for name, i, eng in fleet._engines():
        assert bool(eng.policy.logits_finite), \
            f"{tag}: {name}/{i}: a logit was not finite"
    want = _fleet_launches(fleet)
    assert counts == want, f"{tag}: launches {counts}, expected {want}"
    _check_tickets(f"{tag}: after the run", _fleet_tickets(fleet))
    for name, i, eng in fleet._engines():
        m = eng.metrics.snapshot()
        log("fleet", f"{tag}: {name}/{i} ({eng.kv_dtype} pool, "
            f"{eng.bm.capacity} pages): {m['completed']:.0f} requests, "
            f"{eng.policy.decode_ticks} decode ticks, "
            f"{m['preemptions']:.0f} preemptions, peak "
            f"{m['peak_pages_in_use']:.0f} pages")
    log("fleet", f"{tag}: {fleet._tick} fleet ticks; launches "
        f"{json.dumps(counts)} equal the sum over engines of their graph "
        "replays; split tickets back at 0")
    return {rid: q.generated for rid, q in done.items()}


def _report_fleet(tag: str, fleet) -> None:
    """Fleet and per-model tokens/s and mean TTFT (information)."""
    m = fleet.metrics_snapshot()
    f = m["fleet"]
    log("fleet", f"{tag}: fleet {f['generated_tokens']:.0f} tokens, "
        f"{f['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{f['ttft_avg_s'] * 1e3:.1f} ms, wall {f['wall_s']:.2f} s")
    for name, mm in m["models"].items():
        log("fleet", f"{tag}:   {name} x{len(mm['replicas'])}: "
            f"{mm['tokens_per_s']:.1f} tokens/s, mean TTFT "
            f"{mm['ttft_avg_s'] * 1e3:.1f} ms, preemptions "
            f"{mm['preemptions']:.0f}")


def _fleet_identity(weights, requests, sampling) -> dict:
    """Run A: the fleet of FLEET_A with bf16 pools and a budget in which
    no engine preempts, ``requests`` sampled at temperature 0.9: the
    checks of ``_check_fleet_run``, no preemption, both qwen3-1.7b
    replicas on the storage of the one cast tree, the llama3-8b replica's
    graphs against its functions run eagerly (bit for bit), K1/K2 at its
    shapes (``_llama_attention``) and its tick with the kernels against
    the plain versions and the f32 tick (``_tick_vs_f32``).  Returns the
    streams."""
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A)
    pools = sum(_tree_bytes(eng.cache) for _, _, eng in fleet._engines())
    held = sum(_tree_bytes(w[1]) for w in weights.values())
    alloc = torch.cuda.memory_allocated()
    # an f32 copy of either model's matmul weights would be >= 6.8 GB
    assert alloc < held + pools + 4 * 2 ** 30, \
        f"run A: {alloc / 2 ** 30:.2f} GiB allocated for " \
        f"{(held + pools) / 2 ** 30:.2f} GiB of weights and pools"
    log("fleet", f"run A built: weights {held / 2 ** 30:.2f} GiB, pools "
        f"{pools / 2 ** 30:.2f} GiB, {alloc / 2 ** 30:.2f} GiB allocated "
        "(no f32 copy of a weight is alive)")
    ops.reset_launches()                       # the main path starts here
    _fleet_submit(fleet, requests, sampling)
    fleet.run()
    counts = dict(ops.launches)                # ... and ends here
    streams = _check_fleet_run("run A", fleet, requests, counts)
    for name, i, eng in fleet._engines():
        assert eng.metrics.preemptions == 0, \
            f"run A: {name}/{i} preempted; the budget was sized for none"
    for arch in (ARCH, LLAMA):
        want = [t.data_ptr() for t in tree_leaves(weights[arch][1])]
        for i, eng in enumerate(fleet.group(arch).engines):
            got = [t.data_ptr() for t in tree_leaves(eng.params)]
            assert got == want, f"run A: {arch}/{i} holds its own weights"
    log("fleet", f"run A: both {ARCH} replicas and the {LLAMA} replica "
        "hold the storage of their model's one cast tree (data_ptr of "
        "every leaf)")
    _report_fleet("run A", fleet)
    llama = fleet.group(LLAMA).engines[0]
    _graph_vs_eager(f"{LLAMA}/0", llama, phase="fleet")
    _model_attention(llama.cfg, "fleet", _seat_lengths(llama),
                     llama.policy.n_tables)
    _tick_vs_f32(f"{LLAMA}/0", llama)
    _check_tickets("run A: after the llama3-8b checks", _fleet_tickets(fleet))
    return streams


def _window_mask(lengths: torch.Tensor, width: int, window) -> torch.Tensor:
    """(B, 1, 1, width) keep-mask of single-query decode: keys t <
    lengths[b], and t >= lengths[b] - window with a window."""
    t = torch.arange(width, device=lengths.device)[None, :]
    keep = t < lengths[:, None].long()
    if window is not None:
        keep &= t >= lengths[:, None].long() - window
    return keep[:, None, None, :]


def _model_window(cfg):
    """The sliding window of ``cfg``'s local layers, None without any."""
    return cfg.sliding_window if layer_counts(cfg)[1] else None


def _model_attention(cfg, phase: str, seats, n_table: int,
                     flush=None, pools=("bf16", "fp8"),
                     row_key=None) -> dict:
    """K1 and K2 against their plain versions at the shapes ``cfg``'s
    model gives them: bf16 queries of its heads over its kv heads at its
    head dim (llama3-8b: 32 over 8 of d 128, GQA group 4; qwen2-moe-a2.7b:
    16 over 16 of d 128, group 1; gemma3-12b: 16 over 8 of d 256, group
    2; minicpm-2b: 36 over 36 of d 64, group 1), seats of ``seats``
    tokens in tables of ``n_table`` pages, over each pool of ``pools``
    (bf16, fp8, int8), within BF16_ATOL/RTOL; on a model with
    sliding-window layers with its window and without; the tickets back
    at 0.  With ``flush`` each is timed beside its plain version, its
    bound and SDPA over the gathered cache with the same mask, and the
    windowed ones' rows are returned, and with ``row_key`` the
    unwindowed ones' too, as ``<kernel>[<pool>,<row_key>]``."""
    from repro_torch.core.mixed_precision import (dequantize_kv_page,
                                                  quantize_kv_page)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(4)
    heads, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    W = _model_window(cfg)
    seats = [int(n) for n in seats]
    P, table, lengths, q = _paged_inputs(gen, seats, n_table, heads, d)
    A = len(seats)
    shape = (P, PAGE, kvh, d)
    k, v = (torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    stored = {}
    for dt in pools:
        if dt == "bf16":
            stored[dt] = (k.bfloat16(), v.bfloat16(), None, None)
        else:
            (kq, ks), (vq, vs) = (quantize_kv_page(k, dt),
                                  quantize_kv_page(v, dt))
            stored[dt] = (kq, vq, ks, vs)
    del k, v
    rows = {}
    for dt, (kp, vp, ksc, vsc) in stored.items():
        name = ("paged_decode_attention" if ksc is None
                else "quantized_paged_decode_attention")
        for window in ((W, None) if W else (None,)):
            def run(impl, kp=kp, vp=vp, ksc=ksc, vsc=vsc, window=window):
                return ops.paged_decode_attention(
                    q, kp, vp, table, lengths, k_scale=ksc, v_scale=vsc,
                    window=window, impl=impl)
            tag = f"{name}[{dt}{',window' if window else ''}]"
            got = run("kernel")
            torch.cuda.synchronize()
            err = check_close(f"{cfg.name} {tag}", got, run("plain"),
                              BF16_ATOL, BF16_RTOL)
            what = (f"{cfg.name} {tag} H={heads} KVH={kvh} d={d}, lengths "
                    f"{seats}: max|err| {err:.3e}")
            if flush is None:
                log(phase, what)
                continue
            pt = table.long()
            kg, vg = kp[pt], vp[pt]
            if ksc is not None:
                kg = dequantize_kv_page(kg, ksc[pt]).bfloat16()
                vg = dequantize_kv_page(vg, vsc[pt]).bfloat16()
            kg, vg = (t.reshape(A, -1, kvh, d).transpose(1, 2)
                      .repeat_interleave(heads // kvh, dim=1).contiguous()
                      for t in (kg, vg))
            ms = cuda_ms(lambda: run("kernel"), flush)
            plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
            mask = _window_mask(lengths, kg.shape[2], window)
            lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION,
                                          q.transpose(1, 2), kg, vg,
                                          attn_mask=mask), flush)
            del kg, vg
            kept = int((lengths.clamp(max=W) if window else lengths).sum())
            nbytes = (2 * kept * kvh * d * kp.element_size()
                      + (2 * kept * kvh * 4 if ksc is not None else 0)
                      + 2 * q.numel() * q.element_size()
                      + table.numel() * 4 + lengths.numel() * 4)
            b_ms, b_by = bound(nbytes, 4.0 * kept * heads * d)
            log(phase, f"{what} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"{SDPA_EFF} {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
                f"{nbytes / 1e6:.2f} MB, {kept} keys)")
            if window or row_key:
                rows[tag if window else f"{name}[{dt},{row_key}]"] = dict(
                    name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    library=SDPA_EFF)
    _check_tickets(f"{cfg.name} paged decode", da._tickets.values())
    if flush is not None:
        splits, chunk = da.split_plan(A, kvh, n_table * PAGE, _sms())
        log(phase, f"{cfg.name} paged decode: {splits} splits of {chunk} "
            "tokens (the plan of the whole table, window or not); tickets "
            "back at 0")
    return rows


def _seat_lengths(eng) -> list:
    """The lengths of ``_tick_state(eng)``'s seats (41 to the table's
    end)."""
    return (_tick_state(eng)["pos"] + 1).tolist()


# the bf16 tick with the kernels may lie no further from the f32 tick of
# the same weights and pool than the plain versions' bf16 tick lies, up to
# this factor, in every seat's RMS over its logits and in the largest
# difference
TICK_F32_RATIO = 1.5


def _first_layers(params, cache, cfg, layers: int):
    """The model cut to its first ``layers`` layers (widths unchanged; a
    whole number of periods): views of the stacked weights and pool, and
    the config."""
    import dataclasses
    from repro_torch.tree import tree_map
    g, rest = divmod(layers, cfg.scan_period())
    assert g and not rest, f"{layers} layers: periods of {cfg.scan_period()}"
    return (dict(params, blocks=tree_map(lambda t: t[:g],
                                         params["blocks"])),
            {p: {k: t[:g] for k, t in ent.items()}
             for p, ent in cache.items()},
            dataclasses.replace(cfg, num_layers=layers))


@contextlib.contextmanager
def _routes(record=None, replay=None):
    """``moe.route`` watched: with ``record`` (a list), each call's top-k
    ids are appended to it; with ``replay``, the i-th call takes the ids
    of the i-th recorded call, weighted by its own probabilities there
    (renormalised), so two runs route alike and differ only in their
    arithmetic.  Every recorded call must be replayed."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod.route
    used = []

    def watched(p, m, xt):
        probs, weights, idx = route(p, m, xt)
        if record is not None:
            record.append(idx)
        if replay is not None:
            idx = replay[len(used)]
            used.append(idx)
            weights = probs.gather(-1, idx)
            weights = weights / weights.sum(dim=-1, keepdim=True)
        return probs, weights, idx
    moe_mod.route = watched
    try:
        yield
    finally:
        moe_mod.route = route
    assert replay is None or len(used) == len(replay), \
        f"routes: {len(used)} of {len(replay)} recorded calls replayed"


def _tick_vs_f32(tag: str, eng, phase: str = "fleet", wide=None) -> None:
    """The fused tick with the kernels against the plain versions, where
    bf16 roundings compounded over many layers leave both some way from
    the exact tick: each bf16 tick is held to the f32 tick (plain
    versions) of the same weights and pool widened, and the kernels' may
    be no further from it than TICK_F32_RATIO times the plain versions'.
    A planted fault (the kernels' attention missing every seat's last
    page) must fail both the per-seat limit and the largest-difference
    one.  An MoE's bf16 ticks route each token to the experts the f32
    tick chose (``_routes``), so a rounding cannot flip the router.
    ``wide``, the f32 weights of the model's first L layers, cuts the
    model to those L layers (a model whose f32 weights do not fit beside
    its bf16 ones)."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map
    state = _tick_state(eng)
    params, pool, cfg = eng.params, eng.policy.cache, eng.cfg
    if wide is not None:
        params, pool, cfg = _first_layers(params, pool, cfg,
                                          wide["blocks"]["pos0"]["ln1"]
                                          .shape[0] * cfg.scan_period())
    routes = []

    def bf16(impl):
        with _routes(replay=routes):
            return _tick(eng, _clone(pool), state, impl, params, cfg)[1]
    widened = wide if wide is not None else tree_map(lambda t: t.float(),
                                                     params)
    with _routes(record=routes):
        lf = _tick(eng, {p: {k: t.float() for k, t in ent.items()}
                         for p, ent in pool.items()}, state, "plain",
                   widened, dataclasses.replace(cfg,
                                                compute_dtype="float32"))[1]
    del widened
    gc.collect()

    def ratios(lk, lp):
        assert bool(torch.isfinite(lk).all()), f"{tag}: non-finite logits"
        ek, ep = (lk - lf).abs(), (lp - lf).abs()
        rows = (ek.square().mean(-1).sqrt() / ep.square().mean(-1).sqrt())
        return rows, ek.max().item() / ep.max().item(), ek, ep
    lp = bf16("plain")
    lk = bf16("kernel")
    rows, peak, ek, ep = ratios(lk, lp)
    attention = ops.paged_decode_attention

    def dropped_page(q, k, v, table, lengths, **kw):
        if kw.get("impl") == "plain":
            return attention(q, k, v, table, lengths, **kw)
        return attention(q, k, v, table, torch.clamp(lengths - PAGE, min=1),
                         **kw)
    ops.paged_decode_attention = dropped_page
    try:
        bad_rows, bad_peak, _, _ = ratios(bf16("kernel"), lp)
    finally:
        ops.paged_decode_attention = attention
    scale = lf.abs().max().item()
    pinned = (f", every bf16 tick routed as the f32 tick ({len(routes)} "
              "router calls)" if routes else "")
    log(phase, f"{tag}: bf16 fused tick against the f32 tick (largest "
        f"|logit| {scale:.3e}{pinned}): kernels max|Δ| "
        f"{ek.max().item():.3e}, "
        f"plain max|Δ| {ep.max().item():.3e} (ratio {peak:.3f}); per seat "
        f"RMS ratio kernels/plain {[round(r, 3) for r in rows.tolist()]}; "
        f"kernels vs plain max|Δ| {(lk - lp).abs().max().item():.3e}; "
        f"greedy tokens equal to the f32 tick's: kernels "
        f"{int((lk.argmax(-1) == lf.argmax(-1)).sum())}/{len(lf)}, plain "
        f"{int((lp.argmax(-1) == lf.argmax(-1)).sum())}/{len(lf)}")
    log(phase, f"{tag}: planted fault [last page dropped]: per seat RMS "
        f"ratio {[round(r, 3) for r in bad_rows.tolist()]}, max ratio "
        f"{bad_peak:.3f}")
    assert rows.max().item() <= TICK_F32_RATIO and peak <= TICK_F32_RATIO, \
        f"{tag}: the kernels' bf16 tick lies further from the f32 tick " \
        f"than {TICK_F32_RATIO}x the plain versions' (per seat " \
        f"{rows.tolist()}, largest {peak:.3f})"
    fails = (bad_rows.max().item() > TICK_F32_RATIO,
             bad_peak > TICK_F32_RATIO)
    assert all(fails), \
        f"{tag}: a planted fault passes the f32 tick test (per seat, " \
        f"largest difference: {fails})"


def _fleet_llama_f32(weights, requests) -> None:
    """llama3-8b's kernels (K1 at GQA group 4, K3 and its fused forms at
    D = 4096) against the plain versions where the comparison is fair:
    in f32 (the cast weights widened, f32 pools), 8 of Run A's llama3-8b
    prompts teacher-forced through prefill chunks and 31 fused ticks,
    phase f32's method: every decided position's top-1 equal and at
    least F32_MIN_DECIDED of the positions decided."""
    import dataclasses
    from repro_torch.tree import tree_map
    cfg, params = weights[LLAMA]
    wide = tree_map(lambda t: t.float(), params)
    prompts = [p for arch, p, _ in requests if arch == LLAMA][:8]
    _f32_paged_teacher_forced(
        dataclasses.replace(cfg, compute_dtype="float32"), wide, prompts,
        what=f"{LLAMA} fused tick (paged, f32 pool)", phase="fleet")


def _fleet_solo(weights, requests, streams, sampling) -> None:
    """Each model's requests of Run A on a solo graphed engine, submitted
    with the fleet's rids: the streams must equal the fleet's bit for
    bit, with no preemption."""
    from repro_torch.runtime.serving import PagedServingEngine
    for arch in (ARCH, LLAMA):
        cfg, params = weights[arch]
        eng = PagedServingEngine(cfg, params, device="cuda", **ENGINE_KW)
        mine = [(rid, p, n) for rid, (a, p, n) in enumerate(requests)
                if a == arch]
        for rid, p, n in mine:
            eng.submit(p, max_new_tokens=n, sampling=sampling, rid=rid)
        solo = {q.rid: q.generated for q in eng.run()}
        assert eng.metrics.preemptions == 0, f"solo {arch} preempted"
        diff = [rid for rid, _, _ in mine if solo[rid] != streams[rid]]
        assert not diff, f"{arch}: fleet and solo streams differ for {diff}"
        _check_tickets(f"solo {arch}", [eng.policy._tickets])
        log("fleet", f"solo {arch} engine over its {len(mine)} requests "
            "with the fleet's rids: streams equal to run A's, bit for bit")
        del eng
        gc.collect()


def _fleet_budget(weights, requests) -> None:
    """Run B: qwen3-1.7b with a bf16 pool and llama3-8b with an fp8 pool
    under a budget of the two floors and FLEET_SURPLUS_B pages, SLO-aware
    selection and SLO admission, a third of the requests premium: every
    request finishes, the live bytes across engines stay within the
    budget after every fleet step, some engine borrows beyond its floor,
    and K2 carries the fp8 replica."""
    from repro_torch.kernels import ops
    floors = 2 * -(-ENGINE_KW["max_seq_len"] // PAGE)
    fleet = _fleet(weights, FLEET_B, floors + FLEET_SURPLUS_B,
                   selection="slo-aware", admission="slo")
    budget = fleet.budget
    ops.reset_launches()                       # the main path starts here
    _fleet_submit(fleet, requests, None, premium_every=3)
    borrowed, live_max = Counter(), 0
    while fleet.pending():
        fleet.step()
        u = budget.usage()
        live = sum(e["bytes_in_use"] for e in u["engines"].values())
        assert live <= budget.total_bytes, \
            f"run B: {live} live bytes > budget {budget.total_bytes} at " \
            f"fleet tick {fleet._tick}"
        live_max = max(live_max, live)
        for key, e in u["engines"].items():
            borrowed[key] = max(borrowed[key], e["borrowed"])
        assert fleet._tick < 20_000, "run B: the fleet does not finish"
    counts = dict(ops.launches)                # ... and ends here
    _check_fleet_run("run B", fleet, requests, counts)
    assert any(borrowed.values()), "run B: no engine borrowed"
    assert counts.get("quantized_paged_decode_attention[fp8]", 0) > 0
    log("fleet", f"run B: budget {budget.total} pages of "
        f"{budget.page_bytes} bytes ({budget.total_bytes / 2 ** 20:.1f} MiB)"
        f"; live bytes at most {live_max / 2 ** 20:.1f} MiB across the "
        f"engines after every fleet tick; most pages borrowed beyond the "
        f"floor {json.dumps(dict(borrowed))}")
    _report_fleet("run B", fleet)


def _fleet_telemetry(weights, requests, streams, sampling) -> None:
    """Run A again under ``Telemetry(ring=4096)``: the same streams, one
    ``fleet_tick`` event per engine at every ``heartbeat_every`` stride,
    a valid Perfetto export; then a forced stall (``run(max_ticks=2)`` on
    a fresh fleet) whose message names every pending request as
    ``model/replica:rid(priority)`` and whose postmortem names every
    engine and holds the budget block."""
    from repro_torch.runtime.serving import SchedulerStallError
    from repro_torch.runtime.telemetry import (Telemetry, build_spans,
                                               validate_chrome_trace,
                                               write_perfetto)
    tel = Telemetry(ring=4096)
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A, telemetry=tel)
    _fleet_submit(fleet, requests, sampling)
    done = fleet.run()
    assert {rid: q.generated for rid, q in done.items()} == streams, \
        "telemetry: streams differ from run A's"
    every = tel.heartbeat_every
    assert fleet._tick >= every, f"telemetry: {fleet._tick} fleet ticks"
    engines = [f"{n}/{i}" for n, i, _ in fleet._engines()]
    beats = Counter((e.tick, e.engine) for e in tel.events()
                    if e.kind == "fleet_tick")
    want = {(t, name): 1 for t in range(every, fleet._tick + 1, every)
            for name in engines}
    assert dict(beats) == want, f"telemetry: heartbeats {dict(beats)}"
    assert tel.recorder.dropped == 0, "telemetry: the ring dropped events"
    path = FLEET_DIR / "trace_fleet.json"
    write_perfetto(str(path), tel.events())
    doc = json.loads(path.read_text())
    errors = validate_chrome_trace(doc)
    assert errors == [], f"telemetry: Perfetto export invalid: {errors[:5]}"
    spans = build_spans(tel.events())["spans"]
    log("fleet", f"telemetry: streams equal to run A's; {len(want)} "
        f"fleet_tick events, one per engine every {every} of "
        f"{fleet._tick} ticks; Perfetto export {path.relative_to(ROOT)} "
        f"valid ({len(doc['traceEvents'])} trace events, {len(spans)} "
        "spans)")
    del fleet, done
    gc.collect()
    path = FLEET_DIR / "postmortem.json"
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A, telemetry=Telemetry(
        ring=4096, postmortem_path=str(path)))
    _fleet_submit(fleet, requests, sampling)
    try:
        fleet.run(max_ticks=2)
    except SchedulerStallError as e:
        msg = str(e)
    else:
        raise AssertionError("fleet run(max_ticks=2) did not stall")
    pm = json.loads(path.read_text())
    assert set(pm["engines"]) == set(engines), sorted(pm["engines"])
    assert pm["budget"]["total_pages"] == FLEET_PAGES_A
    assert set(pm["budget"]["engines"]) == \
        {str((n, i)) for n, i, _ in fleet._engines()}
    pending = 0
    for name, i, eng in fleet._engines():
        for q in [*eng.queue, *eng.seats.values()]:
            assert f"{name}/{i}:{q.rid}({q.priority})" in msg, q.rid
            pending += 1
    assert pending and pm["reason"] == "SchedulerStallError: " + msg
    log("fleet", f"forced stall: the message names the {pending} pending "
        f"requests by model/replica:rid(priority); postmortem "
        f"{path.relative_to(ROOT)} names the engines {engines} and holds "
        "the budget block")


def _fleet_steady(weights) -> None:
    """A fleet of FLEET_A with every engine's 8 seats decoding (prompts of
    128 tokens, 64 new tokens): one fleet step (three engine ticks, each
    ending in its token pull) under ``_profile_steady``, then the
    llama3-8b replica's tick replayed alone, its device busy time against
    the least time its bytes take (information)."""
    fleet = _fleet(weights, FLEET_A, FLEET_PAGES_A)
    rng = np.random.default_rng(8)
    for arch, n in ((ARCH, 16), (LLAMA, 8)):
        for _ in range(n):
            fleet.submit(model=arch, prompt=rng.integers(
                0, weights[arch][0].vocab_size, 128).astype(np.int32),
                max_new_tokens=64)
    while any(eng.queue or any(r.prefill_pos < len(r.prefill_src)
                               for r in eng.seats.values())
              for _, _, eng in fleet._engines()):
        fleet.step()
    assert all(len(eng.seats) == 8 for _, _, eng in fleet._engines())
    _profile_steady("fleet", "steady fleet step (3 engines, 24 seats)",
                    fleet.step)
    eng = fleet.group(LLAMA).engines[0]
    nbytes = _tick_bytes(eng)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    _, busy = _profile_graph_tick(f"{LLAMA}/0", eng, phase="fleet")
    log("fleet", f"{LLAMA}/0 tick: device busy {busy:.3f} ms against the "
        f"byte bound {bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): {busy / bound_ms:.2f}x "
        "(information)")
    _check_tickets("steady fleet", _fleet_tickets(fleet))


def _weight_bytes(cfg, params, tokens: int) -> int:
    """Weight bytes one model step over ``tokens`` tokens must read: every
    weight once but the embedding, of which only the tokens' rows (all
    of it where the head is tied to it).  An MoE model's capacity path
    reads every expert's weights each step, so they all count."""
    from repro_torch.tree import tree_flatten_with_paths
    weights = sum(t.numel() * t.element_size() for p, t in
                  tree_flatten_with_paths(params) if p != "embed")
    emb = params["embed"]
    return weights + (emb.numel() if cfg.tie_embeddings else
                      tokens * emb.shape[1]) * emb.element_size()


def _tick_bytes(eng) -> int:
    """Bytes one fused tick of ``eng`` from ``_tick_state(eng)`` must
    move: the weights (``_weight_bytes``), the K and V of every seat's
    positions (bf16 pool; on a sliding-window layer only the last W),
    and the f32 logits."""
    cfg = eng.cfg
    state = _tick_state(eng)
    seats = len(state["pos"])
    weights = _weight_bytes(cfg, eng.params, seats)
    lengths = state["pos"] + 1
    n_global, n_local = layer_counts(cfg)
    tokens = n_global * int(lengths.sum())
    if n_local:
        tokens += n_local * int(lengths.clamp(max=cfg.sliding_window).sum())
    kv = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * tokens
    return weights + kv + seats * cfg.vocab_size * 4


def _fleet_cli() -> None:
    """``python -m repro_torch.launch.serve --fleet`` with the reference's
    defaults (reduced configs, ``qwen3-1.7b:2,llama3-8b``) on the card,
    queued for ``phase_cli``."""
    def check(out):
        assert out.returncode == 0, f"serve --fleet: rc {out.returncode}\n" \
            f"{out.stderr[-3000:]}"
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("[serve.fleet]")]
        assert lines and "device=cuda" in lines[0] and \
            "8 requests" in lines[0], out.stdout[-2000:]
        for ln in lines:
            log("fleet", f"cli: {ln}")
    CLI_JOBS.append((["--fleet"], check))


def phase_fleet() -> None:
    """The multi-model fleet on the card: qwen3-1.7b x2 and llama3-8b x1
    at full width behind one ``ModelFleet``."""
    from repro_torch.runtime.sampler import SamplingParams
    FLEET_DIR.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = _fleet_weights()
    log("fleet", f"weights: {ARCH} "
        f"{_tree_bytes(weights[ARCH][1]) / 2 ** 30:.2f} GiB, {LLAMA} "
        f"{_tree_bytes(weights[LLAMA][1]) / 2 ** 30:.2f} GiB cast for "
        f"compute; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        "allocated, peak while drawing "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    requests = _fleet_requests(weights)
    sampling = SamplingParams(temperature=0.9, seed=11)
    streams = _fleet_identity(weights, requests, sampling)
    gc.collect()
    _fleet_solo(weights, requests, streams, sampling)
    _fleet_llama_f32(weights, requests)
    gc.collect()
    t1 = time.perf_counter()
    _fleet_budget(weights, requests)
    gc.collect()
    _fleet_telemetry(weights, requests, streams, sampling)
    gc.collect()
    t2 = time.perf_counter()
    _fleet_steady(weights)
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    _fleet_cli()
    log("fleet", f"phase times: run A and solo {t1 - t0:.1f} s, run B and "
        f"telemetry {t2 - t1:.1f} s, steady profile "
        f"{time.perf_counter() - t2:.1f} s; peak "
        f"{peak:.2f} GiB allocated (max_memory_allocated)")


# ---------------------------------------------------------------------------
# phase moe
# ---------------------------------------------------------------------------

MOE_REQUESTS = 24
MOE_FIRST_WAVE = 12      # requests submitted before the first engine step;
MOE_EVERY = 4            # then one more every MOE_EVERY steps
MOE_F32_LAYERS = 12      # depth of the f32 checks: the widths never change
# depth of the bf16 tick's check against the f32 tick.  The reference's
# init draws a stacked leaf with std 1/sqrt(layers) (its fan-in is the
# leading axis), so without a qk-norm the attention scores are large and
# nearly one-hot: a bf16 rounding at a near-tie moves a seat's logits as
# far as they are large, with the kernels and the plain versions alike.
# Over 12 layers that swamped a planted fault, routes pinned or not;
# over 2 the fault stands far out of it (PERF.md section 6)
MOE_TICK_LAYERS = 2
MOE_FIXED_REQUESTS = 8


def _draw_cast(arch: str, phase: str, **overrides):
    """``arch`` at full width (its config with ``overrides``: a depth cut
    to fit the card, a compute dtype), drawn on the card from a generator
    seeded 0, each matmul leaf cast to the compute dtype as it is drawn
    (``init_params_for_compute``, bit-equal to casting the drawn f32
    tree): the f32 tree never exists, only the leaf being drawn and its
    cast beside the tree so far.  Logs the tree's size and the drawing
    peak, which may not pass the tree and the largest leaf's f32 draw.
    Returns (cfg, params)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import init_params_for_compute
    from repro_torch.tree import tree_leaves
    full = get_config(arch)
    cfg = dataclasses.replace(full, **overrides)
    specs = M.param_specs(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params_for_compute(
        specs, torch.Generator(device="cuda").manual_seed(0),
        M.compute_dtype(cfg), device="cuda")
    peak = torch.cuda.max_memory_allocated() - base
    held = _tree_bytes(params)
    largest = max(t.numel() for t in tree_leaves(params))
    depth = (f" of its {full.num_layers}"
             if cfg.num_layers != full.num_layers else "")
    log(phase, f"weights: {arch}, {cfg.num_layers}{depth} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"{'tied' if cfg.tie_embeddings else 'untied'}: "
        f"{M.count_params(specs) / 1e9:.3f} B parameters, "
        f"{held / 2 ** 30:.2f} GiB cast as drawn ({cfg.compute_dtype}); "
        f"peak "
        f"{peak / 2 ** 30:.2f} GiB while drawing (the f32 tree alone "
        f"would be {M.count_params(specs) * 4 / 2 ** 30:.2f} GiB)")
    # at most the tree and the largest leaf's f32 draw (4 bytes an
    # element) beside its cast: no earlier leaf's f32 draw outlives it
    assert peak <= held + 4 * largest + 2 ** 28, \
        f"{phase}: drawing peaked at {peak / 2 ** 30:.2f} GiB"
    return cfg, params


def _moe_weights():
    """qwen2-moe-a2.7b at full width, drawn cast (``_draw_cast``).
    Returns (cfg, params)."""
    cfg, params = _draw_cast(MOE, "moe")
    m = cfg.moe
    log("moe", f"experts: {m.num_experts} top-{m.top_k} (d_ff "
        f"{m.d_ff_expert}) + {m.num_shared_experts} shared (d_ff "
        f"{m.d_ff_shared})")
    return cfg, params


def _moe_prompts(cfg) -> list:
    """MOE_REQUESTS prompts of 64-511 tokens."""
    rng = np.random.default_rng(9)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(
        64, 512))).astype(np.int32) for _ in range(MOE_REQUESTS)]


def _moe_drive(eng, prompts, sampling) -> int:
    """Submits MOE_FIRST_WAVE of ``prompts`` (32 new tokens each), then one
    more every MOE_EVERY engine steps, and steps to the end.  Returns the
    number of decode ticks in which an idle seat sat below a decoding
    one, read from the valid counts staged for the tick (they stand until
    the next churn)."""
    pol = eng.policy
    rest = list(prompts)
    for p in rest[:MOE_FIRST_WAVE]:
        eng.submit(p, max_new_tokens=32, sampling=sampling)
    rest = rest[MOE_FIRST_WAVE:]
    gaps = steps = 0
    while rest or eng.queue or eng.seats:
        if rest and steps % MOE_EVERY == 0:
            eng.submit(rest.pop(0), max_new_tokens=32, sampling=sampling)
        ticks = pol.decode_ticks
        eng.step()
        steps += 1
        if pol.decode_ticks > ticks:
            live = pol._i32._host["nv"] > 0
            top = np.flatnonzero(live)
            gaps += bool(top.size) and bool((~live[:top[-1]]).any())
        assert steps < 10_000, "moe: the engine does not finish"
    return gaps


def _moe_run(cfg, params, prompts, sampling, kv_dtype=None,
             fused: bool = True):
    """The paged engine (ENGINE_KW) over ``prompts`` with staggered
    arrivals; returns (engine, launches read just after the run, gap
    ticks)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, kv_dtype=kv_dtype, fused=fused,
                             device="cuda", **ENGINE_KW)
    ops.reset_launches()                       # the main path starts here
    gaps = _moe_drive(eng, prompts, sampling)
    counts = dict(ops.launches)                # ... and ends here
    return eng, counts, gaps


def _moe_check(tag: str, eng, counts: dict, gaps: int) -> None:
    """Every request finished with 32 tokens in the vocabulary, logits
    finite, launches = layers x replays (``_check_run``), no preemption,
    some tick with an idle seat below a decoding one."""
    _check_run(tag, {"engine": eng, "finished": eng.finished,
                     "metrics": eng.metrics.snapshot()}, eng.cfg, counts,
               phase="moe", requests=MOE_REQUESTS)
    assert eng.metrics.preemptions == 0, f"moe {tag}: preempted"
    assert gaps > 0, f"moe {tag}: no tick had an idle seat below a " \
        "decoding one"
    log("moe", f"{tag}: {gaps} of {eng.policy.decode_ticks} decode ticks "
        "had an idle seat below a decoding one; no preemption")


@contextlib.contextmanager
def _capacity_calls(seen: list):
    """``moe._expert_gemms_capacity`` watched: each call runs as it
    would, and its (routed (token, expert) pairs, C, dropped pairs on
    the device) is appended to ``seen``."""
    from repro_torch.models import moe as moe_mod
    inner = moe_mod._expert_gemms_capacity

    def recording(p, m, xs, sizes, dt):
        C = moe_mod.capacity(m, xs.shape[0])
        seen.append((xs.shape[0], C, (sizes - C).clamp(min=0).sum()))
        return inner(p, m, xs, sizes, dt)
    moe_mod._expert_gemms_capacity = recording
    try:
        yield
    finally:
        moe_mod._expert_gemms_capacity = inner


def _log_drops(phase: str, cfg, seen: list) -> None:
    """The dropped (token, expert) pairs of the capacity-path calls
    ``seen`` (``_capacity_calls``, one per layer of each model step of a
    paged engine), per prefill chunk and per decode tick
    (information)."""
    L, k = cfg.num_layers, cfg.moe.top_k
    assert len(seen) % L == 0, len(seen)
    dropped = torch.stack([d for _, _, d in seen]).reshape(-1, L).sum(1)
    steps = [(tk, C, int(d)) for (tk, C, _), d in
             zip(seen[::L], dropped.tolist())]
    for name, tk in (("prefill chunk", PREFILL_CHUNK * k),
                     ("decode tick", ENGINE_KW["max_seats"] * k)):
        mine = [(C, d) for t, C, d in steps if t == tk]
        drops = [d for _, d in mine]
        routed = len(mine) * tk * L
        log(phase, f"drops per {name} ({tk} (token, expert) pairs per "
            f"layer into {cfg.moe.num_experts} experts of {mine[0][0]} "
            f"slots): {len(mine)} {name}s, {sum(drops)} of {routed} routed "
            f"pairs dropped ({sum(drops) / routed:.4f}); per {name} mean "
            f"{sum(drops) / len(mine):.2f}, max {max(drops)}, "
            f"{sum(d > 0 for d in drops)} with drops")


def _moe_drops(cfg, params, prompts, sampling, ref) -> None:
    """The same requests and arrivals through the ``fused=False`` engine
    (eager model steps, host sampling), whose streams and trace must
    equal the graphed run ``ref``'s, with every capacity-path call
    recorded: the dropped (token, expert) pairs per prefill chunk and
    per decode tick (information)."""
    seen = []
    with _capacity_calls(seen):
        eng, _, _ = _moe_run(cfg, params, prompts, sampling, fused=False)
    want = {q.rid: q.generated for q in ref.finished}
    got = {q.rid: q.generated for q in eng.finished}
    diff = [rid for rid in want if got.get(rid) != want[rid]]
    assert not diff and len(got) == len(want), \
        f"moe: fused=True and fused=False streams differ for rids {diff}"
    assert eng.trace == ref.trace, \
        "moe: fused=True and fused=False traces differ"
    _log_drops("moe", cfg, seen)
    log("moe", f"fused=False engine (eager, host sampling): streams and "
        f"trace equal to the graphed run's; {eng.policy.decode_ticks} "
        f"decode ticks, {eng.metrics.snapshot()['tokens_per_s']:.1f} "
        "tokens/s")


def _moe_expert_ms(eng) -> float:
    """CUDA-event time of one tick's expert products alone: per layer the
    capacity path's three batched products over (E, C, ·) at the tick's
    C and the SwiGLU between them, over every layer's weights (25 GB, so
    no flush is needed: nothing stays in L2 from one call to the next)."""
    from repro_torch.models import moe as moe_mod
    cfg, w = eng.cfg, eng.params["blocks"]["pos0"]["moe"]
    m = cfg.moe
    C = moe_mod.capacity(m, eng.policy.max_seats * m.top_k)
    gen = torch.Generator(device="cuda").manual_seed(6)
    xe = torch.randn((m.num_experts, C, cfg.d_model), generator=gen,
                     device="cuda").bfloat16()

    def run():
        for layer in range(cfg.num_layers):
            g = torch.bmm(xe, w["wg"][layer])
            u = torch.bmm(xe, w["wu"][layer])
            torch.bmm(F.silu(g) * u, w["wd"][layer])
    return event_ms(run, torch.empty(1, device="cuda"), 5)


# a tick's kernels by kind: cuBLAS's GEMMs (the dense products, and an
# MoE's expert bmms), and in an MoE tick the sorts of the router and the
# dispatch
TICK_GROUPS = SERVING_GROUPS + (
    ("GEMMs (cuBLAS)", lambda key: "nvjet" in key or "gemm" in key.lower()),)
MOE_GROUPS = TICK_GROUPS + (("sorts", lambda key: "sort" in key.lower()),)


def _moe_syncs(eng) -> None:
    """``eng`` (graphed) over 8 fresh prompts of 128 tokens (no prefix
    of an earlier run) with 64 new tokens each, stepped until every seat
    decodes; then STEADY_TICKS ticks under
    ``torch.cuda.set_sync_debug_mode("warn")`` (``_window_syncs``) make
    exactly one synchronizing call each, the token pull: nothing in the
    replayed MoE tick syncs."""
    rng = np.random.default_rng(10)
    for _ in range(8):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, 128).astype(np.int32),
                   max_new_tokens=64)
    _to_steady(eng)
    syncs = _window_syncs(eng)
    assert sum(syncs.values()) == STEADY_TICKS and len(syncs) == 1, \
        f"moe: synchronizing calls in {STEADY_TICKS} steady ticks: " \
        f"{dict(syncs)}"
    eng.run()
    log("moe", f"steady ticks: one synchronizing call per tick, the token "
        f"pull ({dict(syncs)} over {STEADY_TICKS} ticks)")


def _moe_steady(eng, phase: str = "moe", tag: str = "bf16 pool") -> None:
    """The graphed tick replayed at 8 decoding seats (``_tick_state``):
    wall, busy, kernels, idle share; its busy time against its byte
    bound (every expert's weights each tick; K/V counted as bf16); the
    expert products' time and share of the busy time (information)."""
    cfg = eng.cfg
    wall, busy = _profile_graph_tick(f"{cfg.name} {tag}", eng, phase=phase,
                                     groups=MOE_GROUPS)
    nbytes = _tick_bytes(eng)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    m = cfg.moe
    expert_bytes = 3 * cfg.num_layers * m.num_experts * cfg.d_model * \
        m.d_ff_expert * 2
    expert_ms = _moe_expert_ms(eng)
    log(phase, f"{cfg.name} {tag} tick: device busy {busy:.3f} ms (wall "
        f"{wall:.2f} "
        f"ms) against the byte bound {bound_ms:.3f} ms ({nbytes / 1e9:.2f} "
        f"GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): {busy / bound_ms:.2f}x; "
        f"the expert products alone {expert_ms:.3f} ms by CUDA events, "
        f"{expert_ms / busy:.3f} of the busy time (their bytes "
        f"{expert_bytes / 1e9:.2f} GB, bound "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms) (information)")


def _router_flips(run) -> tuple:
    """Runs ``run()`` with the model step and the router watched, and
    pairs the plain versions' model steps with the kernels' in call
    order.  Returns ((token, layer) rows of valid tokens, rows whose
    top-k expert set differs between the two, tokens, tokens with such a
    row)."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    step, route = M.paged_decode_step, moe_mod.route
    calls = {"plain": [], "kernel": []}
    now = {}

    def watched_step(params, cfg, cache, tokens, pos, table, n_valid, **kw):
        C = tokens.shape[1]
        valid = (torch.arange(C, device=tokens.device)[None, :]
                 < n_valid[:, None]).reshape(-1)
        now["layers"] = []
        calls[kw["impl"]].append((valid, now["layers"]))
        return step(params, cfg, cache, tokens, pos, table, n_valid, **kw)

    def watched_route(p, m, xt):
        out = route(p, m, xt)
        now["layers"].append(out[2])
        return out
    M.paged_decode_step, moe_mod.route = watched_step, watched_route
    try:
        run()
    finally:
        M.paged_decode_step, moe_mod.route = step, route
    assert len(calls["plain"]) == len(calls["kernel"])
    rows = flipped = tokens = tok_flipped = 0
    for (valid, lp), (_, lk) in zip(calls["plain"], calls["kernel"]):
        assert len(lp) == len(lk)
        hit = torch.zeros_like(valid)
        for a, b in zip(lp, lk):
            diff = (a.sort(-1).values != b.sort(-1).values).any(-1) & valid
            flipped += int(diff.sum())
            rows += int(valid.sum())
            hit |= diff
        tok_flipped += int(hit.sum())
        tokens += int(valid.sum())
    return rows, flipped, tokens, tok_flipped


def _moe_f32(eng, prompts, phase: str = "moe", layers: int = MOE_F32_LAYERS,
             tick_layers: int = MOE_TICK_LAYERS) -> None:
    """The model cut to its first ``layers`` layers (widths unchanged:
    qwen2-moe-a2.7b's 24 layers' f32 weights, 53 GiB, do not fit beside
    the bf16 tree), widened to f32: on its first ``tick_layers`` layers
    the bf16 tick with the kernels held to the f32 tick against the
    plain versions', both routed as the f32 tick (``_tick_vs_f32``, with
    its planted fault), then the kernels against the plain versions in
    f32, teacher-forced by phase f32's method over 8 prompts, counting
    the router's top-k flips between the two (information)."""
    import dataclasses
    from repro_torch.tree import tree_map
    name = eng.cfg.name
    params, _, cfg = _first_layers(eng.params, eng.policy.cache, eng.cfg,
                                   layers)
    wide = tree_map(lambda t: t.float(), params)
    log(phase, f"f32 checks on the first {layers} of "
        f"{eng.cfg.num_layers} layers (widths unchanged): "
        f"{_tree_bytes(wide) / 2 ** 30:.2f} GiB of f32 weights")
    _tick_vs_f32(f"{name} (first {tick_layers} layers)", eng,
                 phase=phase, wide=dict(wide, blocks=tree_map(
                     lambda t: t[:tick_layers], wide["blocks"])))
    gc.collect()
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    rows, flipped, tokens, tok_flipped = _router_flips(
        lambda: _f32_paged_teacher_forced(
            f32, wide, prompts, phase=phase,
            what=f"{name} fused tick (paged, f32 pool, first "
                 f"{layers} layers)"))
    log(phase, f"router top-{cfg.moe.top_k} sets differing between the "
        f"kernels' and the plain versions' f32 runs: {flipped} of {rows} "
        f"(token, layer) rows, at {tok_flipped} of {tokens} tokens "
        "(information)")


def _fixed_engine(cfg, params, prompts, phase: str, max_len: int,
                  gen: int) -> dict:
    """The fixed-slot ``ServingEngine`` (8 slots, ``max_len``) over
    ``prompts``, ``gen`` greedy tokens each: all finish in the
    vocabulary, logits finite, launch counts exact (per decode step K4
    once per global layer, and windowed once per sliding-window layer;
    per prefill K5 causal per global layer and windowed per
    sliding-window layer, the window biting in some prompt), the captured
    decode step bit-equal to the eager one, tickets back at 0.  Returns
    the launch counts."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import ServingEngine
    eng = ServingEngine(cfg, params, slots=8, max_len=max_len, device="cuda")
    for p in prompts:
        eng.submit(p, max_new_tokens=gen)
    ops.reset_launches()                       # the main path starts here
    done = eng.run()
    counts = dict(ops.launches)                # ... and ends here
    assert len(done) == len(prompts), f"{phase} fixed-slot: {len(done)}"
    for q in done:
        assert len(q.generated) == gen, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), q.rid
    assert bool(eng.policy.logits_finite), f"{phase} fixed-slot: a logit " \
        "was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    n_global, n_local = layer_counts(cfg)
    want = {**attention_launches(cfg, "decode_attention[bf16]", ticks),
            "flash_attention[causal]": n_global * prefills,
            **norm_launches(cfg, ticks + prefills)}
    W = _model_window(cfg)
    past = sum(len(p) > W for p in prompts) if W else 0
    if W:
        want["flash_attention[window]"] = n_local * prefills
        assert past, f"{phase} fixed-slot: no prefill past the window"
    assert counts == want, f"{phase} fixed-slot: launches {counts}, " \
        f"expected {want}"
    _fixed_graph_vs_eager(eng, phase=phase)
    _check_tickets(f"{phase} fixed-slot", [eng.policy._tickets,
                                           *da._tickets.values()])
    m = eng.metrics.snapshot()
    log(phase, f"fixed-slot engine: {m['completed']:.0f} requests, "
        f"{ticks} decode steps, {prefills} prefills"
        + (f" ({past} past the window)" if W else "")
        + f", {m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms; launches {json.dumps(counts)}")
    return counts


def _fixed_attention(cfg, prompts, phase: str, max_len: int, gen: int,
                     flush=None) -> dict:
    """K4 and K5 against their plain versions at the shapes the
    fixed-slot engine gives ``cfg``'s model (bf16, its heads over its kv
    heads at its head dim), within BF16_ATOL/RTOL: K4 over 8 slots of
    ``max_len`` + 1 keys at the lengths the slots reach over ``prompts``
    with ``gen`` new tokens and an idle slot walking the cache, with the
    model's window if it has one and without, tickets back at 0; K5
    causal over the longest prompt and, on a sliding-window model,
    windowed over it and over the first three (causal without a window).
    With ``flush`` K4 and the windowed K5 at the longest prompt are
    timed beside their plain versions, their bounds and SDPA with the
    same mask, and the windowed ones' rows are returned."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    heads, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    W = _model_window(cfg)
    B, T = 8, max_len + 1
    lens = [len(p) + gen - 1 for p in prompts[:B - 1]] + [T]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rng = torch.Generator(device="cuda").manual_seed(7)

    def draw(*shape):
        return torch.randn(shape, generator=rng, device="cuda").bfloat16()
    q, k, v = draw(B, 1, heads, d), draw(B, T, kvh, d), draw(B, T, kvh, d)
    rows = {}
    for window in ((W, None) if W else (None,)):
        def run(impl, window=window):
            return ops.decode_attention(q, k, v, lengths, window=window,
                                        impl=impl)
        tag = f"decode_attention[bf16{',window' if window else ''}]"
        got = run("kernel")
        torch.cuda.synchronize()
        err = check_close(f"{cfg.name} {tag}", got, run("plain"), BF16_ATOL,
                          BF16_RTOL)
        _check_tickets(f"{cfg.name} dense decode", da._tickets.values())
        what = (f"{cfg.name} {tag} H={heads} KVH={kvh} d={d}, {B} slots of "
                f"{T} keys, lengths {lens}: max|err| {err:.3e}; tickets "
                "back at 0")
        if flush is None:
            log(phase, what)
            continue
        ms = cuda_ms(lambda: run("kernel"), flush)
        plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
        kg, vg = (t.transpose(1, 2).repeat_interleave(heads // kvh, dim=1)
                  .contiguous() for t in (k, v))
        mask = _window_mask(lengths, T, window)
        lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION,
                                      q.transpose(1, 2), kg, vg,
                                      attn_mask=mask), flush)
        del kg, vg
        kept = int((lengths.clamp(max=W) if window else lengths).sum())
        nbytes = 2 * kept * kvh * d * 2 + 2 * q.numel() * 2 + B * 4
        b_ms, b_by = bound(nbytes, 4.0 * kept * heads * d)
        log(phase, f"{what}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"{SDPA_EFF} {lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by}, "
            f"{nbytes / 1e6:.2f} MB, {kept} keys)")
        if window:
            rows[tag] = dict(name="decode_attention", max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms,
                             library=SDPA_EFF)
    longest = max(len(p) for p in prompts)
    errs = {}
    for S, window in ((longest, None), *(((longest, W),) if W else ()),
                      *((len(p), W) for p in prompts[:3])):
        q, k, v = draw(1, S, heads, d), draw(1, S, kvh, d), draw(1, S, kvh, d)

        def run(impl, q=q, k=k, v=v, window=window):
            return ops.flash_attention(q, k, v, causal=True, window=window,
                                       impl=impl)
        tag = f"flash[{'window' if window else 'causal'}, S={S}]"
        errs[tag] = check_close(f"{cfg.name} {tag}", run("kernel"),
                                run("plain"), BF16_ATOL, BF16_RTOL)
        if flush is None or (S, window) != (longest, W):
            continue
        ms = cuda_ms(lambda: run("kernel"), flush)
        plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
        qs, kg, vg = (q.transpose(1, 2).contiguous(),
                      *(t.transpose(1, 2).repeat_interleave(heads // kvh,
                                                            dim=1)
                        .contiguous() for t in (k, v)))
        lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, kg,
                                      vg, attn_mask=mask), flush)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        kept = int(torch.clamp(i + 1, max=W).sum())
        flops = 4.0 * d * heads * kept
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        log(phase, f"flash_attention[window] S={S} W={W} H={heads} "
            f"KVH={kvh} d={d}: max|err| {errs[tag]:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms bound "
            f"{b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.2f} GFLOP at the bf16 tensor-core rate)")
        rows["flash_attention[window]"] = dict(
            name="flash_attention", max_abs_err=errs[tag], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library=SDPA_EFF)
    log(phase, f"{cfg.name} flash prefill (K5) H={heads} KVH={kvh} d={d} "
        "bf16, max|err| " + ", ".join(f"{e:.3e} at {t}"
                                      for t, e in errs.items()))
    return rows


def _serve_cli(arch: str, phase: str) -> None:
    """``python -m repro_torch.launch.serve --arch <arch>`` on both
    engines (``--engine paged`` and the static batch) with their
    defaults (reduced config) on the card, queued for ``phase_cli``."""
    for engine, tag, want in (("paged", "[serve.paged]", "8 requests"),
                              ("batch", "[serve]", "throughput=")):
        def check(out, engine=engine, tag=tag, want=want):
            assert out.returncode == 0, f"serve --arch {arch} --engine " \
                f"{engine}: rc {out.returncode}\n{out.stderr[-3000:]}"
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith(tag)]
            assert any(want in ln for ln in lines), out.stdout[-2000:]
            if engine == "paged":
                assert "device=cuda" in lines[0], lines[0]
            for ln in lines:
                log(phase, f"cli --engine {engine}: {ln}")
        CLI_JOBS.append((["--arch", arch, "--engine", engine], check))


def phase_moe() -> None:
    """qwen2-moe-a2.7b at full width on the paged and fixed-slot engines."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.runtime.sampler import SamplingParams
    t0 = time.perf_counter()
    cfg, params = _moe_weights()
    prompts = _moe_prompts(cfg)
    sampling = SamplingParams(temperature=0.9, seed=13)
    eng, counts, gaps = _moe_run(cfg, params, prompts, sampling)
    pol = eng.policy
    assert pol._tick_fn.graph is not None and \
        pol._prefill_fn.graph is not None, "moe: a step was not captured"
    log("moe", f"run A built: the tick and the prefill chunk captured as "
        f"CUDA graphs (a synchronizing call inside a capture raises); "
        f"pool {_tree_bytes(eng.cache) / 2 ** 30:.2f} GiB; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    _moe_check("bf16", eng, counts, gaps)
    _graph_vs_eager(f"{MOE} bf16", eng, phase="moe")
    _check_tickets("moe run A", [eng.policy._tickets,
                                 *da._tickets.values()])
    _moe_drops(cfg, params, prompts, sampling, eng)
    gc.collect()
    _model_attention(cfg, "moe", _seat_lengths(eng), eng.policy.n_tables)
    _moe_steady(eng)
    _moe_syncs(eng)
    t1 = time.perf_counter()
    _moe_f32(eng, prompts[:8])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    eng, counts, gaps = _moe_run(cfg, params, prompts, None, kv_dtype="fp8")
    _moe_check("fp8", eng, counts, gaps)
    _check_tickets("moe run B", [eng.policy._tickets,
                                 *da._tickets.values()])
    del eng
    gc.collect()
    moe_fixed = prompts[:MOE_FIXED_REQUESTS]
    _fixed_engine(cfg, params, moe_fixed, "moe", MAX_LEN, 32)
    _fixed_attention(cfg, moe_fixed, "moe", MAX_LEN, 32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _serve_cli(MOE, "moe")
    log("moe", f"phase times: run A and its checks {t1 - t0:.1f} s, f32 "
        f"{t2 - t1:.1f} s, run B and fixed-slot "
        f"{time.perf_counter() - t2:.1f} s; peak {peak:.2f} GiB allocated "
        "(max_memory_allocated)")


# ---------------------------------------------------------------------------
# phase gemma
# ---------------------------------------------------------------------------

GEMMA_REQUESTS = 16
GEMMA_GEN = 48
GEMMA_TICK_CROSSERS = 4        # prompts that cross the window in ticks
GEMMA_MAX_LEN = 1456           # prompts of at most 1400 tokens + 48 new
# 8 seats of GEMMA_MAX_LEN tokens in pages of 16, and 32 pages more
GEMMA_ENGINE_KW = dict(page_size=PAGE,
                       num_pages=8 * (GEMMA_MAX_LEN // PAGE) + 32,
                       max_seats=8, max_seq_len=GEMMA_MAX_LEN,
                       prefill_chunk=PREFILL_CHUNK)
# K1/K2 at this model's shapes: a seat below, at and past the window, and
# the longest a seat reaches
GEMMA_SEATS = (1, 17, 1023, 1024, 1025, 1040, 1100, 1448)
# depth of the bf16 tick's check against the f32 tick: one period, five
# windowed layers and a global one.  No qk-norm either, so at depth the
# model's own bf16 jumps would swamp a fault (phase moe's comment)
GEMMA_TICK_LAYERS = 6
GEMMA_RING_S = 1100            # S % W != 0: the rows must be rolled
GEMMA_RING_GEN = 32
GEMMA_FIXED_REQUESTS = 8


def _gemma_prompts(cfg) -> list:
    """GEMMA_REQUESTS prompts whose requests (GEMMA_GEN new tokens each)
    all pass position W = 1024: GEMMA_TICK_CROSSERS of 980-1019 tokens,
    which cross it in decode ticks, the rest of 1030-1400, which cross it
    in a prefill chunk, in a shuffled order."""
    rng = np.random.default_rng(12)
    W = cfg.sliding_window
    lens = [*rng.integers(W - GEMMA_GEN + 4, W - 4, GEMMA_TICK_CROSSERS),
            *rng.integers(W + 6, 1401, GEMMA_REQUESTS - GEMMA_TICK_CROSSERS)]
    lens = [int(lens[i]) for i in rng.permutation(len(lens))]
    assert all(n + GEMMA_GEN > W for n in lens) and max(lens) + GEMMA_GEN \
        <= GEMMA_MAX_LEN
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _gemma_run(cfg, params, prompts, sampling, kv_dtype=None,
               fused: bool = True):
    """The paged engine (GEMMA_ENGINE_KW) over ``prompts``, all submitted
    at once with GEMMA_GEN new tokens each; returns (engine, launches read
    just after the run)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params, kv_dtype=kv_dtype, fused=fused,
                             device="cuda", **GEMMA_ENGINE_KW)
    for p in prompts:
        eng.submit(p, max_new_tokens=GEMMA_GEN, sampling=sampling)
    ops.reset_launches()                       # the main path starts here
    eng.run()
    counts = dict(ops.launches)                # ... and ends here
    return eng, counts


def _gemma_check(tag: str, eng, counts: dict) -> None:
    """Every request finished with GEMMA_GEN tokens in the vocabulary,
    logits finite, no preemption, launches exact: per tick the kernel of
    the pool once per global layer and its windowed form once per
    sliding-window layer (``_check_run``)."""
    _check_run(tag, {"engine": eng, "finished": eng.finished,
                     "metrics": eng.metrics.snapshot()}, eng.cfg, counts,
               phase="gemma", requests=GEMMA_REQUESTS, gen=GEMMA_GEN)
    assert eng.metrics.preemptions == 0, f"gemma {tag}: preempted"
    W = eng.cfg.sliding_window
    lens = [len(q.prompt) for q in eng.finished]
    log("gemma", f"{tag}: no preemption; every request passed position "
        f"{W}: {sum(n > W for n in lens)} in a prefill chunk, "
        f"{sum(n <= W for n in lens)} in decode ticks")


def _gemma_eager(cfg, params, prompts, sampling, ref) -> None:
    """The same submissions through the ``fused=False`` engine (eager
    model steps, host sampling): streams and trace equal to ``ref``'s."""
    eng, counts = _gemma_run(cfg, params, prompts, sampling, fused=False)
    want = {q.rid: q.generated for q in ref.finished}
    got = {q.rid: q.generated for q in eng.finished}
    diff = [rid for rid in want if got.get(rid) != want[rid]]
    assert not diff and len(got) == len(want), \
        f"gemma: fused=True and fused=False streams differ for rids {diff}"
    assert eng.trace == ref.trace, \
        "gemma: fused=True and fused=False traces differ"
    m = eng.metrics.snapshot()
    log("gemma", f"fused=False engine (eager, host sampling): streams and "
        f"trace equal to the graphed run's; {eng.policy.decode_ticks} "
        f"decode ticks, {m['tokens_per_s']:.1f} tokens/s, wall "
        f"{m['wall_s']:.2f} s")


def _gemma_steady(eng) -> None:
    """The graphed tick replayed at 8 decoding seats (``_tick_state``:
    lengths 41-1455, the local layers reading at most the last 1024):
    wall, busy, kernels, idle share, against its byte bound
    (information)."""
    wall, busy = _profile_graph_tick(f"{GEMMA} bf16 pool", eng,
                                     phase="gemma", groups=TICK_GROUPS)
    nbytes = _tick_bytes(eng)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log("gemma", f"{GEMMA} tick: device busy {busy:.3f} ms (wall "
        f"{wall:.2f} ms) against the byte bound {bound_ms:.3f} ms "
        f"({nbytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s): "
        f"{busy / bound_ms:.2f}x (information)")


ATTENTION_OPS = ("decode_attention", "flash_attention")
NORM_OPS = ("rmsnorm", "add_rmsnorm")


@contextlib.contextmanager
def _recording(calls: list, when=lambda: True, names=ATTENTION_OPS):
    """The ``ops`` wrappers ``names`` (by default ``ops.decode_attention``
    and ``ops.flash_attention``) watched: each call launches as it
    would, and while ``when()`` holds a copy of its arguments is
    appended to ``calls`` as (name, args, kwargs)."""
    from repro_torch.kernels import ops
    inner = {name: getattr(ops, name) for name in names}

    def watched(name):
        fn = inner[name]

        def call(*args, **kw):
            if when():
                calls.append((name, [a.clone() for a in args],
                              {k: v.clone() if isinstance(v, torch.Tensor)
                               else v for k, v in kw.items()}))
            return fn(*args, **kw)
        return call
    for name in inner:
        setattr(ops, name, watched(name))
    try:
        yield
    finally:
        for name, fn in inner.items():
            setattr(ops, name, fn)


def _held_to_plain(calls: list, errs: dict,
                   what: str = "gemma ring check") -> None:
    """Each recorded K4/K5 call (``_recording``) again, with the kernel
    and with the plain version, on its own inputs with q scaled by a
    power of two so that no score can pass 4 (Cauchy-Schwarz over its
    rows) and v by one to |v| <= 1, both exact in f32 and in bf16:
    within F32_TOL for f32 inputs, BF16_ATOL/RTOL for bf16 ones.  At
    random weights the model's scores reach ~1.5e4, where an f32 score
    carries an absolute error of ~1e-2 and the two sides differ by ~1e-3
    on the raw inputs with neither nearer an f64 oracle; scaled, the
    softmax spreads over the window and its edges show.  ``errs`` maps
    each call's shape (the cache's rows or the query and key lengths, and
    its mask) to [calls, largest scaled |kernel - plain|, largest raw
    one]."""
    import math
    from repro_torch.kernels import ops
    for name, args, kw in calls:
        q, k, v, *rest = args
        fn = getattr(ops, name)
        raw = (fn(q, k, v, *rest, **{**kw, "impl": "kernel"})
               - fn(q, k, v, *rest, **{**kw, "impl": "plain"})).abs().max()
        top = (q.norm(dim=-1).max() * k.norm(dim=-1).max()
               * q.shape[-1] ** -0.5).item()
        vmax = v.abs().max().item()
        # all-zero inputs (a prompt of zero patch rows alone) need none
        qs = q * 2.0 ** -max(0, math.ceil(math.log2(top / 4)) if top else 0)
        vs = v * 2.0 ** -max(0, math.ceil(math.log2(vmax)) if vmax else 0)
        window = kw.get("window")
        mask = ("window" if window else
                "causal" if kw.get("causal", True) else "full")
        rows = (f"S={q.shape[1]}" if q.shape[1] == k.shape[1]
                else f"{q.shape[1]}x{k.shape[1]}")
        key = (f"{name}[{k.shape[1]} rows, {'window' if window else 'full'}]"
               if name == "decode_attention" else f"{name}[{rows}, {mask}]")
        tol = F32_TOL if q.dtype == torch.float32 else (BF16_ATOL, BF16_RTOL)
        got, want = (fn(qs, k, vs, *rest, **{**kw, "impl": impl})
                     for impl in ("kernel", "plain"))
        err = check_close(f"{what} {key}, scaled inputs", got, want, *tol)
        row = errs.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        row[1], row[2] = max(row[1], err), max(row[2], raw.item())
    calls.clear()


def _paged_held_to_plain(calls: list, errs: dict, what: str) -> None:
    """Each recorded K1/K2 call (``_recording`` of
    ``ops.paged_decode_attention``) again, with the kernel and with the
    plain version, on its own pool with q scaled by a power of two so
    that no score can pass 4 (the largest query row's norm times the
    pool's largest key row's, dequantized) and v by one to |v| <= 1: a
    bf16 pool's V pages are scaled, a quantized pool's V scales (both
    exact).  Within F32_TOL for f32 queries, BF16_ATOL/RTOL for bf16
    ones (``_held_to_plain``'s reasons).  ``errs`` maps
    ``<kernel>[<pool>]`` to [calls, largest scaled |kernel - plain|,
    largest raw one]."""
    import math
    from repro_torch.core.mixed_precision import dequantize_kv_page
    from repro_torch.kernels import ops
    for _, args, kw in calls:
        q, kp, vp, *rest = args
        ks, vs = kw.get("k_scale"), kw.get("v_scale")

        def run(impl, q=q, vp=vp, vs=vs, rest=rest, kw=kw):
            return ops.paged_decode_attention(
                q, kp, vp, *rest, **{**kw, "v_scale": vs, "impl": impl})
        raw = (run("kernel") - run("plain")).abs().max().item()
        kd = kp.float() if ks is None else dequantize_kv_page(kp, ks)
        vmax = (vp.float() if vs is None
                else dequantize_kv_page(vp, vs)).abs().max().item()
        top = (q.float().norm(dim=-1).max() * kd.norm(dim=-1).max()
               * q.shape[-1] ** -0.5).item()
        del kd
        a = max(0, math.ceil(math.log2(top / 4))) if top else 0
        b = max(0, math.ceil(math.log2(vmax))) if vmax else 0
        qs = q * 2.0 ** -a
        if vs is None:
            vps, vss = vp * 2.0 ** -b, None
        else:
            vps, vss = vp, vs * 2.0 ** -b
        pool = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.uint8: "fp8", torch.int8: "int8"}[kp.dtype]
        key = (f"{'quantized_' if vs is not None else ''}"
               f"paged_decode_attention[{pool}]")
        tol = F32_TOL if q.dtype == torch.float32 else (BF16_ATOL, BF16_RTOL)
        got, want = (run(impl, q=qs, vp=vps, vs=vss)
                     for impl in ("kernel", "plain"))
        err = check_close(f"{what} {key}, scaled inputs", got, want, *tol)
        row = errs.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        row[1], row[2] = max(row[1], err), max(row[2], raw)
    calls.clear()


def _ring_shapes_f32(cfg) -> None:
    """K4 and K5 in f32 at the ring check's shapes on unit-scale random
    inputs, against their plain versions within F32_TOL: K4 (16 heads over
    8 of d 256: the f32 group-2, E = 8 build) on a cache of
    GEMMA_RING_S + GEMMA_RING_GEN rows at lengths below, inside and past
    the window, with the window and without, and on a W-row ring at
    min(pos + 1, W) slots; K5 on its f32 CUDA-core route at d 256 over
    GEMMA_RING_S tokens, causal and windowed.  The model's own inputs
    (``_gemma_ring``) are nearly one-hot at random weights, so a wrong
    window edge shows only here."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    heads, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S, W = GEMMA_RING_S, cfg.sliding_window
    T = S + GEMMA_RING_GEN
    assert fa.route(torch.float32, d) != "tensor cores"
    gen = torch.Generator(device="cuda").manual_seed(19)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    errs = []
    for rows, lens, windows in ((T, (1, 700, W + 1, S + 1, T), (W, None)),
                                (W, (1, 700, W, W, W), (None,))):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        B = len(lens)
        q, k, v = draw(B, 1, heads, d), draw(B, rows, kvh, d), \
            draw(B, rows, kvh, d)
        for window in windows:
            got, want = (ops.decode_attention(q, k, v, lengths, window=window,
                                              impl=impl)
                         for impl in ("kernel", "plain"))
            tag = (f"decode_attention[f32, {rows} rows, lengths {list(lens)}"
                   f"{', window' if window else ''}]")
            errs.append(f"{tag} {check_close(tag, got, want, *F32_TOL):.3e}")
    _check_tickets(f"{GEMMA} f32 dense decode", da._tickets.values())
    q, k, v = draw(1, S, heads, d), draw(1, S, kvh, d), draw(1, S, kvh, d)
    for window in (None, W):
        got, want = (ops.flash_attention(q, k, v, causal=True, window=window,
                                         impl=impl)
                     for impl in ("kernel", "plain"))
        tag = f"flash_attention[f32, S={S}, {'window' if window else 'causal'}]"
        errs.append(f"{tag} {check_close(tag, got, want, *F32_TOL):.3e}")
    log("gemma", f"f32 at the ring check's shapes (H={heads} KVH={kvh} "
        f"d={d}), unit-scale inputs, kernel vs plain within F32_TOL, "
        f"max|err|: " + "; ".join(errs))


def _gemma_ring() -> None:
    """The ring-buffer local cache at full width, in f32 (the bf16 tree
    freed; the f32 weights drawn from the same seed): ``prefill`` of one
    GEMMA_RING_S-token prompt, then GEMMA_RING_GEN ``decode_step``s with
    ``RunOptions(ring_local_cache=...)`` off (greedy) and on (fed the
    full cache's tokens).  First K4 and K5 at these shapes on unit-scale
    inputs against plain (``_ring_shapes_f32``); then the run's own K4
    and K5 calls, scaled, against plain (``_held_to_plain``): K5 on its
    f32 CUDA-core route at d 256, causal and windowed, in the prefill; K4
    in the first and last decode steps on the full cache, global and
    windowed, and on the W-row ring over min(pos + 1, W) slots.  The
    ring's logits are held to the full cache's by phase f32's rule
    (``_hold_decided``; the largest |Δlogit| of each step logged), and
    its top-1 must equal the full cache's token up to the first top-2
    gap of at most F32_GAP.  The decode steps' launches exact (the full
    cache: K4 global on 8 layers and windowed on 40; the ring: K4 over
    the filled slots on all 48); the local layers' cache bytes logged, W
    rows against T."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(GEMMA), compute_dtype="float32")
    _ring_shapes_f32(cfg)
    params = M.init_params(M.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    S, T = GEMMA_RING_S, GEMMA_RING_S + GEMMA_RING_GEN
    W = cfg.sliding_window
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)).cuda()
    kinds = cfg.layer_kinds()
    n_global, n_local = layer_counts(cfg)
    out, errs, stream, local_bytes, calls = {}, {}, [], {}, []
    step = [0]
    for ring in (False, True):
        opts = M.RunOptions(q_chunk=512, ring_local_cache=ring)
        # the prefill's K5 calls (the same in both runs) and the first and
        # last decode steps' K4 calls are held to plain
        with _recording(calls, lambda: not ring):
            logits, rows = M.prefill(params, cfg, {"tokens": tokens}, opts)
        _held_to_plain(calls, errs)
        cache = M.init_cache(cfg, 1, T, opts, device="cuda")
        for pk, ent in cache.items():
            for key, full in ent.items():
                full[:, :, :rows[pk][key].shape[2]] = rows[pk][key]
        del rows
        local_bytes[ring] = sum(
            t.numel() * t.element_size() for pk, ent in cache.items()
            for t in ent.values() if kinds[int(pk[3:])] == "attn_local")
        seen = [logits[0, -1]]
        del logits
        ops.reset_launches()                   # the decode steps start here
        with _recording(calls, lambda: step[0] in (0, GEMMA_RING_GEN - 1)):
            for i in range(GEMMA_RING_GEN):
                step[0] = i
                if not ring:
                    stream.append(int(seen[-1].argmax()))
                tok = torch.tensor([[stream[i]]], dtype=torch.int32,
                                   device="cuda")
                logits, _ = M.decode_step(params, cfg, cache, tok,
                                          torch.tensor([S + i],
                                                       dtype=torch.int32,
                                                       device="cuda"), opts)
                seen.append(logits[0, -1])
        counts = {k: n for k, n in ops.launches.items()
                  if k.startswith("decode_attention")}
        want = ({"decode_attention[f32]": cfg.num_layers * GEMMA_RING_GEN}
                if ring else
                {"decode_attention[f32]": n_global * GEMMA_RING_GEN,
                 "decode_attention[f32,window]": n_local * GEMMA_RING_GEN})
        assert counts == want, f"gemma ring={ring}: launches {counts}, " \
            f"expected {want}"
        _held_to_plain(calls, errs)
        out[ring] = torch.stack(seen)
        del cache, logits, seen
    log("gemma", "ring check, K4/K5 calls of the prefill and of the first "
        "and last decode steps against plain on their own inputs, scaled "
        "(calls, max|err| scaled within F32_TOL, max|err| raw): " + "; ".join(
            f"{key} {n}, {e:.3e}, {raw:.3e}"
            for key, (n, e, raw) in errs.items()))
    full, mine = out[False], out[True]
    stats = _new_stats()
    _hold_decided(stats, mine, full)
    _report_decided(f"{GEMMA} f32 decode steps", stats, "gemma",
                    pair=f"ring cache (W = {W} rows) vs full cache (T = {T} "
                         "rows)")
    top = full.topk(2, dim=-1).values
    gaps = (top[:, 0] - top[:, 1]).tolist()
    undecided = next((i for i, g in enumerate(gaps) if g <= F32_GAP),
                     len(gaps))
    picks = mine.argmax(dim=-1).tolist()
    first_diff = next((i for i, (a, b) in enumerate(
        zip(full.argmax(dim=-1).tolist(), picks)) if a != b), len(picks))
    assert first_diff >= undecided, \
        f"gemma ring cache: its top-1 parts from the full cache's at step " \
        f"{first_diff}, before the first top-2 gap <= {F32_GAP} (step " \
        f"{undecided})"
    delta = (mine - full).abs().amax(dim=-1).tolist()
    log("gemma", f"ring cache at full width (f32, prompt {S} tokens, "
        f"{GEMMA_RING_GEN} decode steps): top-1 equal to the full cache's "
        f"at {sum(a == b for a, b in zip(picks, full.argmax(dim=-1).tolist()))}"
        f" of {len(picks)} steps (the first top-2 gap <= {F32_GAP} at step "
        f"{undecided}); max|Δlogit| per step "
        f"[{', '.join(f'{x:.1e}' for x in delta)}] (largest logit "
        f"{full.abs().max().item():.3f}); local layers' cache "
        f"{local_bytes[True] / 2 ** 20:.1f} MiB with the ring (W = {W} "
        f"rows) against {local_bytes[False] / 2 ** 20:.1f} MiB without (T "
        f"= {T} rows)")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_gemma():
    """gemma3-12b at full width on the paged and fixed-slot engines, and
    its ring-buffer local cache.  Returns the windowed kernels' rows and
    the launch counts of the runs that drove them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.runtime.sampler import SamplingParams
    t0 = time.perf_counter()
    cfg, params = _draw_cast(GEMMA, "gemma")
    prompts = _gemma_prompts(cfg)
    sampling = SamplingParams(temperature=0.9, seed=17)
    eng, counts_a = _gemma_run(cfg, params, prompts, sampling)
    pol = eng.policy
    assert pol._tick_fn.graph is not None and \
        pol._prefill_fn.graph is not None, "gemma: a step was not captured"
    log("gemma", f"run A: the tick and the prefill chunk captured as CUDA "
        f"graphs; pool {_tree_bytes(eng.cache) / 2 ** 30:.2f} GiB "
        f"({GEMMA_ENGINE_KW['num_pages']} pages); "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    _gemma_check("bf16", eng, counts_a)
    _graph_vs_eager(f"{GEMMA} bf16", eng, phase="gemma", start=1000)
    _check_tickets("gemma run A", [pol._tickets, *da._tickets.values()])
    _gemma_eager(cfg, params, prompts, sampling, eng)
    gc.collect()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = _model_attention(cfg, "gemma", GEMMA_SEATS, GEMMA_MAX_LEN // PAGE,
                            flush)
    _gemma_steady(eng)
    t1 = time.perf_counter()
    wide, _, _ = _first_layers(eng.params, eng.policy.cache, cfg,
                               GEMMA_TICK_LAYERS)
    from repro_torch.tree import tree_map
    _tick_vs_f32(f"{GEMMA} (first {GEMMA_TICK_LAYERS} layers)", eng,
                 phase="gemma", wide=tree_map(lambda t: t.float(), wide))
    del wide
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng, pol
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    eng, counts_b = _gemma_run(cfg, params, prompts, None, kv_dtype="fp8")
    _gemma_check("fp8", eng, counts_b)
    _check_tickets("gemma run B", [eng.policy._tickets,
                                   *da._tickets.values()])
    del eng
    gc.collect()
    fixed = prompts[:GEMMA_FIXED_REQUESTS]
    counts_fixed = _fixed_engine(cfg, params, fixed, "gemma", GEMMA_MAX_LEN,
                                 GEMMA_GEN)
    gc.collect()
    rows.update(_fixed_attention(cfg, fixed, "gemma", GEMMA_MAX_LEN,
                                 GEMMA_GEN, flush))
    # K3 and the fused add + norm at D = 3840 (not a power of two: the
    # row's block is 4096 wide and its last 256 columns masked) over a
    # tick's 8 rows, a prefill chunk and the longest fixed-slot prompt,
    # and f32 over the ring check's decode row and prompt
    _norms_vs_plain("gemma", 18, (3840,),
                    ((8, torch.bfloat16), (PREFILL_CHUNK, torch.bfloat16),
                     (max(map(len, fixed)), torch.bfloat16),
                     (1, torch.float32),
                     (GEMMA_RING_S, torch.float32)), (), flush)
    del params, flush
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    _gemma_ring()
    _serve_cli(GEMMA, "gemma")
    log("gemma", f"phase times: run A and its checks {t1 - t0:.1f} s, the "
        f"f32 tick {t2 - t1:.1f} s, run B and fixed-slot {t3 - t2:.1f} s, "
        f"ring cache {time.perf_counter() - t3:.1f} s; "
        f"peak {peak:.2f} GiB allocated (max_memory_allocated) before the "
        "ring check")
    return rows, {"gemma_bf16": counts_a, "gemma_fp8": counts_b,
                  "gemma_fixed": counts_fixed}


# ---------------------------------------------------------------------------
# phase ssm
# ---------------------------------------------------------------------------

MAMBA = "mamba2-130m"          # phase ssm: 24 Mamba-2 layers, no attention
SSM_REQUESTS = 24
SSM_GEN = 64
SSM_MAX_LEN = 4160             # prompts of at most 4000 tokens + 64 new
# prompt lengths every run takes: below a chunk of 256, at it and past
# it, multiples of it and not, the longest; the rest drawn in [100, 4000]
SSM_FIXED_LENGTHS = (100, 255, 256, 257, 1000, 2048, 3999, 4000)
# depth of the bf16 decode step's check against the f32 step
SSM_STEP_LAYERS = 6
# prefill(S) against prefill(S - 1) + decode_step in f32: one chunk short
# of 256, one chunk, and the padded path twice
SSM_PD_LENGTHS = (255, 256, 1000, 4000)
SSM_PD_LIMIT = 1e-3            # of the largest logit (PERF.md §6)
SSM_LONG = 32_768              # the O(1)-state request's prompt


def _ssm_prompts(cfg) -> list:
    """SSM_REQUESTS prompts: SSM_FIXED_LENGTHS and the rest drawn in
    [100, 4000], shuffled."""
    rng = np.random.default_rng(21)
    lens = [*SSM_FIXED_LENGTHS,
            *rng.integers(100, 4001, SSM_REQUESTS - len(SSM_FIXED_LENGTHS))]
    lens = [int(lens[i]) for i in rng.permutation(len(lens))]
    assert max(lens) + SSM_GEN <= SSM_MAX_LEN
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _ssm_state_bytes(cfg, slots: int) -> int:
    """A fixed-slot cache's bytes by the arithmetic of the config: per
    slot and layer the f32 (H, N, P) state and the (W - 1, conv_dim)
    conv tail in the compute dtype."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    per = (d_inner // s.head_dim * s.d_state * s.head_dim * 4
           + (s.conv_width - 1) * conv_dim * 2)
    return cfg.num_layers * slots * per


def _ssm_engine(cfg, params, prompts, sampling, max_len: int):
    """The fixed-slot engine (8 slots, ``max_len``) over ``prompts``,
    SSM_GEN new tokens each, every second request sampled with
    ``sampling`` and the others greedy: all finished in the vocabulary,
    logits finite, launch counts exact (the norms alone:
    ``norm_launches`` per decode step and prefill).  Returns (engine,
    launches read just after the run)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import ServingEngine
    eng = ServingEngine(cfg, params, slots=8, max_len=max_len, device="cuda")
    assert eng.policy._decode_fn.graph is not None, \
        "ssm: the decode step was not captured"
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=SSM_GEN,
                   sampling=sampling if i % 2 else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                       # the main path starts here
    done = eng.run()
    counts = dict(ops.launches)                # ... and ends here
    assert len(done) == len(prompts), f"ssm: {len(done)} finished"
    for q in done:
        assert len(q.generated) == SSM_GEN, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), \
            f"ssm: rid {q.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), "ssm: a logit was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    want = norm_launches(cfg, ticks + prefills)
    assert counts == want, f"ssm: launches {counts}, expected {want} for " \
        f"{ticks} decode steps and {prefills} prefills"
    m = eng.metrics.snapshot()
    log("ssm", f"fixed-slot engine, max_len {max_len}: {m['completed']:.0f} "
        f"requests of {min(map(len, prompts))}-{max(map(len, prompts))} "
        f"prompt tokens, {ticks} decode steps (graph replays), {prefills} "
        f"prefills, {m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"launches {json.dumps(counts)}")
    return eng, counts


def _norms_vs_plain(phase: str, seed: int, widths, rows, timed,
                    flush) -> dict:
    """K3 and the fused add + norm at a model's widths ``widths`` against
    their plain versions over ``rows``, the (M, dtype) pairs its path
    gives them: bf16 within BF16_ATOL/RTOL, f32 within F32_TOL; ``s``
    bit-equal to torch's add.  The (name, D) pairs of ``timed`` are
    timed at a decode step's 8 bf16 rows beside their bound and plain
    time (and ``F.rms_norm``, the one library call for the plain norm;
    none computes the fused add + norm).  Returns their rows."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out, errs = {}, []
    for d in widths:
        for m, dt in rows:
            x, y = (torch.randn((m, d), generator=gen, device="cuda")
                    .to(dt) for _ in range(2))
            w = 0.1 * torch.randn((d,), generator=gen, device="cuda")
            tol = F32_TOL if dt == torch.float32 else (BF16_ATOL, BF16_RTOL)
            tag = f"[D={d}, M={m}, {str(dt)[6:]}]"
            got = ops.rmsnorm(x, w, impl="kernel")
            torch.cuda.synchronize()
            e_norm = check_close("rmsnorm" + tag, got,
                                 ops.rmsnorm(x, w, impl="plain"), *tol)
            (s, n), (s_p, n_p) = (ops.add_rmsnorm(x, y, w, impl=impl)
                                  for impl in ("kernel", "plain"))
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            assert torch.equal(s.view(bits), (x + y).view(bits)) and \
                torch.equal(s_p, x + y), \
                f"add_rmsnorm{tag}: s is not bit-equal to x + y"
            e_add = check_close("add_rmsnorm" + tag, n, n_p, *tol)
            errs.append(f"D={d} M={m} {str(dt)[6:]} {e_norm:.3e} / "
                        f"{e_add:.3e}")
            if m != 8 or dt != torch.bfloat16:
                continue
            if ("rmsnorm", d) in timed:
                w_lib = (1.0 + w).bfloat16()
                ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="kernel"), flush)
                plain_ms = cuda_ms(lambda: ops.rmsnorm(x, w, impl="plain"),
                                   flush)
                lib_ms = cuda_ms(lambda: F.rms_norm(x, (d,), weight=w_lib,
                                                    eps=1e-6), flush)
                b_ms, b_by = bound(2 * x.numel() * 2 + d * 4,
                                   4.0 * x.numel())
                log(phase, f"rmsnorm[D={d}, M=8] kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms F.rms_norm {lib_ms:.4f} ms bound "
                    f"{b_ms:.5f} ms ({b_by})")
                out[f"rmsnorm[D={d}]"] = dict(
                    name="rmsnorm", max_abs_err=e_norm, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, library="F.rms_norm")
            if ("add_rmsnorm", d) in timed:
                ms = cuda_ms(lambda: ops.add_rmsnorm(x, y, w, impl="kernel"),
                             flush)
                plain_ms = cuda_ms(
                    lambda: ops.add_rmsnorm(x, y, w, impl="plain"), flush)
                # read x, y and w, write s and the norm
                b_ms, b_by = bound(4 * x.numel() * 2 + d * 4,
                                   5.0 * x.numel())
                log(phase, f"add_rmsnorm[D={d}, M=8] kernel {ms:.4f} ms "
                    f"plain {plain_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
                out[f"add_rmsnorm[D={d}]"] = dict(
                    name="add_rmsnorm", max_abs_err=e_add, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, library=None)
    log(phase, "rmsnorm / add_rmsnorm against plain (s bit-equal to x + y), "
        "max|err|: " + ", ".join(errs))
    return out


def _ssm_step_vs_f32(eng) -> None:
    """The bf16 decode step on the engine's slots (``_decode_state``'s
    tokens, the states Run A left) with the kernels and with the plain
    versions, each held to the f32 step (plain versions) of the same
    weights and states widened, on the first SSM_STEP_LAYERS layers: the
    kernels' step may lie no further from it than TICK_F32_RATIO times
    the plain versions' (per slot RMS and largest difference).  A planted
    fault, the gated norm's rows handed one slot down, must fail both."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    params, cache, cfg = _first_layers(eng.params, eng.cache, eng.cfg,
                                       SSM_STEP_LAYERS)
    tok, pos = _decode_state(eng)

    def step(impl, p=params, c=cache, cfg=cfg):
        return M.decode_step(p, cfg, _clone(c), tok, pos,
                             impl=impl)[0][:, -1].float()
    lf = step("plain", tree_map(lambda t: t.float(), params),
              {p: {k: t.float() for k, t in ent.items()}
               for p, ent in cache.items()},
              dataclasses.replace(cfg, compute_dtype="float32"))

    def ratios(lk, lp):
        assert bool(torch.isfinite(lk).all()), "ssm: non-finite logits"
        ek, ep = (lk - lf).abs(), (lp - lf).abs()
        rows = ek.square().mean(-1).sqrt() / ep.square().mean(-1).sqrt()
        return rows, ek.max().item() / ep.max().item(), ek, ep
    lp, lk = step("plain"), step("kernel")
    rows, peak, ek, ep = ratios(lk, lp)
    rmsnorm = ops.rmsnorm
    d_inner = cfg.ssm.expand * cfg.d_model

    def shifted(x, w, **kw):
        out = rmsnorm(x, w, **kw)
        if kw.get("impl") == "plain" or x.shape[-1] != d_inner:
            return out
        return torch.roll(out, 1, dims=0)
    ops.rmsnorm = shifted
    try:
        bad_rows, bad_peak, _, _ = ratios(step("kernel"), lp)
    finally:
        ops.rmsnorm = rmsnorm
    log("ssm", f"bf16 decode step on the first {SSM_STEP_LAYERS} layers "
        f"against the f32 step (largest |logit| {lf.abs().max().item():.3e}): "
        f"kernels max|Δ| {ek.max().item():.3e}, plain max|Δ| "
        f"{ep.max().item():.3e} (ratio {peak:.3f}); per slot RMS ratio "
        f"kernels/plain {[round(r, 3) for r in rows.tolist()]}; kernels vs "
        f"plain max|Δ| {(lk - lp).abs().max().item():.3e}; planted fault "
        f"[gated norm rows one slot down]: per slot RMS ratio "
        f"{[round(r, 3) for r in bad_rows.tolist()]}, max ratio "
        f"{bad_peak:.3f}")
    assert rows.max().item() <= TICK_F32_RATIO and peak <= TICK_F32_RATIO, \
        f"ssm: the kernels' bf16 step lies further from the f32 step than " \
        f"{TICK_F32_RATIO}x the plain versions' (per slot {rows.tolist()}, " \
        f"largest {peak:.3f})"
    fails = (bad_rows.max().item() > TICK_F32_RATIO,
             bad_peak > TICK_F32_RATIO)
    assert all(fails), f"ssm: a planted fault passes the f32 step test " \
        f"(per slot, largest difference: {fails})"


def _ssm_prefill_vs_decode(cfg, params) -> None:
    """In f32 at full width (``params`` widened): the last logits of
    ``prefill`` of S tokens against ``prefill`` of S - 1 and one
    ``decode_step`` on its cache, at S in SSM_PD_LENGTHS, within
    SSM_PD_LIMIT of the largest logit: the chunked SSD and the per-token
    recurrence carry the same state."""
    import dataclasses
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    rng = np.random.default_rng(24)
    out = []
    for S in SSM_PD_LENGTHS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S))
                                .astype(np.int32)).cuda()
        want, _ = M.prefill(p32, cfg, {"tokens": toks})
        _, cache = M.prefill(p32, cfg, {"tokens": toks[:, :-1]})
        got, _ = M.decode_step(p32, cfg, cache, toks[:, -1:], torch.full(
            (2,), S - 1, dtype=torch.int32, device="cuda"))
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        assert bool(torch.isfinite(got).all()) and err <= SSM_PD_LIMIT * \
            scale, f"ssm: prefill({S}) against prefill({S - 1}) + decode: " \
            f"max|Δ| {err:.3e} > {SSM_PD_LIMIT} × {scale:.3e}"
        same = int((got.argmax(-1) == want.argmax(-1)).sum())
        out.append(f"S={S} {err:.3e} ({err / scale:.2e} of {scale:.3f}; "
                   f"top-1 equal {same}/2)")
    log("ssm", "f32 prefill(S) against prefill(S - 1) + decode_step, "
        "max|Δlogit|: " + "; ".join(out))


def _ssm_long(cfg, params, ref) -> None:
    """The O(1) state: an engine of 8 slots at max_len SSM_LONG + SSM_GEN
    + 1 holds the same state bytes as Run A's ``ref`` (max_len
    SSM_MAX_LEN), the config's arithmetic; it serves one request of
    SSM_LONG prompt tokens and SSM_GEN new (launches exact); its steady
    decode step is profiled beside Run A's."""
    want = _ssm_state_bytes(cfg, 8)
    prompt = np.random.default_rng(25).integers(
        0, cfg.vocab_size, SSM_LONG).astype(np.int32)
    eng, _ = _ssm_engine(cfg, params, [prompt], None,
                         SSM_LONG + SSM_GEN + 1)
    held = (_tree_bytes(ref.cache), _tree_bytes(eng.cache))
    assert held == (want, want), f"ssm: slot state {held} B at max_len " \
        f"{SSM_MAX_LEN} and {SSM_LONG + SSM_GEN + 1}, expected {want} B"
    m = eng.metrics.snapshot()
    log("ssm", f"O(1) state: 8 slots hold {want / 2 ** 20:.2f} MiB at "
        f"max_len {SSM_MAX_LEN} and at {SSM_LONG + SSM_GEN + 1} "
        f"({want // 8 / 2 ** 20:.3f} MiB a slot); a prompt of {SSM_LONG} "
        f"tokens prefilled in {m['ttft_avg_s'] * 1e3:.1f} ms (TTFT)")
    _profile_graph_decode_step(ref, "ssm", f"{MAMBA} run A engine (max_len "
                               f"{SSM_MAX_LEN})")
    _profile_graph_decode_step(eng, "ssm", f"{MAMBA} long engine (max_len "
                               f"{SSM_LONG + SSM_GEN + 1})")


def _fixed_only_cli(arch: str, phase: str, prompt_len) -> None:
    """For an arch the reference serves on fixed slots only: ``serve()``
    at full width (the static batch behind ``--engine batch``: 4 prompts
    of ``prompt_len`` tokens, 16 new; none where ``prompt_len`` is None,
    for a model whose full depth the card cannot hold: ``serve()`` builds
    every layer), then ``python -m repro_torch.launch.serve --arch
    <arch>`` with its defaults (reduced config), and ``--engine paged``,
    which must exit non-zero with the paged engine's refusal (the CLI
    runs queued for ``phase_cli``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    vocab = get_config(arch).vocab_size
    if prompt_len is not None:
        r = serve(arch, batch=4, prompt_len=prompt_len, gen=16,
                  reduced=False, device="cuda")
        g = r["generated"]
        assert g.shape == (4, 16) and ((g >= 0) & (g < vocab)).all(), g
        log(phase, f"serve() at full width: prefill="
            f"{r['prefill_s'] * 1e3:.0f}ms decode="
            f"{r['decode_s'] * 1e3:.0f}ms throughput="
            f"{r['tokens_per_s']:.1f} tok/s (batch 4, prompt "
            f"{prompt_len}, 16 new)")
    def batch(out):
        assert out.returncode == 0 and "throughput=" in out.stdout, \
            f"serve --arch {arch}: rc {out.returncode}\n" \
            f"{out.stderr[-3000:]}"
        for ln in out.stdout.splitlines():
            log(phase, f"cli --engine batch: {ln}")

    def paged(out):
        msg = "use ServingEngine for ssm/enc-dec/frontend archs"
        assert out.returncode != 0 and msg in out.stderr, \
            f"serve --arch {arch} --engine paged: rc " \
            f"{out.returncode}\n{out.stderr[-3000:]}"
        log(phase, f"cli --engine paged: rc {out.returncode}, "
            f"{out.stderr.strip().splitlines()[-1]}")
    CLI_JOBS.append((["--arch", arch, "--engine", "batch"], batch))
    CLI_JOBS.append((["--arch", arch, "--engine", "paged"], paged))


def phase_ssm():
    """mamba2-130m at full width on the fixed-slot engine.  Returns the
    two new K3 rows and Run A's launch counts."""
    from repro_torch.runtime.sampler import SamplingParams
    t0 = time.perf_counter()
    cfg, params = _draw_cast(MAMBA, "ssm")
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    log("ssm", f"SSM: d_inner {d_inner}, {d_inner // s.head_dim} heads of "
        f"{s.head_dim}, d_state {s.d_state}, conv width {s.conv_width}, "
        f"{s.n_groups} group, chunk {s.chunk_size}")
    prompts = _ssm_prompts(cfg)
    sampling = SamplingParams(temperature=0.9, seed=23)
    eng, counts = _ssm_engine(cfg, params, prompts, sampling, SSM_MAX_LEN)
    _fixed_graph_vs_eager(eng, phase="ssm")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # K3 and the fused add + norm at mamba2-130m's two widths, D = 768
    # (d_model: layer 0's ln1, each layer's add fused into the next norm)
    # and D = 1536 (d_inner: the gated norm), neither a power of two: a
    # decode step's 8 rows, the longest prompt, f32 at the checks' rows
    rows = _norms_vs_plain(
        "ssm", 22, (768, 1536),
        ((8, torch.bfloat16), (max(map(len, prompts)), torch.bfloat16),
         (8, torch.float32), (max(SSM_PD_LENGTHS), torch.float32)),
        {("rmsnorm", 1536), ("add_rmsnorm", 768)}, flush)
    del flush
    t1 = time.perf_counter()
    _ssm_step_vs_f32(eng)
    _ssm_prefill_vs_decode(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _ssm_long(cfg, params, eng)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    _fixed_only_cli(MAMBA, "ssm", 1000)
    log("ssm", f"phase times: run A and the norms {t1 - t0:.1f} s, the f32 "
        f"checks {t2 - t1:.1f} s, the long prompt {t3 - t2:.1f} s, serve() "
        f"{time.perf_counter() - t3:.1f} s")
    return rows, {"ssm": counts}


WHISPER_REQUESTS = 24
WHISPER_MAX_LEN = 448          # whisper's published text context
# prompt lengths every run takes: the shortest and longest, a tile of 64
# keys and around it; the rest drawn in [8, 384]; 32-64 new tokens each
WHISPER_FIXED_LENGTHS = (8, 63, 64, 65, 127, 255, 383, 384)
# f32 prefill(S) against prefill(S - 1) + one decode_step, S - 1 in:
WHISPER_PD_LENGTHS = (1, 64, 383)
WHISPER_PD_LIMIT = 1e-3        # of the largest logit, as phase ssm's


def _whisper_requests(cfg) -> list:
    """(prompt, new tokens) of WHISPER_REQUESTS requests: prompts of
    WHISPER_FIXED_LENGTHS and the rest drawn in [8, 384], 32-64 new
    tokens each, shuffled."""
    rng = np.random.default_rng(31)
    n = WHISPER_REQUESTS - len(WHISPER_FIXED_LENGTHS)
    lens = [*WHISPER_FIXED_LENGTHS, *rng.integers(8, 385, n)]
    lens = [int(lens[i]) for i in rng.permutation(len(lens))]
    gens = [int(g) for g in rng.integers(32, 65, len(lens))]
    assert max(a + b for a, b in zip(lens, gens)) <= WHISPER_MAX_LEN
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
            for n, g in zip(lens, gens)]


def whisper_launches(cfg, ticks: int, prefills: int) -> dict:
    """The kernel launches of ``ticks`` fixed-slot decode steps and
    ``prefills`` prefills of an encoder-decoder model: per decode step
    K4 per decoder layer for its self-attention and for its
    cross-attention, layer 0's ln1 alone and three fused add + norms per
    decoder layer (into ln_cross, ln2 and the next norm); per prefill K5
    non-causal per encoder layer (the frames) and per decoder layer (the
    prompt against the frames), K5 causal per decoder layer, and the
    norms of both stacks (the encoder's: its layer 0's ln1 alone, two
    fused per layer)."""
    L, E, D = cfg.num_layers, cfg.num_encoder_layers, cfg.d_model
    return {"decode_attention[bf16]": 2 * L * ticks,
            "flash_attention[full]": (E + L) * prefills,
            "flash_attention[causal]": L * prefills,
            f"rmsnorm[D={D}]": ticks + 2 * prefills,
            f"add_rmsnorm[D={D}]": 3 * L * (ticks + prefills)
            + 2 * E * prefills}


def _whisper_engine(cfg, params, requests, sampling):
    """Run A: the fixed-slot engine (8 slots, max_len WHISPER_MAX_LEN)
    over ``requests``, every second sampled with ``sampling`` and the
    others greedy, each prefill on the reference's stub frames (zeros):
    all finished in the vocabulary, logits finite, launch counts exact
    (``whisper_launches``).  Returns (engine, launches read just after
    the run)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import ServingEngine
    eng = ServingEngine(cfg, params, slots=8, max_len=WHISPER_MAX_LEN,
                        device="cuda")
    assert eng.policy._decode_fn.graph is not None, \
        "whisper: the decode step was not captured"
    for i, (p, g) in enumerate(requests):
        eng.submit(p, max_new_tokens=g, sampling=sampling if i % 2 else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                       # the main path starts here
    done = eng.run()
    counts = dict(ops.launches)                # ... and ends here
    assert len(done) == len(requests), f"whisper: {len(done)} finished"
    for q in done:
        assert len(q.generated) == q.max_new_tokens, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), \
            f"whisper: rid {q.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), "whisper: a logit was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    want = whisper_launches(cfg, ticks, prefills)
    assert counts == want, f"whisper: launches {counts}, expected {want} " \
        f"for {ticks} decode steps and {prefills} prefills"
    m = eng.metrics.snapshot()
    lens = [len(p) for p, _ in requests]
    log("whisper", f"Run A, fixed-slot engine (8 slots, max_len "
        f"{WHISPER_MAX_LEN}): {m['completed']:.0f} requests of "
        f"{min(lens)}-{max(lens)} prompt tokens and "
        f"{min(g for _, g in requests)}-{max(g for _, g in requests)} new, "
        f"{ticks} decode steps (graph replays), {prefills} prefills, "
        f"{m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"launches {json.dumps(counts)}")
    return eng, counts


def _whisper_graph(eng) -> None:
    """The captured decode step against eager (``_fixed_graph_vs_eager``)
    after every slot's ``ck``/``cv`` is filled with random values in place
    (Run A's stub frames leave them zero): logits, ``k``/``v`` and
    ``ck``/``cv`` bit for bit, and ``ck``/``cv`` still the values written,
    an idle slot's ride included."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    cross = {}
    for p, ent in eng.policy.cache.items():
        for key in ("ck", "cv"):
            ent[key].copy_(torch.randn(ent[key].shape, generator=gen,
                                       device="cuda"))
            cross[f"{p}.{key}"] = ent[key].clone()
    _fixed_graph_vs_eager(eng, phase="whisper")
    _assert_bits("whisper: ck/cv after the decode step", {
        name: (eng.policy.cache[name.split(".")[0]][name.split(".")[1]], t)
        for name, t in cross.items()})
    log("whisper", f"ck/cv filled with random values: graph replay == "
        f"eager, and the {len(cross)} ck/cv tensors unchanged by the step "
        "(an idle slot parked on the scratch row among the 8)")


def _whisper_batch(cfg, rng, S: int) -> dict:
    """Two prompts of ``S`` tokens and their frames, standard normal
    (2, encoder_len, frontend_dim), from numpy ``rng``, on the card."""
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, S)).astype(np.int32)).cuda(),
            "audio": torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder_len, cfg.frontend_dim),
                dtype=np.float32)).cuda()}


def _whisper_random_frames(cfg, params) -> None:
    """The kernels against their plain versions at full width on frames
    and prompts from a numpy seed (the engine's stub frames zero every
    cross output).  In bf16: ``prefill`` of 2 prompts of 383 tokens into
    a cache of WHISPER_MAX_LEN + 1 rows and one ``decode_step``, with the
    kernels and with the plain versions; each K4/K5 call of the kernel
    run held to its plain version on its own inputs (``_held_to_plain``:
    K5 non-causal 1500 x 1500 and 383 x 1500, causal 383, K4 over 449
    and 1500 rows); logged, the distance of the kernels' and of the plain
    versions' logits from the f32 logits (the plain versions on the same
    weights widened).  That distance is no check: at random weights the
    scores are nearly one-hot and reach hundreds, a bf16 rounding of q or
    k moves them by more than the gap between the top keys, and both
    bf16 runs lie about the largest logit's size from f32 (PERF.md §6).
    The whole model is held in f32 instead (K5 on
    its CUDA-core route, the f32 K4): ``prefill`` of S tokens against
    ``prefill`` of S - 1 and one ``decode_step`` at S - 1 in
    WHISPER_PD_LENGTHS within WHISPER_PD_LIMIT of the largest logit, the
    calls of S - 1 = 383 held to plain; a planted fault, every slot's
    cross K/V handed to the next slot, must exceed that limit."""
    import dataclasses
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    rng = np.random.default_rng(33)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    opts = M.RunOptions(q_chunk=512)
    S = WHISPER_PD_LENGTHS[-1]
    batch = _whisper_batch(cfg, rng, S)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))
                           .astype(np.int32)).cuda()
    pos = torch.full((2,), S, dtype=torch.int32, device="cuda")
    calls, errs, out = [], {}, {}
    for impl, p, c in (("kernel", params, cfg), ("plain", params, cfg),
                       ("f32", p32, cfg32)):
        mode = "plain" if impl == "f32" else impl
        with _recording(calls, lambda: impl == "kernel"):
            lp, cache = M.prefill(p, c, batch, opts, impl=mode)
            ld, _ = M.decode_step(p, c, M.grow_cache(
                cache, WHISPER_MAX_LEN + 1), tok, pos, impl=mode)
        out[impl] = (lp[:, -1].float(), ld[:, -1].float())
        del cache
    _held_to_plain(calls, errs, "whisper bf16")
    ratios = []
    for i, what in enumerate(("prefill", "decode step")):
        lk, lp, lf = (out[impl][i] for impl in ("kernel", "plain", "f32"))
        assert bool(torch.isfinite(lk).all()), f"whisper: {what} not finite"
        ek, ep = (lk - lf).abs(), (lp - lf).abs()
        ratios.append(f"{what}: kernels max|Δ| {ek.max().item():.3e}, plain "
                      f"{ep.max().item():.3e}, kernels vs plain "
                      f"{(lk - lp).abs().max().item():.3e}, largest |logit| "
                      f"{lf.abs().max().item():.3f}")
    log("whisper", "bf16 on random frames, K4/K5 calls against plain on "
        "their own inputs, scaled (calls, max|err| scaled within "
        "BF16_ATOL/RTOL, max|err| raw): " + "; ".join(
            f"{key} {n}, {e:.3e}, {raw:.3e}"
            for key, (n, e, raw) in errs.items()))
    log("whisper", "bf16 logits against the f32 logits (information): "
        + "; ".join(ratios))
    errs.clear()
    res = []
    for n in WHISPER_PD_LENGTHS:
        batch = _whisper_batch(cfg, rng, n + 1)
        toks = batch["tokens"]
        want, _ = M.prefill(p32, cfg32, batch, opts)
        with _recording(calls, lambda: n == WHISPER_PD_LENGTHS[-1]):
            _, cache = M.prefill(p32, cfg32, {**batch,
                                              "tokens": toks[:, :n]}, opts)
            cache = M.grow_cache(cache, n + 1)
            pos = torch.full((2,), n, dtype=torch.int32, device="cuda")
            got, _ = M.decode_step(p32, cfg32, _clone(cache), toks[:, n:],
                                   pos)
        _held_to_plain(calls, errs, "whisper f32")
        swapped = {p: {k: (t.roll(1, dims=1) if k in ("ck", "cv") else t)
                       for k, t in ent.items()} for p, ent in cache.items()}
        bad, _ = M.decode_step(p32, cfg32, swapped, toks[:, n:], pos)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        bad_err = (bad - want).abs().max().item()
        assert bool(torch.isfinite(got).all()) and \
            err <= WHISPER_PD_LIMIT * scale, f"whisper: prefill({n + 1}) " \
            f"against prefill({n}) + decode: max|Δ| {err:.3e} > " \
            f"{WHISPER_PD_LIMIT} × {scale:.3e}"
        assert bad_err > WHISPER_PD_LIMIT * scale, f"whisper: the planted " \
            f"fault (cross K/V of the next slot) passes at S = {n + 1}: " \
            f"max|Δ| {bad_err:.3e}"
        same = int((got.argmax(-1) == want.argmax(-1)).sum())
        res.append(f"S={n + 1} {err:.3e} ({err / scale:.2e} of {scale:.3f}; "
                   f"top-1 equal {same}/2; fault {bad_err / scale:.2e})")
    log("whisper", "f32 prefill(S) against prefill(S - 1) + decode_step, "
        "max|Δlogit|: " + "; ".join(res))
    log("whisper", "f32 K4/K5 calls of S - 1 = "
        f"{WHISPER_PD_LENGTHS[-1]} against plain, scaled (calls, max|err| "
        "scaled within F32_TOL, max|err| raw): " + "; ".join(
            f"{key} {n}, {e:.3e}, {raw:.3e}"
            for key, (n, e, raw) in errs.items()))


def _whisper_timing(cfg, flush) -> dict:
    """K5 non-causal and K4 at whisper-base's shapes (bf16, 8 heads over
    8 of 64, unit-scale random inputs) against plain within
    BF16_ATOL/RTOL, timed beside their plain versions, their bounds and
    SDPA with the same (empty) mask: K5 over the encoder's 1500 frames
    and over the longest prompt (384) against them, K4 over 8 slots of
    1500 cross rows, every row kept.  Returns the rows of the encoder's
    K5 and of K4."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    heads, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    L = cfg.encoder_len
    gen = torch.Generator(device="cuda").manual_seed(34)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    rows = {}
    k, v = draw(1, L, kvh, d), draw(1, L, kvh, d)
    for Sq in (L, max(WHISPER_FIXED_LENGTHS)):
        q = draw(1, Sq, heads, d)

        def run(impl, q=q):
            return ops.flash_attention(q, k, v, causal=False, impl=impl)
        err = check_close(f"whisper flash[{Sq}x{L}, full]", run("kernel"),
                          run("plain"), BF16_ATOL, BF16_RTOL)
        ms = cuda_ms(lambda: run("kernel"), flush)
        plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = cuda_ms(lambda: sdpa(SDPBackend.FLASH_ATTENTION, qs, ks,
                                      vs), flush)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4.0 * d * heads * Sq * L
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        log("whisper", f"flash_attention[full] {Sq}x{L} H={heads} KVH={kvh} "
            f"d={d}: max|err| {err:.3e} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms {SDPA_FLASH} {lib_ms:.4f} ms bound "
            f"{b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.2f} GFLOP at the bf16 tensor-core rate)")
        if Sq == L:
            rows["flash_attention[full]"] = dict(
                name="flash_attention", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library=SDPA_FLASH)
    B = 8
    q, k, v = draw(B, 1, heads, d), draw(B, L, kvh, d), draw(B, L, kvh, d)
    lengths = torch.full((B,), L, dtype=torch.int32, device="cuda")

    def run(impl):
        return ops.decode_attention(q, k, v, lengths, impl=impl)
    err = check_close("whisper decode_attention[bf16, cross]", run("kernel"),
                      run("plain"), BF16_ATOL, BF16_RTOL)
    _check_tickets("whisper dense decode", da._tickets.values())
    ms = cuda_ms(lambda: run("kernel"), flush)
    plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, ks, vs),
                     flush)
    nbytes = 2 * k.numel() * 2 + 2 * q.numel() * 2 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * B * L * heads * d)
    splits, chunk = da.split_plan(B, kvh, L, _sms())
    log("whisper", f"decode_attention[bf16] cross, {B} slots of {L} rows "
        f"H={heads} KVH={kvh} d={d}: max|err| {err:.3e} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms bound "
        f"{b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB; {splits} splits of "
        f"{chunk})")
    rows["decode_attention[bf16,d=64]"] = dict(
        name="decode_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=SDPA_EFF)
    return rows


def phase_whisper():
    """whisper-base at full width on the fixed-slot engine.  Returns the
    rows of K5 non-causal, K4 at d 64 and K3 and the fused add + norm at
    D = 512, and Run A's launch counts."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.runtime.sampler import SamplingParams
    t0 = time.perf_counter()
    cfg, params = _draw_cast(WHISPER, "whisper")
    log("whisper", f"encoder: {cfg.num_encoder_layers} layers over "
        f"{cfg.encoder_len} frames of {cfg.frontend_dim} (the frontend "
        f"stub's embeddings) through frontend_proj; decoder: "
        f"{cfg.num_layers} layers with cross-attention")
    requests = _whisper_requests(cfg)
    sampling = SamplingParams(temperature=0.9, seed=35)
    eng, counts = _whisper_engine(cfg, params, requests, sampling)
    _check_tickets("whisper fixed-slot", [eng.policy._tickets,
                                          *da._tickets.values()])
    _whisper_graph(eng)
    _profile_graph_decode_step(eng, "whisper", f"{WHISPER} Run A engine")
    del eng
    t1 = time.perf_counter()
    _whisper_random_frames(cfg, params)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = _whisper_timing(cfg, flush)
    # K3 and the fused add + norm at d_model 512, every norm of both
    # stacks: a decode step's 8 rows, the longest prompt, one request's
    # 1500 frames and two (the random-frame checks' batch), and f32 at
    # the checks' decode rows and frames
    D, L = cfg.d_model, cfg.encoder_len
    rows.update(_norms_vs_plain(
        "whisper", 36, (D,),
        ((8, torch.bfloat16), (max(WHISPER_FIXED_LENGTHS), torch.bfloat16),
         (L, torch.bfloat16), (2 * L, torch.bfloat16), (2, torch.float32),
         (2 * L, torch.float32)),
        {("rmsnorm", D), ("add_rmsnorm", D)}, flush))
    del flush, params
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _fixed_only_cli(WHISPER, "whisper", 128)
    log("whisper", f"phase times: run A {t1 - t0:.1f} s, kernels against "
        f"plain and timed {t2 - t1:.1f} s, serve() "
        f"{time.perf_counter() - t2:.1f} s")
    return rows, {"whisper": counts}


VISION_REQUESTS = 16
VISION_GEN = 32
VISION_MAX_LEN = 1056          # prompts of at most 1024 tokens + 32 new
# prompt lengths every run takes: the longest and one text row past the
# patch rows first (rids 0 and 1, the two prefills whose K5 calls are
# held to plain), the patch rows alone (on the engine's zero patches
# every activation of that prompt is 0), a key tile of 64 around 320,
# 511, 767 and 1023; the rest drawn in [256, 1024], all at least
# frontend_len (256)
VISION_FIXED_LENGTHS = (1024, 257, 256, 319, 320, 511, 767, 1023)
VISION_PATCH_S = 700           # the drawn-patch model checks' prompts
VISION_TF_MAX_LEN = 544        # teacher-forced: 8 prompts of 256-512 + 31
VISION_SERVE_PROMPT = 256      # serve() at full width: the least prompt


def _vision_requests(cfg) -> list:
    """VISION_REQUESTS prompts: VISION_FIXED_LENGTHS' first two, then the
    rest of them and lengths drawn in [256, 1024], shuffled."""
    rng = np.random.default_rng(41)
    n = VISION_REQUESTS - len(VISION_FIXED_LENGTHS)
    rest = [*VISION_FIXED_LENGTHS[2:], *rng.integers(cfg.frontend_len, 1025,
                                                     n)]
    lens = [*VISION_FIXED_LENGTHS[:2],
            *(int(rest[i]) for i in rng.permutation(len(rest)))]
    assert min(lens) >= cfg.frontend_len
    assert max(lens) + VISION_GEN <= VISION_MAX_LEN
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _vision_engine(cfg, params, prompts):
    """Run A: the fixed-slot engine (8 slots, max_len VISION_MAX_LEN) over
    ``prompts``, VISION_GEN greedy tokens each, every prefill on the
    reference's stub patches (zeros): all finished in the vocabulary,
    logits finite, launch counts exact (per prefill K5 causal per layer,
    per decode step K4 per layer, and the norms).  The K5 calls of the
    first two prefills (the longest prompt and one of 257) are
    recorded in the run (their inputs copied: ~0.6 GB of copies in two
    of the 16 prefills) and held to plain (``_held_to_plain``); the
    decode step is a graph replay, which no wrapper sees, so its K4
    calls are recorded from one eager ``decode_step`` on the engine's
    cache after the run (the replay is bit-equal to it:
    ``_fixed_graph_vs_eager``).  Returns (engine, launches read just
    after the run, the held calls' errors)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import ServingEngine
    eng = ServingEngine(cfg, params, slots=8, max_len=VISION_MAX_LEN,
                        device="cuda")
    assert eng.policy._decode_fn.graph is not None, \
        "vision: the decode step was not captured"
    for p in prompts:
        eng.submit(p, max_new_tokens=VISION_GEN)
    L = cfg.num_layers
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _recording(calls, lambda: len(calls) < 2 * L):
        ops.reset_launches()                   # the main path starts here
        done = eng.run()
        counts = dict(ops.launches)            # ... and ends here
    assert len(done) == len(prompts), f"vision: {len(done)} finished"
    for q in done:
        assert len(q.generated) == VISION_GEN, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), \
            f"vision: rid {q.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), "vision: a logit was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    want = {"decode_attention[bf16]": L * ticks,
            "flash_attention[causal]": L * prefills,
            **norm_launches(cfg, ticks + prefills)}
    assert counts == want, f"vision: launches {counts}, expected {want} " \
        f"for {ticks} decode steps and {prefills} prefills"
    m = eng.metrics.snapshot()
    lens = [len(p) for p in prompts]
    log("vision", f"Run A, fixed-slot engine (8 slots, max_len "
        f"{VISION_MAX_LEN}): {m['completed']:.0f} requests of "
        f"{min(lens)}-{max(lens)} prompt tokens and {VISION_GEN} new, "
        f"{ticks} decode steps (graph replays), {prefills} prefills, "
        f"{m['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"launches {json.dumps(counts)}")
    assert [c[1][0].shape[1] for c in calls[::L]] == \
        list(VISION_FIXED_LENGTHS[:2]), "vision: recorded the wrong prefills"
    errs = {}
    _held_to_plain(calls, errs, "vision engine prefill")
    tok, pos = _decode_state(eng)
    with _recording(calls):
        M.decode_step(eng.params, cfg, _clone(eng.cache), tok, pos)
    assert len(calls) == L, f"vision: {len(calls)} K4 calls in a step"
    _held_to_plain(calls, errs, "vision engine decode step")
    log("vision", "Run A's K5 calls (prefills of 1024 and 257) and one "
        "decode step's K4 calls against plain on their own inputs, scaled "
        "(calls, max|err| scaled within BF16_ATOL/RTOL, max|err| raw): "
        + "; ".join(f"{key} {n}, {e:.3e}, {raw:.3e}"
                    for key, (n, e, raw) in errs.items()))
    return eng, counts


def _vision_prefill_profile(eng) -> None:
    """One eager prefill of the longest prompt on the engine's stub
    patches, as the engine runs it, under ``_profile_steady`` (wall,
    busy, kernels, the top ones): what a prefill's TTFT is made of."""
    from repro_torch.models import model as M
    cfg = eng.cfg
    S = max(VISION_FIXED_LENGTHS)
    batch = {"tokens": torch.arange(S, dtype=torch.int32,
                                    device="cuda")[None] % cfg.vocab_size,
             "patches": torch.zeros((1, cfg.frontend_len, cfg.frontend_dim),
                                    device="cuda")}

    def step():
        logits, _ = M.prefill(eng.params, cfg, batch, eng.policy.opts)
        return logits.argmax(-1).cpu()
    _profile_steady("vision", f"prefill of {S} tokens, eager", step,
                    steps=2, top=8, groups=SERVING_GROUPS + (
                        ("flash attention (K5)", lambda key: "flash" in key),))


def _scaled_qk(params, cfg):
    """``params`` with every block's ``wq`` and ``wk`` scaled by
    sqrt(G / d_model) to their true fan-in (the reference's init takes a
    stacked leaf's G as its fan-in), rounded to the leaf's dtype; the
    other leaves shared."""
    s = (params["blocks"]["pos0"]["mixer"]["wq"].shape[0]
         / cfg.d_model) ** 0.5

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                ((v.float() * s).to(v.dtype) if k in ("wq", "wk") else v)
                for k, v in t.items()}
    return walk(params)


def _vision_patches(cfg, params) -> None:
    """The frontend and the kernels at full width on patches drawn from a
    numpy seed (the engine's stub patches embed as zero rows).

    - The embedding: rows [0, 256) are the bf16 patches through
      ``frontend_proj``, the rest the token embeddings, bit for bit; the
      drawn patches move the logits away from the zero patches'.
    - bf16: ``prefill`` of 2 prompts of VISION_PATCH_S tokens with their
      patches and one ``decode_step``, with the kernels and with the
      plain versions; each K4/K5 call of the kernel run held to plain on
      its own inputs (``_held_to_plain``); the distance of both runs'
      logits from the f32 logits logged (no check: at random weights the
      scores are near one-hot, PERF.md §6).
    - f32 (the weights widened): 8 prompts of 256-512 tokens with their
      patches, prefill and 31 decode steps teacher-forced, the kernels
      against the plain versions on decided positions (phase f32's
      method: every decided top-1 equal, >= 90% decided).
    - bf16 against f32 on the same streams, with wq and wk at their true
      fan-in (``_scaled_qk``, the CPU bf16 test's weights) so that the
      scores are O(1): the bf16 runs with the kernels and with the plain
      versions, each against the f32 run of the same weights widened;
      the kernels' largest |Δlogit| from f32 may be no more than
      TICK_F32_RATIO times the plain versions' (phase gemma's rule), and
      both runs' decided positions agree with f32 (information: how many
      are decided)."""
    import dataclasses
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    rng = np.random.default_rng(43)
    P, F = cfg.frontend_len, cfg.frontend_dim
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    opts = M.RunOptions(q_chunk=512)
    S = VISION_PATCH_S
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (2, S)).astype(np.int32)).cuda(),
             "patches": torch.from_numpy(rng.standard_normal(
                 (2, P, F), dtype=np.float32)).cuda()}
    x, _ = M._embed_inputs(params, cfg, batch)
    proj = batch["patches"].bfloat16() @ params["frontend_proj"]
    text = params["embed"][batch["tokens"].long()]
    assert torch.equal(x[:, :P], proj) and torch.equal(x[:, P:],
                                                       text[:, P:]), \
        "vision: the embedding is not the patch rows over the text rows"
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))
                           .astype(np.int32)).cuda()
    pos = torch.full((2,), S, dtype=torch.int32, device="cuda")
    calls, errs, out = [], {}, {}
    for impl, w, c in (("kernel", params, cfg), ("plain", params, cfg),
                       ("f32", p32, cfg32)):
        mode = "plain" if impl == "f32" else impl
        with _recording(calls, lambda: impl == "kernel"):
            lp, cache = M.prefill(w, c, batch, opts, impl=mode)
            ld, _ = M.decode_step(w, c, M.grow_cache(cache, S + 1), tok, pos,
                                  impl=mode)
        out[impl] = (lp[:, -1].float(), ld[:, -1].float())
        del cache, w
    zero, _ = M.prefill(params, cfg, {**batch, "patches": torch.zeros_like(
        batch["patches"])}, opts)
    moved = (zero[:, -1] - out["kernel"][0]).abs().max().item()
    assert moved > 0, "vision: the drawn patches left the logits unchanged"
    _held_to_plain(calls, errs, "vision bf16 drawn patches")
    ratios = []
    for i, what in enumerate(("prefill", "decode step")):
        lk, lp, lf = (out[impl][i] for impl in ("kernel", "plain", "f32"))
        assert bool(torch.isfinite(lk).all()), f"vision: {what} not finite"
        ratios.append(f"{what}: kernels max|Δ| {(lk - lf).abs().max():.3e}, "
                      f"plain {(lp - lf).abs().max():.3e}, kernels vs plain "
                      f"{(lk - lp).abs().max():.3e}, largest |logit| "
                      f"{lf.abs().max():.3f}")
    log("vision", f"embedding: rows [0, {P}) the bf16 patches through "
        f"frontend_proj and rows [{P}, {S}) the token embeddings, bit for "
        f"bit; drawn against zero patches moves the last logits by "
        f"{moved:.3e}")
    log("vision", "bf16 on drawn patches, K4/K5 calls against plain on "
        "their own inputs, scaled (calls, max|err| scaled within "
        "BF16_ATOL/RTOL, max|err| raw): " + "; ".join(
            f"{key} {n}, {e:.3e}, {raw:.3e}"
            for key, (n, e, raw) in errs.items()))
    log("vision", "bf16 logits against the f32 logits, weights as drawn "
        "(information): " + "; ".join(ratios))
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(P, VISION_TF_MAX_LEN - F32_GEN + 2, 8)]
    patches = [torch.from_numpy(rng.standard_normal(
        (1, P, F), dtype=np.float32)).cuda() for _ in prompts]
    tf = _fixed_teacher_forced({"plain": (p32, cfg32, "plain"),
                                "kernel": (p32, cfg32, "kernel")},
                               prompts, VISION_TF_MAX_LEN, patches)
    stats = _new_stats()
    for lp, lk in zip(tf["plain"], tf["kernel"]):
        _hold_decided(stats, lk, lp)
    _report_decided("f32 prefill + decode step on drawn patches", stats,
                    "vision")
    del tf, p32
    gc.collect()
    ps = _scaled_qk(params, cfg)
    ps32 = tree_map(lambda t: t.float(), ps)
    tf = _fixed_teacher_forced({"f32": (ps32, cfg32, "plain"),
                                "kernel": (ps, cfg, "kernel"),
                                "plain": (ps, cfg, "plain")},
                               prompts, VISION_TF_MAX_LEN, patches)
    lf, lk, lp = (torch.cat(tf[name]) for name in ("f32", "kernel", "plain"))
    ek, ep = (lk - lf).abs().max().item(), (lp - lf).abs().max().item()
    decided = {}
    for name, l in (("kernels", lk), ("plain", lp)):
        st = _new_stats()
        _hold_decided(st, l, lf)
        decided[name] = st
        assert st["agree"] == st["decided"], f"vision: bf16 {name} top-1 " \
            "differs from f32 at a decided position"
    log("vision", f"bf16 against f32 on the same {len(lf)} teacher-forced "
        f"positions, wq/wk at their true fan-in (largest |logit| "
        f"{lf.abs().max().item():.3f}): kernels max|Δ| {ek:.3e}, plain "
        f"{ep:.3e} (ratio {ek / ep:.3f}, limit {TICK_F32_RATIO}); decided "
        + ", ".join(f"{name} {st['decided']}/{st['rows']} (top-1 equal at "
                    f"all)" for name, st in decided.items()))
    assert ek <= TICK_F32_RATIO * ep, f"vision: the kernels' bf16 logits " \
        f"lie {ek / ep:.3f}x further from f32 than the plain versions'"


def _flash_cuda_cores(q, k, v) -> torch.Tensor:
    """K5's CUDA-core route on bf16 q/k/v, causal, launched through its C
    entry point (the wrapper routes bf16 at d 96 to the tensor cores
    now): the route bf16 at d 96 took before, timed once beside the
    tensor-core one.  Not a launch of the path: not counted."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _build.library("flash_attention").flash_attention(
        fa.CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Skv, H, KVH, d, 1, 0, *q.stride()[:3],
        *k.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"flash_attention (CUDA cores): CUDA error {err}"
    return out


def _attention_timing(cfg, phase: str, S: int, T: int, seed: int,
                      key: str, flush, cuda_cores: bool = False) -> dict:
    """K5 and K4 at ``cfg``'s shapes (bf16, its heads over its kv heads at
    its head dim, unit-scale random inputs from a generator seeded
    ``seed``) against plain within BF16_ATOL/RTOL, timed beside their
    plain versions, their bounds and SDPA with the same mask (K/V
    repeated to every head): K5 causal over a prompt of ``S`` tokens, on
    the tensor cores and, with ``cuda_cores``, once on the CUDA cores;
    K4 over 8 slots of ``T`` keys, every key kept.  Returns their rows,
    ``flash_attention[<key>]`` and ``decode_attention[<key>]``."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    heads, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    assert fa.route(torch.bfloat16, d) == "tensor cores"
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def heads_first(q, k, v):
        return (q.transpose(1, 2).contiguous(),
                *(t.transpose(1, 2).repeat_interleave(heads // kvh, dim=1)
                  .contiguous() for t in (k, v)))
    q, k, v = draw(1, S, heads, d), draw(1, S, kvh, d), draw(1, S, kvh, d)

    def run(impl):
        return ops.flash_attention(q, k, v, causal=True, impl=impl)
    want = run("plain")
    err = check_close(f"{phase} flash[causal, S={S}, d={d}]", run("kernel"),
                      want, BF16_ATOL, BF16_RTOL)
    ms = cuda_ms(lambda: run("kernel"), flush)
    cc_err = cc_time = ""
    if cuda_cores:
        err_cc = check_close(f"{phase} flash[causal, S={S}, d={d}], CUDA "
                             "cores", _flash_cuda_cores(q, k, v), want,
                             BF16_ATOL, BF16_RTOL)
        cc_ms = cuda_ms(lambda: _flash_cuda_cores(q, k, v), flush)
        cc_err = f" (CUDA cores {err_cc:.3e})"
        cc_time = f" (CUDA-core route {cc_ms:.4f} ms, {cc_ms / ms:.1f}x)"
    plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
    qs, ks, vs = heads_first(q, k, v)
    lib_ms = cuda_ms(lambda: sdpa(SDPBackend.FLASH_ATTENTION, qs, ks, vs,
                                  is_causal=True), flush)
    del qs, ks, vs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 2.0 * d * heads * S * (S + 1)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    log(phase, f"flash_attention[causal] S={S} H={heads} KVH={kvh} d={d}: "
        f"max|err| {err:.3e}{cc_err} kernel {ms:.4f} ms{cc_time} plain "
        f"{plain_ms:.4f} ms {SDPA_FLASH} {lib_ms:.4f} ms bound {b_ms:.5f} ms "
        f"({b_by}, {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP at the "
        "bf16 tensor-core rate)")
    rows = {f"flash_attention[{key}]": dict(
        name="flash_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=SDPA_FLASH)}
    B = 8
    q, k, v = draw(B, 1, heads, d), draw(B, T, kvh, d), draw(B, T, kvh, d)
    lengths = torch.full((B,), T, dtype=torch.int32, device="cuda")

    def run(impl):
        return ops.decode_attention(q, k, v, lengths, impl=impl)
    err = check_close(f"{phase} decode_attention[bf16, d={d}]", run("kernel"),
                      run("plain"), BF16_ATOL, BF16_RTOL)
    _check_tickets(f"{phase} dense decode", da._tickets.values())
    ms = cuda_ms(lambda: run("kernel"), flush)
    plain_ms = cuda_ms(lambda: run("plain"), flush, iters=5)
    qs, ks, vs = heads_first(q, k, v)
    lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, ks, vs),
                     flush)
    del qs, ks, vs
    nbytes = 2 * k.numel() * 2 + 2 * q.numel() * 2 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * B * T * heads * d)
    splits, chunk = da.split_plan(B, kvh, T, _sms())
    log(phase, f"decode_attention[bf16] {B} slots of {T} keys H={heads} "
        f"KVH={kvh} d={d}: max|err| {err:.3e} kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms {SDPA_EFF} {lib_ms:.4f} ms bound {b_ms:.5f} ms "
        f"({b_by}, {nbytes / 1e6:.2f} MB; {splits} splits of {chunk})")
    rows[f"decode_attention[{key}]"] = dict(
        name="decode_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=SDPA_EFF)
    return rows


def phase_vision():
    """phi-3-vision-4.2b at full width on the fixed-slot engine.  Returns
    the rows of K5 and K4 at d 96 and K3 and the fused add + norm at
    D = 3072, and Run A's launch counts."""
    from repro_torch.kernels import decode_attention as da
    t0 = time.perf_counter()
    cfg, params = _draw_cast(VISION, "vision")
    log("vision", f"frontend stub: {cfg.frontend_len} patch embeddings of "
        f"{cfg.frontend_dim} through frontend_proj over each prompt's first "
        "rows; the engine feeds zeros, serve() and the checks draw them")
    eng, counts = _vision_engine(cfg, params, _vision_requests(cfg))
    _fixed_graph_vs_eager(eng, phase="vision")
    _check_tickets("vision fixed-slot", [eng.policy._tickets,
                                         *da._tickets.values()])
    _profile_graph_decode_step(eng, "vision", f"{VISION} Run A engine")
    _vision_prefill_profile(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _vision_patches(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # K5 causal over the longest prompt (1024), beside the CUDA-core route
    # it took before, and K4 over 8 x 1056 keys, every key kept
    rows = _attention_timing(cfg, "vision", max(VISION_FIXED_LENGTHS),
                             VISION_MAX_LEN, 44, "d=96", flush,
                             cuda_cores=True)
    # K3 and the fused add + norm at d_model 3072: a decode step's 8 rows,
    # the shortest and the longest prompt, the drawn-patch checks' 2 x 700
    # rows, and f32 at the teacher-forced decode rows and prompts
    D = cfg.d_model
    rows.update(_norms_vs_plain(
        "vision", 45, (D,),
        ((8, torch.bfloat16), (cfg.frontend_len, torch.bfloat16),
         (max(VISION_FIXED_LENGTHS), torch.bfloat16),
         (2 * VISION_PATCH_S, torch.bfloat16), (8, torch.float32),
         (512, torch.float32)),
        {("rmsnorm", D), ("add_rmsnorm", D)}, flush))
    del flush, params
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    _fixed_only_cli(VISION, "vision", VISION_SERVE_PROMPT)
    log("vision", f"phase times: run A {t1 - t0:.1f} s, drawn patches "
        f"{t2 - t1:.1f} s, kernels timed {t3 - t2:.1f} s, serve() "
        f"{time.perf_counter() - t3:.1f} s")
    return rows, {"vision": counts}


HYBRID = "jamba-v0.1-52b"      # phase hybrid: 7 Mamba-2 layers to 1 attention
HYBRID_LAYERS = 16             # two of its four periods of 8: the card holds
#                                48.43 GiB of bf16 weights, not 32 layers' 95.85
HYBRID_REQUESTS = 16
HYBRID_GEN = 32
HYBRID_MAX_LEN = 1056          # prompts of at most 1024 tokens + 32 new
# prompt lengths every run takes: the longest first (rid 0, the prefill
# whose K5 and norm calls are held to plain), an SSD chunk of 256 and
# either side of it, two chunks and either side, 1000; the rest drawn in
# [256, 1024]
HYBRID_FIXED_LENGTHS = (1024, 255, 256, 257, 511, 512, 513, 1000)
HYBRID_TF_MAX_LEN = 544        # f32 teacher-forced: 8 prompts of 256-512 + 31
# a steady step's kernels by kind: the MoE tick's groups and the rest
# (elementwise ops, the SSM recurrence step and conv, dispatch, copies)
HYBRID_GROUPS = MOE_GROUPS + (
    ("the rest (elementwise, SSM step, dispatch, copies)",
     lambda key: not any(pick(key) for _, pick in MOE_GROUPS)),)


def _hybrid_requests(cfg) -> list:
    """HYBRID_REQUESTS prompts: HYBRID_FIXED_LENGTHS' first, then the rest
    of them and lengths drawn in [256, 1024], shuffled."""
    rng = np.random.default_rng(51)
    n = HYBRID_REQUESTS - len(HYBRID_FIXED_LENGTHS)
    rest = [*HYBRID_FIXED_LENGTHS[1:], *rng.integers(256, 1025, n)]
    lens = [HYBRID_FIXED_LENGTHS[0],
            *(int(rest[i]) for i in rng.permutation(len(rest)))]
    assert max(lens) == lens[0] and max(lens) + HYBRID_GEN <= HYBRID_MAX_LEN
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _norms_held(calls: list, errs: dict, what: str) -> None:
    """Each recorded K3 / fused add + norm call (``_recording`` with
    NORM_OPS) again with the kernel and with the plain version on its own
    inputs, raw: the norm divides by each row's RMS, so a power-of-two
    scale would change nothing but eps's share.  bf16 within
    BF16_ATOL/RTOL, f32 within F32_TOL; the fused form's sum bit-equal
    to torch's add.  ``errs`` maps ``name[D=...]`` to [calls, largest
    |kernel - plain|]."""
    from repro_torch.kernels import ops
    for name, args, kw in calls:
        fn = getattr(ops, name)
        got, want = (fn(*args, **{**kw, "impl": impl})
                     for impl in ("kernel", "plain"))
        x = args[0]
        if name == "add_rmsnorm":
            bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got[0].view(bits), (x + args[1]).view(bits)), \
                f"{what} {name}: s is not bit-equal to x + y"
            got, want = got[1], want[1]
        key = f"{name}[D={x.shape[-1]}]"
        tol = F32_TOL if x.dtype == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err = check_close(f"{what} {key}", got, want, *tol)
        row = errs.setdefault(key, [0, 0.0])
        row[0] += 1
        row[1] = max(row[1], err)
    calls.clear()


def _hybrid_engine(cfg, params, prompts, sampling):
    """Run A: the fixed-slot engine (8 slots, max_len HYBRID_MAX_LEN) over
    ``prompts``, HYBRID_GEN new tokens each, every second request
    sampled with ``sampling`` and the others greedy: all finished in the
    vocabulary, logits finite, launch counts exact (per prefill K5 causal
    on each attention layer, per decode step K4 on each, and the norms:
    ``norm_launches``).  The capacity path's dropped (token, expert)
    pairs are counted per prefill (eager) and, by an add captured into
    the decode graph, over the decode steps.  The first prefill's K5 and
    norm calls are recorded in the run and held to plain on their own
    inputs, as are one eager decode step's K4 and norm calls on the
    engine's cache after the run (the replay is bit-equal to it:
    ``_fixed_graph_vs_eager``).  Returns (engine, launches read just
    after the run)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime.serving import ServingEngine
    slots, m = 8, cfg.moe
    periods = cfg.num_layers // cfg.scan_period()
    n_moe = periods * cfg.mlp_kinds().count("moe")
    n_attn = layer_counts(cfg)[0]
    prefill_drops = []
    decode_drops = torch.zeros((), dtype=torch.int64, device="cuda")
    inner = moe_mod._expert_gemms_capacity

    def counted(p, mc, xs, sizes, dt):
        C = moe_mod.capacity(mc, xs.shape[0])
        dropped = (sizes - C).clamp(min=0).sum()
        if xs.shape[0] == slots * mc.top_k:
            decode_drops.add_(dropped)         # replayed with the step
        else:
            prefill_drops.append((xs.shape[0], C, dropped))
        return inner(p, mc, xs, sizes, dt)
    moe_mod._expert_gemms_capacity = counted
    try:
        eng = ServingEngine(cfg, params, slots=slots, max_len=HYBRID_MAX_LEN,
                            device="cuda")
        assert eng.policy._decode_fn.graph is not None, \
            "hybrid: the decode step was not captured"
        decode_drops.zero_()                   # the warm-up and capture's
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=HYBRID_GEN,
                       sampling=sampling if i % 2 else None)
        # a prefill's calls: K5 on each attention layer and the norms
        per_prefill = n_attn + sum(norm_launches(cfg, 1).values())
        calls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _recording(calls, lambda: len(calls) < per_prefill,
                        ATTENTION_OPS + NORM_OPS):
            ops.reset_launches()               # the main path starts here
            done = eng.run()
            counts = dict(ops.launches)        # ... and ends here
        dropped_decode = int(decode_drops)
    finally:
        moe_mod._expert_gemms_capacity = inner
    assert len(done) == len(prompts), f"hybrid: {len(done)} finished"
    for q in done:
        assert len(q.generated) == HYBRID_GEN, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), \
            f"hybrid: rid {q.rid} emitted a token outside the vocabulary"
    assert bool(eng.policy.logits_finite), "hybrid: a logit was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    want = {"decode_attention[bf16]": n_attn * ticks,
            "flash_attention[causal]": n_attn * prefills,
            **norm_launches(cfg, ticks + prefills)}
    assert counts == want, f"hybrid: launches {counts}, expected {want} " \
        f"for {ticks} decode steps and {prefills} prefills"
    met = eng.metrics.snapshot()
    lens = [len(p) for p in prompts]
    log("hybrid", f"Run A, fixed-slot engine (8 slots, max_len "
        f"{HYBRID_MAX_LEN}): {met['completed']:.0f} requests of "
        f"{min(lens)}-{max(lens)} prompt tokens and {HYBRID_GEN} new (every "
        f"second at temperature {sampling.temperature}), {ticks} decode "
        f"steps (graph replays), {prefills} prefills, "
        f"{met['tokens_per_s']:.1f} tokens/s, mean TTFT "
        f"{met['ttft_avg_s'] * 1e3:.1f} ms, wall {met['wall_s']:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"launches {json.dumps(counts)}")
    assert len(prefill_drops) == n_moe * prefills, len(prefill_drops)
    per = torch.stack([d for _, _, d in prefill_drops]).reshape(
        prefills, n_moe).sum(1).tolist()
    routed = [tk * n_moe for tk, _, _ in prefill_drops[::n_moe]]
    shares = [d / r for d, r in zip(per, routed)]
    decode_routed = ticks * n_moe * slots * m.top_k
    log("hybrid", f"capacity drops (factor {m.capacity_factor}, "
        f"{m.num_experts} experts top-{m.top_k}, {n_moe} MoE layers): "
        f"prefills {sum(per)} of {sum(routed)} routed (token, expert) pairs "
        f"({sum(per) / sum(routed):.4f}; per prefill mean "
        f"{statistics.mean(shares):.4f}, max {max(shares):.4f}, capacity "
        f"{prefill_drops[0][1]} slots at {prefill_drops[0][0]} pairs); "
        f"decode steps {dropped_decode} of {decode_routed} "
        f"({dropped_decode / decode_routed:.4f}; {slots * m.top_k} pairs a "
        f"layer into {moe_mod.capacity(m, slots * m.top_k)} slots an "
        "expert, idle slots' rides included)")
    attn = [c for c in calls if c[0] in ATTENTION_OPS]
    norms = [c for c in calls if c[0] in NORM_OPS]
    calls.clear()
    assert len(attn) == n_attn and all(
        c[1][0].shape[1] == lens[0] for c in attn), \
        "hybrid: recorded the wrong prefill"
    errs, norm_errs = {}, {}
    _held_to_plain(attn, errs, "hybrid engine prefill")
    _norms_held(norms, norm_errs, "hybrid engine prefill")
    tok, pos = _decode_state(eng)
    with _recording(calls, names=ATTENTION_OPS + NORM_OPS):
        M.decode_step(eng.params, cfg, _clone(eng.cache), tok, pos)
    attn = [c for c in calls if c[0] in ATTENTION_OPS]
    norms = [c for c in calls if c[0] in NORM_OPS]
    calls.clear()
    assert len(attn) == n_attn, f"hybrid: {len(attn)} K4 calls in a step"
    _held_to_plain(attn, errs, "hybrid engine decode step")
    _norms_held(norms, norm_errs, "hybrid engine decode step")
    log("hybrid", f"the prefill of {lens[0]} tokens and a decode step "
        f"(positions {pos.tolist()}), every kernel call against plain on "
        "its own inputs (calls, max|err|): " + "; ".join(
            f"{key} {n}, {e:.3e}" for key, (n, e) in norm_errs.items())
        + "; K4/K5 scaled within BF16_ATOL/RTOL (calls, max|err| scaled, "
        "max|err| raw): " + "; ".join(
            f"{key} {n}, {e:.3e}, {raw:.3e}"
            for key, (n, e, raw) in errs.items()))
    return eng, counts


def _fixed_step_bytes(eng) -> int:
    """Bytes one fixed-slot decode step of ``eng`` at ``_decode_state``'s
    positions must move: the weights (``_weight_bytes``), the K and V
    rows below each slot's length on the attention layers, each slot's
    conv tail and f32 state read and written on the SSM layers, and the
    f32 logits."""
    cfg = eng.cfg
    _, pos = _decode_state(eng)
    slots = len(pos)
    weights = _weight_bytes(cfg, eng.params, slots)
    kv = state = 0
    for ent in eng.cache.values():
        for key, t in ent.items():
            if key in ("k", "v"):
                # (G, slots, T, KVH, hd): the rows below pos + 1
                row = t.shape[0] * t[0, 0, 0].numel() * t.element_size()
                kv += row * int((pos + 1).sum())
            else:
                state += 2 * t.numel() * t.element_size()
    return weights + kv + state + slots * cfg.vocab_size * 4


def _hybrid_steady(cfg, params) -> None:
    """The steady decode step, captured by a fresh engine (no drop
    counting in its graph) and replayed at ``_decode_state``'s
    positions: wall, busy, kernels, idle share, its busy time by kernel
    group (HYBRID_GROUPS), and against its byte bound."""
    from repro_torch.runtime.serving import ServingEngine
    eng = ServingEngine(cfg, params, slots=8, max_len=HYBRID_MAX_LEN,
                        device="cuda")
    wall, busy = _profile_graph_decode_step(
        eng, "hybrid", f"{HYBRID} steady decode step", groups=HYBRID_GROUPS)
    nbytes = _fixed_step_bytes(eng)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log("hybrid", f"{HYBRID} steady decode step: byte bound {b_ms:.3f} ms "
        f"({nbytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: every "
        f"expert of the capacity path, the K/V rows and the states); device "
        f"busy {busy / b_ms:.2f}x and wall {wall / b_ms:.2f}x the bound")


def _hybrid_refusals(cfg, params) -> None:
    """What the reference refuses for this config, refused on the card
    too: no paged KV layout (``paged_cache_supported``; the paged engine
    raises its message)."""
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import PagedServingEngine
    assert not M.paged_cache_supported(cfg)
    try:
        PagedServingEngine(cfg, params, device="cuda", **ENGINE_KW)
    except ValueError as e:
        paged = str(e)
    else:
        raise AssertionError("hybrid: the paged engine took the hybrid")
    assert "use ServingEngine for ssm" in paged, paged
    log("hybrid", f"refused as the reference refuses: PagedServingEngine "
        f"({paged!r})")


def _hybrid_f32(layers: int) -> None:
    """The first ``layers`` layers (one period: 13.268 B parameters, 49.4
    GiB) drawn in f32 on the card after the bf16 tree is freed: 8 prompts of 256-512
    tokens teacher-forced through ``prefill`` and F32_GEN - 1 decode
    steps with the kernels and with the plain versions (K5 and K4 on
    their f32 routes, K3 in f32), the kernels held to the plain versions
    on decided positions (phase f32's method)."""
    cfg, p32 = _draw_cast(HYBRID, "hybrid", num_layers=layers,
                          compute_dtype="float32")
    rng = np.random.default_rng(53)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(256, HYBRID_TF_MAX_LEN - F32_GEN + 2,
                                     8)]
    tf = _fixed_teacher_forced({"plain": (p32, cfg, "plain"),
                                "kernel": (p32, cfg, "kernel")},
                               prompts, HYBRID_TF_MAX_LEN)
    stats = _new_stats()
    for lp, lk in zip(tf["plain"], tf["kernel"]):
        _hold_decided(stats, lk, lp)
    _report_decided(f"f32, one period ({cfg.num_layers} layers), prefill + "
                    "decode step", stats, "hybrid")


def phase_hybrid():
    """jamba-v0.1-52b at full width, HYBRID_LAYERS of its layers, on the
    fixed-slot engine.  Returns the rows of K3 at D = 4096 and 8192, the
    fused add + norm at 4096 and K4 and K5 at group 4, and Run A's
    launch counts."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.runtime.sampler import SamplingParams
    t0 = time.perf_counter()
    cfg, params = _draw_cast(HYBRID, "hybrid", num_layers=HYBRID_LAYERS)
    s, m = cfg.ssm, cfg.moe
    d_inner = s.expand * cfg.d_model
    log("hybrid", f"cut in depth only: {cfg.num_layers} layers, "
        f"{cfg.num_layers // cfg.scan_period()} whole periods of "
        f"{cfg.scan_period()} {cfg.layer_kinds()} with MLPs "
        f"{cfg.mlp_kinds()}; SSM d_inner {d_inner} in "
        f"{d_inner // s.head_dim} heads of {s.head_dim}, d_state "
        f"{s.d_state}, conv {s.conv_width}, {s.n_groups} group, chunk "
        f"{s.chunk_size}; MoE {m.num_experts} experts top-{m.top_k} of d_ff "
        f"{m.d_ff_expert}, no shared expert, capacity factor "
        f"{m.capacity_factor}")
    _hybrid_refusals(cfg, params)
    sampling = SamplingParams(temperature=0.9, seed=52)
    eng, counts = _hybrid_engine(cfg, params, _hybrid_requests(cfg),
                                 sampling)
    assert eng.cache["pos4"]["k"].shape[0] == 2 and \
        eng.cache["pos0"]["ssm"].dtype == torch.float32
    _fixed_graph_vs_eager(eng, phase="hybrid")
    _check_tickets("hybrid fixed-slot", [eng.policy._tickets,
                                         *da._tickets.values()])
    del eng
    gc.collect()
    _hybrid_steady(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # K5 causal over the longest prompt and K4 over 8 x 1057 keys, at 32
    # heads over 8 of 128 (group 4)
    rows = _attention_timing(cfg, "hybrid", max(HYBRID_FIXED_LENGTHS),
                             HYBRID_MAX_LEN + 1, 54, "G=4", flush)
    # K3 at d_model 4096 (layer 0's ln1) and d_inner 8192 (the gated
    # norm), the fused add + norm at 4096: a decode step's 8 rows, the
    # longest prompt, f32 at the teacher-forced decode rows and prompts
    D = cfg.d_model
    rows.update(_norms_vs_plain(
        "hybrid", 55, (D, d_inner),
        ((8, torch.bfloat16), (max(HYBRID_FIXED_LENGTHS), torch.bfloat16),
         (8, torch.float32), (HYBRID_TF_MAX_LEN, torch.float32)),
        {("rmsnorm", D), ("add_rmsnorm", D), ("rmsnorm", d_inner)}, flush))
    del flush, params
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _hybrid_f32(cfg.scan_period())
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config(HYBRID)
    log("hybrid", f"serve() at full width not run: it builds all "
        f"{full.num_layers} layers ("
        f"{M.count_params(M.param_specs(full)) * 2 / 2 ** 30:.2f} GiB in "
        "bf16), past the card; Run A is the full-width run, through "
        "ServingEngine")
    _fixed_only_cli(HYBRID, "hybrid", None)
    log("hybrid", f"phase times: run A and its checks {t1 - t0:.1f} s, "
        f"kernels timed {t2 - t1:.1f} s, f32 period {t3 - t2:.1f} s")
    return rows, {"hybrid": counts}


STREAM_REQUESTS = 16
STREAM_GEN = 32
MINICPM_TF_LAYERS = 4          # the f32 teacher-forced check's depth
MINICPM_TF_PROMPTS = 8


def _stream_requests(cfg) -> list:
    """(prompt, sampling) of STREAM_REQUESTS requests: the stream phase
    serve's ``serve_paged`` draws at seed 0 (a length in [64, 512), the
    prompt, a budget of 32), drawn for ``cfg``'s vocabulary; every second
    request at temperature 0.9, the others greedy."""
    from repro_torch.runtime.sampler import SamplingParams
    rng = np.random.default_rng(0)
    out = []
    for i in range(STREAM_REQUESTS):
        n = int(rng.integers(64, ENGINE_KW["max_seq_len"] - STREAM_GEN))
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        assert int(rng.integers(STREAM_GEN, STREAM_GEN + 1)) == STREAM_GEN
        out.append((prompt, SamplingParams(temperature=0.9, seed=60 + i)
                    if i % 2 else None))
    return out


def _held_line(what: str, errs: dict, norm_errs: dict) -> str:
    """The log line of ``_paged_held_to_plain``/``_held_to_plain``'s
    ``errs`` and ``_norms_held``'s ``norm_errs``."""
    return (f"{what}, every kernel call against plain on its own inputs "
            "(calls, max|err|): " + "; ".join(
                f"{key} {n}, {e:.3e}" for key, (n, e) in norm_errs.items())
            + "; attention scaled within BF16_ATOL/RTOL (calls, max|err| "
            "scaled, max|err| raw): " + "; ".join(
                f"{key} {n}, {e:.3e}, {raw:.3e}"
                for key, (n, e, raw) in errs.items()))


def _paged_run_a(cfg, params, requests, tag: str, phase: str,
                 eager: bool = True):
    """Run A on the graphed paged engine (ENGINE_KW) with a ``tag`` pool:
    ``_check_run``'s checks (all finished in the vocabulary, logits
    finite, K1/K2 once per layer per tick and the norms per model step,
    exactly); then, with ``eager``, the ``fused=False`` engine's greedy
    streams and trace, its 21st tick's K1/K2 and norm calls held to plain
    and, on an MoE model, its capacity drops logged; without, one fused
    tick from ``_tick_state`` with its K1/K2 and norm calls held to
    plain; each graph against eager bit for bit and the tickets back at
    0.  Returns (run, launches read just after it)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(cfg, params,
                             kv_dtype=None if tag == "bf16" else tag,
                             device="cuda", **ENGINE_KW)
    assert eng.policy._tick_fn.graph is not None, \
        f"{phase}: the fused tick was not captured"
    for prompt, sp in requests:
        eng.submit(prompt, max_new_tokens=STREAM_GEN, sampling=sp)
    ops.reset_launches()                       # the main path starts here
    done = eng.run()
    counts = dict(ops.launches)                # ... and ends here
    r = {"finished": done, "metrics": eng.metrics.snapshot(), "engine": eng}
    _check_run(tag, r, cfg, counts, phase=phase,
               requests=len(requests), gen=STREAM_GEN)
    calls, seen = [], []
    names = ("paged_decode_attention",) + NORM_OPS
    if eager:
        with (_capacity_calls(seen) if cfg.moe is not None
              else contextlib.nullcontext()):
            _eager_engine(tag, r, cfg, phase=phase, record=calls)
        what = "the fused=False engine's 21st tick"
    else:
        with _recording(calls, names=names):
            _tick(eng, _clone(eng.policy.cache), _tick_state(eng), "kernel")
        what = "one fused tick of the graphed engine's pool"
    if seen:
        _log_drops(phase, cfg, seen)
    paged = [c for c in calls if c[0] == "paged_decode_attention"]
    norms = [c for c in calls if c[0] in NORM_OPS]
    per_step = sum(norm_launches(cfg, 1).values())
    assert len(paged) == cfg.num_layers and norms and \
        len(norms) % per_step == 0, \
        f"{phase} {tag}: recorded {len(paged)} K1/K2 and {len(norms)} " \
        "norm calls in a tick and the chunks beside it"
    lengths = paged[0][1][4].tolist()
    chunks = len(norms) // per_step - 1
    errs, norm_errs = {}, {}
    _paged_held_to_plain(paged, errs, f"{phase} {tag} engine tick")
    _norms_held(norms, norm_errs, f"{phase} {tag} engine tick")
    log(phase, _held_line(f"{tag}: {what} (seat lengths {lengths}) and "
                          f"{chunks} prefill chunks beside it", errs,
                          norm_errs))
    gc.collect()
    torch.cuda.empty_cache()
    _graph_vs_eager(tag, eng, phase=phase)
    _check_tickets(f"{phase} {tag}: after the graphed runs",
                   [eng.policy._tickets, *da._tickets.values()])
    return r, counts


def _fixed_run_a(cfg, params, requests, paged: dict, phase: str,
                 groups=SERVING_GROUPS) -> dict:
    """The requests on the fixed-slot ``ServingEngine`` (8 slots,
    MAX_LEN): all finished in the vocabulary, logits finite, K4 once per
    layer per decode step and K5 once per layer per prompt, the norms per
    model call, exactly; the first prefill's K5 and norm calls and one
    eager decode step's K4 and norm calls held to plain on their own
    inputs (K4/K5 scaled); the captured step against eager bit for bit,
    the tickets back at 0, the steady step profiled (its busy time split
    over ``groups``) against its byte bound; and, as information, the
    greedy tokens it shares with the bf16 paged run ``paged``.  Returns
    the launches read just after the run."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import ServingEngine
    L = cfg.num_layers
    eng = ServingEngine(cfg, params, slots=8, max_len=MAX_LEN, device="cuda")
    for prompt, sp in requests:
        eng.submit(prompt, max_new_tokens=STREAM_GEN, sampling=sp)
    per_prefill = L + sum(norm_launches(cfg, 1).values())
    calls = []
    with _recording(calls, lambda: len(calls) < per_prefill,
                    ATTENTION_OPS + NORM_OPS):
        ops.reset_launches()                   # the main path starts here
        done = eng.run()
        counts = dict(ops.launches)            # ... and ends here
    assert len(done) == len(requests), f"{phase} fixed-slot: {len(done)}"
    for q in done:
        assert len(q.generated) == STREAM_GEN, q.rid
        assert all(0 <= t < cfg.vocab_size for t in q.generated), \
            f"{phase} fixed-slot: rid {q.rid} emitted a token outside " \
            "the vocabulary"
    assert bool(eng.policy.logits_finite), \
        f"{phase} fixed-slot: a logit was not finite"
    ticks = eng.policy.decode_ticks
    prefills = sum(1 for _, ev, _ in eng.trace if ev == "admit")
    want = {"decode_attention[bf16]": L * ticks,
            "flash_attention[causal]": L * prefills,
            **norm_launches(cfg, ticks + prefills)}
    assert counts == want, f"{phase} fixed-slot: launches {counts}, " \
        f"expected {want} for {ticks} decode steps and {prefills} prefills"
    m = eng.metrics.snapshot()
    log(phase, f"fixed-slot engine (8 slots, max_len {MAX_LEN}): "
        f"{m['completed']:.0f} requests, {ticks} decode steps (graph "
        f"replays), {prefills} prefills, {m['tokens_per_s']:.1f} tokens/s, "
        f"mean TTFT {m['ttft_avg_s'] * 1e3:.1f} ms, wall {m['wall_s']:.2f} "
        f"s; launches {json.dumps(counts)}")
    first = len(requests[0][0])
    attn = [c for c in calls if c[0] in ATTENTION_OPS]
    norms = [c for c in calls if c[0] in NORM_OPS]
    calls.clear()
    assert len(attn) == L and all(c[1][0].shape[1] == first for c in attn), \
        f"{phase} fixed-slot: recorded the wrong prefill"
    errs, norm_errs = {}, {}
    _held_to_plain(attn, errs, f"{phase} fixed-slot prefill")
    _norms_held(norms, norm_errs, f"{phase} fixed-slot prefill")
    tok, pos = _decode_state(eng)
    with _recording(calls, names=ATTENTION_OPS + NORM_OPS):
        M.decode_step(eng.params, cfg, _clone(eng.cache), tok, pos)
    attn = [c for c in calls if c[0] in ATTENTION_OPS]
    norms = [c for c in calls if c[0] in NORM_OPS]
    calls.clear()
    assert len(attn) == L, f"{phase}: {len(attn)} K4 calls in a step"
    _held_to_plain(attn, errs, f"{phase} fixed-slot decode step")
    _norms_held(norms, norm_errs, f"{phase} fixed-slot decode step")
    log(phase, _held_line(f"fixed-slot: the prefill of {first} tokens and "
                          f"a decode step (positions {pos.tolist()})", errs,
                          norm_errs))
    _fixed_graph_vs_eager(eng, phase=phase)
    _check_tickets(f"{phase} fixed-slot", [eng.policy._tickets,
                                           *da._tickets.values()])
    what = f"{cfg.name} fixed-slot decode step"
    wall, busy = _profile_graph_decode_step(eng, phase, what, groups=groups)
    nbytes = _fixed_step_bytes(eng)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(phase, f"{what}: byte bound {b_ms:.3f} ms ({nbytes / 1e9:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); device busy "
        f"{busy / b_ms:.2f}x and wall {wall / b_ms:.2f}x the bound "
        "(information)")
    # information, not a gate: whole-prompt and chunked prefill round
    # bf16 differently, so greedy streams part at near-ties
    paged_gen = {q.rid: q.generated for q in paged["finished"]}
    greedy = [q for q in done if q.sampling.temperature <= 0]
    equal = sum(a == b for q in greedy
                for a, b in zip(q.generated, paged_gen[q.rid]))
    same = sum(q.generated == paged_gen[q.rid] for q in greedy)
    log(phase, f"greedy tokens shared with the bf16 paged engine: "
        f"{equal}/{len(greedy) * STREAM_GEN} position-wise, "
        f"{same}/{len(greedy)} greedy streams identical")
    return counts


def _minicpm_steady(tag: str, eng, flush) -> None:
    """The steady graphed tick (8 seats) profiled: wall, busy, kernels,
    idle share and the top kernels, with the kernels named as the tied
    LM head's GEMM (8 rows against the 122 753 x 2304 embedding, timed
    alone beside its byte bound), and the tick against its byte bound."""
    pol = eng.policy
    h = torch.randn((8, 1, eng.cfg.d_model), device="cuda").bfloat16()
    w = pol.params["embed"]

    def head():
        return h @ w.T
    # the profiler here keeps about half of a short window's kernels:
    # 20 products, so that some of them are named
    try:
        prof, _ = profiled(lambda: [head() for _ in range(20)])
        head_keys = {a.key for a in prof.key_averages()
                     if a.device_type == torch.autograd.DeviceType.CUDA
                     and a.self_device_time_total > 0}
    except ProfilerLostTime as e:
        log("minicpm", f"{tag}: the LM head's kernels not named ({e})")
        head_keys = set()
    head_ms = cuda_ms(head, flush)
    hb = w.numel() * w.element_size() + 8 * w.shape[0] * 2
    log("minicpm", f"{tag}: LM head GEMM (M = 8, N = {w.shape[0]}, K = "
        f"{w.shape[1]}) alone {head_ms:.4f} ms against its byte bound "
        f"{hb / HBM_BYTES_PER_S * 1e3:.4f} ms ({hb / 1e6:.1f} MB); kernels "
        + "; ".join(k[:110] for k in sorted(head_keys)))
    groups = SERVING_GROUPS + (
        ("kernels named as the LM head's GEMM", lambda key: key in head_keys),)
    _, busy = _profile_graph_tick(f"{tag} pool", eng, phase="minicpm",
                                  groups=groups)
    nbytes = _tick_bytes(eng)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log("minicpm", f"{tag} pool tick: device busy {busy:.3f} ms against the "
        f"byte bound {b_ms:.3f} ms ({nbytes / 1e9:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, K/V as bf16): "
        f"{busy / b_ms:.2f}x (information)")


def phase_minicpm():
    """minicpm-2b at full width and depth on the paged and fixed-slot
    engines.  Returns the rows of K1/K2 at d 64, K4/K5 at d 64 with 36
    heads and K3 and the fused add + norm at D = 2304, and the launch
    counts of Run A by engine and pool."""
    t0 = time.perf_counter()
    cfg, params = _draw_cast(MINICPM, "minicpm")
    kv = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    log("minicpm", f"MHA {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}: {kv} bytes of bf16 K/V per token; pool "
        f"{ENGINE_KW['num_pages']} pages of {PAGE}")
    requests = _stream_requests(cfg)
    runs, counts = {}, {}
    for tag in ("bf16", "fp8", "int8"):
        runs[tag], counts[f"minicpm_{tag}"] = _paged_run_a(
            cfg, params, requests, tag, "minicpm")
    t1 = time.perf_counter()
    counts["minicpm_fixed"] = _fixed_run_a(cfg, params, requests,
                                           runs["bf16"], "minicpm")
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for tag in ("bf16", "fp8"):
        _minicpm_steady(tag, runs[tag]["engine"], flush)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    # K1/K2 at phase serve's seat lengths (1-2048) over the three pools;
    # K5 causal over the widest prompt, K4 over 8 slots of MAX_LEN + 1
    # keys; K3 and the fused add + norm at d_model 2304 (a 4096-wide
    # block, its tail masked): a tick's 8 rows, a prefill chunk, the
    # widest prompt, f32 at the teacher-forced tick and chunk
    rows = _model_attention(cfg, "minicpm", SEAT_LENGTHS, N_TABLE, flush,
                            pools=("bf16", "fp8", "int8"), row_key="d=64")
    rows.update(_attention_timing(cfg, "minicpm", PREFILL_S, MAX_LEN + 1, 61,
                                  "d=64,H=36", flush))
    D = cfg.d_model
    rows.update(_norms_vs_plain(
        "minicpm", 62, (D,),
        ((8, torch.bfloat16), (PREFILL_CHUNK, torch.bfloat16),
         (PREFILL_S, torch.bfloat16), (8, torch.float32),
         (PREFILL_CHUNK, torch.float32)),
        {("rmsnorm", D), ("add_rmsnorm", D)}, flush))
    del flush, params
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    cfg32, p32 = _draw_cast(MINICPM, "minicpm", num_layers=MINICPM_TF_LAYERS,
                            compute_dtype="float32")
    prompts = [p for p, _ in requests[:MINICPM_TF_PROMPTS]]
    _f32_paged_teacher_forced(
        cfg32, p32, prompts, what=f"f32, the first {MINICPM_TF_LAYERS} "
        "layers, fused tick (paged, f32 pool)", phase="minicpm")
    _f32_engines(cfg32, p32, prompts, phase="minicpm")
    log("minicpm", f"phase times: run A paged {t1 - t0:.1f} s, fixed slots "
        f"{t2 - t1:.1f} s, steady ticks {t3 - t2:.1f} s, kernels timed "
        f"{t4 - t3:.1f} s, f32 {time.perf_counter() - t4:.1f} s")
    return rows, counts


# phase grok: grok-1-314b at full width, cut in depth only.  A layer holds
# 4.92 B parameters (8 experts of 3 x 6144 x 32 768); four layers and the
# untied embedding and head are 21.29 B, 39.66 GiB in bf16, and drawing
# them peaks at the tree plus the (4, 8, 6144, 32 768) expert leaf's f32
# draw, 24 GiB.  Six layers (57.99 GiB) and that leaf's f32 draw (36 GiB)
# would not fit the card without drawing the leaf in slices, which would
# no longer equal the drawn tree bit for bit (``init_params_for_compute``)
GROK_LAYERS = 4
GROK_F32_LAYERS = 1      # the f32 checks' depth: 24.3 GiB widened
GROK_FIXED_REQUESTS = 8


def phase_grok():
    """grok-1-314b at full width, GROK_LAYERS of its 64 layers, on the
    paged and fixed-slot engines: its group of 6 runs K1/K2/K4 on their
    MG = 8 instantiations.  Returns the rows of K1/K2 (bf16, fp8, int8),
    K4 and K5 at group 6 and K3 and the fused add + norm at D = 6144, and
    the launch counts of Run A by engine and pool."""
    t0 = time.perf_counter()
    cfg, params = _draw_cast(GROK, "grok", num_layers=GROK_LAYERS)
    m, G = cfg.moe, cfg.num_heads // cfg.num_kv_heads
    kv = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    log("grok", f"GQA {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}: group {G} on the decode kernels' MG = "
        f"{group_arrays(G)} instantiation (rows {G}-{group_arrays(G) - 1} "
        f"of each group empty); {m.num_experts} experts top-{m.top_k} of "
        f"d_ff {m.d_ff_expert} on every layer, no shared expert, capacity "
        f"factor {m.capacity_factor}; {kv} bytes of bf16 K/V per token")
    requests = _stream_requests(cfg)
    runs, counts = {}, {}
    for tag in ("bf16", "fp8", "int8"):
        runs[tag], counts[f"grok_{tag}"] = _paged_run_a(
            cfg, params, requests, tag, "grok", eager=tag != "int8")
    t1 = time.perf_counter()
    counts["grok_fixed"] = _fixed_run_a(
        cfg, params, requests[:GROK_FIXED_REQUESTS], runs["bf16"], "grok",
        groups=MOE_GROUPS)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    _moe_steady(runs["bf16"]["engine"], phase="grok")
    _moe_steady(runs["fp8"]["engine"], phase="grok", tag="fp8 pool")
    _moe_f32(runs["bf16"]["engine"],
             [p for p, _ in requests[:MINICPM_TF_PROMPTS]], phase="grok",
             layers=GROK_F32_LAYERS, tick_layers=GROK_F32_LAYERS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    # K1/K2 at phase 3's seat lengths (1-2048, the bytes of the qwen3-1.7b
    # rows) over the three pools; K5 causal over the widest prompt, K4
    # over 8 slots of MAX_LEN + 1 keys, 48 heads over 8; K3 and the fused
    # add + norm at d_model 6144 (an 8192-wide block, its tail masked): a
    # tick's 8 rows, a prefill chunk, the widest prompt, f32 at the
    # teacher-forced tick and chunk
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = _model_attention(cfg, "grok", SEAT_LENGTHS, N_TABLE, flush,
                            pools=("bf16", "fp8", "int8"), row_key="G=6")
    rows.update(_attention_timing(cfg, "grok", PREFILL_S, MAX_LEN + 1, 71,
                                  "G=6", flush))
    D = cfg.d_model
    rows.update(_norms_vs_plain(
        "grok", 72, (D,),
        ((8, torch.bfloat16), (PREFILL_CHUNK, torch.bfloat16),
         (PREFILL_S, torch.bfloat16), (8, torch.float32),
         (PREFILL_CHUNK, torch.float32)),
        {("rmsnorm", D), ("add_rmsnorm", D)}, flush))
    del flush, params
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config(GROK)
    log("grok", f"serve() at full width not run: it builds all "
        f"{full.num_layers} layers ("
        f"{M.count_params(M.param_specs(full)) * 2 / 2 ** 30:.2f} GiB in "
        "bf16), past the card; Run A is the full-width run")
    _serve_cli(GROK, "grok")
    log("grok", f"phase times: run A paged {t1 - t0:.1f} s, fixed slots "
        f"{t2 - t1:.1f} s, steady ticks and f32 {t3 - t2:.1f} s, kernels "
        f"timed {t4 - t3:.1f} s; peak {peak:.2f} GiB allocated "
        "(max_memory_allocated)")
    return rows, counts


# phase f32: a position is decided when the plain version's top-2 gap
# exceeds twice the largest |kernel - plain| logit difference there (the
# workload-7 method of docs/benchmarks.md): there the two must pick the
# same token.  In f32 the differences are summation order, ~1e-5 against
# top-2 gaps of ~1e-2 at random weights, so nearly every position is
# decided; a wrong split merge (differences of ~1e-1) would leave few.
F32_MIN_DECIDED = 0.9
F32_GAP = 1e-3          # engines: streams must agree up to a gap this small
F32_GEN = 32


def _hold_decided(stats: dict, lk: torch.Tensor, lp: torch.Tensor) -> None:
    """Adds one model step's (rows, V) logits with the kernels ``lk`` and
    the plain versions ``lp`` to ``stats``: rows, decided rows, decided
    rows whose top-1 agree, the largest |Δlogit|."""
    assert bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())
    delta = (lk - lp).abs().amax(dim=-1)
    top = lp.topk(2, dim=-1)
    decided = top.values[:, 0] - top.values[:, 1] > 2 * delta
    agree = lk.argmax(dim=-1) == top.indices[:, 0]
    stats["rows"] += len(lp)
    stats["decided"] += int(decided.sum())
    stats["agree"] += int((decided & agree).sum())
    stats["max_delta"] = max(stats["max_delta"], delta.max().item())


def _report_decided(what: str, stats: dict, phase: str = "f32",
                    pair: str = "kernel vs plain") -> None:
    """Every decided position must agree, and at least F32_MIN_DECIDED of
    the positions must be decided."""
    frac = stats["decided"] / stats["rows"]
    log(phase, f"{what} {pair}, teacher-forced: top-1 equal at "
        f"{stats['agree']}/{stats['decided']} decided positions; decided "
        f"{stats['decided']}/{stats['rows']} = {frac:.4f}; max|Δlogit| "
        f"{stats['max_delta']:.3e}")
    assert stats["agree"] == stats["decided"], \
        f"{what}: top-1 differs at {stats['decided'] - stats['agree']} " \
        "decided positions"
    assert frac >= F32_MIN_DECIDED, \
        f"{what}: only {frac:.3f} of the positions are decided"


def _new_stats() -> dict:
    return {"rows": 0, "decided": 0, "agree": 0, "max_delta": 0.0}


def _f32_paged_teacher_forced(cfg, params, prompts,
                              what: str = "fused tick (paged, f32 pool)",
                              phase: str = "f32") -> None:
    """The fused tick with the kernels and with the plain versions on one
    greedy stream per seat: each prompt prefilled in chunks of
    PREFILL_CHUNK (``paged_decode_step``, as the engine does), then
    F32_GEN - 1 fused ticks over 8 seats, every input token the plain
    version's top-1 (teacher forcing), each on its own f32 pool."""
    from repro_torch.models import model as M
    A = len(prompts)
    n_tables = -(-MAX_LEN // PAGE)
    table = (torch.arange(A * n_tables, dtype=torch.int32, device="cuda")
             + 1).reshape(A, n_tables)
    impls = ("plain", "kernel")
    caches = {impl: M.init_paged_cache(cfg, 1 + A * n_tables, PAGE,
                                       device="cuda") for impl in impls}
    stats = _new_stats()
    first = {impl: [] for impl in impls}
    for a, prompt in enumerate(prompts):
        for impl in impls:
            for start in range(0, len(prompt), PREFILL_CHUNK):
                c = len(prompt[start:start + PREFILL_CHUNK])
                tok = torch.zeros((1, PREFILL_CHUNK), dtype=torch.int32)
                tok[0, :c] = torch.from_numpy(prompt[start:start + c])
                meta = torch.tensor([start, c], dtype=torch.int32)
                logits, _ = M.paged_decode_step(
                    params, cfg, caches[impl], tok.cuda(), meta[:1].cuda(),
                    table[a:a + 1], meta[1:].cuda(), impl=impl)
            first[impl].append(logits[0, c - 1])
    lp = torch.stack(first["plain"])
    _hold_decided(stats, torch.stack(first["kernel"]), lp)
    teacher = lp.argmax(dim=-1).int()
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device="cuda")
    state = {impl: dict(
        last=teacher.clone(), pos=lens.clone(),
        nv=torch.ones(A, dtype=torch.int32, device="cuda"),
        temp=torch.zeros(A, device="cuda"),
        top_k=torch.zeros(A, dtype=torch.int32, device="cuda"),
        top_p=torch.ones(A, device="cuda"),
        seed=torch.zeros(A, dtype=torch.int64, device="cuda"),
        rid=torch.arange(A, dtype=torch.int64, device="cuda"),
        step=torch.ones(A, dtype=torch.int64, device="cuda"))
        for impl in impls}
    for _ in range(F32_GEN - 1):
        out = {}
        for impl in impls:
            st = state[impl]
            st["last"].copy_(teacher)
            out[impl] = M.fused_decode_tick(
                params, cfg, caches[impl], st["last"], st["pos"], table,
                st["nv"], st["temp"], st["top_k"], st["top_p"], st["seed"],
                st["rid"], st["step"], impl=impl)[1]
        _hold_decided(stats, out["kernel"], out["plain"])
        teacher = out["plain"].argmax(dim=-1).int()
    _report_decided(what, stats, phase)


def _fixed_teacher_forced(runs: dict, prompts, max_len: int,
                          patches=None) -> dict:
    """``prefill`` and ``decode_step`` for each run of ``runs`` ({name:
    (params, cfg, impl)}) on the same streams: each prompt prefilled
    whole into its slot of the run's cache of ``max_len`` + 1 rows (a
    vision model's with its patches ``patches[a]``, (1, P, F)), then
    F32_GEN - 1 decode steps over the slots, every input token the first
    run's top-1 (teacher forcing).  Returns {name: [(slots, V) logits of
    each position]}."""
    from repro_torch.models import model as M
    opts = M.RunOptions(q_chunk=min(max_len, 512))
    caches = {name: M.init_cache(cfg, len(prompts), max_len + 1,
                                 device="cuda")
              for name, (_, cfg, _) in runs.items()}
    first = {name: [] for name in runs}
    for a, prompt in enumerate(prompts):
        batch = {"tokens": torch.from_numpy(prompt)[None].cuda()}
        if patches is not None:
            batch["patches"] = patches[a]
        for name, (params, cfg, impl) in runs.items():
            logits, rows = M.prefill(params, cfg, batch, opts, impl=impl)
            for pos, ent in caches[name].items():
                for key, full in ent.items():
                    # K/V rows below the prompt's length; an SSM
                    # layer's conv tail and state whole
                    if key in ("k", "v"):
                        full[:, a, :len(prompt)] = rows[pos][key][:, 0]
                    else:
                        full[:, a] = rows[pos][key][:, 0]
            first[name].append(logits[0, -1])
    out = {name: [torch.stack(rows)] for name, rows in first.items()}
    teacher_run = next(iter(runs))
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    for _ in range(F32_GEN - 1):
        teacher = out[teacher_run][-1].argmax(dim=-1).int()
        for name, (params, cfg, impl) in runs.items():
            out[name].append(M.decode_step(params, cfg, caches[name],
                                           teacher[:, None], pos,
                                           impl=impl)[0][:, -1])
        pos = pos + 1
    return out


def _f32_fixed_teacher_forced(cfg, params, prompts) -> None:
    """``prefill`` and ``decode_step`` with the kernels and with the plain
    versions on the same streams as ``_f32_paged_teacher_forced``: each
    prompt prefilled whole into its slot of an f32 cache of MAX_LEN + 1,
    then F32_GEN - 1 decode steps over the 8 slots, teacher-forced."""
    out = _fixed_teacher_forced({"plain": (params, cfg, "plain"),
                                 "kernel": (params, cfg, "kernel")},
                                prompts, MAX_LEN)
    stats = _new_stats()
    for lp, lk in zip(out["plain"], out["kernel"]):
        _hold_decided(stats, lk, lp)
    _report_decided("prefill + decode step (fixed-slot, f32 cache)", stats)


def _f32_engines(cfg, params, prompts, phase: str = "f32") -> dict:
    """The paged engine and ``ServingEngine`` (the reference's equivalence
    oracle) on the same greedy requests, f32 pool and cache.  Each stream
    must equal the other engine's up to its first position where the
    top-2 gap is at most F32_GAP; the gaps come from a whole-sequence
    re-score of the paged stream (``backbone`` over prompt + stream, the
    logits of every generated position), which is the same context as
    either engine's up to the streams' first difference.  Returns the
    kernel launches of each engine's run."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import PagedServingEngine, ServingEngine
    streams, counts = {}, {}
    for name in ("paged", "fixed"):
        eng = (PagedServingEngine(cfg, params, page_size=PAGE,
                                  num_pages=16 * 34 + 16, max_seats=8,
                                  max_seq_len=MAX_LEN,
                                  prefill_chunk=PREFILL_CHUNK, device="cuda")
               if name == "paged" else
               ServingEngine(cfg, params, slots=8, max_len=MAX_LEN,
                             device="cuda"))
        rids = [eng.submit(p, max_new_tokens=F32_GEN) for p in prompts]
        ops.reset_launches()                   # the main path starts here
        done = {q.rid: q.generated for q in eng.run()}
        counts[name] = dict(ops.launches)      # ... and ends here
        assert sorted(done) == rids and bool(eng.policy.logits_finite), \
            f"{phase} {name} engine: finished {sorted(done)}"
        streams[name] = [done[r] for r in rids]
        log(phase, f"{name} engine: {len(done)} requests, launches "
            f"{json.dumps(counts[name])}")
        del eng
    for name, key in (("paged", "paged_decode_attention[f32]"),
                      ("fixed", "decode_attention[f32]"),
                      ("fixed", "flash_attention[causal]")):
        assert counts[name].get(key, 0) > 0, f"{phase} {name}: {key} never ran"
    out_w = M._output_weight(params, cfg)
    opts = M.RunOptions(q_chunk=512)
    compared, equal_streams = 0, 0
    for a, prompt in enumerate(prompts):
        gp, gf = streams["paged"][a], streams["fixed"][a]
        seq = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(gp[:-1], np.int32)]))[None].cuda()
        h, _, _ = M.backbone(params, cfg, M._embed_inputs(
            params, cfg, {"tokens": seq})[0], opts)
        top = (h[0, len(prompt) - 1:] @ out_w).topk(2, dim=-1).values
        gaps = (top[:, 0] - top[:, 1]).tolist()
        undecided = next((i for i, g in enumerate(gaps) if g <= F32_GAP),
                         len(gp))
        first_diff = next((i for i, (x, y) in enumerate(zip(gp, gf))
                           if x != y), len(gp))
        assert first_diff >= undecided, \
            f"{phase} request {a}: the engines part at token {first_diff}, " \
            f"before the first gap <= {F32_GAP} (token {undecided}; gaps " \
            f"{[f'{g:.2e}' for g in gaps[:first_diff + 1]]})"
        compared += undecided
        equal_streams += first_diff == len(gp)
    log(phase, f"paged engine vs ServingEngine: {compared}/"
        f"{len(prompts) * F32_GEN} tokens compared (each stream up to its "
        f"first top-2 gap <= {F32_GAP}), all equal; {equal_streams}/"
        f"{len(prompts)} streams identical throughout")
    return counts


def phase_f32(prompts) -> dict:
    """qwen3-1.7b at its published width computing in f32 (f32 weights
    from the seed of the bf16 runs, f32 pool and cache; K5 on its CUDA-
    core route, K1 on an f32 pool, K4 on an f32 cache) over ``prompts``
    (the first 8 requests of the paged runs): kernels against plain
    versions teacher-forced on both paths, then the paged engine against
    ``ServingEngine``.  Returns the engines' launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    params = M.init_params(M.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    t0 = time.perf_counter()
    _f32_paged_teacher_forced(cfg, params, prompts)
    _f32_fixed_teacher_forced(cfg, params, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    counts = _f32_engines(cfg, params, prompts)
    log("f32", f"phase times: teacher-forced {t1 - t0:.1f} s, engines "
        f"{time.perf_counter() - t1:.1f} s")
    return counts


# full-width training: 30 steps, as the reference's system test
# (tests/test_system.py), at train()'s default peak lr of 1e-3, the
# reference's; 12 steps leave the loss at its uniform level (ln V = 11.93)
# or above it
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 30, 8, 1024, 1e-3
# the CPU parity tests' tolerances for three f32 train steps
# (tests/test_torch_train.py): losses rtol 1e-5, grad norms rtol 1e-3, lr
# rtol 1e-6, params within 5e-5 and the update (p_3 - p_0) within 1e-3
# of its norm
TRAIN_F32_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "lr": 1e-6,
                 "param": 5e-5, "update": 1e-3}
# a resumed run against an uninterrupted one (bf16 compute): losses
# within 1e-3, and the final params, AdamW moments mu and nu each within
# 1e-3 of their norm (the params: of their update p_8 - p_0), count equal.
# A restore that dropped the moments or reset count misses these by
# orders of magnitude; the card read 0 for the losses (PERF.md §6)
RESUME_LOSS_ATOL, RESUME_STATE_RTOL = 1e-3, 1e-3


def _trained(losses, steps: int) -> tuple:
    """Check a full-width run: ``steps`` finite losses falling by the
    reference's criterion (the mean of the last 5 below the mean of the
    first 5 by more than 0.05) and no kernel launched (every counter of
    ``kernels/ops.py`` still 0: no kernel has a backward).  Returns the
    two means."""
    from repro_torch.kernels import ops
    launched = {k: n for k, n in ops.launches.items() if n}
    if launched:
        raise AssertionError(f"kernels launched by the train step: "
                             f"{launched}")
    if not all(np.isfinite(losses)) or len(losses) != steps:
        raise AssertionError(f"losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first - 0.05:
        raise AssertionError(f"loss did not fall: mean of the first 5 "
                             f"{first:.4f}, of the last 5 {last:.4f}")
    return first, last


def _train_full_width() -> None:
    """``train()`` on qwen3-1.7b at its published width: losses finite
    and falling by the reference's criterion, no kernel launched, wall
    time and peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses = train(ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, reduced=False, log_every=10,
                   lr_peak=TRAIN_LR, device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train", "losses " + " ".join(f"{x:.4f}" for x in losses))
    first, last = _trained(losses, TRAIN_STEPS)
    log("train", f"qwen3-1.7b full width (f32 master weights + AdamW, "
        f"bf16 compute, remat) through train(), batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, {TRAIN_STEPS} steps in {wall:.1f} s, peak lr "
        f"{TRAIN_LR}: loss {first:.4f} -> {last:.4f} (means of the first "
        f"and last 5); peak {peak:.2f} GiB allocated; kernel launches 0")


def _kernel_kind(key: str) -> str:
    """The group of a kernel of the train step, by its name."""
    key = key.lower()
    for kind, marks in (("matmul", ("gemm", "xmma", "cutlass", "cublas",
                                    "nvjet")),
                        ("softmax", ("softmax",)),
                        ("reduction", ("reduce",)),
                        ("index, gather, scatter", ("index", "gather",
                                                    "scatter")),
                        ("copy, fill", ("copy", "memcpy", "memset", "fill",
                                        "cat"))):
        if any(m in key for m in marks):
            return kind
    return "elementwise, other"


TRAIN_GROUPS = tuple(
    (kind, lambda key, kind=kind: _kernel_kind(key) == kind)
    for kind in ("matmul", "softmax", "reduction", "index, gather, scatter",
                 "copy, fill", "elementwise, other"))


def _events(fn, iters: int = 3) -> float:
    """Median ms of ``fn()`` by CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile_train_step() -> None:
    """Steady full-width train steps through ``build_cell(...).fn``: step
    time by CUDA events, tokens/s, then one step profiled (wall, device
    busy time, idle share, top kernels, the time of each kernel group)
    and the forward / forward + backward / AdamW parts."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import build_cell, value_and_grad
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_update
    cfg = get_config(ARCH)
    params, opt = make_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opts = M.RunOptions(q_chunk=min(TRAIN_SEQ, 512),
                        xent_chunk=min(TRAIN_SEQ, 512))
    cell = build_cell(
        cfg, ShapeConfig("custom", TRAIN_SEQ, TRAIN_BATCH, "train"), opts,
        lr_peak=TRAIN_LR, total_steps=10 * TRAIN_STEPS)
    batch = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                          device="cuda").get_batch(0)
    steady = _events(lambda: cell.fn(params, opt, batch), iters=5)
    n_params = M.count_params(M.param_specs(cfg))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log("train", f"steady train step (full width, {n_params / 1e9:.3f} B "
        f"params, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): {steady:.1f} ms "
        f"(CUDA events, median of 5 after one warm-up), "
        f"{tokens / steady * 1e3:.0f} tokens/s; information: "
        f"6·N·tokens/time = {6 * n_params * tokens / steady / 1e9:.1f} "
        f"TFLOP/s, {6 * n_params * tokens / steady * 1e3 / BF16_FLOPS:.3f} "
        "of the bf16 peak")

    def step():
        cell.fn(params, opt, batch)
        torch.cuda.synchronize()
    _profile_steady("train", "steady train step (full width)", step,
                    steps=2, groups=TRAIN_GROUPS, top=12)
    with torch.no_grad():
        fwd = _events(lambda: M.lm_loss(params, cfg, batch, opts))
    fwd_bwd = _events(lambda: value_and_grad(params, cfg, batch, opts))
    _, grads = value_and_grad(params, cfg, batch, opts)
    lr = torch.tensor(TRAIN_LR, device="cuda")
    adam = _events(lambda: adamw_update(grads, opt, params, lr))
    log("train", f"steady train step parts (CUDA events, median of 3): "
        f"forward {fwd:.1f} ms (no grad), forward + backward with remat "
        f"{fwd_bwd:.1f} ms, AdamW {adam:.1f} ms")


# the reduced f32 configs held card against CPU over three train steps,
# the MoE configs at capacity factor 0.5 (MOE_VS_CPU_CF) so that pairs
# drop in every MoE layer; the leaves of TRUE_FAN_IN scaled to their true
# fan-in first (_true_fan_in), as the CPU parity tests do
# (tests/_torch_train_inputs.py says why)
TRAIN_VS_CPU = (ARCH, "phi-3-vision-4.2b", "whisper-base", "mamba2-130m",
                "qwen2-moe-a2.7b", "jamba-v0.1-52b", "grok-1-314b")
TRUE_FAN_IN = {"phi-3-vision-4.2b": ("wq", "wk"),
               "whisper-base": ("wq", "wk"),
               "qwen2-moe-a2.7b": ("wq", "wk"),
               "grok-1-314b": ("wq", "wk"),
               "jamba-v0.1-52b": ("wq", "wk", "in_proj")}
MOE_VS_CPU_CF = 0.5


def _true_fan_in(tree, d_model: int, leaves=("wq", "wk")):
    """Scale each stacked leaf named in ``leaves`` in place by sqrt(G /
    fan-in), its true fan-in being d_model (an attention block's
    ``wq``/``wk`` (G, d_model, heads, hd), an SSM block's ``in_proj``, an
    MoE block's ``router`` and ``wg``/``wu``) or, for a down projection
    ``wd`` (..., F, d_model), F: the reference's ``init_params`` takes a
    stacked leaf's fan-in to be G, which without qk-norm makes these
    models' softmax nearly one-hot, their reduced f32 trajectories part
    by more than rounding, and their full-width losses barely move
    (PERF.md §6)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _true_fan_in(v, d_model, leaves)
        elif k in leaves:
            fan_in = v.shape[-2] if k == "wd" else d_model
            v.mul_((v.shape[0] / fan_in) ** 0.5)
    return tree


def _family_batches(cfg, batch: int, seq: int, device: str):
    """``get(step)``: the token pipeline's batch at ``step`` on ``device``,
    with a vision model's ``patches`` (batch, frontend_len, frontend_dim)
    or an encoder-decoder model's ``audio`` (batch, encoder_len,
    frontend_dim) drawn standard-normal on the CPU from a generator
    seeded with ``step``, so that every device gets the same inputs."""
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, device=device)

    def get(step: int) -> dict:
        b = pipe.get_batch(step)
        gen = torch.Generator().manual_seed(step)
        if cfg.frontend == "vision":
            b["patches"] = torch.randn(
                (batch, cfg.frontend_len, cfg.frontend_dim),
                generator=gen).to(device)
        if cfg.encoder_decoder:
            b["audio"] = torch.randn(
                (batch, cfg.encoder_len, cfg.frontend_dim),
                generator=gen).to(device)
        return b
    return get


# full-width training of the frontend and SSM families (arch, batch,
# seq, steps, peak lr): mamba2-130m at 4 SSD chunks of 256 through
# train() on the streamed token pipeline, at the peak lr of the
# reference's system test (tests/test_system.py: 3e-3; at 1e-3 it fell
# 0.043 in 20 steps); whisper-base at Whisper's text context of 448
# decoder tokens (arXiv:2212.04356) over 1500 frames and
# phi-3-vision-4.2b with its 256 patch rows, each on one batch repeated
# (streamed, their losses fell 0.003-0.074 in 20 steps, within the
# noise of the 0.05 criterion; PERF.md §6).  Steps: the fewest
# that show the fall (_trained needs 10 for its two means of 5)
FAMILY_TRAIN = (("mamba2-130m", 8, 1024, 20, 3e-3),
                ("whisper-base", 8, 448, 10, TRAIN_LR),
                ("phi-3-vision-4.2b", 8, 1024, 10, TRAIN_LR))
# the leaves each full-width run through build_cell(...).fn scales to its
# true fan-in (_true_fan_in): the frontend models' wq/wk, and
# qwen2-moe-a2.7b's wq/wk and MoE blocks (router and experts, the shared
# experts too).  At the reference's init (std 0.5 for 4 stacked layers)
# its grad norm reached 1e7, clipping left AdamW's steps at eps and the
# loss fell 0.021 in 10 steps; with the MoE blocks alone scaled it rose
# 0.010; with wq/wk alone it fell, but the routing collapsed (a third of
# the pairs dropped by step 9) (PERF.md §6)
FULL_WIDTH_FAN_IN = {"whisper-base": ("wq", "wk"),
                     "phi-3-vision-4.2b": ("wq", "wk"),
                     "qwen2-moe-a2.7b": ("wq", "wk", "router", "wg", "wu",
                                         "wd")}
# full-width MoE training (arch, batch, seq, steps, peak lr, layers):
# qwen2-moe-a2.7b, the only MoE config whose f32 training state fits one
# card, cut in depth only: 4 of its 24 layers hold 2.905 B parameters,
# 43.3 GiB of f32 params, grads and AdamW moments (24 layers: 229 GB;
# one layer of grok-1-314b alone 78.7 GB, jamba-v0.1-52b's smallest whole
# depth, one period of 8 layers, 204 GB); 8 x 1024 tokens route 32 768
# (token, expert) pairs a layer into 60 experts of 688 slots; one batch
# repeated, as the frontend models
MOE_TRAIN = ("qwen2-moe-a2.7b", 8, 1024, 10, TRAIN_LR, 4)


def _train_family(arch: str, batch: int, seq: int, steps: int, lr: float,
                  **overrides) -> None:
    """``arch`` trained at its published width (its config with
    ``overrides``: a depth cut to fit the card), f32 master weights and
    AdamW, bf16 compute, remat: mamba2-130m through ``train()``, the
    frontend and MoE models through ``build_cell(...).fn`` (``train()``'s
    options and schedule; the leaves of ``FULL_WIDTH_FAN_IN`` at their
    true fan-in) on one batch of ``_family_batches`` repeated; losses
    finite and falling and no kernel launched (``_trained``), then the
    steady step under ``_profile_steady`` (wall, tokens/s, busy time,
    idle share, the kernel groups) and the peak memory of the whole.  An
    MoE model also logs each step's loss, xent, aux loss and grad norm,
    the dropped (token, expert) pairs of each MoE layer at the first and
    the last step (``_capacity_calls``: the forward's calls, before
    remat's recomputation) and AdamW's time by CUDA events."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell, value_and_grad
    from repro_torch.launch.train import make_train_state, train
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import adamw_update
    cfg = dataclasses.replace(get_config(arch), **overrides)
    opts = M.RunOptions(q_chunk=min(seq, 512), xent_chunk=min(seq, 512))
    cell = build_cell(cfg, ShapeConfig("custom", seq, batch, "train"), opts,
                      lr_peak=lr, total_steps=max(10 * steps, 100))
    b = _family_batches(cfg, batch, seq, "cuda")(0)
    streamed = cfg.frontend is None and cfg.moe is None
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    if streamed:
        losses = train(arch, steps=steps, batch=batch, seq=seq,
                       reduced=False, log_every=steps, lr_peak=lr,
                       device="cuda")
    params, opt = make_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    if not streamed:
        if arch in FULL_WIDTH_FAN_IN:
            _true_fan_in(params, cfg.d_model, FULL_WIDTH_FAN_IN[arch])
        metrics, calls = [], []
        for _ in range(steps):
            seen = []
            with _capacity_calls(seen):
                params, opt, m = cell.fn(params, opt, b)
            metrics.append(torch.stack([m[k] for k in (
                "loss", "xent", "aux_loss", "grad_norm")]))
            calls.append(seen)
        metrics = torch.stack(metrics).tolist()
        losses = [row[0] for row in metrics]
    wall = time.perf_counter() - t0
    log("train", f"{arch} losses " + " ".join(f"{x:.4f}" for x in losses))
    if cfg.moe is not None:
        log("train", f"{arch} per step (loss, xent, aux_loss, grad_norm): "
            + "; ".join(f"{i}: {x:.4f} {y:.4f} {a:.4f} {g:.4g}"
                        for i, (x, y, a, g) in enumerate(metrics)))
        layers = (cfg.num_layers // cfg.scan_period()
                  * cfg.mlp_kinds().count("moe"))
        tk = batch * seq * cfg.moe.top_k
        C = moe_mod.capacity(cfg.moe, tk)
        for i in (0, steps - 1):
            fwd = calls[i][:layers]
            assert [(t, c) for t, c, _ in fwd] == [(tk, C)] * layers, \
                f"train {arch} step {i}: capacity calls {fwd}"
            drops = [int(d) for _, _, d in fwd]
            log("train", f"{arch} step {i}: dropped (token, expert) pairs "
                f"per MoE layer {drops} of {tk} routed into "
                f"{cfg.moe.num_experts} experts of {C} slots "
                f"({sum(drops) / (tk * layers):.4f} of all)")
    first, last = _trained(losses, steps)

    def step():
        cell.fn(params, opt, b)
        torch.cuda.synchronize()
    ms, busy = _profile_steady("train", f"{arch} steady train step", step,
                               steps=1, groups=TRAIN_GROUPS, top=8)
    _trained(losses, steps)                    # the profiled steps too
    if cfg.moe is not None:
        _, grads = value_and_grad(params, cfg, b, opts)
        lr_t = torch.tensor(lr, device="cuda")
        adam = _events(lambda: adamw_update(grads, opt, params, lr_t))
        del grads
        log("train", f"{arch} AdamW over "
            f"{M.count_params(M.param_specs(cfg))} params: {adam:.1f} ms "
            "(CUDA events, median of 3 after one warm-up)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    inputs = {k: tuple(v.shape) for k, v in b.items() if k != "labels"}
    how = ("train(), streamed" if streamed
           else "build_cell.fn, one batch repeated")
    depth = (f", {cfg.num_layers} of its {get_config(arch).num_layers} "
             "layers" if "num_layers" in overrides else "")
    log("train", f"{arch} full width{depth} "
        f"({M.count_params(M.param_specs(cfg))} "
        f"params; {how}, inputs {inputs}, peak lr {lr}): {steps} steps in "
        f"{wall:.1f} s, "
        f"loss {first:.4f} -> {last:.4f} (means of the first and last 5); "
        f"steady step {ms:.1f} ms (host clock, 1 step after 2), "
        f"{batch * seq / ms * 1e3:.0f} tokens/s, busy {busy:.1f} ms; peak "
        f"{peak:.2f} GiB allocated; kernel launches 0")


def _train_families() -> None:
    """``_train_family`` for each of ``FAMILY_TRAIN`` and then
    ``MOE_TRAIN``, the card's memory freed between them, on expandable
    allocator segments: phi-3-vision-4.2b's state (61.8 GiB, leaves of 3
    GiB) peaks at 67.06 GiB of the card's 79.18, and with fixed segments
    its AdamW once found 12.76 GiB reserved but in pieces too small for
    a 3 GiB temporary (PERF.md §6)."""
    moe_arch, *moe_run, layers = MOE_TRAIN
    runs = [(arch, run, {}) for arch, *run in FAMILY_TRAIN]
    runs.append((moe_arch, moe_run, {"num_layers": layers}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        for arch, run, cut in runs:
            t0 = time.perf_counter()
            _train_family(arch, *run, **cut)
            gc.collect()
            torch.cuda.empty_cache()
            log("train", f"{arch}: {time.perf_counter() - t0:.1f} s")
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def _train_card_vs_cpu() -> None:
    """``_card_vs_cpu`` for each config of ``TRAIN_VS_CPU``."""
    for arch in TRAIN_VS_CPU:
        _card_vs_cpu(arch)


def _card_vs_cpu(arch: str) -> None:
    """Three train steps of the reduced f32 ``arch`` on the card and on
    the CPU from the same params and batches (``_family_batches``); an
    MoE config at capacity factor ``MOE_VS_CPU_CF``."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config, reduced_config
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduced_config(get_config(arch), compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_VS_CPU_CF))
    batch, seq = 8, 64
    cell = build_cell(cfg, ShapeConfig("custom", seq, batch, "train"),
                      M.RunOptions(q_chunk=seq, xent_chunk=seq),
                      lr_peak=3e-3, total_steps=300)

    def state():
        params, opt = make_train_state(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
        if arch in TRUE_FAN_IN:
            _true_fan_in(params, cfg.d_model, TRUE_FAN_IN[arch])
        return params, opt
    p0, _ = state()
    runs = {}
    for dev in ("cpu", "cuda"):
        params, opt = state()
        params = tree_map(lambda t: t.to(dev), params)
        opt = tree_map(lambda t: t.to(dev), opt)
        get = _family_batches(cfg, batch, seq, dev)
        metrics = []
        for step in range(3):
            params, opt, m = cell.fn(params, opt, get(step))
            metrics.append({k: float(m[k]) for k in
                            ("loss", "grad_norm", "lr")})
        runs[dev] = (metrics, [t.cpu() for t in tree_leaves(params)])
    (mc, pc), (mg, pg) = runs["cpu"], runs["cuda"]
    tol = TRAIN_F32_TOL
    for step, (a, b) in enumerate(zip(mc, mg)):
        for key in ("loss", "grad_norm", "lr"):
            if abs(a[key] - b[key]) > tol[key] * abs(a[key]):
                raise AssertionError(f"step {step} {key}: cpu {a[key]} "
                                     f"cuda {b[key]}")
    worst_p = worst_u = 0.0
    for c, g, start in zip(pc, pg, tree_leaves(p0)):
        worst_p = max(worst_p, float((c - g).abs().max()))
        worst_u = max(worst_u, float(torch.linalg.vector_norm(c - g)
                                     / torch.linalg.vector_norm(c - start)))
    if worst_p > tol["param"] or worst_u > tol["update"]:
        raise AssertionError(f"params after 3 steps: max |cpu - cuda| "
                             f"{worst_p:.3e}, update error {worst_u:.3e}")
    gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"]
                 for a, b in zip(mc, mg))
    cf = f" at capacity factor {MOE_VS_CPU_CF}" if cfg.moe else ""
    log("train", f"reduced f32 {arch}{cf}, 3 steps, card vs CPU: losses "
        + ", ".join(f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b in
                    zip(mc, mg))
        + f"; grad norms within {gn_err:.2e} relative; params max |Δ| "
        f"{worst_p:.2e}, update "
        f"error {worst_u:.2e} (limits {tol})")


def _train_restart(device: str = "cuda") -> None:
    """Checkpoint and restart at the reduced config: an injected failure,
    a resumed run against an uninterrupted one (losses, and the final
    params and AdamW state), and a ``save_async`` whose restored tensors
    must equal the saved ones bit for bit."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.train import make_train_state, train
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves
    kw = dict(steps=8, batch=8, seq=64, lr_peak=3e-3, log_every=100,
              device=device)
    cfg = reduced_config(get_config(ARCH))
    with tempfile.TemporaryDirectory() as root:
        full_ck = str(Path(root) / "full")
        full = train(ARCH, ckpt_dir=full_ck, ckpt_every=100, **kw)
        ck = str(Path(root) / "ck")
        try:
            train(ARCH, ckpt_dir=ck, ckpt_every=4, fail_at_step=6, **kw)
        except RuntimeError as e:
            if "injected failure at step 6" not in str(e):
                raise
        else:
            raise AssertionError("fail_at_step=6 did not raise")
        if CheckpointManager(ck).steps() != [4]:
            raise AssertionError(f"checkpoints after the failure: "
                                 f"{CheckpointManager(ck).steps()}")
        resumed = train(ARCH, ckpt_dir=ck, ckpt_every=100, **kw)
        err = max(abs(a - b) for a, b in zip(resumed, full[4:]))
        if len(resumed) != 4 or err > RESUME_LOSS_ATOL:
            raise AssertionError(f"resumed losses {resumed} against "
                                 f"{full[4:]}")
        p0, o0 = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        like = {"params": p0, "opt": o0}
        ends = []
        for where in (full_ck, ck):
            mgr = CheckpointManager(where)
            ends.append(mgr.restore(like, 8)[1])
            mgr.close()
        want, got = ends

        def rel(got_t, want_t, base_t=None) -> float:
            """||got - want|| / ||want - base|| over the leaves (``base``
            0 when None)."""
            g, w = tree_leaves(got_t), tree_leaves(want_t)
            b = tree_leaves(base_t) if base_t is not None else [0] * len(w)
            num = sum(float((x - y).double().square().sum())
                      for x, y in zip(g, w))
            den = sum(float((y - z).double().square().sum())
                      for y, z in zip(w, b))
            return (num / den) ** 0.5
        state_err = {"params": rel(got["params"], want["params"], p0),
                     "mu": rel(got["opt"]["mu"], want["opt"]["mu"]),
                     "nu": rel(got["opt"]["nu"], want["opt"]["nu"])}
        counts = {int(got["opt"]["count"]), int(want["opt"]["count"])}
        if counts != {8} or max(state_err.values()) > RESUME_STATE_RTOL:
            raise AssertionError(f"resumed state against the uninterrupted "
                                 f"run: {state_err}, counts {counts}")
        params, opt = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(1), device)
        opt["mu"]["embed"].normal_()
        opt["count"].fill_(4)
        tree = {"params": params, "opt": opt,
                "bf16": {"embed": params["embed"].to(torch.bfloat16)}}
        saved = {name: t.clone() for name, t in tree_flatten_with_paths(tree)}
        mgr = CheckpointManager(str(Path(root) / "bits"), stripes=4)
        fut = mgr.save_async(4, tree)
        for _, t in tree_flatten_with_paths(tree):
            t.add_(1)                        # the save copied them already
        fut.result()
        step, got = mgr.restore(tree)
        mgr.close()
        bad = [name for name, t in tree_flatten_with_paths(got)
               if t.device.type != torch.device(device).type
               or not _bits_equal(t, saved[name])]
        if step != 4 or bad:
            raise AssertionError(f"restored step {step}, leaves not "
                                 f"bit-equal: {bad}")
    log("train", f"restart on {device} (reduced qwen3-1.7b, bf16 compute): "
        f"fail_at_step=6 raised with step_4 committed; resumed steps 4-7 "
        f"against the uninterrupted run: max |Δloss| {err:.2e} (limit "
        f"{RESUME_LOSS_ATOL}), final state relative error "
        + ", ".join(f"{k} {v:.2e}" for k, v in state_err.items())
        + f" (limit {RESUME_STATE_RTOL}), count 8 on both; save_async then "
        "in-place writes: "
        f"{len(saved)} leaves restored bit-equal (f32, int32, bf16)")


def phase_train() -> None:
    """Training on the card: qwen3-1.7b at full width through ``train()``
    and its steady step, the frontend, SSM and MoE families at full width
    (``_train_families``; qwen2-moe-a2.7b cut in depth), the reduced f32
    steps against the CPU (the MoE configs with drops), and a checkpoint
    restart."""
    t0 = time.perf_counter()
    _train_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    _profile_train_step()
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _train_families()
    t2 = time.perf_counter()
    _train_remat_policies()
    gc.collect()
    torch.cuda.empty_cache()
    _train_card_vs_cpu()
    _train_restart()
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"phase times: qwen3-1.7b full width {t1 - t0:.1f} s, "
        f"the families at full width {t2 - t1:.1f} s, reduced checks "
        f"{time.perf_counter() - t2:.1f} s")


def _step_timed(fn, steps: int):
    """``steps`` calls of ``fn()``, each timed by CUDA events; returns the
    results and the median ms."""
    out, times = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(fn())
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return out, statistics.median(times)


def _train_remat_policies() -> None:
    """qwen3-1.7b at full width with ``remat_policy="nothing"`` and
    ``"dots"`` (the matmul outputs kept): the step time (CUDA events,
    median of 3 after one warm-up) and the peak memory of each, the two
    steps' losses bit-equal."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import model as M
    cfg = get_config(ARCH)
    batch = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                          device="cuda").get_batch(0)
    res = {}
    for policy in ("nothing", "dots"):
        opts = M.RunOptions(q_chunk=min(TRAIN_SEQ, 512),
                            xent_chunk=min(TRAIN_SEQ, 512),
                            remat_policy=policy)
        cell = build_cell(cfg, ShapeConfig("custom", TRAIN_SEQ, TRAIN_BATCH,
                                           "train"), opts,
                          lr_peak=TRAIN_LR, total_steps=10 * TRAIN_STEPS)
        params, opt = make_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.reset_peak_memory_stats()
        first = cell.fn(params, opt, batch)[2]["loss"]
        losses, ms = _step_timed(
            lambda: cell.fn(params, opt, batch)[2]["loss"], 3)
        res[policy] = (torch.stack([first, *losses]), ms,
                       torch.cuda.max_memory_allocated() / 2 ** 30)
        del params, opt, cell
        gc.collect()
        torch.cuda.empty_cache()
    (ln, tn, pn), (ld, td, pd) = res["nothing"], res["dots"]
    if not _bits_equal(ln, ld):
        raise AssertionError(f"remat 'dots' losses {ld.tolist()} against "
                             f"'nothing' {ln.tolist()}")
    log("train", f"remat policy at full width (batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, one batch, CUDA events, median of 3 steps after "
        f"one, from the same state): 'nothing' {tn:.1f} ms, peak {pn:.2f} GiB; 'dots' "
        f"{td:.1f} ms, peak {pd:.2f} GiB ({td / tn:.3f}x the time, "
        f"{pd - pn:+.2f} GiB); losses bit-equal; {smi_line()}")


# phase dist: the train step over a mesh at world size 1, full width
# (the sharded step against the meshless one) and, for the checkpoint
# round trip, qwen3-1.7b at full width cut to DIST_ELASTIC_LAYERS of its 28
# layers (its f32 state 4.9 GB, written and read back; the whole model's
# would be 27.6 GB)
DIST_STEPS, DIST_ELASTIC_LAYERS = 3, 2


def _dist_run(cell, params, opt, batch, steps: int = DIST_STEPS) -> tuple:
    """``steps`` steps of ``cell.fn`` on one batch: the stacked (loss,
    grad norm) per step, the median step ms (CUDA events) and the peak
    GiB allocated."""
    torch.cuda.reset_peak_memory_stats()
    rows, ms = _step_timed(lambda: torch.stack([
        (m := cell.fn(params, opt, batch)[2])["loss"],
        m["grad_norm"]]), steps)
    return (torch.stack(rows), ms,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _dist_compressed(cfg, mesh, make_cell, batch) -> tuple:
    """``DIST_STEPS`` compressed steps; before each, ``cell.grads`` with
    the in-pod gradient ``g`` kept, and every leaf's synced gradient
    held bit for bit to the plain int8 quantize-dequantize of ``g + ef``
    (one pod, one scale per tensor) and the new ``ef`` to ``g + ef -
    deq``.  Returns the (loss, grad norm) rows, the median step ms, the
    largest of the steps' peaks (GiB allocated during ``cell.fn``, the
    checks' copies freed) and the leaves checked."""
    from repro_torch.launch.train import make_train_state
    from repro_torch.tree import tree_leaves
    cell = make_cell("compressed")
    params, opt = make_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        cell=cell)
    rows, times, peaks, leaves = [], [], [], 0
    for step in range(DIST_STEPS):
        _, _, extra = cell.grads(params, opt, batch, keep=True)
        for g, e, got, new in zip(*(tree_leaves(t) for t in (
                extra["grad"], opt["ef"], extra["synced"], extra["ef"]))):
            x = g.float() / 1 + e
            scale = (torch.max(torch.abs(x)) + 1e-12) / 127.0
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            deq = q.float() * scale
            if not (_bits_equal(got, deq.to(g.dtype))
                    and _bits_equal(new, x - deq)):
                raise AssertionError(f"compressed step {step}: a synced "
                                     "leaf or its error feedback is not the "
                                     "plain int8 composition")
            leaves += 1
        del extra, g, e, got, new, x, q, deq
        torch.cuda.reset_peak_memory_stats()
        (row,), ms = _step_timed(lambda: torch.stack([
            (m := cell.fn(params, opt, batch)[2])["loss"],
            m["grad_norm"]]), 1)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        rows.append(row)
        times.append(ms)
    return torch.stack(rows), statistics.median(times), max(peaks), leaves


def _dist_elastic(mesh, opts, tmp: str) -> float:
    """At full width cut to ``DIST_ELASTIC_LAYERS`` layers: a mesh run
    saves its state after 2 steps (gathered, rank 0 writes), the state
    is restored into a meshless state and takes step 3, whose loss must
    equal the uninterrupted mesh run's step 3 bit for bit.  Returns the
    save + restore seconds."""
    import dataclasses
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import make_train_state
    cfg = dataclasses.replace(get_config(ARCH),
                              num_layers=DIST_ELASTIC_LAYERS)
    shape = ShapeConfig("custom", TRAIN_SEQ, TRAIN_BATCH, "train")
    kw = dict(lr_peak=TRAIN_LR, total_steps=10 * TRAIN_STEPS)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                         device="cuda")

    def state(cell=None):
        return make_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
            cell=cell)
    cell = build_cell(cfg, shape, opts, mesh=mesh, **kw)
    params, opt = state(cell)
    losses = []
    mgr = CheckpointManager(os.path.join(tmp, "elastic"))
    for step in range(3):
        losses.append(cell.fn(params, opt, pipe.get_batch(step))[2]["loss"])
        if step == 1:
            t0 = time.perf_counter()
            mgr.save(2, {"params": params, "opt": opt},
                     shardings=cell.state_shardings())
            save_s = time.perf_counter() - t0
    del params, opt
    like = dict(zip(("params", "opt"), state()))
    t0 = time.perf_counter()
    step, restored = mgr.restore(like)
    load_s = time.perf_counter() - t0
    mgr.close()
    one = build_cell(cfg, shape, opts, **kw)
    loss = one.fn(restored["params"], restored["opt"],
                  pipe.get_batch(step))[2]["loss"]
    if step != 2 or not _bits_equal(loss, losses[2]):
        raise AssertionError(f"elastic restore at step {step}: loss "
                             f"{float(loss)!r} against the uninterrupted "
                             f"{float(losses[2])!r}")
    log("dist", f"elastic restore (qwen3-1.7b full width, "
        f"{DIST_ELASTIC_LAYERS} of 28 layers): saved from the mesh run "
        f"after 2 steps ({save_s:.2f} s), restored into a meshless state "
        f"({load_s:.2f} s); step 3 loss {float(loss):.6f} bit-equal to the "
        f"uninterrupted step 3; {smi_line()}")
    return save_s + load_s


def phase_dist() -> None:
    """The train step over a mesh on the card, world size 1: a NCCL
    process group on a store of its own, the (1, 1, 1) pod × data × model
    mesh, qwen3-1.7b at full width with phase train's batch and
    ``train()``'s options; 3 ``"auto"`` steps of ``build_cell(mesh=)``
    bit-equal to 3 meshless steps from the same state (losses, grad
    norms, every param leaf), through the tensor-parallel placement and
    functions (``parallel.tensor``: the heads, ff and vocabulary slices
    of a model axis of one, its ``copy``/``reduce`` and the
    vocab-parallel logsumexp counted); 3 ``"compressed"`` steps, each step's sync
    held bit for bit to the plain int8 composition; an elastic restore
    (``_dist_elastic``); every mesh state built as ``train()`` builds it,
    the AdamW state on the shards (``make_train_state(cell=)``); the step times and peaks of the three paths,
    and no kernel launched.  Every collective is a copy at world size 1:
    the times show what the sync path costs on the card."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import make_train_state
    from repro_torch.models import model as M
    from repro_torch.parallel import tensor
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    shape = ShapeConfig("custom", TRAIN_SEQ, TRAIN_BATCH, "train")
    kw = dict(lr_peak=TRAIN_LR, total_steps=10 * TRAIN_STEPS)
    batch = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                          device="cuda").get_batch(0)

    def opts(sync: str = "auto"):
        return M.RunOptions(q_chunk=min(TRAIN_SEQ, 512),
                            xent_chunk=min(TRAIN_SEQ, 512), grad_sync=sync)

    def state(cell=None):
        return make_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
            cell=cell)
    ops.reset_launches()
    plain = build_cell(cfg, shape, opts(), **kw)
    params, opt = state()
    m_plain, ms_plain, peak_plain = _dist_run(plain, params, opt, batch)
    want = tree_leaves(params)
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            assert dist.get_backend() == "nccl"
            mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))

            def make_cell(sync):
                return build_cell(cfg, shape, opts(sync), mesh=mesh, **kw)
            cell = make_cell("auto")
            local = sum(tree_leaves(cell.fsdp.local))
            params, opt = state(cell)
            gc.collect()
            torch.cuda.empty_cache()
            tensor.reset_calls()
            m_auto, ms_auto, peak_auto = _dist_run(cell, params, opt, batch)
            calls = dict(tensor.calls)
            if not (local and calls.get("copy") and calls.get("reduce")
                    and calls.get("lse")):
                raise AssertionError(
                    f"the mesh step did not run the tensor-parallel path: "
                    f"{local} model-local leaves, calls {calls}")
            bad = [i for i, (a, b) in enumerate(zip(tree_leaves(params),
                                                    want))
                   if not _bits_equal(a, b)]
            if not _bits_equal(m_auto, m_plain) or bad:
                raise AssertionError(
                    f"mesh 'auto' steps against meshless: (loss, grad "
                    f"norm) {m_auto.tolist()} vs {m_plain.tolist()}, "
                    f"{len(bad)} param leaves differ")
            del params, opt, want
            gc.collect()
            torch.cuda.empty_cache()
            m_comp, ms_comp, peak_comp, n_leaves = _dist_compressed(
                cfg, mesh, make_cell, batch)
            gc.collect()
            torch.cuda.empty_cache()
            io_s = _dist_elastic(mesh, opts(), tmp)
        finally:
            dist.destroy_process_group()
    launched = {k: n for k, n in ops.launches.items() if n}
    if launched:
        raise AssertionError(f"kernels launched by the train steps: "
                             f"{launched}")
    fmt = lambda m: ", ".join(f"{a:.6f}/{b:.4f}"  # noqa: E731
                              for a, b in m.tolist())
    log("dist", f"NCCL world size 1, mesh (1, 1, 1) pod x data x model; "
        f"qwen3-1.7b full width, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"{DIST_STEPS} steps from one state on one batch; (loss/grad "
        f"norm) meshless {fmt(m_plain)}; 'auto' bit-equal (losses, grad "
        f"norms, all {len(tree_leaves(M.param_specs(cfg)))} param leaves) "
        f"through the tensor-parallel path ({local} leaves held as model "
        f"slices; {DIST_STEPS} steps' calls {calls}); "
        f"'compressed' {fmt(m_comp)} ({n_leaves} leaf syncs bit-equal to "
        f"the plain int8 composition, error feedback exact); {smi_line()}")
    log("dist", f"step time (CUDA events, median of {DIST_STEPS}) and peak "
        f"allocated: meshless {ms_plain:.1f} ms, {peak_plain:.2f} GiB; "
        f"'auto' {ms_auto:.1f} ms ({ms_auto / ms_plain:.3f}x), "
        f"{peak_auto:.2f} GiB; 'compressed' {ms_comp:.1f} ms "
        f"({ms_comp / ms_plain:.3f}x), {peak_comp:.2f} GiB; kernel "
        f"launches 0; {smi_line()}")
    log("dist", f"phase time {time.perf_counter() - t0:.1f} s (checkpoint "
        f"write + read {io_s:.1f} s); {smi_line()}")


# phase cells: the serving cells over a mesh at world size 1 (a prefill
# of CELLS_PROMPT tokens; CELLS_STEPS decode steps of CELLS_SEATS seats
# over CELLS_ROWS rows, the cache's sequence split by decode_kv_seq_axis),
# and K4 with lse= over a cache of SPLIT_ROWS rows cut into SPLIT_PARTS
# slices, merged as the ranks' states are (parallel.sequence)
CELLS_PROMPT, CELLS_SEATS, CELLS_ROWS, CELLS_STEPS = 4096, 8, 16384, 3
CELLS_POS = (0, 1, 4095, 8191, 8192, 12000, 16000, 16380)
SPLIT_ROWS, SPLIT_PARTS = 32768, 4
SPLIT_LENGTHS = (1, 100, 8192, 8193, 16000, 24577, 30000, 32768)
SPLIT_WINDOWS = (5000, 9000)


def _cells_prefill(cfg, params, opts, mesh) -> dict:
    """The prefill cell over the mesh against the meshless prefill cell at
    1 x CELLS_PROMPT: logits and every cache leaf bit-equal, the same
    kernel launches; then its kernels at its shapes against plain
    (``_cells_prefill_kernels``).  Returns the mesh run's launch
    counts."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.convert import COMPUTE_CAST
    from repro_torch.tree import tree_flatten_with_paths
    shape = ShapeConfig("cells_prefill", CELLS_PROMPT, 1, "prefill")
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, CELLS_PROMPT),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    one = build_cell(cfg, shape, opts)
    cell = build_cell(cfg, shape, opts, mesh=mesh)
    dtypes = {t.dtype for name, t in tree_flatten_with_paths(params)
              if name.split("/")[-1] in COMPUTE_CAST}
    if dtypes != {cell.param_dtype}:
        raise AssertionError(f"serving weights in {dtypes}; the cells lay "
                             f"them out in {cell.param_dtype}")
    ops.reset_launches()
    want, wcache = one.fn(params, batch)
    meshless = {k: n for k, n in ops.launches.items() if n}
    shard = cell.shard_params(params)
    ops.reset_launches()
    got, gcache = cell.fn(shard, batch)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launches.items() if n}
    bad = [k for (k, a), (_, b) in zip(tree_flatten_with_paths(gcache),
                                       tree_flatten_with_paths(wcache))
           if not _bits_equal(a, b)]
    if not _bits_equal(got, want) or bad:
        raise AssertionError(
            f"prefill cell vs meshless prefill: logits max diff "
            f"{(got - want).abs().max().item():.3e}, cache leaves that "
            f"differ {bad}")
    if counts != meshless or not counts.get("flash_attention[causal]"):
        raise AssertionError(f"the prefill cell's launches {counts}; the "
                             f"meshless prefill's {meshless}")
    n_leaves = len(tree_flatten_with_paths(gcache))
    del shard, gcache, wcache
    errs = _cells_prefill_kernels(gen)
    log("cells", f"prefill cell 1 x {CELLS_PROMPT} over the (1, 1, 1) "
        f"mesh: logits and all {n_leaves} "
        f"cache leaves bit-equal to the meshless prefill; launches "
        f"{counts}; its kernels at its shapes vs plain: {errs}; "
        f"{smi_line()}")
    return counts


def _cells_prefill_kernels(gen: torch.Generator) -> dict:
    """The prefill cell's kernels at its shapes against their plain
    versions, bf16: K5 causal over CELLS_PROMPT tokens (16 heads over 8
    of 128), K3 and the fused add + norm at CELLS_PROMPT rows of D_MODEL,
    the q/k norm at its rows of HEAD_DIM.  Returns each max |err|."""
    from repro_torch.kernels import ops
    S = CELLS_PROMPT
    q, k, v = (torch.randn((1, S, n, HEAD_DIM), generator=gen,
                           device="cuda").bfloat16() for n in (H, KVH, KVH))
    got, want = (ops.flash_attention(q, k, v, causal=True, impl=impl)
                 for impl in ("kernel", "plain"))
    torch.cuda.synchronize()
    errs = {"flash_attention[causal]": check_close(
        f"flash_attention[causal, S={S}]", got, want, BF16_ATOL, BF16_RTOL)}
    del got, want
    wq, wk = (0.1 * torch.randn((HEAD_DIM,), generator=gen, device="cuda")
              for _ in range(2))
    (gq, gk), (pq, pk) = (ops.rmsnorm_qk(q, k, wq, wk, impl=impl)
                          for impl in ("kernel", "plain"))
    torch.cuda.synchronize()
    errs["rmsnorm_qk"] = max(
        check_close(f"rmsnorm_qk[S={S}] q", gq, pq, BF16_ATOL, BF16_RTOL),
        check_close(f"rmsnorm_qk[S={S}] k", gk, pk, BF16_ATOL, BF16_RTOL))
    _norms_vs_plain("cells", 14, (D_MODEL,), ((S, torch.bfloat16),), (),
                    None)
    return {key: f"{e:.3e}" for key, e in errs.items()}


def _cells_decode(cfg, params, opts, mesh) -> dict:
    """The decode cell with ``decode_kv_seq_axis`` over the mesh against
    the meshless decode cell, CELLS_STEPS greedy steps of CELLS_SEATS
    seats at CELLS_POS over a drawn cache of CELLS_ROWS rows (each cell
    on its own copy): logits, tokens and the whole cache bit-equal (at
    one rank the merge's weight is exactly 1).  Then K4 with lse= at the
    cell's shape (layer 0's cache) against its plain version.  Returns
    the mesh run's launch counts and that check's error."""
    import dataclasses
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel import tensor
    from repro_torch.tree import tree_leaves
    shape = ShapeConfig("cells_decode", CELLS_ROWS, CELLS_SEATS, "decode")
    sopts = dataclasses.replace(opts, decode_kv_seq_axis=True)
    one = build_cell(cfg, shape, sopts)
    cell = build_cell(cfg, shape, sopts, mesh=mesh)
    seq = cell.layout["pos0"]["k"].seq
    if seq is None or seq.axes != ("model",):
        raise AssertionError(f"decode_kv_seq_axis put the sequence on "
                             f"{seq}; the rules give it 'model'")
    gen = torch.Generator(device="cuda").manual_seed(12)
    cache_a = one.init_cache(device="cuda")
    for t in tree_leaves(cache_a):
        t.normal_(generator=gen)
    cache_b = cell.shard_cache(cache_a)
    gib = sum(t.numel() * t.element_size() for t in tree_leaves(cache_a))
    tok0 = torch.randint(0, cfg.vocab_size, (CELLS_SEATS, 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos0 = torch.tensor(CELLS_POS, dtype=torch.int32, device="cuda")
    shard = cell.shard_params(params)

    def run(c, p, cache):
        tok, pos, rows = tok0, pos0, []
        for _ in range(CELLS_STEPS):
            logits, cache = c.fn(p, cache, tok, pos)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            rows.append((logits, tok))
            pos = pos + 1
        return rows
    want = run(one, params, cache_a)
    ops.reset_launches()
    tensor.reset_calls()
    t0 = time.perf_counter()
    got = run(cell, shard, cache_b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in ops.launches.items() if n}
    calls = dict(tensor.calls)
    for step, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        if not (_bits_equal(gl, wl) and torch.equal(gt, wt)):
            raise AssertionError(
                f"decode cell step {step} vs meshless: logits max diff "
                f"{(gl - wl).abs().max().item():.3e}, tokens "
                f"{gt.flatten().tolist()} vs {wt.flatten().tolist()}")
    bad = [i for i, (a, b) in enumerate(zip(tree_leaves(cache_b),
                                            tree_leaves(cache_a)))
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"decode cell cache leaves {bad} differ from "
                             "the meshless decode's")
    n_layers = cfg.num_layers * CELLS_STEPS
    if counts.get("decode_attention[bf16,lse]") != n_layers or \
            counts.get("decode_attention[bf16]"):
        raise AssertionError(f"the decode cell's attention launches "
                             f"{counts}; want {n_layers} of "
                             "decode_attention[bf16,lse] and no other")
    # K4 with lse= at the cell's shape: layer 0 after the steps
    q = torch.randn((CELLS_SEATS, 1, H, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k, v = cache_b["pos0"]["k"][0], cache_b["pos0"]["v"][0]
    lens = (pos0 + CELLS_STEPS).int()
    err = _lse_vs_plain("decode cell shape", q, k, v, lens, None)
    log("cells", f"decode cell, decode_kv_seq_axis (the sequence on "
        f"{seq.axes}, {seq.n} rank): {CELLS_STEPS} greedy steps of "
        f"{CELLS_SEATS} seats at positions {CELLS_POS} over {CELLS_ROWS} "
        f"rows ({gib / 2 ** 30:.2f} GiB of drawn cache each): logits, "
        f"tokens and cache bit-equal to the meshless decode_step; launches "
        f"{counts}; tensor-parallel calls {calls}; {wall * 1e3:.1f} ms "
        f"wall for the steps; K4 lse= at (8, {CELLS_ROWS}, 8, 128) vs plain "
        f"max|err| {err:.3e}; {smi_line()}")
    del cache_a, cache_b, shard
    return counts, err


def _lse_vs_plain(what: str, q, k, v, lengths, starts) -> float:
    """K4 with lse= (and starts=) against its plain version: the f32
    outputs within F32_TOL, the lse values within 1e-4 absolute (-inf
    where the plain one is).  Returns the outputs' max |err|."""
    from repro_torch.kernels import ops
    B, _, Hq, _ = q.shape
    lk, lp = (torch.empty((B, Hq), device="cuda") for _ in range(2))
    got = ops.decode_attention(q, k, v, lengths, starts=starts, lse=lk,
                               impl="kernel")
    want = ops.decode_attention(q, k, v, lengths, starts=starts, lse=lp,
                                impl="plain")
    torch.cuda.synchronize()
    err = check_close(f"decode_attention[lse] {what}", got, want, *F32_TOL)
    fin = torch.isfinite(lp)
    if not torch.equal(fin, torch.isfinite(lk)) or not bool(
            torch.isneginf(lk[~fin]).all()) or bool(
            ((lk - lp).abs()[fin] > 1e-4).any()):
        raise AssertionError(f"decode_attention[lse] {what}: lse parts "
                             "from the plain version's")
    return err


def _cells_split(flush: torch.Tensor) -> dict:
    """K4 with lse= over a (8, SPLIT_ROWS, 8, 128) bf16 cache cut into
    SPLIT_PARTS slices (seats of SPLIT_LENGTHS keys: some slices empty),
    each slice's states merged by ``parallel.sequence.merge``, against K4
    and the plain version over the whole cache; again with windows
    (``starts=``) that cross the slices' edges; each slice's call held to
    plain.  Then K4 with lse= timed over the whole cache at full length
    beside the plain version and SDPA.  Returns the kernels-line row."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import sequence as S
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, T, n = len(SPLIT_LENGTHS), SPLIT_ROWS, SPLIT_ROWS // SPLIT_PARTS
    q = torch.randn((B, 1, H, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((B, T, KVH, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn((B, T, KVH, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device="cuda")
    errs, empty = [], 0
    for window in (None,) + SPLIT_WINDOWS:
        outs, lses = [], []
        for r in range(SPLIT_PARTS):
            lo = r * n
            lens, starts = S.local_bounds(lengths - 1, lo, n, window)
            lse = torch.empty((B, H), device="cuda")
            kr, vr = k[:, lo:lo + n], v[:, lo:lo + n]
            outs.append(ops.decode_attention(q, kr, vr, lens, starts=starts,
                                             lse=lse, impl="kernel")[:, 0])
            lses.append(lse)
            errs.append(_lse_vs_plain(f"slice {r}, window {window}", q, kr,
                                      vr, lens, starts))
            empty += int(torch.isneginf(lse[:, 0]).sum())
        merged, _ = S.merge(torch.stack(outs), torch.stack(lses))
        merged = merged[:, None].to(q.dtype)
        for impl in ("kernel", "plain"):
            whole = ops.decode_attention(q, k, v, lengths, window=window,
                                         impl=impl)
            errs.append(check_close(
                f"split-and-merge vs {impl}, window {window}", merged, whole,
                BF16_ATOL, BF16_RTOL))
    err = max(errs)
    full = torch.full((B,), T, dtype=torch.int32, device="cuda")
    lse = torch.empty((B, H), device="cuda")
    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, full, lse=lse,
                                              impl="kernel"), flush)
    plain_ms = cuda_ms(lambda: ops.decode_attention(
        q, k, v, full, lse=lse, impl="plain"), flush, iters=3)
    kg = k.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    vg = v.transpose(1, 2).repeat_interleave(H // KVH, dim=1).contiguous()
    qs = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: sdpa(SDPBackend.EFFICIENT_ATTENTION, qs, kg, vg),
                     flush)
    del kg, vg
    nbytes = (2 * B * T * KVH * HEAD_DIM * 2 + q.numel() * 2
              + q.numel() * 4 + lse.numel() * 4 + full.numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * B * T * H * HEAD_DIM)
    log("cells", f"K4 lse= split over {SPLIT_PARTS} slices of {n} rows "
        f"(lengths {SPLIT_LENGTHS}; windows None, {SPLIT_WINDOWS}; "
        f"{empty} empty (seat, slice) states, lse -inf): merged held to "
        f"K4 and to plain over the whole cache, each slice held to plain; "
        f"max|err| {err:.3e}")
    log("cells", f"decode_attention[lse] at ({B}, {T}, {KVH}, {HEAD_DIM}) "
        f"bf16, full lengths: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"{SDPA_EFF} {lib_ms:.4f} ms bound {b_ms:.5f} ms ({b_by}, "
        f"{nbytes / 1e9:.3f} GB); {smi_line()}")
    return {"decode_attention[lse]": dict(
        name="decode_attention", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=SDPA_EFF)}


def phase_cells() -> tuple:
    """The serving cells on the card, world size 1: a NCCL process group
    on a store of its own, the (1, 1, 1) pod × data × model mesh,
    qwen3-1.7b at full width in bf16 (drawn cast); the prefill cell
    (``_cells_prefill``) and the decode cell with ``decode_kv_seq_axis``
    (``_cells_decode``) bit-equal to the meshless cells, the decode
    cell's attention through K4 with ``lse=`` (its launches the main
    path's count); then K4's split-and-merge (``_cells_split``), timed.
    Returns the kernels-line rows and the decode cell's launch counts."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg, params = _draw_cast(ARCH, "cells")
    opts = M.RunOptions()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
            _cells_prefill(cfg, params, opts, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            counts, cell_err = _cells_decode(cfg, params, opts, mesh)
        finally:
            dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = _cells_split(flush)
    rows["decode_attention[lse]"]["max_abs_err"] = max(
        rows["decode_attention[lse]"]["max_abs_err"], cell_err)
    del flush
    log("cells", f"phase time {time.perf_counter() - t0:.1f} s; "
        f"{smi_line()}")
    return rows, counts


def check_fp8(name: str, got: torch.Tensor, want: torch.Tensor, a_q, b_q,
              sa_rows: torch.Tensor, sb_cols: torch.Tensor,
              faults: dict | None = None) -> float:
    """Holds the fp8 GEMM kernel ``got`` against its plain version
    ``want`` on the same e4m3 operands, to ``fp8_matmul.error_bound``:
    the f32 summation bound ``2·γ_K·(|a_q|·|b_q|)·(sa·sb) +
    2^-23·|plain|`` plus the tensor-core term ``2^-9·(|a_q|·|b_q|)·(sa·sb)``
    of sums promoted into f32 every 128 products.  ``sa_rows`` (M,) and
    ``sb_cols`` (N,) are each row's and column's scale.  Logs the largest
    ``|Δ| / ((|a_q|·|b_q|)·sa·sb)`` and whether the f32 bound alone (that
    of a kernel summing in f32) held as well.

    ``faults`` maps a planted fault's name to ``(make, must_fail)``:
    ``make()`` returns a wrong result for the same product, which is held
    to the same limit and its ratio logged; where ``must_fail``, the
    limit must reject it.  Returns the kernel's ratio."""
    from repro_torch.kernels import fp8_matmul as fm
    k = a_q.shape[1]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    mag = fm.magnitude(a_q, b_q, sa_rows, sb_cols)
    lim = fm.error_bound(mag, want, k)

    def held(res):
        err = (res - want).abs()
        ratio = torch.where(mag > 0, err / mag, 0.0).max().item()
        return err, ratio, bool((err <= lim).all())
    err, ratio, ok = held(got)
    if not ok:
        raise AssertionError(
            f"{name}: max |kernel - plain| {err.max().item():.3e} beyond "
            f"the tensor-core bound (largest |Δ|/mag {ratio:.3e}, limit "
            f"2·γ_K + {fm.TC_LIMIT:.3e})")
    f32_ok = bool((err <= fm.error_bound(mag, want, k,
                                         tensor_core=False)).all())
    log("hpc", f"{name}: max|err| {err.max().item():.3e}, largest "
        f"|Δ|/((|a||b|)·s) {ratio:.3e} within the tensor-core bound "
        f"(2·γ_K + 2^-9, K={k}); within the f32 summation bound alone: "
        f"{f32_ok}")
    del err
    for fault, (make, must_fail) in (faults or {}).items():
        _, r, passed = held(make())
        log("hpc", f"{name}: planted fault [{fault}]: largest |Δ|/mag "
            f"{r:.3e}, {'passes' if passed else 'fails'} the bound")
        assert not (must_fail and passed), \
            f"{name}: the bound passes the planted fault [{fault}]"
    return ratio


def _dropped_kstep(a_q: torch.Tensor) -> torch.Tensor:
    """a_q with its second wgmma k-step (columns 32–63) zeroed: the result
    of a kernel that skips one k-step of its first chunk."""
    bad = a_q.clone()
    bad[:, 32:64] = 0
    return bad


def _no_promotion(a_q, b_q, sa, sb):
    """``torch._scaled_mm`` with fast accumulation: Hopper's fp8 tensor-core
    sums kept across all of K, never promoted (b_q column-major)."""
    return lambda: torch._scaled_mm(a_q, b_q, scale_a=sa, scale_b=sb,
                                    out_dtype=torch.float32,
                                    use_fast_accum=True)


def _fp8_kernel(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K6 against its plain version: the per-block wrapper at aligned and
    ragged shapes and at bm/bn != 128; the per-tensor (broadcast-scale)
    call at the n = 256, nb = 64 LU's first trailing update, at a K the
    wrapper pads (b column-major, as the LU's row panel is), on operands
    of one sign (every product positive, so no truncation cancels
    another: the shape that shows promotion), and at a mid-run HPL
    trailing-update shape, M = N = 32768, K = NB, timed (``event_ms``)
    with the plain version and the ``torch._scaled_mm`` yardstick.  At
    each shape planted faults are held to the same bound and must fail
    it: a dropped k-step everywhere, a scale of the wrong block where
    there are blocks, and sums never promoted on the one-sign operands
    (logged on signed operands, where promotion changes little)."""
    from repro_torch.core.mixed_precision import quantize_fp8
    from repro_torch.kernels import ops
    ratios = []
    for m, k, n, (bm, bn, bk) in ((512, 1024, 384, (128, 128, 128)),
                                  (1000, 700, 300, (128, 128, 128)),
                                  (320, 512, 448, (64, 256, 64))):
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
        a_q, b_q, sa, sb = ops.quantize_blocks(a, b, bm=bm, bn=bn, bk=bk)
        got = ops.fp8_matmul(a, b, bm=bm, bn=bn, bk=bk, impl="kernel")
        torch.cuda.synchronize()
        want = ops.fp8_matmul(a, b, bm=bm, bn=bn, bk=bk, impl="plain")

        def bad(aq, sa_, sb_, b_q=b_q, bm=bm, bn=bn, bk=bk, m=m, n=n):
            return lambda: ops.scaled_fp8_matmul(
                aq, b_q, sa_, sb_, bm=bm, bn=bn, bk=bk,
                impl="kernel")[:m, :n]
        ratios.append(check_fp8(
            f"fp8_matmul[M={m},K={k},N={n},bm={bm},bn={bn},bk={bk}]", got,
            want, a_q[:m], b_q[:, :n], sa.repeat_interleave(bm)[:m],
            sb.repeat_interleave(bn)[:n], faults={
                "a scale of the wrong block": (bad(a_q, sa.roll(1), sb),
                                               True),
                "b scale of the wrong block": (bad(a_q, sa, sb.roll(1)),
                                               True),
                "dropped k-step": (bad(_dropped_kstep(a_q), sa, sb), True)}))
    # K = 200 reaches the kernel padded to 208 (TMA's 16-byte rows); the
    # one-sign operands come last
    for m, k, n, draw in ((192, 64, 192, torch.randn),
                          (384, 200, 320, torch.randn),
                          (512, 1024, 512, torch.rand)):
        a_q, sa = quantize_fp8(draw((m, k), generator=gen, device="cuda"))
        b_q, sb = quantize_fp8(draw((n, k), generator=gen,
                                    device="cuda").t())
        assert b_q.t().is_contiguous(), "b_q is not column-major"

        def run(aq, impl="kernel", b_q=b_q, sa=sa, sb=sb, m=m, n=n, k=k):
            return ops.scaled_fp8_matmul(aq, b_q, sa.reshape(1),
                                         sb.reshape(1), bm=m, bn=n, bk=k,
                                         impl=impl)
        faults = {"dropped k-step":
                  (lambda run=run, a_q=a_q: run(_dropped_kstep(a_q)), True)}
        if k % 16 == 0:                        # _scaled_mm's contract
            faults["no promotion"] = (_no_promotion(a_q, b_q, sa, sb),
                                      draw is torch.rand)
        sign = "one-sign operands" if draw is torch.rand else "b column-major"
        ratios.append(check_fp8(
            f"fp8_matmul[per-tensor, M={m},K={k},N={n},{sign}]", run(a_q),
            run(a_q, "plain"), a_q, b_q, sa.expand(m), sb.expand(n),
            faults=faults))

    M, N, K = K6_M, K6_N, HPL_NB
    a = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((K, N), generator=gen, device="cuda")
    a_q, sa = quantize_fp8(a)
    b_q, sb = quantize_fp8(b)
    del a, b

    def run(impl):
        return ops.scaled_fp8_matmul(a_q, b_q, sa.reshape(1), sb.reshape(1),
                                     bm=M, bn=N, bk=K, impl=impl)
    got = run("kernel")
    torch.cuda.synchronize()
    want = run("plain")
    err = (got - want).abs().max().item()
    b_cm = b_q.t().contiguous().t()            # column-major, as cuBLASLt takes
    ratios.append(check_fp8(
        f"fp8_matmul[per-tensor, M={M},K={K},N={N}]", got, want, a_q, b_q,
        sa.expand(M), sb.expand(N), faults={
            "dropped k-step": (lambda: ops.scaled_fp8_matmul(
                _dropped_kstep(a_q), b_q, sa.reshape(1), sb.reshape(1),
                bm=M, bn=N, bk=K, impl="kernel"), True),
            "no promotion": (_no_promotion(a_q, b_cm, sa, sb), False)}))
    del got, want
    log("hpc", f"fp8_matmul: largest |Δ|/((|a||b|)·s) over the checks "
        f"{max(ratios):.3e} (one-sign operands {ratios[-2]:.3e}, signed "
        f"{max(ratios[:-2] + ratios[-1:]):.3e}); limit 2^-9 = "
        f"{2.0 ** -9:.3e} plus 2·γ_K")
    ms = event_ms(lambda: run("kernel"), flush, iters=5)
    plain_ms = event_ms(lambda: run("plain"), flush, iters=3)
    library = "torch._scaled_mm[out f32]"
    try:
        lib_ms = event_ms(lambda: torch._scaled_mm(
            a_q, b_cm, scale_a=sa, scale_b=sb, out_dtype=torch.float32),
            flush, iters=5)
    except RuntimeError as e:                  # the yardstick only
        log("hpc", f"_scaled_mm refused an f32 output ({e}); timing it with "
            "a bf16 output")
        library = "torch._scaled_mm[out bf16]"
        lib_ms = event_ms(lambda: torch._scaled_mm(
            a_q, b_cm, scale_a=sa, scale_b=sb, out_dtype=torch.bfloat16),
            flush, iters=5)
    nbytes = M * K + K * N + 4 * M * N + 8
    flops = 2.0 * M * N * K
    # a reading above the fp8 tensor-core peak is a misread timer
    assert flops / (ms * 1e-3) <= FP8_FLOPS, \
        f"fp8_matmul timed at {ms:.3f} ms, above the fp8 tensor-core peak"
    b_ms, b_by = bound(nbytes, flops, FP8_FLOPS)
    log("hpc", f"fp8_matmul[e4m3] M=N={M} K={K}: kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms "
        f"{library} {lib_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e9:.2f} GB; operations at the fp8 tensor-core rate "
        f"{flops / FP8_FLOPS * 1e3:.4f} ms)")
    return {"fp8_matmul[e4m3]": dict(
        name="fp8_matmul", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=library)}


def _hpl_runs() -> tuple:
    """HPL (fp32) and HPL-MxP (fp8, bf16) at HPL_N, HPL_NB through the
    entry points ``run_hpl``/``run_hplmxp``, each with the kernel launch
    counts set to 0 just before it and read just after it."""
    from repro_torch.core.hpl import run_hpl
    from repro_torch.core.hplmxp import run_hplmxp
    from repro_torch.kernels import ops
    n, nb = HPL_N, HPL_NB
    counts = {}
    ops.reset_launches()                       # the main path starts here
    hpl = run_hpl(n, nb, device="cuda")
    counts["fp32"] = dict(ops.launches)        # ... and ends here
    assert hpl["passed"] and hpl["residual"] < 16, f"HPL fp32: {hpl}"
    assert counts["fp32"] == {}, f"HPL fp32 launched {counts['fp32']}"
    log("hpc", f"HPL fp32 N={n} NB={nb}: {hpl['time_s']:.2f} s "
        f"{hpl['gflops']:.1f} GFLOP/s residual {hpl['residual']:.3e}")
    runs = {"fp32": hpl}
    for prec in ("fp8", "bf16"):
        ops.reset_launches()                   # the main path starts here
        r = run_hplmxp(n, nb, lowprec=prec, ir_iters=8, device="cuda")
        counts[prec] = dict(ops.launches)      # ... and ends here
        hist = r["ir_history"]
        assert r["passed"] and r["residual"] < 16, f"HPL-MxP {prec}: {r}"
        assert hist[-1] < hist[0], f"HPL-MxP {prec}: IR history {hist}"
        # one trailing update per block step but the last, in the timed
        # factorization and in the warm-up at 2·NB
        want = ({"fp8_matmul[e4m3]": n // nb - 1 + 1} if prec == "fp8"
                else {})
        assert counts[prec] == want, \
            f"HPL-MxP {prec}: launches {counts[prec]}, expected {want}"
        log("hpc", f"HPL-MxP {prec} N={n} NB={nb}: LU {r['lu_time_s']:.2f} s "
            f"({r['gflops_lu_only']:.1f} GFLOP/s LU only), IR "
            f"{r['ir_time_s']:.3f} s, {r['gflops']:.1f} GFLOP/s; residual "
            f"{r['residual']:.3e} after IR, {r['residual_no_ir']:.3e} "
            f"without; IR history {[f'{h:.1e}' for h in hist]}; launches "
            f"{json.dumps(counts[prec])}")
        runs[prec] = r
    # information: the test matrix's 0.3·N diagonal shift shrinks the
    # trailing updates, and the fp8 error in them, as N grows;
    # _fp8_lu_alone holds the reference's criterion at its own size
    log("hpc", f"fp8 factor without IR at N={n}: residual "
        f"{runs['fp8']['residual_no_ir'] / hpl['residual']:.2f}x the fp32 "
        "factor's")
    return runs, counts


def _fp8_lu_alone() -> None:
    """The reference's ``test_hplmxp_fp8_lu_alone_is_inaccurate`` on the
    card: at n = 256, nb = 64 the fp8 factor solved without refinement
    must leave more than 5x the fp32 factor's scaled residual.  Larger n
    are logged: the test matrix's 0.3·n diagonal shift shrinks the
    trailing updates, and with them the fp8 error, as 1/n."""
    from repro_torch.core.hpl import (blocked_lu, hpl_residual, lu_solve,
                                      make_test_matrix)
    for n, nb in ((256, 64), (1024, 128), (4096, 512), (16384, 1024)):
        a, b = make_test_matrix(n, device="cuda")
        r = {m: float(hpl_residual(a, lu_solve(blocked_lu(
            a, nb=nb, matmul=m), b), b)) for m in ("fp8", "fp32")}
        ratio = r["fp8"] / r["fp32"]
        log("hpc", f"fp8 LU without IR, n={n} nb={nb}: residual "
            f"{r['fp8']:.3e} = {ratio:.1f}x the fp32 factor's "
            f"{r['fp32']:.3e}" + (" (must exceed 5x)" if n == 256 else ""))
        if n == 256:
            assert ratio > 5, f"fp8 LU without IR only {ratio:.2f}x fp32's"


def _hpl_kernel_vs_plain() -> None:
    """``blocked_lu(matmul="fp8")`` at HPL_CHECK_N with the kernel and with
    the plain version.  Both factor the first panel identically, so the
    first trailing update multiplies identical quantized operands: it is
    held to ``check_fp8``'s bound, with a dropped k-step planted.  Later
    panels can flip an e4m3
    rounding, so the refined solutions (8 iterations) are held instead:
    within 1e-4 of |x|∞, the f32 accuracy IR reaches on this matrix."""
    from repro_torch.core.hpl import blocked_lu, lu_solve, make_test_matrix
    from repro_torch.core.mixed_precision import (iterative_refinement,
                                                  quantize_fp8)
    from repro_torch.kernels import ops
    n, nb = HPL_CHECK_N, HPL_NB
    a, b = make_test_matrix(n, device="cuda")
    lu = {impl: blocked_lu(a, nb=nb, matmul="fp8", impl=impl)
          for impl in ("kernel", "plain")}
    l_col, u_row = lu["kernel"][nb:, :nb], lu["kernel"][:nb, nb:]
    assert torch.equal(l_col, lu["plain"][nb:, :nb]) and \
        torch.equal(u_row, lu["plain"][:nb, nb:]), "first panels differ"
    qa, sa = quantize_fp8(l_col)
    qb, sb = quantize_fp8(u_row)
    # the real path's row panel, as blocked_lu makes it: a triangular
    # solve's result, whose e4m3 copy the kernel reads without a transpose
    # when it is column-major
    u_solve = torch.linalg.solve_triangular(
        lu["kernel"][:nb, :nb], a[:nb, nb:], upper=False, unitriangular=True)
    log("hpc", f"row panel from solve_triangular: strides "
        f"{u_solve.stride()}, its e4m3 copy column-major (no transpose "
        f"copy): {quantize_fp8(u_solve)[0].t().is_contiguous()}")
    del u_solve
    first = {impl: ops.scaled_fp8_matmul(qa, qb, sa.reshape(1),
                                         sb.reshape(1), bm=n - nb, bn=n - nb,
                                         bk=nb, impl=impl)
             for impl in ("kernel", "plain")}
    check_fp8(f"first trailing update N={n}", first["kernel"],
              first["plain"], qa, qb, sa.expand(n - nb), sb.expand(n - nb),
              faults={"dropped k-step": (lambda: ops.scaled_fp8_matmul(
                  _dropped_kstep(qa), qb, sa.reshape(1), sb.reshape(1),
                  bm=n - nb, bn=n - nb, bk=nb, impl="kernel"), True)})
    x = {}
    for impl, f in lu.items():
        x[impl], _ = iterative_refinement(lambda v: a @ v,
                                          lambda r, f=f: lu_solve(f, r), b,
                                          iters=8)
    dx = (x["kernel"] - x["plain"]).abs().max().item()
    scale = x["plain"].abs().max().item()
    dlu = (lu["kernel"] - lu["plain"]).abs().max().item()
    assert dx <= 1e-4 * scale, \
        f"IR solutions kernel vs plain differ by {dx:.3e} (|x| {scale:.3e})"
    log("hpc", f"blocked_lu fp8 N={n}: factors kernel vs plain max|Δ| "
        f"{dlu:.3e}; IR solutions max|Δ| {dx:.3e} (|x|∞ {scale:.3e}, "
        "limit 1e-4·|x|∞)")


def _hpcg_runs() -> None:
    """HPCG at 256³ (50 iterations, the reference default) with the true
    residual recomputed against the recurrence's, then the 48³,
    90-iteration case of ``benchmarks/run.py``, which must converge."""
    from repro_torch.core.hpcg import run_hpcg
    e = HPCG_EDGE
    r = run_hpcg(e, e, e, max_iters=50, device="cuda")
    ratio = r["true_rel_residual"] / r["rel_residual"]
    # in f32 the recurrence drifts from the true residual by ~eps·|A||x|,
    # far below a residual that 50 iterations leave at this size
    assert 1 / 1.5 < ratio < 1.5, f"HPCG {e}³: true/recurrence {ratio}"
    log("hpc", f"HPCG {e}³ 50 iterations: {r['time_s'] * 1e3:.1f} ms "
        f"{r['gflops']:.1f} GFLOP/s {r['bandwidth_gbs']:.1f} GB/s (nominal "
        f"bytes), relative residual {r['rel_residual']:.3e}, true "
        f"{r['true_rel_residual']:.3e} (ratio {ratio:.4f}, limit 1.5x)")
    r = run_hpcg(48, 48, 48, max_iters=90, device="cuda")
    assert r["converged"], f"HPCG 48³: {r}"
    log("hpc", f"HPCG 48³ 90 iterations: {r['time_s'] * 1e3:.1f} ms "
        f"{r['gflops']:.2f} GFLOP/s, relative residual "
        f"{r['rel_residual']:.3e} (converged < 1e-4)")


def phase_hpc() -> tuple:
    """The HPC path: K6 against its plain version and timed; HPL fp32 and
    HPL-MxP fp8/bf16 at full size; the fp8 factorization with the kernel
    against the plain version; HPCG.  Returns K6's results and the
    launch counts of each HPL run."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    results = _fp8_kernel(gen, flush)
    del flush
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs, counts = _hpl_runs()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t2 = time.perf_counter()
    _fp8_lu_alone()
    _hpl_kernel_vs_plain()
    _hpcg_runs()
    log("hpc", f"phase times: K6 checks {t1 - t0:.1f} s, HPL runs "
        f"{t2 - t1:.1f} s (peak {peak:.1f} GiB allocated), the rest "
        f"{time.perf_counter() - t2:.1f} s")
    return results, counts


# the serving CLIs: each phase queues its own runs of ``python -m
# repro_torch.launch.serve`` (arguments and a check of the finished
# process), and ``phase_cli`` runs them all after the last phase,
# CLI_PARALLEL at a time.  A run spends most of its 15-35 s starting
# Python, torch and a CUDA context and little on the card (reduced
# configs), and run one after another inside their phases they took
# ~250 s of the script
CLI_JOBS: list = []
CLI_PARALLEL = 6


def phase_cli() -> None:
    """Every queued CLI run, CLI_PARALLEL processes at a time, each
    waited for (600 s at most), then each checked as its phase asked."""
    from concurrent.futures import ThreadPoolExecutor
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run(args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *args],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(CLI_PARALLEL) as pool:
        outs = list(pool.map(run, [args for args, _ in CLI_JOBS]))
    for (_, check), out in zip(CLI_JOBS, outs):
        check(out)
    log("cli", f"{len(outs)} serving CLI runs, {CLI_PARALLEL} at a time: "
        f"{time.perf_counter() - t0:.1f} s")
    CLI_JOBS.clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    results = phase_kernels(flush)
    del flush
    phase_variants()
    runs, counts = phase_serve()
    counts["fixed"] = phase_serve_fixed(runs["bf16"])
    reqs = sorted(runs["bf16"]["finished"], key=lambda q: q.rid)
    prompts = [q.prompt for q in reqs[:8]]
    requests = [(q.prompt, q.max_new_tokens) for q in reqs]
    want = {tag: ({q.rid: q.generated for q in runs[tag]["finished"]},
                  runs[tag]["engine"].trace) for tag in ("bf16", "fp8")}
    params = runs["bf16"]["engine"].params
    del runs, reqs                             # free the serving state
    gc.collect()
    torch.cuda.empty_cache()
    phase_telemetry(params, requests, want)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the engines' pools, weights and graphs (with their private memory)
    # go with them
    log("serve", f"serving state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")
    phase_fleet()
    gc.collect()
    torch.cuda.empty_cache()
    log("fleet", f"fleet state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    phase_moe()
    gc.collect()
    torch.cuda.empty_cache()
    log("moe", f"moe state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    gemma_rows, gemma_counts = phase_gemma()
    results.update(gemma_rows)
    counts.update(gemma_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("gemma", f"gemma state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    ssm_rows, ssm_counts = phase_ssm()
    results.update(ssm_rows)
    counts.update(ssm_counts)
    gc.collect()
    torch.cuda.empty_cache()
    whisper_rows, whisper_counts = phase_whisper()
    results.update(whisper_rows)
    counts.update(whisper_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("whisper", f"whisper state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    vision_rows, vision_counts = phase_vision()
    results.update(vision_rows)
    counts.update(vision_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("vision", f"vision state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    hybrid_rows, hybrid_counts = phase_hybrid()
    results.update(hybrid_rows)
    counts.update(hybrid_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("hybrid", f"hybrid state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    minicpm_rows, minicpm_counts = phase_minicpm()
    results.update(minicpm_rows)
    counts.update(minicpm_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("minicpm", f"minicpm state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    grok_rows, grok_counts = phase_grok()
    results.update(grok_rows)
    counts.update(grok_counts)
    gc.collect()
    torch.cuda.empty_cache()
    log("grok", f"grok state freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    phase_f32(prompts)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_dist()
    gc.collect()
    torch.cuda.empty_cache()
    cells_rows, counts["cells"] = phase_cells()
    results.update(cells_rows)
    gc.collect()
    torch.cuda.empty_cache()
    hpc_results, hpc_counts = phase_hpc()
    results.update(hpc_results)
    counts["hplmxp_fp8"] = hpc_counts["fp8"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_cli()
    source = "src/repro_torch/kernels/"
    meta = {
        "paged_decode_attention": (
            "cuda", source + "csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:159"),
        "quantized_paged_decode_attention": (
            "cuda", source + "csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:254"),
        "rmsnorm": ("triton", source + "rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:25"),
        "add_rmsnorm": ("triton", source + "rmsnorm.py",
                        "src/repro/kernels/rmsnorm.py:25"),
        "rmsnorm_qk": ("triton", source + "rmsnorm.py",
                       "src/repro/kernels/rmsnorm.py:25"),
        "decode_attention": ("cuda", source + "csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:63"),
        "flash_attention": ("cuda", source + "csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:79"),
        "fp8_matmul": ("cuda", source + "csrc/fp8_matmul.cu",
                       "src/repro/kernels/fp8_matmul.py:42"),
    }
    kernels = []
    # each row's launches come from the serving run that drove it: the
    # paged attention kernels from the run with their pool type, the norm
    # kernels (which every run drives) from the bf16 paged run, the dense
    # decode and flash kernels from the fixed-slot engine run; the
    # windowed ones from phase gemma's runs; the norms at mamba2-130m's
    # widths from phase ssm's Run A; the norms at whisper-base's width,
    # non-causal flash and the dense decode at d 64 (whose launches count
    # under the variant's key, self- and cross-attention together) from
    # phase whisper's Run A; the norms at phi-3-vision-4.2b's width and
    # flash and the dense decode at d 96 (counted under the variant's
    # key) from phase vision's Run A; the norms at jamba-v0.1-52b's widths
    # and flash and the dense decode at group 4 (counted under the
    # variant's key) from phase hybrid's Run A; the paged attention
    # kernels at d 64 and the norms at minicpm-2b's width from phase
    # minicpm's paged Run A with their pool, flash and the dense decode at
    # d 64 with 36 heads from its fixed-slot run; the paged attention
    # kernels at group 6, counted under the pool's key, and the norms at
    # grok-1-314b's width from phase grok's paged Run A with their pool,
    # flash and the dense decode at group 6 from its fixed-slot run
    for key, run, *count_key in (("paged_decode_attention[bf16]", "bf16"),
                     ("quantized_paged_decode_attention[fp8]", "fp8"),
                     ("quantized_paged_decode_attention[int8]", "int8"),
                     ("rmsnorm[D=2048]", "bf16"),
                     ("add_rmsnorm[D=2048]", "bf16"),
                     ("rmsnorm_qk[D=128]", "bf16"),
                     ("decode_attention[bf16]", "fixed"),
                     ("flash_attention[causal]", "fixed"),
                     ("paged_decode_attention[bf16,window]", "gemma_bf16"),
                     ("quantized_paged_decode_attention[fp8,window]",
                      "gemma_fp8"),
                     ("decode_attention[bf16,window]", "gemma_fixed"),
                     ("flash_attention[window]", "gemma_fixed"),
                     ("rmsnorm[D=1536]", "ssm"),
                     ("add_rmsnorm[D=768]", "ssm"),
                     ("rmsnorm[D=512]", "whisper"),
                     ("add_rmsnorm[D=512]", "whisper"),
                     ("flash_attention[full]", "whisper"),
                     ("decode_attention[bf16,d=64]", "whisper",
                      "decode_attention[bf16]"),
                     ("rmsnorm[D=3072]", "vision"),
                     ("add_rmsnorm[D=3072]", "vision"),
                     ("flash_attention[d=96]", "vision",
                      "flash_attention[causal]"),
                     ("decode_attention[d=96]", "vision",
                      "decode_attention[bf16]"),
                     ("rmsnorm[D=4096]", "hybrid"),
                     ("add_rmsnorm[D=4096]", "hybrid"),
                     ("rmsnorm[D=8192]", "hybrid"),
                     ("flash_attention[G=4]", "hybrid",
                      "flash_attention[causal]"),
                     ("decode_attention[G=4]", "hybrid",
                      "decode_attention[bf16]"),
                     ("paged_decode_attention[bf16,d=64]", "minicpm_bf16",
                      "paged_decode_attention[bf16]"),
                     ("quantized_paged_decode_attention[fp8,d=64]",
                      "minicpm_fp8", "quantized_paged_decode_attention[fp8]"),
                     ("quantized_paged_decode_attention[int8,d=64]",
                      "minicpm_int8",
                      "quantized_paged_decode_attention[int8]"),
                     ("rmsnorm[D=2304]", "minicpm_bf16"),
                     ("add_rmsnorm[D=2304]", "minicpm_bf16"),
                     ("flash_attention[d=64,H=36]", "minicpm_fixed",
                      "flash_attention[causal]"),
                     ("decode_attention[d=64,H=36]", "minicpm_fixed",
                      "decode_attention[bf16]"),
                     ("paged_decode_attention[bf16,G=6]", "grok_bf16",
                      "paged_decode_attention[bf16]"),
                     ("quantized_paged_decode_attention[fp8,G=6]",
                      "grok_fp8", "quantized_paged_decode_attention[fp8]"),
                     ("quantized_paged_decode_attention[int8,G=6]",
                      "grok_int8", "quantized_paged_decode_attention[int8]"),
                     ("rmsnorm[D=6144]", "grok_bf16"),
                     ("add_rmsnorm[D=6144]", "grok_bf16"),
                     ("flash_attention[G=6]", "grok_fixed",
                      "flash_attention[causal]"),
                     ("decode_attention[G=6]", "grok_fixed",
                      "decode_attention[bf16]"),
                     ("decode_attention[lse]", "cells",
                      "decode_attention[bf16,lse]"),
                     ("fp8_matmul[e4m3]", "hplmxp_fp8")):
        r = results[key]
        route, src, replaces = meta[r["name"]]
        n = counts[run].get(count_key[0] if count_key else key, 0)
        if n <= 0:
            raise AssertionError(f"{key} never launched on the path")
        kernels.append({"name": key, "route": route, "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library": r["library"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
