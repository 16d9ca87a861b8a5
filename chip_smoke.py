#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, holds every kernel against its plain PyTorch version on
the card, drives ``repro_torch.fleet.run_mega(backend="torch")`` on the
600-device, ~1M-request acceptance day and checks it against the port's
numpy backend, drives the rest of the fleet-accounting stack
(``core.simulator``, ``run_mega_sweep`` and ``plan_fleet``), then serves
all eleven of the reference's archs: Qwen2.5-7B, RecurrentGemma-9B,
gemma3-1b, granite-20b, command-r-35b, internvl2-26b, Mixtral-8x22B (12
of its 56 layers), minicpm3-4b, deepseek-v2-236b (7 of its 60 layers),
whisper-base and xlstm-125m, through ``ServingEngine``,
``repro_torch.launch.serve`` or, for internvl2's prefix embeddings, the
model's ``prefill`` / ``decode_step``, then trains: the kernels'
gradients, ``train_loss``'s at full width, Qwen2.5-7B's widths through
``training.trainer.train`` and the training launcher with resume, runs
the sharded cells (``launch.steps.jit_cell``), the GPipe pipeline and
``remat="dots"``, drives the attention logit softcap and
multi-token steps at a cache offset (chunked prefill through
``decode_step``) through every attention kernel, and last holds the
dry run's trace (``launch.dryrun``) against the sharded cells it
predicts.
Phases, in order:

  1. the card (``nvidia-smi`` name and power limit) and the build time
     (every source's ``nvcc`` started at once, with its ``ptxas``
     register and spill lines per entry function; the float32 attention
     backward, which no phase before 18 launches, compiles on while
     phases 2-17 run and phase 18 waits for it), and the HGMMA (wgmma)
     instructions in the sm90 attention library's SASS where the
     toolkit has ``cuobjdump``;
  2. each metering kernel against its plain version: ``fused_meter`` at
     small and acceptance-day shapes (``e``/``s`` bit-equal, ``c``/``fa``
     within 1e-12 relative); ``segment_trapz`` bit-equal at N in {1, 17,
     2001, tile - 1, tile, tile + 1, 3 tiles + 1, one persistent wave
     +- 1, the acceptance day's N - 1 (odd) and N}, a zero-width entry
     exactly 0, and a view off the 16-byte grid refused;
     ``ordered_segment_sum`` bit-equal at n in {0, 1, 1000, N} with
     uniform keys, with 90 % of the keys on one key, and at 15,000 keys,
     and refused above its key limit; planted faults modelled in plain
     torch (the ring read one tile late; each key's run summed in
     reverse, and as a pairwise tree) must fail those checks, and the
     count each gets wrong is printed.  Then the three public wrappers'
     CUDA-event times at the acceptance day's shapes (per call, median
     of 7 rounds of 20 calls, each round queued behind a spin kernel so
     the events time the card and not the host's launches, rotating
     over input sets of >= 100 MB so no call reads the L2), beside the
     least time the card could take: the larger of the bytes over the
     HBM rate, the FP64-pipe instructions (counted per entry in the
     kernels' SASS) over 132 SMs x 64 a clock at the top clock, and for
     ``ordered_segment_sum`` the longest run times the latency of one
     dependent FP64 add (measured by a one-thread chain);
  3. the acceptance day on the fused lane (the metering path), with the
     launch counters reset just before it and read just after;
  4. the unfused lane on a 24-route day, then the 3-zone pinned day
     (several carbon traces in one fused launch);
  4a. the 1-device anchor: each of the four traffic patterns (seed 7)
     under AlwaysOn, Breakeven and FixedTTL(300) through ``run_mega`` on
     the card, equal to ``core.simulator.simulate`` on the same
     arrivals (energy within 1e-6 Wh, cold starts and requests equal;
     always-on H100 for 24 h 2920.8 Wh);
  4b. the sweep (``benchmarks/bench_fleet.py``'s sweep leg: 24 points
     of 6 routes over 24 h): ``sweep_traces`` on the card, timed, a
     second batch bit-identical, ``sweep_traces([5])`` equal to point 5
     (and a planted fault, route seeds from the batch position, must
     differ), every route's count within 6 sigma of its rate's
     integral; then ``run_mega_sweep``, each point against the numpy
     backend on its trace with phase 3's gate, its wall and
     ``bulk_scan_s`` printed, point 0 replayed to the same bits;
  4c. one sweep point at the acceptance scale (600 routes, ~1M
     arrivals) sampled on the card, timed, resampled bit-identical,
     Poisson-bounded, and replayed on both backends as in phase 3;
  4d. the Pareto planner on the torch backend: the pinned 20-point
     sweep of the 24 h 3-zone day against the numpy planner (every
     field but the engine label equal, carbon and the hypervolume
     within 1e-9, the frontier's labels equal) and the reference's
     three anchors; then ``benchmarks/plan_compare.py``'s 27-point grid
     batched and serial, point for point identical.  In 4a-4d every
     torch-backend simulation launched ``fused_meter`` and
     ``ordered_segment_sum`` once each and nothing else (counts reset
     just before each path and read just after);
  5. the attention kernels against their plain versions (the
     reference's shape sweeps in float32 and bfloat16, tolerance 2e-3 /
     2e-2; rows past ``length`` ignored to 1e-5; the launcher's ragged
     shapes through permuted cache views), each prefill asserting the
     route that took it: bfloat16 at D in {32, 64, 128, 256} the sm90
     kernel (wgmma + TMA), float32 there the f32tc kernel (3xTF32
     mma.sync), other head dims the simt kernel (FP32 FMAs); the f32tc
     kernel against float64 at one kv head's group of the training
     shape ([1, 7, 1, 4096, 128]): its max abs error at most 4x the
     plain float32 version's (TF32 off), and a planted single-pass
     TF32 version (the plain version with TF32 matmuls) must miss that
     bound; then
     the sm90 route at RecurrentGemma's heads (16 over 1, D = 256,
     S = T = 300, window None and 64), at both launchers' 3-token
     prompts against 48 cache rows through views, at a Mixtral
     rank's 3 query heads over 1 kv head (D = 128) with its 4,096-token
     window over S = T = 8,192, and without the causal mask; then the
     split-KV ``decode_attention`` (each call's
     route asserted): the timed Qwen shape with ragged lengths [4096,
     1000, 17, 1] (splits wholly past a row's length), a row of length 0
     (exactly 0, where the plain version gives NaN), RecurrentGemma's
     decode shape at T = 2048, and two calls bit-equal, with unit-normal
     queries and with queries x4, whose peaked softmax lets the check
     see the combine: two wrong combines of the same partials, modelled
     in plain torch, must fail it; then the times,
     each beside the bound (a kernel time under it fails the run), the
     plain version and ``scaled_dot_product_attention`` under every
     backend that takes it (the fastest is the yardstick):
     ``decode_attention`` (the split and the single route on the same
     inputs) at the Qwen shape B=4, T=4096, RecurrentGemma's B=4,
     T=2048, D=256, and both launchers' B=4, T=48 through views, the
     kernel and the library each rotating over input sets of >= 100 MB
     so that no call finds its cache in the 50 MB L2 (the back-to-back
     time of one set beside it); and bf16 ``flash_attention`` (the sm90
     and the simt kernel on the same inputs) at the 2048-token Qwen and
     RecurrentGemma prompts and at both launchers' prefill shapes.  The
     rows of slice 8's archs are timed here too: decode at granite's
     B=4, T=4096 and at the granite and gemma3 launchers' T=48, prefill
     at gemma3's 2048-token prompt under its 512-token window (the
     library's mask a boolean causal band) and at the granite
     launcher's S=3; and whisper's two rows: its encoder prefill
     (B=1, 8 heads, S = T = 1500, D = 64, no causal mask) and its cross
     decode (B=4, 8 heads over 8, T = 1500, split, views);
  6. Qwen2.5-7B's widths at depth 2 in float32, the same weights served
     on the card and on the CPU: logits within 2e-3 of their max
     magnitude, greedy tokens equal; each side's prefill logits beside a
     float64 CPU run; then a bf16 prefill of 300 tokens with the kernels
     and with the plain flash attention swapped in, each against float32
     on the card: the kernel run no farther than 2x the plain one; then
     one bf16 ``decode_step`` at a 2048-row context (the split route):
     each layer's decode against the plain version on the model's views,
     where the two wrong combines must fail, and the logits within 2e-2
     of their max of the same step with the plain ``decode_attention``;
  7. the launcher (the serving path) at full width and depth on the
     card, counters reset just before it and read just after: exactly
     28 ``flash_attention`` launches per prefill, all on the sm90
     route, and 28 ``decode_attention`` launches per decode step, all
     on the single route, and the energy line equal to the
     ``--reduced`` run on the CPU;
  8. a ``torch.profiler`` breakdown of the card's kernel time over three
     served requests at full width, beside their host-clock time;
  9. ``rglru_scan`` against its plain version on both routes, the
     serial and the chunked kernel, at the reference's three shapes,
     the launcher's [1,3,4096] and [4,1,4096] and a 2048-token prompt
     [1,2048,4096] with a channel at a = 0.9999 (the carry's drift), in
     float32 and bfloat16 (tolerance 1e-4 / 3e-2), and a sharded rank's
     256 channels of recurrentgemma-9b's train and prefill cells,
     [16,4096,256] and [2,32768,256], in float32; two chunked calls
     bit-equal, and the carried ``h0``; its times (both routes on the
     same inputs) on the 2048-token prompt, at the launcher's shapes and
     at the rank's; and windowed decode (``decode_attention`` over a view of
     the window's cache rows) against the plain windowed attention at
     RecurrentGemma's heads;
  10. RecurrentGemma-9B's widths at depth 3 (one RG-LRU, RG-LRU, local
      attention superlayer, the window cut to 16) in float32, card
      against CPU, then in bf16 against float32, as phase 6 (its
      300-token prefill's scans on the chunked route);
  11. the RecurrentGemma launcher at full width and depth (38 layers)
      on the card, counted as phase 7: exactly 26 ``rglru_scan`` and 12
      ``flash_attention`` launches per prefill, 26 ``rglru_scan`` and 12
      ``decode_attention`` per decode step, every scan on the serial
      route and every decode on the single one (its profile, as phase
      8, is no longer taken: its time went to phase 24.3's Mixtral
      cells; ``PERF.md`` keeps the last one);
  12. both attention kernels at the new archs' shapes, bf16 and
      float32 against their plain versions (tolerances of phase 5), each
      call's route asserted: prefill at granite's 48 query heads over 1
      kv head (S = T = 300 and the launcher's 3 tokens against 48 rows),
      gemma3's 4 over 1 at D = 256 (S = T = 600 with its 512 window and
      without, and the launcher's shape), command-r's 64 over 8 and
      internvl2's / Mixtral's 48 over 8 at S = T = 272; decode at
      granite's G = 48 and gemma3's G = 4, D = 256, at T = 48 (one
      split, through views) and T = 4096 (split, and the single route on
      the same inputs by a raw call), command-r's 64 over 8 and
      Mixtral's 48 over 8 at T = 48 (single, views), internvl2's B = 4,
      48 over 8 at its 280-row cache with lengths 273-280 (split,
      views); with queries x4 the two planted wrong combines must fail
      on every split case; its wall;
  13. the new archs at full width, cut in depth, float32
      (``check_depth``): the card serves a prompt and 8 greedy decode
      steps, every attention kernel call held against float64 attention
      on the model's own inputs (within 2e-3 of the output's max; the
      kernel's and the float32 plain version's worst printed); the CPU
      in float32 and a float64 run (float64 attention) replay the card's
      tokens; the card's logits within 2e-3 of float64's, each side's
      greedy token float64's wherever float64's top-two gap exceeds
      twice that side's distance, and phase 6's gate: card within 2e-3
      of the CPU, greedy tokens equal:
      granite at depth 2; gemma3 at depth 6 (one 5-local + 1-global
      superlayer) on a 600-token prompt, past the 512 window in prefill
      and decode, twice as whisper and xlstm in phase 16 (at the
      reference's init, chaotic in float32 -- two float64 runs, CPU and
      card, differ by 0.2 of the max -- each kernel call held and the
      logits printed ungated; at the d_model fan-in law every gate);
      Mixtral at depth 1 on a 48-token prompt (capacity 15:
      the prefill's drops printed, decode drops none), onehot dispatch;
      internvl2 at depth 2 at the model level with 256 prefix
      embeddings from a seed; command-r at depth 2 (about 23 GB of
      float32 on the host) where the host has the memory, else the
      reason is printed; its wall;
  14. the new archs at full width in bf16, counted as phase 7: the
      gemma3-1b, granite-20b and command-r-35b launchers at full depth,
      ``--hours 2`` (26, 52 and 40 launches of each kernel a call; every
      prefill sm90,
      every decode single; energy lines equal to the ``--reduced`` CPU
      runs; ``max_memory_allocated`` printed; the profiles of phase 14's
      and 17's archs are PERF.md's serving table's);
      internvl2-26b at full depth at the model level (B = 4, 256 prefix
      embeddings + 16 tokens, 8 decode steps, 48 launches a call);
      Mixtral-8x22B at 12 of its 56 layers through ``ServingEngine``
      with the launcher's settings on the launcher's 5 requests (12
      launches a call, drops of one request printed); the card's cache
      emptied between runs; its wall;
  15. both attention kernels at whisper-base's shapes (one query head a
      kv head, D = 64), bf16 and float32, as phase 12, routes asserted:
      the encoder's non-causal prefill at S = T = 1500, the cross
      prefill of 3 tokens against the 1500 rows and the causal self
      prefill against 48 rows (both through views), a self prefill at
      S = T = 300; the cross decode of 4 slots over 1500 rows (split,
      views; the planted combines must fail) and the self decode over
      48 rows (single, views); its wall (the cross prefill at a
      sharded rank's shape, 2 rows' 32,768 queries against the 1,500
      frames, runs with phase 5's sm90 cases);
  16. the new archs at full width in float32, cut in depth where they
      are big, as phase 13 (each kernel call against float64 attention,
      the calls exactly those of the config: none for MLA and xLSTM;
      logits within 2e-3 of the CPU's and of float64's, greedy tokens
      equal): whisper-base at full depth at the model level against
      1500 source frames from a seed, xlstm-125m at full depth,
      minicpm3-4b at depth 2, deepseek-v2 at depth 1 (its drops
      printed) where the host has the memory, else the reason is
      printed; its wall;
  17. the new archs at full width in bf16, counted as phase 7: the
      minicpm3-4b (62 layers)
      and xlstm-125m (12) launchers at ``--hours 2`` (5 requests;
      energy lines equal to the ``--reduced`` CPU runs; no kernel
      launch at all: MLA and xLSTM are plain PyTorch); whisper-base
      through ``ServingEngine``
      with the launcher's settings on 24 of its requests, 1500 frames
      from a seed as each ``admit``'s extras (the launcher itself raises
      ``KeyError('source_embeds')``, as the reference's): exactly 18
      ``flash_attention`` launches a prefill (6 encoder, 6 self, 6
      cross; all sm90) and 12 ``decode_attention`` a step (6 single, 6
      split); deepseek-v2 at 7 of its 60 layers (~57.7 GB) through
      ``ServingEngine`` on 24 requests, no launch, drops printed; its
      wall;
  18. (after waiting for the float32 attention backward's build) the
      kernels' gradients (``ops``' autograd functions: in float32
      the f32tc forward and its backward kernel, in bf16 the sm90
      forward with the plain version's recomputed gradient, the scan
      kernel in both passes) against ``torch.autograd`` through the
      plain versions on the card, within the forward contracts' 2e-3 /
      2e-2 (flash, float32 / bf16) and 1e-4 (scan) of each gradient's
      max: flash at Qwen2.5-7B's training shape (B = 1, 28 over 4 heads,
      S = T = 4,096, D = 128), RecurrentGemma's local attention past its
      2,048 window and whisper's non-causal 1,500-frame encoder, in
      float32 and bf16, each call's route asserted and in float32 one
      backward kernel launch; in float32 the backward kernel on its own
      against ``ref.flash_attention_bwd_ref`` on the same inputs, and a
      second gradient bit-equal to the first; both f32tc kernels on
      their own at 11 small shapes (every head dim, causal / windowed /
      non-causal, GQA groups of 1-16, ragged S != T, [B, S, heads, D]
      views): out, lse and dq / dk / dv within 2e-3 of their plain
      versions', two backward calls bit-equal; the backward against
      float64 at one kv head's group of the training shape ([1, 7, 1,
      4096, 128]): each gradient's error at most 4x the plain float32
      version's; the scan at [1, 4096,
      4096] (chunked) and [2, 40, 4096] (serial) with h0 nonzero, two
      launches (forward and backward) on the route S picks; planted
      faults modelled in plain torch must fail the same checks (the bare
      kernel with no autograd; the float32 backward with Delta dropped,
      and with dK / dV of one query head of the group where the group
      has more than one; the scan's backward without the one-step shift
      of ``a``);
  19. ``train_loss``'s gradients at full width in float32 (Qwen2.5-7B at
      1 layer; RecurrentGemma-9B's pattern once plus its tail, 5 layers;
      B = 1, S = 256) with the kernels against the same call with the
      plain versions patched into ``ops``: every kernel call (f32tc
      forward and backward, the scan forward and adjoint) held against
      its plain version on its own inputs, every leaf within 2e-3 of its
      max, none zero where the plain run's is not (RecurrentGemma twice:
      at the reference's init, where its float32 gradients are
      ill-conditioned, the leaves' distance printed ungated; with its
      attention projections at the d_model fan-in law, every gate), and
      exactly 2 flash
      launches an attention layer (forward and remat recompute, both
      f32tc) and one of its backward kernel, and 3 scan launches an
      RG-LRU layer (and the backward) with the kernels, none with the
      plain versions;
  20. ``training.trainer.train`` on Qwen2.5-7B at full width, 4 of its
      28 layers, float32 without TF32, S = 4,096 (the reference's
      ``train_4k`` length), at the largest batch that fits (the run
      itself probes it, from one row above TRAIN_BATCH; a run at one more
      row must run out of memory within two steps), 8 steps with a 2-step
      warmup: the loss each step (the mean of the last 3 below the mean
      of the first 3), ms a step, tokens a second, peak memory, exactly 8
      flash launches a step, all f32tc, and 4 of its backward kernel
      (counters reset just before each step and read just after), the
      card's idle share of the last step under ``torch.profiler``; the
      same for 4 steps at COMPARE_BATCH = 4 rows (phase 20's batch while
      the backward recomputed the plain version); both f32tc kernels at
      that run's own shape ([rows, 28, 4096, 128], through views) against
      their plain versions run a batch row at a time (2e-3); then at
      TRAIN_SHAPE
      [4, 28, 4096, 128] the f32tc forward and its backward kernel
      against their plain versions (2e-3) and their bounds, beside the
      simt kernel's forward and the plain recompute's backward on the
      same inputs, and the scan's kernel backward at [1, 4096, 4096]
      (CUDA events);
  21. the training launcher (``repro_torch.launch.train``'s ``main`` in
      this process) at the reduced Qwen config on the card: 10 steps, and
      5 then 5 resumed from the checkpoint, final losses within rtol
      1e-5 (bit-equality printed), and 10 steps with ``--grad-accum 2
      --grad-compression``;
  22. the sharded cells, the pipeline and ``remat="dots"`` on the card,
      on a (1, 1) ("data", "model") ``DeviceMesh`` over NCCL at world
      size 1 (a ``FileStore`` under ``build/``, no network; one
      all-reduce first): ``jit_cell``'s train cell (TRAIN_RULES) on
      Qwen2.5-7B at full width, 2 of its 28 layers, float32 without TF32,
      2 x 4,096 tokens, ``remat="full"``, two steps beside
      ``make_train_step``'s two on the same state made again from the
      same seed (loss, grad norm and every parameter leaf within 1e-6 of
      its max, bit-equality printed; exactly 4 f32tc flash launches and
      2 of its backward kernel a step; ms a step and
      ``max_memory_allocated``); the prefill (2 x
      2,048 tokens) and decode (at position 2,048 of 4,096 cache rows
      whose first 2,048 hold seeded values) cells (SERVE rules) in bf16
      against ``make_prefill_step`` / ``make_decode_step`` (logits within
      1e-6, equality printed; exactly 2 sm90 flash launches and 2 decode
      launches on the route the split plan names); the GPipe loss at one
      stage on a ("pod",) mesh, 2 microbatches, ``remat="none"``, B = 2,
      S = 1,024 (within rel 1e-4 of ``train_loss``, every gradient leaf
      within 2e-3 of its max, exactly 4 flash launches in the forward);
      ``remat="dots"`` against ``"full"`` at phase 19's cuts (every leaf
      within 2e-3, the launches of each: the kernels are recomputed under
      both), then Qwen at 4 layers x 2 x 4,096 tokens under both, 3
      steps each, ms a step and peak memory; planted faults modelled in
      plain torch must fail their checks (two data ranks' gradients
      summed, not averaged; a pipeline that drops its last microbatch;
      every layer recomputed with the last layer's closure under
      "dots"); and at the float32 training shape [4, 28, 4096, 128]
      ``scaled_dot_product_attention`` under each backend that takes
      float32, forward and forward + backward, and the efficient
      backend's backward on its own
      (``aten._scaled_dot_product_efficient_attention_backward``, its
      gradients held against the backward kernel's), beside the f32tc
      kernels;
      one JSON line for the phase;
  23. the logit softcap and the query offset (``--cap-offset`` runs
      phases 1 and 23 alone): (a) every attention kernel against its
      plain version with a cap of 5 on unit-normal inputs and Gemma 2's
      50 with the queries x8 (tolerance 2e-3 / 2e-2, each route
      asserted): sm90 and f32tc at Qwen's heads (1,024 queries at
      q_offset 3,072 against 4,096 rows, and the first chunk) and
      gemma3's (384 queries under its 512 window at the offset whose rows
      straddle the window's edge, and the first chunk), simt in float32
      at D = 96, decode's split and single routes at Qwen's B = 4,
      T = 4,096 and gemma3's G = 4, D = 256 (bf16 and float32); planted
      faults in plain torch (the cap dropped, the cap after the mask,
      the offset ignored) must each miss under one cap or the other; the
      f32tc forward and backward with the cap against float64 at [1, 7,
      1, 4096, 128] (4x plain float32's error, two backward calls
      bit-equal) and the backward against its plain version at Qwen's
      and gemma3's training shapes, where the backward without the cap's
      derivative must miss; CUDA-event times with the cap off and on;
      (b) Qwen2.5-7B at full width and depth in bf16: a 4,096-token
      prompt prefilled at once and as a 1,024-token prefill plus three
      1,024-token ``decode_step``s, then 8 one-token steps from each
      cache (last logits within 2e-2, greedy tokens equal where the
      top-two gap exceeds twice the distance; exactly 28 sm90 flash
      launches and no decode launch a chunk, 28 decode launches a step);
      (c) gemma3-1b at full width: a 1,536-token prompt in chunks of 384
      against one-shot, then with ``attn_logit_softcap`` 50 in bf16
      against float32 (kernels no farther than 2x the plain attention),
      then cut to 6 layers in float32 at the d_model fan-in law with
      every kernel call held against float64 capped attention; (d)
      capped ``train_loss`` gradients at gemma3-1b's width, 6 layers,
      S = 1,024, against the plain versions (2e-3; 2 f32tc forward and 1
      backward launch a layer); (e) whisper-base's 3-token step at
      offset 48 (causal flash at q_offset 48, non-causal cross flash
      over 1,500 rows) against the plain versions; its wall;
  24. the dry run (``launch/dryrun``; ``--train`` runs it after phase 22):
      phase 22's three cells (Qwen2.5-7B at full width, 2 layers: the
      train cell in float32, 2 x 4,096 tokens; prefill 2 x 2,048 and
      decode at 2,048 of 4,096 cache rows in bf16) traced on a fake
      process group at world size 1, on fake tensors through the
      kernels' fake branch, then each run for real on a (1, 1) NCCL mesh
      under ``FlopCounterMode`` after ``reset_peak_memory_stats()``: the
      aten FLOPs equal, the predicted kernel launches and routes equal to
      the counters' (4 f32tc forwards and 2 backward kernels a train
      step, 2 sm90 prefills, 2 decodes on the plan's route), the
      predicted peak within 5 % of ``max_memory_allocated`` above what
      the card held before the inputs; a trace through the plain
      attention (the CPU's program, [B, H, S, T] scores) must miss that
      gate on the prefill cell (its gap on the other two printed: the
      train step's peak is its logits'); then granite-20b x
      decode_32k traced on the fake (16, 16) mesh at world size 256
      (its report printed; the sharded serving layout, one split decode
      a layer over rank 0's 2,048-row cache block); then granite-20b
      x train_4k on the (16, 16) mesh in the sharded layout, full width
      and depth, bf16: traced, and its step run for real on the card as
      rank 0 of a fake group of 256 (rank 0's blocks of the state drawn
      at their local shapes, 16 rows x 256 tokens; the collectives
      return nothing, so no value is checked): the traced peak within 5
      % of ``max_memory_allocated``, launches (2 sm90 a layer) and
      routes equal, the step's wall printed; on the cell cut to 24
      layers a trace that keeps every layer's gathered weights to the
      end of the step must miss that cut's correct trace by more than
      10 %; then granite-20b x decode_32k (at its last row: rank
      0 reads its whole block) and x prefill_32k in the sharded serving
      layout the same way (rank 0's weights and cache blocks; one split
      decode / one sm90 flash a layer), the faults that must miss being
      a decode writing its cache out of place and restacking it, and a
      prefill keeping the whole length as cache rows; then
      mixtral-8x22b x train_4k, prefill_32k and decode_32k (at row
      4,095: rank 0 reads its whole block under the 4,096 window) at 4
      of its 56 layers, full width, bf16, in the sharded layout the same
      way (the serving cells under SERVE_BIG_RULES, as the full depth
      takes them; the MoE FFN's ffn split over "model"; 2 / 1 sm90
      flash and 1 split decode a layer), the fault that must miss
      being the experts' weights gathered whole over "model"; then the
      long_500k cells in the sharded layout the same way (one row, the
      cache's 524,288 rows over all 256 ranks, 2,048 a rank; the token
      at row 2,047, so rank 0 writes it into its own block and reads all
      of its visible rows): gemma3-1b at full width and depth under
      LONG_SERVE_RULES, mixtral-8x22b at 4 of 56 layers under the full
      depth's LONG_SERVE_BIG_RULES and recurrentgemma-9b at 3 of 38 under
      LONG_SERVE_RULES, one decode an attention layer on the route the
      plan gives its visible rows and one serial scan an RG-LRU layer,
      the fault that must miss being
      the cache's length split over "model" alone (16 times the block);
      then deepseek-v2-236b x train_4k, prefill_32k and decode_32k (at
      row 2,047: rank 0 reads its whole latent block) at 2 of its 60
      layers, full width, bf16, in the sharded layout the same way (MLA's
      heads, the latent cache's length, the routed experts and the
      shared experts' ffn over "model"; the serving cells under
      SERVE_BIG_RULES; the train cell at one microbatch): MLA and the
      MoE FFN are plain PyTorch, so no kernel launches, traced and real;
      the faults that must miss being the MLA scores made whole (train,
      prefill) and the latent cache held whole on every model rank
      (decode); then minicpm3-4b x train_4k, prefill_32k and decode_32k
      (at row 2,047) at 2 of its 62 layers, full width, bf16, under
      SERVE_RULES, the same way (all 40 MLA heads on every rank, in
      train the queries of the rank's 256 rows against every row's
      gathered latents; 400 of the ffn's 6,400 columns; in serving the
      heads' dims over "model", gathered whole a layer; no kernel
      launches), each peak within 0.5 % of its trace, the faults that
      must miss being every head's queries run on all 4,096 rows
      (train), the MLA scores made whole (prefill) and the latent cache
      held whole on every model rank (decode); then internvl2-26b x
      train_4k, prefill_32k and decode_32k (at row 2,047) at 2 of its 48
      layers, full width, bf16, in the sharded layout the same way (3 of the 48 query heads over
      one K/V head a rank; the train residual 272 of the 4,352 rows of
      [256 prefix rows; 4,096 tokens], re-blocked by an all-to-all each
      way in and out; the prefill cache 2,064 of its 33,024 rows; 2 / 1
      sm90 flash and 1 split decode a layer), each peak within 0.5 % of
      its trace, the faults that must miss being the residual gathered
      whole with the loss over every token (train), the whole length
      kept as cache rows (prefill) and the decode's out-of-place writes;
      then recurrentgemma-9b x train_4k, prefill_32k and decode_32k (at
      row 2,047) at 3 of its 38 layers (one RG-LRU, RG-LRU, local
      attention superlayer), full width, bf16, in the sharded layout the
      same way (256 of the RG-LRU's 4,096 channels and of its state a
      rank, each gate's partial sums reduce-scattered by channel; 1 of
      the 16 query heads over the one K/V head), the launches counted
      per mixer (attention 2 / 1 sm90 flash and 1 split decode a layer,
      RG-LRU 3 / 1 / 1 scans a layer, chunked in train and prefill), the
      faults that must miss being the RG-LRU weights gathered whole
      (train), the "ffn" axis split over nothing (prefill) and the
      decode's cache and state written out of place, and its long_500k
      cell at 3 layers with the long cells; then whisper-base x
      train_4k, prefill_32k and decode_32k (at row 2,047) at full depth
      (6 encoder and 6 decoder layers), full width, bf16, in the sharded
      layout the same way (every head and all 1,500 frames of the
      rank's rows on every rank, 128 of the ffn's 2,048 columns, the
      cross cache 4 of the 64 head dims, gathered whole a layer at a
      decode step; 2 / 1 sm90 flash an encoder layer and a decoder
      layer's self- and cross-attention, 2 split decodes a decoder
      layer), each peak within 0.5 % of its trace, the faults that must
      miss being the encoder run on every row of the batch (train), the
      whole length kept as self cache rows (prefill) and the decode's
      out-of-place writes; then the decode
      wrapper (with the fake branch's tests) beside its raw kernel on
      the same rotated inputs at Qwen's B = 4, T = 4,096, and its host
      time a call; one JSON line for the phase;
  25. ``decode_attention``'s log-sum-exp output (``lse=True``): against
      ``ref.decode_attention_lse_ref`` at granite-20b's, gemma3-1b's
      and mixtral-8x22b's rank-0 cache blocks (split; gemma3-1b's and
      mixtral-8x22b's at B = 1 too, their long_500k blocks) and a
      launcher's 48 rows (single), in
      bf16 and float32, cap off and on (outputs within 2e-3 / 2e-2,
      log-sum-exps within 1e-4 relative, the output bit-equal to the
      call without it); its merge over 2 and 4 length blocks of
      granite's block (a block of length 0, a window across two
      blocks) against one call over the visible rows, the planted wrong
      merges of ``ref.decode_merge_faults`` missing; the kernel timed
      with and without it at Qwen's B = 4, T = 4,096;
  26. one JSON line describing every kernel (the metering rows: the
      input sets, FP64 instructions an entry or the longest run and the
      dependent-add latency; the flash row: the sm90
      kernel's time, the simt kernel's beside it, every timed prefill
      shape and the launches of each serving run; the f32tc forward and
      backward rows (``flash_attention_f32``, ``flash_attention_bwd``):
      their times at the training shape, both bounds (3xTF32 and the
      FP32 pipe), the simt forward's and the plain recompute's times,
      the library's, their gradient and float64 errors and their
      launches in phase 20's run, a train step and phase 22; the decode
      row: the single route's time beside the split route's, the
      back-to-back time, every timed shape and the launches of each
      serving run; the scan row: the serial route's time beside the
      chunked one's, and
      every timed shape; the metering rows also carry their launches
      on the paths of 4a-4d, ``stack_launches``; the scan row also its
      gradient error, backward time and launches a train step; the
      attention and scan rows their launches in phase 22,
      ``distributed_launches``; the attention rows phase 23's times with
      the cap off and on, ``softcap_ms``, its worst errors and the
      launches of a chunk and a step of Qwen's chunked prefill; the
      attention rows phase 24's launches a cell, ``dryrun_launches``,
      the flash row also the sharded train and prefill cells' rank-0
      steps' (granite-20b's, mixtral-8x22b's, internvl2-26b's,
      recurrentgemma-9b's and whisper-base's, and the MLA archs'
      deepseek-v2-236b and minicpm3-4b, which launch none), the decode
      row the sharded decode cells' (the MLA archs' none) and long_500k
      cells' and phase 25's figures, ``lse``);
  27. as the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and never prints
the last line.  The whole must finish within 1000 s of the runner's
1200 s limit.  It took 777.7 s on an H100 80GB HBM3 at 700 W, where the
phases took: 1 (the build) 15 s, the float32 attention backward's 55 s
of ``nvcc`` running on behind phases 2-17; 2-11 325 s (the acceptance
day and the acceptance-scale sweep point on both backends, the kernel
checks, the Qwen and RecurrentGemma launchers); 12-17 156 s; 18-21 81
s; 22 24 s; 23 21 s; 24 155 s, mostly phase 24.3's traces (granite-20b's
52-layer train cell 24 s traced and 6 s run, its fault two 24-layer
traces 22 s, its serving cells about 20 s; each other model's cells and
the three long_500k cells 2-25 s); 25 1 s.  A host seen earlier ran the
host-bound phases 1.3-1.6 times as long (992.0 s with the backward's
build in phase 1 and recurrentgemma-9b's cells not yet run), so phases
14 and 17 profile none of their runs and phase 11 none, and phase 24.3
prints recurrentgemma-9b's cells' wall beside what the 24-layer fault
traces (against a 52-layer one) and the late build save, and
whisper-base's three cells' wall.  With those cells (31.8 s, two
11-second traces of the train cell) the whole took 954.3 s on a host
that traced granite-20b's 52 layers in 30.7 s (24.3 s above).  With
minicpm3-4b's three cells (17.4 s), phase 20's batch probed by its main
run (12.8 s less) and the depth checks' float64 weights cast on the
card (phases 13 and 16 45.5 s and 27.0 s), it took 808.3 s on a host
that traced those 52 layers in 24.8 s.
It also exits non-zero without a CUDA device.
``python3 chip_smoke.py --metering`` stops after phase 4d and
prints the metering kernels' figures and the stack's walls and launches
as two JSON lines instead of the last two;
``python3 chip_smoke.py --train`` runs phase 1 and phases 18-22 and 24
alone and prints their results as one JSON line instead of the last
three;
``python3 chip_smoke.py --cap-offset`` runs phases 1 and 23 alone, the
same way.
"""
import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_METER = 790_603          # charge-log entries of the acceptance day
N_SEG = 790_002            # metered power segments of the acceptance day
N_DEV = 600
REL_KERNEL = 1e-12         # carbon lanes vs their plain versions
REL_DAY = 1e-9             # torch backend vs numpy backend totals
DEV = "cuda"

# NVIDIA H100 data sheet: memory bandwidth, FP64 and FP32 (non-tensor)
# peaks and dense BF16 and TF32 tensor-core peaks (TF32 half of BF16) per
# form factor, matched against torch.cuda.get_device_name().
_PEAKS = (("PCIe", 2.0e12, 26e12, 51e12, 756e12, 378e12),
          ("NVL", 3.9e12, 30e12, 60e12, 835e12, 417.5e12),
          ("", 3.35e12, 34e12, 67e12, 989e12, 494.5e12))


def _peaks(name):
    for key, bw, fp64, fp32, bf16, tf32 in _PEAKS:
        if key in name:
            return bw, {"fp64": fp64, "fp32": fp32, "bf16": bf16,
                        "tf32": tf32}
    raise AssertionError("unreachable")


def _bound_ms(name, nbytes, flops, kind="fp64"):
    bw, peak = _peaks(name)
    t_bytes, t_ops = nbytes / bw, flops / peak[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def _busy_card(torch):
    """Keep the card busy for about 2.5 ms (a spin kernel) while the host
    enqueues the calls of a timed round: the events around the round
    then time the card's work, not the rate at which the host launches
    (a wrapper or a ctypes call costs the host microseconds, as much as
    a small kernel takes the card)."""
    torch.cuda._sleep(5_000_000)


def _time_ms(fn, torch, reps=20, rounds=7):
    """Per-call CUDA-event time of ``fn``: back-to-back calls, the L2
    flushed before each round (``_time_rot`` over one function)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEV)
    return _time_rot([fn], torch, reps, rounds, flush=flush)


def _time_rot(fns, torch, reps=20, rounds=7, flush=None):
    """Per-call CUDA-event time of calls that take ``fns`` in turn (each
    on its own input set where there are several: together >=
    ROTATE_BYTES, so no call finds its inputs in the L2 the calls before
    it left): events around ``reps`` calls queued behind ``_busy_card``,
    ``flush`` (if given) zeroed before each round, median over
    ``rounds`` after a warm-up pass over all."""
    for fn in fns:
        fn()
    times, i = [], 0
    for _ in range(rounds):
        if flush is not None:
            flush.zero_()
        _busy_card(torch)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fns[i % len(fns)]()
            i += 1
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def _rel_close(x, y, rel):
    """|x - y| <= rel * |y| elementwise; returns the max abs error."""
    import torch
    err = (x - y).abs()
    if not bool(torch.all(err <= rel * y.abs())):
        bad = int(torch.argmax(err / y.abs().clamp_min(1e-300)))
        raise AssertionError(f"mismatch beyond {rel} rel at {bad}: "
                             f"{float(x[bad])!r} vs {float(y[bad])!r}")
    return float(err.max()) if err.numel() else 0.0


# the sources no phase before 18 launches: they compile while phases 2-17
# run, and phase 18 waits for them (``finish_build``); every other source
# is waited for in phase 1
LATE_BUILDS = ("flash_attention_f32_bwd",)
# phase 1's wall, and when the late builds ended (``finish_build``)
BUILD_WALLS = {}


def _ptxas(names):
    from repro_torch.kernels import _build
    for name in names:
        log = _build.lib_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "entry")):
                print(f"  ptxas {name}: {line.strip()}")


def build():
    """Start every source's ``nvcc`` at once and wait for all but
    LATE_BUILDS; returns the wall waited."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.start_all()
    names = [n for n in _build.SOURCES if n not in LATE_BUILDS]
    secs = {n: _build.finish(n) for n in names}
    wall = BUILD_WALLS["phase1_s"] = time.perf_counter() - t0
    print(f"build: {wall:.3f} s wall "
          f"({', '.join(f'{k}.cu {v:.3f} s' for k, v in secs.items())}); "
          f"{', '.join(f'{k}.cu' for k in LATE_BUILDS)} compiling on "
          f"while phases 2-17 run")
    _ptxas(names)
    return wall


def finish_build():
    """Wait for LATE_BUILDS (phase 18 launches them): the wall this
    waited, and when each one's compiler ended, in seconds since the
    builds started (phase 1 would have waited that long for it)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = {n: _build.finish(n) for n in LATE_BUILDS}
    waited = time.perf_counter() - t0
    BUILD_WALLS.update(late_ended_s=max(secs.values()), late_waited_s=waited)
    print(f"late build: "
          f"{', '.join(f'{k}.cu ended {v:.3f} s after the build began' for k, v in secs.items())}"
          f"; phase 18 waited {waited:.3f} s for it")
    _ptxas(LATE_BUILDS)
    return {"waited_s": waited, "ended_s": secs}


def _tables(traces, torch):
    import numpy as np
    kmax = max(len(t._kt) for t in traces)

    def pad(rows):
        return np.stack([np.concatenate([r, np.full(kmax - len(r), r[-1])])
                         for r in rows])

    tabs = (pad([t._kt for t in traces]), pad([t._kv for t in traces]),
            pad([t._cum for t in traces]),
            np.array([t.period_s for t in traces]))
    return [torch.from_numpy(x).to(DEV) for x in tabs]


def _entries(n, seed, G, torch):
    import numpy as np
    rng = np.random.default_rng(seed)
    a = np.sort(rng.uniform(0.0, 1.2 * 86400.0, n))
    b = a + rng.exponential(110.0, n)
    if n:
        b[n // 2] = a[n // 2]                       # a zero-width entry
    w = rng.uniform(60.0, 700.0, n)
    g = rng.integers(0, G, n).astype(np.int32)
    return [torch.from_numpy(x).to(DEV) for x in (a, b, b - a, w, g)]


def _sort_inputs(n, num, seed, torch, hot=None):
    """vals [2, n] and keys [n] int64 uniform over [0, num) (or, with
    ``hot``, 90 % of them on key ``hot``: a flash crowd on one device)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num, n)
    if hot is not None:
        keys[rng.random(n) < 0.9] = hot
    vals = rng.uniform(0.0, 5e5, (2, n))
    return torch.from_numpy(vals).to(DEV), torch.from_numpy(keys).to(DEV)


def metering_sets(torch):
    """The three metering wrappers' timed inputs at the acceptance day's
    shapes, each a list of input sets that together hold at least
    ROTATE_BYTES (so no call finds its inputs in the L2).  Returns
    {name: (calls, bytes one call must move, the first set, extra)}:
    ``calls`` are thunks of the public wrappers of the ``repro_torch``
    on the path; ``extra`` is the knot tables, or for
    ``ordered_segment_sum`` thunks of ``index_add_`` on the same sets."""
    from repro_torch.fleet import make_trace
    from repro_torch.kernels import segment_trapz as cu

    tr = make_trace("solar-duck", 0.39)
    tabs = _tables([tr], torch)
    K = tabs[0].shape[1]
    one = (4 * 8 + 4) * N_METER + 4 * 8 * N_METER + (3 * K + 1) * 8
    fm = [_entries(N_METER, 1000 + j, 1, torch) for j in range(_sets(one))]
    fm_calls = [lambda s=s: cu.fused_meter(*s, *tabs) for s in fm]
    kt, kv, cum = tabs[0][0], tabs[1][0], tabs[2][0]
    one_s = 4 * 8 * N_SEG + 3 * K * 8
    st = [_entries(N_SEG, 2000 + j, 1, torch) for j in range(_sets(one_s))]
    st_calls = [lambda s=s: cu.segment_trapz(s[0], s[1], s[3], kt, kv, cum,
                                             period=tr.period_s)
                for s in st]
    num = N_DEV * 3
    one_o = 3 * 8 * N_METER + 2 * num * 8
    os_ = [_sort_inputs(N_METER, num, 3000 + j, torch)
           for j in range(_sets(one_o))]
    os_calls = [lambda s=s: cu.ordered_segment_sum(*s, num) for s in os_]
    lib = [lambda s=s: torch.zeros(2, num, dtype=torch.float64, device=DEV)
           .index_add_(1, s[1], s[0]) for s in os_]
    return {"fused_meter": (fm_calls, one, fm[0], tabs),
            "segment_trapz": (st_calls, one_s, st[0], (kt, kv, cum, tr)),
            "ordered_segment_sum": (os_calls, one_o, os_[0], lib)}


def time_metering(torch, sets=None):
    """Rotated, spin-queued CUDA-event time of each metering wrapper
    (``_time_rot`` over ``metering_sets``).  Returns {name: ms}."""
    sets = sets or metering_sets(torch)
    return {k: _time_rot(v[0], torch) for k, v in sets.items()}


# FP64-pipe opcodes counted in a kernel's SASS (an H100 SM issues 64 a
# clock: the data sheet's 34 TFLOP/s FP64 / 2 / 132 SMs / 1.98 GHz)
_FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET", "FRND",
             "MUFU.RCP64H", "MUFU.RSQ64H", "F2F", "F2I", "I2F")


def _sass_functions(lib):
    """{mangled name: [SASS lines]} of a built library (``cuobjdump``
    beside ``nvcc``)."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    assert tool.exists(), "cuobjdump not found beside nvcc"
    sass = subprocess.run([str(tool), "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def _fp64_ops(lines):
    """FP64-pipe instructions of one function's SASS by opcode, leaving
    out the subroutines it CALLs (the divide's rarely taken slow path).
    F2F, F2I and I2F count only with an F64 operand type."""
    import re
    text = "\n".join(lines)
    called = set(re.findall(r"CALL\.REL[.A-Z]*\s+`\((\.L_x_\d+)\)", text))
    counts, skip = {}, False
    for line in lines:
        label = line.strip().rstrip(":")
        if line.strip().endswith(":") and label in called:
            skip = True
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(1)
        if not skip:
            for k in _FP64_OPS:
                if op == k or op.startswith(k + "."):
                    if k in ("F2F", "F2I", "I2F") and "F64" not in op:
                        break
                    counts[k] = counts.get(k, 0) + 1
                    break
        elif op.startswith("RET"):
            skip = False
    return counts


def fp64_per_entry(kernel, K):
    """FP64-pipe instructions a metering kernel issues per entry, read
    from its SASS (its instantiation for K knots; a loop's body, as
    fused_meter's bisect, counts once, so the count is a lower one, and
    the bound it gives still a least time): every entry does four
    IEEE divides, each one MUFU.RCP64H on its fast path, so the code
    holds the body of round(RCP64H / 4) entries (one in fused_meter's
    loop, four in segment_trapz's tile), whatever the compiler unrolled.
    The function's SASS is written to ``chiprun_out/<kernel>.sass``.
    Returns (per entry, {opcode: count over the code})."""
    steps = max(1, (K - 1).bit_length())
    funcs = _sass_functions("segment_trapz")
    (name,) = [f for f in funcs if f"{kernel}ILi{steps}E" in f] or \
        [f for f in funcs if f"{kernel}E" in f]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{kernel}.sass").write_text("\n".join(funcs[name]))
    ops = _fp64_ops(funcs[name])
    entries = round(ops.get("MUFU.RCP64H", 0) / 4)
    assert entries >= 1, (name, ops)
    return sum(ops.values()) / entries, ops


def _clock_hz():
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``): the
    FP64 term of a bound at this clock is the least time."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.split()[0]) * 1e6


def _bound_terms(terms):
    """The largest of ``terms`` ({term: ms}) and its name."""
    by = max(terms, key=terms.get)
    return terms[by], by


def dadd_latency_ms(torch, steps=1 << 20):
    """The latency of one dependent FP64 add on the card: one thread
    adding ``steps`` times (``dadd_chain_f64``), CUDA events around it."""
    from repro_torch.kernels import segment_trapz as cu
    out = torch.empty(1, dtype=torch.float64, device=DEV)
    fn = cu._fn("dadd_chain_f64")
    stream = torch.cuda.current_stream().cuda_stream
    for n in (1024, steps):                 # a warm-up, then the timed run
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        assert fn(1.0, n, out.data_ptr(), stream) == 0
        stop.record()
    stop.synchronize()
    assert float(out) == float(steps)
    return start.elapsed_time(stop) / steps


def _sees(got, want, faults, label, axis=None):
    """A check that must be able to fail: ``got`` equals ``want`` bit
    for bit and each planted fault does not.  Returns {fault: how many
    entries (``axis=None``) or keys (``axis=0``: columns) it gets
    wrong}."""
    import torch
    assert torch.equal(got, want), f"{label}: not bit-equal to the plain"
    wrong = {}
    for name, bad in faults.items():
        diff = bad != want
        if axis is not None:
            diff = diff.any(axis)
        wrong[name] = int(diff.sum())
        assert wrong[name] > 0, f"{label}: the check passes {name}"
    return wrong


def check_kernels(quick=False):
    """Phase 2: every metering kernel against its plain version on the
    card, then (unless ``quick``) their times and bounds."""
    import torch

    from repro_torch.fleet import make_trace
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_trapz as cu

    name = torch.cuda.get_device_name(0)
    shapes = ("solar-duck", "wind-night", "flat")
    stats = {}
    big_m = 0 if quick else N_METER
    for G in (1, 3):
        tabs = _tables([make_trace(s, 0.39) for s in shapes[:G]], torch)
        for n in (0, 1, 33, 3001, big_m):
            a, b, dt, w, g = _entries(n, n + G, G, torch)
            got = ops.fused_meter(a, b, dt, w, g, *tabs)
            want = ref.fused_meter_ref(a, b, dt, w, g, *tabs)
            torch.cuda.synchronize()
            assert all(o.device == a.device and o.shape == (n,)
                       for o in got)
            assert torch.equal(got[0], want[0]) and torch.equal(got[0],
                                                                w * dt)
            assert torch.equal(got[1], want[1]) and torch.equal(got[1], dt)
            err = max(_rel_close(got[2], want[2], REL_KERNEL),
                      _rel_close(got[3], want[3], REL_KERNEL))
            assert bool(torch.isfinite(got[2]).all())
            print(f"fused_meter   G={G} N={n:>7}: e,s bit-equal; "
                  f"c,fa max abs err {err:.3e}")
            if G == 1 and n == big_m:
                stats["fused_meter"] = {"max_abs_err": err, "n": n}
    tr = make_trace("solar-duck", 0.39)
    kt, kv, cum = (torch.tensor(x, dtype=torch.float64, device=DEV)
                   for x in (tr._kt, tr._kv, tr._cum))
    K = len(tr._kt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = cu.TRAPZ_TILE
    wave = cu.trapz_plan(10**9, sms).blocks * tile   # one persistent wave
    sizes = [1, 17, 2001, tile - 1, tile, tile + 1, 3 * tile + 1]
    if not quick:
        sizes += [wave - 1, wave, wave + 1, N_SEG - 1, N_SEG]
    for n in sizes:
        a, b, _dt, w, _g = _entries(n, n, 1, torch)
        got = ops.segment_trapz(a, b, w, kt, kv, cum, period=tr.period_s)
        want = ref.segment_trapz_ref(a, b, w, kt, kv, cum,
                                     period=tr.period_s)
        torch.cuda.synchronize()
        plan = cu.trapz_plan(n, sms)
        faults = ref.segment_trapz_faults(want, tile, plan.full_tiles) \
            if plan.full_tiles > 1 else {}
        wrong = _sees(got, want, faults, f"segment_trapz N={n}")
        assert float(got[n // 2]) == 0.0            # the zero-width entry
        seen = "".join(f"; {k} gets {v} entries wrong"
                       for k, v in wrong.items())
        print(f"segment_trapz N={n:>7} ({plan.blocks} blocks, "
              f"{plan.full_tiles} ring tiles + {plan.tiles - plan.full_tiles}"
              f" tail): bit-equal{seen}")
        stats["segment_trapz"] = {"max_abs_err": 0.0, "n": n}
    try:
        ops.segment_trapz(a[1:], b[1:], w[1:], kt, kv, cum,
                          period=tr.period_s)
    except ValueError as e:
        print(f"segment_trapz on a view off the 16-byte grid raises: {e}")
    else:
        raise AssertionError("segment_trapz took a misaligned view")

    num = N_DEV * 3
    cases = [("uniform", n, num, None) for n in (0, 1, 1000, big_m)]
    if not quick:
        cases += [("90 % on one key", 100_000, num, 7),
                  ("uniform", N_METER, 15_000, None)]
    for kind, n, nk, hot in cases:
        vals, keys = _sort_inputs(n, nk, n + nk, torch, hot)
        got = ops.ordered_segment_sum(vals, keys, nk)
        # the plain version loops over the longest run: on the CPU for
        # the skewed keys (90,000 steps), on the card otherwise
        on = "cpu" if hot is not None else DEV
        want = ref.ordered_segment_sum_ref(vals.to(on), keys.to(on), nk)
        faults = ref.ordered_segment_sum_faults(
            vals.to(on), keys.to(on), nk) if n >= 100_000 else {}
        torch.cuda.synchronize()
        wrong = _sees(got.to(on), want, faults,
                      f"ordered_segment_sum {kind} N={n} num={nk}", axis=0)
        run = int(torch.bincount(keys, minlength=nk).max()) if n else 0
        seen = "".join(f"; {k} gets {v} keys wrong"
                       for k, v in wrong.items())
        print(f"ordered_segment_sum {kind} N={n:>7} num={nk} (tiles of "
              f"{cu.sort_plan(n, nk).tile}, longest run {run}): "
              f"bit-equal{seen}")
        if n == big_m and nk == num:
            stats["ordered_segment_sum"] = {"max_abs_err": 0.0, "n": n}
    try:
        cu.ordered_segment_sum(vals, keys, cu.SORT_MAX_NUM + 1)
    except ValueError as e:
        print(f"ordered_segment_sum above its key limit raises: {e}")
    else:
        raise AssertionError("ordered_segment_sum took too many keys")
    if quick:
        return stats

    # times at the acceptance day's shapes, rotated, beside the least time
    sets = metering_sets(torch)
    times = time_metering(torch, sets)
    clock = _clock_hz()
    fp64_rate = sms * 64 * clock                   # instructions a second
    bw = _peaks(name)[0]
    dadd_ms = dadd_latency_ms(torch)
    print(f"FP64 pipe: {sms} SMs x 64 a clock x {clock / 1e6:.0f} MHz; "
          f"one dependent FP64 add {dadd_ms * 1e6:.3f} ns (one-thread "
          f"chain)")
    for k in ("fused_meter", "segment_trapz"):
        t = stats[k]
        calls, nbytes = sets[k][:2]
        per, ops_by = fp64_per_entry(k + "_kernel", K)
        t.update(ms=times[k], sets=len(calls), fp64_per_entry=per,
                 library_ms=None, n=N_METER if k == "fused_meter" else N_SEG)
        t["bound_ms"], t["bound_by"] = _bound_terms({
            "bytes": nbytes / bw * 1e3,
            "operations": per * t["n"] / fp64_rate * 1e3})
        print(f"{k} SASS (K={K}): {per:.2f} FP64-pipe instructions an "
              f"entry; over the code {ops_by}")
    a, b, dt, w, g = sets["fused_meter"][2]
    tabs = sets["fused_meter"][3]
    stats["fused_meter"]["plain_ms"] = _time_ms(
        lambda: ref.fused_meter_ref(a, b, dt, w, g, *tabs), torch, reps=3)
    a, b, _dt, w, _g = sets["segment_trapz"][2]
    stats["segment_trapz"]["plain_ms"] = _time_ms(
        lambda: ref.segment_trapz_ref(a, b, w, kt, kv, cum,
                                      period=tr.period_s), torch, reps=3)
    t = stats["ordered_segment_sum"]
    calls, nbytes, (vals, keys), lib = sets["ordered_segment_sum"]
    t.update(ms=times["ordered_segment_sum"], sets=len(calls),
             longest_run=int(torch.bincount(keys, minlength=num).max()),
             dadd_ns=dadd_ms * 1e6)
    t["plain_ms"] = _time_ms(lambda: ref.ordered_segment_sum_ref(
        vals, keys, num), torch, reps=1, rounds=3)
    t["bound_ms"], t["bound_by"] = _bound_terms({
        "bytes": nbytes / bw * 1e3,
        "operations": vals.numel() / fp64_rate * 1e3,
        "dependent adds": t["longest_run"] * dadd_ms})
    t["library_ms"] = _time_rot(lib, torch)
    for k, v in stats.items():
        lib_ms = v["library_ms"]
        print(f"time {k:20s} N={v['n']}: kernel {v['ms']!r} ms rotating "
              f"over {v['sets']} input sets, plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']!r} ms ({v['bound_by']}), library "
              f"{'n/a' if lib_ms is None else repr(lib_ms) + ' ms'}")
        _possible(v["ms"], v["bound_ms"], k)
    return stats


# ---------------------------------------------------------------------------
# attention kernels and the serving path
# ---------------------------------------------------------------------------

ARCH = "qwen2-5-7b"
# the reference's attention contract (tests/test_kernels.py)
FLASH_SHAPES = ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 256, 128),
                (2, 2, 2, 512, 32))                     # (B, H, Hkv, S, D)
DECODE_SHAPES = ((1, 4, 4, 256, 64), (2, 8, 2, 512, 64),
                 (4, 8, 1, 1024, 128))                  # (B, H, Hkv, T, D)
ATTN_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
REL_LOGITS = 2e-3          # card vs CPU logits, relative to their max
# decode timing shape: 4 decode rows over 4096 rows (the prefill rows
# are FLASH_ROWS), its ragged lengths, and RecurrentGemma's decode over
# its 2048-row window
DECODE_TIMED = (4, 28, 4, 4096, 128)
DECODE_RAGGED = (4096, 1000, 17, 1)
RG_DECODE = (4, 16, 1, 2048, 256)
RG_RAGGED = (2048, 700, 64, 3)
# bf16 decode timing rows: (label, B, H, Hkv, T, D, length, views);
# ``views``: k, v read through [B,T,Hkv,D] tensors, as the launcher's
# decode steps hand them over (position 5 of a 48-row cache)
DECODE_ROWS = (
    ("qwen 4096", *DECODE_TIMED, 4096, False),
    ("recurrentgemma 2048", *RG_DECODE, 2048, False),
    ("qwen launcher", 4, 28, 4, 48, 128, 6, True),
    ("recurrentgemma launcher", 4, 16, 1, 48, 256, 6, True),
    ("granite 4096", 4, 48, 1, 4096, 128, 4096, False),
    ("granite launcher", 4, 48, 1, 48, 128, 6, True),
    ("gemma3 launcher", 4, 4, 1, 48, 256, 6, True),
    # whisper's cross-attention decode: 4 slots over the 1500 encoder
    # rows of the engine's cache (one query head a kv head, split route)
    ("whisper cross 1500", 4, 8, 8, 1500, 64, 1500, True),
)
# input sets a timed call rotates over: together at least this many
# bytes, twice the 50 MB L2, so no call finds its inputs there
ROTATE_BYTES = 100_000_000

RG_ARCH = "recurrentgemma-9b"
# the reference's rglru_scan contract (tests/test_kernels.py), then the
# launcher's shapes: a 3-token prefill and a 4-row decode step at W=4096
RGLRU_SHAPES = ((1, 128, 128), (2, 256, 256), (3, 384, 128))   # (B, S, W)
RGLRU_RAGGED = ((1, 3, 4096), (4, 1, 4096))
RGLRU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
RGLRU_TIMED = (1, 2048, 4096)          # a long RecurrentGemma prompt, f32
RGLRU_ROWS = (RGLRU_TIMED,) + RGLRU_RAGGED   # timed, f32
# a rank's 256 of recurrentgemma-9b's 4,096 RG-LRU channels in phase
# 24.3's sharded cells: train (16 rows x 4,096 tokens) and prefill (2
# rows x 32,768), float32; checked and timed beside RGLRU_ROWS
RGLRU_RANK = ((16, 4096, 256), (2, 32768, 256))
RG_WINDOW = 16                         # the depth-3 run's cut window
# phase 24.3's cut of recurrentgemma-9b: one (RG-LRU, RG-LRU, local
# attention) superlayer of its first scan group
RG_LAYERS = 3


def _randn(shape, seed, dtype, torch):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def _close(got, want, tol):
    """Whether |got - want| <= tol + tol * |want| elementwise (the
    reference's assert_allclose(rtol=tol, atol=tol)) with got finite, and
    the max abs error."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.all(err <= tol + tol * w.abs()))
    return ok and bool(torch.isfinite(g).all()), float(err.max())


def _attn_close(got, want, tol, label):
    """``_close`` or fail; returns the max abs error."""
    ok, err = _close(got, want, tol)
    assert ok, f"{label}: max abs err {err:.3e} beyond {tol}"
    return err


def _sees_combine(q, k, v, length, want, tol, label):
    """The split route's check must be able to fail a wrong combine:
    the kernel's own plan's partials, modelled in plain torch
    (``ref.decode_split_partials``), combined the two wrong ways of
    ``ref.decode_split_faults`` (splits weighted equally; each split left
    on its own max), must each fail ``_close(., want, tol)``.  Returns
    their max abs errors."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import ref
    b, h, d = q.shape
    pl = dmod.plan(b, h, k.shape[1], k.shape[2], d, dmod._sms(q.device))
    parts = ref.decode_split_partials(q, k, v, length, pl.chunk)
    errs = {}
    for name, out in ref.decode_split_faults(*parts, q.dtype).items():
        ok, errs[name] = _close(out, want, tol)
        assert not ok, (f"{label}: the check passes a combine with "
                        f"{name} (max abs err {errs[name]:.3e})")
    return errs


def _routed(op, way, call):
    """``call()``, asserting that it made one call of ``op`` and that
    the call took route ``way`` (``ops.route_counts(op)``)."""
    from repro_torch.kernels import ops
    before = ops.route_counts(op)
    out = call()
    after = ops.route_counts(op)
    assert after[way] == before[way] + 1 and sum(after.values()) == sum(
        before.values()) + 1, (op, way, before, after)
    return out


def _flash_row(route):
    """The kernels line's row of a flash route: the sm90 kernel is the
    ``flash_attention`` row (serving), the f32tc kernel its own (float32
    prefill and training); the simt kernel is timed in the former."""
    return "flash_attention_f32" if route == "f32tc" else "flash_attention"


# one kv head's query group of the float32 training shape (TRAIN_SHAPE's
# 28 / 4 = 7 heads over 1, S = T = 4,096, D = 128), causal
F32_ACC_SLICE = (1, 7, 1, 4096, 128)


def check_f32_accuracy(stats):
    """Phase 5: the f32tc kernel (3xTF32) against float64 at
    F32_ACC_SLICE: its max abs error at most 4x that of the plain float32
    version (TF32 off), and a planted single-pass TF32 version (the plain
    version with TF32 matmuls) must miss that bound; lse within 2e-3 of
    the float64 one."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    b, h, hkv, s, d = F32_ACC_SLICE
    q = _randn((b, h, s, d), 21, torch.float32, torch)
    k = _randn((b, hkv, s, d), 22, torch.float32, torch)
    v = _randn((b, hkv, s, d), 23, torch.float32, torch)
    want, want_lse = ref.flash_attention_lse_ref(q.double(), k.double(),
                                                 v.double())
    got, lse = _routed("flash_attention", "f32tc",
                       lambda: fmod.flash_attention_lse(q, k, v))
    plain = ref.flash_attention_ref(q, k, v)
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = ref.flash_attention_ref(q, k, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    errs = {n: float((x.double() - want).abs().max())
            for n, x in (("kernel", got), ("plain_f32", plain),
                         ("single_pass_tf32", tf32))}
    lse_err = _attn_close(lse, want_lse, ATTN_TOL["float32"],
                          "f32tc lse against float64")
    assert errs["kernel"] <= 4 * errs["plain_f32"], errs
    assert errs["single_pass_tf32"] > 4 * errs["plain_f32"], \
        f"the accuracy check passes a single TF32 pass: {errs}"
    stats["flash_attention_f32"]["accuracy_vs_float64"] = errs
    print(f"flash_attention  f32tc accuracy at {list(F32_ACC_SLICE)} "
          f"against float64: max abs err kernel {errs['kernel']:.3e}, "
          f"plain float32 {errs['plain_f32']:.3e} (bound 4x: "
          f"{4 * errs['plain_f32']:.3e}), planted single-pass TF32 "
          f"{errs['single_pass_tf32']:.3e} (misses); lse {lse_err:.3e}")


def _flash_routed(q, k, v, window, causal=True):
    """``ops.flash_attention``, asserting that the route the wrapper
    names for q's dtype and head dim took the launch."""
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops
    return _routed("flash_attention", fmod.route(q.dtype, q.shape[-1]),
                   lambda: ops.flash_attention(q, k, v, causal=causal,
                                               window=window))


# bf16 checks of the sm90 route beyond the reference's sweep:
# (B, H, Hkv, S, T, D, window, views, causal) -- RecurrentGemma's heads
# at a ragged S = T = 300; the launcher's 3-token prompt against 48 cache
# rows, read through [B,S|T,heads,D] views, at both models' heads; a
# mixtral-8x22b rank's prefill heads on (16, 16) (3 query heads over the
# one kv head they read) with its 4,096-token window over 8,192 rows;
# and
# the non-causal mask the wrapper also takes, with T below and above S
# (every row sees a key: where none is visible the plain version gives
# NaN and the kernels 0)
SM90_CASES = (
    (1, 16, 1, 300, 300, 256, None, False, True),
    (1, 16, 1, 300, 300, 256, 64, False, True),
    (1, 28, 4, 3, 48, 128, None, True, True),
    (1, 16, 1, 3, 48, 256, 2048, True, True),
    (1, 3, 1, 8192, 8192, 128, 4096, False, True),
    (2, 8, 2, 300, 200, 128, None, False, False),
    (2, 4, 4, 200, 300, 64, 64, False, False),
    # internvl2-26b's sharded prefill rank shape (3 query heads over one
    # K/V head) at its train cell's 4,352 rows (256 prefix + 4,096 tokens)
    (2, 3, 1, 4352, 4352, 128, None, True, True),
    # whisper-base's sharded cross-attention prefill rank shape: a rank's
    # 2 rows' 32,768 queries, every head, against all 1,500 frames (11
    # key tiles of 128 and a partial one of 92), non-causal
    (2, 8, 8, 32768, 1500, 64, None, True, False),
)


def check_flash_sm90(stats):
    """The bf16 sm90 route (``csrc/flash_attention_sm90.cu``) against the
    plain version at SM90_CASES, 2e-2; every call must take the sm90
    route.  (The reference's sweep in ``check_attention`` covers D = 32,
    64 and 128 on this route in bf16.)"""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref

    dt, tol = torch.bfloat16, ATTN_TOL["bfloat16"]
    for i, (b, h, hkv, s, t, d, window, views, causal) in \
            enumerate(SM90_CASES):
        assert fmod.route(dt, d) == "sm90"
        if views:
            q = _randn((b, s, h, d), 70 + i, dt, torch).transpose(1, 2)
            k = _randn((b, t, hkv, d), 80 + i, dt, torch).transpose(1, 2)
            v = _randn((b, t, hkv, d), 90 + i, dt, torch).transpose(1, 2)
        else:
            q = _randn((b, h, s, d), 70 + i, dt, torch)
            k = _randn((b, hkv, t, d), 80 + i, dt, torch)
            v = _randn((b, hkv, t, d), 90 + i, dt, torch)
        got = _flash_routed(q, k, v, window, causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        err = _attn_close(got, want, tol, f"sm90 flash {SM90_CASES[i]}")
        stats["flash_attention"]["max_abs_err"] = max(
            stats["flash_attention"]["max_abs_err"], err)
        print(f"flash_attention  sm90 bf16 B,H,Hkv,S,T,D="
              f"{(b, h, hkv, s, t, d)} window={window} views={views} "
              f"causal={causal}: max abs err {err:.3e} (tol {tol})")


def count_hgmma():
    """The HGMMA (wgmma) instructions in the sm90 library's SASS, read
    with the toolkit's ``cuobjdump`` where it has one (None otherwise)."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("cuobjdump not found beside nvcc: the sm90 library's HGMMA "
              "count is not read")
        return None
    sass = subprocess.run(
        [str(tool), "-sass", str(_build.lib_path("flash_attention_sm90"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    print(f"flash_attention_sm90 SASS: {n} HGMMA instructions")
    assert n > 0, "the sm90 library holds no wgmma"
    return n


def check_attention():
    """The attention kernels against their plain versions on the card:
    the reference's shape sweeps, the frontier case, and the launcher's
    ragged shapes through permuted cache views.  Returns the max abs
    error of each kernel over all cases."""
    import torch

    from repro_torch.kernels import ops, ref

    from repro_torch.kernels import flash_attention as fmod
    worst = {"flash_attention": 0.0, "flash_attention_f32": 0.0,
             "decode_attention": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dt).split(".")[-1]]
        for b, h, hkv, s, d in FLASH_SHAPES:
            row = _flash_row(fmod.route(dt, d))
            q = _randn((b, h, s, d), 0, dt, torch)
            k = _randn((b, hkv, s, d), 1, dt, torch)
            v = _randn((b, hkv, s, d), 2, dt, torch)
            for window in (None, 64):
                got = _flash_routed(q, k, v, window)
                want = ref.flash_attention_ref(q, k, v, causal=True,
                                               window=window)
                torch.cuda.synchronize()
                assert got.shape == q.shape and got.dtype == dt
                err = _attn_close(got, want, tol,
                                  f"flash {dt} {(b, h, hkv, s, d)} "
                                  f"window={window}")
                worst[row] = max(worst[row], err)
                print(f"flash_attention  {str(dt):14s} B,H,Hkv,S,D="
                      f"{(b, h, hkv, s, d)} window={window}: max abs err "
                      f"{err:.3e} (tol {tol})")
        for b, h, hkv, t, d in DECODE_SHAPES:
            q = _randn((b, h, d), 0, dt, torch)
            k = _randn((b, hkv, t, d), 1, dt, torch)
            v = _randn((b, hkv, t, d), 2, dt, torch)
            g = torch.Generator().manual_seed(t)
            length = torch.randint(1, t, (b,), generator=g,
                                   dtype=torch.int32).to(DEV)
            got = ops.decode_attention(q, k, v, length)
            want = ref.decode_attention_ref(q, k, v, length)
            torch.cuda.synchronize()
            assert got.shape == q.shape and got.dtype == dt
            err = _attn_close(got, want, tol,
                              f"decode {dt} {(b, h, hkv, t, d)}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            print(f"decode_attention {str(dt):14s} B,H,Hkv,T,D="
                  f"{(b, h, hkv, t, d)} length={length.tolist()}: max abs "
                  f"err {err:.3e} (tol {tol})")
        # the launcher's shapes: a 3-token prompt against 48 cache rows,
        # and a decode at position 5, both read through [B,T,Hkv,D] views
        q = _randn((1, 3, 28, 128), 3, dt, torch)
        k = _randn((1, 48, 4, 128), 4, dt, torch)
        v = _randn((1, 48, 4, 128), 5, dt, torch)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = _flash_routed(qt, kt, vt, None)
        want = ref.flash_attention_ref(qt, kt, vt, causal=True)
        torch.cuda.synchronize()
        err = _attn_close(got, want, tol, f"flash {dt} S=3 T=48")
        row = _flash_row(fmod.route(dt, 128))
        worst[row] = max(worst[row], err)
        kb = _randn((4, 48, 4, 128), 6, dt, torch).transpose(1, 2)
        vb = _randn((4, 48, 4, 128), 7, dt, torch).transpose(1, 2)
        qd = _randn((4, 28, 128), 8, dt, torch)
        length = torch.full((4,), 6, dtype=torch.int32, device=DEV)
        got = ops.decode_attention(qd, kb, vb, length)
        want = ref.decode_attention_ref(qd, kb, vb, length)
        torch.cuda.synchronize()
        err2 = _attn_close(got, want, tol, f"decode {dt} T=48 length=6")
        worst["decode_attention"] = max(worst["decode_attention"], err2)
        print(f"launcher shapes  {str(dt):14s} flash S=3 T=48 err {err:.3e}; "
              f"decode B=4 T=48 length=6 err {err2:.3e} (tol {tol})")
    # garbage past the frontier must not change the output
    b, h, hkv, t, d = 1, 4, 2, 256, 64
    q = _randn((b, h, d), 0, torch.float32, torch)
    k = _randn((b, hkv, t, d), 1, torch.float32, torch)
    v = _randn((b, hkv, t, d), 2, torch.float32, torch)
    out1 = ops.decode_attention(q, k, v, 100)
    k[:, :, 100:] = 1e4
    v[:, :, 100:] = -1e4
    out2 = ops.decode_attention(q, k, v, 100)
    torch.cuda.synchronize()
    diff = float((out1 - out2).abs().max())
    assert diff <= 1e-5, f"decode reads past length: {diff:.3e}"
    print(f"decode_attention ignores rows past length: max diff {diff:.3e}")
    return {k: {"max_abs_err": v} for k, v in worst.items()}


def _raw_attn(mod, lib, fn_name, sig, strides, *args):
    """A call of one attention or RG-LRU C entry point (``fn(*args,
    strides, stream)``) with a preallocated output (no checks, no
    allocation, no launch count)."""
    import ctypes

    import torch
    fn = mod.c_fn(lib, fn_name, sig)
    arr = (ctypes.c_longlong * len(strides))(*strides)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(*args, arr, stream)
        if rc != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {rc}")

    return run


def _sets(nbytes):
    """Input sets of ``nbytes`` each to rotate over: at least two, and
    together at least ROTATE_BYTES."""
    return max(2, -(-ROTATE_BYTES // nbytes))


def _possible(ms, bound, label):
    """A kernel time under the least time the card could take is a
    timing fault (an input read from cache, work skipped): fail."""
    assert ms >= bound, (f"{label}: {ms} ms is under the bound {bound} ms; "
                         f"impossible")


def _raw_decode(q, k, v, length, out, pl, softcap=None, lse=None):
    """One raw call of the decode kernel with plan ``pl`` (no checks, no
    count; its partials' scratch allocated here and kept by the call);
    ``lse``: a [B, H] float32 output for the log-sum-exps, or None."""
    import math

    import torch

    from repro_torch.kernels import decode_attention as dmod
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    acc = ml = None
    if pl.splits > 1:
        acc = torch.empty((b, h, pl.splits, d), dtype=torch.float32,
                          device=DEV)
        ml = torch.empty((b, h, pl.splits, 2), dtype=torch.float32,
                         device=DEV)
    run = _raw_attn(
        dmod, "decode_attention", "decode_attention_fwd", dmod._SIG,
        [*q.stride(), *k.stride(), *v.stride(), *out.stride()],
        1 if q.dtype == torch.bfloat16 else 0,
        int(dmod.tensor_cores(q.dtype, d)), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), length.data_ptr(), out.data_ptr(),
        acc.data_ptr() if acc is not None else None,
        ml.data_ptr() if ml is not None else None,
        lse.data_ptr() if lse is not None else None, b, h, hkv, t, d,
        pl.splits, pl.chunk, 1.0 / math.sqrt(d), float(softcap or 0.0))
    run.scratch = (acc, ml)
    return run


def _decode_routed(q, k, v, length, way):
    """``ops.decode_attention``, asserting that it took route ``way``."""
    from repro_torch.kernels import ops
    return _routed("decode_attention", way,
                   lambda: ops.decode_attention(q, k, v, length))


def check_decode_split(stats):
    """The split-KV route against the plain version at the timed Qwen
    shape with ragged lengths (whole splits past a row's length) and at
    RecurrentGemma's decode shape, in bfloat16 (the tensor cores) and
    float32 (FP32 FMAs), with unit-normal queries and with queries x4:
    there the softmax is peaked, a row spanning splits takes its value
    from a few keys, and the check must reject a wrong combine of the
    same plan's partials (``_sees_combine``); a row of length 0 gives
    exactly 0; two calls on the same inputs are bit-equal."""
    import torch

    from repro_torch.kernels import ops, ref

    for shape, lengths in ((DECODE_TIMED, DECODE_RAGGED),
                           (RG_DECODE, RG_RAGGED)):
        b, h, hkv, t, d = shape
        for dt in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL[str(dt).split(".")[-1]]
            k = _randn((b, hkv, t, d), 101, dt, torch)
            v = _randn((b, hkv, t, d), 102, dt, torch)
            length = torch.tensor(lengths, dtype=torch.int32, device=DEV)
            for qs in (1, 4):
                q = _randn((b, h, d), 100, dt, torch) * qs
                got = _decode_routed(q, k, v, length, "split")
                want = ref.decode_attention_ref(q, k, v, length)
                again = ops.decode_attention(q, k, v, length)
                torch.cuda.synchronize()
                err = _attn_close(got, want, tol,
                                  f"split decode {dt} {shape} q x{qs}")
                assert torch.equal(got, again), "two calls differ"
                # a row of length 0: 0 (the plain version's empty softmax
                # is NaN), the other rows as before
                zero = torch.tensor((0,) + lengths[1:], dtype=torch.int32,
                                    device=DEV)
                got0 = _decode_routed(q, k, v, zero, "split")
                torch.cuda.synchronize()
                assert bool((got0[0] == 0).all()), "length 0 row is not 0"
                assert torch.equal(got0[1:], got[1:])
                seen = ""
                if qs > 1:
                    faults = _sees_combine(q, k, v, length, want, tol,
                                           f"split decode {dt} {shape}")
                    seen = "; the check rejects a wrong combine: " + \
                        ", ".join(f"{n} max abs err {e:.3e}"
                                  for n, e in faults.items())
                stats["decode_attention"]["max_abs_err"] = max(
                    stats["decode_attention"]["max_abs_err"], err)
                print(f"decode_attention split {str(dt):14s} B,H,Hkv,T,D="
                      f"{shape} length={list(lengths)} q x{qs}: max abs "
                      f"err {err:.3e} (tol {tol}), max|want| "
                      f"{float(want.float().abs().max()):.3e}; two calls "
                      f"bit-equal; a length-0 row exactly 0{seen}")


def time_attention(stats):
    """``decode_attention``'s time at every row of DECODE_ROWS (bf16):
    the split route the plan takes and, on the same inputs, the single
    route (one block a (b, kv head, query-head group)), each rotating
    over input sets of >= ROTATE_BYTES together; beside them the
    back-to-back time of one set (the earlier method, which reads
    a cache smaller than the L2 from there after the first call), the
    plain version, the bound (every kernel time must be at or above
    it) and ``scaled_dot_product_attention`` under its fastest backend,
    rotating alike (``flash_attention``'s rows are ``time_flash``'s).
    The Qwen 4096 row fills ``stats["decode_attention"]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import ref

    name = torch.cuda.get_device_name(0)
    dt = torch.bfloat16
    rows = []
    for i, (label, b, h, hkv, t, d, n, views) in enumerate(DECODE_ROWS):
        # queries x4: a peaked softmax, whose output a wrong combine
        # would miss by far more than the tolerance (check_decode_split)
        q = _randn((b, h, d), 200 + i, dt, torch) * 4
        sets = []
        for j in range(_sets(2 * b * hkv * t * d * 2)):
            if views:
                k = _randn((b, t, hkv, d), 300 + 2 * j, dt, torch)
                v = _randn((b, t, hkv, d), 301 + 2 * j, dt, torch)
                sets.append((k.transpose(1, 2), v.transpose(1, 2)))
            else:
                sets.append((_randn((b, hkv, t, d), 300 + 2 * j, dt, torch),
                             _randn((b, hkv, t, d), 301 + 2 * j, dt,
                                    torch)))
        length = torch.full((b,), n, dtype=torch.int32, device=DEV)
        want = ref.decode_attention_ref(q, *sets[0], length)
        pl = dmod.plan(b, h, hkv, t, d, dmod._sms(q.device))
        one = dmod.Plan(1, -(-t // dmod.TILE) * dmod.TILE)
        way = "split" if pl.splits > 1 else "single"
        row = {"label": label, "splits": pl.splits, "route": way,
               "shape": f"B,H,Hkv,T,D={(b, h, hkv, t, d)} length={n} "
                        f"views={views} bf16"}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            name, (2 * q.numel() + 2 * b * hkv * n * d) * 2,
            4 * b * h * n * d, "bf16")
        for route, p in (("split", pl), ("single", one)):
            if route == "split" and pl.splits == 1:
                continue
            outs = [torch.empty_like(q) for _ in sets]
            fns = [_raw_decode(q, k, v, length, o, p)
                   for (k, v), o in zip(sets, outs)]
            row[route] = _time_rot(fns, torch)
            torch.cuda.synchronize()
            row[route + "_err"] = _attn_close(outs[0], want, 2e-2,
                                              f"{route} decode at {label}")
            _possible(row[route], row["bound_ms"], f"{route} decode {label}")
            if route == way:
                row["l2_ms"] = _time_ms(fns[0], torch)
        row["plain_ms"] = _time_ms(
            lambda: ref.decode_attention_ref(q, *sets[0], length), torch,
            reps=5)
        calls = [lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k[:, :, :n], v[:, :, :n], enable_gqa=True)
            for k, v in sets]
        row["library_ms"], row["library"], row["backends"] = _library_ms(
            calls[0], torch, rotate=calls[1:])
        rows.append(row)
        times = ", ".join(f"{r} {row[r]:.4f} ms (err {row[r + '_err']:.3e})"
                          for r in ("split", "single") if r in row)
        bk = ", ".join(f"{k} {v:.4f}" for k, v in row["backends"].items())
        print(f"time decode_attention {label:24s} {row['shape']}, "
              f"{pl.splits} splits: {times}, each rotating over "
              f"{len(sets)} input sets; {way} back-to-back on one set "
              f"{row['l2_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"scaled_dot_product_attention {row['library_ms']:.4f} ms "
              f"({row['library']}; {bk})")
    top = rows[0]
    t = stats["decode_attention"]
    t.update(ms=top["split"], single_ms=top["single"], l2_ms=top["l2_ms"],
             plain_ms=top["plain_ms"], library_ms=top["library_ms"],
             library=top["library"], bound_ms=top["bound_ms"],
             bound_by=top["bound_by"], shape=top["shape"],
             splits=top["splits"])
    t["max_abs_err"] = max(t["max_abs_err"], top["split_err"],
                           top["single_err"])
    return rows


# bf16 prefill timing rows: (label, B, H, Hkv, S, T, D, window, views,
# causal); ``views``: q, k, v read through [B,S|T,heads,D] tensors, as
# the launcher hands them over (a 3-token prompt against 48 cache rows)
FLASH_ROWS = (
    ("qwen 2048", 1, 28, 4, 2048, 2048, 128, None, False, True),
    ("recurrentgemma 2048", 1, 16, 1, 2048, 2048, 256, 2048, False, True),
    ("qwen launcher", 1, 28, 4, 3, 48, 128, None, True, True),
    ("recurrentgemma launcher", 1, 16, 1, 3, 48, 256, 2048, True, True),
    ("gemma3 2048", 1, 4, 1, 2048, 2048, 256, 512, False, True),
    ("granite launcher", 1, 48, 1, 3, 48, 128, None, True, True),
    # whisper's encoder layer: bidirectional over the 1500 frames
    ("whisper encoder 1500", 1, 8, 8, 1500, 1500, 64, None, True, False),
)


def _flash_work(b, h, hkv, s, t, d, window, causal=True):
    """Bytes and operations a prefill needs: q, out and the kv rows some
    query sees, once each; 4 D operations per visible (query, key) pair
    (every pair without the causal mask)."""
    if causal:
        pairs = sum(min(i + 1, t) - (max(0, i + 1 - window) if window
                                     else 0) for i in range(s))
        rows = min(s, t)
    else:
        pairs, rows = s * t, t
    return (2 * b * h * s * d + 2 * b * hkv * rows * d) * 2, \
        4 * b * h * pairs * d


def _library_ms(call, torch, rotate=()):
    """``call`` (one ``scaled_dot_product_attention``) timed under each
    backend of ``torch.nn.attention.sdpa_kernel`` that accepts it, in
    turn with the same call on the input sets ``rotate`` when given
    (``_time_rot``); returns (the fastest time, its backend, every
    backend's time)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a backend that refuses the call warns why, then raises
            with sdpa_kernel(be), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                call()
                torch.cuda.synchronize()
                times[be.name] = _time_rot([call, *rotate], torch, reps=5) \
                    if rotate else _time_ms(call, torch, reps=5)
        except RuntimeError:
            continue
    best = min(times, key=times.get)
    return times[best], best, times


def _raw_flash(q, k, v, out, window, route, causal=True, softcap=None,
               q_offset=0):
    """One raw call of the ``route`` kernel (sm90 or simt; no checks, no
    count)."""
    import math

    from repro_torch.kernels import flash_attention as fmod
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    return _raw_attn(fmod, *fmod.ENTRY[route], fmod._SIG,
                     [*q.stride(), *k.stride(), *v.stride(), *out.stride()],
                     fmod._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), b, h, hkv, s, t, d,
                     int(causal), int(window or 0), int(q_offset),
                     1.0 / math.sqrt(d), float(softcap or 0.0))


def time_flash(stats, routes=("sm90", "simt")):
    """bf16 ``flash_attention`` at every row of FLASH_ROWS: each route's
    kernel (the wrapper takes the first; the simt kernel, which bf16 no
    longer reaches at these head dims, is timed on the same inputs), the
    plain version, the bound and ``scaled_dot_product_attention`` under
    its fastest backend.  The Qwen 2048 row fills
    ``stats["flash_attention"]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    name = torch.cuda.get_device_name(0)
    dt = torch.bfloat16
    rows = []
    for i, (label, b, h, hkv, s, t, d, window, views, causal) in \
            enumerate(FLASH_ROWS):
        if views:
            q = _randn((b, s, h, d), 40 + i, dt, torch).transpose(1, 2)
            k = _randn((b, t, hkv, d), 50 + i, dt, torch).transpose(1, 2)
            v = _randn((b, t, hkv, d), 60 + i, dt, torch).transpose(1, 2)
        else:
            q = _randn((b, h, s, d), 40 + i, dt, torch)
            k = _randn((b, hkv, t, d), 50 + i, dt, torch)
            v = _randn((b, hkv, t, d), 60 + i, dt, torch)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        row = {"label": label, "shape": f"B,H,Hkv,S,T,D={(b, h, hkv, s, t, d)}"
               f" window={window} bf16 {'causal' if causal else 'all keys'}"}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            name, *_flash_work(b, h, hkv, s, t, d, window, causal), "bf16")
        for route in routes:
            out = torch.empty_like(q)
            reps = 5 if s > 512 else 20
            row[route] = _time_ms(_raw_flash(q, k, v, out, window, route,
                                             causal), torch, reps=reps)
            torch.cuda.synchronize()
            row[route + "_err"] = _attn_close(out, want, 2e-2,
                                              f"{route} flash at {label}")
            _possible(row[route], row["bound_ms"], f"{route} flash {label}")
        row["plain_ms"] = _time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), torch, reps=2, rounds=3)
        if not causal:
            lib = {}
        elif window is None or window >= s:
            # the window never bites (S <= window): is_causal alone is
            # the same function
            lib = dict(is_causal=True)
        else:
            # a window that bites: the causal band as a boolean mask
            i = torch.arange(s, device=DEV)[:, None]
            j = torch.arange(t, device=DEV)[None, :]
            lib = dict(attn_mask=(j <= i) & (i - j < window))
        row["library_ms"], row["library"], row["backends"] = _library_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **lib), torch)
        rows.append(row)
        times = ", ".join(f"{r} {row[r]:.4f} ms (err {row[r + '_err']:.3e})"
                          for r in routes)
        bk = ", ".join(f"{k} {v:.4f}" for k, v in row["backends"].items())
        print(f"time flash_attention {label:24s} {row['shape']}: {times}; "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}), scaled_dot_product_attention "
              f"{row['library_ms']:.4f} ms ({row['library']}; {bk})")
    top = rows[0]
    t = stats["flash_attention"]
    t.update(ms=top[routes[0]], plain_ms=top["plain_ms"],
             library_ms=top["library_ms"], library=top["library"],
             bound_ms=top["bound_ms"], bound_by=top["bound_by"],
             shape=top["shape"])
    t["max_abs_err"] = max(t["max_abs_err"],
                           *(top[r + "_err"] for r in routes))
    return rows


def _scan_inputs(shape, seed, dtype, torch):
    b, s, w = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    a = torch.rand((b, s, w), generator=g, device=DEV) * 0.499 + 0.5
    x = torch.randn((b, s, w), generator=g, device=DEV)
    h0 = torch.randn((b, w), generator=g, device=DEV)
    return a.to(dtype), x.to(dtype), h0.to(dtype)


def _scan_both(a, x, h0):
    """``rglru_scan`` on both routes: the one S picks through
    ``ops.rglru_scan`` (its route asserted), the other by a raw call of
    its kernel on the same inputs.  Returns {route: h}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rmod
    way = rmod.route(a.shape[1])
    other = "serial" if way == "chunked" else "chunked"
    out = torch.empty_like(a)
    _raw_scan(a, x, h0, out, other)()
    return {way: _routed("rglru_scan", way,
                         lambda: ops.rglru_scan(a, x, h0)), other: out}


def check_rglru():
    """``rglru_scan`` against its plain version on the card, on both
    routes: the reference's shapes, the launcher's ragged shapes and the
    2048-token prompt (a channel at a = 0.9999 throughout), in float32
    and bfloat16, and a sharded rank's 256 channels (RGLRU_RANK, float32:
    two of the chunked kernel's 128-channel blocks); two chunked calls
    bit-equal; the carried ``h0``.  Returns its max abs error."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rmod

    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = RGLRU_TOL[str(dt).split(".")[-1]]
        rank = RGLRU_RANK if dt == torch.float32 else ()
        for shape in RGLRU_SHAPES + RGLRU_ROWS + rank:
            a, x, h0 = _scan_inputs(shape, sum(shape), dt, torch)
            if shape == RGLRU_TIMED:
                a[:, :, 7] = 0.9999                 # the carry's drift
            want = ref.rglru_scan_ref(a, x, h0)
            got = _scan_both(a, x, h0)
            again = _scan_both(a, x, h0)
            torch.cuda.synchronize()
            errs = []
            for way in ("serial", "chunked"):
                assert got[way].shape == a.shape and got[way].dtype == dt
                errs.append(_attn_close(got[way], want, tol,
                                        f"rglru_scan {way} {dt} {shape}"))
            assert torch.equal(got["chunked"], again["chunked"]), \
                "two chunked calls differ"
            worst = max(worst, *errs)
            print(f"rglru_scan       {str(dt):14s} B,S,W={shape}: max abs "
                  f"err serial {errs[0]:.3e}, chunked {errs[1]:.3e} (tol "
                  f"{tol}; route by S: {rmod.route(shape[1])}); chunked "
                  f"calls bit-equal")
    b, s, w = RGLRU_SHAPES[0]
    h = ops.rglru_scan(torch.full((b, s, w), 0.9, device=DEV),
                       torch.zeros((b, s, w), device=DEV),
                       torch.ones((b, w), device=DEV))
    torch.cuda.synchronize()
    first = float((h[:, 0] - 0.9).abs().max() / 0.9)
    last = float((h[:, -1] - 0.9 ** s).abs().max() / 0.9 ** s)
    assert first <= 1e-5 and last <= 1e-3, (first, last)
    print(f"rglru_scan carries h0: h[:, 0] rel err {first:.3e}, h[:, -1] "
          f"vs 0.9**{s} rel err {last:.3e}")
    return {"rglru_scan": {"max_abs_err": worst}}


def _raw_scan(a, x, h0, out, way):
    """One raw call of the ``way`` scan kernel (no checks, no count; h0
    widened to the float32 the kernel reads, and kept by the call)."""
    import torch

    from repro_torch.kernels import rglru_scan as rmod
    b, s, w = a.shape
    h0 = h0.to(torch.float32).contiguous()
    buf = rmod.scratch(a.device, rmod.scratch_words(b, s, w)) \
        if way == "chunked" else None
    run = _raw_attn(
        rmod, "rglru_scan", "rglru_scan_fwd", rmod._SIG,
        [*a.stride()[:2], *x.stride()[:2], *out.stride()[:2]],
        rmod._DTYPES[a.dtype], a.data_ptr(), x.data_ptr(), h0.data_ptr(),
        out.data_ptr(), b, s, w, int(way == "chunked"),
        buf.data_ptr() if buf is not None else None,
        buf.numel() if buf is not None else 0)
    run.inputs = (h0, buf)
    return run


def time_rglru(stats):
    """Its time at every RGLRU_ROWS and RGLRU_RANK shape (float32): the
    serial and the chunked kernel on the same inputs, each rotating over
    input sets of >= ROTATE_BYTES together, beside the byte bound (every
    kernel time must be at or above it) and the plain version; no single
    PyTorch call computes the recurrence.  The 2048-token row fills
    ``stats["rglru_scan"]``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rmod

    name = torch.cuda.get_device_name(0)
    rows = []
    for shape in RGLRU_ROWS + RGLRU_RANK:
        b, s, w = shape
        sets = [_scan_inputs(shape, 20 + j, torch.float32, torch)
                for j in range(_sets(3 * b * s * w * 4))]
        a, x, h0 = sets[0]
        want = ref.rglru_scan_ref(a, x, h0)
        row = {"shape": f"B,S,W={shape} f32", "route": rmod.route(s)}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            name, (3 * a.numel() + h0.numel()) * 4, 2 * a.numel(), "fp32")
        for way in ("chunked", "serial"):
            outs = [torch.empty_like(a) for _ in sets]
            row[way] = _time_rot([_raw_scan(*abh, o, way)
                                  for abh, o in zip(sets, outs)], torch)
            torch.cuda.synchronize()
            row[way + "_err"] = _attn_close(outs[0], want, 1e-4,
                                            f"rglru_scan {way} at {shape}")
            _possible(row[way], row["bound_ms"], f"rglru_scan {way} {shape}")
        row["plain_ms"] = _time_ms(lambda: ref.rglru_scan_ref(a, x, h0),
                                   torch, reps=1, rounds=3)
        rows.append(row)
        print(f"time rglru_scan       {row['shape']}: chunked "
              f"{row['chunked']:.4f} ms (err {row['chunked_err']:.3e}), "
              f"serial {row['serial']:.4f} ms (err {row['serial_err']:.3e}),"
              f" each rotating over {len(sets)} input sets (route by S: "
              f"{row['route']}); plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library none: "
              f"no single PyTorch call")
    top = rows[0]
    t = stats["rglru_scan"]
    t.update(ms=top["chunked"], serial_ms=top["serial"],
             plain_ms=top["plain_ms"], library_ms=None,
             bound_ms=top["bound_ms"], bound_by=top["bound_by"],
             shape=top["shape"])
    t["max_abs_err"] = max(t["max_abs_err"], top["chunked_err"],
                           top["serial_err"])
    return rows


def check_windowed_decode(stats):
    """Windowed decode as the model runs it: ``decode_attention`` over a
    view of the cache rows [off + 1 - window, off] of a [B,T,Hkv,D]
    cache, against the plain windowed prefill attention's last query
    row, at RecurrentGemma's heads (16 over 1 kv head, head_dim 256)."""
    import torch

    from repro_torch.kernels import ops, ref

    b, h, hkv, t, d, window = 2, 16, 1, 64, 256, RG_WINDOW
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dt).split(".")[-1]]
        k = _randn((b, t, hkv, d), 30, dt, torch)
        v = _randn((b, t, hkv, d), 31, dt, torch)
        for off in (5, window - 1, window, 40, t - 1):
            q = _randn((b, h, off + 1, d), 32 + off, dt, torch)
            lo = max(0, off + 1 - window)
            got = ops.decode_attention(
                q[:, :, off], k[:, lo:off + 1].transpose(1, 2),
                v[:, lo:off + 1].transpose(1, 2),
                torch.full((b,), off + 1 - lo, dtype=torch.int32,
                           device=DEV))
            want = ref.flash_attention_ref(
                q, k[:, :off + 1].transpose(1, 2),
                v[:, :off + 1].transpose(1, 2), causal=True,
                window=window)[:, :, off]
            torch.cuda.synchronize()
            err = _attn_close(got, want, tol,
                              f"windowed decode {dt} off={off}")
            stats["decode_attention"]["max_abs_err"] = max(
                stats["decode_attention"]["max_abs_err"], err)
            print(f"windowed decode  {str(dt):14s} H,Hkv,D={(h, hkv, d)} "
                  f"window={window} off={off} (rows {lo}..{off}): max abs "
                  f"err {err:.3e} (tol {tol})")


class _Recorder:
    """Wraps the engine's ``prefill`` / ``decode_step`` to count the calls,
    time them (synchronised host clock) and keep their logits."""

    def __init__(self, torch):
        from repro_torch.serving import engine
        self.engine, self.torch = engine, torch
        self.real = (engine.prefill, engine.decode_step)
        self.calls = {"prefill": [], "decode": []}
        self.logits = []

    def _wrap(self, kind, fn):
        def run(*a, **kw):
            sync = self.torch.cuda.synchronize
            sync()
            t0 = time.perf_counter()
            logits, caches = fn(*a, **kw)
            sync()
            self.calls[kind].append(time.perf_counter() - t0)
            self.logits.append(logits.float().cpu())
            return logits, caches
        return run

    def __enter__(self):
        self.engine.prefill = self._wrap("prefill", self.real[0])
        self.engine.decode_step = self._wrap("decode", self.real[1])
        return self

    def __exit__(self, *exc):
        self.engine.prefill, self.engine.decode_step = self.real


def cut_depth(arch, n_layers, dtype):
    """``arch`` at full width in ``dtype``, its first scan group's
    pattern repeated to ``n_layers`` layers (a whole period of it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import ScanGroup
    full = get_config(arch)
    pattern = full.groups[0].pattern
    assert n_layers % len(pattern) == 0, (arch, n_layers, len(pattern))
    return dataclasses.replace(
        full, n_layers=n_layers,
        groups=(ScanGroup("main", n_layers // len(pattern), pattern),),
        param_dtype=dtype, compute_dtype=dtype)


def recurrentgemma_depth3():
    """RecurrentGemma-9B's widths at depth 3, float32: one (RG-LRU,
    RG-LRU, local attention) superlayer and the tied head, the local
    window cut from 2048 to RG_WINDOW so that a 48-token prompt and 8
    decode steps run windowed prefill and windowed decode."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ScanGroup
    full = get_config(RG_ARCH)
    pattern = tuple(dataclasses.replace(b, window=RG_WINDOW) if b.window
                    else b for b in full.groups[0].pattern)
    return dataclasses.replace(
        full, n_layers=3, groups=(ScanGroup("main", 1, pattern),),
        param_dtype=torch.float32, compute_dtype=torch.float32)


def serve_depth(cfg, prompt_len=48, steps=8, f64=True):
    """A cut-in-depth config at full width in float32: the same weights
    served on the card (kernels) and on the CPU (plain versions) through
    ``ServingEngine``; logits within REL_LOGITS of their max magnitude
    and equal greedy tokens.  With ``f64``, each side's prefill logits
    beside a float64 CPU prefill."""
    import dataclasses

    import torch

    from repro_torch.models import (build_cache_specs, build_param_specs,
                                    materialize, prefill)
    from repro_torch.serving import ServingEngine

    tag = f"depth {cfg.n_layers}"
    t0 = time.perf_counter()
    host = materialize(build_param_specs(cfg),
                       torch.Generator().manual_seed(0), "cpu")

    card = _cast(host, DEV)
    print(f"{tag}: {cfg.name} d_model={cfg.d_model} layers="
          f"{cfg.n_layers} float32 weights built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab_size, (prompt_len,),
                           generator=torch.Generator().manual_seed(1)).tolist()
    runs = {}
    for dev, params in (("cpu", host), (DEV, card)):
        with _Recorder(torch) as rec:
            eng = ServingEngine(cfg, params, max_batch=1,
                                max_len=prompt_len + steps + 8, device=dev)
            toks = eng.generate(prompt, max_new=steps + 1).tokens
        runs[dev] = (toks, rec.logits)
    (ct, cl), (gt, gl) = runs["cpu"], runs[DEV]
    assert len(cl) == len(gl) == steps + 1
    worst = 0.0
    for a, c in zip(gl, cl):
        assert bool(torch.isfinite(a).all())
        worst = max(worst, float((a - c).abs().max() / c.abs().max()))
    assert worst <= REL_LOGITS, f"{tag} logits differ by {worst:.3e}"
    assert gt == ct, f"tokens differ: card {gt} vs CPU {ct}"
    print(f"{tag}: prefill of {prompt_len} tokens + {steps} decode steps, "
          f"tokens equal {gt}; logits max |card - CPU| / max|CPU| = "
          f"{worst:.3e} (limit {REL_LOGITS})")
    if not f64:
        return
    # which side the gap comes from: the prefill once more on the CPU in
    # float64 (no gate: a measure of float32 rounding through the model)
    c64 = dataclasses.replace(cfg, param_dtype=torch.float64,
                              compute_dtype=torch.float64)
    caches = materialize(build_cache_specs(c64, 1, prompt_len + steps + 8,
                                           torch.float64),
                         torch.Generator(), "cpu")
    o64, _ = prefill(_cast(host, torch.float64),
                     {"tokens": torch.tensor([prompt])}, caches, c64)
    o64 = o64.float()
    m = o64.abs().max()
    print(f"{tag}: prefill logits against a float64 CPU run, max |x - "
          f"f64| / max|f64|: card {float((gl[0] - o64).abs().max() / m):.3e}"
          f", CPU float32 {float((cl[0] - o64).abs().max() / m):.3e}")


class _Plain:
    """Swaps the plain version ``ref.<op>_ref`` in for ``ops.<op>``
    (which the model calls) and restores the kernel on exit."""

    def __init__(self, op):
        self.op = op

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ops, self.real = ops, getattr(ops, self.op)
        setattr(ops, self.op, getattr(ref, self.op + "_ref"))
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.op, self.real)


def check_bf16_model(cfg, prompt_len=300):
    """A bf16 forward of ``cfg`` (cut in depth, full width) on the card
    with the kernels, then with the plain flash attention swapped in,
    each against a float32 forward of the same weights: the kernel run
    may be no farther from float32 than 2x the plain bf16 run.  The
    prompt is ragged against the 128-row tiles and prefills into a
    longer cache, so the model's cache views reach the sm90 route."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import (build_cache_specs, build_param_specs,
                                    materialize, prefill)

    c16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    w16 = materialize(build_param_specs(c16),
                      torch.Generator().manual_seed(0), DEV)
    w32 = _cast(w16, torch.float32)                 # the same values
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                           generator=torch.Generator().manual_seed(2))

    def forward(c, w):
        caches = materialize(build_cache_specs(c, 1, prompt_len + 16,
                                               c.compute_dtype),
                             torch.Generator(), DEV)
        logits, _ = prefill(w, {"tokens": tokens.to(DEV)}, caches, c)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits).all())
        return logits.float()

    ops.reset_launches()
    kern = forward(c16, w16)
    routes = ops.route_counts()
    n_attn = ops.launch_counts()["flash_attention"]
    assert n_attn > 0 and routes == {"sm90": n_attn, "f32tc": 0,
                                      "simt": 0}, routes
    # a long prompt's scans take the chunked kernel
    n_scan = ops.launch_counts()["rglru_scan"]
    scans = ops.route_counts("rglru_scan")
    assert scans == {"chunked": n_scan, "serial": 0}, scans
    with _Plain("flash_attention"):
        plain = forward(c16, w16)
    f32 = forward(c32, w32)
    m = f32.abs().max()
    d_kern = float((kern - f32).abs().max() / m)
    d_plain = float((plain - f32).abs().max() / m)
    print(f"bf16 {cfg.name} depth {cfg.n_layers}, {prompt_len}-token "
          f"prefill: max |logits - float32| / max|float32| = {d_kern:.3e} "
          f"with the kernels ({n_attn} sm90 flash launches, {n_scan} "
          f"chunked scans), {d_plain:.3e} with the plain flash attention "
          f"(limit 2x)")
    assert d_kern <= 2 * d_plain, (d_kern, d_plain)
    del w16, w32
    torch.cuda.empty_cache()
    return d_kern, d_plain


def check_model_decode(cfg, ctx=2048):
    """One bf16 ``decode_step`` of ``cfg`` (cut in depth, full width) on
    the card at a ``ctx``-row context: its attention layers' decode on
    the split route (counted), each layer's output held against the
    plain version on the model's own q and cache views (2e-2), where a
    wrong combine must fail (``_sees_combine``: the random weights' scores
    spread over hundreds, so each row's softmax sits on its top key and a
    combine that weighs the splits wrongly misses by the values' size);
    then the logits against the same step with the plain
    ``decode_attention`` swapped in, within 2e-2 of their max."""
    import dataclasses
    import math

    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import (build_cache_specs, build_param_specs,
                                    decode_step, materialize, prefill)

    c16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    w = materialize(build_param_specs(c16),
                    torch.Generator().manual_seed(0), DEV)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, ctx + 1),
                           generator=gen).to(DEV)
    n_attn = per_call_launches(cfg)[1]["decode_attention"]
    caches = materialize(build_cache_specs(c16, 1, ctx + 16, torch.bfloat16),
                         torch.Generator(), DEV)
    _, caches = prefill(w, {"tokens": tokens[:, :ctx]}, caches, c16)

    def step():
        # the step writes its row out of place: both steps see one cache
        ops.reset_launches()
        logits, _ = decode_step(w, tokens[:, ctx:], caches, ctx, c16)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits).all())
        return logits.float(), ops.route_counts("decode_attention")

    seen, real = [], ops.decode_attention

    def spy(q, k, v, length):
        out = real(q, k, v, length)
        seen.append((q, k, v, length, out))
        return out

    ops.decode_attention = spy
    try:
        kern, routes = step()
    finally:
        ops.decode_attention = real
    assert routes == {"split": n_attn, "single": 0}, routes
    assert len(seen) == n_attn
    tol = ATTN_TOL["bfloat16"]
    op_err, faults, peak = 0.0, {}, 1.0
    for q, k, v, length, out in seen:
        want = ref.decode_attention_ref(q, k, v, length)
        op_err = max(op_err, _attn_close(out, want, tol,
                                         "model decode views"))
        for name, e in _sees_combine(q, k, v, length, want, tol,
                                     "model decode views").items():
            faults[name] = min(faults.get(name, math.inf), e)
        g = q.shape[1] // k.shape[1]
        p = torch.softmax(torch.einsum(
            "bhd,bhtd->bht", q.float(), k.repeat_interleave(g, 1).float())
            / math.sqrt(q.shape[-1]), -1)
        peak = min(peak, float(p.amax(-1).mean()))
    del seen
    with _Plain("decode_attention"):
        plain, _ = step()
    d_both = float((kern - plain).abs().max() / plain.abs().max())
    print(f"bf16 {cfg.name} depth {cfg.n_layers}, decode_step at a "
          f"{ctx}-row context ({n_attn} split-route decodes; each row's "
          f"largest softmax weight {peak:.4f} on average, least over the "
          f"layers): each layer's decode against the plain version on "
          f"the model's views max abs err {op_err:.3e} (tol {tol}), a "
          f"wrong combine rejected in every layer (least max abs err: "
          + ", ".join(f"{n} {e:.3e}" for n, e in faults.items()) +
          f"); logits against the plain decode_attention's step: max "
          f"|kernel - plain| / max|plain| = {d_both:.3e} (limit {tol})")
    assert d_both <= tol, d_both
    del w, caches
    torch.cuda.empty_cache()
    return d_both


def _cast(tree, to, specs=None):
    """Every leaf of a parameter tree moved to a device or dtype; with
    ``specs`` (a spec tree of the same shape), to device ``to`` in each
    leaf's spec dtype, moved first and cast there (a blocking copy that
    casts too converts on the host and moves the wider leaf)."""
    if isinstance(tree, dict):
        return {k: _cast(v, to, specs and specs[k]) for k, v in tree.items()}
    return tree.to(to) if specs is None else tree.to(to).to(specs.dtype)


def _serve_lines(argv, **kw):
    import contextlib
    import io

    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(argv, **kw) == 0
    out = buf.getvalue().splitlines()
    for line in out:
        print(f"  {line}")
    return out


def profile_serving(arch, requests=3, cfg=None, extras=None):
    """Where the time of a served request goes at full width: the card's
    kernel time by name over a few requests (``torch.profiler``, after a
    warm-up request), against the host clock of the same requests run
    without the profiler.  ``cfg`` (a config cut in depth) replaces the
    full config of ``arch``; ``extras`` go to each request's ``admit``
    (``_request``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import RunFlags, build_param_specs, materialize
    from repro_torch.serving import ServingEngine

    t_all = time.perf_counter()
    cfg = cfg or get_config(arch)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=48,
                        flags=RunFlags(remat="none"), device=DEV)

    def serve():
        for _ in range(requests):
            _request(eng, extras)
        torch.cuda.synchronize()

    serve()                                           # warm-up
    t0 = time.perf_counter()
    serve()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve()
    # device-side events only (kernels, copies): an operator's own device
    # time repeats that of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    if not busy:
        print("profile: the profiler recorded no device time; the idle "
              "share is not measured")
        return
    print(f"profile {arch}: {requests} requests (4 forwards each) took "
          f"{1e3 * wall:.3f} ms of host clock without the profiler; the "
          f"card's kernels took {busy:.3f} ms under it, so the card was "
          f"idle {100 * (1 - busy / (1e3 * wall)):.1f} % of the request "
          f"time (the whole profile, weights and tracing included: "
          f"{time.perf_counter() - t_all:.3f} s)")
    for key, ms, n in rows[:10]:
        print(f"  device {ms:10.3f} ms  {100 * ms / busy:5.1f} %  x{n:<6d} "
              f"{key[:90]}")
    del params, eng
    torch.cuda.empty_cache()


def per_call_launches(cfg):
    """The kernel launches one prefill and one decode step of ``cfg``
    make: each attention layer and each cross-attention block launches
    ``flash_attention`` (prefill) or ``decode_attention`` (decode), each
    encoder layer ``flash_attention`` (prefill), each RG-LRU layer
    ``rglru_scan``; MLA and xLSTM layers launch none (plain PyTorch, as
    plain jnp in the reference)."""
    from repro_torch.models import Mixer
    blocks = [blk for g in cfg.groups for _ in range(g.repeats)
              for blk in g.pattern]
    n_attn = sum(b.mixer == Mixer.ATTN for b in blocks) + \
        sum(b.cross_attention for b in blocks)
    n_rec = sum(b.mixer == Mixer.RGLRU for b in blocks)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    return ({"flash_attention": n_attn + n_enc, "rglru_scan": n_rec},
            {"decode_attention": n_attn, "rglru_scan": n_rec})


def serve_launcher(arch, argv=None, cfg=None):
    """The launcher at full width and depth on the card, counted and
    timed, then its --reduced run on the CPU: the energy lines must be
    equal (the clock and the loader come from the full config's
    checkpoint bytes, not from compute).  Every kernel's launches must
    equal what the recorded prefills and decode steps of ``cfg`` (the
    full config by default) make, and no other kernel may launch.
    Returns the launch counts (one an op call) and the number of
    ``decode_attention``'s combine launches (one a split-route call)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    argv = list(argv or ("--arch", arch, "--hours", "6"))
    per_prefill, per_decode = per_call_launches(cfg or get_config(arch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _Recorder(torch) as rec:
        card = _serve_lines(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = ops.route_counts()
    decodes = ops.route_counts("decode_attention")
    scans = ops.route_counts("rglru_scan")
    pre, dec = rec.calls["prefill"], rec.calls["decode"]
    print(f"launcher {arch} on the card: wall {wall:.3f} s, {len(pre)} "
          f"prefills (mean {1e3 * statistics.mean(pre):.6f} ms, median "
          f"{1e3 * statistics.median(pre):.6f} ms), {len(dec)} decode "
          f"steps (mean {1e3 * statistics.mean(dec):.6f} ms, median "
          f"{1e3 * statistics.median(dec):.6f} ms), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    print(f"launcher {arch} launches {counts}; flash_attention routes "
          f"{routes}, decode_attention routes {decodes}, rglru_scan routes "
          f"{scans}")
    want = {k: per_prefill.get(k, 0) * len(pre) +
            per_decode.get(k, 0) * len(dec) for k in counts}
    assert counts == want, (counts, want)
    # the launchers serve bf16 at head dims the sm90 route takes; their
    # 48-row caches are one split, their 3- and 1-step scans serial
    assert routes == {"sm90": counts["flash_attention"], "f32tc": 0,
                      "simt": 0}, routes
    assert decodes == {"split": 0,
                       "single": counts["decode_attention"]}, decodes
    assert scans == {"chunked": 0, "serial": counts["rglru_scan"]}, scans
    cpu = _serve_lines(argv + ["--reduced"], device="cpu")
    assert card[1] == cpu[1], (card[1], cpu[1])
    print(f"launcher {arch}: energy line equal to the --reduced run on the "
          f"CPU; launches exactly {per_prefill} per prefill and "
          f"{per_decode} per decode step")
    # a split-route decode launches the combine kernel too
    return counts, decodes["split"]


# ---------------------------------------------------------------------------
# Phases 12-14: the dense, vision-language and MoE configs (gemma3-1b,
# granite-20b, command-r-35b, internvl2-26b, mixtral-8x22b).
# ---------------------------------------------------------------------------

GEMMA3, GRANITE, COMMAND_R = "gemma3-1b", "granite-20b", "command-r-35b"
INTERNVL2, MIXTRAL = "internvl2-26b", "mixtral-8x22b"
MIXTRAL_LAYERS = 12        # of 56: ~5.01 GB a layer in bf16, ~61 GB in all
# the launcher's --hours for the new archs: 2 of its default 6 (5 of the
# bursty trace's 123 requests; 3 hours hold 66) keep the whole script
# well inside its limit on a slow host (each request is the same
# ``generate([1, 2, 3], max_new=4)``, so the counts per call are the
# same)
NEW_HOURS = 2.0
# prefills at the new archs' heads, in bf16 (sm90) and float32 (f32tc):
# (label, B, H, Hkv, S, T, D, window, views, causal); ``views`` as in
# SM90_CASES
NEW_FLASH_CASES = (
    ("granite", 1, 48, 1, 300, 300, 128, None, False, True),
    ("granite launcher", 1, 48, 1, 3, 48, 128, None, True, True),
    ("gemma3 local", 1, 4, 1, 600, 600, 256, 512, False, True),
    ("gemma3 global", 1, 4, 1, 600, 600, 256, None, False, True),
    ("gemma3 launcher", 1, 4, 1, 3, 48, 256, 512, True, True),
    ("command-r", 1, 64, 8, 272, 272, 128, None, False, True),
    ("internvl2 / mixtral", 1, 48, 8, 272, 272, 128, None, False, True),
)
# decodes at the new archs' heads: (label, B, H, Hkv, T, D, lengths,
# views, route); the launchers' and Mixtral's engine's 48-row caches (read
# through [B,T,Hkv,D] views) take one split; internvl2's 280-row cache
# (256 prefix + 16 prompt + 8 steps; lengths 273-280 on the main path)
# and T = 4096 take several
NEW_DECODE_CASES = (
    ("granite", 4, 48, 1, 48, 128, (48, 30, 6, 1), True, "single"),
    ("granite", 4, 48, 1, 4096, 128, DECODE_RAGGED, False, "split"),
    ("gemma3", 4, 4, 1, 48, 256, (48, 30, 6, 1), True, "single"),
    ("gemma3", 4, 4, 1, 4096, 256, DECODE_RAGGED, False, "split"),
    ("command-r", 4, 64, 8, 48, 128, (48, 30, 6, 1), True, "single"),
    ("mixtral", 4, 48, 8, 48, 128, (48, 30, 6, 1), True, "single"),
    ("internvl2", 4, 48, 8, 280, 128, (280, 277, 275, 273), True, "split"),
)


def _qkv(b, h, hkv, s, t, d, views, seed, dt, torch):
    """q [B,H,S,D], k and v [B,Hkv,T,D], contiguous or (``views``) read
    through [B,S|T,heads,D] tensors."""
    if views:
        return (_randn((b, s, h, d), seed, dt, torch).transpose(1, 2),
                _randn((b, t, hkv, d), seed + 1, dt, torch).transpose(1, 2),
                _randn((b, t, hkv, d), seed + 2, dt, torch).transpose(1, 2))
    return (_randn((b, h, s, d), seed, dt, torch),
            _randn((b, hkv, t, d), seed + 1, dt, torch),
            _randn((b, hkv, t, d), seed + 2, dt, torch))


def check_new_shapes(stats, flash_cases=NEW_FLASH_CASES,
                     decode_cases=NEW_DECODE_CASES):
    """Phase 12 (and 15, with whisper's cases): both attention kernels at
    the new archs' head groups (48, 8, 6, 4 and 1 query heads a kv head),
    head dims, gemma3's 512-token window and whisper's non-causal
    prefills, in bf16 and float32 against their plain versions (phase 5's
    tolerances), each call's route asserted.  A decode over several
    splits is also run on the single route (a raw call of the kernel with
    one split, on the same inputs), and with queries x4 the planted wrong
    combines of ``_sees_combine`` must fail."""
    import torch

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref

    for dt in (torch.bfloat16, torch.float32):
        tol = ATTN_TOL[str(dt).split(".")[-1]]
        for i, (label, b, h, hkv, s, t, d, window, views, causal) in \
                enumerate(flash_cases):
            q, k, v = _qkv(b, h, hkv, s, t, d, views, 400 + 3 * i, dt, torch)
            got = _flash_routed(q, k, v, window, causal)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            torch.cuda.synchronize()
            err = _attn_close(got, want, tol, f"flash {label} {dt}")
            kernel = fmod.route(dt, d)
            row = stats[_flash_row(kernel)]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            print(f"flash_attention  {str(dt):14s} {label:20s} B,H,Hkv,S,T,"
                  f"D={(b, h, hkv, s, t, d)} window={window} views={views}"
                  f" causal={causal} ({kernel}): max abs err {err:.3e} "
                  f"(tol {tol})")
        for i, (label, b, h, hkv, t, d, lengths, views, way) in \
                enumerate(decode_cases):
            _, k, v = _qkv(b, h, hkv, 1, t, d, views, 500 + 3 * i, dt, torch)
            length = torch.tensor(lengths, dtype=torch.int32, device=DEV)
            pl = dmod.plan(b, h, hkv, t, d, dmod._sms(k.device))
            assert (pl.splits > 1) == (way == "split"), (label, t, pl)
            for qs in (1, 4):
                q = _randn((b, h, d), 600 + i, dt, torch) * qs
                got = _decode_routed(q, k, v, length, way)
                want = ref.decode_attention_ref(q, k, v, length)
                torch.cuda.synchronize()
                errs = {way: _attn_close(got, want, tol,
                                         f"{way} decode {label} {dt}")}
                seen = ""
                if way == "split":
                    out = torch.empty_like(q)
                    one = dmod.Plan(1, -(-t // dmod.TILE) * dmod.TILE)
                    _raw_decode(q, k, v, length, out, one)()
                    torch.cuda.synchronize()
                    errs["single"] = _attn_close(
                        out, want, tol, f"single decode {label} {dt}")
                    if qs > 1:
                        faults = _sees_combine(q, k, v, length, want, tol,
                                               f"split decode {label} {dt}")
                        seen = "; the check rejects a wrong combine: " + \
                            ", ".join(f"{n} max abs err {e:.3e}"
                                      for n, e in faults.items())
                stats["decode_attention"]["max_abs_err"] = max(
                    stats["decode_attention"]["max_abs_err"], *errs.values())
                print(f"decode_attention {str(dt):14s} {label:9s} B,H,Hkv,T,"
                      f"D={(b, h, hkv, t, d)} length={list(lengths)} views="
                      f"{views} q x{qs}, {pl.splits} splits: max abs err "
                      + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
                      + f" (tol {tol}){seen}")


class _Drops:
    """Wraps ``models.moe._router`` and records, for every routed call on
    DEV, (tokens a sequence, capacity, assignments, assignments past
    capacity): the one-hot dispatch keeps min(count, capacity) of each
    (sequence, expert)'s assignments, slot 0 first, and drops the rest."""

    def __enter__(self):
        import math

        import torch

        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe._router, []

        def spy(p, x, m, tp=None):
            gates, idx, aux = self.real(p, x, m, tp)
            if x.device.type == torch.device(DEV).type:
                s = x.shape[1]
                cap = max(int(math.ceil(s * m.top_k * m.capacity_factor /
                                        m.n_experts)), 1)
                n = torch.nn.functional.one_hot(idx, m.n_experts).sum((1, 2))
                self.calls.append((s, cap, idx.numel(),
                                   int((n - cap).clamp_min(0).sum())))
            return gates, idx, aux

        moe._router = spy
        return self

    def __exit__(self, *exc):
        self.moe._router = self.real


def _host_free_bytes():
    import os
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _model_generate(cfg, params, tokens, steps, dev, prefix=None,
                    forced=None, source=None):
    """A prefill of ``tokens`` [B, S] (after ``prefix`` embeddings where
    given: the model level, as the engine cannot serve them; against
    ``source`` frame embeddings [B, T, D] for an encoder) on ``dev``,
    then ``steps`` decode steps at ``pos = n_prefix + S + i``, each fed
    the last greedy token or, with ``forced`` [B, steps], the given one.
    Returns (greedy tokens [B, steps + 1], the logits of every call on
    the host, the host seconds of each prefill and decode call)."""
    import torch

    from repro_torch.models import (build_cache_specs, decode_step,
                                    materialize, prefill)
    b, s = tokens.shape
    n = 0 if prefix is None else prefix.shape[1]
    batch = {"tokens": tokens.to(dev)}
    if prefix is not None:
        batch["prefix_embeds"] = prefix.to(dev)
    if source is not None:
        batch["source_embeds"] = source.to(dev)
    caches = materialize(build_cache_specs(cfg, b, n + s + steps,
                                           cfg.compute_dtype),
                         torch.Generator(), dev)
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch, caches, cfg)
    sync()
    secs = {"prefill": [time.perf_counter() - t0], "decode": []}
    out, toks = [logits.float().cpu()], [torch.argmax(logits, -1)]
    for i in range(steps):
        feed = toks[-1] if forced is None else forced[:, i].to(dev)
        t0 = time.perf_counter()
        logits, caches = decode_step(params, feed[:, None], caches,
                                     n + s + i, cfg)
        sync()
        secs["decode"].append(time.perf_counter() - t0)
        out.append(logits.float().cpu())
        toks.append(torch.argmax(logits, -1))
    return torch.stack(toks, 1).cpu(), out, secs


def _attention64(q, k, v, mask, softcap=None):
    """softmax(cap(q k^T / sqrt(D)), where ``mask``) v in float64:
    q [B,H,S,D], k and v [B,Hkv,T,D], ``mask`` broadcasting to
    [B,H,S,T], ``softcap`` c capping the scores at c tanh(s / c) (the
    plain versions compute in float32 whatever their inputs)."""
    import math

    import torch

    from repro_torch.kernels import ref
    g = q.shape[1] // k.shape[1]
    kk = k.double().repeat_interleave(g, dim=1)
    vv = v.double().repeat_interleave(g, dim=1)
    scores = ref.cap_scores(torch.einsum("bhsd,bhtd->bhst", q.double(), kk)
                            / math.sqrt(q.shape[-1]), softcap)
    w = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, vv)


def _flash64(q, k, v, causal=True, window=None, softcap=None, q_offset=0):
    """``flash_attention``'s function in float64."""
    import torch
    s, t = q.shape[2], k.shape[2]
    i = q_offset + torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = (j <= i) if causal else torch.ones_like(i - j, dtype=bool)
    if window is not None:
        mask = mask & (i - j < window)
    return _attention64(q, k, v, mask, softcap)


def _decode64(q, k, v, length, softcap=None):
    """``decode_attention``'s function in float64."""
    import torch
    lens = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    mask = torch.arange(k.shape[2], device=q.device)[None] < lens
    return _attention64(q[:, :, None], k, v, mask[:, None, None],
                        softcap)[:, :, 0]


class _Exact:
    """Swaps float64 attention in for both ``ops`` attention functions
    (which the model calls), cast back to the query's dtype."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.real = ops, (ops.flash_attention, ops.decode_attention)
        ops.flash_attention = lambda q, k, v, *, causal=True, window=None, \
            softcap=None, q_offset=0: _flash64(
                q, k, v, causal, window, softcap, q_offset).to(q.dtype)
        ops.decode_attention = lambda q, k, v, length, *, softcap=None: \
            _decode64(q, k, v, length, softcap).to(q.dtype)
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.decode_attention = self.real


class _KernelSpy:
    """Holds every attention kernel call the model makes on the card
    against float64 attention on the same inputs (the model's own q and
    cache views): the kernel's max abs error at most phase 5's tolerance
    times the output's max magnitude, failing on the first call beyond
    it.  (The random weights give these models' attention scores a
    spread of hundreds and values of ~100, where a few float32 ulps of a
    score move an output by ~1e-2: a tolerance set for unit-normal
    inputs is scaled by the output here.)  Keeps, for each kernel, the
    calls, the worst error over the max of the kernel and of the float32
    plain version on the same inputs, and in how many calls the kernel
    was the farther of the two (by more than 5 %)."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops, ref
        self.ops, self.real = ops, (ops.flash_attention, ops.decode_attention)
        self.seen = {n: {"calls": 0, "kernel": 0.0, "plain": 0.0,
                         "farther": 0}
                     for n in ("flash_attention", "decode_attention")}

        def held(name, out, want, exact):
            tol = ATTN_TOL[str(out.dtype).split(".")[-1]]
            m = float(exact.abs().max())
            e_k = float((out.double() - exact).abs().max())
            e_p = float((want.double() - exact).abs().max())
            assert bool(torch.isfinite(out).all()) and e_k <= tol * m, \
                (name, e_k, e_p, m, tol)
            st = self.seen[name]
            st["calls"] += 1
            st["kernel"] = max(st["kernel"], e_k / m)
            st["plain"] = max(st["plain"], e_p / m)
            st["farther"] += int(e_k > 1.05 * e_p)
            return out

        def flash(q, k, v, *, causal=True, window=None, softcap=None,
                  q_offset=0):
            kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)
            return held("flash_attention", self.real[0](q, k, v, **kw),
                        ref.flash_attention_ref(q, k, v, **kw),
                        _flash64(q, k, v, **kw))

        def decode(q, k, v, length, *, softcap=None):
            return held("decode_attention",
                        self.real[1](q, k, v, length, softcap=softcap),
                        ref.decode_attention_ref(q, k, v, length,
                                                 softcap=softcap),
                        _decode64(q, k, v, length, softcap))

        ops.flash_attention, ops.decode_attention = flash, decode
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.decode_attention = self.real

    def line(self):
        return "; ".join(
            f"{n} {st['calls']} calls, worst max abs err {st['kernel']:.3e}"
            f" of the max (float32 plain version {st['plain']:.3e}), "
            f"kernel farther than plain in {st['farther']}"
            for n, st in self.seen.items())




def check_depth(cfg, prompt_len=48, steps=8, prefix=False, card_ctx=None,
                f64_limit=REL_LOGITS, cpu_gate=True, source=False,
                weights=None, cpu=True):
    """Phase 13's (and 16's) check of one config cut in depth (float32,
    full width).

    The card serves a prompt and ``steps`` greedy decode steps through
    ``ServingEngine`` (or, with ``prefix`` embeddings or an encoder's
    ``source`` frame embeddings from a seed, at the model level), every
    attention kernel call held against float64 attention on the same
    inputs (``_KernelSpy``); the calls must be exactly those
    ``per_call_launches`` gives (none for MLA and xLSTM).  ``weights``,
    where given, changes the random weights in place before the run
    (``_fan_in_d_model``).  The CPU in float32
    and a float64 run (on the card, attention in float64; the model's
    float32 leaves, norms, rope angles and router stay float32, as it
    defines them) then replay the same calls, fed the card's tokens.
    The card's logits must be within ``f64_limit`` of the float64 run's
    (max abs over max|f64|); wherever the float64 top-two gap exceeds
    twice a side's max abs distance, that side's greedy token must be
    float64's (no rounding can flip it there).  With ``cpu_gate``,
    ``serve_depth``'s gate too: the card's logits within REL_LOGITS of
    the CPU's and every greedy token equal; without it (gemma3) that
    distance is printed only.  Without ``cpu`` there is no CPU replay
    (and no CPU gate): the card against float64 alone."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.models import build_param_specs, materialize
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    tag = f"depth {cfg.n_layers}: {cfg.name}" + \
        (f" ({weights.__name__})" if weights is not None else "")
    card = materialize(build_param_specs(cfg),
                       torch.Generator().manual_seed(0), DEV)
    if weights is not None:
        weights(card, cfg)
    host = _cast(card, "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=g)
    pre = torch.randn((1, cfg.n_prefix_embeddings, cfg.d_model),
                      generator=g) if prefix else None
    src = torch.randn((1, cfg.encoder.source_len, cfg.d_model),
                      generator=g) if source else None
    with _KernelSpy() as spy, card_ctx or contextlib.nullcontext():
        if prefix or source:
            toks, card_l, _ = _model_generate(cfg, card, tokens, steps, DEV,
                                              prefix=pre, source=src)
        else:
            with _Recorder(torch) as rec:
                eng = ServingEngine(cfg, card, max_batch=1,
                                    max_len=prompt_len + steps + 8,
                                    device=DEV)
                toks = torch.tensor([eng.generate(tokens[0].tolist(),
                                                  max_new=steps + 1).tokens])
            card_l = rec.logits
            del eng
    del card
    _free_card()
    fed = toks[:, :steps]
    cpu_l = _model_generate(cfg, host, tokens, steps, "cpu", prefix=pre,
                            forced=fed, source=src)[1] if cpu else card_l
    cpu_gate = cpu_gate and cpu
    c64 = dataclasses.replace(cfg, param_dtype=torch.float64,
                              compute_dtype=torch.float64)
    # each leaf in its float64 spec's dtype: the float32 leaves (norm
    # scales, the MoE router) stay float32, as the model defines them
    w64 = _cast(host, DEV, build_param_specs(c64))
    del host
    with _Exact():
        f64_l = _model_generate(c64, w64, tokens, steps, DEV, prefix=pre,
                                forced=fed, source=src)[1]
    del w64
    _free_card()
    assert len(card_l) == len(cpu_l) == len(f64_l) == steps + 1
    d_card, d_cpu, d_both, flips, ties = 0.0, 0.0, 0.0, 0, 0
    for i, (gl, cl, rl) in enumerate(zip(card_l, cpu_l, f64_l)):
        assert bool(torch.isfinite(gl).all())
        m = float(rl.abs().max())
        top2 = torch.topk(rl, 2, dim=-1).values
        gap = float((top2[..., 0] - top2[..., 1]).min())
        for side, lg in (("card", gl), ("CPU", cl)):
            err = float((lg - rl).abs().max())
            if gap > 2 * err:
                assert torch.equal(torch.argmax(lg, -1),
                                   torch.argmax(rl, -1)), (tag, side, i)
            else:
                ties += 1
        d_card = max(d_card, float((gl - rl).abs().max()) / m)
        d_cpu = max(d_cpu, float((cl - rl).abs().max()) / m)
        d_both = max(d_both, float((gl - cl).abs().max() / cl.abs().max()))
        flips += int(not torch.equal(torch.argmax(gl, -1),
                                     torch.argmax(cl, -1)))
    extra = ""
    if prefix:
        extra = f" after {cfg.n_prefix_embeddings} prefix embeddings"
    if source:
        extra = f" against {cfg.encoder.source_len} source frames"
    print(f"{tag} d_model={cfg.d_model} float32, {prompt_len}-token prompt"
          f"{extra}"
          f" + {steps} decode steps ({time.perf_counter() - t0:.1f} s): "
          f"kernel calls against float64 attention on the same inputs "
          f"(limit {ATTN_TOL['float32']} of the max): {spy.line()}; "
          f"logits max |x - f64| / max|f64|: card {d_card:.3e} (limit "
          f"{f64_limit}), CPU float32 {d_cpu:.3e}; greedy tokens equal "
          f"float64's wherever its top-two gap exceeds twice the distance "
          f"({ties} of {2 * (steps + 1)} side-calls closer); card against "
          f"CPU: max |card - CPU| / max|CPU| = {d_both:.3e}, {flips} of "
          f"{steps + 1} greedy tokens differ ("
          + (f"limit {REL_LOGITS}, none" if cpu_gate else "not gated" if cpu
             else "no CPU run: the card's own logits") +
          f"); card tokens {toks[0].tolist()}")
    per_prefill, per_decode = per_call_launches(cfg)
    assert spy.seen["flash_attention"]["calls"] == \
        per_prefill["flash_attention"], spy.seen
    assert spy.seen["decode_attention"]["calls"] == \
        steps * per_decode["decode_attention"], spy.seen
    assert d_card <= f64_limit, (tag, d_card, f64_limit)
    if cpu_gate:
        assert d_both <= REL_LOGITS and flips == 0, (tag, d_both, flips)
    return d_card, d_cpu, d_both


def check_new_depths():
    """Phase 13: the new archs at full width, cut in depth, float32, the
    card against a float64 run and (but for gemma3) the CPU
    (``check_depth``)."""
    import torch

    from repro_torch.models import build_param_specs, param_bytes

    f32 = torch.float32
    check_depth(cut_depth(GRANITE, 2, f32))
    # one (5 local + 1 global) superlayer; 600 tokens, past the 512 window
    # in prefill and in every decode step.  At the reference's init law
    # the model is chaotic in float32 (two float64 runs, on the CPU and
    # on the card, differ by 0.227 of the max; a one-ulp move of the
    # weights moves the card's float32 logits 1.6e-3 to 4.6e-2), so that
    # run holds each kernel call and prints the logits ungated; at the
    # fan-in law over d_model it takes every gate, as whisper and xlstm
    # do in phase 16
    gemma3 = cut_depth(GEMMA3, 6, f32)
    check_depth(gemma3, prompt_len=600, f64_limit=math.inf, cpu_gate=False)
    check_depth(gemma3, prompt_len=600, weights=_fan_in_d_model)
    # one layer; a 48-token prompt: capacity ceil(48 * 2 * 1.25 / 8) = 15
    drops = _Drops()
    check_depth(cut_depth(MIXTRAL, 1, f32), card_ctx=drops)
    pre = next(c for c in drops.calls if c[0] > 1)
    dec = [c for c in drops.calls if c[0] == 1]
    print(f"depth 1: mixtral prefill routed {pre[2]} assignments of "
          f"{pre[0]} tokens at capacity {pre[1]}: {pre[3]} dropped; decode "
          f"steps dropped {sum(c[3] for c in dec)} of "
          f"{sum(c[2] for c in dec)}")
    assert pre[:2] == (48, 15) and dec
    assert not any(c[3] for c in dec)
    check_depth(cut_depth(INTERNVL2, 2, f32), prompt_len=16, prefix=True)
    cfg = cut_depth(COMMAND_R, 2, f32)
    need = param_bytes(build_param_specs(cfg))
    free = _host_free_bytes()
    if free < 1.5 * need:
        print(f"depth 2: command-r-35b not checked: its float32 weights "
              f"take {need} B of host memory and {free} B are free")
        return False
    check_depth(cfg)
    return True


def _free_card():
    """Drop what the last phase left (the launchers' weights sit in
    reference cycles until a collection) and return the card's cache."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _launcher_requests(hours):
    """The requests the launcher serves: one at time 0, then one per
    arrival of its bursty trace (seed 0) before ``hours``."""
    from repro_torch.core import traffic
    return 1 + sum(a < hours * 3600.0
                   for a in traffic.PATTERNS["bursty"](seed=0))


def serve_internvl2():
    """internvl2-26b at full width and depth in bf16, at the model level:
    B=4, 256 prefix embeddings + a 16-token prompt, then 8 decode steps,
    counts reset just before and read just after: 48 ``flash_attention``
    launches (sm90) for the prefill and 48 ``decode_attention`` launches
    a decode step.  Returns the launch counts and the combine launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_param_specs, materialize

    cfg = get_config(INTERNVL2)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    # token ids and unit-normal prefix embeddings from a fixed seed (the
    # vision tower is a stub in both packages)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
    prefix = torch.randn((4, cfg.n_prefix_embeddings, cfg.d_model),
                         generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    toks, logits, secs = _model_generate(cfg, params, tokens, 8, DEV,
                                         prefix=prefix)
    counts = ops.launch_counts()
    routes = ops.route_counts()
    decodes = ops.route_counts("decode_attention")
    n = cfg.n_layers
    want = {k: 0 for k in counts}
    want.update(flash_attention=n, decode_attention=8 * n)
    assert counts == want, (counts, want)
    assert routes == {"sm90": n, "f32tc": 0, "simt": 0}, routes
    assert all(bool(torch.isfinite(x).all()) and x.shape == (
        4, cfg.vocab_size) for x in logits)
    print(f"internvl2-26b full width and depth (bf16, model level): B=4, "
          f"{cfg.n_prefix_embeddings} prefix + 16 tokens, prefill "
          f"{1e3 * secs['prefill'][0]:.6f} ms, 8 decode steps (mean "
          f"{1e3 * statistics.mean(secs['decode']):.6f} ms, median "
          f"{1e3 * statistics.median(secs['decode']):.6f} ms), "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
          f"launches {counts}; flash routes {routes}, decode routes "
          f"{decodes}; tokens {toks.tolist()}")
    del params
    _free_card()
    return counts, decodes["split"]


def _request(eng, extras=None):
    """One launcher request, ``generate([1, 2, 3], max_new=4)``, with
    ``extras`` (whisper's frames) passed to ``admit``; its tokens."""
    if extras is None:
        return eng.generate([1, 2, 3], max_new=4).tokens
    slot = eng.admit([1, 2, 3], extras=extras)
    toks = [int(eng._slot_last[slot])]
    for _ in range(3):
        toks.append(eng.step()[slot])
    eng.release(slot)
    return toks


def serve_engine(cfg, label, extras=None, requests=24):
    """``cfg`` at full width in bf16 through ``ServingEngine`` with the
    launcher's settings (4 slots, 48 cache rows) on ``requests`` of the
    launcher's requests (``_request``, with ``extras`` for admit),
    counts reset just before and read just after: each kernel's launches
    exactly those ``per_call_launches`` gives per recorded prefill and
    decode step, every prefill on the sm90 route; the MoE dispatch's
    drops of one more request (untimed) printed.  Returns the launch
    counts and the decode routes."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import (RunFlags, build_param_specs,
                                    materialize)
    from repro_torch.serving import ServingEngine

    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=48,
                        flags=RunFlags(remat="none"), device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _Recorder(torch) as rec:
        toks = [_request(eng, extras) for _ in range(requests)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = ops.route_counts()
    decodes = ops.route_counts("decode_attention")
    with _Drops() as drops:
        assert _request(eng, extras) == toks[0]
    pre, dec = rec.calls["prefill"], rec.calls["decode"]
    assert len(pre) == requests and all(len(t) == 4 for t in toks)
    assert all(bool(torch.isfinite(x).all()) and x.shape[-1] ==
               cfg.vocab_size for x in rec.logits)
    per_prefill, per_decode = per_call_launches(cfg)
    want = {k: per_prefill.get(k, 0) * len(pre) +
            per_decode.get(k, 0) * len(dec) for k in counts}
    assert counts == want, (counts, want)
    assert routes == {"sm90": counts["flash_attention"], "f32tc": 0,
                      "simt": 0}, routes
    dropped = ""
    if drops.calls:
        dropped = (f"; one request's one-hot dispatch dropped "
                   f"{sum(c[3] for c in drops.calls)} of "
                   f"{sum(c[2] for c in drops.calls)} assignments")
    print(f"{label} (bf16, ServingEngine, {requests} launcher requests): "
          f"wall {wall:.3f} s, {len(pre)} prefills (mean "
          f"{1e3 * statistics.mean(pre):.6f} ms, median "
          f"{1e3 * statistics.median(pre):.6f} ms), {len(dec)} decode steps "
          f"(mean {1e3 * statistics.mean(dec):.6f} ms, median "
          f"{1e3 * statistics.median(dec):.6f} ms), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches {counts} "
          f"(exactly {per_prefill} a prefill, {per_decode} a decode step); "
          f"flash routes {routes}, decode routes {decodes}; tokens "
          f"{toks[0]}{dropped}")
    del params, eng
    _free_card()
    return counts, decodes


def serve_new_archs():
    """Phase 14: the new archs at full width on the card.  Returns the
    launch counts of each run and the combine launches in all."""
    import torch

    counts, combines = {}, 0
    for arch in (GEMMA3, GRANITE, COMMAND_R):
        counts[arch], c = serve_launcher(
            arch, argv=("--arch", arch, "--hours", str(NEW_HOURS)))
        combines += c
        _free_card()            # (their profiles: PERF.md section 5)
    counts[INTERNVL2], c = serve_internvl2()
    combines += c
    # Mixtral at MIXTRAL_LAYERS of 56 on the launcher's requests over
    # NEW_HOURS, every decode on the single route (48 cache rows)
    cfg = cut_depth(MIXTRAL, MIXTRAL_LAYERS, torch.bfloat16)
    label = f"{MIXTRAL} ({MIXTRAL_LAYERS} of 56 layers)"
    counts[MIXTRAL], decodes = serve_engine(
        cfg, label, requests=_launcher_requests(NEW_HOURS))
    assert decodes == {"split": 0,
                       "single": counts[MIXTRAL]["decode_attention"]}, decodes
    _free_card()
    return counts, combines


# ---------------------------------------------------------------------------
# Phases 15-17: MLA (minicpm3-4b, deepseek-v2-236b), the encoder-decoder
# whisper-base and xLSTM (xlstm-125m).
# ---------------------------------------------------------------------------

MINICPM3, DEEPSEEK = "minicpm3-4b", "deepseek-v2-236b"
WHISPER, XLSTM = "whisper-base", "xlstm-125m"
DEEPSEEK_LAYERS = 7        # of 60: ~7.95 GB a layer in bf16, ~57.7 GB in all
# the launcher's --hours for minicpm3 and xlstm (5 requests, as NEW_HOURS);
# the engine runs (whisper, deepseek) take ``serve_engine``'s 24 requests
SLICE9_HOURS = 2.0
# whisper's prefills, bf16 (sm90) and float32 (f32tc), as NEW_FLASH_CASES:
# the encoder's bidirectional layer over the 1500 frames (a ragged tail
# on both axes), the decoder's cross prefill of the launcher's 3 tokens
# against them and its causal self prefill against 48 cache rows, both
# through [B,S|T,heads,D] views, and a causal self prefill at S = T = 300
WHISPER_FLASH_CASES = (
    ("whisper encoder", 1, 8, 8, 1500, 1500, 64, None, True, False),
    ("whisper cross", 1, 8, 8, 3, 1500, 64, None, True, False),
    ("whisper self", 1, 8, 8, 3, 48, 64, None, True, True),
    ("whisper self 300", 1, 8, 8, 300, 300, 64, None, False, True),
)
# whisper's decodes, as NEW_DECODE_CASES: the cross decode of the engine's
# 4 slots over all 1500 encoder rows (split), the self decode over its
# 48-row cache (single), both through views
WHISPER_DECODE_CASES = (
    ("whisper cross", 4, 8, 8, 1500, 64, (1500,) * 4, True, "split"),
    ("whisper self", 4, 8, 8, 48, 64, (48, 30, 6, 1), True, "single"),
)


def _fan_in_d_model(params, cfg, specs=None):
    """Scale every [d_model, heads, head_dim] input projection (q, k, v
    of attention and cross-attention, the xLSTM blocks' projections and
    gates), in place, from the reference's init law -- fan-in read at
    the heads axis, std 1/sqrt(heads) -- to the fan-in law over d_model,
    1/sqrt(d_model): whisper's scores then spread over ~1 instead of
    ~64, and xLSTM's gates leave saturation."""
    from repro_torch.models import build_param_specs
    specs = specs or build_param_specs(cfg)
    for key, sub in params.items():
        if isinstance(sub, dict):
            _fan_in_d_model(sub, cfg, specs[key])
        elif specs[key].axes[-3:-1] in (("embed", "heads"),
                                        ("embed", "kv_heads")):
            sub.mul_((sub.shape[-2] / sub.shape[-3]) ** 0.5)


def check_slice9_depths():
    """Phase 16: the new archs at full width in float32, the card
    against the CPU and a float64 run (``check_depth``): whisper-base and
    xlstm-125m at full depth (whisper at the model level against 1500
    source frames from a seed; its groups are ``enc`` and ``dec``, which
    ``cut_depth`` does not cut), minicpm3-4b at depth 2, deepseek-v2 at
    depth 1 (about 20 GB of float32 on the host) where the host has the
    memory, else the reason is printed.  Returns whether deepseek ran.

    Whisper and xlstm run twice.  With the reference's init law their
    [d_model, heads, head_dim] projections are sqrt(d_model / heads)
    times the fan-in law over d_model (fan-in read at the 8 or 4 heads:
    8x for whisper, 13.9x for xlstm), and the models are chaotic in
    float32: whisper's scores spread over ~64 and its float32 runs on
    the card and on the CPU land ~1.2 of the max from float64 and from
    each other, though each kernel call is within ~3e-5 of float64 on
    its own inputs; xlstm's saturated gates put its float32 runs 1e-2
    to 1e-1 from float64.  So that run holds each
    kernel call (``_KernelSpy``) and prints the logits' distances
    ungated; the second, with those projections at the fan-in law over
    d_model (``_fan_in_d_model``), takes every gate."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_param_specs, param_bytes

    f32 = torch.float32
    full = {a: dataclasses.replace(get_config(a), param_dtype=f32,
                                   compute_dtype=f32)
            for a in (WHISPER, XLSTM)}
    for arch in (WHISPER, XLSTM):
        check_depth(full[arch], source=arch == WHISPER, f64_limit=math.inf,
                    cpu_gate=False)
        check_depth(full[arch], source=arch == WHISPER,
                    weights=_fan_in_d_model)
    check_depth(cut_depth(MINICPM3, 2, f32))
    cfg = cut_depth(DEEPSEEK, 1, f32)
    need = param_bytes(build_param_specs(cfg))
    free = _host_free_bytes()
    if free < 1.5 * need:
        print(f"depth 1: deepseek-v2-236b not checked: its float32 weights "
              f"take {need} B of host memory and {free} B are free")
        return False
    drops = _Drops()
    check_depth(cfg, card_ctx=drops)
    pre = next(c for c in drops.calls if c[0] > 1)
    print(f"depth 1: deepseek-v2 prefill routed {pre[2]} assignments of "
          f"{pre[0]} tokens at capacity {pre[1]}: {pre[3]} dropped; decode "
          f"steps dropped {sum(c[3] for c in drops.calls if c[0] == 1)}")
    return True


def serve_slice9():
    """Phase 17: the new archs at full width in bf16, counted as phase 7
    (their profiles: PERF.md section 5): the minicpm3-4b (62
    layers) and xlstm-125m (12) launchers at ``--hours`` SLICE9_HOURS
    (no kernel launch at all: MLA and xLSTM are plain PyTorch),
    whisper-base through
    ``ServingEngine`` with frames from a seed as extras (18
    ``flash_attention`` launches a prefill, all sm90; 12
    ``decode_attention`` a step, 6 split and 6 single), deepseek-v2 at
    DEEPSEEK_LAYERS of its 60 layers through ``ServingEngine`` (none).
    Returns the launch counts of each run and the combine launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dmod

    counts, combines = {}, 0
    for arch in (MINICPM3, XLSTM):
        counts[arch], c = serve_launcher(
            arch, argv=("--arch", arch, "--hours", str(SLICE9_HOURS)))
        assert sum(counts[arch].values()) == 0, counts[arch]
        combines += c
        _free_card()            # (their profiles: PERF.md section 5)
    cfg = get_config(WHISPER)
    # frame embeddings from a seed (the audio frontend is a stub in both
    # packages)
    extras = {"source_embeds": torch.randn(
        (1, cfg.encoder.source_len, cfg.d_model),
        generator=torch.Generator().manual_seed(5))}
    counts[WHISPER], decodes = serve_engine(cfg, WHISPER, extras)
    # a step's cross decodes (one a decoder layer) over the 4 slots' 1500
    # encoder rows take the route the plan gives (split), its self
    # decodes over the 48 cache rows single
    n_cross = cfg.n_layers
    steps = counts[WHISPER]["decode_attention"] // (2 * n_cross)
    cross = dmod.plan(4, cfg.n_heads, cfg.n_kv_heads, cfg.encoder.source_len,
                      cfg.head_dim_, dmod._sms(torch.device(DEV)))
    want = {"split": 0, "single": n_cross * steps}
    want["split" if cross.splits > 1 else "single"] += n_cross * steps
    assert decodes == want, (decodes, want)
    combines += decodes["split"]
    _free_card()
    cfg = cut_depth(DEEPSEEK, DEEPSEEK_LAYERS, torch.bfloat16)
    label = f"{DEEPSEEK} ({DEEPSEEK_LAYERS} of 60 layers)"
    counts[DEEPSEEK], _ = serve_engine(cfg, label)
    assert sum(counts[DEEPSEEK].values()) == 0, counts[DEEPSEEK]
    _free_card()
    return counts, combines


def _compare_days(got, want, label, show=True):
    """The torch backend against the numpy backend on one day; returns
    the largest relative carbon/tier difference."""
    assert got.requests == want.requests, (got.requests, want.requests)
    assert got.cold_starts == want.cold_starts
    for gd, wd in zip(got.devices, want.devices):
        assert gd.energy_wh == wd.energy_wh, gd.instance_id   # bit-equal
        assert gd.durations_s == wd.durations_s, gd.instance_id
    assert got.energy_wh == want.energy_wh
    assert got.cost_usd == want.cost_usd
    assert got.gpu_hours_usd == want.gpu_hours_usd
    assert got.energy_usd == want.energy_usd

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-300)

    worst = rel(got.carbon_kg, want.carbon_kg)
    assert len(got.carbon_timeline) == len(want.carbon_timeline)
    for (tg, cg), (tw, cw) in zip(got.carbon_timeline, want.carbon_timeline):
        assert tg == tw
        worst = max(worst, rel(cg, cw))
    for gd, wd in zip(got.devices, want.devices):
        worst = max(worst, rel(gd.carbon_kg, wd.carbon_kg))
    for k, v in want.tier_billed_s.items():
        worst = max(worst, rel(got.tier_billed_s[k], v))
    assert worst <= REL_DAY, f"{label}: carbon/tier drift {worst:.3e}"
    import math
    assert math.isfinite(got.carbon_kg) and got.energy_wh > 0
    if show:
        print(f"{label}: {got.requests:,} requests, {got.cold_starts} cold "
              f"starts, {len(got.devices)} devices; energy/seconds per "
              f"(device, state) bit-equal, cost equal (${got.cost_usd!r}), "
              f"carbon/timeline/tier max rel diff {worst:.3e}")
    return worst


def _drive(scenario_fn, label, **kw):
    """Numpy backend, then the torch backend on the card (launch counts
    reset just before the torch run and read just after)."""
    import torch

    from repro_torch.fleet import run_mega
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    want = run_mega(scenario_fn(), backend="numpy", **kw)
    t_np = time.perf_counter() - t0
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got = run_mega(scenario_fn(), backend="torch", device=DEV, **kw)
    torch.cuda.synchronize()
    t_cu = time.perf_counter() - t0
    launches = ops.launch_counts()
    for tag, res, wall in (("numpy", want, t_np), ("torch/cuda", got, t_cu)):
        pt = {k: round(v, 6) for k, v in res.phase_timings.items()}
        print(f"{label} [{tag}] wall {wall:.3f} s; phase_timings {pt}")
    print(f"{label} launches {launches}")
    _compare_days(got, want, label)
    return launches


def drive_days():
    """Phases 3 and 4; returns the launch counts of each path."""
    import torch

    from repro_torch.core.scheduler import Breakeven
    from repro_torch.fleet import flash_crowd, make_trace
    from repro_torch.fleet import mixed_fleet_scenario
    from repro_torch.fleet.mega import torchback
    from repro_torch.kernels import ops

    ct = make_trace("solar-duck", 0.39)
    shapes = {}
    real_fm = ops.fused_meter

    def seen_fused_meter(a, b, dt, w, g, kt, *rest):
        shapes["fused_meter"] = (a.shape[0], tuple(kt.shape))
        return real_fm(a, b, dt, w, g, kt, *rest)

    real_oss = ops.ordered_segment_sum

    def seen_ordered_segment_sum(vals, keys, num):
        shapes.setdefault("longest_run", int(
            torch.bincount(keys, minlength=num).max()) if keys.numel()
            else 0)
        return real_oss(vals, keys, num)

    torchback.ops.fused_meter = seen_fused_meter    # records shapes only
    torchback.ops.ordered_segment_sum = seen_ordered_segment_sum
    try:
        torchback.FUSED = True
        day = flash_crowd(n_routes=600, fleet="200xh100+200xa100+200xl40s",
                          seed=100, base_rate_hr=130.0, spike_x=60.0)
        main = _drive(lambda: day.to_scenario(Breakeven, carbon_trace=ct),
                      "acceptance day (fused)", compute_bound=False)
        print(f"acceptance day fused_meter N, [G, K] = "
              f"{shapes['fused_meter']}; ordered_segment_sum's longest "
              f"run {shapes['longest_run']}")
        main["longest_run"] = shapes["longest_run"]
        assert main["fused_meter"] > 0 and main["ordered_segment_sum"] > 0
        torchback.FUSED = False
        d24 = flash_crowd(n_routes=24, fleet="2xh100+2xa100+2xl40s",
                          seed=100, horizon_s=6 * 3600.0, base_rate_hr=40.0)
        unfused = _drive(lambda: d24.to_scenario(Breakeven, carbon_trace=ct),
                         "24-route day (unfused)", compute_bound=False)
        assert unfused["segment_trapz"] > 0
        assert unfused["ordered_segment_sum"] > 0
        torchback.FUSED = True
        zones = _drive(lambda: mixed_fleet_scenario(
            Breakeven, "warm-first", seed=100,
            fleet="2xh100@DEU+2xa100@USA+2xl40s@IND", carbon_trace="zone"),
            "3-zone pinned day (fused)")
        G = shapes["fused_meter"][1][0]
        assert zones["fused_meter"] > 0 and G > 1, G
    finally:
        torchback.ops.fused_meter = real_fm
        torchback.ops.ordered_segment_sum = real_oss
        torchback.FUSED = True
    return main, unfused


# ---------------------------------------------------------------------------
# Phases 4a-4d: the rest of the fleet-accounting stack on the card.
# ---------------------------------------------------------------------------

# benchmarks/bench_fleet.py's sweep leg: 24 points of 6 routes over 24 h
SWEEP_KW = dict(n_routes=6, fleet="2xh100+2xa100+2xl40s", base_rate_hr=30.0,
                horizon_s=24 * 3600.0)
SWEEP_SEEDS = tuple(range(24))
# one sweep point at the acceptance day's scale (~1M arrivals)
ACCEPT_SWEEP_KW = dict(n_routes=600, fleet="200xh100+200xa100+200xl40s",
                       base_rate_hr=130.0, spike_x=60.0)
ACCEPT_SWEEP_SEED = 100
SIGMAS = 6.0               # a route's count vs the integral of its rate
# benchmarks/plan_compare.py's 27-point grid (fleets x routers x tiers)
PLAN27_ROUTERS = ("warm-first", "slo-aware", "carbon-aware")
PLAN27_TIERS = ("on_demand", "reserved", "spot")
PLAN_ANCHORS = {"reference_cost": 624.6396714072346,
                "best_cost": 182.70635568021723,
                "best_carbon": 2.7966818523969312}
# PlanPoint fields compared between planners (eval_s is wall-clock)
PLAN_FIELDS = ("fleet", "router", "price_tier", "preemption_rate",
               "cost_usd", "energy_wh", "carbon_kg", "p99_s", "engine",
               "gpu_hours_usd", "energy_usd", "preemptions", "requests")


class _MegaRuns:
    """Times the ``run_mega`` calls that finish on the torch backend
    while the block runs (``megasim.run_mega`` wrapped; the wrapper only
    observes): their number is the count of mega-torch simulations."""

    def __enter__(self):
        from repro_torch.fleet.mega import megasim
        self._mod, self._real = megasim, megasim.run_mega
        self.walls = []

        def run(sc, **kw):
            t0 = time.perf_counter()
            res = self._real(sc, **kw)
            if kw.get("backend", "torch") == "torch":
                self.walls.append(time.perf_counter() - t0)
            return res

        megasim.run_mega = run
        return self

    def __exit__(self, *exc):
        self._mod.run_mega = self._real


def _launched(n, label):
    """Each mega-torch simulation launched the fused metering pass and
    the in-order segment sum once, and nothing else."""
    from repro_torch.kernels import ops
    got = ops.launch_counts()
    want = {k: 0 for k in got}
    want.update(fused_meter=n, ordered_segment_sum=n)
    assert got == want, f"{label}: launches {got}, expected {want}"
    return got


def check_anchor():
    """Phase 4a: one device, one model on the card against
    ``core.simulator.simulate`` on the same arrivals; always-on H100 for
    24 h is 2920.8 Wh (121.7 W x 24 h)."""
    import torch

    from repro_torch.core import H100, PYTORCH_70B, simulate, traffic
    from repro_torch.core.scheduler import AlwaysOn, Breakeven, FixedTTL
    from repro_torch.fleet import run_mega, single_device_scenario
    from repro_torch.kernels import ops

    policies = (("always-on", AlwaysOn),
                ("breakeven", lambda: Breakeven(PYTORCH_70B, H100)),
                ("ttl-5min", lambda: FixedTTL(300.0)))
    torch.cuda.synchronize()
    ops.reset_launches()
    n, worst = 0, 0.0
    for pattern in ("steady", "bursty", "diurnal", "mmpp"):
        arr = traffic.PATTERNS[pattern](seed=7)
        for name, make in policies:
            sim = simulate(arr, make(), H100, PYTORCH_70B)
            res = run_mega(single_device_scenario(arr, make, PYTORCH_70B,
                                                  "h100"),
                           backend="torch", device=DEV)
            n += 1
            label = f"anchor {pattern}/{name}"
            err = abs(res.energy_wh - sim.energy_wh)
            assert err <= 1e-6, (label, res.energy_wh, sim.energy_wh)
            assert res.cold_starts == sim.cold_starts, label
            assert res.requests == sim.n_requests, label
            if name == "always-on":
                assert abs(res.energy_wh - 2920.8) <= 1e-6, \
                    (label, res.energy_wh)
            worst = max(worst, err)
    torch.cuda.synchronize()
    launches = _launched(n, "anchor")
    print(f"1-device anchor on the card: {n} (pattern, policy) days equal "
          f"to core.simulator (max |dE| {worst:.3e} Wh, cold starts and "
          f"requests equal), always-on H100 24 h = 2920.8 Wh; launches "
          f"{launches}")
    return n


def _same_days(got, want, label):
    """Two sweep batches bit-identical: names, plans, every arrival."""
    assert len(got) == len(want), label
    for a, b in zip(got, want):
        assert (a.name, a.fleet, a.horizon_s, a.seed) == \
            (b.name, b.fleet, b.horizon_s, b.seed), label
        for ra, rb in zip(a.routes, b.routes, strict=True):
            assert (ra.route_id, ra.checkpoint_gb) == \
                (rb.route_id, rb.checkpoint_gb), label
            assert ra.arrivals_s.tobytes() == rb.arrivals_s.tobytes(), \
                (label, a.seed, ra.route_id)


def _same_result(got, want, label):
    """Two FleetResults equal in every field but the phase timings."""
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(want):
        if f.name == "phase_timings":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert np.array_equal(g, w), (label, f.name)
        else:
            assert g == w, (label, f.name)


def _differs(got, want):
    try:
        _same_days(got, want, "")
    except AssertionError:
        return True
    return False


def _poisson_bounds(days, generator="flash-crowd", **kw):
    """Every route's count within SIGMAS sigma of the integral of its
    rate (per hour) over the day; returns the largest |z| and the
    number of routes."""
    import inspect
    import math

    import torch

    from repro_torch.fleet.mega import torchback

    sig = inspect.signature(torchback.sweep_traces).parameters
    rate_kw = {k: kw.get(k, sig[k].default) for k in (
        "base_rate_hr", "spike_x", "spike_start_s", "spike_width_s")}
    horizon_s = kw.get("horizon_s", sig["horizon_s"].default)
    n_routes = len(days[0].routes)
    t = torch.linspace(0.0, horizon_s, int(horizon_s) * 2 + 1,
                       dtype=torch.float64)
    mu = [0.0] * n_routes
    for routes, fn, _rmax in torchback.sweep_rates(generator, n_routes,
                                                   **rate_kw):
        r = fn(t)
        m = float(torch.sum(0.5 * (r[1:] + r[:-1]) * torch.diff(t))) / 3600
        for i in routes:
            mu[i] = m
    worst = 0.0
    for tr in days:
        for i, route in enumerate(tr.routes):
            z = (route.arrivals_s.size - mu[i]) / math.sqrt(max(mu[i], 1.0))
            assert abs(z) <= SIGMAS, (tr.seed, route.route_id,
                                      route.arrivals_s.size, mu[i])
            worst = max(worst, abs(z))
    return worst, len(days) * n_routes


def check_sweep():
    """Phase 4b: ``run_mega_sweep`` on bench_fleet's sweep leg, its
    arrivals sampled on the card, each point against the numpy backend
    on its trace."""
    import torch

    from repro_torch.core.scheduler import Breakeven
    from repro_torch.fleet import make_trace, run_mega
    from repro_torch.fleet.mega import torchback
    from repro_torch.kernels import ops

    seeds = list(SWEEP_SEEDS)
    ct = make_trace("solar-duck", 0.39)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    days = torchback.sweep_traces(seeds, device=DEV, **SWEEP_KW)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = torchback.sweep_traces(seeds, device=DEV, **SWEEP_KW)
    torch.cuda.synchronize()
    resample_s = time.perf_counter() - t0
    _same_days(again, days, "24-point sweep sampled twice")
    _same_days(torchback.sweep_traces([5], device=DEV, **SWEEP_KW),
               [days[5]], "sweep_traces([5]) against point 5")
    # a planted fault: route seeds taken from the batch position (as one
    # generator for the whole batch would) must fail the same check
    real = torchback._sample_group
    torchback._sample_group = lambda child, *a: real(
        [child[0] + r for r in range(len(child))], *a)
    try:
        alone = torchback.sweep_traces([5], device=DEV, **SWEEP_KW)
        batch = torchback.sweep_traces(seeds, device=DEV, **SWEEP_KW)
    finally:
        torchback._sample_group = real
    assert _differs(alone, [batch[5]]), "batch-position fault not seen"
    z, n_routes = _poisson_bounds(days, **SWEEP_KW)
    print(f"sweep_traces: {len(seeds)} points x {SWEEP_KW['n_routes']} "
          f"routes, {sum(d.requests for d in days):,} arrivals sampled on "
          f"the card in {sample_s * 1e3:.3f} ms (synchronised; the first "
          f"sampling of the run), again in {resample_s * 1e3:.3f} ms, "
          f"bit-identical; sweep_traces([5]) equal to point 5 (the "
          f"batch-position fault differs); {n_routes} routes within "
          f"{SIGMAS:g} sigma (max |z| {z:.3f})")
    torch.cuda.synchronize()
    ops.reset_launches()
    with _MegaRuns() as runs:
        t0 = time.perf_counter()
        results = torchback.run_mega_sweep(
            seeds=seeds, device=DEV, scenario_kw={"carbon_trace": ct},
            **SWEEP_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launched(len(seeds), "sweep")
    assert len(runs.walls) == len(seeds)
    worst = 0.0
    bulk = []
    for tr, res, w in zip(days, results, runs.walls, strict=True):
        assert res.requests == tr.requests, tr.seed
        want = run_mega(tr.to_scenario(Breakeven, carbon_trace=ct),
                        backend="numpy", compute_bound=False)
        worst = max(worst, _compare_days(res, want, f"sweep point "
                                         f"{tr.seed}", show=False))
        bulk.append(res.phase_timings["bulk_scan_s"])
        print(f"  sweep point {tr.seed}: {res.requests} requests, "
              f"{res.cold_starts} cold starts, wall {w:.6f} s, "
              f"bulk_scan_s {bulk[-1]:.6f}")
    # the torch backend replays a day to the same bits (the batched
    # planner's equality with serial rests on it)
    again = run_mega(days[0].to_scenario(Breakeven, carbon_trace=ct),
                     backend="torch", device=DEV, compute_bound=False)
    _same_result(again, results[0], "sweep point 0 replayed")
    print(f"run_mega_sweep: {len(seeds)} points in {wall:.3f} s on the "
          f"card; each equal to the numpy backend on its trace (requests, "
          f"cold starts, per-(device, state) joules and seconds bit-equal; "
          f"carbon max rel diff {worst:.3e}); point 0 replayed bit-equal; "
          f"launches {launches}")
    return {"points": len(seeds), "sample_ms": sample_s * 1e3,
            "resample_ms": resample_s * 1e3, "wall_s": wall, "point_wall_s": runs.walls, "bulk_scan_s": bulk,
            "launches": launches["fused_meter"]}


def check_sweep_acceptance():
    """Phase 4c: one sweep point at the acceptance day's scale, sampled
    on the card and replayed on both backends."""
    import torch

    from repro_torch.core.scheduler import Breakeven
    from repro_torch.fleet import make_trace
    from repro_torch.fleet.mega import torchback

    ct = make_trace("solar-duck", 0.39)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    days = torchback.sweep_traces([ACCEPT_SWEEP_SEED], device=DEV,
                                  **ACCEPT_SWEEP_KW)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    _same_days(torchback.sweep_traces([ACCEPT_SWEEP_SEED], device=DEV,
                                      **ACCEPT_SWEEP_KW), days,
               "acceptance-scale point sampled twice")
    z, n_routes = _poisson_bounds(days, **ACCEPT_SWEEP_KW)
    print(f"acceptance-scale sweep point: {days[0].requests:,} arrivals "
          f"over {n_routes} routes sampled on the card in "
          f"{sample_s * 1e3:.3f} ms (synchronised), a second sample "
          f"bit-identical, every route within {SIGMAS:g} sigma (max |z| "
          f"{z:.3f})")
    launches = _drive(lambda: days[0].to_scenario(Breakeven,
                                                  carbon_trace=ct),
                      "acceptance-scale sweep point", compute_bound=False)
    want = {k: 0 for k in launches}
    want.update(fused_meter=1, ordered_segment_sum=1)
    assert launches == want, launches
    return {"sample_ms": sample_s * 1e3, "arrivals": days[0].requests,
            "launches": launches["fused_meter"]}


def _plan_key(p, skip=()):
    return tuple(getattr(p, f) for f in PLAN_FIELDS if f not in skip)


def _plan(base_fn, axes, label, **kw):
    """``plan_fleet`` on the card, launch counts reset just before it and
    checked just after against its mega-torch simulations."""
    import torch

    from repro_torch.fleet.planner import plan_fleet
    from repro_torch.kernels import ops

    base = base_fn()
    torch.cuda.synchronize()
    ops.reset_launches()
    with _MegaRuns() as runs:
        res = plan_fleet(base, axes, backend="torch", device=DEV, **kw)
    torch.cuda.synchronize()
    _launched(len(runs.walls), label)
    print(f"{label}: {res.stats['points']} points, wall "
          f"{res.stats['wall_s']:.3f} s, sims {res.stats['sims']} "
          f"({len(runs.walls)} mega-torch), compiles "
          f"{res.stats['compiles']}, hypervolume {res.hypervolume!r}")
    return res, len(runs.walls)


def check_planner():
    """Phase 4d: the Pareto planner on the torch backend: the pinned
    20-point sweep against the numpy planner and the reference's
    anchors, then plan_compare's 27-point grid batched against serial."""
    from repro_torch.fleet.planner import (SPOT_ALL_FLEET, SPOT_H100_FLEET,
                                           ZONES3_FLEET, PlanAxes,
                                           pinned_day_axes, pinned_day_base,
                                           plan_fleet)

    t0 = time.perf_counter()
    want = plan_fleet(pinned_day_base(), pinned_day_axes(), backend="numpy")
    numpy_wall = time.perf_counter() - t0
    got, n_pinned = _plan(pinned_day_base, pinned_day_axes(),
                          "planner, pinned 24 h day")
    assert len(got.points) == len(want.points) == 20
    worst = 0.0
    for g, w in zip(got.points + [got.reference],
                    want.points + [want.reference]):
        assert _plan_key(g, ("engine", "carbon_kg")) == \
            _plan_key(w, ("engine", "carbon_kg")), g.label()
        assert g.engine == w.engine.replace("mega-numpy", "mega-torch"), \
            (g.label(), g.engine, w.engine)
        worst = max(worst, abs(g.carbon_kg - w.carbon_kg)
                    / abs(w.carbon_kg))
    hv = abs(got.hypervolume - want.hypervolume) / abs(want.hypervolume)
    assert worst <= REL_DAY and hv <= REL_DAY, (worst, hv)
    assert [p.label() for p in got.frontier] == \
        [p.label() for p in want.frontier]
    ref_cost = got.reference.cost_usd
    best = got.best("cost_usd")
    best_carbon = got.best("carbon_kg").carbon_kg
    for value, key in ((ref_cost, "reference_cost"),
                       (best.cost_usd, "best_cost"),
                       (best_carbon, "best_carbon")):
        anchor = PLAN_ANCHORS[key]
        assert abs(value - anchor) <= 1e-6 * anchor, (key, value, anchor)
    assert best.fleet == SPOT_ALL_FLEET and best.preemptions > 0
    print(f"planner, pinned 24 h day: every PlanPoint field equal to the "
          f"numpy planner's (numpy wall {numpy_wall:.3f} s) but the "
          f"engine label, carbon max rel diff {worst:.3e}, frontier labels "
          f"equal, hypervolume rel diff {hv:.3e}; reference cost "
          f"{ref_cost!r}, best cost {best.cost_usd!r} on {best.fleet} "
          f"({best.preemptions} preemptions), best carbon {best_carbon!r}")
    axes = PlanAxes(fleets=(ZONES3_FLEET, SPOT_H100_FLEET, SPOT_ALL_FLEET),
                    routers=PLAN27_ROUTERS, price_tiers=PLAN27_TIERS)
    batched, n_batched = _plan(pinned_day_base, axes,
                               "planner, 27-point grid, batched",
                               batched=True)
    serial, n_serial = _plan(pinned_day_base, axes,
                             "planner, 27-point grid, serial",
                             batched=False)
    assert len(batched.points) == len(serial.points) == 27
    for a, b in zip(serial.points, batched.points):
        assert _plan_key(a) == _plan_key(b), a.label()
    assert [_plan_key(p) for p in serial.frontier] == \
        [_plan_key(p) for p in batched.frontier]
    assert _plan_key(serial.reference) == _plan_key(batched.reference)
    assert serial.hypervolume == batched.hypervolume
    print(f"planner, 27-point grid: batched equal to serial point for "
          f"point (frontier, reference and hypervolume too)")
    legs = {}
    for name, res, n in (("pinned", got, n_pinned),
                         ("grid27_batched", batched, n_batched),
                         ("grid27_serial", serial, n_serial)):
        legs[name] = {"wall_s": res.stats["wall_s"],
                      "sims": res.stats["sims"],
                      "compiles": res.stats["compiles"], "launches": n}
    legs["pinned_numpy_wall_s"] = numpy_wall
    return legs


def drive_stack():
    """Phases 4a-4d; returns what the kernels line and PERF.md read."""
    t0 = time.perf_counter()
    anchor = check_anchor()
    sweep = check_sweep()
    accept = check_sweep_acceptance()
    plans = check_planner()
    wall = time.perf_counter() - t0
    print(f"phases 4a-4d: {wall:.3f} s")
    return {"anchor": anchor, "sweep": sweep, "sweep_acceptance": accept,
            "planner": plans, "wall_s": wall}


# ---------------------------------------------------------------------------
# training (phases 18-21)
# ---------------------------------------------------------------------------

GRAD_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # the forward contracts'
SCAN_GRAD_TOL = 1e-4
# (label, (B, H, Hkv, S, D), window, causal): Qwen2.5-7B's training
# shape (S = T = 4,096), RecurrentGemma's local attention past its 2,048
# window, whisper's non-causal 1,500-frame encoder
TRAIN_FLASH_CASES = (
    ("qwen2-5-7b train", (1, 28, 4, 4096, 128), None, True),
    ("recurrentgemma-9b windowed", (1, 16, 1, 4096, 256), 2048, True),
    ("whisper-base encoder", (1, 8, 8, 1500, 64), None, False),
)
# (B, S, W): RecurrentGemma's width at the training length (chunked) and
# a short sequence (serial)
TRAIN_SCAN_SHAPES = ((1, 4096, 4096), (2, 40, 4096))
# the f32tc kernels on their own at small shapes, float32: (B, H, Hkv, S,
# T, D, causal, window, views) -- every head dim, causal / windowed /
# non-causal, GQA groups of 1 to 16, ragged S != T (a 3-row prefill
# against 48 keys), and [B, S|T, heads, D] views as the model hands them
F32TC_CASES = (
    (1, 4, 4, 128, 128, 64, True, None, False),
    (2, 8, 2, 256, 256, 64, True, 64, False),
    (1, 4, 1, 256, 256, 128, True, None, False),
    (2, 2, 2, 512, 512, 32, True, None, False),
    (1, 16, 1, 300, 300, 256, True, 64, False),
    (1, 7, 1, 300, 300, 128, True, None, True),
    (1, 28, 4, 3, 48, 128, True, None, True),
    (2, 8, 2, 200, 300, 128, False, None, False),
    (2, 4, 4, 300, 200, 64, False, 64, False),
    (1, 8, 8, 150, 150, 64, False, None, True),
    (1, 16, 1, 260, 260, 256, True, None, False),
)
TRAIN_LAYERS = 4           # of Qwen2.5-7B's 28, at full width, float32
TRAIN_SEQ = 4096           # the reference's train_4k length
TRAIN_STEPS = 8
TRAIN_BATCH = 6            # the largest batch that fits (phase 20 probes +1)
COMPARE_BATCH = 4          # phase 20's batch before the backward kernel
COMPARE_STEPS = 4
GRAD_SEQ = 256             # phase 19's sequence


def _grad_check(got, want, tol):
    """(ok, worst): each gradient in ``got`` within ``tol`` of its
    counterpart in ``want``, relative to that one's max |.|, finite, and
    none missing (None) or all zero where ``want``'s is nonzero; worst =
    the largest such relative error (inf for a missing one)."""
    import torch
    ok, worst = True, 0.0
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        if g is None or (scale > 0 and not bool(g.any())):
            ok, worst = False, float("inf")
            continue
        err = float((g.float() - w.float()).abs().max())
        rel = err / scale if scale else err
        ok = ok and bool(torch.isfinite(g).all()) and rel <= tol
        worst = max(worst, rel)
    return ok, worst


def _flash_grads(fn, q, k, v, r, causal, window):
    """dL/d(q, k, v) of L = sum(out^2 * r), out = fn(q, k, v) (None where
    out carries no gradient)."""
    import torch
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*ins, causal=causal, window=window)
    if out.grad_fn is None:
        return (None, None, None)
    loss = (out.float() ** 2 * r).sum()
    return torch.autograd.grad(loss, ins, allow_unused=True)


def _scan_grads(fn, a, b, h0, r):
    """dL/d(a, b, h0) of L = sum(h^2 * r), h = fn(a, b, h0)."""
    import torch
    ins = [t.detach().requires_grad_() for t in (a, b, h0)]
    h = fn(*ins)
    if h.grad_fn is None:
        return (None, None, None)
    return torch.autograd.grad((h.float() ** 2 * r).sum(), ins,
                               allow_unused=True)


def _scan_grads_by(backward, scan, a, b, h0, r):
    """The same gradients from a backward formula (``ref.rglru_scan_
    backward`` or a planted fault) run with ``scan``."""
    h = scan(a, b, h0)
    return backward(a, h, h0, (2 * h.float() * r).to(h.dtype), scan=scan)


def check_kernel_grads(stats):
    """Phase 18: the kernels' gradients (``ops``' autograd functions)
    against the plain versions' on the card, and the planted faults."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rmod
    t0 = time.perf_counter()
    flash_worst, scan_worst = 0.0, 0.0
    for label, (b, h, hkv, s, d), window, causal in TRAIN_FLASH_CASES:
        for dt, tol in ((torch.float32, GRAD_TOL["float32"]),
                        (torch.bfloat16, GRAD_TOL["bfloat16"])):
            q = _randn((b, h, s, d), 1, dt, torch)
            k = _randn((b, hkv, s, d), 2, dt, torch)
            v = _randn((b, hkv, s, d), 3, dt, torch)
            r = _randn((b, h, s, d), 4, torch.float32, torch)
            want = _flash_grads(ref.flash_attention_ref, q, k, v, r, causal,
                                window)
            way = fmod.route(dt, d)
            n_bwd = ops.launch_counts()["flash_attention_bwd"]
            got = _routed("flash_attention", way,
                          lambda: _flash_grads(ops.flash_attention, q, k, v,
                                               r, causal, window))
            # the f32tc route's backward is the kernel (one launch a
            # call); the others recompute the plain version
            n_bwd = ops.launch_counts()["flash_attention_bwd"] - n_bwd
            assert n_bwd == (way == "f32tc"), (label, dt, n_bwd)
            ok, worst = _grad_check(got, want, tol)
            assert ok, f"{label} {dt}: gradients off by {worst:.3e}"
            # planted fault: the bare kernel, no autograd
            bare = _flash_grads(fmod.flash_attention, q, k, v, r, causal,
                                window)
            miss = _grad_check(bare, want, tol)
            assert not miss[0], f"{label}: the bare kernel passed"
            more = ""
            if way == "f32tc":
                flash_worst = max(flash_worst, worst)
                more = "; " + _check_bwd_kernel(stats, label, q, k, v, r,
                                                causal, window, got, want,
                                                tol)
            print(f"flash grads {label} {str(dt)[6:]} ({way}): dq/dk/dv "
                  f"within {worst:.3e} of the max (tol {tol}); the bare "
                  f"kernel misses ({miss[1]}){more}")
            del q, k, v, r, want, got, bare
            torch.cuda.empty_cache()
    for shape in TRAIN_SCAN_SHAPES:
        a, x, h0 = _scan_inputs(shape, 7, torch.float32, torch)
        r = _randn(shape, 8, torch.float32, torch)
        want = _scan_grads(ref.rglru_scan_ref, a, x, h0, r)
        way = rmod.route(shape[1])
        before = ops.route_counts("rglru_scan")[way]
        got = _scan_grads(ops.rglru_scan, a, x, h0, r)
        # forward and backward each launch the kernel, on one route
        assert ops.route_counts("rglru_scan")[way] == before + 2
        ok, worst = _grad_check(got, want, SCAN_GRAD_TOL)
        assert ok, f"scan grads {shape}: off by {worst:.3e}"
        faults = {
            "unshifted a": _scan_grads_by(ref.rglru_scan_backward_unshifted,
                                          rmod.rglru_scan, a, x, h0, r),
            "bare kernel": _scan_grads(rmod.rglru_scan, a, x, h0, r)}
        misses = {n: _grad_check(f, want, SCAN_GRAD_TOL)
                  for n, f in faults.items()}
        assert not any(m[0] for m in misses.values()), misses
        scan_worst = max(scan_worst, worst)
        print(f"scan grads {list(shape)} ({way}): da/db/dh0 within "
              f"{worst:.3e} of the max (tol {SCAN_GRAD_TOL}); faults miss: "
              + ", ".join(f"{n} {m[1]:.3e}" for n, m in misses.items()))
        del a, x, h0, r, want, got, faults
    # the float32 (f32tc) cases' worst; the bf16 ones are printed above
    stats["flash_attention_f32"]["grad_err"] = flash_worst
    stats["rglru_scan"]["grad_err"] = scan_worst
    check_f32tc_cases(stats)
    print(f"phase 18: {time.perf_counter() - t0:.3f} s")


def check_f32tc_cases(stats):
    """Phase 18, the f32tc kernels on their own: at each F32TC_CASES
    shape ``flash_attention_lse`` (out and lse) against
    ``ref.flash_attention_lse_ref`` and ``flash_attention_bwd`` against
    ``ref.flash_attention_bwd_ref`` on the same inputs, each within 2e-3
    of its max (lse: of 1, -inf where no key is visible), and two
    backward calls bit-equal; then the backward at F32_ACC_SLICE against
    float64: each gradient's max abs error, over its max, at most 4x
    that of the plain float32 version (as phase 5 holds the forward)."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    tol = GRAD_TOL["float32"]
    worst = {"out": 0.0, "lse": 0.0, "dq/dk/dv": 0.0}
    for i, (b, h, hkv, s, t, d, causal, window, views) in enumerate(
            F32TC_CASES):
        label = f"f32tc case {F32TC_CASES[i]}"
        q, k, v = _qkv(b, h, hkv, s, t, d, views, 10 * i, torch.float32,
                       torch)
        dout = _randn((b, h, s, d), 10 * i + 5, torch.float32, torch)
        out, lse = fmod.flash_attention_lse(q, k, v, causal=causal,
                                            window=window)
        w_out, w_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                                   window=window)
        grads = fmod.flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
        again = fmod.flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window)
        assert all(bool(torch.equal(a, c)) for a, c in zip(grads, again)), \
            f"{label}: two backward calls differ"
        ok, rel = _grad_check([out], [w_out], tol)
        assert ok, f"{label}: out off by {rel:.3e}"
        # a row that sees no key: -inf in both
        assert bool(torch.equal(lse == -math.inf, w_lse == -math.inf)), label
        seen = lse != -math.inf
        lse_err = float((lse[seen] - w_lse[seen]).abs().max()) \
            if bool(seen.any()) else 0.0
        assert lse_err <= tol, f"{label}: lse off by {lse_err:.3e}"
        ok, grel = _grad_check(grads, want, tol)
        assert ok, f"{label}: dq/dk/dv off by {grel:.3e}"
        for n, e in (("out", rel), ("lse", lse_err), ("dq/dk/dv", grel)):
            worst[n] = max(worst[n], e)
    print(f"f32tc kernels at {len(F32TC_CASES)} small shapes: out, lse and "
          f"dq/dk/dv within " + ", ".join(f"{n} {e:.3e}" for n, e in
                                         worst.items())
          + f" of their max (tol {tol}); two backward calls bit-equal in "
          "each")
    b, h, hkv, s, d = F32_ACC_SLICE
    q, k, v = _qkv(b, h, hkv, s, s, d, False, 700, torch.float32, torch)
    dout = _randn((b, h, s, d), 705, torch.float32, torch)
    out, lse = fmod.flash_attention_lse(q, k, v)
    got = fmod.flash_attention_bwd(q, k, v, out, lse, dout)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    exact = ref.flash_attention_bwd_ref(*(x.double() for x in (
        q, k, v, out, lse, dout)))
    acc = {}
    for n, g, p, w in zip(("dq", "dk", "dv"), got, plain, exact):
        m = float(w.abs().max())
        acc[n] = {"kernel": float((g.double() - w).abs().max()) / m,
                  "plain_f32": float((p.double() - w).abs().max()) / m}
    assert all(e["kernel"] <= 4 * e["plain_f32"] for e in acc.values()), acc
    stats["flash_attention_bwd"]["accuracy_vs_float64"] = acc
    print(f"f32tc backward at {list(F32_ACC_SLICE)} against float64, max "
          f"abs err over the max: " + "; ".join(
              f"{n} kernel {e['kernel']:.3e}, plain float32 "
              f"{e['plain_f32']:.3e}" for n, e in acc.items())
          + " (bound 4x plain)")


def _check_bwd_kernel(stats, label, q, k, v, r, causal, window, got, want,
                      tol):
    """Phase 18, float32: the f32tc backward kernel on its own against
    its plain version (``ref.flash_attention_bwd_ref``) on the same
    inputs (the kernel forward's out and lse, dout = 2 out r), within
    ``tol`` of each gradient's max; a second ``ops.flash_attention``
    gradient bit-equal to the first; the two planted backward faults of
    ``ref.flash_attention_bwd_faults`` must miss the gradient check.
    Returns a line for the log."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref
    again = _flash_grads(ops.flash_attention, q, k, v, r, causal, window)
    equal = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    assert equal, f"{label}: two backward calls differ"
    del again
    out, lse = fmod.flash_attention_lse(q, k, v, causal=causal,
                                        window=window)
    dout = 2 * out * r
    kern = fmod.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                    window=window)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                        causal=causal, window=window)
    ok, rel = _grad_check(kern, plain, tol)
    assert ok, f"{label}: the backward kernel off its plain version by {rel}"
    row = stats["flash_attention_bwd"]
    row["max_abs_err"] = max(row["max_abs_err"], *(
        float((a - b).abs().max()) for a, b in zip(kern, plain)))
    del kern, plain
    # with one query head a kv head the group's sum is that head: only
    # the dropped Delta is a fault there
    faults = {n: _grad_check(f, want, tol)
              for n, f in ref.flash_attention_bwd_faults(
                  q, k, v, out, lse, dout, causal=causal,
                  window=window).items()
              if q.shape[1] > k.shape[1] or n == "delta dropped"}
    assert not any(m[0] for m in faults.values()), faults
    return (f"backward kernel within {rel:.3e} of its plain version's max, "
            f"two calls bit-equal; faults miss: " + ", ".join(
                f"{n} {m[1]:.3e}" for n, m in faults.items()))


def _bwd_work(b, h, hkv, s, d):
    """Bytes and operations of the causal float32 backward at S = T:
    q, k, v, out, dout and lse read and dq, dk, dv written once each;
    FlashAttention-2's 5 products of 2 D operations per visible pair."""
    nbytes, flops = _flash_work(b, h, hkv, s, s, d, None)
    return 2 * (2 * nbytes) + 4 * b * h * s, 2.5 * flops


def check_train_batch(stats, batch):
    """Phase 20's own flash shape, [batch, 28, 4096, 128] float32 causal
    through [B, S, heads, D] views as the model hands them: the f32tc
    forward (out, lse) and its backward kernel against their plain
    versions, run one batch row at a time (a row's attention depends on
    that row alone; the plain versions' [B, H, S, T] tensors of all rows
    at once would not fit beside the backward's), out within 2e-3
    (``_attn_close``), lse within 2e-3, dq / dk / dv within 2e-3 of
    each row's max."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    _, h, hkv, s, d = TRAIN_SHAPE
    q, k, v = _qkv(batch, h, hkv, s, s, d, True, 30, torch.float32, torch)
    dout = _randn((batch, s, h, d), 35, torch.float32, torch).transpose(1, 2)
    out, lse = fmod.flash_attention_lse(q, k, v)
    grads = fmod.flash_attention_bwd(q, k, v, out, lse, dout)
    tol = GRAD_TOL["float32"]
    errs = {"out": 0.0, "lse": 0.0, "dq/dk/dv": 0.0}
    for r in range(batch):
        row = slice(r, r + 1)
        w_out, w_lse = ref.flash_attention_lse_ref(q[row], k[row], v[row])
        errs["out"] = max(errs["out"], _attn_close(
            out[row], w_out, ATTN_TOL["float32"],
            f"f32tc forward at row {r} of {batch}"))
        errs["lse"] = max(errs["lse"], _attn_close(
            lse[row], w_lse, tol, f"f32tc lse at row {r} of {batch}"))
        del w_out, w_lse
        want = ref.flash_attention_bwd_ref(q[row], k[row], v[row], out[row],
                                           lse[row], dout[row])
        ok, rel = _grad_check([g[row] for g in grads], want, tol)
        assert ok, f"f32tc backward at row {r} of {batch}: off by {rel:.3e}"
        errs["dq/dk/dv"] = max(errs["dq/dk/dv"], rel)
        del want
    del q, k, v, dout, out, lse, grads
    _free_card()
    stats["flash_attention_f32"]["train_batch_errs"] = errs
    print(f"f32tc at phase 20's shape [{batch}, {h}, {hkv}, {s}, {d}] "
          f"float32 causal (views), against the plain versions a row at a "
          f"time: out max abs err {errs['out']:.3e}, lse {errs['lse']:.3e}, "
          f"dq/dk/dv {errs['dq/dk/dv']:.3e} of each row's max (tol {tol})")


def time_backward(stats):
    """At TRAIN_SHAPE ([4, 28, 4096, 128] float32, causal): the f32tc
    forward and its backward kernel against their plain versions
    (``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``:
    within 2e-3 of each output's max) and their bounds (3xTF32 on the
    tensor cores; the FP32 pipe's beside them), the simt kernel's
    forward and the plain recompute's backward (the route's previous
    kernels) on the same inputs; and the scan's kernel backward at
    [1, 4096, 4096].  CUDA events, median of the rounds."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref
    name = torch.cuda.get_device_name(0)
    b, h, hkv, s, d = TRAIN_SHAPE
    q = _randn((b, h, s, d), 1, torch.float32, torch)
    k = _randn((b, hkv, s, d), 2, torch.float32, torch)
    v = _randn((b, hkv, s, d), 3, torch.float32, torch)
    dout = _randn((b, h, s, d), 4, torch.float32, torch)
    out, lse = fmod.flash_attention_lse(q, k, v)
    fwd = _time_ms(lambda: fmod.flash_attention_lse(q, k, v), torch, reps=5)
    bwd = _time_ms(lambda: fmod.flash_attention_bwd(q, k, v, out, lse,
                                                    dout), torch, reps=3)
    grads = fmod.flash_attention_bwd(q, k, v, out, lse, dout)
    simt_out = torch.empty_like(q)
    simt = _time_ms(_raw_flash(q, k, v, simt_out, None, "simt"), torch,
                    reps=2, rounds=3)
    torch.cuda.synchronize()
    plain_out, _ = ref.flash_attention_lse_ref(q, k, v)
    errs = {"out": _attn_close(out, plain_out, ATTN_TOL["float32"],
                               "f32tc forward at the training shape"),
            "simt out": _attn_close(simt_out, plain_out, ATTN_TOL["float32"],
                                    "simt forward at the training shape")}
    del plain_out, simt_out
    plain_fwd = _time_ms(lambda: ref.flash_attention_lse_ref(q, k, v),
                         torch, reps=1, rounds=3)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    ok, rel = _grad_check(grads, plain, GRAD_TOL["float32"])
    assert ok, f"the backward kernel at the training shape: off by {rel}"
    errs["dq/dk/dv"] = max(float((a - p).abs().max())
                           for a, p in zip(grads, plain))
    del plain, grads
    plain_bwd = _time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout), torch, reps=1, rounds=3)

    def recompute():       # the backward the route had before its kernel
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(ref.flash_attention_ref(*ins), ins, dout)

    recomp = _time_ms(recompute, torch, reps=1, rounds=3)
    del q, k, v, out, lse, dout
    torch.cuda.empty_cache()
    a, x, h0 = (t.requires_grad_() for t in _scan_inputs(
        TRAIN_SCAN_SHAPES[0], 7, torch.float32, torch))
    hh = ops.rglru_scan(a, x, h0)
    gh = torch.randn_like(hh)
    sbwd = _time_ms(lambda: torch.autograd.grad(hh, (a, x, h0), gh,
                                                retain_graph=True), torch,
                    reps=5)
    del a, x, h0, hh, gh
    torch.cuda.empty_cache()
    nbytes, flops = _flash_work(b, h, hkv, s, s, d, None)
    fb, fby = _bound_ms(name, 2 * nbytes, 3 * flops, "tf32")
    f32b = _bound_ms(name, 2 * nbytes, flops, "fp32")[0]
    bbytes, bflops = _bwd_work(b, h, hkv, s, d)
    bb, bby = _bound_ms(name, bbytes, 3 * bflops, "tf32")
    b32b = _bound_ms(name, bbytes, bflops, "fp32")[0]
    _possible(fwd, fb, "f32tc flash forward at the training shape")
    _possible(bwd, bb, "f32tc flash backward at the training shape")
    shape = f"B,H,Hkv,S,T,D={(b, h, hkv, s, s, d)} float32 causal"
    f32_row, bwd_row = stats["flash_attention_f32"], \
        stats["flash_attention_bwd"]
    f32_row["max_abs_err"] = max(f32_row["max_abs_err"], errs["out"])
    bwd_row["max_abs_err"] = max(bwd_row["max_abs_err"], errs["dq/dk/dv"])
    f32_row.update(
        ms=fwd, plain_ms=plain_fwd, bound_ms=fb, bound_by=fby,
        bound="3xTF32 tensor cores", fp32_pipe_bound_ms=f32b, shape=shape,
        simt_ms=simt, simt_source="src/repro_torch/kernels/csrc/"
        "flash_attention.cu", train_shape_errs=errs)
    bwd_row.update(
        ms=bwd, plain_ms=plain_bwd, bound_ms=bb, bound_by=bby,
        bound="3xTF32 tensor cores, 5 products a pair",
        fp32_pipe_bound_ms=b32b, shape=shape, plain_recompute_ms=recomp)
    stats["rglru_scan"].update(backward_ms=sbwd,
                               backward="kernel (chunked, flipped inputs)")
    print(f"flash at the training shape {list(TRAIN_SHAPE)} float32 causal: "
          f"f32tc forward {fwd:.4f} ms (bound {fb:.4f} ms 3xTF32, "
          f"{f32b:.4f} ms on the FP32 pipe; simt kernel {simt:.4f} ms; "
          f"plain {plain_fwd:.4f} ms), backward kernel {bwd:.4f} ms (bound "
          f"{bb:.4f} ms 3xTF32, {b32b:.4f} ms on the FP32 pipe; plain "
          f"{plain_bwd:.4f} ms, plain recompute {recomp:.4f} ms); max abs "
          f"errs {errs}; scan backward {list(TRAIN_SCAN_SHAPES[0])} "
          f"{sbwd:.4f} ms")


class _PlainOps:
    """``ops.flash_attention`` / ``ops.rglru_scan`` replaced by the plain
    versions for one call (restored in ``__exit__``)."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.real = ops.flash_attention, ops.rglru_scan
        ops.flash_attention = ref.flash_attention_ref
        ops.rglru_scan = ref.rglru_scan_ref
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention, ops.rglru_scan = self.real


def _loss_grads(cfg, params, batch):
    """(loss, [(path, grad)]) of ``train_loss`` at ``params``."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import RunFlags
    from repro_torch.models.params import leaves_with_paths
    loss, grads = value_and_grad(params, batch, cfg, RunFlags())
    return float(loss), list(leaves_with_paths(grads))


class _GradSpy:
    """Holds every kernel call of a gradient run (``ops``' autograd
    functions call these) on its own inputs, failing on the first call
    beyond its bound.  Each f32tc forward (out and lse) and each backward
    kernel call (dq, dk, dv) against its plain version run in float64
    (``ref.flash_attention_lse_ref``, ``ref.flash_attention_bwd_ref``),
    each output's max abs error over its max: within 2e-3, or no more
    than 4x the plain float32 version's on the same inputs (as phase 5
    holds the forward), where float32 itself lands farther (at the
    reference's init, plain float32 sits ~1e-3 of the max from float64
    on a RecurrentGemma backward call); each scan, forward or adjoint,
    against
    ``ref.rglru_scan_ref`` (a float32 state), within 1e-4 of its max.
    Keeps each kernel's calls, its worst error and the plain float32
    version's, and how many calls only the 4x bound held."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import flash_attention as fmod
        from repro_torch.kernels import ref
        from repro_torch.kernels import rglru_scan as rmod
        self.mods = fmod, rmod
        self.real = (fmod.flash_attention_lse, fmod.flash_attention_bwd,
                     rmod.rglru_scan)
        lse_fn, bwd_fn, scan_fn = self.real
        self.seen = {n: {"calls": 0, "kernel": 0.0, "plain": 0.0,
                         "by_4x": 0} for n in (
            "flash_attention", "flash_attention_bwd", "rglru_scan")}

        def rel(x, w):
            # -inf lse (a row that sees no key) in the same places
            fin = torch.isfinite(w)
            assert bool(torch.equal(fin, torch.isfinite(x)))
            x, w = x.double()[fin], w.double()[fin]
            return float((x - w).abs().max() / w.abs().max()) \
                if x.numel() and bool(w.any()) else 0.0

        def held(name, got, plain, exact, tol):
            e_k = max(rel(x, w) for x, w in zip(got, exact))
            e_p = max(rel(x, w) for x, w in zip(plain, exact))
            st = self.seen[name]
            assert e_k <= tol or e_k <= 4 * e_p, \
                f"{name} call {st['calls']}: {e_k:.3e} of the max from " \
                f"float64 (plain float32 {e_p:.3e}; tol {tol} or 4x plain)"
            st["calls"] += 1
            st["kernel"] = max(st["kernel"], e_k)
            st["plain"] = max(st["plain"], e_p)
            st["by_4x"] += int(e_k > tol)

        def flash_lse(q, k, v, **kw):
            got = lse_fn(q, k, v, **kw)
            held("flash_attention", got, ref.flash_attention_lse_ref(
                q, k, v, **kw), ref.flash_attention_lse_ref(
                    q.double(), k.double(), v.double(), **kw),
                GRAD_TOL["float32"])
            return got

        def flash_bwd(q, k, v, out, lse, dout, **kw):
            got = bwd_fn(q, k, v, out, lse, dout, **kw)
            ins = (q, k, v, out, lse, dout)
            held("flash_attention_bwd", got, ref.flash_attention_bwd_ref(
                *ins, **kw), ref.flash_attention_bwd_ref(
                    *(x.double() for x in ins), **kw),
                GRAD_TOL["float32"])
            return got

        def scan(a, b, h0):
            h = scan_fn(a, b, h0)
            want = ref.rglru_scan_ref(a, b, h0)
            held("rglru_scan", [h], [want], [want], SCAN_GRAD_TOL)
            return h

        fmod.flash_attention_lse, fmod.flash_attention_bwd = flash_lse, \
            flash_bwd
        rmod.rglru_scan = scan
        return self

    def __exit__(self, *exc):
        fmod, rmod = self.mods
        fmod.flash_attention_lse, fmod.flash_attention_bwd, \
            rmod.rglru_scan = self.real

    def line(self):
        return "; ".join(
            f"{n} {st['calls']} calls, worst {st['kernel']:.3e} of the max "
            + ("from the plain version" if n == "rglru_scan" else
               f"from float64 (plain float32 {st['plain']:.3e}; "
               f"{st['by_4x']} held by the 4x bound)")
            for n, st in self.seen.items() if st["calls"])


def check_model_grads():
    """Phase 19: ``train_loss``'s gradients at full width, float32, with
    the kernels against the same call with the plain versions patched
    into ``ops``: every kernel call held against its plain version on
    its own inputs (``_GradSpy``), every leaf within 2e-3 of its max,
    none zero where the plain run's is not, and the launches each run
    made.  The RecurrentGemma cut runs twice.  At the reference's init
    law (its attention's [d_model, heads, head_dim] projections 16x the
    fan-in law over d_model) its float32 gradients are ill-conditioned:
    float32 runs whose kernels differ only in rounding put the leaves
    8e-4 to 3.7e-3 of their max from the plain run's, and one backward
    call 2.4e-3 from its plain version on the same inputs (``PERF.md``
    §6-7), so that run holds each kernel call and prints the leaves'
    distance ungated; the second, with those
    projections at the fan-in law over d_model (``_fan_in_d_model``),
    takes every gate, as phases 13 and 16 do for gemma3, whisper and
    xlstm."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_param_specs, materialize
    t0 = time.perf_counter()
    (qwen, qwen_cfg), (rg, rg_cfg) = _grad_cuts()
    # (label, config, weights, gated)
    cases = ((qwen, qwen_cfg, None, True), (rg, rg_cfg, None, False),
             (f"{rg} (_fan_in_d_model)", rg_cfg, _fan_in_d_model, True))
    counts = {}
    for label, cfg, weights, gated in cases:
        params = materialize(build_param_specs(cfg),
                             torch.Generator().manual_seed(0), DEV)
        if weights is not None:
            weights(params, cfg)
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (1, GRAD_SEQ + 1),
                            generator=g, dtype=torch.int32).to(DEV)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        ops.reset_launches()
        with _GradSpy() as spy:
            loss, got = _loss_grads(cfg, params, batch)
        torch.cuda.synchronize()
        kernel_counts = {k: n for k, n in ops.launch_counts().items() if n}
        kernel_routes = ops.route_counts()
        ops.reset_launches()
        with _PlainOps():
            want_loss, want = _loss_grads(cfg, params, batch)
        plain_counts = {k: n for k, n in ops.launch_counts().items() if n}
        assert not plain_counts, plain_counts
        n_attn = sum(b.mixer.value == "attn" for grp in cfg.groups
                     for b in grp.pattern * grp.repeats)
        n_scan = cfg.n_layers - n_attn
        # remat: each attention layer's forward runs twice (forward and
        # recompute, on the f32tc route) and its backward kernel once;
        # each RG-LRU layer's scan three times (forward, recompute,
        # backward)
        expect = {"flash_attention": 2 * n_attn,
                  "flash_attention_bwd": n_attn, "rglru_scan": 3 * n_scan}
        assert kernel_counts == {k: n for k, n in expect.items() if n}, \
            (kernel_counts, expect)
        assert {k: st["calls"] for k, st in spy.seen.items()} == expect, \
            (spy.seen, expect)
        assert kernel_routes["f32tc"] == 2 * n_attn == sum(
            kernel_routes.values()), kernel_routes
        ok, worst = _grad_check([gg for _, gg in got],
                                [w for _, w in want], 2e-3)
        # ungated, the leaves must still all be there and finite
        assert math.isfinite(worst) and all(
            bool(torch.isfinite(gg).all()) for _, gg in got), label
        assert ok or not gated, f"{label}: a gradient leaf off by {worst:.3e}"
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        assert loss_rel <= 2e-3 or not gated, (loss, want_loss)
        counts[label] = kernel_counts
        print(f"model grads {label}: loss {loss!r} (plain {want_loss!r}); "
              f"kernel calls against their plain versions: {spy.line()}; "
              f"{len(got)} leaves within {worst:.3e} of their max ("
              + ("limit 2e-3" if gated else "not gated: the reference's "
                 "init") + "), none zero where the plain run's is not; "
              f"launches with the kernels {kernel_counts}, with the plain "
              f"versions {plain_counts or 'none'}")
        del params, got, want
        _free_card()
    print(f"phase 19: {time.perf_counter() - t0:.3f} s")
    return counts


def _instrumented_steps(record, profile_step):
    """Wrap ``trainer.make_train_step``: each step's kernel launches
    (counters reset just before the step, read just after) go into
    ``record``; step ``profile_step`` runs under ``torch.profiler`` and
    its device busy time goes there too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.training import trainer
    real = trainer.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            ops.reset_launches()
            if len(record["launches"]) != profile_step:
                out = step(state, batch)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = step(state, batch)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rows = [(e.key, e.self_device_time_total / 1e3)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0]
                record["profile"] = {"wall_ms": 1e3 * wall,
                                     "busy_ms": sum(ms for _, ms in rows),
                                     "top": sorted(rows,
                                                   key=lambda r: -r[1])[:8]}
            record["launches"].append(
                {k: n for k, n in ops.launch_counts().items() if n})
            record.setdefault("routes", []).append(ops.route_counts())
            return out
        return run
    return real, make


def train_full_width(stats):
    """Phase 20: ``trainer.train`` on Qwen2.5-7B at full width, 4 of its
    28 layers, float32, S = 4,096, at the largest batch that fits (a
    run at one more row runs out of memory within two steps), 8 steps
    with a 2-step warmup."""
    import torch

    from repro_torch.models import RunFlags
    from repro_torch.training import trainer
    from repro_torch.training.optimizer import AdamWConfig
    t0 = time.perf_counter()
    cfg = cut_depth(ARCH, TRAIN_LAYERS, torch.float32)

    def tc(batch, steps):
        return trainer.TrainConfig(
            steps=steps, batch_size=batch, seq_len=TRAIN_SEQ, log_every=1,
            opt=AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS),
            flags=RunFlags())

    def run(rows, steps):
        torch.cuda.reset_peak_memory_stats()
        record = {"launches": []}
        real, make = _instrumented_steps(record, profile_step=steps - 1)
        trainer.make_train_step = make
        try:
            hist = trainer.train(cfg, tc(rows, steps),
                                 log_fn=lambda s: print(f"  {s}"),
                                 device=DEV)
        finally:
            trainer.make_train_step = real
        peak = torch.cuda.max_memory_allocated()
        losses = hist["loss"]
        assert all(map(math.isfinite, losses)), losses
        # every step: 2 forward launches a layer (forward and remat
        # recompute) and 1 backward launch, all on the f32tc route
        want = {"flash_attention": 2 * TRAIN_LAYERS,
                "flash_attention_bwd": TRAIN_LAYERS}
        assert record["launches"] == [want] * steps, record["launches"]
        assert all(r["f32tc"] == 2 * TRAIN_LAYERS and sum(r.values()) ==
                   2 * TRAIN_LAYERS for r in record["routes"]), \
            record["routes"]
        # the profiled step is the last; the others' host clock
        step_ms = 1e3 * statistics.median(hist["step_time_s"][1:-1])
        return {"losses": losses, "step_ms": step_ms,
                "first_step_ms": 1e3 * hist["step_time_s"][0],
                "tokens_per_s": rows * TRAIN_SEQ / (step_ms / 1e3),
                "peak_bytes": peak, "profile": record["profile"],
                "launches": record["launches"]}

    # the largest batch that fits, probed by the main run itself (a
    # separate two-step probe at its batch cost two of its steps): one
    # row above TRAIN_BATCH while its run goes through, until a row more
    # runs out of the card's memory (within two steps: at 5 rows one step
    # ran and the second did not); the card's cache is emptied after each
    # run, once a failed step's frames are gone
    batch, runs = TRAIN_BATCH, {}
    while True:
        try:
            more = run(batch + 1, TRAIN_STEPS)
        except torch.cuda.OutOfMemoryError:
            more = None
        _free_card()
        if more is None:
            break
        batch += 1
        runs = {batch: more}
    print(f"train: a step at {batch + 1} rows of {TRAIN_SEQ} tokens runs "
          f"out of the card's memory; {batch} rows a step"
          + ("" if batch == TRAIN_BATCH else
             f" (TRAIN_BATCH is {TRAIN_BATCH}: raise it)"))
    for rows, steps in ((batch, TRAIN_STEPS), (COMPARE_BATCH, COMPARE_STEPS)):
        if rows not in runs:
            runs[rows] = run(rows, steps)
            _free_card()
    # what a separate two-step probe at the main batch took: two of the
    # main run's steps (phase 24.3 prints it with the time won back)
    probe_s = 2 * runs[batch]["step_ms"] / 1e3
    main = runs[batch]
    losses = main["losses"]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    assert last < first, losses
    prof = main["profile"]
    # None: the profiler recorded no device time (not measured)
    idle = 1 - prof["busy_ms"] / prof["wall_ms"] if prof["busy_ms"] \
        else None
    step_ms, peak = main["step_ms"], main["peak_bytes"]
    flash = [c["flash_attention"] for c in main["launches"]]
    print(f"train {cfg.name} x {TRAIN_LAYERS} layers float32, "
          f"{batch} x {TRAIN_SEQ} tokens a step: losses {losses}; "
          f"mean of the first 3 {first!r}, of the last 3 {last!r}")
    for rows, r in runs.items():
        print(f"train at {rows} rows: {r['step_ms']:.3f} ms a step (median "
              f"of steps 2-{len(r['losses']) - 1}; step 1 "
              f"{r['first_step_ms']:.3f} ms), {r['tokens_per_s']:.1f} "
              f"tokens/s, max_memory_allocated {r['peak_bytes']:,} B, "
              f"launches a step {r['launches'][0]} (flash: 2 x "
              f"{TRAIN_LAYERS} layers, forward and remat recompute, f32tc; "
              f"its backward kernel once a layer)")
    print(f"train profile (last step): {prof['wall_ms']:.3f} ms of host "
          f"clock, the card busy {prof['busy_ms']:.3f} ms: idle "
          + ("not measured" if idle is None else f"{100 * idle:.1f} %"))
    for key, ms in prof["top"]:
        print(f"  device {ms:10.3f} ms  {100 * ms / prof['busy_ms']:5.1f} % "
              f" {key[:90]}")
    _free_card()
    check_train_batch(stats, batch)
    time_backward(stats)
    result = {"arch": cfg.name, "layers": TRAIN_LAYERS, "batch": batch,
              "seq": TRAIN_SEQ, "losses": losses, "step_ms": step_ms,
              "tokens_per_s": main["tokens_per_s"], "peak_bytes": peak,
              "idle": idle, "flash_launches_per_step": flash[0],
              "launches_per_step": main["launches"][0],
              "flash_bwd_launches": sum(c["flash_attention_bwd"]
                                        for c in main["launches"]),
              "flash_launches": sum(flash),
              "at_compare_batch": {k: runs[COMPARE_BATCH][k] for k in (
                  "step_ms", "tokens_per_s", "peak_bytes", "losses")},
              "compare_batch": COMPARE_BATCH, "probe_won_s": probe_s}
    print(f"phase 20: {time.perf_counter() - t0:.3f} s")
    return result


def _train_lines(argv):
    import contextlib
    import io

    from repro_torch.launch import train as train_launch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_launch.main(list(argv)) == 0
    out = buf.getvalue().splitlines()
    for line in out:
        print(f"  {line}")
    final = [x for x in out if x.startswith("[train] final loss ")]
    return float(final[-1].split()[3])


def check_train_launcher(tmp):
    """Phase 21: ``repro_torch.launch.train`` (its ``main``, in this
    process) at the reduced Qwen config on the card: 10 steps straight,
    5 then a resumed 5 from the checkpoint (final losses within rtol
    1e-5, as the reference's ``test_train_resume_bitexact``), and a run
    with ``--grad-accum 2 --grad-compression``."""
    import shutil
    t0 = time.perf_counter()
    base = ["--arch", ARCH, "--reduced", "--torch-device", DEV]
    shutil.rmtree(tmp, ignore_errors=True)
    straight = _train_lines(base + ["--steps", "10", "--ckpt",
                                    f"{tmp}/straight"])
    _train_lines(base + ["--steps", "5", "--ckpt", f"{tmp}/resume"])
    resumed = _train_lines(base + ["--steps", "10", "--ckpt",
                                   f"{tmp}/resume"])
    assert abs(resumed - straight) <= 1e-5 * abs(straight), \
        (straight, resumed)
    accum = _train_lines(base + ["--steps", "10", "--grad-accum", "2",
                                 "--grad-compression"])
    assert math.isfinite(accum)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"train launcher: final loss straight {straight!r}, resumed "
          f"{resumed!r} (bit-equal: {straight == resumed}); accum 2 + "
          f"compression {accum!r}")
    print(f"phase 21: {time.perf_counter() - t0:.3f} s")
    return {"straight": straight, "resumed": resumed,
            "bit_equal": straight == resumed, "accum_compression": accum}


def drive_training(stats):
    """Phases 18-21 (the late builds waited for first)."""
    finish_build()
    stats.setdefault("rglru_scan", {})
    for row in ("flash_attention_f32", "flash_attention_bwd"):
        stats.setdefault(row, {"max_abs_err": 0.0})
    check_kernel_grads(stats)
    model = check_model_grads()
    full = train_full_width(stats)
    launcher = check_train_launcher(ROOT / "build" / "train_ckpt")
    return {"model_grads": model, "full_width": full, "launcher": launcher}


# ---------------------------------------------------------------------------
# sharded cells, the pipeline and remat="dots" (phase 22)
# ---------------------------------------------------------------------------

DIST_BACKEND = "nccl"      # world size 1 on the card
DIST_LAYERS = 2            # of Qwen2.5-7B's 28, at full width
CELL_RTOL = 1e-6           # jit_cell vs make_*_step, of each leaf's max
DECODE_POS = 2048          # the decode cell's write offset
PIPE_SHAPE = (2, 1024)     # (B, S) of the pipelined loss
PIPE_MICRO = 2
DOTS_LAYERS = 4            # phase 20's cut, timed under "dots" and "full"
DOTS_BATCH = 2
DOTS_STEPS = 3
TRAIN_SHAPE = (4, 28, 4, 4096, 128)   # phase 20's flash shape, float32


def _dist_shapes():
    from repro_torch.launch.steps import ShapeSpec
    return (ShapeSpec("train_cell", "train", TRAIN_SEQ, 2),
            ShapeSpec("prefill_cell", "prefill", DECODE_POS, 2),
            ShapeSpec("decode_cell", "decode", 2 * DECODE_POS, 2))


def _process_group(store):
    """torch.distributed's default group at world size 1 over a
    ``FileStore`` under ``build/`` (no network); destroyed by the
    caller."""
    import torch.distributed as dist
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(DIST_BACKEND, rank=0, world_size=1,
                            store=dist.FileStore(str(store), 1))


def _rel_max(got, want):
    """max |got - want| over max |want| (abs error where want is 0)."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if w.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    return err / scale if scale else err


def _cell_check(got, want, rtol=CELL_RTOL):
    """(ok, worst, bit-equal) over paired lists of tensors: each within
    ``rtol`` of its counterpart's max |.|, finite."""
    import torch
    worst = max(_rel_max(g, w) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    return finite and worst <= rtol, worst, equal


def _tokens(cfg, b, s, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         dtype=torch.int32).to(DEV)


def _timed(fn, steps):
    """(outputs, ms a call by the host clock ending in a synchronize,
    launches of each call) of ``steps`` calls ``fn(i)``."""
    import torch

    from repro_torch.kernels import ops
    outs, ms, launches = [], [], []
    for i in range(steps):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn(i))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        launches.append({k: n for k, n in ops.launch_counts().items() if n})
    return outs, ms, launches


def _flash_per_call(launches, n, route):
    from repro_torch.kernels import ops
    assert all(c == {"flash_attention": n} for c in launches), launches
    assert ops.route_counts()[route] == n, ops.route_counts()


def _two_rank_stand_in(cfg, state, batch, opt, fault):
    """One train step modelled in plain torch at two data ranks, each on
    half the rows: the right reduction averages the ranks' loss means
    and gradients, ``fault`` sums them (the gradients not reduced as the
    global batch's mean)."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import RunFlags
    from repro_torch.models.params import tree_map
    from repro_torch.training.optimizer import adamw_update
    halves = [{k: v[i::2] for k, v in batch.items()} for i in range(2)]
    (l0, g0), (l1, g1) = (value_and_grad(state["params"], h, cfg,
                                         RunFlags()) for h in halves)
    w = 1.0 if fault else 0.5
    loss = (l0 + l1) * w
    grads = tree_map(lambda a, b: (a + b) * w, g0, g1)
    _, _, _, gnorm = adamw_update(state["params"], grads, state["mu"],
                                  state["nu"], state["step"], opt)
    return loss, gnorm


def check_train_cell(mesh):
    """Phase 22.1: ``jit_cell``'s train cell on Qwen2.5-7B at full width,
    DIST_LAYERS layers, float32, 2 x TRAIN_SEQ tokens, ``remat="full"``,
    two steps, beside ``make_train_step``'s two on the same state (made
    again from the same seed; only the first run's params are kept)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (input_specs, jit_cell, layout,
                                          make_train_step)
    from repro_torch.models import RunFlags, materialize
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig
    shape = _dist_shapes()[0]
    cfg = cut_depth(ARCH, DIST_LAYERS, torch.float32)
    opt, flags = AdamWConfig(warmup_steps=0, total_steps=10), RunFlags()

    def state():
        return materialize(input_specs(cfg, shape)["state"],
                           torch.Generator().manual_seed(0), DEV)

    batches = [{"tokens": _tokens(cfg, 2, shape.seq_len, 30 + i),
                "labels": _tokens(cfg, 2, shape.seq_len, 40 + i)}
               for i in range(2)]
    ref = make_train_step(cfg, opt, flags)
    st = state()

    def ref_step(i):
        nonlocal st
        st, m = ref(st, batches[i])
        return {k: v.clone() for k, v in m.items()}

    want_m, ref_ms, ref_launches = _timed(ref_step, 2)
    want = [t.clone() for t in tree_leaves(st["params"])]
    del st                      # one copy of the state at a time
    _free_card()
    step, args = jit_cell(cfg, shape, mesh, flags, opt)
    assert all(t.is_meta for a in args for t in tree_leaves(a))
    st = state()
    torch.cuda.reset_peak_memory_stats()

    def cell_step(i):
        nonlocal st
        st, m = step(st, batches[i])
        return {k: v.full_tensor() for k, v in m.items()}

    got_m, ms, launches = _timed(cell_step, 2)
    peak = torch.cuda.max_memory_allocated()
    for c in (ref_launches, launches):
        assert all(x == {"flash_attention": 2 * DIST_LAYERS,
                         "flash_attention_bwd": DIST_LAYERS} for x in c), c
    assert ops.route_counts()["f32tc"] == 2 * DIST_LAYERS     # float32
    got = [t.full_tensor() for t in tree_leaves(st["params"])]
    scalars = [m[k] for m in got_m for k in ("loss", "grad_norm")]
    ok, worst, equal = _cell_check(scalars + got, [
        m[k] for m in want_m for k in ("loss", "grad_norm")] + want)
    assert ok, f"train cell: off by {worst:.3e} of the max"
    # the sharded body at world size 1: every collective an identity, the
    # arithmetic the unsharded step's, op for op
    assert layout(cfg, shape, mesh) == "sharded"
    assert equal, f"train cell: not bit-equal to make_train_step ({worst})"
    del st, got, want
    _free_card()
    # planted fault: the ranks' gradients summed, not averaged (modelled
    # at phase 19's cut, which keeps it cheap)
    small = cut_depth(ARCH, 1, torch.float32)
    sb = {"tokens": _tokens(small, 2, GRAD_SEQ, 50),
          "labels": _tokens(small, 2, GRAD_SEQ, 51)}

    def small_state():
        return materialize(input_specs(small, shape)["state"],
                           torch.Generator().manual_seed(0), DEV)

    _, wm = make_train_step(small, opt, flags)(small_state(), sb)
    fine = _two_rank_stand_in(small, small_state(), sb, opt, fault=False)
    bad = _two_rank_stand_in(small, small_state(), sb, opt, fault=True)
    want_s = [wm["loss"], wm["grad_norm"]]
    fine_chk = _cell_check(list(fine), want_s)
    bad_chk = _cell_check(list(bad), want_s)
    assert not bad_chk[0], f"the check passes unreduced gradients {bad_chk}"
    _free_card()
    print(f"train cell {cfg.name} x {DIST_LAYERS} layers float32, 2 x "
          f"{shape.seq_len} tokens, mesh {mesh.shape} ({DIST_BACKEND}): "
          f"losses {[float(m['loss']) for m in got_m]}, params and "
          f"metrics within {worst:.3e} of their max of make_train_step's "
          f"(tol {CELL_RTOL}), bit-equal {equal}; {statistics.median(ms):.3f}"
          f" ms a step (make_train_step {statistics.median(ref_ms):.3f} ms), "
          f"max_memory_allocated {peak:,} B, flash launches a step "
          f"{launches[0]} (f32tc); planted fault (two ranks summed) misses by "
          f"{bad_chk[1]:.3e}, the right two-rank stand-in sits at "
          f"{fine_chk[1]:.3e}")
    return {"losses": [float(m["loss"]) for m in got_m], "worst": worst,
            "bit_equal": equal, "layout": "sharded", "ms": ms,
            "ref_ms": ref_ms,
            "peak_bytes": peak, "flash_per_step": 2 * DIST_LAYERS,
            "flash_bwd_per_step": DIST_LAYERS,
            "fault_miss": bad_chk[1], "stand_in": fine_chk[1]}


def check_serve_cells(mesh):
    """Phase 22.2: ``jit_cell``'s prefill and decode cells (SERVE rules,
    the sharded serving layout at world size 1) on Qwen2.5-7B at full
    width, DIST_LAYERS layers, bf16, bit-equal to ``make_prefill_step`` /
    ``make_decode_step`` on the same inputs (logits and caches)."""
    import torch

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (input_specs, jit_cell,
                                          make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import materialize
    from repro_torch.models.params import tree_leaves, tree_map
    pre, dec = _dist_shapes()[1:]
    cfg = cut_depth(ARCH, DIST_LAYERS, torch.bfloat16)
    params = materialize(input_specs(cfg, pre)["params"],
                         torch.Generator().manual_seed(0), DEV)
    batch = {"tokens": _tokens(cfg, 2, pre.seq_len, 60)}
    caches = materialize(input_specs(cfg, pre)["caches"],
                         torch.Generator().manual_seed(1), DEV)
    want, want_c = make_prefill_step(cfg)(params, batch,
                                          tree_map(torch.clone, caches))
    step, _ = jit_cell(cfg, pre, mesh)
    (out,), ms_pre, launches = _timed(lambda i: step(params, batch, caches),
                                      1)
    _flash_per_call(launches, DIST_LAYERS, "sm90")
    got, got_c = out
    pre_equal = torch.equal(got.full_tensor(), want) and all(
        torch.equal(g.full_tensor(), w) for g, w in
        zip(tree_leaves(got_c), tree_leaves(want_c)))
    ok, pre_worst, _ = _cell_check([got.full_tensor()], [want])
    assert ok, f"prefill cell: logits off by {pre_worst:.3e}"
    # world size 1: the sharded serving body is the unsharded step, op
    # for op
    assert pre_equal, "prefill cell: not bit-equal to make_prefill_step"
    # decode at DECODE_POS over caches whose first DECODE_POS rows hold
    # seeded values
    caches = materialize(input_specs(cfg, dec)["caches"],
                         torch.Generator().manual_seed(2), DEV)
    for i, leaf in enumerate(tree_leaves(caches)):
        leaf[:, :, :DECODE_POS] = _randn(
            (leaf.shape[0], leaf.shape[1], DECODE_POS) + leaf.shape[3:],
            70 + i, leaf.dtype, torch)
    tok = _tokens(cfg, 2, 1, 61)
    want, want_c = make_decode_step(cfg)(params, tok, tree_map(torch.clone,
                                                               caches),
                                         DECODE_POS)
    step, _ = jit_cell(cfg, dec, mesh)
    b, h, hkv, d = 2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    way = "split" if dmod.plan(b, h, hkv, DECODE_POS + 1, d, dmod._sms(
        torch.device(DEV))).splits > 1 else "single"
    (out,), ms_dec, launches = _timed(
        lambda i: step(params, tok, caches, DECODE_POS), 1)
    assert launches == [{"decode_attention": DIST_LAYERS}], launches
    assert ops.route_counts("decode_attention")[way] == DIST_LAYERS
    got = out[0].full_tensor()
    dec_equal = torch.equal(got, want) and all(
        torch.equal(g.full_tensor(), w) for g, w in
        zip(tree_leaves(out[1]), tree_leaves(want_c)))
    ok, dec_worst, _ = _cell_check([got], [want])
    assert ok, f"decode cell: logits off by {dec_worst:.3e}"
    assert dec_equal, "decode cell: not bit-equal to make_decode_step"
    del params, caches, out
    _free_card()
    print(f"serve cells {cfg.name} x {DIST_LAYERS} layers bf16: prefill "
          f"2 x {pre.seq_len} ({ms_pre[0]:.3f} ms, flash {DIST_LAYERS} "
          f"sm90) logits and caches equal to make_prefill_step's: "
          f"{pre_equal} (within {pre_worst:.3e}); decode at {DECODE_POS} "
          f"over {dec.seq_len} cache rows ({ms_dec[0]:.3f} ms, decode "
          f"{DIST_LAYERS} {way}) equal to make_decode_step's: {dec_equal} "
          f"(within {dec_worst:.3e})")
    return {"prefill_equal": pre_equal, "prefill_worst": pre_worst,
            "prefill_ms": ms_pre[0], "decode_equal": dec_equal,
            "decode_worst": dec_worst, "decode_ms": ms_dec[0],
            "decode_route": way, "flash": DIST_LAYERS,
            "decode": DIST_LAYERS}


def _drop_last_loss(cfg, params, batch, m):
    """The pipelined loss with the last microbatch dropped (its rows'
    final activations zero), modelled in plain torch: a planted fault."""
    import torch

    from repro_torch.models import RunFlags
    from repro_torch.models import model as mm
    from repro_torch.models.layers import rmsnorm, softmax_xent, unembed
    x, positions, _ = mm._prepare_inputs(params, cfg, batch)
    rows = x.shape[0] // m
    hs = [mm._run_groups(params, cfg.groups, cfg, x[i * rows:(i + 1) * rows],
                         positions[:rows], mm.build_meta(cfg), train=True,
                         flags=RunFlags(remat="none"))[0]
          for i in range(m - 1)]
    h = torch.cat(hs + [torch.zeros_like(x[:rows])])
    logits = unembed(params["embed"], rmsnorm(params["final_norm"], h,
                                              cfg.norm_eps), cfg)
    return softmax_xent(logits, batch["labels"])


def _loss_and_grads(loss_fn, params):
    """(loss, gradients of each leaf) of ``loss_fn(params)``."""
    import torch

    from repro_torch.models.params import tree_leaves, tree_unflatten
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves))
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def check_pipeline(mesh):
    """Phase 22.3: the GPipe loss at one stage on a ("pod",) mesh of
    size 1, PIPE_MICRO microbatches, ``remat="none"``, Qwen2.5-7B at full
    width, DIST_LAYERS layers, float32, against ``train_loss``, at the
    d_model fan-in law (``_fan_in_d_model``): at the reference's init the
    float32 rounding of another microbatch split alone moves a gradient
    leaf by ~1e-2 of its max, pipeline or not (``tools/pipeline_diag.py``;
    PERF.md section 6)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import RunFlags, build_param_specs, materialize
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.training.pipeline import (make_pipelined_train_loss,
                                               split_stage_params)
    cfg = cut_depth(ARCH, DIST_LAYERS, torch.float32)
    flags = RunFlags(remat="none")
    b, s = PIPE_SHAPE
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    _fan_in_d_model(params, cfg)
    batch = {"tokens": _tokens(cfg, b, s, 80), "labels": _tokens(cfg, b, s,
                                                                 81)}
    loss_fn = make_pipelined_train_loss(cfg, mesh, n_microbatches=PIPE_MICRO,
                                        flags=flags)
    staged = split_stage_params(params, cfg, n_stages=1)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(staged)]
    ops.reset_launches()
    loss = loss_fn(tree_unflatten(staged, leaves), batch)
    torch.cuda.synchronize()
    fwd = {k: n for k, n in ops.launch_counts().items() if n}
    assert fwd == {"flash_attention": PIPE_MICRO * DIST_LAYERS}, fwd
    grads = [g.reshape(w.shape) for g, w in zip(
        torch.autograd.grad(loss, leaves), tree_leaves(params))]
    loss = float(loss.detach())
    want_loss, want = value_and_grad(params, batch, cfg, flags)
    want_loss, want = float(want_loss), tree_leaves(want)
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss), (loss, want_loss)
    ok, worst = _grad_check(grads, want, 2e-3)
    assert ok, f"pipeline: a gradient leaf off by {worst:.3e}"
    del grads
    # planted fault: the last microbatch dropped
    bad_loss, bad = _loss_and_grads(
        lambda p: _drop_last_loss(cfg, p, batch, PIPE_MICRO), params)
    bad_ok = abs(bad_loss - want_loss) <= 1e-4 * abs(want_loss) and \
        _grad_check(bad, want, 2e-3)[0]
    assert not bad_ok, "the check passes a pipeline that drops a microbatch"
    del params, want, bad
    _free_card()
    print(f"pipeline {cfg.name} x {DIST_LAYERS} layers float32, 1 stage, "
          f"{PIPE_MICRO} microbatches of {b // PIPE_MICRO} x {s}: loss "
          f"{loss!r} (train_loss {want_loss!r}), gradient leaves within "
          f"{worst:.3e} of their max; forward launches {fwd}; planted "
          f"fault (last microbatch dropped) loss {bad_loss!r}")
    return {"loss": loss, "train_loss": want_loss, "grad_worst": worst,
            "forward_launches": fwd, "fault_loss": bad_loss}


def _late_closure_loss(cfg, params, batch):
    """``train_loss`` under "dots" with every layer's checkpoint closing
    over the loop's variables, so the backward's recompute runs every
    layer with the last layer's: a planted fault (the first remat
    loop's mistake, ROADMAP.md section 3, fault 5)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import RunFlags
    from repro_torch.models import model as mm
    from repro_torch.models.layers import rmsnorm, softmax_xent, unembed
    x, positions, _ = mm._prepare_inputs(params, cfg, batch)
    metas, flags = mm.build_meta(cfg), RunFlags(remat="dots")
    for g in cfg.groups:
        for r in range(g.repeats):
            def run(h):
                return mm._apply_layer(
                    h, r=r, g=g, gp=params["groups"][g.name],
                    gm=metas[g.name], gc=None, cfg=cfg, positions=positions,
                    cache_offset=None, enc_out=None, causal=True,
                    flags=flags)
            x = checkpoint(run, x, use_reentrant=False,
                           context_fn=mm._save_dots)[0]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return softmax_xent(unembed(params["embed"], x, cfg), batch["labels"])


def check_dots():
    """Phase 22.4: ``remat="dots"`` against ``"full"`` at phase 19's cuts
    (every leaf within 2e-3 of its max; the launches of each), the
    planted late-closure fault, then Qwen2.5-7B at DOTS_LAYERS layers x
    TRAIN_SEQ x DOTS_BATCH rows under both, DOTS_STEPS steps each."""
    import torch

    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import RunFlags, build_param_specs, materialize
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.trainer import init_state
    cuts = {}
    for label, cfg in _grad_cuts():
        params = materialize(build_param_specs(cfg),
                             torch.Generator().manual_seed(0), DEV)
        batch = {"tokens": _tokens(cfg, 1, GRAD_SEQ, 1),
                 "labels": _tokens(cfg, 1, GRAD_SEQ, 2)}
        runs = {}
        for remat in ("full", "dots"):
            (out,), _, launches = _timed(lambda i: value_and_grad(
                params, batch, cfg, RunFlags(remat=remat)), 1)
            runs[remat] = (float(out[0]), tree_leaves(out[1]), launches[0])
        ok, worst = _grad_check(runs["dots"][1], runs["full"][1], 2e-3)
        assert ok, f"dots {label}: a leaf off by {worst:.3e}"
        assert runs["dots"][2] == runs["full"][2], (runs["dots"][2],
                                                    runs["full"][2])
        cuts[label] = {"worst": worst, "dots_launches": runs["dots"][2],
                       "full_launches": runs["full"][2]}
        print(f"dots {label}: leaves within {worst:.3e} of \"full\"'s max; "
              f"launches a step dots {runs['dots'][2]}, full "
              f"{runs['full'][2]}")
        del params, runs
        _free_card()
    # planted fault: every layer recomputed with the last one's closure,
    # on two layers of one structure (RecurrentGemma's groups differ in
    # their blocks, and there the recompute's saved-tensor count differs
    # and torch's own check raises before any gradient is compared)
    cfg = cut_depth(ARCH, 2, torch.float32)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    batch = {"tokens": _tokens(cfg, 1, GRAD_SEQ, 1),
             "labels": _tokens(cfg, 1, GRAD_SEQ, 2)}
    _, want = value_and_grad(params, batch, cfg, RunFlags(remat="dots"))
    _, bad = _loss_and_grads(lambda p: _late_closure_loss(cfg, p, batch),
                             params)
    miss = _grad_check(bad, tree_leaves(want), 2e-3)
    assert not miss[0], "the check passes a late-closure recompute"
    print(f"dots planted fault (every layer recomputed with the last "
          f"one's closure, {ARCH} x 2 layers): misses by {miss[1]:.3e}")
    del params, want, bad
    _free_card()
    cfg = cut_depth(ARCH, DOTS_LAYERS, torch.float32)
    timed = {}
    for remat in ("dots", "full"):
        flags = RunFlags(remat=remat)
        step = make_train_step(cfg, flags=flags)
        st = init_state(cfg, 0, device=DEV)
        torch.cuda.reset_peak_memory_stats()

        def one(i):
            nonlocal st
            st, m = step(st, {"tokens": _tokens(cfg, DOTS_BATCH, TRAIN_SEQ,
                                                90 + i),
                              "labels": _tokens(cfg, DOTS_BATCH, TRAIN_SEQ,
                                                95 + i)})
            return float(m["loss"])

        losses, ms, launches = _timed(one, DOTS_STEPS)
        timed[remat] = {"losses": losses, "ms": ms,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "launches": launches[0]}
        assert launches == [{"flash_attention": 2 * DOTS_LAYERS,
                             "flash_attention_bwd": DOTS_LAYERS}] * \
            DOTS_STEPS, launches
        del st
        _free_card()
    assert timed["dots"]["losses"][0] == timed["full"]["losses"][0] or \
        abs(timed["dots"]["losses"][0] - timed["full"]["losses"][0]) <= \
        1e-5 * abs(timed["full"]["losses"][0]), timed
    for remat, t in timed.items():
        print(f"{remat}: {cfg.name} x {DOTS_LAYERS} layers float32, "
              f"{DOTS_BATCH} x {TRAIN_SEQ} tokens: "
              f"{statistics.median(t['ms'][1:]):.3f} ms a step (steps 2-"
              f"{DOTS_STEPS}; step 1 {t['ms'][0]:.3f} ms), "
              f"max_memory_allocated {t['peak_bytes']:,} B, losses "
              f"{t['losses']}, launches a step {t['launches']}")
    return {"cuts": cuts, "fault_miss": miss[1], "timed": timed}


def _grad_cuts():
    """Phase 19's cuts: Qwen2.5-7B at 1 layer, RecurrentGemma-9B's
    pattern once plus its tail (5 layers), full width, float32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ScanGroup
    rg = get_config(RG_ARCH)
    return ((f"{ARCH} (1 layer)", cut_depth(ARCH, 1, torch.float32)),
            (f"{RG_ARCH} (main x 1 + tail)", dataclasses.replace(
                rg, n_layers=sum(len(g.pattern) for g in rg.groups),
                groups=tuple(ScanGroup(g.name, 1, g.pattern)
                             for g in rg.groups),
                param_dtype=torch.float32, compute_dtype=torch.float32)))


def _efficient_backward(q, k, v, dout):
    """The library's float32 attention backward on its own at
    TRAIN_SHAPE: one call of
    ``aten._scaled_dot_product_efficient_attention_backward`` (SDPA's
    efficient backend, causal) on q and on k and v expanded to the query
    heads, given the out and lse of its own forward (taken outside the
    timing) and dout.  Its dq, and its dk / dv summed over each kv head's
    group, are held against the f32tc backward kernel's on the same
    inputs (2e-3 of each gradient's max), so the time is of the same
    function.  Returns (ms: CUDA events, median of the rounds; that
    error)."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    aten = torch.ops.aten
    out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        q, k, v, None, True, 0.0, True)

    def bwd():
        return aten._scaled_dot_product_efficient_attention_backward(
            dout, q, k, v, None, out, lse, seed, offset, 0.0,
            [True, True, True, False], True)

    b, h, s, d = q.shape
    hkv = TRAIN_SHAPE[2]
    lib = bwd()[:3]
    lib = (lib[0], *(x.reshape(b, hkv, h // hkv, s, d).sum(2)
                     for x in lib[1:]))
    # k and v are repeat_interleave'd: kv head i is query head i * group's
    kk, vv = (x[:, ::h // hkv].contiguous() for x in (k, v))
    o, l = fmod.flash_attention_lse(q, kk, vv)
    ok, err = _grad_check(lib, fmod.flash_attention_bwd(q, kk, vv, o, l,
                                                        dout),
                          GRAD_TOL["float32"])
    assert ok, f"SDPA efficient backward against the f32tc kernel: {err}"
    del lib, kk, vv, o, l
    ms = _time_ms(bwd, torch, reps=2, rounds=3)
    return ms, err


def flash_train_library(stats):
    """Phase 22.6: the float32 training shape TRAIN_SHAPE ([4, 28, 4096,
    128], causal): ``scaled_dot_product_attention`` under each backend
    that takes float32, forward and forward + backward (k and v expanded
    to the 28 query heads beforehand, outside the timing), beside the
    f32tc forward and its backward kernel (timed in phase 20 against
    their bounds: 3xTF32 and, beside it, the FP32 pipe).  The fastest
    forward is the f32tc row's ``library_ms``; the backward row's is the
    efficient backend's backward on its own (``_efficient_backward``),
    with each backend's forward + backward less its forward beside it."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, h, hkv, s, d = TRAIN_SHAPE
    q = _randn((b, h, s, d), 1, torch.float32, torch).requires_grad_()
    k, v = (_randn((b, hkv, s, d), i, torch.float32, torch)
            .repeat_interleave(h // hkv, dim=1).requires_grad_()
            for i in (2, 3))
    g = _randn((b, h, s, d), 4, torch.float32, torch)
    times = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fwd():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (q, k, v), g)
        try:
            with sdpa_kernel(be), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                with torch.no_grad():
                    fwd()
                torch.cuda.synchronize()
                with torch.no_grad():
                    f_ms = _time_ms(fwd, torch, reps=2, rounds=3)
                fb_ms = _time_ms(fwd_bwd, torch, reps=1, rounds=3)
        except (RuntimeError, torch.cuda.OutOfMemoryError):
            continue
        times[be.name] = {"forward_ms": f_ms, "forward_backward_ms": fb_ms,
                          "backward_ms_by_difference": fb_ms - f_ms}
        _free_card()
    assert times, "no scaled_dot_product_attention backend took float32"
    lib_bwd, lib_err = _efficient_backward(q.detach(), k.detach(),
                                           v.detach(), g)
    del q, k, v, g
    _free_card()
    best = min(times, key=lambda n: times[n]["forward_ms"])
    fwd_row, bwd_row = stats["flash_attention_f32"], \
        stats["flash_attention_bwd"]
    fwd_row.update(library_ms=times[best]["forward_ms"], library=best,
                   train_library=times)
    bwd_row.update(library_ms=lib_bwd, library="aten._scaled_dot_product_"
                   "efficient_attention_backward", library_grad_err=lib_err,
                   train_library=times)
    print(f"flash at the training shape {list(TRAIN_SHAPE)} float32: "
          f"f32tc forward {fwd_row['ms']:.4f} ms (bound "
          f"{fwd_row['bound_ms']:.4f} ms 3xTF32, "
          f"{fwd_row['fp32_pipe_bound_ms']:.4f} ms FP32 pipe; simt "
          f"{fwd_row['simt_ms']:.4f} ms), backward kernel "
          f"{bwd_row['ms']:.4f} ms (bound {bwd_row['bound_ms']:.4f} ms "
          f"3xTF32, {bwd_row['fp32_pipe_bound_ms']:.4f} ms FP32 pipe; plain "
          f"recompute {bwd_row['plain_recompute_ms']:.4f} ms; the efficient "
          f"backend's backward alone {lib_bwd:.4f} ms, its gradients within "
          f"{lib_err:.3e} of the kernel's); "
          "scaled_dot_product_attention " + ", ".join(
              f"{n} forward {t['forward_ms']:.4f} ms, forward + backward "
              f"{t['forward_backward_ms']:.4f} ms (backward by difference "
              f"{t['backward_ms_by_difference']:.4f} ms)"
              for n, t in times.items()))
    return {"library": times, "forward_ms": fwd_row["ms"],
            "backward_ms": bwd_row["ms"], "library_backward_ms": lib_bwd}


def drive_distributed(stats):
    """Phase 22: a (1, 1) ("data", "model") mesh on DIST_BACKEND at world
    size 1: the train, prefill and decode cells, the pipeline on a
    ("pod",) mesh, remat="dots", the planted faults, the flash row's
    training-shape bound and library times."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    for row in ("flash_attention_f32", "flash_attention_bwd"):
        stats.setdefault(row, {"max_abs_err": 0.0})
    _process_group(ROOT / "build" / "dist_store")
    try:
        one = torch.ones(1, device=DEV)
        dist.all_reduce(one)
        assert float(one) == 1.0
        mesh = make_host_mesh(device_type=torch.device(DEV).type)
        train = check_train_cell(mesh)
        serve = check_serve_cells(mesh)
        from torch.distributed.device_mesh import init_device_mesh
        pod = Mesh(init_device_mesh(torch.device(DEV).type, (1,),
                                    mesh_dim_names=("pod",)))
        pipe = check_pipeline(pod)
    finally:
        dist.destroy_process_group()
    dots = check_dots()
    library = flash_train_library(stats)
    wall = time.perf_counter() - t0
    print(f"phase 22: {wall:.3f} s")
    return {"backend": DIST_BACKEND, "train_cell": train,
            "serve_cells": serve, "pipeline": pipe, "dots": dots,
            "flash_train_shape": library, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 23: the attention logit softcap and multi-token steps at a cache
# offset (chunked prefill through ``decode_step``)
# ---------------------------------------------------------------------------

# (softcap, query scale): a cap of 5 on unit-normal inputs, and Gemma 2's
# published attn_logit_softcapping of 50 with the queries x8 so that it
# binds (at 50 on unit inputs tanh is nearly linear, and a dropped cap
# would pass 2e-3)
CAPS = ((5.0, 1.0), (50.0, 8.0))
CAP_FAULTS = ("cap dropped", "cap after the mask", "offset ignored")
# prefills with a cap and a query offset, through the model's
# [B, S|T, heads, D] views: (label, B, H, Hkv, S, T, D, window, q_offset,
# the planted faults that must miss under one cap or the other).  Qwen's
# last 1,024-token chunk of a 4,096-token prompt and its first chunk (at
# offset 0 a row sees few keys, so the cap applied after the mask leaks
# most of its weight to the masked ones; past a long offset the leak is
# e^-5 a key spread over thousands of random values, below the bf16
# tolerance); gemma3's 384-token chunk at 768 under its 512 window, as the
# model hands it the cache rows [257, 1152) at q_offset 511 (the window's
# edge crosses the chunk); the simt kernel at a head dim outside the
# tensor-core routes
CAP_FLASH_CASES = (
    ("qwen chunk at 3072", 1, 28, 4, 1024, 4096, 128, None, 3072,
     ("cap dropped", "offset ignored")),
    ("qwen first chunk", 1, 28, 4, 1024, 1024, 128, None, 0,
     ("cap dropped", "cap after the mask")),
    ("gemma3 chunk at 768", 1, 4, 1, 384, 895, 256, 512, 511,
     ("cap dropped", "offset ignored")),
    ("gemma3 first chunk", 1, 4, 1, 384, 384, 256, 512, 0,
     ("cap dropped", "cap after the mask")),
    ("D=96 chunk at 512", 1, 8, 2, 256, 768, 96, None, 512,
     ("cap dropped", "offset ignored")),
    ("D=96 windowed chunk at 200", 1, 8, 2, 256, 456, 96, 128, 200,
     ("cap dropped", "offset ignored")),
)
# decodes with a cap: (label, B, H, Hkv, T, D) at DECODE_RAGGED lengths
# (the length-17 row's masked keys expose the cap after the mask)
CAP_DECODE_CASES = (("qwen", 4, 28, 4, 4096, 128),
                    ("gemma3", 4, 4, 1, 4096, 256))
# the f32tc backward with a cap at the training shapes: (label, (B, H,
# Hkv, S, D), window)
CAP_BWD_CASES = (("qwen", (1, 28, 4, 4096, 128), None),
                 ("gemma3 windowed", (1, 4, 1, 4096, 256), 512))
CHUNK_PROMPT, CHUNK = 4096, 1024          # Qwen's chunked prefill
GEMMA3_PROMPT, GEMMA3_CHUNK = 1536, 384
GEMMA2_CAP = 50.0                         # Gemma 2's published softcap
TRAIN_CAP, CAP_GRAD_LAYERS, CAP_GRAD_SEQ = 5.0, 6, 1024
WHISPER_STEP = (48, 3)                    # (offset, tokens) of its step


def _fold_misses(seen, want, faults, tol):
    """Fold each planted fault's check into ``seen`` {name: (missed under
    some cap so far, its largest max abs error from ``want``)}: a fault
    misses where ``_close(fault, want, tol)`` fails."""
    for name, f in faults.items():
        ok, err = _close(f, want, tol)
        missed, worst = seen.get(name, (False, 0.0))
        seen[name] = (missed or not ok, max(worst, err))


def check_cap_kernels():
    """Phase 23a: every attention kernel with a softcap (and the flash
    kernels with a query offset) against its plain version on the same
    inputs, each call's route asserted, tolerance 2e-3 float32 / 2e-2
    bf16, under both CAPS: the sm90 and f32tc kernels at CAP_FLASH_CASES'
    tensor-core head dims, the simt kernel in float32 at D = 96, the
    decode kernel's split and single routes at CAP_DECODE_CASES in bf16
    and float32.  The planted faults of ``ref.flash_attention_faults``
    and ``ref.decode_attention_faults`` must each miss the check under
    one cap or the other wherever a case lists them (every decode case
    lists both of its faults), and every fault must miss somewhere.  Returns {kernel: worst
    error}."""
    import torch

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref
    worst = {"flash_attention": 0.0, "flash_attention_f32": 0.0,
             "flash_attention_simt": 0.0, "decode_attention": 0.0}
    missed = {n: 0 for n in CAP_FAULTS}
    for i, (label, b, h, hkv, s, t, d, window, off, must) in enumerate(
            CAP_FLASH_CASES):
        dts = (torch.float32,) if d not in fmod.TC_HEAD_DIMS else \
            (torch.bfloat16, torch.float32)
        for dt in dts:
            tol = ATTN_TOL[str(dt).split(".")[-1]]
            way = fmod.route(dt, d)
            seen, errs = {}, []
            for cap, scale in CAPS:
                q, k, v = _qkv(b, h, hkv, s, t, d, True, 600 + 10 * i, dt,
                               torch)
                q = (q.float() * scale).to(dt)
                kw = dict(causal=True, window=window, softcap=cap,
                          q_offset=off)
                got = _routed("flash_attention", way,
                              lambda: ops.flash_attention(q, k, v, **kw))
                want = ref.flash_attention_ref(q, k, v, **kw)
                errs.append(_attn_close(got, want, tol,
                                        f"{way} {label} cap {cap}"))
                _fold_misses(seen, want, ref.flash_attention_faults(
                    q, k, v, **kw), tol)
                del q, k, v, got, want
            for n in must:
                assert seen[n][0], (f"{way} {label}: the check passes the "
                                    f"planted fault {n} under both caps "
                                    f"({seen[n][1]:.3e})")
            for n, (miss, _) in seen.items():
                missed[n] += int(miss)
            row = {"sm90": "flash_attention", "f32tc": "flash_attention_f32",
                   "simt": "flash_attention_simt"}[way]
            worst[row] = max(worst[row], *errs)
            print(f"cap {way:5s} {label:28s} {str(dt)[6:]:8s} B,H,Hkv,S,T,D="
                  f"{(b, h, hkv, s, t, d)} window={window} q_offset={off}: "
                  f"max abs err " + ", ".join(
                      f"cap {c} {e:.3e}" for (c, _), e in zip(CAPS, errs))
                  + f" (tol {tol}); faults " + ", ".join(
                      f"{n} {e:.3e}" + (" misses" if m else "")
                      for n, (m, e) in seen.items()))
    for i, (label, b, h, hkv, t, d) in enumerate(CAP_DECODE_CASES):
        for dt in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL[str(dt).split(".")[-1]]
            pl = dmod.plan(b, h, hkv, t, d, dmod._sms(torch.device(DEV)))
            way = "split" if pl.splits > 1 else "single"
            one = dmod.Plan(1, -(-t // dmod.TILE) * dmod.TILE)
            length = torch.tensor(DECODE_RAGGED, dtype=torch.int32,
                                  device=DEV)
            seen, errs = {}, []
            for cap, scale in CAPS:
                q = (_randn((b, h, d), 700 + 10 * i, torch.float32, torch)
                     * scale).to(dt)
                k = _randn((b, t, hkv, d), 701 + 10 * i, dt,
                           torch).transpose(1, 2)
                v = _randn((b, t, hkv, d), 702 + 10 * i, dt,
                           torch).transpose(1, 2)
                want = ref.decode_attention_ref(q, k, v, length,
                                                softcap=cap)
                got = _routed("decode_attention", way,
                              lambda: ops.decode_attention(
                                  q, k, v, length, softcap=cap))
                single = torch.empty_like(q)
                _raw_decode(q, k, v, length, single, one, softcap=cap)()
                errs.append(max(
                    _attn_close(got, want, tol, f"{way} decode {label}"),
                    _attn_close(single, want, tol,
                                f"single decode {label}")))
                _fold_misses(seen, want, ref.decode_attention_faults(
                    q, k, v, length, softcap=cap), tol)
            for n, (miss, e) in seen.items():
                assert miss, (f"decode {label}: the check passes the "
                              f"planted fault {n} under both caps ({e:.3e})")
                missed[n] += 1
            worst["decode_attention"] = max(worst["decode_attention"], *errs)
            print(f"cap decode {way}+single {label:8s} {str(dt)[6:]:8s} "
                  f"B,H,Hkv,T,D={(b, h, hkv, t, d)} lengths "
                  f"{list(DECODE_RAGGED)}: max abs err " + ", ".join(
                      f"cap {c} {e:.3e}" for (c, _), e in zip(CAPS, errs))
                  + f" (tol {tol}); faults " + ", ".join(
                      f"{n} {e:.3e} misses" for n, (m, e) in seen.items()))
    assert all(missed.values()), missed
    torch.cuda.synchronize()
    return worst


def check_cap_f32tc():
    """Phase 23a, float32 training route with the cap: the f32tc forward
    and its backward kernel against float64 at F32_ACC_SLICE under both
    CAPS (each output's and gradient's max abs error over its max at
    most 4x the plain float32 version's; two backward calls bit-equal);
    then the backward kernel against ``ref.flash_attention_bwd_ref`` with
    the cap at CAP_BWD_CASES (Qwen's training shape and gemma3's windowed
    one), within 2e-3 of each gradient's max, where the planted backward
    faults (Delta dropped, one head of the group where the group has
    several, and the cap's derivative 1 - (Sc / c)^2 dropped) must miss.
    Returns the float64 errors."""
    import torch

    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    b, h, hkv, s, d = F32_ACC_SLICE
    acc = {}
    for cap, scale in CAPS:
        q, k, v = _qkv(b, h, hkv, s, s, d, False, 800, torch.float32, torch)
        q = q * scale
        dout = _randn((b, h, s, d), 805, torch.float32, torch)
        out, lse = _routed("flash_attention", "f32tc", lambda: (
            fmod.flash_attention_lse(q, k, v, softcap=cap)))
        plain_out = ref.flash_attention_ref(q, k, v, softcap=cap)
        exact_out, _ = ref.flash_attention_lse_ref(
            q.double(), k.double(), v.double(), softcap=cap)
        got = fmod.flash_attention_bwd(q, k, v, out, lse, dout, softcap=cap)
        again = fmod.flash_attention_bwd(q, k, v, out, lse, dout,
                                         softcap=cap)
        assert all(bool(torch.equal(x, y)) for x, y in zip(got, again)), \
            f"cap {cap}: two backward calls differ"
        plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                            softcap=cap)
        exact = ref.flash_attention_bwd_ref(*(x.double() for x in (
            q, k, v, out, lse, dout)), softcap=cap)
        e = {}
        for n, g, pl_, w in (("out", out, plain_out, exact_out),
                             *zip(("dq", "dk", "dv"), got, plain, exact)):
            m = float(w.abs().max())
            e[n] = {"kernel": float((g.double() - w).abs().max()) / m,
                    "plain_f32": float((pl_.double() - w).abs().max()) / m}
        assert all(x["kernel"] <= 4 * x["plain_f32"] for x in e.values()), \
            (cap, e)
        acc[f"cap {cap}"] = e
        print(f"cap f32tc at {list(F32_ACC_SLICE)} cap {cap} (queries "
              f"x{scale:g}) against float64, max abs err over the max: "
              + "; ".join(f"{n} kernel {x['kernel']:.3e}, plain float32 "
                          f"{x['plain_f32']:.3e}" for n, x in e.items())
              + " (bound 4x plain); two backward calls bit-equal")
        del q, k, v, out, lse, got, again, plain, exact
    tol = GRAD_TOL["float32"]
    bwd = {}
    for label, (b, h, hkv, s, d), window in CAP_BWD_CASES:
        q, k, v = _qkv(b, h, hkv, s, s, d, True, 820, torch.float32, torch)
        dout = _randn((b, s, h, d), 825, torch.float32, torch).transpose(1, 2)
        kw = dict(causal=True, window=window, softcap=TRAIN_CAP)
        out, lse = fmod.flash_attention_lse(q, k, v, **kw)
        kern = fmod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        ok, rel = _grad_check(kern, plain, tol)
        assert ok, f"cap backward {label}: off its plain version by {rel}"
        faults = {n: _grad_check(f, plain, tol)
                  for n, f in ref.flash_attention_bwd_faults(
                      q, k, v, out, lse, dout, **kw).items()
                  if h > hkv or n != "one head of the group"}
        assert not any(m[0] for m in faults.values()), faults
        bwd[label] = rel
        print(f"cap f32tc backward {label} [{b}, {h}, {hkv}, {s}, {d}] "
              f"window={window} cap {TRAIN_CAP}: within {rel:.3e} of its "
              f"plain version's max (tol {tol}); faults miss: " + ", ".join(
                  f"{n} {m[1]:.3e}" for n, m in faults.items()))
        del q, k, v, out, lse, kern, plain
        _free_card()
    return {"accuracy_vs_float64": acc, "backward_vs_plain": bwd}


def time_cap():
    """CUDA-event times with the cap off and on, on the same inputs, off
    / on / on / off (the median of each pair): the sm90 kernel at Qwen's
    causal S = T = 2,048 (bf16), the f32tc forward and its backward at
    TRAIN_SHAPE, and the decode kernel's split route at Qwen's B = 4,
    T = 4,096 (bf16, every row at full length, rotating over input sets
    of >= ROTATE_BYTES).  Returns {kernel: {"off": ms, "on": ms}}."""
    import torch

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    out = {}

    def pair(fn_off, fn_on, **kw):
        a = [_time_ms(fn_off, torch, **kw), _time_ms(fn_on, torch, **kw)]
        a += [_time_ms(fn_on, torch, **kw), _time_ms(fn_off, torch, **kw)]
        return {"off": statistics.median((a[0], a[3])),
                "on": statistics.median((a[1], a[2])), "turns": a}

    b, h, hkv, s, d = 1, 28, 4, 2048, 128
    q, k, v = _qkv(b, h, hkv, s, s, d, True, 900, torch.bfloat16, torch)
    o = torch.empty_like(q)
    out["flash_attention"] = pair(
        _raw_flash(q, k, v, o, None, "sm90"),
        _raw_flash(q, k, v, o, None, "sm90", softcap=GEMMA2_CAP))
    out["flash_attention"]["shape"] = f"B,H,Hkv,S=T,D={(b, h, hkv, s, d)} " \
        "causal bf16"
    del q, k, v, o
    b, h, hkv, s, d = TRAIN_SHAPE
    q, k, v = _qkv(b, h, hkv, s, s, d, False, 910, torch.float32, torch)
    dout = _randn((b, h, s, d), 915, torch.float32, torch)
    res = {}
    for cap in (None, TRAIN_CAP):
        res[cap] = fmod.flash_attention_lse(q, k, v, softcap=cap)
    out["flash_attention_f32"] = pair(
        lambda: fmod.flash_attention_lse(q, k, v),
        lambda: fmod.flash_attention_lse(q, k, v, softcap=TRAIN_CAP), reps=5)
    out["flash_attention_bwd"] = pair(
        lambda: fmod.flash_attention_bwd(q, k, v, *res[None], dout),
        lambda: fmod.flash_attention_bwd(q, k, v, *res[TRAIN_CAP], dout,
                                         softcap=TRAIN_CAP), reps=5)
    for n in ("flash_attention_f32", "flash_attention_bwd"):
        out[n]["shape"] = f"B,H,Hkv,S=T,D={TRAIN_SHAPE} causal float32"
    del q, k, v, dout, res
    _free_card()
    b, h, hkv, t, d = DECODE_TIMED
    q = _randn((b, h, d), 920, torch.bfloat16, torch)
    sets = [(_randn((b, hkv, t, d), 921 + 2 * j, torch.bfloat16, torch),
             _randn((b, hkv, t, d), 922 + 2 * j, torch.bfloat16, torch))
            for j in range(_sets(2 * b * hkv * t * d * 2))]
    length = torch.full((b,), t, dtype=torch.int32, device=DEV)
    pl = dmod.plan(b, h, hkv, t, d, dmod._sms(q.device))
    outs = [torch.empty_like(q) for _ in sets]

    def rot(cap):
        fns = [_raw_decode(q, k_, v_, length, o_, pl, softcap=cap)
               for (k_, v_), o_ in zip(sets, outs)]
        return lambda: _time_rot(fns, torch)

    a = [rot(None)(), rot(GEMMA2_CAP)(), rot(GEMMA2_CAP)(), rot(None)()]
    out["decode_attention"] = {
        "off": statistics.median((a[0], a[3])),
        "on": statistics.median((a[1], a[2])), "turns": a,
        "shape": f"B,H,Hkv,T,D={DECODE_TIMED} length {t} bf16, "
                 f"{pl.splits} splits"}
    del q, sets, outs
    for n, r in out.items():
        print(f"time cap {n:20s} {r['shape']}: cap off {r['off']:.4f} ms, "
              f"on {r['on']:.4f} ms ({r['on'] / r['off']:.3f}x; turns "
              + ", ".join(f"{x:.4f}" for x in r["turns"]) + ")")
    return out


def _greedy_pair(a, b, label):
    """Two runs' logits [B, V] of one call: their max abs distance over
    the max of ``a``, and whether b's greedy token equals a's wherever
    a's top-two gap exceeds twice the distance (asserted); returns
    (relative distance, rows whose gap was too close to call)."""
    import torch
    dist = float((a - b).abs().max())
    top2 = torch.topk(a, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    clear = gap > 2 * dist
    assert torch.equal(torch.argmax(a, -1)[clear],
                       torch.argmax(b, -1)[clear]), label
    return dist / float(a.abs().max()), int((~clear).sum())


def _chunked_run(cfg, params, tokens, chunk, steps, forced=None):
    """``prefill`` of the first ``chunk`` tokens, then ``decode_step`` of
    ``chunk`` tokens at each later offset (a chunked prefill), then
    ``steps`` one-token steps fed ``forced`` [B, steps] (or the greedy
    token), into a cache of len(tokens) + steps + 8 rows; each call's
    launches counted (counters reset just before, read just after) and
    timed (host clock, synchronised).  With ``chunk`` the whole prompt it
    is a one-shot prefill.  Returns (the prompt's last logits, each
    step's logits, the tokens the steps were fed [B, steps], [(kind,
    ms, launches, routes)])."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import (build_cache_specs, decode_step,
                                    materialize, prefill)
    b, n = tokens.shape
    caches = materialize(build_cache_specs(cfg, b, n + steps + 8,
                                           cfg.compute_dtype),
                         torch.Generator(), DEV)
    calls = []

    def call(kind, fn):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        calls.append((kind, (time.perf_counter() - t0) * 1e3,
                      {k: c for k, c in ops.launch_counts().items() if c},
                      ops.route_counts()))
        assert bool(torch.isfinite(res[0]).all()), kind
        return res

    logits, caches = call("prefill", lambda: prefill(
        params, {"tokens": tokens[:, :chunk]}, caches, cfg))
    for off in range(chunk, n, chunk):
        logits, caches = call("chunk", lambda: decode_step(
            params, tokens[:, off:off + chunk], caches, off, cfg))
    last, outs, fed = logits.float(), [], []
    feed = torch.argmax(logits, -1)
    for i in range(steps):
        if forced is not None:
            feed = forced[:, i]
        fed.append(feed)
        logits, caches = call("step", lambda: decode_step(
            params, feed[:, None], caches, n + i, cfg))
        outs.append(logits.float())
        feed = torch.argmax(logits, -1)
    del caches
    return last, outs, torch.stack(fed, 1), calls


def _chunk_counts(calls, n_attn, chunked):
    """The launch counts each call of ``_chunked_run`` must show: a
    prefill or a chunk ``n_attn`` sm90 ``flash_attention`` launches and
    no decode launch; a one-token step ``n_attn`` ``decode_attention``
    launches and no flash launch."""
    for kind, _, launches, routes in calls:
        if kind in ("prefill", "chunk"):
            assert launches == {"flash_attention": n_attn} and \
                routes["sm90"] == n_attn, (kind, launches, routes)
        else:
            assert launches == {"decode_attention": n_attn}, (kind, launches)
    assert chunked == any(c[0] == "chunk" for c in calls)


def _chunk_compare(cfg, params, tokens, chunk, label, gated=True):
    """A one-shot prefill of ``tokens`` and a chunked one (chunks of
    ``chunk``), then 8 one-token steps from each cache fed the one-shot
    run's greedy tokens (``_chunked_run``), after a warm-up of both
    (the calls time the card's work, not the first use of a shape): exact
    launch counts, and with ``gated`` the last logits within 2e-2 of
    their max and each step's greedy token equal wherever the top-two
    gap exceeds twice the distance (otherwise printed only).  Returns
    the figures."""
    import torch
    _chunked_run(cfg, params, tokens, tokens.shape[1], 1)       # warm-up
    _chunked_run(cfg, params, tokens[:, :2 * chunk], chunk, 1)
    one = _chunked_run(cfg, params, tokens, tokens.shape[1], 8)
    chunked = _chunked_run(cfg, params, tokens, chunk, 8, forced=one[2])
    _chunk_counts(one[3], cfg.n_layers, False)
    _chunk_counts(chunked[3], cfg.n_layers, True)
    pairs = [(one[0], chunked[0])] + list(zip(one[1], chunked[1]))
    if gated:
        dists = [_greedy_pair(a, b, f"{label} call {i}")
                 for i, (a, b) in enumerate(pairs)]
    else:
        dists = [(float((a - b).abs().max() / a.abs().max()), 0)
                 for a, b in pairs]
    res = {"one_shot_prefill_ms": one[3][0][1],
           "chunk_ms": [c[1] for c in chunked[3] if c[0] != "step"],
           "step_ms": [c[1] for c in chunked[3] if c[0] == "step"],
           "last_logits_rel": dists[0][0],
           "step_logits_rel": max(x[0] for x in dists[1:]),
           "too_close_to_call": sum(x[1] for x in dists),
           "launches_per_chunk": chunked[3][1][2],
           "launches_per_step": chunked[3][-1][2], "gated": gated}
    if gated:
        assert res["last_logits_rel"] <= ATTN_TOL["bfloat16"], res
    n = tokens.shape[1]
    print(f"chunked {label} bf16, {n}-token prompt: one-shot prefill "
          f"{res['one_shot_prefill_ms']:.2f} ms; chunks of {chunk} (prefill "
          f"then decode_step at {list(range(chunk, n, chunk))}) "
          + ", ".join(f"{x:.2f}" for x in res["chunk_ms"]) + " ms; last "
          f"logits {res['last_logits_rel']:.3e} of the max from one-shot ("
          + (f"limit {ATTN_TOL['bfloat16']}" if gated else "not gated")
          + f"); 8 steps fed the one-shot greedy tokens: logits within "
          f"{res['step_logits_rel']:.3e}" + (
              f", greedy tokens equal where called "
              f"({res['too_close_to_call']} calls too close)" if gated
              else "") + f"; launches a chunk {res['launches_per_chunk']} "
          f"(all sm90), a step {res['launches_per_step']}; step ms "
          + ", ".join(f"{x:.2f}" for x in res["step_ms"]))
    del one, chunked
    return res


def check_chunked_qwen():
    """Phase 23b: Qwen2.5-7B at full width and depth (28 layers), bf16,
    random weights: a 4,096-token prompt prefilled at once, and as a
    1,024-token prefill then three ``decode_step``s of 1,024 tokens at
    1,024, 2,048 and 3,072, each into a 4,104-row cache, then 8 one-token
    steps from each cache fed the one-shot run's greedy tokens: last
    logits within 2e-2 of their max, every step's greedy token equal
    wherever the top-two gap exceeds twice the distance, exactly 28 sm90
    flash launches and no decode launch a chunk, 28 decode launches a
    step; ms a chunk beside ms of the one-shot prefill
    (``_chunk_compare``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_param_specs, materialize
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    tokens = torch.randint(0, cfg.vocab_size, (1, CHUNK_PROMPT),
                           generator=torch.Generator().manual_seed(3)).to(DEV)
    res = _chunk_compare(cfg, params, tokens, CHUNK, "qwen2-5-7b full "
                         "width and depth")
    del params
    _free_card()
    print(f"phase 23b: {time.perf_counter() - t0:.1f} s")
    return res


def check_chunked_gemma3():
    """Phase 23c: gemma3-1b at full width (26 layers), bf16: a 1,536-
    token prompt prefilled at once and in chunks of 384 (its local
    layers' 512 window crossed inside chunks), as phase 23b, twice: at
    the reference's init, where gemma3 is chaotic (phase 13: float32
    runs that differ only in rounding land 0.2 of the max apart), every
    kernel call held against float64 attention on its own inputs
    (``_KernelSpy``, 2e-2 of the output's max) and the logits printed
    ungated; at the d_model fan-in law every gate of phase 23b.  Then,
    on the fan-in weights, with ``attn_logit_softcap`` = 50 (Gemma 2's
    published value; the scores there spread over ~1, so these runs hold
    the cap's plumbing at full width, and 23a binds it): the first chunk
    and 8 steps in bf16 with the kernels and with the plain attention
    swapped in, each against float32 with the kernels on the same
    weights, the kernel run no farther from float32 than 2x the plain
    one (phase 6's gate); then the capped config cut to 6 layers (one
    superlayer) in float32 at the d_model fan-in law (``check_depth``
    with every kernel call held against float64 capped attention on its
    own inputs, the logits against a float64 run)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_param_specs, materialize
    t0 = time.perf_counter()
    cfg = get_config(GEMMA3)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    tokens = torch.randint(0, cfg.vocab_size, (1, GEMMA3_PROMPT),
                           generator=torch.Generator().manual_seed(4)).to(DEV)
    res = {}
    with _KernelSpy() as spy:
        res["reference_init"] = _chunk_compare(
            cfg, params, tokens, GEMMA3_CHUNK, "gemma3-1b full width, the "
            "reference's init", gated=False)
    print(f"gemma3-1b chunked at the reference's init: kernel calls "
          f"against float64 attention: {spy.line()}")
    _fan_in_d_model(params, cfg)
    res["fan_in_d_model"] = _chunk_compare(
        cfg, params, tokens, GEMMA3_CHUNK, "gemma3-1b full width, "
        "_fan_in_d_model")
    capped = dataclasses.replace(cfg, attn_logit_softcap=GEMMA2_CAP)
    c32 = dataclasses.replace(capped, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    w32 = _cast(params, torch.float32)
    short = tokens[:, :GEMMA3_CHUNK]
    kern = _chunked_run(capped, params, short, GEMMA3_CHUNK, 8)
    with _Plain("flash_attention"), _Plain("decode_attention"):
        plain = _chunked_run(capped, params, short, GEMMA3_CHUNK, 8,
                             forced=kern[2])
    f32 = _chunked_run(c32, w32, short, GEMMA3_CHUNK, 8, forced=kern[2])
    assert not plain[3][0][2], plain[3][0][2]
    _chunk_counts(kern[3], cfg.n_layers, False)
    dk, dp = [], []
    for a, b, c in zip([kern[0]] + kern[1], [plain[0]] + plain[1],
                       [f32[0]] + f32[1]):
        m = float(c.abs().max())
        dk.append(float((a - c).abs().max()) / m)
        dp.append(float((b - c).abs().max()) / m)
    assert max(dk) <= 2 * max(dp), (dk, dp)
    res["capped_bf16_vs_f32"] = {"kernels": max(dk), "plain": max(dp)}
    print(f"gemma3-1b bf16 with attn_logit_softcap {GEMMA2_CAP}, "
          f"{GEMMA3_CHUNK}-token prompt + 8 steps: max |logits - float32| "
          f"/ max|float32| {max(dk):.3e} with the kernels, {max(dp):.3e} "
          f"with the plain attention (limit 2x)")
    del params, w32, kern, plain, f32
    _free_card()
    c6 = dataclasses.replace(cut_depth(GEMMA3, 6, torch.float32),
                             attn_logit_softcap=GEMMA2_CAP)
    res["depth6_f32"] = check_depth(c6, prompt_len=600,
                                    weights=_fan_in_d_model, cpu=False)
    print(f"phase 23c: {time.perf_counter() - t0:.1f} s")
    return res


def check_cap_grads():
    """Phase 23d: ``train_loss``'s gradients with ``attn_logit_softcap``
    = 5 at gemma3-1b's width, 6 layers (one superlayer), float32, S =
    1,024, at the d_model fan-in law: the kernels (every f32tc forward and
    backward call held against its plain version in float64, ``_GradSpy``)
    against the same call with the plain versions patched into ``ops``;
    every leaf within 2e-3 of its max, exactly 2 f32tc forward launches
    and 1 backward launch an attention layer, none with the plain
    versions."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_param_specs, materialize
    t0 = time.perf_counter()
    cfg = dataclasses.replace(
        cut_depth(GEMMA3, CAP_GRAD_LAYERS, torch.float32),
        attn_logit_softcap=TRAIN_CAP)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    _fan_in_d_model(params, cfg)
    tok = torch.randint(0, cfg.vocab_size, (1, CAP_GRAD_SEQ + 1),
                        generator=torch.Generator().manual_seed(5),
                        dtype=torch.int32).to(DEV)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    ops.reset_launches()
    with _GradSpy() as spy:
        loss, got = _loss_grads(cfg, params, batch)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    routes = ops.route_counts()
    ops.reset_launches()
    with _PlainOps():
        want_loss, want = _loss_grads(cfg, params, batch)
    assert not any(ops.launch_counts().values())
    n = CAP_GRAD_LAYERS
    assert counts == {"flash_attention": 2 * n, "flash_attention_bwd": n}, \
        counts
    assert routes["f32tc"] == 2 * n, routes
    ok, worst = _grad_check([g for _, g in got], [w for _, w in want], 2e-3)
    assert ok, f"capped gradients: a leaf off by {worst:.3e}"
    assert abs(loss - want_loss) <= 2e-3 * abs(want_loss), (loss, want_loss)
    print(f"capped train_loss gradients, gemma3-1b width x {n} layers, "
          f"float32, S = {CAP_GRAD_SEQ}, softcap {TRAIN_CAP} (d_model "
          f"fan-in law): loss {loss!r} (plain {want_loss!r}); {len(got)} "
          f"leaves within {worst:.3e} of their max (limit 2e-3); kernel "
          f"calls: {spy.line()}; launches {counts} "
          f"({time.perf_counter() - t0:.1f} s)")
    del params, got, want
    _free_card()
    return {"worst_leaf": worst, "launches": counts}


def check_whisper_step():
    """Phase 23e: whisper-base (float32, full depth, the d_model fan-in
    law) prefilled with 48 tokens against 1,500 source frames, then one
    ``decode_step`` of 3 tokens at offset 48: every decoder layer's self-
    attention a causal flash call at q_offset 48 and its cross-attention
    a non-causal flash call of the 3 queries against the 1,500 encoder
    rows (12 flash launches, no decode launch), each call held against
    float64 attention on its own inputs (``_KernelSpy``); the logits
    within 2e-3 of their max of the same step with the plain versions."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import (build_cache_specs, build_param_specs,
                                    decode_step, materialize, prefill)
    cfg = dataclasses.replace(get_config(WHISPER), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), DEV)
    _fan_in_d_model(params, cfg)
    g = torch.Generator().manual_seed(6)
    off, s = WHISPER_STEP
    tokens = torch.randint(0, cfg.vocab_size, (1, off + s), generator=g)
    src = torch.randn((1, cfg.encoder.source_len, cfg.d_model), generator=g)
    caches = materialize(build_cache_specs(cfg, 1, off + s + 8,
                                           torch.float32),
                         torch.Generator(), DEV)
    _, caches = prefill(params, {"tokens": tokens[:, :off].to(DEV),
                                 "source_embeds": src.to(DEV)}, caches, cfg)
    step = tokens[:, off:].to(DEV)
    ops.reset_launches()
    with _KernelSpy() as spy:
        got, _ = decode_step(params, step, caches, off, cfg)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    n_dec = sum(g_.repeats * len(g_.pattern) for g_ in cfg.groups
                if g_.name != "enc")
    assert counts == {"flash_attention": 2 * n_dec}, counts
    with _Plain("flash_attention"), _Plain("decode_attention"):
        want, _ = decode_step(params, step, caches, off, cfg)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= REL_LOGITS, rel
    print(f"whisper-base float32 (fan-in law): a {s}-token decode_step at "
          f"offset {off} against {cfg.encoder.source_len} frames: launches "
          f"{counts} (self causal at q_offset {off}, cross non-causal), "
          f"kernel calls against float64: {spy.line()}; logits within "
          f"{rel:.3e} of the plain versions' (limit {REL_LOGITS})")
    del params, caches
    _free_card()
    return {"launches": counts, "logits_rel": rel}


def drive_cap_offset():
    """Phase 23: the logit softcap and multi-token steps at a cache offset
    on the card (23a the kernels, 23b-e the model's entry points);
    returns the phase's figures for the kernels line."""
    t0 = time.perf_counter()
    res = {"kernels": check_cap_kernels(), "f32tc": check_cap_f32tc(),
           "times": time_cap()}
    print(f"phase 23a: {time.perf_counter() - t0:.3f} s")
    res["qwen"] = check_chunked_qwen()
    res["gemma3"] = check_chunked_gemma3()
    res["grads"] = check_cap_grads()
    res["whisper"] = check_whisper_step()
    print(f"phase 23: {time.perf_counter() - t0:.3f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 24: the dry run (``launch/dryrun``) against phase 22's cells
# ---------------------------------------------------------------------------

DRY_PEAK_TOL = 0.05        # the traced peak vs max_memory_allocated
# one production cell traced at world size 256 (the (16, 16) mesh)
DRY_CELL = ("granite-20b", "decode_32k", "single")
# one production train cell in the sharded layout, run as rank 0
DRY_SHARDED = ("granite-20b", "train_4k", "single")
# the depth cut of DRY_SHARDED whose trace with the planted fault
# (``_kept_gathers``) is held against its own correct trace: the fault's
# excess grows by about 0.5 % of the peak a layer (traces of this cell at
# 2, 4, 8 and 20 layers: 1.4, 2.5, 4.7 and 10.5 %), so at 24 layers it
# misses by about 12.5 %, clear of KEPT_MISS
KEPT_LAYERS = 24
KEPT_MISS = 2 * DRY_PEAK_TOL
# the production serving cells in the sharded layout, run as rank 0
DRY_SERVING = (("granite-20b", "decode_32k", "single"),
               ("granite-20b", "prefill_32k", "single"))
# mixtral-8x22b's sharded cells, run as rank 0 of the (16, 16) mesh at
# MOE_LAYERS of its 56 layers (full width, bf16); the decode at MOE_POS,
# the last row of its 4,096 window's second 2,048-row block, so that
# rank 0 reads all of its block
MOE_ARCH = "mixtral-8x22b"
MOE_LAYERS = 4
MOE_POS = 4095


def _dry_cells():
    """(kind, config, shape, decode position) of phase 22's three cells
    at world size 1: Qwen2.5-7B at full width, DIST_LAYERS layers, the
    train cell in float32, the prefill and decode cells in bf16."""
    import torch
    train, pre, dec = _dist_shapes()
    f32 = cut_depth(ARCH, DIST_LAYERS, torch.float32)
    bf16 = cut_depth(ARCH, DIST_LAYERS, torch.bfloat16)
    return (("train", f32, train, None), ("prefill", bf16, pre, None),
            ("decode", bf16, dec, DECODE_POS))


def _dry_inputs(kind, cfg, shape, pos):
    """The cell's inputs on the card, made as phase 22 makes them."""
    import torch

    from repro_torch.launch.steps import input_specs
    from repro_torch.models import materialize
    specs = input_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        return [materialize(specs["state"], torch.Generator().manual_seed(0),
                            DEV),
                {"tokens": _tokens(cfg, b, s, 30),
                 "labels": _tokens(cfg, b, s, 40)}]
    params = materialize(specs["params"], torch.Generator().manual_seed(0),
                         DEV)
    caches = materialize(specs["caches"], torch.Generator().manual_seed(1),
                         DEV)
    if kind == "prefill":
        return [params, {"tokens": _tokens(cfg, b, s, 60)}, caches]
    return [params, _tokens(cfg, b, 1, 61), caches, pos]


def _real_cell(mesh, kind, cfg, shape, pos):
    """One step of ``jit_cell``'s cell on the card under
    ``FlopCounterMode``: its aten FLOPs, kernel launches and routes
    (counters reset just before the step, read just after), and the
    peak of ``max_memory_allocated`` above what the card held before
    the cell's inputs were made."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import jit_cell
    _free_card()
    base = torch.cuda.memory_allocated()
    args = _dry_inputs(kind, cfg, shape, pos)
    step, _ = jit_cell(cfg, shape, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    res = {"aten_flops": fc.get_total_flops(),
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "launches": {k: n for k, n in ops.launch_counts().items() if n},
           "routes": {op: {k: n for k, n in ops.route_counts(op).items()
                           if n} for op in ("flash_attention",
                                            "decode_attention",
                                            "rglru_scan")},
           "ms": ms}
    del out, args
    _free_card()
    return res


def _gap(got, want):
    return abs(got - want) / want


def _rank0_inputs(cfg, shape, mesh, pos=None):
    """Rank 0's blocks of a cell's inputs on the card, drawn at their
    local shapes from seed 0 (the state, or the weights), 1 (a cache:
    zeros) and 70 (the tokens), laid out as ``input_shardings`` over
    ``mesh`` (a fake group's); a decode cell at ``pos`` (default: its
    cache's last row)."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import entry_axes
    from repro_torch.launch.steps import input_shardings, input_specs
    from repro_torch.models import materialize
    from repro_torch.models.params import tree_map
    specs = input_specs(cfg, shape)
    shards = input_shardings(cfg, shape, mesh)

    def local(s, sh):
        dims = list(s.shape)
        for dim, entry in enumerate(sh.spec):
            for a in entry_axes(entry):
                dims[dim] //= mesh.shape[a]
        return dataclasses.replace(s, shape=tuple(dims))

    def laid_out(t, s, sh):
        return DTensor.from_local(
            t, mesh.device_mesh, sh.placements, run_check=False,
            shape=torch.Size(s.shape),
            stride=torch.empty(s.shape, device="meta").stride())

    def drawn(name, seed):
        t = materialize(tree_map(local, specs[name], shards[name]),
                        torch.Generator().manual_seed(seed), DEV)
        return tree_map(laid_out, t, specs[name], shards[name])

    def tokens(name):
        # token leaves drawn as tokens, a VLM's prefix embeddings as
        # unit normals
        toks = tree_map(lambda s, sh: s, specs[name], shards[name])
        leaves = toks.items() if isinstance(toks, dict) else [(None, toks)]
        out = {}
        for i, (k, s) in enumerate(leaves):
            dims = local(s, shards[name][k] if k else shards[name]).shape
            out[k] = _randn(dims, 70 + i, s.dtype, torch) \
                if s.dtype.is_floating_point else \
                _tokens(cfg, *dims, 70 + i)
        out = out if isinstance(toks, dict) else out[None]
        return tree_map(laid_out, out, specs[name], shards[name])

    if shape.kind == "train":
        return [drawn("state", 0), tokens("batch")]
    if shape.kind == "prefill":
        return [drawn("params", 0), tokens("batch"), drawn("caches", 1)]
    return [drawn("params", 0), tokens("tokens"), drawn("caches", 1),
            shape.seq_len - 1 if pos is None else pos]


def _rank0_step(cfg, shape, mesh, pos=None):
    """One step of ``jit_cell``'s cell on the card as rank 0 of
    ``mesh``: the kernel launches and routes (counters reset just before
    the step, read just after), the step's wall (host clock ending in a
    synchronize) and the peak of ``max_memory_allocated`` above what the
    card held before the inputs were made.  No FLOP counter runs (it
    would run ``silu_backward`` through its decomposition, whose
    temporaries the step does not make); a decode cell at ``pos``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import jit_cell
    _free_card()
    base = torch.cuda.memory_allocated()
    args = _rank0_inputs(cfg, shape, mesh, pos)
    step, _ = jit_cell(cfg, shape, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    res = {"ms": 1e3 * (time.perf_counter() - t0),
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "launches": {k: n for k, n in ops.launch_counts().items() if n},
           "routes": {op: {k: n for k, n in ops.route_counts(op).items()
                           if n} for op in ("flash_attention",
                                            "decode_attention",
                                            "rglru_scan")}}
    del out, args
    _free_card()
    return res


@contextlib.contextmanager
def _kept_gathers():
    """A planted layout fault, modelled in the trace: every layer's
    FSDP-gathered weights kept alive to the end of the step (a gather
    cache never freed), as a body that gathers each weight once and
    holds it would."""
    from repro_torch.distributed.sharding import ModelShards
    real = ModelShards.layer
    kept = []

    def layer(self, tree, *path):
        out = real(self, tree, *path)
        kept.append(out)
        return out

    ModelShards.layer = layer
    try:
        yield
    finally:
        ModelShards.layer = real
        kept.clear()


def check_sharded_rank0(card):
    """Phase 24.3: DRY_SHARDED (granite-20b x train_4k on the (16, 16)
    mesh, full width and depth, bf16) traced as the dry run traces it,
    then its step run for real as rank 0 of a ``fake`` group of 256 on
    the card (the weights drawn at their local shapes; the collectives
    complete at once and return nothing, so the values are not checked):
    the traced peak within DRY_PEAK_TOL of ``max_memory_allocated``, the
    launches and routes equal.  The planted fault (``_kept_gathers``) is
    traced on the cell cut to KEPT_LAYERS layers and must miss that
    cut's correct trace by more than KEPT_MISS (the full-depth trace is
    tied to the card by the gate above; a second trace of all 52 layers
    would take as long as the first)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import SHAPES
    arch, shape_name, mesh_name = DRY_SHARDED
    cfg, shape = get_config(arch), SHAPES[shape_name]
    traced = dryrun.run_cell(arch, shape_name, mesh_name, verbose=False)
    assert traced["layout"] == "sharded", traced["layout"]
    t0 = time.perf_counter()
    cut = cut_depth(arch, KEPT_LAYERS, torch.bfloat16)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type=dryrun.tensor_device("cuda"))
        clean = dryrun.trace_cell(cut, shape, mesh, mesh_name=mesh_name)
        with _kept_gathers():
            kept = dryrun.trace_cell(cut, shape, mesh, mesh_name=mesh_name)
    kept_wall = time.perf_counter() - t0
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cuda")
        real = _rank0_step(cfg, shape, mesh)
    want = {"flash_attention": 2 * cfg.n_layers}
    assert traced["kernel_launches"] == real["launches"] == want, (
        traced["kernel_launches"], real["launches"])
    assert traced["kernel_routes"] == real["routes"], (
        traced["kernel_routes"], real["routes"])
    assert real["routes"]["flash_attention"] == {"sm90": 2 * cfg.n_layers}
    gap = _gap(traced["peak_device_bytes"], real["peak_bytes"])
    miss = _gap(kept["peak_device_bytes"], clean["peak_device_bytes"])
    assert gap <= DRY_PEAK_TOL, (traced["peak_device_bytes"],
                                 real["peak_bytes"])
    assert miss > KEPT_MISS, (
        "the trace that keeps every layer's gathered weights does not miss "
        "its cut's correct trace by KEPT_MISS", kept["peak_device_bytes"],
        clean["peak_device_bytes"])
    print(f"sharded {arch} x {shape_name} rank 0 of {mesh_name} (16, 16), "
          f"{cfg.n_layers} layers bf16, {shape.global_batch // 16} rows x "
          f"{shape.seq_len // 16} tokens a rank: step {real['ms']:.3f} ms "
          f"({card}); launches {real['launches']} routes "
          f"{real['routes']} traced and real; peak "
          f"{traced['peak_device_bytes']:,} B traced vs "
          f"{real['peak_bytes']:,} B max_memory_allocated (gap "
          f"{100 * gap:.3f} %, gate {100 * DRY_PEAK_TOL:.0f} %; {card}); "
          f"at {KEPT_LAYERS} layers the kept-gathers trace "
          f"{kept['peak_device_bytes']:,} B vs the correct trace "
          f"{clean['peak_device_bytes']:,} B (gap {100 * miss:.1f} %, it "
          f"must exceed {100 * KEPT_MISS:.0f} %); useful-FLOP ratio "
          f"{traced['useful_flops_ratio']:.3f}; the {cfg.n_layers}-layer "
          f"trace {traced['trace_s']:.3f} s, the two {KEPT_LAYERS}-layer "
          f"traces {clean['trace_s']:.3f} / {kept['trace_s']:.3f} s "
          f"({kept_wall:.3f} s)")
    return {"cell": "_".join(DRY_SHARDED), "layout": traced["layout"],
            "step_ms": real["ms"], "launches": real["launches"],
            "routes": real["routes"],
            "predicted_peak": traced["peak_device_bytes"],
            "real_peak": real["peak_bytes"], "peak_gap": gap,
            "kept_layers": KEPT_LAYERS,
            "kept_clean_peak": clean["peak_device_bytes"],
            "kept_gathers_peak": kept["peak_device_bytes"],
            "kept_gathers_gap": miss, "kept_wall_s": kept_wall,
            "useful_flops_ratio": traced["useful_flops_ratio"],
            "collective_counts": traced["collective_counts"],
            "trace_s": traced["trace_s"], "card": card}


@contextlib.contextmanager
def _out_of_place_writes():
    """A planted layout fault of the sharded serving body, modelled in
    the trace: each layer's cache block written out of place
    (``torch.slice_scatter``, the gathered body's writer, whose kernel
    clones the whole stacked storage its view lies in) and an RG-LRU
    layer's new state returned, not written, so that ``_run_groups``
    restacks the new blocks."""
    import torch

    from repro_torch.models import attention, recurrent
    real, real_state = attention._kv_put, recurrent._state_put

    def put(cache, kv, lo, off):
        t, s = cache["k"].shape[1], kv["k"].shape[1]
        a = min(max(lo, off), lo + t)
        e = max(min(lo + t, off + s), a)
        return {n: torch.slice_scatter(
            cache[n], kv[n][:, a - off:e - off].to(cache[n].dtype), 1,
            a - lo, e - lo) for n in cache}

    attention._kv_put = put
    recurrent._state_put = lambda state, new: {
        n: v.to(state[n].dtype) for n, v in new.items()}
    try:
        yield
    finally:
        attention._kv_put, recurrent._state_put = real, real_state


@contextlib.contextmanager
def _whole_length_writes():
    """A planted layout fault of the sharded serving prefill, modelled
    in the trace: every layer's K/V of the whole sequence kept as cache
    rows to the end of the step (a cache not split by length over
    "model"), beside the rank's block written as before."""
    from repro_torch.models import attention
    real = attention._kv_put
    kept = []

    def put(cache, kv, lo, off):
        kept.append({n: v.to(cache[n].dtype) for n, v in kv.items()})
        return real(cache, kv, lo, off)

    attention._kv_put = put
    try:
        yield
    finally:
        attention._kv_put = real
        kept.clear()


def check_serving_rank0(card, decode=None):
    """Phase 24.3, serving: DRY_SERVING's cells (granite-20b x
    decode_32k at its last row, so rank 0 reads all 2,048 rows of its
    cache block, and x prefill_32k; the (16, 16) mesh, full width and
    depth, bf16, in the sharded serving layout) traced as the dry run
    traces them (``decode``: the decode cell's trace, if made already),
    then run for real as rank 0 of a ``fake`` group of 256 on the card
    (the weights drawn at their local shapes; the collectives complete
    at once and return nothing, so the values are not checked): the
    launches (one decode a layer on the plan's route; one sm90 flash a
    layer) and routes traced = real, the traced peak within DRY_PEAK_TOL
    of ``max_memory_allocated``; the traces with the planted faults
    (decode: the blocks written out of place and restacked,
    ``_out_of_place_writes``; prefill: the whole length kept as cache
    rows, ``_whole_length_writes``) must miss the peak gate."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import SHAPES
    res = {}
    for arch, shape_name, mesh_name in DRY_SERVING:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        t0 = time.perf_counter()
        traced = decode if decode is not None and \
            shape.kind == "decode" else \
            dryrun.run_cell(arch, shape_name, mesh_name, verbose=False)
        assert traced["layout"] == "sharded", traced["layout"]
        fault = _out_of_place_writes if shape.kind == "decode" else \
            _whole_length_writes
        with fault():
            bad = dryrun.run_cell(arch, shape_name, mesh_name,
                                  verbose=False)
        with dryrun.fake_group(256):
            mesh = make_production_mesh(device_type="cuda")
            real = _rank0_step(cfg, shape, mesh)
        n = cfg.n_layers
        if shape.kind == "decode":
            rows, block = shape.global_batch // 16, shape.seq_len // 16
            way = "split" if dmod.plan(rows, cfg.n_heads, cfg.n_kv_heads,
                                       block, cfg.head_dim_,
                                       dmod.FAKE_SMS).splits > 1 \
                else "single"
            want, routes = {"decode_attention": n}, {
                "decode_attention": {way: n}}
        else:
            want, routes = {"flash_attention": n}, {
                "flash_attention": {"sm90": n}}
        assert traced["kernel_launches"] == real["launches"] == want, (
            shape_name, traced["kernel_launches"], real["launches"])
        assert traced["kernel_routes"] == real["routes"], (
            shape_name, traced["kernel_routes"], real["routes"])
        for op, r in routes.items():
            assert real["routes"][op] == r, (shape_name, real["routes"])
        gap = _gap(traced["peak_device_bytes"], real["peak_bytes"])
        miss = _gap(bad["peak_device_bytes"], real["peak_bytes"])
        assert gap <= DRY_PEAK_TOL, (shape_name, traced["peak_device_bytes"],
                                     real["peak_bytes"])
        assert miss > DRY_PEAK_TOL, (
            f"the {fault.__name__} trace passes the peak gate of "
            f"{shape_name}", bad["peak_device_bytes"], real["peak_bytes"])
        print(f"sharded {arch} x {shape_name} rank 0 of {mesh_name} "
              f"(16, 16), {n} layers bf16: step {real['ms']:.3f} ms "
              f"({card}); launches {real['launches']} routes "
              f"{real['routes']} traced and real; peak "
              f"{traced['peak_device_bytes']:,} B traced vs "
              f"{real['peak_bytes']:,} B max_memory_allocated (gap "
              f"{100 * gap:.3f} %, gate {100 * DRY_PEAK_TOL:.0f} %; {card});"
              f" the {fault.__name__} trace {bad['peak_device_bytes']:,} B "
              f"(gap {100 * miss:.1f} %); useful-FLOP ratio "
              f"{traced['useful_flops_ratio']:.3f}; "
              f"{time.perf_counter() - t0:.3f} s")
        res[shape_name] = {
            "layout": traced["layout"], "step_ms": real["ms"],
            "launches": real["launches"], "routes": real["routes"],
            "predicted_peak": traced["peak_device_bytes"],
            "real_peak": real["peak_bytes"], "peak_gap": gap,
            "fault": fault.__name__, "fault_peak": bad["peak_device_bytes"],
            "fault_gap": miss,
            "useful_flops_ratio": traced["useful_flops_ratio"],
            "collective_counts": traced["collective_counts"],
            "trace_s": traced["trace_s"], "card": card}
    return res


@contextlib.contextmanager
def _whole_experts():
    """A planted layout fault of the sharded MoE bodies, modelled in the
    trace: each layer's expert weights (``wi_gate``, ``wi_up``, ``wo``)
    gathered whole over "model" too, as a body that split neither the
    experts nor their ffn would hold them, and the rank's block cut from
    them (a view, which keeps the whole alive through the layer)."""
    from repro_torch.distributed import sharding
    real = sharding.ModelShards.layer       # ServeShards' too

    def layer(self, tree, *path):
        out = real(self, tree, *path)
        ffn = out.get("ffn", {})
        if "router" not in ffn or self.size == 1:
            return out
        specs = sharding._at(self.specs, path)["ffn"]
        for name in ("wi_gate", "wi_up", "wo"):
            t = ffn[name]
            for dim, entry in enumerate(specs[name][1:]):
                if self.axis in sharding.entry_axes(entry):
                    n = t.shape[dim]
                    t = sharding._AllGather.apply(
                        t, dim, self._group(self.axis)).narrow(
                            dim, self.index * n, n)
            ffn[name] = t
        return out

    sharding.ModelShards.layer = layer
    try:
        yield
    finally:
        sharding.ModelShards.layer = real


@contextlib.contextmanager
def _rules_of(full):
    """``steps.rules_for`` choosing the rule set of the config ``full``
    (a depth cut's rules are its full depth's: the cut's fewer weights
    would replicate over "data" at serve time)."""
    from repro_torch.launch import steps
    real = steps.rules_for
    steps.rules_for = lambda shape, cfg=None: real(shape, full)
    try:
        yield
    finally:
        steps.rules_for = real


@contextlib.contextmanager
def _relaid(**entries):
    """The cells laid out by their rule sets with ``entries`` in place of
    theirs, and run in the sharded body all the same (a planted layout
    fault's frame)."""
    from repro_torch.launch import steps
    rules_for, layout = steps.rules_for, steps.layout
    steps.rules_for = lambda shape, cfg=None: dict(
        rules_for(shape, cfg), **entries)
    steps.layout = lambda *args, **kw: "sharded"
    try:
        yield
    finally:
        steps.rules_for, steps.layout = rules_for, layout


def _check_cut_rank0(arch, layers, pos, faults, card, gate=DRY_PEAK_TOL):
    """Phase 24.3's check of ``arch``'s train_4k, prefill_32k and
    decode_32k cells on the (16, 16) mesh in the sharded layout at
    ``layers`` of its layers (full width, bf16), each traced as the dry
    run traces it and then run for real as rank 0 of a ``fake`` group of
    256 on the card (the weights, and rank 0's cache block and a VLM's
    prefix block, drawn at their local shapes; the collectives complete
    at once and return nothing, so the values are not checked).  The cut
    takes the full depth's rules (``_rules_of``), the train cell one
    microbatch (the dry run's full-depth row may take more; on a fake
    group a gathered batch is uninitialised memory, whose tokens would
    index the table out of range), the decode cell ``pos``.  The
    launches of each mixer (``_cut_launches``: attention 2 sm90 flash a
    layer in train, 1 in prefill, 1 decode a layer on the plan's route
    for rank 0's 2,048-row block; RG-LRU 3 scans a layer in train, 1
    in prefill and decode; MLA none) and routes traced = real, a VLM's
    train trace four
    all-to-alls (its re-blocking, in and out, each way), the traced peak
    within ``gate`` of ``max_memory_allocated``; the trace with the
    planted fault ``faults[kind]`` must miss the peak gate."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import SHAPES
    full = get_config(arch)
    cfg = cut_depth(arch, layers, torch.bfloat16)
    n = cfg.n_layers
    res = {}
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SHAPES[shape_name]
        at = pos if shape.kind == "decode" else None
        fault = faults[shape.kind]
        t0 = time.perf_counter()
        with _rules_of(full), dryrun.fake_group(256):
            mesh = make_production_mesh(
                device_type=dryrun.tensor_device("cuda"))
            traced = dryrun.trace_cell(cfg, shape, mesh, pos=at,
                                       mesh_name="single")
            assert traced["layout"] == "sharded", traced["layout"]
            with fault():
                bad = dryrun.trace_cell(cfg, shape, mesh, pos=at,
                                        mesh_name="single")
            real = _rank0_step(cfg, shape, mesh, at)
        want = _cut_launches(cfg, shape, at, shape.global_batch // 16, 16)
        assert traced["kernel_launches"] == real["launches"] == {
            op: sum(r.values()) for op, r in want.items()}, (
            shape_name, traced["kernel_launches"], real["launches"])
        assert traced["kernel_routes"] == real["routes"], (
            shape_name, traced["kernel_routes"], real["routes"])
        assert real["routes"] == {op: want.get(op, {})
                                  for op in real["routes"]}, (
            shape_name, real["routes"])
        if cfg.n_prefix_embeddings and shape.kind == "train":
            assert traced["collective_counts"]["all-to-all"] == 4, \
                traced["collective_counts"]
        gap = _gap(traced["peak_device_bytes"], real["peak_bytes"])
        miss = _gap(bad["peak_device_bytes"], real["peak_bytes"])
        assert gap <= gate, (shape_name, traced["peak_device_bytes"],
                             real["peak_bytes"])
        assert miss > gate, (
            f"the {fault.__name__} trace passes the peak gate of "
            f"{shape_name}", bad["peak_device_bytes"], real["peak_bytes"])
        wall = time.perf_counter() - t0
        print(f"sharded {arch} x {shape_name} rank 0 of single (16, 16), "
              f"{n} of {full.n_layers} layers bf16: step "
              f"{real['ms']:.3f} ms ({card}); launches {real['launches']} "
              f"routes {real['routes']} traced and real; peak "
              f"{traced['peak_device_bytes']:,} B traced vs "
              f"{real['peak_bytes']:,} B max_memory_allocated (gap "
              f"{100 * gap:.3f} %, gate {100 * gate:.1f} %; {card}); the "
              f"{fault.__name__} trace {bad['peak_device_bytes']:,} B (gap "
              f"{100 * miss:.1f} %); collectives "
              f"{traced['collective_counts']}; useful-FLOP ratio "
              f"{traced['useful_flops_ratio']:.3f}; traces "
              f"{traced['trace_s']:.3f} / {bad['trace_s']:.3f} s; "
              f"{wall:.3f} s")
        res[shape_name] = {
            "layers": n, "layout": traced["layout"], "step_ms": real["ms"],
            "launches": real["launches"], "routes": real["routes"],
            "predicted_peak": traced["peak_device_bytes"],
            "real_peak": real["peak_bytes"], "peak_gap": gap,
            "fault": fault.__name__,
            "fault_peak": bad["peak_device_bytes"], "fault_gap": miss,
            "useful_flops_ratio": traced["useful_flops_ratio"],
            "collective_counts": traced["collective_counts"],
            "trace_s": traced["trace_s"], "wall_s": wall, "card": card}
    return res


def check_moe_rank0(card):
    """Phase 24.3, MoE: mixtral-8x22b's three cells at MOE_LAYERS of its
    56 layers (``_check_cut_rank0``: serving under the full depth's
    SERVE_BIG_RULES, the decode at MOE_POS); the fault for every cell the
    experts' weights gathered whole over "model" (``_whole_experts``)."""
    return _check_cut_rank0(MOE_ARCH, MOE_LAYERS, MOE_POS, dict.fromkeys(
        ("train", "prefill", "decode"), _whole_experts), card)


# deepseek-v2-236b's sharded cells, run as rank 0 of the (16, 16) mesh
# at MLA_LAYERS of its 60 layers (full width, bf16, the full depth's
# SERVE_BIG_RULES): 8 of the 128 MLA heads, 10 of the 160 routed experts
# and a 192-wide block of the shared experts' ffn a rank; the decode at
# MLA_POS, the last row of rank 0's 2,048-row latent cache block, so
# that rank 0 reads all of it
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 2
MLA_POS = 2047


@contextlib.contextmanager
def _whole_mla_scores():
    """A planted layout fault of the sharded MLA train and prefill,
    modelled in the trace: the naive path's scores made whole, [B, H, S,
    S] float32 at once, as the port's MLA made them before it was
    query-chunked (the reference's ``chunk_q``)."""
    from repro_torch.models import attention
    real = attention._mla_heads

    def heads(p, q_nope, q_rope, c_kv, k_rope, pos_q, pos_k, cfg, chunk_q):
        return real(p, q_nope, q_rope, c_kv, k_rope, pos_q, pos_k, cfg,
                    q_nope.shape[1])

    attention._mla_heads = heads
    try:
        yield
    finally:
        attention._mla_heads = real


@contextlib.contextmanager
def _mla_every_row():
    """A planted layout fault of the sharded MLA train body where the
    heads replicate over "model", modelled in the trace: the residual's
    whole sequence gathered, projected, and every head's queries run on
    all of its rows against every key, the rank keeping its block of
    the output (the body before its queries were cut to the rank's own
    rows); split heads as they are."""
    import torch

    from repro_torch.models import attention
    real = attention._tp_mla

    def every_row(p, x, positions, *, cfg, rope_theta, chunk_q, tp):
        if p["wq_b"].shape[1] != cfg.n_heads:
            return real(p, x, positions, cfg=cfg, rope_theta=rope_theta,
                        chunk_q=chunk_q, tp=tp)
        q_nope, q_rope, c_kv, k_rope = attention.mla_project(
            p, tp.seq_gather(x), positions, cfg, rope_theta)
        out = attention._mla_heads(p, q_nope, q_rope, c_kv, k_rope,
                                   positions, positions, cfg, chunk_q)
        return tp.own(torch.einsum("bshk,hkd->bsd", out, p["wo"]))

    attention._tp_mla = every_row
    try:
        yield
    finally:
        attention._tp_mla = real


def _latent_whole():
    """A planted layout fault of the sharded MLA decode, modelled in the
    trace: the latent cache's length split over no axis (``kv_len`` and
    ``k_rope``'s ``hdim`` replicated), so that each model rank holds the
    whole cache of its rows and attends its heads over all of it, the
    body otherwise as it is."""
    return _relaid(kv_len=[], hdim=[])


def check_mla_rank0(card):
    """Phase 24.3, MLA: deepseek-v2-236b's three cells at MLA_LAYERS of
    its 60 layers (``_check_cut_rank0``: serving under the full depth's
    SERVE_BIG_RULES, the decode at MLA_POS; MLA and the MoE FFN are plain
    PyTorch, so no kernel launches); the faults the MLA scores whole
    (train, prefill: ``_whole_mla_scores``) and the latent cache whole on
    every model rank (decode: ``_latent_whole``)."""
    return _check_cut_rank0(MLA_ARCH, MLA_LAYERS, MLA_POS, {
        "train": _whole_mla_scores, "prefill": _whole_mla_scores,
        "decode": _latent_whole}, card)


# minicpm3-4b's sharded cells, run as rank 0 of the (16, 16) mesh at
# MINICPM3_LAYERS of its 62 layers (full width, bf16, SERVE_RULES): all
# 40 MLA heads on every rank (40 do not divide 16), in train the queries
# of the rank's 256 of the 4,096 rows against every row's gathered
# latents, 400 of the ffn's 6,400 columns; in serving the heads' dims
# (96 and 64) over "model", gathered whole a layer, and 2,048 rows of the
# latent cache a rank; the decode at MINICPM3_POS, the last row of rank
# 0's block, so that rank 0 reads all of it.  Each peak within
# VLM_PEAK_TOL of its trace
MINICPM3_LAYERS = 2
MINICPM3_POS = 2047


def check_minicpm3_rank0(card):
    """Phase 24.3, MLA with replicated heads: minicpm3-4b's three cells
    at MINICPM3_LAYERS of its 62 layers (``_check_cut_rank0``: MLA and
    the dense FFN are plain PyTorch and cuBLAS, so no kernel launches;
    each peak within VLM_PEAK_TOL, the decode at MINICPM3_POS); the
    faults every head's queries run on all 4,096 rows (train:
    ``_mla_every_row``), the MLA scores whole (prefill:
    ``_whole_mla_scores``) and the latent cache whole on every model
    rank (decode: ``_latent_whole``).  Prints the three cells' wall."""
    t0 = time.perf_counter()
    res = _check_cut_rank0(MINICPM3, MINICPM3_LAYERS, MINICPM3_POS, {
        "train": _mla_every_row, "prefill": _whole_mla_scores,
        "decode": _latent_whole}, card, VLM_PEAK_TOL)
    print(f"phase 24.3 minicpm3-4b's three cells: "
          f"{time.perf_counter() - t0:.3f} s")
    return res


# the long_500k cells in the sharded layout (LONG_SERVE_RULES /
# LONG_SERVE_BIG_RULES: the cache's length over all 256 ranks, 2,048 rows
# a rank), run as rank 0 of the (16, 16) mesh, (arch, layers; None: its
# full depth): gemma3-1b at full depth, mixtral-8x22b at MOE_LAYERS of
# its 56 layers and recurrentgemma-9b at RG_LAYERS of its 38 (the full
# depth's rules); the token at LONG_POS, the last row of rank 0's block,
# so rank 0 writes it into its own block and reads all of its visible
# rows
DRY_LONG = (("gemma3-1b", None), (MOE_ARCH, MOE_LAYERS),
            (RG_ARCH, RG_LAYERS))
LONG_POS = 2047


def _kv_over_model():
    """A planted layout fault of the long cells, modelled in the trace:
    the cache's length split over "model" alone (as SERVE_RULES split
    it), so each rank holds 16 times its block (the "data" ranks
    repeating each other's), the body otherwise as it is."""
    return _relaid(kv_len=[("model",)])


def _cut_launches(cfg, shape, pos, rows, blocks):
    """The kernel launches of rank 0's step of a cell in the sharded
    layout, op -> route -> count, per mixer: an attention layer 2 sm90
    flash a train step (forward and remat recompute; the bf16 backward
    recomputes the plain version), 1 a prefill, 1 decode a decode step on
    the route the plan gives ``rows`` rows of every head over rank 0's
    visible rows (its block of the length cut in ``blocks``, under the
    layer's window, the token at ``pos``; a block wholly before the
    window: a one-row view); an RG-LRU layer the scan on rank 0's
    channels on the route its sequence picks (the gathered sequence, or
    one token), 3 a train step (forward, recompute, backward) and 1 a
    prefill or decode step; MLA none.  An encoder's layer and a decoder
    layer's cross-attention as an attention layer's train and prefill
    launches (all frames on every rank); a cross-attention 1 decode a
    decode step on the route the plan gives ``rows`` rows of every head
    over all of the encoder's frames (the head dim gathered whole)."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import rglru_scan as rmod
    from repro_torch.models import Mixer
    from repro_torch.models.blocks import WINDOW_INF
    from repro_torch.models.model import build_meta
    train, decode = shape.kind == "train", shape.kind == "decode"
    want = {}

    def add(op, way, n):
        want.setdefault(op, {})
        want[op][way] = want[op].get(way, 0) + n

    def decode_way(n):
        return "split" if dmod.plan(
            rows, cfg.n_heads, cfg.n_kv_heads, n, cfg.head_dim_,
            dmod.FAKE_SMS).splits > 1 else "single"

    if cfg.encoder is not None and not decode:
        add("flash_attention", "sm90",
            (2 if train else 1) * cfg.encoder.n_layers)
    meta = build_meta(cfg)
    for g in cfg.groups:
        for j, blk in enumerate(g.pattern):
            for w in meta[g.name][f"pos{j}"]["window"]:
                if blk.cross_attention and decode:
                    add("decode_attention",
                        decode_way(cfg.encoder.source_len), 1)
                elif blk.cross_attention:
                    add("flash_attention", "sm90", 2 if train else 1)
                if blk.mixer == Mixer.RGLRU:
                    add("rglru_scan", rmod.route(1 if decode
                                                 else shape.seq_len),
                        3 if train else 1)
                elif blk.mixer != Mixer.ATTN:
                    continue
                elif not decode:
                    add("flash_attention", "sm90", 2 if train else 1)
                else:
                    block = shape.seq_len // blocks
                    first = 0 if w >= WINDOW_INF else max(0, pos + 1 - w)
                    n = max(min(block, pos + 1) - first, 1)
                    add("decode_attention", decode_way(n), 1)
    return want


def check_long_rank0(card):
    """Phase 24.3, long context: DRY_LONG's long_500k cells on the
    (16, 16) mesh in the sharded layout (gemma3-1b at full width and
    depth under LONG_SERVE_RULES; mixtral-8x22b at full width and
    MOE_LAYERS layers under the full depth's LONG_SERVE_BIG_RULES,
    ``_rules_of``; recurrentgemma-9b at RG_LAYERS layers under
    LONG_SERVE_RULES, its RG-LRU state 256 of the 4,096 channels a rank,
    repeated over "data"), bf16, the token at LONG_POS, each traced as the dry
    run traces it and then run for real as rank 0 of a ``fake`` group of
    256 on the card (the weights and rank 0's 2,048-row cache block drawn
    at their local shapes; the collectives complete at once and return
    nothing, so the values are not checked).  The launches (one
    ``decode_attention`` an attention layer, each on the route the plan
    gives its visible rows, and one serial scan an RG-LRU layer:
    ``_cut_launches``) and routes traced = real, the traced peak within
    DRY_PEAK_TOL of ``max_memory_allocated``; the trace with the cache's
    length split over "model" alone (``_kv_over_model``: 16 times the
    block) must miss the peak gate."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import SHAPES
    shape = SHAPES["long_500k"]
    rows = shape.seq_len // 256
    res = {}
    for arch, layers in DRY_LONG:
        full = get_config(arch)
        cfg = full if layers is None else \
            cut_depth(arch, layers, torch.bfloat16)
        n = cfg.n_layers
        t0 = time.perf_counter()
        with _rules_of(full), dryrun.fake_group(256):
            mesh = make_production_mesh(
                device_type=dryrun.tensor_device("cuda"))
            traced = dryrun.trace_cell(cfg, shape, mesh, pos=LONG_POS,
                                       mesh_name="single")
            assert traced["layout"] == "sharded", traced["layout"]
            with _kv_over_model():
                bad = dryrun.trace_cell(cfg, shape, mesh, pos=LONG_POS,
                                        mesh_name="single")
            real = _rank0_step(cfg, shape, mesh, LONG_POS)
        want = _cut_launches(cfg, shape, LONG_POS, 1, 256)
        assert traced["kernel_launches"] == real["launches"] == {
            op: sum(r.values()) for op, r in want.items()}, (
            arch, traced["kernel_launches"], real["launches"])
        assert traced["kernel_routes"] == real["routes"], (
            arch, traced["kernel_routes"], real["routes"])
        assert real["routes"] == {op: want.get(op, {})
                                  for op in real["routes"]}, (
            arch, real["routes"], want)
        gap = _gap(traced["peak_device_bytes"], real["peak_bytes"])
        miss = _gap(bad["peak_device_bytes"], real["peak_bytes"])
        assert gap <= DRY_PEAK_TOL, (arch, traced["peak_device_bytes"],
                                     real["peak_bytes"])
        assert miss > DRY_PEAK_TOL, (
            f"the _kv_over_model trace passes the peak gate of {arch} x "
            f"long_500k", bad["peak_device_bytes"], real["peak_bytes"])
        wall = time.perf_counter() - t0
        print(f"sharded {arch} x long_500k rank 0 of single (16, 16), "
              f"{n} of {full.n_layers} layers bf16, {rows} cache rows a "
              f"rank, token at {LONG_POS}: step {real['ms']:.3f} ms "
              f"({card}); launches {real['launches']} routes "
              f"{real['routes']} traced and real; peak "
              f"{traced['peak_device_bytes']:,} B traced vs "
              f"{real['peak_bytes']:,} B max_memory_allocated (gap "
              f"{100 * gap:.3f} %, gate {100 * DRY_PEAK_TOL:.0f} %; {card});"
              f" the _kv_over_model trace {bad['peak_device_bytes']:,} B "
              f"(gap {100 * miss:.1f} %); useful-FLOP ratio "
              f"{traced['useful_flops_ratio']:.3f}; traces "
              f"{traced['trace_s']:.3f} / {bad['trace_s']:.3f} s; "
              f"{wall:.3f} s")
        res[arch] = {
            "layers": n, "layout": traced["layout"], "step_ms": real["ms"],
            "launches": real["launches"], "routes": real["routes"],
            "predicted_peak": traced["peak_device_bytes"],
            "real_peak": real["peak_bytes"], "peak_gap": gap,
            "fault": "_kv_over_model",
            "fault_peak": bad["peak_device_bytes"], "fault_gap": miss,
            "useful_flops_ratio": traced["useful_flops_ratio"],
            "collective_counts": traced["collective_counts"],
            "trace_s": traced["trace_s"], "wall_s": wall, "card": card}
    return res


# internvl2-26b's sharded cells, run as rank 0 of the (16, 16) mesh at
# VLM_LAYERS of its 48 layers (full width, bf16, the full depth's
# SERVE_RULES): 3 of the 48 query heads over one of the 8 K/V heads a
# rank; train's residual 272 of the 4,352 rows of [256 prefix rows; 4,096
# tokens] (re-blocked from and to the tokens' 256-row blocks), the
# prefill cache 2,064 of its 33,024 rows; the decode at VLM_POS, the last
# row of rank 0's 2,048-row cache block, so that rank 0 reads all of it.
# Each peak within VLM_PEAK_TOL of its trace
VLM_ARCH = "internvl2-26b"
VLM_LAYERS = 2
VLM_POS = 2047
VLM_PEAK_TOL = 0.005


@contextlib.contextmanager
def _whole_residual():
    """A planted layout fault of a VLM's sharded train body, modelled in
    the trace: the concatenated [prefix; tokens] sequence gathered whole
    on every rank instead of re-blocked (each rank's block a view of the
    whole, which its layers' checkpoints keep alive), and the loss over
    every token on every rank, as a body that left the residual whole
    would take it."""
    import torch

    from repro_torch.models import model
    real_in, real_out, real_xent = model._prefix_in, model._prefix_out, \
        model.softmax_xent

    def whole_in(pre, x, tp):
        full = torch.cat([tp.concat(pre, 1), tp.concat(x, 1)], 1)
        n = full.shape[1] // tp.size
        return full[:, tp.index * n:(tp.index + 1) * n]

    def whole_out(x, n_prefix, seq, tp):
        return tp.concat(x, 1)[:, n_prefix:]

    def whole_xent(logits, labels, mask=None):
        tp = model.sharding.model_shards()
        return real_xent(logits, tp.concat(labels, 1), mask)

    model._prefix_in, model._prefix_out = whole_in, whole_out
    model.softmax_xent = whole_xent
    try:
        yield
    finally:
        model._prefix_in, model._prefix_out, model.softmax_xent = \
            real_in, real_out, real_xent


def check_vlm_rank0(card):
    """Phase 24.3, VLM: internvl2-26b's three cells at VLM_LAYERS of its
    48 layers (``_check_cut_rank0``, each peak within VLM_PEAK_TOL, the
    decode at VLM_POS); the faults the residual gathered whole
    (``_whole_residual``), the whole length kept as cache rows
    (``_whole_length_writes``) and the decode's blocks written out of
    place (``_out_of_place_writes``)."""
    return _check_cut_rank0(VLM_ARCH, VLM_LAYERS, VLM_POS, {
        "train": _whole_residual, "prefill": _whole_length_writes,
        "decode": _out_of_place_writes}, card, VLM_PEAK_TOL)


# recurrentgemma-9b's sharded cells, run as rank 0 of the (16, 16) mesh
# at RG_LAYERS of its 38 layers (full width, bf16, the full depth's
# SERVE_RULES): 256 of the RG-LRU's 4,096 channels and 1 of the 16 query
# heads over the one K/V head a rank; the decode at RG_POS, the last row
# of rank 0's 2,048-row cache block, so that rank 0 reads all of it
RG_POS = 2047


@contextlib.contextmanager
def _whole_channels():
    """A planted layout fault of the sharded RG-LRU block, modelled in the
    trace: each RG-LRU layer's weights gathered whole over "model" too
    (the width split over no axis), so that every rank runs all 4,096
    channels -- the gates, the conv and the scan -- and keeps its own
    rows."""
    from repro_torch.distributed import sharding
    real = sharding.ModelShards.layer       # ServeShards' too

    def layer(self, tree, *path):
        out = real(self, tree, *path)
        if "rglru" not in out or self.size == 1:
            return out
        specs = sharding._at(self.specs, path)["rglru"]
        for name, t in out["rglru"].items():
            for dim, entry in enumerate(specs[name][1:]):
                if self.axis in sharding.entry_axes(entry):
                    t = sharding._AllGather.apply(t, dim,
                                                  self._group(self.axis))
            out["rglru"][name] = t
        return out

    sharding.ModelShards.layer = layer
    try:
        yield
    finally:
        sharding.ModelShards.layer = real


def _ffn_whole():
    """A planted layout fault of the sharded RG-LRU serving cells,
    modelled in the trace: "ffn" split over no mesh axis, so that every
    rank holds each RG-LRU weight and its state whole (the FFN's weights
    too) and runs all 4,096 channels, the body otherwise as it is."""
    return _relaid(ffn=[])


def check_rg_rank0(card):
    """Phase 24.3, RG-LRU: recurrentgemma-9b's three cells at RG_LAYERS
    of its 38 layers (``_check_cut_rank0``: the RG-LRU's channels, its
    state's too, over "model", each gate's partial sums reduce-scattered
    by channel, the scan on the rank's 256 channels over the whole
    sequence; the decode at RG_POS); the faults the RG-LRU weights
    gathered whole (train: ``_whole_channels``), its weights and state
    whole (prefill: ``_ffn_whole``) and the decode's cache and state
    written out of place (``_out_of_place_writes``).
    Prints the four cells' wall (the long_500k cell is
    ``check_long_rank0``'s)."""
    t0 = time.perf_counter()
    res = _check_cut_rank0(RG_ARCH, RG_LAYERS, RG_POS, {
        "train": _whole_channels, "prefill": _ffn_whole,
        "decode": _out_of_place_writes}, card)
    print(f"phase 24.3 recurrentgemma-9b's three cells: "
          f"{time.perf_counter() - t0:.3f} s")
    return res


# whisper-base's sharded cells, run as rank 0 of the (16, 16) mesh at full
# depth (6 encoder and 6 decoder layers, full width, bf16, SERVE_RULES):
# every head and all 1,500 frames of its rows on every rank (8 heads and
# 1,500 frames split over no "model" rank), 128 of the ffn's 2,048
# columns, the cross cache's head dim 4 of 64; the decode at
# WHISPER_POS, the last row of rank 0's 2,048-row self cache block, so
# that rank 0 reads all of it.  Each peak within VLM_PEAK_TOL of its trace
WHISPER_ARCH = "whisper-base"
WHISPER_LAYERS = 6
WHISPER_POS = 2047


@contextlib.contextmanager
def _encoder_every_row():
    """A planted layout fault of the sharded train body's encoder,
    modelled in the trace: the frames gathered over the batch's axes and
    the encoder run on every row of the global batch, each rank keeping
    its rows of the output (a view, which holds the whole output alive,
    and the encoder layers' saved inputs with it, through the decoder)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    real = model._encode

    def encode(params, cfg, source, flags, train=False, tp=None):
        shards = sharding.batch_shards()
        if tp is None or shards is None:
            return real(params, cfg, source, flags, train, tp)
        axes = [a for a in shards.axes if a != tp.axis]
        whole = source
        for a in reversed(axes):
            whole = sharding._AllGather.apply(whole, 0, tp._group(a))
        n = source.shape[0]
        i = sharding.BatchShards(tp.mesh, axes).index
        return real(params, cfg, whole, flags, train, tp)[i * n:(i + 1) * n]

    model._encode = encode
    try:
        yield
    finally:
        model._encode = real


def check_whisper_rank0(card):
    """Phase 24.3, encoder-decoder: whisper-base's three cells at full
    depth (``_check_cut_rank0``: the encoder on all 1,500 frames of the
    rank's rows, its ffn over "model"; the cross-attention of the rank's
    rows against all frames, its cache by head dim over "model", gathered
    whole at a decode step; each peak within VLM_PEAK_TOL, the decode at
    WHISPER_POS); the faults the encoder run on every row of the batch
    (train: ``_encoder_every_row``; the cross-attention run over every
    decoder row leaves the train peak where it is, the decoder
    self-attention's plain-recompute backward), the whole length kept
    as self cache rows (prefill: ``_whole_length_writes``) and the
    decode's blocks written out of place (``_out_of_place_writes``).
    Prints the three cells' wall."""
    t0 = time.perf_counter()
    res = _check_cut_rank0(WHISPER_ARCH, WHISPER_LAYERS, WHISPER_POS, {
        "train": _encoder_every_row, "prefill": _whole_length_writes,
        "decode": _out_of_place_writes}, card, VLM_PEAK_TOL)
    print(f"phase 24.3 whisper-base's three cells: "
          f"{time.perf_counter() - t0:.3f} s")
    return res


def time_decode_wrapper(stats):
    """The decode wrapper (``kernels/decode_attention.py``, with the fake
    branch's tests) against a raw launch of its kernel on the same
    rotated inputs at the kernel table's shape (Qwen B = 4, T = 4,096),
    CUDA events behind a spin kernel as phase 5; and the wrapper's host
    time a call (the launch's, queued behind a spin kernel)."""
    import torch

    from repro_torch.kernels import decode_attention as dmod
    b, h, hkv, t, d = DECODE_TIMED
    dt = torch.bfloat16
    sets = [(_randn((b, h, d), 400 + 2 * j, dt, torch),
             _randn((b, hkv, t, d), 401 + 2 * j, dt, torch),
             _randn((b, hkv, t, d), 402 + 2 * j, dt, torch))
            for j in range(_sets(2 * b * hkv * t * d * 2))]
    length = torch.full((b,), t, dtype=torch.int32, device=DEV)
    pl = dmod.plan(b, h, hkv, t, d, dmod._sms(torch.device(DEV)))
    outs = [torch.empty((b, h, d), dtype=dt, device=DEV) for _ in sets]
    raw = _time_rot([_raw_decode(q, k, v, length, o, pl)
                     for (q, k, v), o in zip(sets, outs)], torch)
    wrap = _time_rot([lambda q=q, k=k, v=v: dmod.decode_attention(
        q, k, v, length) for q, k, v in sets], torch)
    _busy_card(torch)
    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        dmod.decode_attention(*sets[i % len(sets)], length)
    host_us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    table = stats["decode_attention"]["ms"] if "decode_attention" in \
        stats else None
    del sets, outs
    _free_card()
    return {"wrapper_ms": wrap, "raw_ms": raw, "phase5_ms": table,
            "host_us_a_call": host_us, "splits": pl.splits}


def drive_dryrun(stats, training):
    """Phase 24: the dry run traces phase 22's three world-1 cells on a
    fake process group, on fake tensors through the kernels' fake
    branch, and each trace is held against a real step of the same cell
    on the card (NCCL at world size 1): the aten FLOPs equal, the
    predicted kernel launches and routes equal to the counters', the
    predicted peak within DRY_PEAK_TOL of ``max_memory_allocated``; a
    trace through the plain attention (the CPU's program) must miss the
    prefill cell's peak (its gap on the others printed).  Then DRY_CELL
    at world size 256, DRY_SHARDED traced and run as rank 0 of 256
    (``check_sharded_rank0``), the sharded cells of every other arch
    the same way, and the decode wrapper timed beside its raw kernel.
    ``training``: phases 18-21's results, whose phase 20 says what its
    old two-step batch probe took (printed with the walls)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    cells = _dry_cells()
    traced, plain = {}, {}
    for device, into in (("cuda", traced), ("cpu", plain)):
        with dryrun.fake_group(1):
            mesh = make_host_mesh(device_type=dryrun.tensor_device(device))
            for kind, cfg, shape, pos in cells:
                into[kind] = dryrun.trace_cell(cfg, shape, mesh,
                                               device=device, pos=pos)
    _process_group(ROOT / "build" / "dist_store")
    try:
        mesh = make_host_mesh(device_type=torch.device(DEV).type)
        real = {kind: _real_cell(mesh, kind, cfg, shape, pos)
                for kind, cfg, shape, pos in cells}
    finally:
        dist.destroy_process_group()
    want = {"train": {"flash_attention": 2 * DIST_LAYERS,
                      "flash_attention_bwd": DIST_LAYERS},
            "prefill": {"flash_attention": DIST_LAYERS},
            "decode": {"decode_attention": DIST_LAYERS}}
    res = {}
    for kind, cfg, shape, pos in cells:
        tr, pl, rl = traced[kind], plain[kind], real[kind]
        assert tr["aten_flops"] == rl["aten_flops"], (kind, tr["aten_flops"],
                                                      rl["aten_flops"])
        assert tr["kernel_launches"] == rl["launches"] == want[kind], (
            kind, tr["kernel_launches"], rl["launches"])
        assert tr["kernel_routes"] == rl["routes"], (
            kind, tr["kernel_routes"], rl["routes"])
        gap = _gap(tr["peak_device_bytes"], rl["peak_bytes"])
        miss = _gap(pl["peak_device_bytes"], rl["peak_bytes"])
        assert gap <= DRY_PEAK_TOL, (kind, tr["peak_device_bytes"],
                                     rl["peak_bytes"])
        if kind == "prefill":
            # its peak is the attention's; the train step's is set by
            # the [2, 4096, 152064] float32 logits and their gradient,
            # which the plain attention's scores do not pass
            assert miss > DRY_PEAK_TOL, (
                f"the plain-attention trace passes the peak gate of the "
                f"{kind} cell", pl["peak_device_bytes"], rl["peak_bytes"])
        res[kind] = {
            "aten_flops": rl["aten_flops"],
            "flops_per_device": tr["flops_per_device"],
            "launches": rl["launches"], "routes": rl["routes"],
            "predicted_peak": tr["peak_device_bytes"],
            "real_peak": rl["peak_bytes"], "peak_gap": gap,
            "plain_peak": pl["peak_device_bytes"], "plain_gap": miss,
            "collectives": tr["collective_counts"],
            "trace_s": tr["trace_s"], "real_ms": rl["ms"]}
        print(f"dry run {kind} cell {cfg.name} x {DIST_LAYERS} layers "
              f"({shape.global_batch} x {shape.seq_len}): aten FLOPs "
              f"{rl['aten_flops']:,} traced and real; launches "
              f"{rl['launches']} routes {rl['routes']} traced and real; "
              f"peak {tr['peak_device_bytes']:,} B traced vs "
              f"{rl['peak_bytes']:,} B max_memory_allocated (gap "
              f"{100 * gap:.3f} %, gate {100 * DRY_PEAK_TOL:.0f} %); the "
              f"plain-attention trace {pl['peak_device_bytes']:,} B (gap "
              f"{100 * miss:.1f} %); trace {tr['trace_s']:.3f} s, the "
              f"real step {rl['ms']:.3f} ms")
    arch, shape_name, mesh_name = DRY_CELL
    cell = dryrun.run_cell(arch, shape_name, mesh_name)
    assert cell["status"] == "ok", cell
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dmod
    # the sharded serving layout: rank 0's 8 rows x its 2,048-row block
    cfg = get_config(arch)
    way = "split" if dmod.plan(8, cfg.n_heads, cfg.n_kv_heads, 2048,
                               cfg.head_dim_, dmod.FAKE_SMS).splits > 1 \
        else "single"
    assert cell["layout"] == "sharded", cell["layout"]
    assert cell["kernel_launches"] == {"decode_attention": cfg.n_layers}, \
        cell["kernel_launches"]
    assert cell["kernel_routes"]["decode_attention"] == {
        way: cfg.n_layers}, cell["kernel_routes"]
    sharded = check_sharded_rank0(_card_line())
    serving = check_serving_rank0(_card_line(), cell)
    moe = check_moe_rank0(_card_line())
    mla = check_mla_rank0(_card_line())
    minicpm3 = check_minicpm3_rank0(_card_line())
    vlm = check_vlm_rank0(_card_line())
    rg = check_rg_rank0(_card_line())
    whisper = check_whisper_rank0(_card_line())
    long = check_long_rank0(_card_line())
    # the newer cells' walls beside the time won back for them:
    # granite-20b's fault traced at KEPT_LAYERS layers, not at its 52 (a
    # trace as long as its correct one), the late build, which phase 1
    # does not wait for, and phase 20's batch probed by its main run
    rg_wall = sum(c["wall_s"] for c in rg.values()) + \
        long[RG_ARCH]["wall_s"]
    whisper_wall = sum(c["wall_s"] for c in whisper.values())
    minicpm3_wall = sum(c["wall_s"] for c in minicpm3.values())
    probe = training["full_width"]["probe_won_s"]
    won = sharded["trace_s"] - sharded["kept_wall_s"]
    late = BUILD_WALLS.get("late_ended_s", 0.0) - \
        BUILD_WALLS.get("phase1_s", 0.0) - \
        BUILD_WALLS.get("late_waited_s", 0.0)
    print(f"phase 24.3 walls: minicpm3-4b's three cells "
          f"{minicpm3_wall:.3f} s; whisper-base's three cells "
          f"{whisper_wall:.3f} s; recurrentgemma-9b's four cells "
          f"{rg_wall:.3f} s; won back: granite-20b's fault at "
          f"{KEPT_LAYERS} layers {sharded['kept_wall_s']:.3f} s against "
          f"its 52-layer trace's {sharded['trace_s']:.3f} s "
          f"({won:.3f} s), the late build's compile behind phases 2-17 "
          f"({late:.3f} s: it ended "
          f"{BUILD_WALLS.get('late_ended_s', 0.0):.3f} s after the build "
          f"began, phase 1 took {BUILD_WALLS.get('phase1_s', 0.0):.3f} s)"
          f", phase 20's two-step batch probe, which its main run now "
          f"takes ({probe:.3f} s: two of that run's steps)")
    timing = time_decode_wrapper(stats)
    _possible(timing["wrapper_ms"], stats["decode_attention"]["bound_ms"]
              if "decode_attention" in stats else 0.0, "decode wrapper")
    print(f"decode wrapper at B,H,Hkv,T,D={DECODE_TIMED} bf16 "
          f"({timing['splits']} splits): {timing['wrapper_ms']:.6f} ms, "
          f"its raw kernel {timing['raw_ms']:.6f} ms on the same inputs "
          f"(phase 5: {timing['phase5_ms']}); {timing['host_us_a_call']:.1f}"
          f" us of host a call")
    wall = time.perf_counter() - t0
    print(f"phase 24: {wall:.3f} s")
    keys = ("peak_device_bytes", "argument_bytes", "temp_bytes",
            "flops_per_device", "aten_flops", "bytes_per_device",
            "collective_counts", "collective_detail", "compute_s",
            "memory_s", "collective_s", "memory_floor_s", "dominant_floor",
            "useful_flops_ratio", "kernel_launches", "kernel_routes",
            "fits", "trace_s")
    return {"cells": res, "production": {
        "cell": "_".join(DRY_CELL), **{k: cell[k] for k in keys}},
        "sharded_rank0": sharded, "serving_rank0": serving,
        "moe_rank0": moe, "mla_rank0": mla, "minicpm3_rank0": minicpm3,
        "vlm_rank0": vlm,
        "rg_rank0": rg, "whisper_rank0": whisper, "long_rank0": long,
        "rg_wall_s": rg_wall, "whisper_wall_s": whisper_wall,
        "minicpm3_wall_s": minicpm3_wall, "probe_won_s": probe,
        "kept_won_s": won, "late_build_won_s": late,
        "decode_wrapper": timing,
        "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 25: decode_attention's log-sum-exp output, and its merge over the
# length blocks of a cache (the sharded serving body's decode)
# ---------------------------------------------------------------------------

LSE_REL = 1e-4             # the log-sum-exps vs the plain version's
# (label, B, H, Hkv, T, D): granite-20b's, gemma3-1b's and
# mixtral-8x22b's rank-0 cache blocks at decode_32k on (16, 16) (the
# split route), gemma3-1b's and mixtral-8x22b's at long_500k (one row),
# and a launcher's 48-row decode (the single route)
LSE_CASES = (("granite rank block", 8, 48, 1, 2048, 128),
             ("gemma3 rank block", 8, 4, 1, 2048, 256),
             ("mixtral rank block", 8, 48, 8, 2048, 128),
             ("gemma3 long rank block", 1, 4, 1, 2048, 256),
             ("mixtral long rank block", 1, 48, 8, 2048, 128),
             ("launcher rows", 1, 28, 4, 48, 128))
# the merge: granite's rank block of 2,048 rows cut into 2 and 4 length
# blocks, the token at row 1,500 (at 4 the last block lies past it),
# with no window and with one of 700 (rows 801-1,500: it crosses two
# blocks, and at 4 the first lies wholly before it)
MERGE_POS = 1500
MERGE_WINDOWS = (None, 700)


def _lengths_for(b, t):
    """Ragged rows: the whole cache, one key, none, then mid-way."""
    pick = [t, 1, 0] + [t // 3 + 5 + 17 * i for i in range(b)]
    return pick[:b] if b > 2 else [t // 2 + 3] * b


def check_decode_lse(stats):
    """Phase 25: ``decode_attention(..., lse=True)`` on the card against
    ``ref.decode_attention_lse_ref`` at LSE_CASES, in bf16 and float32,
    with the softcap off and on, on the plan's route (asserted): outputs
    within ATTN_TOL, log-sum-exps within LSE_REL of the plain version's
    (-inf on a row of length 0), the output bit-equal to the call
    without the log-sum-exp.  Then the merge: granite's rank block cut
    into 2 and 4 length blocks, each block's visible rows run alone
    with the log-sum-exp (a block the token cannot see: length 0) and
    merged by ``ref.decode_merge``, held within ATTN_TOL of one call over
    the visible rows, queries x4 (a peaked softmax); the planted wrong
    merges of ``ref.decode_merge_faults`` must miss.  Then the kernel
    with and without the log-sum-exp timed at DECODE_TIMED (bf16, raw
    launches over rotated inputs, as phase 5)."""
    import torch

    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    row = stats.setdefault("decode_attention", {"max_abs_err": 0.0})
    worst = {"out": 0.0, "lse_rel": 0.0, "merge": 0.0}
    miss = {}
    for label, b, h, hkv, t, d in LSE_CASES:
        way = "split" if dmod.plan(b, h, hkv, t, d, dmod._sms(
            torch.device(DEV))).splits > 1 else "single"
        length = torch.tensor(_lengths_for(b, t), dtype=torch.int32,
                              device=DEV)
        for dt in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL[str(dt).split(".")[-1]]
            q = _randn((b, h, d), 500, dt, torch)
            k = _randn((b, hkv, t, d), 501, dt, torch)
            v = _randn((b, hkv, t, d), 502, dt, torch)
            for cap in (None, 5.0):
                kw = {} if cap is None else {"softcap": cap}
                out, lse = _routed("decode_attention", way,
                                   lambda: ops.decode_attention(
                                       q, k, v, length, lse=True, **kw))
                plain = ops.decode_attention(q, k, v, length, **kw)
                want, want_lse = ref.decode_attention_lse_ref(
                    q, k, v, length, softcap=cap)
                torch.cuda.synchronize()
                err = _attn_close(out, want, tol, f"lse decode {label} "
                                  f"{dt} cap {cap}")
                assert torch.equal(out, plain), \
                    f"{label} {dt}: the output moved with the lse output"
                empty = length == 0
                assert bool(torch.isneginf(lse[empty]).all()) and \
                    bool(torch.isfinite(lse[~empty]).all()), lse
                rel = float(((lse[~empty] - want_lse[~empty]).abs() /
                             want_lse[~empty].abs().clamp_min(1.0)).max())
                assert rel <= LSE_REL, (label, str(dt), cap, rel)
                worst["out"] = max(worst["out"], err)
                worst["lse_rel"] = max(worst["lse_rel"], rel)
                print(f"decode_attention lse {label} B,H,Hkv,T,D="
                      f"{(b, h, hkv, t, d)} {str(dt):14s} cap {cap} "
                      f"({way}): out max abs err {err:.3e} (tol {tol}), "
                      f"lse max rel err {rel:.3e} (gate {LSE_REL}); the "
                      f"output bit-equal to the call without it")
    _, b, h, hkv, t, d = LSE_CASES[0]
    for dt in (torch.bfloat16, torch.float32):
        tol = ATTN_TOL[str(dt).split(".")[-1]]
        q = _randn((b, h, d), 510, dt, torch) * 4
        k = _randn((b, hkv, t, d), 511, dt, torch)
        v = _randn((b, hkv, t, d), 512, dt, torch)
        for window in MERGE_WINDOWS:
            first = 0 if window is None else MERGE_POS + 1 - window
            whole = ops.decode_attention(
                q, k[:, :, first:MERGE_POS + 1], v[:, :, first:MERGE_POS + 1],
                MERGE_POS + 1 - first)
            for blocks in (2, 4):
                outs, lses, ks, ns = [], [], [], []
                for i in range(blocks):
                    lo, hi = i * t // blocks, (i + 1) * t // blocks
                    a = max(lo, first)
                    n = max(min(hi, MERGE_POS + 1) - a, 0)
                    start = min(a, hi - 1)
                    kb = k[:, :, start:start + max(n, 1)]
                    vb = v[:, :, start:start + max(n, 1)]
                    out, lse = ops.decode_attention(q, kb, vb, n, lse=True)
                    outs.append(out), lses.append(lse), ks.append(kb)
                    ns.append(n)
                assert blocks == 2 or 0 in ns, ns
                outs, lses = torch.stack(outs), torch.stack(lses)
                got = ref.decode_merge(outs, lses, dt)
                torch.cuda.synchronize()
                err = _attn_close(got, whole, tol, f"merge {blocks} blocks "
                                  f"{dt} window {window}")
                worst["merge"] = max(worst["merge"], err)
                for name, bad in ref.decode_merge_faults(
                        q, ks, outs, lses, ns).items():
                    ok, e = _close(bad, whole, tol)
                    assert not ok, (f"the merge check passes {name} ({dt}, "
                                    f"{blocks} blocks, window {window}): "
                                    f"max abs err {e:.3e}")
                    miss[name] = min(miss.get(name, math.inf), e)
                print(f"decode merge of {blocks} length blocks {ns} of "
                      f"{t} rows, token at {MERGE_POS}, window {window}, "
                      f"{str(dt):14s}: max abs err {err:.3e} against one "
                      f"call (tol {tol}); planted wrong merges miss")
    # the kernel with and without the log-sum-exp at the table's shape
    b, h, hkv, t, d = DECODE_TIMED
    dt = torch.bfloat16
    sets = [(_randn((b, h, d), 520 + 3 * j, dt, torch),
             _randn((b, hkv, t, d), 521 + 3 * j, dt, torch),
             _randn((b, hkv, t, d), 522 + 3 * j, dt, torch))
            for j in range(_sets(2 * b * hkv * t * d * 2))]
    length = torch.full((b,), t, dtype=torch.int32, device=DEV)
    pl = dmod.plan(b, h, hkv, t, d, dmod._sms(torch.device(DEV)))
    outs = [torch.empty((b, h, d), dtype=dt, device=DEV) for _ in sets]
    lses = [torch.empty((b, h), dtype=torch.float32, device=DEV)
            for _ in sets]
    plain_ms, lse_ms = [], []
    for into, with_lse in ((plain_ms, False), (lse_ms, True),
                           (lse_ms, True), (plain_ms, False)):
        into.append(_time_rot([_raw_decode(q, k_, v_, length, o, pl,
                                           lse=m if with_lse else None)
                               for (q, k_, v_), o, m in zip(sets, outs,
                                                            lses)], torch))
    del sets, outs, lses
    _free_card()
    ms = {"without": statistics.median(plain_ms),
          "with": statistics.median(lse_ms)}
    wall = time.perf_counter() - t0
    print(f"decode_attention at B,H,Hkv,T,D={DECODE_TIMED} bf16 "
          f"({pl.splits} splits): {ms['without']:.6f} ms without the "
          f"log-sum-exp, {ms['with']:.6f} ms with it (runs {plain_ms} / "
          f"{lse_ms}); phase 25: {wall:.3f} s")
    row["max_abs_err"] = max(row["max_abs_err"], worst["out"])
    row["lse"] = {"out_max_abs_err": worst["out"],
                  "lse_max_rel_err": worst["lse_rel"],
                  "merge_max_abs_err": worst["merge"],
                  "merge_fault_min_miss": miss, "ms": ms,
                  "splits": pl.splits, "wall_s": wall}
    return row["lse"]


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fail before printing without the port)
    card = _card_line()
    print(card)
    # float32 products on the card stay float32 (no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    hgmma = count_hgmma()
    if "--train" in sys.argv[1:]:           # phases 1 and 18-22 alone
        stats = {}
        training = drive_training(stats)
        distributed = drive_distributed(stats)
        dry = drive_dryrun(stats, training)
        print(card)
        print(json.dumps({"training": training, "distributed": distributed,
                          "dryrun": dry, "kernels": stats}))
        return 0
    if "--cap-offset" in sys.argv[1:]:      # phases 1 and 23 alone
        cap_offset = drive_cap_offset()
        print(f"chip_smoke: phases 1 and 23 in "
              f"{time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"cap_offset": cap_offset}))
        return 0
    stats = check_kernels()
    main_counts, unfused_counts = drive_days()
    stack = drive_stack()
    # the metering kernels' launches on each path of the stack
    stack_launches = {
        "anchor": stack["anchor"], "sweep": stack["sweep"]["launches"],
        "sweep_acceptance": stack["sweep_acceptance"]["launches"],
        **{f"planner_{k}": v["launches"]
           for k, v in stack["planner"].items() if isinstance(v, dict)}}
    if "--metering" in sys.argv[1:]:        # phases 1-4 alone
        print(json.dumps({k: {x: y for x, y in v.items()}
                          for k, v in stats.items()}))
        print(json.dumps({"stack": stack, "launches": stack_launches}))
        return 0
    attn = check_attention()
    check_f32_accuracy(attn)
    check_flash_sm90(attn)
    check_decode_split(attn)
    decode_rows = time_attention(attn)
    flash_rows = time_flash(attn)
    qwen2 = cut_depth(ARCH, 2, torch.float32)      # Qwen's widths, depth 2
    serve_depth(qwen2)
    check_bf16_model(qwen2)
    check_model_decode(qwen2)
    qwen_counts, qwen_combines = serve_launcher(ARCH)
    profile_serving(ARCH)
    torch.cuda.empty_cache()                   # the Qwen weights are gone
    stats.update(attn)
    stats.update(check_rglru())
    scan_rows = time_rglru(stats)
    check_windowed_decode(stats)
    serve_depth(recurrentgemma_depth3(), f64=False)
    check_bf16_model(recurrentgemma_depth3())
    rg_counts, rg_combines = serve_launcher(RG_ARCH)
    _free_card()
    t0 = time.perf_counter()
    check_new_shapes(stats)
    print(f"phase 12: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    check_new_depths()
    print(f"phase 13: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    new_counts, new_combines = serve_new_archs()
    print(f"phase 14: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    check_new_shapes(stats, WHISPER_FLASH_CASES, WHISPER_DECODE_CASES)
    print(f"phase 15: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    check_slice9_depths()
    print(f"phase 16: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    s9_counts, s9_combines = serve_slice9()
    print(f"phase 17: {time.perf_counter() - t0:.3f} s")
    training = drive_training(stats)
    distributed = drive_distributed(stats)
    cap_offset = drive_cap_offset()
    dry = drive_dryrun(stats, training)
    lse = check_decode_lse(stats)
    csrc = "src/repro_torch/kernels/csrc/"
    source = {"fused_meter": csrc + "segment_trapz.cu",
              "segment_trapz": csrc + "segment_trapz.cu",
              "ordered_segment_sum": csrc + "segment_trapz.cu",
              "flash_attention": csrc + "flash_attention_sm90.cu",
              "flash_attention_f32": csrc + "flash_attention_f32.cu",
              "flash_attention_bwd": csrc + "flash_attention_f32_bwd.cu",
              "decode_attention": csrc + "decode_attention.cu",
              "rglru_scan": csrc + "rglru_scan.cu"}
    replaces = {
        "fused_meter": "src/repro/kernels/segment_trapz.py:114",
        "segment_trapz": "src/repro/kernels/segment_trapz.py:161",
        # not a Pallas kernel: the jax.ops.segment_sum it replaces
        "ordered_segment_sum": "src/repro/fleet/mega/jaxback.py:236",
        "flash_attention": "src/repro/kernels/flash_attention.py:78",
        "flash_attention_f32": "src/repro/kernels/flash_attention.py:78",
        # the backward of that kernel's function (the Pallas kernel has
        # none; the reference differentiates plain jnp attention)
        "flash_attention_bwd": "src/repro/kernels/flash_attention.py:78",
        "decode_attention": "src/repro/kernels/decode_attention.py:57",
        "rglru_scan": "src/repro/kernels/rglru_scan.py:40",
    }
    # each path's own run: the fleet days for the metering kernels, every
    # serving run (summed) for the attention kernels
    served = {ARCH: qwen_counts, RG_ARCH: rg_counts, **new_counts,
              **s9_counts}
    launches = {"fused_meter": main_counts["fused_meter"],
                "segment_trapz": unfused_counts["segment_trapz"],
                "ordered_segment_sum": main_counts["ordered_segment_sum"],
                "flash_attention": sum(c["flash_attention"]
                                       for c in served.values()),
                "decode_attention": sum(c["decode_attention"]
                                        for c in served.values()),
                "rglru_scan": rg_counts["rglru_scan"],
                # the training path: phase 20's trainer run
                "flash_attention_f32": training["full_width"][
                    "flash_launches"],
                "flash_attention_bwd": training["full_width"][
                    "flash_bwd_launches"]}
    kernels = [{"name": k, "route": "cuda", "source": source[k],
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                "bound_by": v["bound_by"], "library_ms": v["library_ms"]}
               for k, v in stats.items()]
    for row in kernels:
        if "library" in stats[row["name"]]:
            row["library"] = stats[row["name"]]["library"]
        if row["name"] in ("fused_meter", "segment_trapz",
                           "ordered_segment_sum"):
            row.update({k: stats[row["name"]][k] for k in (
                "sets", "fp64_per_entry", "longest_run", "dadd_ns")
                if k in stats[row["name"]]})
            if row["name"] == "ordered_segment_sum":
                row["acceptance_longest_run"] = main_counts["longest_run"]
            if row["name"] != "segment_trapz":
                row["stack_launches"] = stack_launches
        if row["name"] in ("flash_attention_f32", "flash_attention_bwd"):
            # the float32 training route: times at TRAIN_SHAPE (phase
            # 20), both bounds, the route's previous kernels' times, the
            # launches a train step (phase 20; phase 19's cuts)
            op = "flash_attention" if row["name"] == "flash_attention_f32" \
                else "flash_attention_bwd"
            f = stats[row["name"]]
            row.update({k: f[k] for k in (
                "shape", "bound", "fp32_pipe_bound_ms", "train_library",
                "grad_err", "accuracy_vs_float64", "simt_ms", "simt_source",
                "plain_recompute_ms", "train_shape_errs", "library",
                "library_grad_err", "train_batch_errs")
                if k in f}, kernel_route="f32tc",
                train_launches_per_step={
                    f"qwen2-5-7b x {TRAIN_LAYERS} layers, "
                    f"{training['full_width']['batch']} rows":
                        training["full_width"]["launches_per_step"][op],
                    **{k: c.get(op, 0)
                       for k, c in training["model_grads"].items()}})
        if row["name"] == "flash_attention":
            # every launcher launch took the sm90 route (serve_launcher);
            # the simt kernel (other head dims) timed beside it in bf16
            row.update(kernel_route="sm90", hgmma=hgmma,
                       launches_by_run={a: c["flash_attention"]
                                        for a, c in served.items()},
                       simt_source=csrc + "flash_attention.cu",
                       simt_ms=flash_rows[0]["simt"],
                       rows={r["label"]: {k: r[k] for k in (
                           "sm90", "simt", "plain_ms", "library_ms",
                           "library", "bound_ms")} for r in flash_rows})
        if row["name"] == "decode_attention":
            # the split route's time; the single route (one block a
            # (b, kv head, head group)) and the back-to-back time of one
            # input set beside it; every launcher decode took single
            # (internvl2's 273-280-row decodes and whisper's cross
            # decodes over 1500 rows take split).
            # ``launches`` counts op calls; a split-route call launches
            # the combine kernel too, counted in ``combine_launches``
            row.update(kernel_route="split",
                       launches_by_run={a: c["decode_attention"]
                                        for a, c in served.items()},
                       combine_launches=qwen_combines + rg_combines +
                       new_combines + s9_combines,
                       splits=stats["decode_attention"]["splits"],
                       single_ms=stats["decode_attention"]["single_ms"],
                       l2_ms=stats["decode_attention"]["l2_ms"],
                       rows={r["label"]: {k: r.get(k) for k in (
                           "split", "single", "l2_ms", "splits",
                           "plain_ms", "library_ms", "library",
                           "bound_ms")} for r in decode_rows})
        if row["name"] == "rglru_scan":
            # the chunked route's time, the serial one's beside it; every
            # launcher scan took serial.  Training: the backward's time
            # (the kernel on the flipped inputs) and the launches a
            # train step of phase 19's RecurrentGemma cut (3 a layer)
            row.update({k: stats["rglru_scan"][k] for k in (
                "grad_err", "backward", "backward_ms")},
                train_launches_per_step={
                    k: c.get("rglru_scan", 0)
                    for k, c in training["model_grads"].items()})
            row.update(kernel_route="chunked",
                       serial_ms=stats["rglru_scan"]["serial_ms"],
                       rows={r["shape"]: {k: r[k] for k in (
                           "chunked", "serial", "plain_ms", "bound_ms")}
                           for r in scan_rows})
    # phase 22's launches: a train-cell step, a prefill / decode cell, the
    # pipeline's forward, a "dots" step at phase 19's cuts
    dots_cuts = distributed["dots"]["cuts"]
    dist_launches = {
        "flash_attention": {
            "prefill_cell": distributed["serve_cells"]["flash"]},
        "flash_attention_f32": {
            "train_cell_per_step": distributed["train_cell"][
                "flash_per_step"],
            "pipeline_forward": distributed["pipeline"][
                "forward_launches"]["flash_attention"],
            **{f"dots {k}": c["dots_launches"].get("flash_attention", 0)
               for k, c in dots_cuts.items()}},
        "flash_attention_bwd": {
            "train_cell_per_step": distributed["train_cell"][
                "flash_bwd_per_step"],
            **{f"dots {k}": c["dots_launches"].get("flash_attention_bwd",
                                                    0)
               for k, c in dots_cuts.items()}},
        "decode_attention": {
            "decode_cell": distributed["serve_cells"]["decode"]},
        "rglru_scan": {f"dots {k}": c["dots_launches"].get("rglru_scan", 0)
                       for k, c in dots_cuts.items()}}
    for row in kernels:
        if row["name"] in dist_launches:
            row["distributed_launches"] = dist_launches[row["name"]]
    # phase 23: the cap off and on, the capped checks' worst errors, and
    # the launches of a chunk and of a one-token step of Qwen's chunked
    # prefill (counters reset just before each call, read just after)
    chunk = {"flash_attention": cap_offset["qwen"]["launches_per_chunk"],
             "decode_attention": cap_offset["qwen"]["launches_per_step"]}
    for row in kernels:
        n = row["name"]
        if n in cap_offset["times"]:
            row["softcap_ms"] = cap_offset["times"][n]
        if n in cap_offset["kernels"]:
            row["softcap_max_abs_err"] = cap_offset["kernels"][n]
        if n in chunk:
            row["chunked_prefill_launches"] = chunk[n]
        if n == "flash_attention":
            row["simt_softcap_max_abs_err"] = cap_offset["kernels"][
                "flash_attention_simt"]
        if n in ("flash_attention_f32", "flash_attention_bwd"):
            row["softcap_accuracy_vs_float64"] = cap_offset["f32tc"][
                "accuracy_vs_float64"]
            row["softcap_train_launches_per_step"] = cap_offset["grads"][
                "launches"].get(n if n == "flash_attention_bwd"
                                else "flash_attention", 0)
    # phase 24: the launches of each cell's real step (the trace's equal)
    dry_ops = {"flash_attention": ("prefill", "flash_attention"),
               "flash_attention_f32": ("train", "flash_attention"),
               "flash_attention_bwd": ("train", "flash_attention_bwd"),
               "decode_attention": ("decode", "decode_attention")}
    for row in kernels:
        if row["name"] in dry_ops:
            kind, op = dry_ops[row["name"]]
            row["dryrun_launches"] = {
                f"{kind}_cell": dry["cells"][kind]["launches"][op]}
        if row["name"] == "flash_attention":
            # the sharded train and prefill cells' rank-0 steps (bf16:
            # sm90)
            row["dryrun_launches"]["sharded_train_rank0"] = \
                dry["sharded_rank0"]["launches"]["flash_attention"]
            row["dryrun_launches"]["sharded_prefill_rank0"] = \
                dry["serving_rank0"]["prefill_32k"]["launches"][
                    "flash_attention"]
            # mixtral-8x22b's, internvl2-26b's, recurrentgemma-9b's and
            # whisper-base's sharded cells at MOE_LAYERS / VLM_LAYERS /
            # RG_LAYERS / WHISPER_LAYERS layers; deepseek-v2-236b's and
            # minicpm3-4b's (MLA: none)
            for cell in ("train_4k", "prefill_32k"):
                for key in ("moe", "vlm", "rg", "whisper", "mla",
                            "minicpm3"):
                    row["dryrun_launches"][f"{key}_{cell}_rank0"] = \
                        dry[f"{key}_rank0"][cell]["launches"].get(
                            "flash_attention", 0)
        if row["name"] == "decode_attention":
            # the sharded decode cell's rank-0 step (with the log-sum-exp
            # output), and phase 25's checks and times of that output
            row["dryrun_launches"]["sharded_decode_rank0"] = \
                dry["serving_rank0"]["decode_32k"]["launches"][
                    "decode_attention"]
            row["dryrun_launches"]["moe_decode_32k_rank0"] = \
                dry["moe_rank0"]["decode_32k"]["launches"][
                    "decode_attention"]
            row["dryrun_launches"]["vlm_decode_32k_rank0"] = \
                dry["vlm_rank0"]["decode_32k"]["launches"][
                    "decode_attention"]
            row["dryrun_launches"]["rg_decode_32k_rank0"] = \
                dry["rg_rank0"]["decode_32k"]["launches"][
                    "decode_attention"]
            row["dryrun_launches"]["whisper_decode_32k_rank0"] = \
                dry["whisper_rank0"]["decode_32k"]["launches"][
                    "decode_attention"]
            for key in ("mla", "minicpm3"):
                row["dryrun_launches"][f"{key}_decode_32k_rank0"] = \
                    dry[f"{key}_rank0"]["decode_32k"]["launches"].get(
                        "decode_attention", 0)
            # the long_500k cells' rank-0 steps (gemma3-1b, Mixtral,
            # recurrentgemma-9b)
            for arch, cell in dry["long_rank0"].items():
                row["dryrun_launches"][f"{arch}_long_500k_rank0"] = \
                    cell["launches"]["decode_attention"]
            row["lse"] = lse
        if row["name"] == "rglru_scan":
            # recurrentgemma-9b's sharded cells' rank-0 steps, the scan
            # on a rank's 256 channels
            row["dryrun_launches"] = {
                f"rg_{cell}_rank0": c["launches"]["rglru_scan"]
                for cell, c in dry["rg_rank0"].items()}
            row["dryrun_launches"]["rg_long_500k_rank0"] = \
                dry["long_rank0"][RG_ARCH]["launches"]["rglru_scan"]
    print(json.dumps({"cap_offset": {k: cap_offset[k] for k in (
        "qwen", "gemma3", "grads", "whisper")}}))
    print(json.dumps({"dryrun": dry}))
    for row in kernels:
        _possible(row["ms"], row["bound_ms"], row["name"])
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"distributed": distributed}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _stop_builds():
    """End a build still running when the script stops early."""
    mod = sys.modules.get("repro_torch.kernels._build")
    if mod is not None:
        mod.stop_all()


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        _stop_builds()
