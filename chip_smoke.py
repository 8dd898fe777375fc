#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py
  python3 chip_smoke.py --phase 2c   # phases 1 and 2c only, no result line
  python3 chip_smoke.py --phase 8    # phases 1 and 8-10 only, no result line
  python3 chip_smoke.py --phase 11   # phases 1 and 11-13 only, no result line
  python3 chip_smoke.py --phase 14   # phases 1, 2 at H 16/8 and 14-16 only,
                                     # no result line
  python3 chip_smoke.py --phase 17   # phases 1, the new rows of 2 and 2b
                                     # and 17-19 only, no result line
  python3 chip_smoke.py --phase 20   # phases 1 and 20 only, no result line
  python3 chip_smoke.py --phase 21   # phases 1, the new rows of 2b and 2c
                                     # and 21-22 only, no result line
  python3 chip_smoke.py --phase 23   # phases 1 and 23 only, no result line
  python3 chip_smoke.py --phase 24   # phases 1 and 24 only, no result line

Each phase header prints the wall clock and the seconds the previous
phase took.

1. Device: the card's name and power limit; build the CUDA kernels from
   src/repro_torch/kernels/{decode_attention,flash_attention,rglru_scan}/
   csrc with nvcc (sm_90a), one nvcc per source, started together, and
   print each one's registers and spills.  B3's bf16 (wgmma) instances
   must not spill, and no instance may have its wgmma serialized (C7513)
   or its setmaxnreg ignored (C7508); a cached build prints that these
   checks did not run.
2. Kernels at the demo LM's widths (H 12, Hkv 4, dh 64): the dense (B1)
   and paged (B2) decode-attention kernels against their plain PyTorch
   versions, at the serve run's shapes (B 16, M 512, kv_len <= 232, a
   256-page pool) and at B 8 and 64 with M 1024, ragged kv_len (0,
   non-multiples of 32, full rows), bf16 and f32;
   B2 == B1 bitwise for page sizes 16 and 64, and B2 bitwise unchanged by
   a NaN-filled trash page.  Times with CUDA events, L2 flushed before
   every call, beside the HBM bound, the plain version and SDPA, with the
   ratios B1 / SDPA and B2 / B1.  B1/B2 limits: f32 2e-5; bf16 2e-2 of
   each (row, head)'s largest |plain output|, at most 2e-2, and never
   below 2 bf16 ulps of the element's |plain output|.  The same at
   granite-moe's decode widths (H 16, Hkv 8: a GQA group of 2) at the
   serve run's shape, in rows of their own, and so at the decode widths
   of phase 17 (the new rows): stablelm-12b's (H 32/8, dh 160: `_dh160`),
   command-r-35b's (H 64/8, dh 128: `_dh128`), qwen2.5-32b's (H 40/8, dh
   128, an odd query group of 5: `_h40`) and minicpm-2b's (H 36/36, dh
   64: `_mha`).
   2b. The flash-attention forward kernel (B3) against its plain version:
   the training shape (B 8, H 12, Hkv 4, S 1024, dh 64, bf16, causal and
   not), S 1000, MHA, MQA, dh 128, bf16 within B1's scaled limit and f32
   within 2e-5; two calls on the same inputs bitwise equal; at the
   training shape a planted fault (the plain version leaving out one key
   in 128) must fail the bf16 limit.  Gradients of q, k, v through the
   autograd path against autograd through the plain version.  Times at
   the training shape beside the FLOP bound, the plain version and SDPA.
   The new rows: the same checks (no planted fault, no gradients) and
   times at qwen2-vl-2b's training shape (B 8, H 12/2, S 1024, dh 128:
   `flash_attention_dh128`), musicgen-medium's (H 24/24, dh 64:
   `flash_attention_mha`) and stablelm-12b's (H 32/8, dh 160:
   `flash_attention_dh160`, where the planted fault must fail too).
   2c. The RG-LRU scan kernel (B4) against its plain version, f32
   bitwise: the serve prefill shape (16, 256, 2560), recurrentgemma-2b's
   training shape (8, 1024, 2560), an xLSTM prefix sum's (8, 256, 4), the
   long prefill's (2, 2048, 2560), B = 1 (1, 2048, 2560) and
   (3, 1001, 2600) on the TMA copy path; a ragged (3, 100, 70) and (2, 517, 2560) with its bases 4
   bytes off 16-byte alignment on the cp.async path; bf16 within 0.1
   (tests/test_kernels.py::_tol x 5) at (1, 512, 256), (2, 2048, 2560)
   and an odd D (2, 300, 77), which the wrapper widens to f32; a == 0
   gives x and a == 1 the cumsum of integer-valued x, bitwise; gradients
   through the autograd path against autograd through the plain version.
   Times at the serve and long prefill shapes and at B = 1 (f32) beside
   the bound, the plain version, the same call after an L2 flush that
   reads instead of writing, and an elementwise a * x that moves the same
   bytes.  B1 at
   recurrentgemma-2b's decode widths (H 10, Hkv 1, dh 256, a 2048-slot
   ring), f32 and bf16, kv_len ragged from 0 to 2048.  Times beside the
   bounds and the plain versions, and B1's beside SDPA (and its ratio to
   SDPA) at the serve run's rings (B 16, kv_len <= 232) and on full rings
   (B 4, kv_len 2048), where a planted fault (the plain version leaving
   out one position in 64) must fail the bf16 limit.
   2b and 2c, the new rows of slice 9: B3 at granite-moe-1b-a400m's
   training shape (B 8, H 16/8, S 1024, dh 64: `flash_attention_h16`),
   checked and timed as the other B3 rows; B4's backward kernel
   (`rglru_scan_bwd`) against the plain reverse walk, f32 bit patterns
   equal (da_0's -0.0 included) at the training shape (8, 1024, 2560),
   at the forward's ragged and misaligned shapes on both copy paths and
   at an xLSTM prefix sum's (8, 256, 4), bf16 within 0.1; a planted
   fault (the plain version with a_517 dropped) must fail; through the
   autograd wrapper one backward is one launch of this kernel and no
   other kernel (the profiler's device activity, which must record
   it); xLSTM's prefix sum as the mLSTM's chunked form calls it (a = 1
   on a strided 256-step chunk at (8, 256, 4)), forward and gradient
   bit patterns equal to autograd through the plain version; timed at the
   training shape beside its bound (a, h, g read, dx, da written), the
   plain version and torch.mul over flat tensors moving the same bytes.
3. Serve: suncatcher-lm-100m at full width in bf16, random weights from a
   seed, through ServingEngine: 32 requests on 16 slots, max_len 512,
   decode_block 8, prompts of 4-200 tokens with shared heads; dense and
   paged (page 16, pool half the dense footprint, prefix cache 8), greedy
   and at temperature 0.7.  Every request completes, paged == dense token
   streams, each kernel launched n_layers x sub-steps times, no host sync
   inside a decode block (the engine runs it under sync debug mode
   "error").
   One more dense run of 16 requests x 16 tokens under torch.profiler:
   device busy share, top kernels by device time.
4. Reference: a small config (reduced widths, head_dim 64) in f32 on the
   card against the same model on the CPU, logits within 1e-3.
5. Train: suncatcher-lm-100m at full width, bf16 compute, f32 masters,
   seq 1024, batch 8, random weights from a seed, the port's SyntheticLM
   (seed 0), under torch.use_deterministic_algorithms(True):
   FaultTolerantTrainer.run_fused for 16 steps (drain_every 8, replicated
   async checkpoints into a temporary directory), then run for 16 steps
   from the same state.  Every loss finite and falling from step 0 to 15;
   run == run_fused losses and final state bitwise; 2 drains; no host sync
   inside a fused block (sync debug mode "error"); B3 launched 2 x 12 x 16
   times per run (forward and remat recompute); the newest checkpoint
   restores onto the card bitwise.  One fused block under torch.profiler,
   with B3's share of its device time.
   A reduced f32 config (head_dim 64): one train step on the card against
   the CPU.
6. Serve recurrentgemma-2b at full width (26 layers, d 2560, MQA 10/1,
   head_dim 256, vocab 256000, window 2048) in bf16, random weights drawn
   on the card from seed 0, through ServingEngine: the workload of phase
   3, greedy and T 0.7.  Every request completes; B4 launched 18 times
   per prefill call (2 x 8 groups + 2 tail blocks) and B1 8 times per
   sub-step; decode_block 1 == 8 token streams; a finished and a
   never-used row keep their whole state bitwise across a decode block.
   A run of 16 requests x 16 tokens under torch.profiler.  Then a long
   run that wraps the ring: 4 requests of 2000-2040 prompt tokens on 4
   slots, max_len 4096, 64 new tokens (B4 at the 2048 bucket, positions
   past W = 2048, B1 on full rings), and its prefill once more with 16 new
   tokens under torch.profiler: device time per sub-step, B1's share of
   it, and B4's device time over its prefill's 18 launches.
7. Reference: recurrentgemma's reduced config at d_model 256 (head_dim
   64, window 16), f32, on the card against the CPU: prefill, then 24
   decode steps past the window, logits within 1e-3.
8. DiLoCo: suncatcher-lm-100m at full width (bf16 compute, f32 masters),
   2 pods x H 8, SyntheticLM seq 1024 and batch 8 per pod step, int8
   error-feedback compression, pod masks from ConstellationLinkModel,
   under DiLoCoSupervisor for 4 rounds with a whole-round rollback forced
   at round 3 and a snapshot every 2 rounds (keep 1, two replicas).
   Losses finite and falling; the replay verified bitwise; one host
   drain per round run; B3 launched 24 times per inner step run; the
   masks used equal `mask_at` computed on the CPU; sent + residual ==
   delta + ef bitwise at every leaf (int8, top-k); a round with pod 1
   NaN-poisoned gives pod_bad [F, T] and outer_ok, bitwise equal to the
   plain round with pod 1 masked by hand and to make_inner_steps +
   outer_step.  Prints one snapshot's time (device to host, replicated
   write), one round's wall time and tok/s, one round under
   torch.profiler, the outer sync's device time with none, int8 and
   top-k, and peak memory.  Phases 8-10 run under
   torch.use_deterministic_algorithms(True).
9. Co-residency: `run_coserve` at full width, 2 pods x H 4, 3 rounds, a
   rollback forced at round 1, publish every round with a holdback of 1;
   an engine of 8 slots (max_len 512, decode_block 8) serves 16 greedy
   requests of 4-200 prompt tokens from the published params.  Every
   request completes, published round <= verified round, >= 1 swap and
   >= 1 candidate dropped by the rollback, B1 and B3 launched, and each
   request's tokens equal a fresh engine's serving, alone, the param
   version it was admitted under.
10. Reference: the micro DiLoCo config (2 layers, d 32, head_dim 64,
   vocab 256; 2 pods x H 4, int8), f32, 2 rounds on the card against the
   CPU: losses and global params within 1e-3.
11. Serving plane: suncatcher-lm-100m at full width in bf16 (random
   weights from seed 0, the tied embedding scaled by 0.1 so that every
   token depends on the context), 3 pods of 16 slots behind a
   ConstellationRouter, max_len 512, decode_block 8; 48 requests of phase
   3's prompt mix, 32 new tokens each, greedy and T 0.7 alternating,
   arriving 4 per router tick; the chaos schedule "2:1:3,10:1:3" plus pods
   0 and 2 struck together at tick 6 for 2 ticks.  Run dense, paged (page
   16, half-size pool, prefix cache 8) and as the full-drain plane (no
   replication).  Each: zero drops and the outage contract (a pointer
   flip where replicating, a rebalance), every request's tokens bitwise
   equal to one engine serving all 48 alone (so paged == dense), B1 or B2
   launched n_layers x sub-steps times, row_wire_bytes equal to the bytes
   of one row the engine holds and the replicated bytes equal to its
   prediction.  Prints tok/s, the failover stalls (p50, max), standby
   syncs, bytes replicated, peak memory and the launches.  One more
   dense plane of the first 12 requests under torch.profiler: device
   busy share, top kernels, and the device time of B1, the GEMMs and the
   index and gather kernels.
12. Mixed serving plane: recurrentgemma-2b (bf16 params made anew from
   seed 0, each pod its own copy) and suncatcher-lm-100m, 2 pods each of
   8 slots, max_len 512; 16 requests round-robin over the arch groups, 32
   new tokens; the busiest pod struck at tick 2 for 3 ticks.  Zero drops, no
   session moves between arch groups, a pointer flip in the carry group,
   each request bitwise equal to its arch's engine serving it alone; B4
   launched 18 times per recurrentgemma prefill call, B1 12 (dh 64) and
   8 (dh 256) times per sub-step of its group, each arch's B1 launches
   counted around its engines' steps.
13. Reference: a micro mixed plane (the reduced demo LM at head_dim 64,
   paged, and recurrentgemma reduced at d_model 256), f32, 2 + 2 pods, an
   outage schedule, on the card and on the CPU: tokens and every
   plane_stats() counter equal.
14. Serve granite-moe-1b-a400m at its published widths, 6 of its 24
   layers (all 24 until slice 9, 12 until slice 11; d 1024, 16/8 heads, dh 64, 32 experts
   top-8, d_ff 512, vocab 49408; 1.335B params at full depth)
   in bf16, random weights from seed 0 with the embedding scaled by 0.1,
   through ServingEngine: phase 3's workload (greedy and T 0.7
   alternating), dense and paged, decode_block 8 and 1.  Every request
   completes; decode_block 1 == 8 token streams, dense and paged; B1 or
   B2 launched n_layers x sub-steps times; no host sync inside a decode
   block (the MoE dispatch included); a finished and a never-used row
   keep pos, token and KV [0, pos) bitwise across a decode block.
   Paged == dense is not checked: the reference keeps neither it nor a
   plane == one engine alone for MoE (ROADMAP C7).  One short run under
   torch.profiler (sort, gather and index kernels' shares), and the
   kernel device time of one decode call beside one layer's MoE FFN, its
   dispatch and its expert products (sums under torch.profiler).
15. Serve xlstm-350m at its published widths cut to 1 of its 12
   sLSTM/mLSTM pairs (d 1024, 4 heads, vocab 50304; all 12 until slice 9,
   2 until slice 11)
   in bf16 with f32 carries, random weights from seed
   0 with the embedding scaled by 0.1: phase 3's workload at
   decode_block 8 and 1, bitwise equal; a short run under
   torch.profiler; a finished and a never-used row keep their whole
   state bitwise; row_wire_bytes equal to one row the engine holds.  Then
   a 3-pod plane of 8 slots, 16 requests (prompts cut to 60 tokens), pod
   1 struck at tick 2 for 3 ticks, replicated and full drain: zero drops,
   a pointer flip on the replicated plane, every request bitwise equal to
   one engine serving it alone, the replicated bytes equal to the rows
   shipped x row_wire_bytes.
16. Reference: the reduced granite-moe and qwen3-moe (head_dim 64) and
   xlstm configs, f32, on the card against the CPU: prefill and 8 decode
   steps, logits within 1e-3, and an engine's token streams equal.
17. Serve the four token LMs of the remaining transformer branches at
   their published widths, cut in depth only, in bf16 (random weights
   drawn on the card from seed 0, the embedding scaled by 0.1, divided
   by the config's embed_scale: minicpm-2b's 12):
   minicpm-2b at 20 of 40 layers (MHA 36/36, mu-P scales), stablelm-12b
   at 8 of 40 (LayerNorm, H 32/8, dh 160), command-r-35b at 4 of 40 (the
   parallel block, vocab 256000 tied, logit_scale 0.0625) and qwen2.5-32b
   at 6 of 64 (QKV bias, H 40/8); phase 3's workload (greedy and T 0.7
   alternating), dense and paged, stablelm also at decode_block 1.  Every
   request completes; paged == dense token streams; decode_block 1 == 8;
   B1 or B2 launched n_layers x sub-steps times (the engine runs each
   decode block under sync debug mode "error").  tok/s, host syncs per
   token and peak memory per run; minicpm's 16 requests x 16 tokens under
   torch.profiler.
18. Train musicgen-medium (3 of 48 layers, 6 until slice 11: 4 codebooks,
   sinusoidal positions, GELU MLP, MHA 24/24), qwen2-vl-2b (2 of 28, 4
   until slice 11: M-RoPE over
   "vlm" batches' (3, B, S) positions, H 12/2, dh 128) and stablelm-12b
   (2 of 40: LayerNorm, H 32/8, dh 160, vocab 100352 untied) at their
   published widths, bf16 compute, f32 masters drawn on the card, seq
   1024, batch 8, the port's SyntheticLM of their kind, under
   torch.use_deterministic_algorithms(True): run_fused for 8 steps (one
   drain), then run for 8 from the same state (drawn anew from the
   seed).  Every loss finite; run == run_fused losses and final state
   bitwise; B3 launched 2 x n_layers x 8 times per run; no host sync
   inside the fused block.
19. Reference: the six configs' reduced widths at head_dim 64 (qwen2-vl's
   M-RoPE sections 16/8/8) and at their own reduced head dims (12, 16,
   20, which the kernels run zero-padded to 64), f32, on the card against
   the CPU: the loss of one "tokens", "codebooks" or "vlm" batch (B3), a
   prefill and 8 decode steps (B1; musicgen's (B, 4, V) logits) within
   1e-3 with equal greedy tokens, and the token LMs' engines (dense and
   paged) giving the CPU's token streams.  Then the train and serve
   launchers at their defaults (the reduced demo LM, dh 16, on the card,
   side by side) must exit 0 and print B3 and B1 launches above 0.
20. Slice 8.  (a) The SDC injector: identical f32 and bf16 trees flipped
   on the card and the CPU with the same keys are bitwise equal (1, 64
   and 5,000 flips, and 200 colliding flips on 3 elements), with equal
   changed-element counts; the demo LM at full width (seq 1024, batch
   8) under FaultTolerantTrainer.run with an SDCInjector and a forced
   burst of 2,000 flips at step 3: detected, rolled back, replayed, every
   kept loss finite; the train launcher (6 steps, both runs side by
   side) with --sdc-rate-multiplier 2e3 exits 0 having injected,
   detected and rolled back, and with 1e5 raises "persistent
   non-finite".  (b) The J2
   orbit in float64 on the card, through the paper's entries
   (`repro_torch.paper`): fig2_constellation's simulate_cluster (81
   satellites, one orbit at dt 5 s) within 1e-6 m and 1e-9 m/s of the
   same entry on the CPU, its printed line equal, direct neighbours
   100-200 m; the energy-matched Keplerian cluster closes to < 5 mm
   after an orbit at dt 2 s; j2_drift's rates at kappa 1.0 and 0.999
   over 6 orbits (both in one integration), the tuned rate under half
   the base;
   ConstellationLinkModel(integrate=True) at 8 pods, masks equal to the
   CPU port's.  (c) train_controller at the reference test's problem
   (3 x 3 lattice, 20 intervals x 4 substeps, 25 iterations, float64) on
   the card and the CPU from the same draws: loss histories within 1e-8
   relative, the loss under 0.6x its start, rms error under 0.8x free
   fall's.  The CPU sides of (b) and (c) run in one worker process while
   the card works.  Each prints its seconds.
21. Train granite-moe-1b-a400m (12 of 24 layers since slice 11, all 24
   before: 32 experts top-8, H 16/8), xlstm-350m (1 of 12 sLSTM/mLSTM pairs) and recurrentgemma-2b
   (5 of 26 layers: one remat'd (rec, rec, attn) group and the two tail
   recurrent blocks, the loss in chunks of 256 positions) at their
   published widths in phase 18's setting: bf16 compute, f32 masters
   drawn on the card, seq 1024, batch 8, SyntheticLM, run_fused for 8
   steps then run for 8 from the same state, under
   torch.use_deterministic_algorithms(True).  Every loss finite; run ==
   run_fused losses and final state bitwise; no host sync inside the
   fused block; B3, B4 and B4's backward launched exactly the counts the
   layer counts and remat give (`family_launches`).  tok/s and peak
   memory per run.  Then the train launcher on the card, side by side:
   the reference launcher's DiLoCo example for granite-moe (reduced,
   `--diloco-pods 2 --inner-steps 8 --compress int8`) and 8 steps of
   xlstm-350m and recurrentgemma-2b (reduced) exit 0 having launched B3
   or B4 forward and backward.
22. Reference: the three families' reduced configs (granite-moe at
   head_dim 64, xLSTM's chunked form), f32, card against CPU: one
   batch's loss within 1e-3, every gradient leaf within GRAD_TOL of its
   losses within 1e-3; the micro recurrent DiLoCo round (recurrentgemma
   and xlstm reduced, 2 pods x H 2) within 1e-3 of the CPU and on the
   card bitwise equal to make_inner_steps + outer_step.
23. The paper's system model (slice 10).  In this process, the paper
   entry diloco_traffic on the card (its micro DiLoCo run: the reduced
   demo LM at 2 layers, d 32, head_dim 16, which B3 runs zero-padded to
   64; 12 rounds of 2 pods x 4 steps under the supervisor with
   constellation masks): mask counts and orbit profile equal to the CPU
   port's (a worker process), bf16 losses within 2^-8 relative, and the
   same run in f32 within 1e-3 of the CPU's f32 run (phase 22's limit);
   B3 launches asserted.  Side by side, each a process on the card:
   `python -m repro_torch.paper` (its host entries; Fig. 2 and the J2
   drift ran in 20b), its printed lines equal to the same entries run
   here; and the five examples (examples/torch_port: quickstart and
   serve_batch at their defaults, `train_100m.py --full --steps 16
   --inner 8`, constellation_design, `formation_flight.py --iters 6
   --intervals 8`), each exiting 0 with its sentinel line, the B3 and B1
   launches the training and serving ones print counted into the
   kernels line.  Then the analytic roofline (`repro_torch.analysis`) of
   phase 5's train step priced at H100_SXM beside phase 5's measured
   fused-block step time, and useful_flops / (step time x peak).
24. The port on a device mesh (slice 11).  (a) A one-rank NCCL mesh
   (1, 1, 1) on the card, the demo LM at full width (seq 1024, batch 8,
   bf16) under deterministic algorithms: two steps of
   make_sharded_train_step equal make_train_step bitwise (losses and
   every state leaf, gathered), B3 launched 24 times a step through the
   DTensor path (local_map); one make_diloco_round(mesh=, compress="int8")
   round (2 pods x H 2, supervised, screens) equals the unmeshed round
   bitwise; the wire hop alone (`_wire_shard_hop`) under the collective
   counter issues two NCCL all-gathers per wire leaf, s8 and f32 only.
   (b) `repro_torch.launch.dryrun --outer-sync` for none, int8 and top-k
   with --device cuda: rank 0 of the (2, 16, 16) mesh on a fake group of
   512 ranks, its shards on the card; per-rank bytes by op and dtype
   equal the reference's checked-in dry run, and the per-pod payload
   passes --check against the per-pod prediction (like for like).  (c)
   stablelm-12b train_4k at TRAIN_MICROBATCHES 2 on a fake (16, 16)
   group: the fake-mode estimate (MemTracker, FLOPs, collectives), then
   rank 0's program for real on the card (B3's dh-160 instance on 2 of
   32 query heads, the KV heads replicated): max_memory_allocated beside
   the estimate and their ratio, FLOPs per rank beside the analytic
   roofline priced at H100_SXM, and B3 launches (2 x 40 layers x 2
   microbatches).  Its B3 launches count into the kernels line.

Exits non-zero on any failed check or without a CUDA device.  The last
line is {"ok": true, "device": {...}}; the line before it is the card's
name and power limit, and before that one JSON line listing the kernels
(B1 at dh 64, B2, B3, B4 at the serve and the long prefill shapes,
B1 at dh 256 in two rows: the serve run's rings and full rings, and B1
and B2 at H 16 / Hkv 8) with their launches on their main paths (B1's
dh-64 row phases 3, 9, 11, 12 and 23; B2's phases 3 and 11; B3's phases
5, 8, 9, 20a and 23; B4's serve row and B1's dh-256 serve-rings row phase 6's
16-slot runs and phase 12; the long rows phase 6's long runs; the H 16
rows phase 14; the `_mha`, `_dh160`, `_dh128` and `_h40` rows phase 17's
minicpm-2b, stablelm-12b, command-r-35b and qwen2.5-32b runs; the new B3
rows phase 18; `flash_attention_h16` and `rglru_scan_bwd` phase 21, whose
B4 forwards add to the `rglru_scan` row; phase 24a's B3 launches add
to `flash_attention`, 24c's to `flash_attention_dh160`), errors, times
and bounds; B4's rows also name their copy path.
"""
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, set before the
# first CUDA call; the train phase compares two runs bitwise
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.core.system import H100_SXM  # noqa: E402

# the card's data-sheet rates (repro_torch.core.system.H100_SXM, which the
# analytic roofline is priced at too)
HBM_BYTES_PER_S = H100_SXM.hbm_bytes_per_s
PEAK_OPS = {"bfloat16": H100_SXM.peak_bf16_flops,
            "float32": 67e12}      # f32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
H, HKV, DH = 12, 4, 64


_PHASE_T0 = []


def phase(title=None):
    """A phase's header, with the wall clock and the seconds the previous
    phase took; with no title, only those seconds."""
    now = time.perf_counter()
    took = now - _PHASE_T0[-1] if _PHASE_T0 else None
    _PHASE_T0.append(now)
    if title is None:
        print(f"  last phase took {took:.1f} s", flush=True)
        return
    print(f"{title} [{time.strftime('%H:%M:%S')}"
          + (f", previous phase {took:.1f} s" if took is not None else "")
          + "]", flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def plain_close(out, ref, dtype):
    """An attention kernel (B1, B2, B3) against its plain version: (max abs
    err, worst share of the limit).  f32: 2e-5.  bf16: 2e-2 of each (row,
    head)'s largest |ref|, at most 2e-2, and never below 2 bf16 ulps of
    the element's |ref|; the kernel (P rounded to bf16 for P.V) and the
    plain version round differently.  Where a row stays at or below 1
    (B1, B2, B3's long rows) the scaled part is at least 2.5 ulps and the
    floor never binds; B3's short causal rows are near single v values
    of 2 to 8, where 2e-2 alone is 1.28 to 0.64 ulps.  A flat 2e-2 would
    pass a kernel that drops a position per split of a 2048-position row,
    whose outputs are ~0.03."""
    d = (out.float() - ref.float()).abs()
    lim = TOL[dtype]
    if dtype == "bfloat16":
        r = ref.float().abs()
        ulp = (2.0 ** (r.frexp().exponent - 8).float()).where(r > 0, 0.0)
        lim = (lim * r.amax(-1, keepdim=True).clamp(max=1.0)).maximum(
            2 * ulp)
    share = (d / lim).where(d > 0, 0.0).max().item()
    return d.max().item(), share


class Timer:
    """Per-call device time from CUDA events, with L2 flushed before each
    call by writing 64 MB, which leaves it full of dirty lines whose
    write-backs land inside the timed call (`clean`: by reading 64 MB
    that is never written, which leaves it clean).  The card first spins
    long enough for the host to queue every call, so the events time the
    device, not the host's launch path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        self.cold = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters=50, clean=False):
        torch = self.torch
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)      # ~50 ms of device spin
        for s, e in ev:
            if clean:
                self.cold.amax()
            else:
                self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters


def bound(lens, ps, dtype, itemsize, b, h=H, hkv=HKV, dh=DH):
    """Least time for the same work: each input byte read once, each output
    byte written once, or the operations at the card's peak, the larger."""
    kv = sum(lens)
    nbytes = 2 * kv * hkv * dh * itemsize + 2 * b * h * dh * itemsize + 4 * b
    if ps:
        nbytes += 4 * sum(-(-n // ps) for n in lens)
    ops = 4 * kv * h * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, timer, h=H, hkv=HKV, cases=None, suffix="", dh=DH):
    """B1 and B2 at H `h`, Hkv `hkv`, head_dim `dh` over `cases` of (B,
    M, kv_len ceiling, pool pages at page 16), the first being the serve
    run's shape; returns their rows, timed there, named with `suffix`."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference, paged_decode_attention,
        paged_decode_attention_reference)
    dev = torch.device("cuda")
    main = {}
    # (B, M, kv_len ceiling, pool pages at page 16): the serve run's shape
    # (its kv_len <= 200 + 32 and pool of 256 pages), then two wider
    # cases with full-length rows
    for b, m, cap, pool16 in cases or ((16, 512, 232, 256),
                                       (8, 1024, 1024, None),
                                       (64, 1024, 1024, None)):
        main_case = (b, m) == (16, 512)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            g = torch.Generator().manual_seed(b * 7 + m)
            q = torch.randn(b, h, dh, generator=g).to(dev, dt)
            kc = torch.randn(b, m, hkv, dh, generator=g).to(dev, dt)
            vc = torch.randn(b, m, hkv, dh, generator=g).to(dev, dt)
            lens_l = torch.randint(1, cap + 1, (b,), generator=g).tolist()
            lens_l[:4] = [0, 33, cap, cap - 1]
            lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
            out = decode_attention(q, kc, vc, lens)
            ref = decode_attention_reference(q, kc, vc, lens)
            torch.cuda.synchronize()
            err, share = plain_close(out, ref, dtype)
            check(bool(torch.isfinite(out).all()), f"B1 non-finite {b}x{m}")
            check(share <= 1, f"B1 {dtype} B={b} M={m}: max abs err {err}, "
                  f"{share:.3f} of its limit")
            check(bool((out[0] == 0).all()), "B1 kv_len == 0 row not zero")
            line = (f"  H {h}/{hkv} dh {dh} B={b:3d} M={m} {dtype:8s} B1 "
                    f"err {err:.3e} ({share:.3f} of the limit)")
            perr = {}
            for ps in (16, 64):
                # each row's live pages on distinct, shuffled physical
                # pages; every other table entry is the trash page
                mp = m // ps
                rows_, cols_ = zip(*[(r, j) for r, n in enumerate(lens_l)
                                     for j in range(-(-n // ps))])
                n_pool = pool16 if ps == 16 and pool16 else b * mp
                check(len(rows_) <= n_pool, "pool too small for the case")
                phys = torch.randperm(n_pool, generator=g)[:len(rows_)]
                rows_t = torch.tensor(rows_, device=dev)
                cols_t = torch.tensor(cols_, device=dev)
                phys = phys.to(dev)
                kp = torch.zeros(n_pool + 1, ps, hkv, dh, dtype=dt,
                                 device=dev)
                vp = torch.zeros_like(kp)
                kp[phys] = kc.reshape(b, mp, ps, hkv, dh)[rows_t, cols_t]
                vp[phys] = vc.reshape(b, mp, ps, hkv, dh)[rows_t, cols_t]
                ptab = torch.full((b, mp), n_pool, dtype=torch.int32,
                                  device=dev)
                ptab[rows_t, cols_t] = phys.to(torch.int32)
                paged = paged_decode_attention(q, kp, vp, ptab, lens)
                check(torch.equal(paged, out),
                      f"B2 != B1 bitwise (ps {ps}, B={b}, M={m}, {dtype})")
                unref = torch.ones(n_pool + 1, dtype=torch.bool, device=dev)
                unref[phys] = False
                kp[unref] = float("nan")
                vp[unref] = float("nan")
                poisoned = paged_decode_attention(q, kp, vp, ptab, lens)
                check(torch.equal(poisoned, out),
                      f"B2 changed by a NaN trash page (ps {ps})")
                kp, vp = kp.nan_to_num(0.0), vp.nan_to_num(0.0)
                pref = paged_decode_attention_reference(q, kp, vp, ptab,
                                                        lens)
                perr[ps], share = plain_close(paged, pref, dtype)
                check(share <= 1, f"B2 err {perr[ps]}, {share:.3f} of its "
                      f"limit (ps {ps})")
                if ps == 16 and main_case and dtype == "bfloat16":
                    main["paged"] = (q, kp, vp, ptab, lens, lens_l, ps,
                                     perr[ps])
            print(line + f" | B2 err ps16 {perr[16]:.3e} ps64 "
                  f"{perr[64]:.3e} | B2 == B1 bitwise, NaN trash invariant",
                  flush=True)
            if main_case and dtype == "bfloat16":
                main["dense"] = (q, kc, vc, lens, lens_l, err)

    # times at the serve run's shape (B 16, M 512, bf16)
    rows = []
    q, kc, vc, lens, lens_l, err = main["dense"]
    mask = (torch.arange(kc.shape[1], device=dev)[None] <
            lens[:, None])[:, None, None, :]
    q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    b1_ms = timer.ms(lambda: decode_attention(q, kc, vc, lens))
    plain_ms = timer.ms(lambda: decode_attention_reference(q, kc, vc, lens),
                        iters=20)
    sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True))
    bms, by = bound(lens_l, 0, "bfloat16", 2, q.shape[0], h, hkv, dh)
    rows.append({"name": "decode_attention" + suffix, "route": "cuda",
                 "source": "src/repro_torch/kernels/decode_attention/csrc/"
                           "decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention/"
                             "kernel.py:45",
                 "max_abs_err": err, "ms": b1_ms, "plain_ms": plain_ms,
                 "bound_ms": bms, "bound_by": by, "library_ms": sdpa_ms})
    q, kp, vp, ptab, lens, lens_l, ps, perr = main["paged"]
    b2_ms = timer.ms(lambda: paged_decode_attention(q, kp, vp, ptab, lens))
    plain2_ms = timer.ms(lambda: paged_decode_attention_reference(
        q, kp, vp, ptab, lens), iters=20)
    bms, by = bound(lens_l, ps, "bfloat16", 2, q.shape[0], h, hkv, dh)
    rows.append({"name": "paged_decode_attention" + suffix,
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/decode_attention/csrc/"
                           "decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention/"
                             "paged.py:47",
                 "max_abs_err": perr, "ms": b2_ms, "plain_ms": plain2_ms,
                 "bound_ms": bms, "bound_by": by, "library_ms": None})
    for r in rows:
        print(f"  {r['name']} @ H {h}/{hkv} dh {dh} B=16 M=512 bf16 (ps 16 "
              f"for B2): {r['ms'] * 1e3:.2f} us | bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) | plain {r['plain_ms'] * 1e3:.2f} us | "
              f"SDPA {r['library_ms'] and r['library_ms'] * 1e3}", flush=True)
    print(f"  B1 / SDPA at H {h}/{hkv}, dh {dh}: {b1_ms / sdpa_ms:.3f} | "
          f"B2 / B1: {b2_ms / b1_ms:.3f}", flush=True)
    return rows


def flash_bound(b, h, hkv, sq, skv, dh, causal, itemsize):
    """Least time for B3's work on these inputs: 4 * dh FLOP per visible
    (query, key) pair (QK^T and PV) at the bf16 tensor-core peak, or q, k,
    v read once and o written once at the HBM rate, the larger."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    ops = 4 * dh * pairs * b * h
    nbytes = (2 * b * h * sq * dh + 2 * b * hkv * skv * dh) * itemsize
    t_ops = ops / PEAK_OPS["bfloat16" if itemsize == 2 else "float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# B3's timed shapes: the demo LM's training shape (the main row), then
# qwen2-vl-2b's (H 12/2, dh 128: a GQA group of 6), musicgen-medium's
# (H 24/24, MHA) and stablelm-12b's (H 32/8, dh 160) at seq 1024, batch 8
# (phase 18), and granite-moe-1b-a400m's (H 16/8, phase 21), each a row of
# its own
FLASH_ROWS = (("flash_attention", (8, 12, 4, 1024, 64)),
              ("flash_attention_dh128", (8, 12, 2, 1024, 128)),
              ("flash_attention_mha", (8, 24, 24, 1024, 64)),
              ("flash_attention_dh160", (8, 32, 8, 1024, 160)),
              ("flash_attention_h16", (8, 16, 8, 1024, 64)))
# the timed shapes whose bf16 causal run must catch a planted fault
PLANTED = ((8, 12, 4, 1024, 64), (8, 32, 8, 1024, 160))


def flash_phase(torch, timer, names, more=True):
    """B3 against its plain version at the shapes of the FLASH_ROWS in
    `names`, and with `more` at further shapes and through autograd;
    returns those rows, timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    dev = torch.device("cuda")

    def inputs(b, h, hkv, s, dh, dt, seed):
        g = torch.Generator().manual_seed(seed)
        return [torch.randn(b, s, n, dh, generator=g).to(dev, dt)
                for n in (h, hkv, hkv)]

    def plain(q, k, v, causal, keep=None):
        """The plain version in the model layout; `keep(kpos)` False
        leaves a key out (the planted fault)."""
        if keep is None:
            return attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=causal
                                       ).transpose(1, 2)
        qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
        kh, vh = (t.repeat_interleave(q.shape[2] // k.shape[2], dim=1)
                  for t in (kh, vh))
        sc = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * q.shape[-1] ** -0.5
        pos = torch.arange(q.shape[1], device=q.device)
        mask = keep(pos)[None, :] & (pos[None, :] <= pos[:, None]
                                     if causal else True)
        probs = sc.masked_fill(~mask, float("-inf")).softmax(-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs, vh).to(q.dtype
                                                             ).transpose(1, 2)

    timed = [(n, shape) for n, shape in FLASH_ROWS if n in names]
    shapes = [shape for _, shape in timed]
    if more:
        shapes += [(2, 12, 4, 1000, 64), (2, 12, 12, 256, 64),
                   (2, 12, 1, 256, 64), (2, 8, 2, 200, 128)]
    errs = {}
    for b, h, hkv, s, dh in shapes:
        for dtype in ("bfloat16", "float32"):
            for causal in (True, False):
                q, k, v = inputs(b, h, hkv, s, dh, getattr(torch, dtype),
                                 s + dh)
                out = flash_attention(q, k, v, causal=causal)
                again = flash_attention(q, k, v, causal=causal)
                ref = plain(q, k, v, causal)
                torch.cuda.synchronize()
                err, share = plain_close(out, ref, dtype)
                tag = (f"B3 B={b} H={h} Hkv={hkv} S={s} dh={dh} {dtype:8s} "
                       f"causal={causal!s:5s}")
                check(bool(torch.isfinite(out).all()), f"{tag}: non-finite")
                check(share <= 1, f"{tag}: max abs err {err}, {share:.3f} "
                      f"of its limit")
                check(torch.equal(out, again),
                      f"{tag}: two calls differ")
                print(f"  {tag}: max abs err {err:.3e} ({share:.3f} of the "
                      f"limit); two calls bitwise equal", flush=True)
                if (b, s, dtype, causal) == (8, 1024, "bfloat16", True):
                    errs[(b, h, hkv, s, dh)] = err
                if (b, h, hkv, s, dh) in PLANTED and (dtype, causal) == (
                        "bfloat16", True):
                    # the plain version leaving out keys 127, 255, ...:
                    # what a kernel that lost one key per tile gives
                    planted = plain(q, k, v, causal, keep=lambda kpos:
                                    kpos % 128 != 127)
                    p_err, p_share = plain_close(planted, ref, dtype)
                    check(p_share > 1, f"the bf16 limit passes a planted "
                          f"fault (max abs err {p_err}, {p_share:.3f} of "
                          f"the limit)")
                    print(f"  planted fault at dh {dh} (one key in 128 "
                          f"left out): {p_err:.3e} ({p_share:.3f} of the "
                          f"limit, caught)", flush=True)

    if more:
        flash_gradients(torch, inputs, plain)
    rows = []
    for name, (b, h, hkv, s, dh) in timed:
        q, k, v = inputs(b, h, hkv, s, dh, torch.bfloat16, s + dh)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        ms = timer.ms(lambda: flash_attention(q, k, v))
        plain_ms = timer.ms(lambda: plain(q, k, v, True), iters=20)
        sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True))
        bms, by = flash_bound(b, h, hkv, s, s, dh, True, 2)
        print(f"  {name} @ B={b} H={h} Hkv={hkv} S={s} dh={dh} bf16 causal: "
              f"{ms * 1e3:.2f} us | bound {bms * 1e3:.2f} us ({by}) | plain "
              f"{plain_ms * 1e3:.2f} us | SDPA {sdpa_ms * 1e3:.2f} us | "
              f"B3 / SDPA {ms / sdpa_ms:.3f}", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/flash_attention/"
                               "csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/"
                                 "kernel.py:32",
                     "max_abs_err": errs[(b, h, hkv, s, dh)], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": sdpa_ms})
    return rows


def flash_gradients(torch, inputs, plain):
    """Autograd through B3's Function against autograd through the plain
    version (the backward is the plain formula's VJP)."""
    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    q, k, v = (t.requires_grad_() for t in inputs(2, 12, 4, 256, 64,
                                                  torch.float32, 1))
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dev)
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), go)
    want = torch.autograd.grad(plain(q, k, v, True), (q, k, v), go)
    gerr = max((a - w).abs().max().item() for a, w in zip(got, want))
    check(gerr <= 1e-5, f"B3 gradients differ from the plain VJP by {gerr}")
    print(f"  B3 gradients (q, k, v; f32, S 256) vs autograd through the "
          f"plain version: max abs err {gerr:.3e} (tol 1e-5)", flush=True)


def serve_phase(torch):
    import numpy as np

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    dev = torch.device("cuda")
    cfg = registry.get_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg, dev)
    slots, max_len, block, n_req, max_new = 16, 512, 8, 32, 32
    rng = np.random.default_rng(0)
    heads = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (32, 48)]
    prompts = []
    for i in range(n_req):
        tail = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, 153))).astype(np.int32)
        prompts.append(np.concatenate([heads[i % 2], tail]) if i % 4 < 2
                       else tail)
    check(min(map(len, prompts)) >= 4 and max(map(len, prompts)) <= 200,
          "prompt lengths outside 4-200")
    dense_pages = slots * max_len // 16

    def run(page_size, temp, ps=prompts, new=max_new):
        ecfg = EngineConfig(max_batch=slots, max_len=max_len,
                            decode_block=block, page_size=page_size,
                            pool_pages=dense_pages // 2 if page_size else None,
                            prefix_cache=8 if page_size else 0)
        eng = ServingEngine(cfg, fns, params, ecfg)
        for uid, p in enumerate(ps):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=new,
                               temperature=temp))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode_attention.launches = 0
        paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (decode_attention.launches,
                    paged_decode_attention.launches)
        return eng, done, dt, launches

    run(0, 0.0)                       # warm-up: cuBLAS handles, allocator
    totals = [0, 0]
    results = {}
    for temp in (0.0, 0.7):
        for page_size in (0, 16):
            eng, done, dt, launches = run(page_size, temp)
            s = eng.stats
            check(len(done) == n_req and all(
                len(r.generated) == max_new for r in done),
                f"not every request completed (page {page_size}, T {temp})")
            sub = s["decode_blocks"] * block
            want = (cfg.n_layers * sub, 0) if not page_size \
                else (0, cfg.n_layers * sub)
            check(launches == want, f"kernel launches {launches} != "
                  f"{want} (n_layers x {sub} sub-steps)")
            totals[0] += launches[0]
            totals[1] += launches[1]
            results[(page_size, temp)] = {r.uid: r.generated for r in done}
            extra = ""
            if page_size:
                ps = eng.page_stats()
                check(ps["device_live"] == ps["pool_pages"] - ps["host_free"],
                      "pages leaked: only prefix-cache pins may stay live")
                extra = (f" | pool {ps['pool_pages']} pages, "
                         f"{s['prefix_hits']} prefix hits, "
                         f"{s['pages_shared']} pages shared, "
                         f"{s['admission_stalls']} admission stalls, "
                         f"{ps['device_live']} live after drain")
            print(f"  serve {'paged' if page_size else 'dense'} T={temp}: "
                  f"{s['tokens']} tokens in {dt:.3f} s = "
                  f"{s['tokens'] / dt:.1f} tok/s | "
                  f"{s['host_syncs'] / s['tokens']:.4f} host syncs/token | "
                  f"{s['decode_blocks']} blocks | launches B1 {launches[0]} "
                  f"B2 {launches[1]} | peak "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
                  + extra, flush=True)
            del eng, done         # the next run's peak memory is its own
        check(results[(16, temp)] == results[(0, temp)],
              f"paged != dense token streams at T={temp}")
        print(f"  T={temp}: paged == dense token streams (bitwise)",
              flush=True)
    differ = sum(a != b for uid in results[(0, 0.0)] for a, b in
                 zip(results[(0, 0.0)][uid], results[(0, 0.7)][uid]))
    print(f"  T=0.7 vs greedy: {differ} of {n_req * max_new} tokens differ "
          f"(random weights give near one-hot logits)", flush=True)
    # a short window (one fill of 16 requests x 16 tokens): the trace's
    # processing grows with its events
    profile_window(torch, "dense, greedy, 16 requests x 16 tokens",
                   lambda: run(0, 0.0, prompts[:16], 16)[2])

    # full-width logits: finite, of the expected shape
    cache = fns.init_cache(cfg, 2, 64, device=dev)
    logits, _ = fns.decode_step(params, cache, torch.tensor(
        [[1, 2, 3], [4, 5, 6]], device=dev), cfg)
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "full-width logits")
    return totals


def profile_window(torch, label, fn, watch=()):
    """fn() (which returns its own wall time) under torch.profiler: device
    busy share of the wall time, the kernels that take the most device
    time, and the device time of kernels whose names hold a `watch`
    string.  Returns {"wall": s, "busy": s, name: (s, launches) for each
    watched name}, or None where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    # device activity only: the host ops' events would triple the trace's
    # processing time and add nothing to these sums
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = fn()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy == 0:
        print("  profiler: no device time recorded", flush=True)
        return None
    print(f"  profile ({label}): wall {wall:.3f} s, device busy "
          f"{busy:.3f} s = {busy / wall:.1%}, idle {1 - busy / wall:.1%}",
          flush=True)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.self_device_time_total / 1e6 / busy:6.1%} x{e.count:<6d} "
              f"{e.key[:90]}", flush=True)
    seen = {"wall": wall, "busy": busy}
    for name in watch:
        hit = [e for e in events if name in e.key]
        t = sum(e.self_device_time_total for e in hit) / 1e6
        n = sum(e.count for e in hit)
        seen[name] = (t, n)
        print(f"    {name}: {t * 1e3:.2f} ms = {t / busy:.1%} of device "
              f"time over {n} launches", flush=True)
    return seen


def kernel_ms(torch, fn, reps=3, tries=3):
    """Device time of one call of fn() with many small kernels: the sum of
    its kernels' device time under torch.profiler, the mean of `reps`
    calls after a warm-up.  Unlike CUDA events around the call, the
    host's launch gaps do not count.  None when `tries` profiles in a
    row record no device time (a profile can come back without the
    calls' kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA")
        if total > 0:
            return total / 1e3 / reps
    return None


def train_phase(torch):
    """Full-width training through FaultTolerantTrainer, fused and
    per-step, compared bitwise; returns B3's launches over both runs and
    the wall seconds of one fused block of 8 steps (phase 23 sets it
    beside the analytic roofline)."""
    import numpy as np

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import registry
    from repro_torch.train import (AdamWConfig, DataConfig,
                                   FaultTolerantTrainer, FTConfig,
                                   SyntheticLM, TrainConfig, init_train_state,
                                   make_fused_steps, make_train_step,
                                   restore_latest, screen_init)
    from repro_torch.train.tree import tree_paths
    dev = torch.device("cuda")
    cfg = registry.get_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    steps, k, seq, batch = 16, 8, 1024, 8
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                       total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0), dev)
    state0 = init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                              dev)
    step_fn = make_train_step(cfg, fns, tcfg)
    fused = make_fused_steps(cfg, fns, tcfg)
    step_fn(state0, data.batch_at(0))     # warm-up: cuBLAS, allocator
    tokens = steps * seq * batch
    want_launches = 2 * cfg.n_layers * steps

    def equal_trees(a, b):
        pa, pb = tree_paths(a), tree_paths(b)
        return list(pa) == list(pb) and all(
            pa[n].dtype == pb[n].dtype and torch.equal(pa[n], pb[n])
            for n in pa)

    runs = {}
    for mode in ("run_fused", "run"):
        # snapshots (1.2 GB of f32 params and moments, two replicas) at
        # steps 0 and 16; the timed run includes writing them
        with tempfile.TemporaryDirectory() as tmp:
            dirs = (os.path.join(tmp, "a"), os.path.join(tmp, "b"))
            ft = FTConfig(checkpoint_dirs=dirs, checkpoint_every=steps,
                          keep=1, drain_every=k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr = FaultTolerantTrainer(step_fn, state0, data, ft,
                                      fused_steps=fused)
            flash_attention.launches = 0
            t0 = time.perf_counter()
            hist = getattr(tr, mode)(steps)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = flash_attention.launches
            losses = [h["loss"] for h in hist]
            st = tr.stats
            print(f"  train {mode}: {steps} steps x {seq * batch} tokens in "
                  f"{dt:.3f} s = {tokens / dt:.1f} tok/s | "
                  f"{st['host_syncs'] / steps:.4f} host syncs/step "
                  f"({st['drains']} drains, {st['checkpoints']} checkpoint "
                  f"snapshots) | B3 launches {launches} | peak "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
                  flush=True)
            print(f"    loss {' '.join(f'{x:.4f}' for x in losses)}",
                  flush=True)
            check(len(losses) == steps and all(np.isfinite(losses)),
                  f"{mode}: a loss is not finite: {losses}")
            check(losses[-1] < losses[0],
                  f"{mode}: loss did not fall ({losses[0]} -> {losses[-1]})")
            check(st["rollbacks"] == 0, f"{mode}: {st['rollbacks']} "
                  f"rollbacks on a clean run")
            check(launches == want_launches, f"{mode}: B3 launched "
                  f"{launches} times, want 2 x {cfg.n_layers} x {steps}")
            got_step, restored = restore_latest(tr.state, dirs)
            check(got_step == steps and equal_trees(restored, tr.state)
                  and restored["params"]["embed"].is_cuda,
                  f"{mode}: newest checkpoint (step {got_step}) does not "
                  f"restore onto the card bitwise")
            runs[mode] = (losses, tr.state, launches, st)
    check(runs["run_fused"][3]["drains"] == steps // k,
          f"run_fused drained {runs['run_fused'][3]['drains']} times, "
          f"want {steps // k}")
    check(runs["run_fused"][0] == runs["run"][0],
          "run_fused and run losses differ")
    check(equal_trees(runs["run_fused"][1], runs["run"][1]),
          "run_fused and run final states differ")
    print("  run_fused == run: losses and final state bitwise; no host "
          "sync inside a fused block (sync debug mode \"error\"); "
          "newest checkpoints restore bitwise", flush=True)

    def one_block():
        batches = data.batch_block(np.arange(k))
        thr = torch.tensor([3.0, 10.0], device=dev)
        screen = screen_init(32, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused(state0, screen, batches, thr)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    wall = one_block()
    print(f"  one fused block of {k} steps, no checkpoints: {wall:.3f} s = "
          f"{k * seq * batch / wall:.1f} tok/s", flush=True)
    profile_window(torch, f"one fused block of {k} train steps", one_block,
                   watch=("flash_fwd_tc",))
    return runs["run_fused"][2] + runs["run"][2], wall


def train_reference(torch):
    """Reduced widths with head_dim 64, f32: one train step on the card
    against the same step on the CPU."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.train import (DataConfig, SyntheticLM, TrainConfig,
                                   init_train_state, make_train_step)
    from repro_torch.train.tree import tree_paths
    cfg = registry.get_reduced_config("suncatcher-lm-100m",
                                      compute_dtype="float32", head_dim=64)
    fns = registry.model_fns(cfg)
    step = make_train_step(cfg, fns, TrainConfig(warmup_steps=0))
    out = {}
    for d in ("cpu", "cuda"):
        state = init_train_state(torch.Generator().manual_seed(1), cfg, fns,
                                 d)
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=128, global_batch=4), d
                            ).batch_at(0)
        out[d] = step(state, batch)
    (sc, mc), (sg, mg) = out["cpu"], out["cuda"]
    rel = max(abs(mg[n].item() - mc[n].item()) / abs(mc[n].item())
              for n in ("loss", "grad_norm"))
    # AdamW's first step moves each element by ~lr * sign(g): an element
    # whose gradient is at rounding level may step differently, so params
    # get lr / 10 of slack, and at most 1 in 1000 may differ by > 1e-6
    lr = TrainConfig().adamw.lr
    diffs = [(tree_paths(sg)[n].cpu() - p).abs()
             for n, p in tree_paths(sc).items()]
    perr = max(d.max().item() for d in diffs)
    share = sum((d > 1e-6).sum().item() for d in diffs) / sum(
        d.numel() for d in diffs)
    check(rel <= 1e-4 and perr <= lr / 10 and share <= 1e-3
          and np.isfinite(perr),
          f"card vs CPU train step: loss/grad-norm rel {rel}, params max "
          f"{perr}, share > 1e-6 {share}")
    print(f"  reduced config f32, one train step: card vs CPU loss and grad "
          f"norm rel err {rel:.3e} (tol 1e-4), params max abs err "
          f"{perr:.3e} (tol lr/10 = {lr / 10:.0e}), share of params off by "
          f"> 1e-6 {share:.2e} (tol 1e-3)", flush=True)


def reference_phase(torch):
    """Small config (the reduced widths with head_dim 64, which the
    kernels take), f32: decode on the card == decode on the CPU."""
    from repro_torch.models import registry
    cfg = registry.get_reduced_config("suncatcher-lm-100m",
                                      compute_dtype="float32", head_dim=64)
    fns = registry.model_fns(cfg)
    cpu = fns.init(torch.Generator().manual_seed(1), cfg, "cpu")
    gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()}
               if isinstance(v, dict) else v.cuda()) for k, v in cpu.items()}
    caches = {d: fns.init_cache(cfg, 2, 64, device=d)
              for d in ("cpu", "cuda")}
    for c in caches.values():
        c["pos"] = torch.zeros(2, dtype=torch.int32, device=c["k"].device)
    toks = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
                          19, 20], [7] * 16])
    last = torch.tensor([15, 4])
    worst = 0.0
    lc, caches["cpu"] = fns.decode_step(cpu, caches["cpu"], toks, cfg,
                                        last_idx=last)
    lg, caches["cuda"] = fns.decode_step(gpu, caches["cuda"], toks.cuda(),
                                         cfg, last_idx=last.cuda())
    caches["cpu"]["pos"] = torch.tensor([16, 5], dtype=torch.int32)
    caches["cuda"]["pos"] = caches["cpu"]["pos"].cuda()
    for _ in range(4):
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        nxt = lc.argmax(-1, keepdim=True)
        lc, caches["cpu"] = fns.decode_step(cpu, caches["cpu"], nxt, cfg)
        lg, caches["cuda"] = fns.decode_step(gpu, caches["cuda"], nxt.cuda(),
                                             cfg)
    worst = max(worst, (lg.cpu() - lc).abs().max().item())
    check(worst <= 1e-3, f"card vs CPU logits differ by {worst}")
    print(f"  reduced config f32, prefill + 4 decode steps: card vs CPU "
          f"logits max abs err {worst:.3e} (tol 1e-3)", flush=True)


def scan_bound(b, s, d, itemsize):
    """Least time for B4's work: a and x read once and h written once at
    the HBM rate, or 2 FLOP per element at the f32 rate, the larger."""
    t_bytes = 3 * b * s * d * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * s * d / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rglru_kernel_phase(torch, timer):
    """B4 against its plain version, and B1 at recurrentgemma-2b's decode
    widths (H 10, Hkv 1, dh 256, M = W = 2048); returns their rows of the
    kernels line: B4 at the serve and long prefill shapes, B1 on the
    serve run's rings and on full rings."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference)
    from repro_torch.kernels.rglru_scan import (rglru_scan,
                                                rglru_scan_reference)
    from repro_torch.kernels.rglru_scan import kernel as b4
    dev = torch.device("cuda")

    def inputs(b, s, d, dt, seed):
        g = torch.Generator().manual_seed(seed)
        a = torch.empty(b, s, d).uniform_(0.2, 0.999, generator=g)
        return a.to(dev, dt), torch.randn(b, s, d, generator=g).to(dev, dt)

    # (B, S, D, dtype, offset in elements of a view into a larger buffer):
    # the serve and long prefill shapes, recurrentgemma-2b's training
    # shape, an xLSTM prefix sum's (one 256-step chunk of 4 heads at
    # batch 8), B = 1, S not a multiple of the
    # ring's stage depth with D not a multiple of its channel tile, a
    # ragged D whose rows are not 16-byte multiples and a base 4 bytes in
    # (both on the cp.async path), bf16 long, and bf16 at an odd D
    # (widened to f32 for the cp.async path)
    for b, s, d, dtype, off in ((16, 256, 2560, "float32", 0),
                                (8, 1024, 2560, "float32", 0),
                                (8, 256, 4, "float32", 0),
                                (3, 100, 70, "float32", 0),
                                (2, 2048, 2560, "float32", 0),
                                (1, 2048, 2560, "float32", 0),
                                (3, 1001, 2600, "float32", 0),
                                (2, 517, 2560, "float32", 1),
                                (1, 512, 256, "bfloat16", 0),
                                (2, 2048, 2560, "bfloat16", 0),
                                (2, 300, 77, "bfloat16", 0)):
        a, x = inputs(b, s, d, getattr(torch, dtype), b * s + d)
        if off:
            a, x = (torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
                    [off:].view_as(t).copy_(t) for t in (a, x))
        path = b4.copy_path(a, x)
        out = rglru_scan(a, x)
        ref = rglru_scan_reference(a, x)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(out).all()) and out.dtype == x.dtype,
              f"B4 non-finite or wrong dtype at {b}x{s}x{d}")
        if dtype == "float32":
            check(torch.equal(out, ref), f"B4 f32 {b}x{s}x{d} ({path}): not "
                  f"bitwise equal to the plain version (max abs err {err})")
        else:
            check(err <= 0.1, f"B4 bf16 {b}x{s}x{d}: max abs err {err}")
        print(f"  B4 B={b} S={s} D={d} {dtype:8s} "
              f"{f'base +{off * 4} B, ' if off else ''}path {path}: max abs "
              f"err {err:.3e} "
              f"({'bitwise' if dtype == 'float32' else 'tol 0.1'})",
              flush=True)
    a, x = inputs(2, 300, 130, torch.float32, 5)
    check(torch.equal(rglru_scan(torch.zeros_like(a), x), x),
          "B4: a == 0 does not give x")
    xi = torch.randint(-8, 9, (2, 300, 130), generator=torch.Generator()
                       .manual_seed(6)).float().to(dev)
    check(torch.equal(rglru_scan(torch.ones_like(xi), xi), xi.cumsum(1)),
          "B4: a == 1 does not give the cumsum of integer-valued x")
    a, x = (t.requires_grad_() for t in inputs(1, 128, 128, torch.float32,
                                               7))
    go = torch.randn(1, 128, 128, generator=torch.Generator().manual_seed(8)
                     ).to(dev)
    got = torch.autograd.grad(rglru_scan(a, x), (a, x), go)
    want = torch.autograd.grad(rglru_scan_reference(a, x), (a, x), go)
    gerr = max((u - w).abs().max().item() for u, w in zip(got, want))
    check(gerr <= 1e-5, f"B4 gradients differ from the plain VJP by {gerr}")
    print(f"  B4: a == 0 gives x, a == 1 the cumsum (bitwise); gradients "
          f"vs autograd through the plain version: max abs err {gerr:.3e} "
          f"(tol 1e-5)", flush=True)

    # times at the serve and long prefill shapes and at B = 1; beside them
    # the same kernel after an L2 flush that reads (no write-back of a
    # dirty line lands inside the call) and an elementwise a * x, which
    # moves the same bytes (a and x read once, one output written)
    times = {}
    for b, s, d in ((16, 256, 2560), (4, 2048, 2560), (1, 2048, 2560)):
        a, x = inputs(b, s, d, torch.float32, 9)
        err = (rglru_scan(a, x) - rglru_scan_reference(a, x)).abs().max(
            ).item()
        check(err == 0, f"B4 at {b}x{s}x{d}: max abs err {err}")
        path = b4.copy_path(a, x)
        prod = torch.empty_like(x)
        ms = timer.ms(lambda: rglru_scan(a, x))
        clean_ms = timer.ms(lambda: rglru_scan(a, x), clean=True)
        mul_ms = timer.ms(lambda: torch.mul(a, x, out=prod))
        plain_ms = timer.ms(lambda: rglru_scan_reference(a, x), iters=5)
        bms, by = scan_bound(b, s, d, 4)
        times[(b, s, d)] = (err, path, ms, plain_ms, bms, by)
        print(f"  rglru_scan @ B={b} S={s} D={d} f32 ({path}): "
              f"{ms * 1e3:.2f} us | bound {bms * 1e3:.2f} us ({by}), "
              f"{bms / ms:.3f} of it | after a reading L2 flush "
              f"{clean_ms * 1e3:.2f} us | a * x (same bytes) "
              f"{mul_ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
              f"library: none", flush=True)

    # B1 at dh 256, group 10, a 2048-slot ring
    h, hkv, dh, m = 10, 1, 256, 2048
    b1_err = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        g = torch.Generator().manual_seed(256)
        q = torch.randn(16, h, dh, generator=g).to(dev, dt)
        kc = torch.randn(16, m, hkv, dh, generator=g).to(dev, dt)
        vc = torch.randn(16, m, hkv, dh, generator=g).to(dev, dt)
        lens_l = torch.randint(1, m + 1, (16,), generator=g).tolist()
        lens_l[:5] = [0, m, 1, 33, m - 1]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        out = decode_attention(q, kc, vc, lens)
        ref = decode_attention_reference(q, kc, vc, lens)
        torch.cuda.synchronize()
        err, share = plain_close(out, ref, dtype)
        check(bool(torch.isfinite(out).all()), "B1 dh 256 non-finite")
        check(share <= 1, f"B1 dh 256 {dtype}: max abs err {err}, "
              f"{share:.3f} of its limit")
        check(bool((out[0] == 0).all()), "B1 dh 256 kv_len == 0 row not 0")
        b1_err[dtype] = err
        print(f"  B1 H=10 Hkv=1 dh=256 M=2048 B=16 {dtype:8s}: max abs err "
              f"{err:.3e} ({share:.3f} of the limit)", flush=True)
    # times in bf16: the serve run's rings (kv_len <= 232) and full rings
    b1_times = {}
    full_err = None
    for b, cap in ((16, 232), (4, 2048)):
        g = torch.Generator().manual_seed(cap)
        q = torch.randn(b, h, dh, generator=g).to(dev, torch.bfloat16)
        kc = torch.randn(b, m, hkv, dh, generator=g).to(dev, torch.bfloat16)
        vc = torch.randn(b, m, hkv, dh, generator=g).to(dev, torch.bfloat16)
        lens_l = ([cap] * b if cap == m else
                  torch.randint(4, cap + 1, (b,), generator=g).tolist())
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        mask = (torch.arange(m, device=dev)[None] <
                lens[:, None])[:, None, None, :]
        q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        if cap == m:
            out = decode_attention(q, kc, vc, lens)
            ref = decode_attention_reference(q, kc, vc, lens)
            full_err, share = plain_close(out, ref, "bfloat16")
            check(share <= 1, f"B1 dh 256 full rings: max abs err "
                  f"{full_err}, {share:.3f} of its limit")
            # the plain version leaving out positions 63, 127, ...: what a
            # kernel that lost one position per 64-position split gives
            keep = torch.arange(m, device=dev) % 64 != 63
            s = torch.einsum("bhd,btd->bht", q.float(),
                             kc[:, :, 0].float()) * dh ** -0.5
            p = s.masked_fill(~keep, float("-inf"))
            planted = torch.einsum("bht,btd->bhd", p.softmax(-1),
                                   vc[:, :, 0].float()).to(q.dtype)
            p_err, p_share = plain_close(planted, ref, "bfloat16")
            check(p_share > 1, f"the bf16 limit passes a planted fault "
                  f"(max abs err {p_err}, {p_share:.3f} of the limit)")
            print(f"  B1 dh 256 full rings bf16: max abs err {full_err:.3e} "
                  f"({share:.3f} of the limit) | planted fault (one "
                  f"position in 64 left out): {p_err:.3e} ({p_share:.3f} "
                  f"of the limit, caught)", flush=True)
        ms = timer.ms(lambda: decode_attention(q, kc, vc, lens))
        plain_ms = timer.ms(lambda: decode_attention_reference(q, kc, vc,
                                                               lens), iters=20)
        sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True))
        bms, by = bound(lens_l, 0, "bfloat16", 2, b, h, hkv, dh)
        b1_times[cap] = (ms, plain_ms, sdpa_ms, bms, by)
        print(f"  decode_attention dh 256 @ B={b} M=2048 kv_len "
              f"{'= 2048' if cap == m else '<= 232'} bf16: {ms * 1e3:.2f} us "
              f"| bound {bms * 1e3:.2f} us ({by}) | plain "
              f"{plain_ms * 1e3:.2f} us | SDPA {sdpa_ms * 1e3:.2f} us | "
              f"B1 / SDPA {ms / sdpa_ms:.3f}", flush=True)
    rows = []
    for name, shape in (("rglru_scan", (16, 256, 2560)),
                        ("rglru_scan_long", (4, 2048, 2560))):
        err, path, ms, plain_ms, bms, by = times[shape]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/rglru_scan/csrc/"
                               "rglru_scan.cu",
                     "replaces": "src/repro/kernels/rglru_scan/kernel.py:26",
                     "path": path, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": None})
    for name, cap, err in (("decode_attention_dh256", 232, b1_err["bfloat16"]),
                           ("decode_attention_dh256_full", m, full_err)):
        ms, plain_ms, sdpa_ms, bms, by = b1_times[cap]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/decode_attention/"
                               "csrc/decode_attention.cu",
                     "replaces": "src/repro/kernels/decode_attention/"
                                 "kernel.py:45",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": sdpa_ms})
    return rows


def scan_bwd_bound(b, s, d):
    """Least time for B4's backward: a, h and g read once and dx and da
    written once (f32) at the HBM rate, or 3 FLOP per element at the f32
    rate, the larger."""
    t_bytes = 5 * b * s * d * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * b * s * d / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rglru_bwd_phase(torch, timer):
    """B4's backward kernel against its plain version (the reverse walk of
    `ref.rglru_scan_backward_reference`): f32 bitwise (bit patterns, so
    da_0's signed zeros count) at the training shape (8, 1024, 2560) and
    at the shapes B4's forward is checked at on both copy paths, bf16
    within B4's bf16 limit 0.1; a planted fault (the plain version with
    one position's a dropped) must fail the bitwise check; through the
    autograd wrapper, one backward launches this kernel once and no other
    kernel.  Timed at the training shape beside its bound, the plain
    version and torch.mul over flat tensors that move the same bytes.
    Returns its row of the kernels line."""
    from repro_torch.kernels.rglru_scan import kernel as b4
    from repro_torch.kernels.rglru_scan import (
        rglru_scan, rglru_scan_backward_reference, rglru_scan_reference)
    dev = torch.device("cuda")

    def inputs(b, s, d, dt, seed, off=0):
        """a, h (the f32 carry of a scan of x) and g; `off` puts each in a
        view `off` elements into a larger buffer."""
        g = torch.Generator().manual_seed(seed)
        a = torch.empty(b, s, d).uniform_(0.2, 0.999, generator=g)
        x, go = (torch.randn(b, s, d, generator=g) for _ in range(2))
        a, x, go = a.to(dev, dt), x.to(dev, dt), go.to(dev, dt)
        h = rglru_scan(a.float(), x.float())
        ts = [a, h, go]
        if off:
            ts = [torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
                  [off:].view_as(t).copy_(t) for t in ts]
        return ts

    worst = 0.0
    for b, s, d, dtype, off in ((8, 1024, 2560, "float32", 0),
                                (16, 256, 2560, "float32", 0),
                                (3, 100, 70, "float32", 0),
                                (1, 2048, 2560, "float32", 0),
                                (3, 1001, 2600, "float32", 0),
                                (2, 517, 2560, "float32", 1),
                                (8, 256, 4, "float32", 0),
                                (1, 512, 256, "bfloat16", 0),
                                (2, 2048, 2560, "bfloat16", 0),
                                (2, 300, 77, "bfloat16", 0)):
        a, h, go = inputs(b, s, d, getattr(torch, dtype), b * s + d, off)
        path = b4.copy_path(a.float(), h, go.float())
        n0 = b4.rglru_scan_bwd.launches
        got = b4.rglru_scan_bwd(a, h, go)
        check(b4.rglru_scan_bwd.launches == n0 + 1,
              "B4 backward: one call is not one launch")
        want = rglru_scan_backward_reference(a, h, go)
        torch.cuda.synchronize()
        err = max((u.float() - w.float()).abs().max().item()
                  for u, w in zip(got, want))
        tag = f"B4 backward {b}x{s}x{d} {dtype} ({path})"
        check(all(bool(torch.isfinite(u).all()) and u.dtype == w.dtype
                  for u, w in zip(got, want)),
              f"{tag}: non-finite or wrong dtype")
        if dtype == "float32":
            check(all(bits_equal(torch, u, w) for u, w in zip(got, want)),
                  f"{tag}: not bitwise equal to the plain version (max abs "
                  f"err {err})")
        else:
            check(err <= 0.1, f"{tag}: max abs err {err}")
        if (b, s, d) == (8, 1024, 2560):
            worst = err
        neg = int(torch.signbit(got[0][:, 0]).sum())
        print(f"  {tag}{f', bases +{off * 4} B' if off else ''}: max abs "
              f"err {err:.3e} ({'bit patterns equal' if dtype == 'float32' else 'tol 0.1'}); "
              f"da_0 = -0.0 in {neg} channels", flush=True)

    # the planted fault: one position's a dropped from the plain version
    a, h, go = inputs(8, 1024, 2560, torch.float32, 11)
    got = b4.rglru_scan_bwd(a, h, go)
    a_bad = a.clone()
    a_bad[:, 517] = 0.0
    bad = rglru_scan_backward_reference(a_bad, h, go)
    p_err = max((u - w).abs().max().item() for u, w in zip(got, bad))
    check(not all(bits_equal(torch, u, w) for u, w in zip(got, bad)),
          "the bitwise check passes a planted fault (a_517 dropped)")
    print(f"  planted fault (the plain version with a_517 dropped): max abs "
          f"err {p_err:.3e}, caught", flush=True)

    # the autograd wrapper: one forward launch, one backward launch, and
    # the backward's device activity is this kernel alone
    a, h, go = inputs(8, 1024, 2560, torch.float32, 12)
    x = torch.randn(a.shape, generator=torch.Generator().manual_seed(13)
                    ).to(dev)
    a.requires_grad_()
    x.requires_grad_()
    f0, b0 = b4.rglru_scan_fwd.launches, b4.rglru_scan_bwd.launches
    out = rglru_scan(a, x)
    grads = torch.autograd.grad(out, (a, x), go, retain_graph=True)
    check((b4.rglru_scan_fwd.launches - f0, b4.rglru_scan_bwd.launches - b0)
          == (1, 1), "B4 autograd: not one forward and one backward launch")
    want = torch.autograd.grad(rglru_scan_reference(a, x), (a, x), go)
    check(all(bits_equal(torch, u, w) for u, w in zip(grads, want)),
          "B4 autograd on the card: gradients differ from autograd through "
          "the plain version")
    names = []
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, (a, x), go, retain_graph=True)
            torch.cuda.synchronize()
        names = sorted(e.key for e in prof.key_averages()
                       if e.device_type.name == "CUDA"
                       and e.self_device_time_total > 0)
        if names:
            break
    check(len(names) == 1 and "rglru_scan_bwd_kernel" in names[0],
          f"B4 autograd backward: the profiler saw {names or 'no kernel'} "
          f"in 3 tries, not rglru_scan_bwd_kernel alone")
    print(f"  B4 autograd at 8x1024x2560 f32: one forward and one backward "
          f"launch, gradients bitwise equal to autograd through the plain "
          f"version; its device activity is rglru_scan_bwd_kernel alone",
          flush=True)

    # xLSTM's prefix sum as the mLSTM's chunked form makes it: a = 1 over
    # one 256-step chunk (a strided view of the (B, N, C, H) log forget
    # gates) at batch 8 and 4 heads, forward and backward against
    # autograd through the plain version, bit patterns equal
    logf = torch.nn.functional.logsigmoid(torch.randn(
        8, 4, 256, 4, generator=torch.Generator().manual_seed(14)).to(dev))
    fc = logf[:, 1].requires_grad_()
    gl = torch.randn(8, 256, 4, generator=torch.Generator().manual_seed(15)
                     ).to(dev)
    f0, b0 = b4.rglru_scan_fwd.launches, b4.rglru_scan_bwd.launches
    lam = rglru_scan(torch.ones_like(fc), fc)
    (dfc,) = torch.autograd.grad(lam, fc, gl)
    check((b4.rglru_scan_fwd.launches - f0, b4.rglru_scan_bwd.launches - b0)
          == (1, 1), "B4 at xLSTM's 8x256x4: not one forward and one "
          "backward launch")
    ones = torch.ones_like(fc)
    want_lam = rglru_scan_reference(ones, fc)
    (want_dfc,) = torch.autograd.grad(want_lam, fc, gl)
    check(bits_equal(torch, lam, want_lam)
          and bits_equal(torch, dfc, want_dfc),
          "B4 at xLSTM's 8x256x4 (a = 1, a strided chunk): not bitwise "
          "equal to the plain version")
    print("  B4 at xLSTM's prefix-sum shape 8x256x4 (a = 1, one chunk of a "
          "strided view): forward and its gradient bit patterns equal to "
          "autograd through the plain version, one launch each", flush=True)

    # times at the training shape, L2 flushed
    ms = timer.ms(lambda: b4.rglru_scan_bwd(a.detach(), h, go))
    plain_ms = timer.ms(lambda: rglru_scan_backward_reference(
        a.detach(), h, go), iters=3)
    n = a.numel() * 5 // 3           # two inputs and an output: 5N floats
    fa, fb, fo = (torch.empty(n, device=dev) for _ in range(3))
    mul_ms = timer.ms(lambda: torch.mul(fa, fb, out=fo))
    bms, by = scan_bwd_bound(8, 1024, 2560)
    print(f"  rglru_scan_bwd @ B=8 S=1024 D=2560 f32 "
          f"({b4.copy_path(a, h, go)}): {ms * 1e3:.2f} us | bound "
          f"{bms * 1e3:.2f} us ({by}), {bms / ms:.3f} of it | torch.mul "
          f"moving the same bytes {mul_ms * 1e3:.2f} us | plain "
          f"{plain_ms * 1e3:.2f} us | library: none", flush=True)
    return {"name": "rglru_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan/ops.py:28",
            "path": b4.copy_path(a, h, go), "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def family_rows(torch, timer):
    """Phase 2b's row at granite-moe's training widths and phase 2c's
    backward row: {row name: row}."""
    print("  B3 at granite-moe-1b-a400m's training widths (H 16/8, dh 64):",
          flush=True)
    rows = {r["name"]: r for r in flash_phase(
        torch, timer, ("flash_attention_h16",), more=False)}
    print("  B4's backward:", flush=True)
    rows["rglru_scan_bwd"] = rglru_bwd_phase(torch, timer)
    return rows


def _rglru_workload(np, vocab, n_req, rng):
    """Phase 3's prompt mix: 4-200 tokens, half behind one of two shared
    32/48-token heads."""
    heads = [rng.integers(0, vocab, n).astype(np.int32) for n in (32, 48)]
    prompts = []
    for i in range(n_req):
        tail = rng.integers(0, vocab, int(rng.integers(4, 153))
                            ).astype(np.int32)
        prompts.append(np.concatenate([heads[i % 2], tail]) if i % 4 < 2
                       else tail)
    return prompts


def rglru_serve_phase(torch):
    """recurrentgemma-2b at full width through ServingEngine; returns the
    launches of B4 over the phase's served runs at 16 slots and over its
    long runs (prefill at (4, 2048, 2560)), then B1's over the same two
    (the long runs' on full 2048-slot rings)."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    dev = torch.device("cuda")
    cfg = registry.get_config("recurrentgemma-2b")
    fns = registry.model_fns(cfg)
    t0 = time.perf_counter()
    # drawn on the card: 2.9B draws of the CPU generator take ~25 s
    params = fns.init(torch.Generator(dev).manual_seed(0), cfg, dev)
    n_params = sum(t.numel() for grp in params.values()
                   for t in (grp.values() if isinstance(grp, dict) else [grp]))
    check(n_params == cfg.param_count(), "param count")
    params = fns.cast_params(params, cfg)     # one bf16 copy for every run
    torch.cuda.synchronize()
    print(f"  {n_params / 1e9:.3f}B params from seed 0 drawn on the card "
          f"(f32 masters dropped after the bf16 cast): "
          f"{time.perf_counter() - t0:.1f} s | "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    n_rec = 2 * cfg.n_groups + cfg.n_tail_rec
    slots, max_len, n_req, max_new = 16, 512, 32, 32
    prompts = _rglru_workload(np, cfg.vocab_size, n_req,
                              np.random.default_rng(0))
    check(min(map(len, prompts)) >= 4 and max(map(len, prompts)) <= 200,
          "prompt lengths outside 4-200")
    totals = [0, 0]

    def run(temp, block, reqs, max_len=max_len, slots=slots, new=max_new):
        eng = ServingEngine(cfg, fns, params, EngineConfig(
            max_batch=slots, max_len=max_len, decode_block=block))
        calls = []
        prefill = eng.spec.prefill

        def counted(*a, **k):
            calls.append(1)
            return prefill(*a, **k)
        eng.spec.prefill = counted
        for uid, p in enumerate(reqs):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=new,
                               temperature=temp))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rglru_scan_fwd.launches = 0
        decode_attention.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (rglru_scan_fwd.launches, decode_attention.launches)
        s = eng.stats
        check(len(done) == len(reqs) and all(
            len(r.generated) == new for r in done),
            f"not every request completed (T {temp}, block {block})")
        sub = s["decode_blocks"] * block
        want = (n_rec * len(calls), cfg.n_groups * sub)
        check(launches == want, f"launches (B4, B1) {launches} != {want} "
              f"({n_rec} x {len(calls)} prefill calls, {cfg.n_groups} x "
              f"{sub} sub-steps)")
        totals[0] += launches[0]
        totals[1] += launches[1]
        print(f"  serve T={temp} decode_block {block}: {s['tokens']} tokens "
              f"in {dt:.3f} s = {s['tokens'] / dt:.1f} tok/s | "
              f"{s['host_syncs'] / s['tokens']:.4f} host syncs/token | "
              f"{s['decode_blocks']} blocks, {len(calls)} prefill calls | "
              f"launches B4 {launches[0]} B1 {launches[1]} | peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        return eng, {r.uid: r.generated for r in done}, dt, launches

    run(0.0, 8, prompts[:4], new=4)      # warm-up: cuBLAS, allocator
    streams = {}
    for temp in (0.0, 0.7):
        for block in (8, 1):
            eng, streams[(temp, block)], _, _ = run(temp, block, prompts)
            del eng
        check(streams[(temp, 1)] == streams[(temp, 8)],
              f"decode_block 1 != 8 token streams at T={temp}")
        print(f"  T={temp}: decode_block 1 == 8 token streams (bitwise)",
              flush=True)
    differ = sum(a != b for uid in streams[(0.0, 8)] for a, b in
                 zip(streams[(0.0, 8)][uid], streams[(0.7, 8)][uid]))
    print(f"  T=0.7 vs greedy: {differ} of {n_req * max_new} tokens differ",
          flush=True)
    profile_window(torch, "recurrentgemma-2b, greedy, 16 requests x 16 "
                   "tokens", lambda: run(0.0, 8, prompts[:16], new=16)[2],
                   watch=("rglru_scan_kernel", "decode_split_kernel",
                          "decode_merge_kernel"))

    # inactive rows: one request finished at prefill, one slot never used
    eng = ServingEngine(cfg, fns, params, EngineConfig(
        max_batch=slots, max_len=max_len, decode_block=8))
    for uid, new in enumerate((1, 20, 20)):
        eng.submit(Request(uid=uid, prompt=prompts[uid],
                           max_new_tokens=new))
    eng._fill_slots()
    check(eng.slots[0] is None and eng.slots[1] is not None,
          "the one-token request did not finish at prefill")

    def rows(i):
        st = eng.cache
        return [st["pos"][i].clone()] + [leaf[:, i].clone() for k in
                                         sorted(st) if k != "pos"
                                         for leaf in st[k]]
    before = {i: rows(i) for i in (0, slots - 1)}
    eng._decode_block()
    for i, leaves in before.items():
        check(all(torch.equal(a, b) for a, b in zip(rows(i), leaves)),
              f"inactive row {i}'s state changed across a decode block")
    print("  a finished row and a never-used row keep their whole state "
          "(carries, conv tails, rings, pos) bitwise across a decode block",
          flush=True)
    del eng

    # the long run: prompts of 2000-2040 tokens, positions past W = 2048,
    # so B1 reads (nearly) full rings; then once more under the profiler
    rng = np.random.default_rng(1)
    long = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in (2000, 2013, 2027, 2040)]
    serve = tuple(totals)

    def long_run(new=64):
        return run(0.7, 8, long, max_len=4096, slots=4, new=new)

    eng = long_run()[0]
    top = int(eng.cache["pos"].max())
    check(top > cfg.window, f"long run ended at pos {top} <= {cfg.window}")
    print(f"  long run: 4 x 2000-2040 prompt tokens + 64 new, bucket 2048, "
          f"positions to {top} (ring of {cfg.window} wrapped)", flush=True)
    del eng
    # the profiled run repeats its prefill with 16 new tokens (2 blocks)
    held = []

    def short_long_run():
        eng, _, dt, _ = long_run(16)
        held.append(eng.stats["decode_blocks"] * 8)
        return dt
    prof = profile_window(torch, "long run, 16 new tokens", short_long_run,
                          watch=("decode_split_kernel", "decode_merge_kernel",
                                 "rglru_scan_kernel"))
    if prof:
        sub = held[0]
        b1_ms = sum(prof[k][0] for k in ("decode_split_kernel",
                                         "decode_merge_kernel")) * 1e3
        b4_ms, b4_n = prof["rglru_scan_kernel"]
        print(f"  long run, device time per sub-step ({sub} sub-steps; "
              f"prefill included): {prof['busy'] * 1e3 / sub:.3f} ms, of "
              f"which B1 {b1_ms / sub:.3f} ms ({b1_ms / sub / 8 * 1e3:.2f} "
              f"us per call, split + merge); B4 {b4_ms * 1e3:.3f} ms over "
              f"its {b4_n} launches at (4, 2048, 2560) ("
              f"{b4_ms * 1e6 / max(b4_n, 1):.2f} us each)", flush=True)

    # full-width logits from one prefill call: finite, of the right shape
    spec = fns.decode_spec(cfg, dev)
    toks = torch.tensor(np.stack([prompts[0][:16], prompts[1][:16]]),
                        device=dev)
    logits, _ = spec.prefill(params, spec.init_state(2, 64), toks,
                             torch.tensor([16, 9], dtype=torch.int32,
                                          device=dev),
                             torch.ones(2, dtype=torch.bool, device=dev))
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "full-width logits")
    return (serve[0], totals[0] - serve[0], serve[1],
            totals[1] - serve[1])


def rglru_reference(torch):
    """recurrentgemma reduced at d_model 256 (head_dim 64, window 16),
    f32: prefill and 24 decode steps on the card against the CPU."""
    from repro_torch.models import registry
    cfg = registry.get_reduced_config("recurrentgemma-2b", d_model=256,
                                      compute_dtype="float32")
    fns = registry.model_fns(cfg)
    cpu = fns.init(torch.Generator().manual_seed(1), cfg, "cpu")
    gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()}
               if isinstance(v, dict) else v.cuda()) for k, v in cpu.items()}
    toks = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
                         [7] * 12])
    lens = torch.tensor([12, 5], dtype=torch.int32)
    admit = torch.ones(2, dtype=torch.bool)
    out = {}
    for d, p in (("cpu", cpu), ("cuda", gpu)):
        spec = fns.decode_spec(cfg, d)
        out[d] = spec, p, spec.prefill(p, spec.init_state(2, 64),
                                       toks.to(d), lens.to(d), admit.to(d))
    (sc, pc, (lc, stc)), (sg, pg, (lg, stg)) = out["cpu"], out["cuda"]
    worst = 0.0
    for _ in range(24):
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        nxt = lc.argmax(-1, keepdim=True).to(torch.int32)
        lc, stc = sc.decode(pc, stc, nxt)
        lg, stg = sg.decode(pg, stg, nxt.cuda())
    worst = max(worst, (lg.cpu() - lc).abs().max().item())
    check(int(stc["pos"].max()) > 2 * cfg.window, "decode did not pass the "
          "window")
    check(worst <= 1e-3, f"card vs CPU logits differ by {worst}")
    print(f"  recurrentgemma reduced (d 256, head_dim 64, window 16) f32, "
          f"prefill + 24 decode steps to pos {int(stc['pos'].max())}: card "
          f"vs CPU logits max abs err {worst:.3e} (tol 1e-3)", flush=True)


def bits_equal(torch, a, b):
    """Bitwise equality of two tensors, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


def trees_bits_equal(torch, a, b, keys):
    from repro_torch.train.tree import tree_paths
    pa = {k: v for k, v in tree_paths(a).items() if k.startswith(keys)}
    pb = {k: v for k, v in tree_paths(b).items() if k.startswith(keys)}
    return list(pa) == list(pb) and all(bits_equal(torch, pa[k], pb[k])
                                        for k in pa)


def poison_pod(torch, d_state, pod):
    """d_state with pod `pod`'s replica all NaN (a new tree)."""
    from repro_torch.train.tree import tree_map

    def one(x):
        x = x.clone()
        x[pod] = float("nan")
        return x
    return {**d_state, "pod_params": tree_map(one, d_state["pod_params"])}


def diloco_phase(torch):
    """DiLoCo at the demo LM's published widths under the DiLoCoSupervisor:
    2 pods, H 8, int8 EF compression, constellation masks, 4 rounds with
    a whole-round rollback forced at round 3 and a snapshot every 2
    rounds.  Returns B3's launches over that run."""
    import numpy as np

    from repro_torch.core.isl import ConstellationLinkModel, LivenessConfig
    from repro_torch.distributed.compression import ef_wire_roundtrip
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import registry
    from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                                   DiLoCoSupervisor, FTConfig, SyntheticLM,
                                   TrainConfig, diloco_init,
                                   make_diloco_round, make_inner_steps,
                                   outer_step, outer_wire_bytes,
                                   pod_step_grid, save_replicated_async)
    from repro_torch.train.checkpoint import host_copy
    from repro_torch.train.fault_tolerance import drain
    from repro_torch.train.tree import tree_leaves, tree_map, tree_paths
    dev = torch.device("cuda")
    cfg = registry.get_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    n_pods, h, seq, batch, n_rounds = 2, 8, 1024, 8, 4
    tokens = n_pods * h * seq * batch
    dcfg = DiLoCoConfig(n_pods=n_pods, inner_steps=h)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                       total_steps=n_rounds * h)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0), dev)
    params = fns.init(torch.Generator().manual_seed(0), cfg, dev)
    window = FTConfig(checkpoint_dirs=()).gnorm_window
    rnd = make_diloco_round(cfg, fns, tcfg, dcfg, compress="int8",
                            data=data, screen_window=window, supervise=True)
    d0 = diloco_init(params, dcfg, compress="int8", screen_window=window)
    state_gb = sum(x.numel() * x.element_size()
                   for x in tree_leaves(d0)) / 1e9
    wire = outer_wire_bytes(params, "int8")
    live_cfg = LivenessConfig(n_pods=n_pods, outer_wire_bytes=wire)
    calls = []

    def watched(d, grid, mask, thr):
        calls.append((grid, mask))
        return rnd(d, grid, mask, thr)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = (os.path.join(tmp, "a"), os.path.join(tmp, "b"))
        ft = FTConfig(checkpoint_dirs=dirs, checkpoint_every=2 * h, keep=1)
        flash_attention.launches = 0
        t0 = time.perf_counter()
        sup = DiLoCoSupervisor(watched, d0, dcfg, ft,
                               liveness=ConstellationLinkModel(cfg=live_cfg))
        sup.run(n_rounds, forced_rollback_at=[3])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated() / 2**20
        st, losses = sup.stats, sup.mean_losses
        print(f"  DiLoCo run: {n_pods} pods x H {h}, {len(calls)} rounds run "
              f"for {n_rounds} kept, {len(calls) * tokens} tokens in "
              f"{dt:.3f} s ({st['checkpoints'] // len(dirs)} snapshots of "
              f"{state_gb:.3f} GB to {len(dirs)} replicas included) | B3 "
              f"launches {launches} | peak {peak:.1f} MiB",
              flush=True)
        print(f"    stats {st}", flush=True)
        print(f"    mean pod loss per round "
              f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
        check(len(losses) == n_rounds and all(np.isfinite(losses)),
              f"DiLoCo losses not finite: {losses}")
        check(losses[-1] < losses[0],
              f"DiLoCo loss did not fall ({losses[0]} -> {losses[-1]})")
        check(st["rollbacks"] == 1 and st["replay_verified_rounds"] >= 1
              and st["replay_mismatches"] == 0,
              f"rollback replay not verified: {st}")
        check(st["drains"] == len(calls) == 6,
              f"{st['drains']} host drains for {len(calls)} rounds run, "
              f"want one each (6)")
        check(launches == 2 * cfg.n_layers * len(calls) * n_pods * h,
              f"B3 launched {launches} times, want 24 x {len(calls)} rounds "
              f"x {n_pods} pods x {h} steps")
        fresh = ConstellationLinkModel(cfg=live_cfg)
        for grid, mask in calls:
            r = int(grid[0, 0]) // h
            check(mask.cpu().numpy().tobytes()
                  == fresh.mask_at(r)[0].tobytes(),
                  f"round {r}: the pod mask used differs from mask_at")
        print(f"  one host drain per round run; B3 launched 24 per inner "
              f"step; replay verified bitwise; masks used == mask_at on the "
              f"CPU ({[m.tolist() for _, m in calls]})", flush=True)

        # one snapshot by itself: device to host, then the replicated
        # background write the supervisor starts, joined
        base = sup.d_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = host_copy(base)
        t1 = time.perf_counter()
        for t in save_replicated_async(snap, dirs, 10**6, keep=1,
                                       copy=False):
            t.join()
        t2 = time.perf_counter()
        del snap
        print(f"  one snapshot of {state_gb:.3f} GB: device to host "
              f"{t1 - t0:.3f} s, replicated write (2 replicas, parallel) "
              f"{t2 - t1:.3f} s", flush=True)

    # EF invariant at every full-width leaf: sent + residual == delta + ef
    g = torch.Generator(device=dev).manual_seed(3)
    for method in ("int8", "topk"):
        for name, e in tree_paths(base["pod_ef"]).items():
            delta = 1e-3 * torch.randn(e.shape, generator=g, device=dev)
            counts = (n_pods,) + (1,) * (e.dim() - 1)
            _, sent, resid = ef_wire_roundtrip(delta, e, counts, method)
            check(torch.equal(sent + resid, delta + e),
                  f"{method} {name}: sent + residual != delta + ef")
    print(f"  sent + residual == delta + ef bitwise at every leaf (int8, "
          f"top-k), EF from the run", flush=True)

    # a NaN-poisoned pod: the supervised round == the plain round with
    # that pod masked by hand == make_inner_steps + outer_step
    grid = torch.as_tensor(pod_step_grid(n_rounds, n_pods, h), device=dev)
    ones = torch.ones(n_pods, device=dev)
    hand = torch.tensor([1.0, 0.0], device=dev)
    thr = torch.tensor([3.0, 10.0], device=dev)
    got, metrics = rnd(poison_pod(torch, base, 1), grid, ones, thr)
    metrics = drain(metrics)
    check(metrics["pod_bad"].tolist() == [False, True]
          and bool(metrics["outer_ok"]),
          f"poisoned pod: pod_bad {metrics['pod_bad']}, outer_ok "
          f"{metrics['outer_ok']}")
    plain = make_diloco_round(cfg, fns, tcfg, dcfg, compress="int8",
                              data=data, screen_window=window)
    ref, _ = plain(poison_pod(torch, base, 1), grid, hand, thr)
    check(trees_bits_equal(torch, got, ref, ("global_params", "outer_m",
                                             "pod_params")),
          "supervised poisoned round != plain round with a hand mask")
    del got
    inner = make_inner_steps(cfg, fns, tcfg, dcfg)
    mid, _ = inner(poison_pod(torch, base, 1), data.batch_block(grid))
    io = outer_step(mid, dcfg, pod_mask=hand, compress="int8")
    del mid
    check(trees_bits_equal(torch, io, ref, ("global_params", "outer_m",
                                            "pod_params", "pod_opt",
                                            "pod_ef", "step")),
          "make_diloco_round != make_inner_steps + outer_step")
    del io, ref
    print("  poisoned pod: pod_bad [False, True], outer_ok; supervised "
          "round == plain round with a hand mask == make_inner_steps + "
          "outer_step, bitwise", flush=True)

    # round wall time, then one round under the profiler
    def one_round():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rnd(base, grid, ones, thr)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    wall = one_round()
    print(f"  one round ({n_pods} pods x {h} steps, int8, screens, no "
          f"snapshot): {wall:.3f} s = {tokens / wall:.1f} tok/s "
          f"({tokens} tokens)", flush=True)
    profile_window(torch, "one DiLoCo round", one_round,
                   watch=("flash_fwd_tc",))

    # the outer sync by itself, on pod replicas moved off the globals
    moved = {**base, "pod_params": tree_map(
        lambda x: x + 1e-3 * torch.randn(x.shape, generator=g, device=dev),
        base["pod_params"])}
    for method in (None, "int8", "topk"):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        outer_step(moved, dcfg, pod_mask=ones, compress=method)
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(3):
            outer_step(moved, dcfg, pod_mask=ones, compress=method)
        ev[1].record()
        torch.cuda.synchronize()
        print(f"  outer sync ({method or 'none'}): "
              f"{ev[0].elapsed_time(ev[1]) / 3:.3f} ms of device time "
              f"(mean of 3; wire {outer_wire_bytes(params, method) / 1e6:.2f}"
              f" MB per pod)", flush=True)
    return launches


def coserve_phase(torch):
    """run_coserve at the demo LM's published widths: DiLoCo rounds (2
    pods, H 4, 3 rounds, a rollback forced at round 1) beside an engine
    of 8 slots serving 16 greedy requests from published params.  Returns
    (B3 launches, B1 launches) over that run."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.coserve import run_coserve
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                                   DiLoCoSupervisor, FTConfig,
                                   ParamPublisher, PublishConfig,
                                   SyntheticLM, TrainConfig, diloco_init,
                                   make_diloco_round, snapshot_global_params)
    dev = torch.device("cuda")
    cfg = registry.get_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    n_pods, h, seq, batch, n_rounds, max_new = 2, 4, 1024, 8, 3, 32
    dcfg = DiLoCoConfig(n_pods=n_pods, inner_steps=h)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                       total_steps=n_rounds * h)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0), dev)
    window = FTConfig(checkpoint_dirs=()).gnorm_window
    d_state = diloco_init(fns.init(torch.Generator().manual_seed(0), cfg,
                                   dev), dcfg, screen_window=window)
    rnd = make_diloco_round(cfg, fns, tcfg, dcfg, data=data,
                            screen_window=window, supervise=True)
    ecfg = EngineConfig(max_batch=8, max_len=512, decode_block=8)
    snap0 = snapshot_global_params(d_state)
    eng = ServingEngine(cfg, fns, snap0, ecfg)
    versions = {0: snap0}

    def sink(p):
        versions[eng.swap_params(p)] = p
    pub = ParamPublisher(sink, PublishConfig(publish_every=1,
                                             holdback_rounds=1))
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(4, 201))).astype(np.int32),
        max_new_tokens=max_new) for i in range(16)]
    prompts = {r.uid: r.prompt for r in reqs}
    with tempfile.TemporaryDirectory() as tmp:
        ft = FTConfig(checkpoint_dirs=(os.path.join(tmp, "a"),
                                       os.path.join(tmp, "b")),
                      checkpoint_every=2 * h, keep=1)
        sup = DiLoCoSupervisor(rnd, d_state, dcfg, ft, publisher=pub)
        decode_attention.launches = 0
        flash_attention.launches = 0
        t0 = time.perf_counter()
        # one decode block per drained round: the first requests are
        # still in flight when the first publication is staged, so the
        # swap waits for them and later requests decode on newer params
        done = run_coserve(sup, eng, reqs, n_rounds, forced_rollback_at=[1],
                           blocks_per_round=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        b1, b3 = decode_attention.launches, flash_attention.launches
    s, ps = eng.stats, pub.stats
    used = sorted({r._params_version for r in done})
    print(f"  co-resident: {len(sup.history)} rounds kept "
          f"({sup.stats['drains']} run) x {n_pods} pods x H {h} + "
          f"{len(done)} requests ({s['tokens']} tokens) in {dt:.3f} s | "
          f"{s['tokens'] / dt:.1f} tok/s served | swaps {s['swaps']} | "
          f"publish {ps} | published round {pub.published_round} <= "
          f"verified {sup.verified_round} | versions served {used} | "
          f"launches B1 {b1} B3 {b3}", flush=True)
    check(len(done) == 16 and all(r.done and len(r.generated) == max_new
                                  for r in done),
          "co-serve: not every request completed")
    check(pub.published_round <= sup.verified_round,
          "a round was published past the verification watermark")
    check(s["swaps"] >= 1 and ps["dropped_rollback"] >= 1,
          f"co-serve: swaps {s['swaps']}, dropped {ps['dropped_rollback']}")
    check(b1 > 0, "B1 never launched while co-serving")
    check(len(used) >= 2, f"every request decoded on one version {used}")
    check(b3 == 2 * cfg.n_layers * sup.stats["drains"] * n_pods * h,
          f"B3 launched {b3} times, want 24 per inner step run")
    for r in done:
        alone = ServingEngine(cfg, fns, versions[r._params_version], ecfg)
        alone.submit(Request(uid=r.uid, prompt=prompts[r.uid],
                             max_new_tokens=max_new))
        check(alone.run()[0].generated == r.generated,
              f"request {r.uid}: tokens differ from a fresh engine serving "
              f"version {r._params_version} alone")
    print(f"  every request's tokens == a fresh engine serving, alone, the "
          f"version it was admitted under (versions {used})", flush=True)
    return b3, b1


def diloco_reference(torch):
    """The micro DiLoCo config (2 layers, d 32, head_dim 64, vocab 256,
    seq 8, batch 2; 2 pods, H 4, int8), f32: 2 supervised rounds on the
    card against the same rounds on the CPU."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.train import (DataConfig, DiLoCoConfig, SyntheticLM,
                                   TrainConfig, diloco_init,
                                   make_diloco_round, pod_step_grid)
    from repro_torch.train.tree import tree_map, tree_paths
    cfg = registry.get_reduced_config(
        "suncatcher-lm-100m", compute_dtype="float32", head_dim=64,
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
        vocab_size=256)
    fns = registry.model_fns(cfg)
    dcfg = DiLoCoConfig(n_pods=2, inner_steps=4)
    cpu = fns.init(torch.Generator().manual_seed(1), cfg, "cpu")
    out = {}
    for d in ("cpu", "cuda"):
        data = SyntheticLM(DataConfig(vocab_size=256, seq_len=8,
                                      global_batch=2), d)
        rnd = make_diloco_round(cfg, fns, TrainConfig(warmup_steps=2,
                                                      total_steps=100),
                                dcfg, compress="int8", data=data,
                                screen_window=16, supervise=True)
        st = diloco_init(tree_map(lambda x: x.to(d), cpu), dcfg,
                         compress="int8", screen_window=16)
        losses = []
        for r in range(2):
            st, m = rnd(st, torch.as_tensor(pod_step_grid(r, 2, 4),
                                            device=d),
                        torch.ones(2, device=d),
                        torch.tensor([3.0, 10.0], device=d))
            losses.append(m["loss"].cpu())
        out[d] = torch.stack(losses), tree_paths(st["global_params"])
    lerr = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    perr = max((v.cpu() - out["cpu"][1][k]).abs().max().item()
               for k, v in out["cuda"][1].items())
    check(lerr <= 1e-3 and perr <= 1e-3 and np.isfinite(perr),
          f"DiLoCo card vs CPU: losses {lerr}, global params {perr}")
    print(f"  micro DiLoCo f32 (int8, 2 rounds): card vs CPU losses max "
          f"abs err {lerr:.3e}, global params {perr:.3e} (tol 1e-3)",
          flush=True)


PLANE_SCHEDULE = "2:1:3,10:1:3,6:0:2,6:2:2"


def plane_prompts(np, vocab, n_req, seed):
    """Phase 3's prompt mix: 4-200 tokens, half behind one of two shared
    32/48-token heads.  The lengths come from a generator of their own,
    so a plane schedules the same way at any vocab."""
    lens = np.random.default_rng(seed).integers(4, 153, n_req)
    rng = np.random.default_rng(seed + 1)
    heads = [rng.integers(0, vocab, n).astype(np.int32) for n in (32, 48)]
    out = []
    for i, n in enumerate(lens):
        tail = rng.integers(0, vocab, int(n)).astype(np.int32)
        out.append(np.concatenate([heads[i % 2], tail]) if i % 4 < 2
                   else tail)
    return out


def context_params(torch, fns, cfg, dev, seed=0, scale=0.1):
    """Random params from a seed, drawn on `dev`'s own generator, with the
    tied embedding scaled by 0.1: at the init scale the embedding
    dominates the residual stream and a random model repeats its input
    token, so its tokens would not show a corrupted migration; scaled,
    every token depends on the context."""
    params = fns.init(torch.Generator(dev).manual_seed(seed), cfg, dev)
    params["embed"].mul_(scale)
    return params


def outage_contract(plane, done, n_req, **expect):
    """The launchers' zero-drop outage contract, as a check."""
    from repro_torch.serving import check_forced_outage_contract
    try:
        check_forced_outage_contract(plane, done, n_req, **expect)
    except SystemExit as err:
        fail(f"outage contract: {err}")


def drive_plane(plane, reqs, per_tick):
    """Submit `per_tick` requests before each router tick until all are
    in, then run the plane dry; returns the finished requests."""
    pending = list(reqs)
    steps = 0
    while pending or plane.queue or any(e.queue for e in plane.engines) \
            or any(s is not None for s in plane.slots):
        for r in pending[:per_tick]:
            plane.submit(r)
        del pending[:per_tick]
        plane.step()
        steps += 1
        check(steps < 10_000, "the plane did not drain")
    return plane.finished


def spy_moves(plane):
    """Record (request arch, destination arch, pointer flip) of every
    session the router moves."""
    moves = []
    relocate = plane._relocate

    def spy(sess, dst, dslot, *, flip, failover=True):
        moves.append((sess.req.arch or plane.engines[0].model_cfg.name,
                      plane.engines[dst].model_cfg.name, flip))
        return relocate(sess, dst, dslot, flip=flip, failover=failover)
    plane._relocate = spy
    return moves


def row_bytes(cache, batch):
    """Bytes of one slot row of a dense state tree (the wire format)."""
    from repro_torch.models.decode_state import _leaves
    return sum(x.numel() // batch * x.element_size() for x in _leaves(cache))


def plane_phase(torch):
    """The demo LM's serving plane at full width (phase 11): 3 pods of 16
    slots behind a ConstellationRouter, 48 requests arriving 4 a tick,
    under a chaos schedule; dense, paged and full-drain.  Returns (B1
    launches over the dense and full-drain planes, B2 launches over the
    paged plane)."""
    import numpy as np

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)
    from repro_torch.models import registry
    from repro_torch.serving import (ConstellationRouter, EngineConfig,
                                     GridConfig, Request, ServingEngine,
                                     parse_outage_spec)
    dev = torch.device("cuda")
    cfg = registry.get_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    params = context_params(torch, fns, cfg, dev)
    pods, slots, max_len, block, n_req, max_new = 3, 16, 512, 8, 48, 32
    prompts = plane_prompts(np, cfg.vocab_size, n_req, 0)
    check(min(map(len, prompts)) >= 4 and max(map(len, prompts)) <= 200,
          "prompt lengths outside 4-200")

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=max_new,
                        temperature=0.0 if i % 2 == 0 else 0.7)
                for i, p in enumerate(prompts)]

    def ecfg(page_size):
        return EngineConfig(
            max_batch=slots, max_len=max_len, decode_block=block,
            page_size=page_size,
            pool_pages=slots * max_len // 16 // 2 if page_size else None,
            prefix_cache=8 if page_size else 0)

    # the streams every plane must give: one engine serving them alone
    alone = ServingEngine(cfg, fns, params, ecfg(0))
    for r in reqs():
        alone.submit(r)
    want = {r.uid: r.generated for r in alone.run()}
    del alone
    check(len(want) == n_req and all(len(v) == max_new
                                     for v in want.values()),
          "the single engine did not complete every request")
    distinct = sorted(len(set(v)) for v in want.values())
    print(f"  one engine alone: {n_req} requests x {max_new} tokens; "
          f"distinct tokens per stream {distinct[0]}-{distinct[-1]} "
          f"(median {distinct[len(distinct) // 2]})", flush=True)

    def run_plane(page_size, replicate, label, n=n_req):
        """One plane run of the first `n` requests, with every check;
        returns (wall s, launches)."""
        engines = [ServingEngine(cfg, fns, params, ecfg(page_size))
                   for _ in range(pods)]
        plane = ConstellationRouter(
            engines, forced_outage=parse_outage_spec(PLANE_SCHEDULE),
            grid=GridConfig(replicate=replicate))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode_attention.launches = 0
        paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        done = drive_plane(plane, reqs()[:n], per_tick=4)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = (decode_attention.launches, paged_decode_attention.launches)
        s = plane.plane_stats()
        e = s["engines"]
        outage_contract(plane, done, n, expect_pointer_flip=replicate,
                        expect_rebalance=True)
        check(all(len(r.generated) == max_new for r in done),
              f"{label} plane: a request stopped short")
        bad = [r.uid for r in done if r.generated != want[r.uid]]
        check(not bad, f"{label} plane: requests {bad[:8]} differ from one "
              f"engine serving them alone")
        sub = e["decode_blocks"] * block
        need = ((0, cfg.n_layers * sub) if page_size
                else (cfg.n_layers * sub, 0))
        check(got == need, f"{label} plane: launches (B1, B2) {got} != "
              f"{need} (n_layers x {sub} sub-steps)")
        full_b, per_pos_b, carry_b = engines[0].spec.row_wire_bytes(max_len)
        if page_size == 0:
            check(full_b == row_bytes(engines[0].cache, slots),
                  f"row_wire_bytes {full_b} != the bytes of one row the "
                  f"engine holds {row_bytes(engines[0].cache, slots)}")
        if replicate:
            n_syncs = s["full_bytes_equiv"] // full_b
            check(s["replicated_bytes"] == carry_b * n_syncs
                  + per_pos_b * s["replicated_rows"] > 0,
                  f"{label} plane: replicated bytes {s['replicated_bytes']}"
                  f" != the row_wire_bytes prediction")
        else:
            check(e["standby_syncs"] == 0 and s["replicated_bytes"] == 0,
                  "the full-drain plane replicated")
        stalls = sorted(plane.failover_stalls)
        extra = ""
        if page_size:
            ps = [x.page_stats() for x in engines]
            check(all(p["device_live"] == p["pool_pages"] - p["host_free"]
                      for p in ps), "paged plane: pages leaked")
            extra = (f" | pool {ps[0]['pool_pages']} pages per pod, "
                     f"{e['admission_stalls']} admission stalls, "
                     f"{e['prefix_hits']} prefix hits")
        print(f"  {label} plane ({pods} pods x {slots} slots, {n} "
              f"requests, '{PLANE_SCHEDULE}'): {e['tokens']} tokens in "
              f"{dt:.3f} s = "
              f"{e['tokens'] / dt:.1f} tok/s | {s['pointer_flips']} pointer "
              f"flips + {s['full_migrations']} full drains "
              f"({s['migrated_slots']} failed over), "
              f"{s['deferred_slot_migrations']} deferrals, "
              f"{s['rebalanced_slots']} rebalanced, {s['rejoins']} rejoins | "
              f"failover stalls {len(stalls)}: p50 "
              f"{stalls[len(stalls) // 2] * 1e3 if stalls else 0:.2f} ms, "
              f"max {stalls[-1] * 1e3 if stalls else 0:.2f} ms | "
              f"{e['standby_syncs']} standby syncs, "
              f"{s['replicated_bytes']} bytes replicated "
              f"({s['full_bytes_equiv']} as whole rows) | launches B1 "
              f"{got[0]} B2 {got[1]} | peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
              + extra, flush=True)
        return dt, got

    launches = {}
    for page_size, replicate, label in ((0, True, "dense"),
                                        (16, True, "paged"),
                                        (0, False, "full-drain")):
        launches[label] = run_plane(page_size, replicate, label)[1]
    # a shorter run under the profiler (its trace takes the host ~15 s
    # per second of wall to process): 12 requests, ticks 0-5
    profile_window(torch, "dense plane, 12 requests",
                   lambda: run_plane(0, True, "dense (profiled)", n=12)[0],
                   watch=("decode_split_kernel", "decode_merge_kernel",
                          "nvjet", "index", "gather"))
    print("  dense, paged and full-drain planes == one engine alone, every "
          "request bitwise; zero drops", flush=True)
    return (launches["dense"][0] + launches["full-drain"][0],
            launches["paged"][1])


def mixed_plane_phase(torch):
    """A mixed plane at full width (phase 12): suncatcher-lm-100m and
    recurrentgemma-2b, 2 pods of 8 slots each, 16 requests round-robin
    over the arch groups, the busiest pod struck at tick 2.  Returns the
    launches (B1 at dh 64, B1 at dh 256, B4) of the plane's run, B1's
    counted per arch around each engine's step."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    from repro_torch.models import registry
    from repro_torch.serving import (ConstellationRouter, EngineConfig,
                                     Request, ServingEngine,
                                     parse_outage_spec)
    from repro_torch.train.tree import tree_map
    dev = torch.device("cuda")
    lm_cfg = registry.get_config("suncatcher-lm-100m")
    rg_cfg = registry.get_config("recurrentgemma-2b")
    lm_fns, rg_fns = registry.model_fns(lm_cfg), registry.model_fns(rg_cfg)
    lm = context_params(torch, lm_fns, lm_cfg, dev)
    t0 = time.perf_counter()
    # the cast head is embed.T, so it carries the embedding's scale
    rg_params = rg_fns.cast_params(context_params(torch, rg_fns, rg_cfg, dev),
                                   rg_cfg)
    torch.cuda.synchronize()
    print(f"  recurrentgemma-2b params from seed 0 drawn on the card, cast "
          f"to bf16: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pods, slots, max_len, block, n_req, max_new = 2, 8, 512, 8, 16, 32
    ecfg = EngineConfig(max_batch=slots, max_len=max_len, decode_block=block)
    n_rec = 2 * rg_cfg.n_groups + rg_cfg.n_tail_rec
    builds = {lm_cfg.name: (lm_cfg, lm_fns), rg_cfg.name: (rg_cfg, rg_fns)}
    # each pod holds its own copy of its arch's params
    copies = {lm_cfg.name: [lm] + [tree_map(torch.clone, lm)
                                   for _ in range(pods - 1)],
              rg_cfg.name: [rg_params] + [tree_map(torch.clone, rg_params)
                                          for _ in range(pods - 1)]}
    torch.cuda.synchronize()
    print(f"  params on the card: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated ({pods} pods per arch, a copy each)", flush=True)
    order = (rg_cfg.name, lm_cfg.name)
    engines = [ServingEngine(*builds[a], copies[a][i], ecfg)
               for a in order for i in range(pods)]
    plane = ConstellationRouter(engines,
                                forced_outage=parse_outage_spec("2:*:3"))
    moves = spy_moves(plane)
    prefills = []
    b1_arch = dict.fromkeys(order, 0)   # B1 launches inside each arch's steps
    for e in engines:
        def counted_step(_step=e.step, _arch=e.model_cfg.name):
            n0 = decode_attention.launches
            out = _step()
            b1_arch[_arch] += decode_attention.launches - n0
            return out
        e.step = counted_step
        if e.model_cfg is rg_cfg:
            fill = e.spec.prefill

            def counted(*a, _fill=fill, **k):
                prefills.append(1)
                return _fill(*a, **k)
            e.spec.prefill = counted
    lens = np.random.default_rng(2).integers(4, 201, n_req)
    reqs = []
    for i, n in enumerate(lens):
        arch = order[i % 2]
        reqs.append(Request(
            uid=i, prompt=np.random.default_rng(100 + i).integers(
                0, builds[arch][0].vocab_size, int(n)).astype(np.int32),
            max_new_tokens=max_new,
            temperature=0.0 if (i // 2) % 2 == 0 else 0.7, arch=arch))
    for r in reqs:
        plane.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attention.launches = 0
    rglru_scan_fwd.launches = 0
    b1_arch.update(dict.fromkeys(order, 0))
    t0 = time.perf_counter()
    done = plane.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    b1, b4 = decode_attention.launches, rglru_scan_fwd.launches
    s = plane.plane_stats()
    outage_contract(plane, done, n_req, expect_pointer_flip=True)
    check(all(len(r.generated) == max_new for r in done),
          "mixed plane: a request stopped short")
    check(all(a == b for a, b, _ in moves),
          f"a session moved between arch groups: {moves}")
    carry_flips = sum(flip for a, _, flip in moves if a == rg_cfg.name)
    check(carry_flips >= 1, f"no pointer flip in the carry group: {moves}")
    blocks = {a: sum(e.stats["decode_blocks"] for e in engines
                     if e.model_cfg.name == a) for a in order}
    b1_lm, b1_rg = b1_arch[lm_cfg.name], b1_arch[rg_cfg.name]
    need = (lm_cfg.n_layers * block * blocks[lm_cfg.name],
            rg_cfg.n_groups * block * blocks[rg_cfg.name])
    check(b1 == b1_lm + b1_rg,
          f"mixed plane: {b1 - b1_lm - b1_rg} B1 launches outside the "
          f"engines' steps")
    check((b1_lm, b1_rg) == need and b4 == n_rec * len(prefills),
          f"mixed plane: launches B1 dh 64 {b1_lm}, dh 256 {b1_rg} != "
          f"{need} (layers x {block} x decode blocks) or B4 {b4} != "
          f"{n_rec} x {len(prefills)} prefill calls")
    print(f"  mixed plane ({pods} + {pods} pods x {slots} slots, '2:*:3'): "
          f"{s['engines']['tokens']} tokens in {dt:.3f} s = "
          f"{s['engines']['tokens'] / dt:.1f} tok/s | {s['pointer_flips']} "
          f"pointer flips ({carry_flips} in the carry group) + "
          f"{s['full_migrations']} full drains, {len(moves)} moves, none "
          f"across groups | {s['engines']['standby_syncs']} standby syncs, "
          f"{s['replicated_bytes']} bytes replicated | launches B1 dh 64 "
          f"{b1_lm}, B1 dh 256 {b1_rg}, B4 {b4} ({len(prefills)} prefill "
          f"calls) | peak {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB", flush=True)
    for a in order:
        cfg, fns = builds[a]
        alone = ServingEngine(cfg, fns, copies[a][0], ecfg)
        mine = [r for r in done if r.arch == a]
        for r in mine:
            one = Request(uid=r.uid, prompt=r.prompt,
                          max_new_tokens=max_new, temperature=r.temperature)
            one._seq = r._seq
            alone.submit(one)
        want = {r.uid: r.generated for r in alone.run()}
        bad = [r.uid for r in mine if r.generated != want[r.uid]]
        check(not bad, f"mixed plane: {a} requests {bad} differ from one "
              f"engine serving them alone")
    print("  every request == its arch's engine serving it alone, bitwise",
          flush=True)
    return b1_lm, b1_rg, b4


def plane_reference(torch):
    """A micro mixed plane (phase 13): the reduced demo LM (head_dim 64)
    paged and recurrentgemma reduced at d_model 256, f32, 2 + 2 pods,
    chaos; on the card and on the CPU: tokens and every plane counter
    equal."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.serving import (ConstellationRouter, EngineConfig,
                                     Request, ServingEngine,
                                     parse_outage_spec)
    from repro_torch.train.tree import tree_map
    cfgs = (registry.get_reduced_config("suncatcher-lm-100m",
                                        compute_dtype="float32", head_dim=64),
            registry.get_reduced_config("recurrentgemma-2b", d_model=256,
                                        compute_dtype="float32"))
    cpu = [registry.model_fns(c).init(torch.Generator().manual_seed(1), c,
                                      "cpu") for c in cfgs]
    devices = ("cpu", "cuda")
    out = {}
    for d in devices:
        engines = []
        for cfg, p, page in zip(cfgs, cpu, (16, 0)):
            ecfg = EngineConfig(max_batch=3, max_len=64, decode_block=4,
                                page_size=page)
            engines += [ServingEngine(cfg, registry.model_fns(cfg),
                                      tree_map(lambda x: x.to(d), p), ecfg)
                        for _ in range(2)]
        plane = ConstellationRouter(
            engines, forced_outage=parse_outage_spec("2:*:3,6:2:2"))
        rng = np.random.default_rng(5)
        for i in range(10):
            cfg = cfgs[i % 2]
            plane.submit(Request(
                uid=i, prompt=rng.integers(0, cfg.vocab_size, int(
                    rng.integers(3, 30))).astype(np.int32),
                max_new_tokens=20, temperature=0.0 if i % 4 < 2 else 0.8,
                arch=cfg.name))
        done = plane.run()
        out[d] = {r.uid: r.generated for r in done}, plane.plane_stats()
    (tc, sc), (tg, sg) = (out[d] for d in devices)
    check(len(tc) == 10 and sc["migrated_slots"] >= 1,
          f"micro plane: {len(tc)} requests done, "
          f"{sc['migrated_slots']} slots moved")
    check(tg == tc, "micro plane: card and CPU tokens differ")
    diff = sorted(k for k in sc if sc[k] != sg.get(k))
    check(not diff, f"micro plane: card and CPU counters differ: {diff}")
    print(f"  micro mixed plane f32 (paged LM + RG-LRU, '2:*:3,6:2:2'): "
          f"card == CPU tokens and every plane_stats() counter "
          f"({sc['pointer_flips']} flips, {sc['full_migrations']} drains, "
          f"{sc['rebalanced_slots']} rebalanced)", flush=True)


def plane_paths(torch):
    """Phases 11-13.  Returns (B1 dh-64 launches, B2 launches, B1 dh-256
    launches, B4 launches) over the planes' runs."""
    phase("phase 11: serving plane, suncatcher-lm-100m (full width, bf16, "
          "3 pods, chaos)")
    b1, b2 = plane_phase(torch)
    torch.cuda.empty_cache()
    phase("phase 12: mixed serving plane, suncatcher-lm-100m + "
          "recurrentgemma-2b (full width, bf16)")
    b1_lm, b1_rg, b4 = mixed_plane_phase(torch)
    torch.cuda.empty_cache()
    phase("phase 13: serving plane reference check")
    plane_reference(torch)
    check(min(b1, b2, b1_lm, b1_rg, b4) > 0,
          "a kernel never launched on the serving planes")
    return b1 + b1_lm, b2, b1_rg, b4


def new_paths(torch):
    """Phases 8-10 under deterministic algorithms (the supervisor verifies
    replayed rounds bitwise).  Returns (B3 launches, B1 launches) on the
    DiLoCo and co-serve paths."""
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        phase("phase 8: DiLoCo suncatcher-lm-100m (full width, bf16, 2 pods "
              "x H 8, int8, constellation)")
        b3 = diloco_phase(torch)
        torch.cuda.empty_cache()
        phase("phase 9: co-resident DiLoCo + serving (full width)")
        b3_co, b1 = coserve_phase(torch)
        torch.cuda.empty_cache()
        phase("phase 10: DiLoCo reference check")
        diloco_reference(torch)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    check(b3 > 0 and b3_co > 0 and b1 > 0,
          "a kernel never launched on the DiLoCo or co-serve path")
    return b3 + b3_co, b1


def _family_requests(Request, prompts, new):
    """Requests of the prompt mix, greedy and T 0.7 alternating."""
    return [Request(uid=i, prompt=p, max_new_tokens=new,
                    temperature=0.0 if i % 2 == 0 else 0.7)
            for i, p in enumerate(prompts)]


def _serve_config(EngineConfig, page_size, block, slots=16, max_len=512):
    """Phase 3's engine: dense, or paged at `page_size` with a pool half
    the dense footprint and a prefix cache of 8."""
    return EngineConfig(
        max_batch=slots, max_len=max_len, decode_block=block,
        page_size=page_size,
        pool_pages=slots * max_len // 16 // 2 if page_size else None,
        prefix_cache=8 if page_size else 0)


def _serve_run(torch, cfg, fns, params, page_size, block, prompts, new,
               tag):
    """One ServingEngine run of `prompts` under `_serve_config`: every
    request completes with `new` tokens, and B1 (dense) or B2 (paged)
    launches n_layers x sub-steps times, decode blocks under sync debug
    mode "error".  Prints tok/s, host syncs per token and peak memory;
    returns ({uid: tokens}, (B1, B2 launches), the run's seconds)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(cfg, fns, params,
                        _serve_config(EngineConfig, page_size, block))
    for r in _family_requests(Request, prompts, new):
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attention.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = (decode_attention.launches, paged_decode_attention.launches)
    s = eng.stats
    check(len(done) == len(prompts) and all(len(r.generated) == new
                                            for r in done),
          f"{tag}: not every request completed (page {page_size}, block "
          f"{block})")
    sub = s["decode_blocks"] * block
    want = (0, cfg.n_layers * sub) if page_size else (cfg.n_layers * sub, 0)
    check(got == want, f"{tag}: kernel launches (B1, B2) {got} != {want} "
          f"(n_layers x {sub} sub-steps)")
    print(f"  {tag} {'paged' if page_size else 'dense'} decode_block "
          f"{block}: {s['tokens']} tokens in {dt:.3f} s = "
          f"{s['tokens'] / dt:.1f} tok/s | "
          f"{s['host_syncs'] / s['tokens']:.4f} host syncs/token | "
          f"{s['decode_blocks']} blocks | launches B1 {got[0]} B2 "
          f"{got[1]} | peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    return {r.uid: r.generated for r in done}, got, dt


def moe_serve_phase(torch):
    """granite-moe-1b-a400m at full width through ServingEngine (phase
    14): the phase 3 workload, dense and paged, decode_block 8 and 1.
    Returns (B1 launches, B2 launches) over its served runs."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.models import registry
    from repro_torch.models.moe import (capacity_of, moe_ffn, router_topk,
                                        slot_table)
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    from repro_torch.train.tree import tree_leaves
    dev = torch.device("cuda")
    cfg = registry.get_config("granite-moe-1b-a400m",
                              n_layers=MOE_SERVE_LAYERS)
    fns = registry.model_fns(cfg)
    t0 = time.perf_counter()
    params = context_params(torch, fns, cfg, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == cfg.param_count(), "param count")
    params = fns.cast_params(params, cfg)     # one bf16 copy for every run
    torch.cuda.synchronize()
    print(f"  {n_params / 1e9:.3f}B params "
          f"({cfg.active_param_count() / 1e9:.3f}B active per token) from "
          f"seed 0, the embedding scaled by 0.1, "
          f"cast to bf16: {time.perf_counter() - t0:.1f} s | "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    slots, max_len, n_req, max_new = 16, 512, 32, 32
    prompts = _rglru_workload(np, cfg.vocab_size, n_req,
                              np.random.default_rng(0))
    check(min(map(len, prompts)) >= 4 and max(map(len, prompts)) <= 200,
          "prompt lengths outside 4-200")

    def run(page_size, block, ps=prompts, new=max_new):
        return _serve_run(torch, cfg, fns, params, page_size, block, ps,
                          new, "serve")

    run(0, 8, prompts[:4], 4)            # warm-up: cuBLAS, allocator
    totals = [0, 0]
    streams = {}
    for page_size in (0, 16):
        for block in (8, 1):
            streams[(page_size, block)], got, _ = run(page_size, block)
            totals[0] += got[0]
            totals[1] += got[1]
        check(streams[(page_size, 1)] == streams[(page_size, 8)],
              f"decode_block 1 != 8 token streams (page {page_size})")
    dense = streams[(0, 8)]
    distinct = sorted(len(set(v)) for v in dense.values())
    apart = sum(streams[(16, 8)][u] != dense[u] for u in dense)
    print(f"  decode_block 1 == 8 token streams, dense and paged (bitwise); "
          f"greedy and T 0.7 alternate; distinct tokens per stream "
          f"{distinct[0]}-{distinct[-1]}", flush=True)
    print(f"  paged vs dense: {apart} of {n_req} streams differ; not "
          f"checked: the reference keeps neither paged == dense nor a "
          f"plane == one engine alone for MoE (every row of a call, "
          f"inactive ones included, shares the experts' capacity)",
          flush=True)

    # inactive rows: one request finished at prefill, one slot never used
    eng = ServingEngine(cfg, fns, params,
                        _serve_config(EngineConfig, 0, 8))
    for uid, new in enumerate((1, 20, 20)):
        eng.submit(Request(uid=uid, prompt=prompts[uid],
                           max_new_tokens=new))
    eng._fill_slots()
    check(eng.slots[0] is None and eng.slots[1] is not None,
          "the one-token request did not finish at prefill")

    def rows(i):
        st = eng.cache
        n = int(st["pos"][i])
        return [st["pos"][i].clone(), st["k"][:, i, :n].clone(),
                st["v"][:, i, :n].clone(), eng.state["last"][i].clone()]
    before = {i: rows(i) for i in (0, slots - 1)}
    eng._decode_block()
    for i, leaves in before.items():
        check(all(torch.equal(a, b) for a, b in zip(rows(i), leaves)),
              f"inactive row {i}'s pos, KV prefix or token changed across "
              f"a decode block")
    print("  a finished row and a never-used row keep pos, token and KV "
          "[0, pos) bitwise across a decode block (their stale writes land "
          "at pos, past kv_len)", flush=True)
    del eng

    # a short window under the profiler: one fill of 16 requests
    prof = profile_window(torch, "granite-moe dense, 16 requests x 16 "
                          "tokens", lambda: run(0, 8, prompts[:16], 16)[2],
                          watch=("decode_split_kernel", "decode_merge_kernel",
                                 "Sort", "sort", "gather", "index"))

    if prof:
        hit = {n: prof[n][0] for n in ("Sort", "sort", "gather", "index")}
        print(f"  profiled window's device time: sort kernels "
              f"{(hit['Sort'] + hit['sort']) / prof['busy']:.1%}, gather "
              f"kernels {hit['gather'] / prof['busy']:.1%}, index kernels "
              f"{hit['index'] / prof['busy']:.1%} (the MoE dispatch's, the "
              f"KV writes' and the sampler's); prefill included",
              flush=True)

    # one decode call and one layer's MoE FFN at the decode shape (B = T
    # = 16), by the kernels' device time: the whole FFN, its dispatch
    # (router, sort, slot table) and its expert products
    lp = {k: v[0] for k, v in params["layers"].items()}
    mp = {"router": lp["router"], "wi_gate": lp["moe_wi_gate"],
          "wi_up": lp["moe_wi_up"], "wo": lp["moe_wo"]}
    g = torch.Generator().manual_seed(3)
    x = torch.randn(slots, cfg.d_model, generator=g).to(dev, cfg.cdtype)
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity_of(slots, e, k, cfg.capacity_factor)
    xe = torch.randn(e, cap, cfg.d_model, generator=g).to(dev, cfg.cdtype)

    def dispatch():
        w, ix = router_topk(x, mp["router"], k)
        return slot_table(ix, w, slots, e, cap, x.dtype)

    def experts():
        h = F.silu(torch.bmm(xe, mp["wi_gate"])) * torch.bmm(xe, mp["wi_up"])
        return torch.bmm(h, mp["wo"])
    cache = fns.init_cache(cfg, slots, max_len, device=dev)
    cache["pos"] = torch.full((slots,), 200, dtype=torch.int32, device=dev)
    last = torch.tensor(np.stack([p[:1] for p in prompts[:slots]]),
                        device=dev)
    step_ms = kernel_ms(torch, lambda: fns.decode_step(params, cache, last,
                                                       cfg))
    parts = {"FFN": lambda: moe_ffn(x, mp, num_experts=e, top_k=k,
                                    capacity_factor=cfg.capacity_factor),
             "dispatch (router, sort, slot table)": dispatch,
             "expert bmm": experts}
    n = cfg.n_layers
    line = (f"  one decode call (B 16, kv_len 201): "
            f"{step_ms * 1e3:.1f} us of kernel time" if step_ms else
            "  one decode call: kernel time not measured (no device time "
            "recorded)")
    line += f"; one layer's MoE at T {slots} (capacity {cap}):"
    for name, fn in parts.items():
        ms = kernel_ms(torch, fn)
        if ms is None:
            line += f" {name} not measured,"
            continue
        line += f" {name} {ms * 1e3:.2f} us"
        if step_ms:
            line += f" (x {n} layers = {n * ms / step_ms:.1%} of the call)"
        line += ","
    print(line.rstrip(",") + "; sums of kernel device time under "
          "torch.profiler", flush=True)

    # full-width logits from one decode call: finite, of the right shape
    cache = fns.init_cache(cfg, 2, 64, device=dev)
    logits, _ = fns.decode_step(params, cache, torch.tensor(
        np.stack([prompts[0][:4], prompts[1][:4]]), device=dev), cfg)
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "full-width logits")
    return tuple(totals)


# Depth cuts of earlier phases that make room for phases 21-22 under the
# script's time limit (their times at full depth: PERF.md).  Phase 15
# serves xlstm-350m at 2 of its 12 sLSTM/mLSTM pairs: its prefill runs
# the decode cell per position, ~25 ms of host a cell at all 12 pairs, so
# the phase took 101.5-146.3 s at full depth.  Phase 14 serves
# granite-moe-1b-a400m at 6 of its 24 layers.  Both halved again in slice 11
# to make room for phase 24.
XLSTM_SERVE_LAYERS = 2         # 4 until slice 11 (the run's time)
MOE_SERVE_LAYERS = 6           # 12 until slice 11 (the run's time)


def xlstm_serve_phase(torch):
    """xlstm-350m at its published widths, XLSTM_SERVE_LAYERS of its 24
    layers, through ServingEngine and behind a ConstellationRouter (phase
    15)."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.serving import (ConstellationRouter, EngineConfig,
                                     GridConfig, Request, ServingEngine,
                                     parse_outage_spec)
    from repro_torch.train.tree import tree_leaves
    dev = torch.device("cuda")
    cfg = registry.get_config("xlstm-350m", n_layers=XLSTM_SERVE_LAYERS)
    fns = registry.model_fns(cfg)
    t0 = time.perf_counter()
    params = context_params(torch, fns, cfg, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == cfg.param_count(), "param count")
    params = fns.cast_params(params, cfg)
    torch.cuda.synchronize()
    print(f"  {n_params / 1e9:.3f}B params from seed 0, the embedding "
          f"scaled by 0.1, cast to bf16 (carries f32): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    slots, max_len, n_req, max_new = 16, 512, 32, 32
    prompts = _rglru_workload(np, cfg.vocab_size, n_req,
                              np.random.default_rng(0))

    def run(block, ps, new=max_new, n_slots=slots, label="serve"):
        eng = ServingEngine(cfg, fns, params, EngineConfig(
            max_batch=n_slots, max_len=max_len, decode_block=block))
        calls = []
        prefill = eng.spec.prefill

        def counted(*a, **k):
            calls.append(1)
            return prefill(*a, **k)
        eng.spec.prefill = counted
        for r in _family_requests(Request, ps, new):
            eng.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        s = eng.stats
        check(len(done) == len(ps) and all(len(r.generated) == new
                                           for r in done),
              f"not every request completed (block {block})")
        print(f"  {label} decode_block {block}: {s['tokens']} tokens in "
              f"{dt:.3f} s = {s['tokens'] / dt:.1f} tok/s | "
              f"{s['decode_blocks']} blocks, {len(calls)} prefill calls | "
              f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        return eng, {r.uid: r.generated for r in done}, dt

    run(8, [p[:12] for p in prompts[:2]], 4, label="warm-up")
    streams = {}
    for block in (8, 1):
        eng, streams[block], _ = run(block, prompts)
        del eng
    check(streams[1] == streams[8], "decode_block 1 != 8 token streams")
    distinct = sorted(len(set(v)) for v in streams[8].values())
    print(f"  decode_block 1 == 8 token streams (bitwise), greedy and T 0.7 "
          f"alternating; distinct tokens per stream "
          f"{distinct[0]}-{distinct[-1]}", flush=True)
    short = [p[:12] for p in prompts[:8]]
    profile_window(torch, "xlstm-350m, 8 prompts of 12 tokens x 16 new",
                   lambda: run(8, short, 16, label="profiled")[2])

    # inactive rows: one request finished at prefill, one slot never used
    eng = ServingEngine(cfg, fns, params, EngineConfig(
        max_batch=slots, max_len=max_len, decode_block=8))
    for uid, new in enumerate((1, 20, 20)):     # one 16-token bucket
        eng.submit(Request(uid=uid, prompt=prompts[uid][:16],
                           max_new_tokens=new))
    eng._fill_slots()
    check(eng.slots[0] is None and eng.slots[1] is not None,
          "the one-token request did not finish at prefill")

    def rows(i):
        st = eng.cache
        return [st["pos"][i].clone()] + [leaf[:, i].clone() for key in
                                         ("slstm", "mlstm")
                                         for leaf in st[key]]
    before = {i: rows(i) for i in (0, slots - 1)}
    eng._decode_block()
    for i, leaves in before.items():
        check(all(torch.equal(a, b) for a, b in zip(rows(i), leaves)),
              f"inactive row {i}'s state changed across a decode block")
    full_b, per_pos_b, carry_b = eng.spec.row_wire_bytes(max_len)
    check(per_pos_b == 0 and carry_b == full_b
          and full_b == row_bytes(eng.cache, slots),
          f"row_wire_bytes {full_b} != the bytes of one row the engine "
          f"holds {row_bytes(eng.cache, slots)}")
    print(f"  a finished row and a never-used row keep their whole state "
          f"(sLSTM and mLSTM carries, pos) bitwise across a decode block | "
          f"one carry row: {full_b} bytes", flush=True)
    del eng

    # a 3-pod plane of 8 slots, pod 1 struck at tick 2 for 3 ticks;
    # replicated, then full drain.  Prompts cut to 60 tokens (buckets 16
    # to 64): prefill runs the decode cell once per bucket position
    pods, pslots, n_plane = 3, 8, 16
    sched = "2:1:3"
    plane_prompts_ = [p[:60] for p in prompts[:n_plane]]
    want = None
    for replicate in (True, False):
        label = "replicated" if replicate else "full-drain"
        plane = ConstellationRouter(
            [ServingEngine(cfg, fns, params, EngineConfig(
                max_batch=pslots, max_len=max_len, decode_block=8))
             for _ in range(pods)],
            forced_outage=parse_outage_spec(sched),
            grid=GridConfig(replicate=replicate))
        for r in _family_requests(Request, plane_prompts_, max_new):
            plane.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = plane.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        s = plane.plane_stats()
        outage_contract(plane, done, n_plane, expect_pointer_flip=replicate)
        check(all(len(r.generated) == max_new for r in done),
              f"{label} plane: a request stopped short")
        if want is None:
            alone = ServingEngine(cfg, fns, params, EngineConfig(
                max_batch=pslots, max_len=max_len, decode_block=8))
            for r in sorted(done, key=lambda r: r._seq):
                one = Request(uid=r.uid, prompt=r.prompt,
                              max_new_tokens=max_new,
                              temperature=r.temperature)
                one._seq = r._seq
                alone.submit(one)
            want = {r.uid: r.generated for r in alone.run()}
            del alone
        bad = [r.uid for r in done if r.generated != want[r.uid]]
        check(not bad, f"{label} plane: requests {bad} differ from one "
              f"engine serving them alone")
        if replicate:
            check(s["replicated_bytes"] == full_b * s["replicated_rows"] > 0,
                  f"replicated bytes {s['replicated_bytes']} != "
                  f"{s['replicated_rows']} rows x row_wire_bytes {full_b}")
        else:
            check(s["replicated_bytes"] == 0, "the full-drain plane "
                  "replicated")
        stalls = sorted(plane.failover_stalls)
        e = s["engines"]
        print(f"  {label} plane ({pods} pods x {pslots} slots, {n_plane} "
              f"requests of 4-60 prompt tokens, '{sched}'): {e['tokens']} "
              f"tokens in {dt:.3f} s = "
              f"{e['tokens'] / dt:.1f} tok/s | {s['pointer_flips']} pointer "
              f"flips + {s['full_migrations']} full drains, "
              f"{s['rebalanced_slots']} rebalanced | failover stalls "
              f"{len(stalls)}: p50 "
              f"{stalls[len(stalls) // 2] * 1e3 if stalls else 0:.2f} ms, "
              f"max {stalls[-1] * 1e3 if stalls else 0:.2f} ms | "
              f"{e['standby_syncs']} standby syncs, {s['replicated_rows']} "
              f"carry rows = {s['replicated_bytes']} bytes "
              f"({full_b} per row) | peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        del plane, done
    print("  replicated and full-drain planes == one engine alone, every "
          "request bitwise; zero drops", flush=True)


def family_reference(torch):
    """Phase 16: the reduced granite-moe, qwen3-moe (head_dim 64, which
    the decode kernels take) and xlstm configs in f32, on the card
    against the CPU: prefill and decode logits within 1e-3, and an
    engine's token streams equal."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    from repro_torch.train.tree import tree_map
    toks = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
                         [7] * 12, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]],
                        dtype=torch.int32)
    lens = torch.tensor([12, 5, 9], dtype=torch.int32)
    admit = torch.ones(3, dtype=torch.bool)
    for arch in ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "xlstm-350m"):
        over = dict(compute_dtype="float32")
        if arch != "xlstm-350m":
            over["head_dim"] = 64
        cfg = registry.get_reduced_config(arch, **over)
        fns = registry.model_fns(cfg)
        cpu = context_params(torch, fns, cfg, "cpu", seed=1)
        gpu = tree_map(lambda x: x.cuda(), cpu)
        out = {}
        for d, p in (("cpu", cpu), ("cuda", gpu)):
            spec = fns.decode_spec(cfg, d)
            out[d] = spec, p, spec.prefill(p, spec.init_state(3, 64),
                                           toks.to(d), lens.to(d),
                                           admit.to(d))
        (sc, pc, (lc, stc)), (sg, pg, (lg, stg)) = out["cpu"], out["cuda"]
        worst = 0.0
        for _ in range(8):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            nxt = lc.argmax(-1, keepdim=True).to(torch.int32)
            lc, stc = sc.decode(pc, stc, nxt)
            lg, stg = sg.decode(pg, stg, nxt.cuda())
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        check(worst <= 1e-3, f"{arch}: card vs CPU logits differ by {worst}")
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(3, 30, 6)]
        streams = {}
        for d, p in (("cpu", cpu), ("cuda", gpu)):
            eng = ServingEngine(cfg, fns, p, EngineConfig(
                max_batch=3, max_len=64, decode_block=4))
            for r in _family_requests(Request, prompts, 12):
                eng.submit(r)
            streams[d] = {r.uid: r.generated for r in eng.run()}
        check(streams["cpu"] == streams["cuda"],
              f"{arch}: card and CPU token streams differ")
        print(f"  {cfg.name} f32: prefill + 8 decode steps, card vs CPU "
              f"logits max abs err {worst:.3e} (tol 1e-3); an engine's 6 "
              f"streams equal on both", flush=True)


def family_paths(torch):
    """Phases 14-16.  Returns (B1 launches, B2 launches) of phase 14."""
    gc.collect()             # earlier phases' engines sit in cycles
    torch.cuda.empty_cache()
    phase("phase 14: serve granite-moe-1b-a400m (published widths, 6 of "
          "24 layers, bf16, H 16/8, 32 experts top-8)")
    launches = moe_serve_phase(torch)
    torch.cuda.empty_cache()
    phase("phase 15: serve xlstm-350m (published widths, 1 of 12 pairs, "
          "bf16, f32 carries), "
          "engine and 3-pod plane")
    xlstm_serve_phase(torch)
    torch.cuda.empty_cache()
    phase("phase 16: MoE and xLSTM reference check")
    family_reference(torch)
    check(min(launches) > 0, "B1 or B2 never launched serving "
          "granite-moe-1b-a400m")
    return launches


# phase 17's configs: arch -> (layers kept, B1/B2 row suffix of phase 2)
# (minicpm-2b at 20 of its 40 layers since slice 9, for the time limit)
BRANCH_SERVE = {"minicpm-2b": (20, "_mha"), "stablelm-12b": (8, "_dh160"),
                "command-r-35b": (4, "_dh128"), "qwen2.5-32b": (6, "_h40")}
# phase 2's rows at their decode widths: suffix -> (H, Hkv, dh)
BRANCH_ROWS = {"_dh160": (32, 8, 160), "_dh128": (64, 8, 128),
               "_h40": (40, 8, 128), "_mha": (36, 36, 64)}


def branch_serve_phase(torch, arch):
    """Phase 17, one config: published widths, depth cut to the layers of
    BRANCH_SERVE, random bf16 weights drawn on the card from seed 0 with
    the embedding x 0.1; phase 3's workload dense and paged (stablelm-12b
    also at decode_block 1).  Returns (B1 launches, B2 launches)."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.train.tree import tree_leaves
    dev = torch.device("cuda")
    full = registry.get_config(arch)
    cfg = registry.get_config(arch, n_layers=BRANCH_SERVE[arch][0])
    fns = registry.model_fns(cfg)
    t0 = time.perf_counter()
    # minicpm-2b multiplies its embedding by 12: scaled by 0.1 / 12, its
    # rows enter the residual stream as the other configs' (x 0.1) do
    params = context_params(torch, fns, cfg, dev,
                            scale=0.1 / cfg.embed_scale)
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == cfg.param_count(), f"{arch}: param count")
    params = fns.cast_params(params, cfg)     # one bf16 copy for every run
    torch.cuda.synchronize()
    print(f"  {arch}: {cfg.n_layers} of {full.n_layers} layers, d "
          f"{cfg.d_model}, H {cfg.n_heads}/{cfg.n_kv_heads}, dh {cfg.hd}, "
          f"vocab {cfg.vocab_size}: {n_params / 1e9:.3f}B params (full "
          f"depth {full.param_count() / 1e9:.3f}B) drawn on the card from "
          f"seed 0, the embedding x {0.1 / cfg.embed_scale:.4g}, cast to "
          f"bf16: "
          f"{time.perf_counter() - t0:.1f} s | "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    n_req, max_new = 32, 32
    prompts = _rglru_workload(np, cfg.vocab_size, n_req,
                              np.random.default_rng(0))
    check(min(map(len, prompts)) >= 4 and max(map(len, prompts)) <= 200,
          "prompt lengths outside 4-200")

    def run(page_size, block, ps=prompts, new=max_new):
        return _serve_run(torch, cfg, fns, params, page_size, block, ps,
                          new, arch)

    run(0, 8, prompts[:4], 4)            # warm-up: cuBLAS, allocator
    totals = [0, 0]
    streams = {}
    runs = [(0, 8), (16, 8)] + ([(0, 1)] if arch == "stablelm-12b" else [])
    for page_size, block in runs:
        streams[(page_size, block)], got, _ = run(page_size, block)
        totals[0] += got[0]
        totals[1] += got[1]
    dense = streams[(0, 8)]
    check(streams[(16, 8)] == dense,
          f"{arch}: paged != dense token streams")
    if (0, 1) in streams:
        check(streams[(0, 1)] == dense,
              f"{arch}: decode_block 1 != 8 token streams")
    distinct = sorted(len(set(v)) for v in dense.values())
    print(f"  {arch}: paged == dense token streams (bitwise)"
          + ("; decode_block 1 == 8" if (0, 1) in streams else "")
          + f"; greedy and T 0.7 alternate; distinct tokens per stream "
          f"{distinct[0]}-{distinct[-1]}", flush=True)
    if arch == "minicpm-2b":
        profile_window(torch, f"{arch} dense, 16 requests x 16 tokens",
                       lambda: run(0, 8, prompts[:16], 16)[2],
                       watch=("decode_split_kernel", "decode_merge_kernel"))

    # full-width logits from one decode call: finite, of the right shape
    cache = fns.init_cache(cfg, 2, 64, device=dev)
    logits, _ = fns.decode_step(params, cache, torch.tensor(
        np.stack([prompts[0][:4], prompts[1][:4]]), device=dev), cfg)
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{arch}: logits")
    return tuple(totals)


# phase 18's configs: arch -> layers kept
# stablelm-12b at 2 of 40 layers (1.58B params): f32 AdamW holds old and
# new state at once (~30 bytes a parameter) beside (8, 1024, 100352) f32
# logits, so 4 layers (2.14B) would not leave room on one 80 GB card;
# qwen2-vl-2b at 2 of 28 and musicgen-medium at 3 of 48 (8 and 12 until
# slice 9, 4 and 6 until slice 11: cut for the script's time limit)
BRANCH_TRAIN = {"qwen2-vl-2b": 2, "musicgen-medium": 3, "stablelm-12b": 2}


def branch_train_phase(torch, arch):
    """Phase 18, one config: published widths, depth cut to BRANCH_TRAIN;
    see `train_cut_phase`.  Returns B3's launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import registry
    cfg = registry.get_config(arch, n_layers=BRANCH_TRAIN[arch])
    return train_cut_phase(torch, arch, cfg, {"B3": flash_attention},
                           {"B3": 2 * cfg.n_layers * 8})["B3"]


def train_cut_phase(torch, arch, cfg, kernels, want, steps=8):
    """Phases 18 and 21, one config `cfg` (published widths, cut in
    depth): seq 1024, batch 8, the port's SyntheticLM of the arch's kind,
    random f32 masters drawn on the card from seed 0, bf16 compute;
    FaultTolerantTrainer.run_fused for `steps` steps (one drain) and run
    for as many from the same state (drawn anew from the seed for each run, so no
    third copy of the state sits beside a step's old and new), bitwise
    equal.  `kernels` maps a label to a kernel wrapper whose launches
    each run must make exactly `want[label]` of.  Returns {label:
    launches over both runs}."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.train import (AdamWConfig, DataConfig,
                                   FaultTolerantTrainer, FTConfig,
                                   SyntheticLM, TrainConfig, init_train_state,
                                   make_fused_steps, make_train_step)
    from repro_torch.train.tree import tree_map, tree_paths
    dev = torch.device("cuda")
    full = registry.get_config(arch)
    fns = registry.model_fns(cfg)
    kind = registry.input_kind(arch)
    k, seq, batch = steps, 1024, 8
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3),
                       schedule=registry.lr_schedule(arch), warmup_steps=2,
                       total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0,
                                  n_codebooks=getattr(cfg, "n_codebooks", 1),
                                  kind=kind),
                       dev)

    def state0():
        return init_train_state(torch.Generator(dev).manual_seed(0), cfg,
                                fns, dev)

    t0 = time.perf_counter()
    first = state0()
    torch.cuda.synchronize()
    shapes = {n: tuple(v.shape) for n, v in data.batch_at(0).items()}
    heads = (f"H {cfg.n_heads}/{cfg.n_kv_heads}, dh {cfg.hd}"
             if hasattr(cfg, "n_kv_heads") else f"H {cfg.n_heads}")
    print(f"  {arch}: {cfg.n_layers} of {full.n_layers} layers, d "
          f"{cfg.d_model}, {heads}: "
          f"{cfg.param_count() / 1e9:.3f}B params (full depth "
          f"{full.param_count() / 1e9:.3f}B) drawn on the card: "
          f"{time.perf_counter() - t0:.1f} s | {kind} batches {shapes}",
          flush=True)
    step_fn = make_train_step(cfg, fns, tcfg)
    fused = make_fused_steps(cfg, fns, tcfg)
    step_fn(first, data.batch_at(0))     # warm-up: cuBLAS, allocator
    del first
    runs = {}
    for mode in ("run_fused", "run"):
        # the trainer's step-0 snapshot is a host copy only (no
        # directories): phase 5 covers the checkpoint writes
        ft = FTConfig(checkpoint_dirs=(), checkpoint_every=10 * steps,
                      drain_every=k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = FaultTolerantTrainer(step_fn, state0(), data, ft,
                                  fused_steps=fused)
        for k_ in kernels.values():
            k_.launches = 0
        t0 = time.perf_counter()
        hist = getattr(tr, mode)(steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {n: k_.launches for n, k_ in kernels.items()}
        losses = [h["loss"] for h in hist]
        st = tr.stats
        print(f"  {arch} {mode}: {steps} steps x {seq * batch} tokens in "
              f"{dt:.3f} s = {steps * seq * batch / dt:.1f} tok/s | "
              f"{st['host_syncs'] / steps:.4f} host syncs/step "
              f"({st['drains']} drains) | launches "
              f"{' '.join(f'{n} {c}' for n, c in launches.items())} | peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        print(f"    loss {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"{arch} {mode}: a loss is not finite: {losses}")
        check(st["rollbacks"] == 0, f"{arch} {mode}: rollbacks on a clean "
              f"run")
        check(launches == want, f"{arch} {mode}: launches {launches}, "
              f"want {want}")
        # on the host: a third state beside the next run's old and new
        # would not fit beside stablelm-12b's step
        runs[mode] = (losses, tree_map(lambda x: x.cpu(), tr.state),
                      launches, st)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    check(runs["run_fused"][3]["drains"] == steps // k,
          f"{arch}: run_fused drained {runs['run_fused'][3]['drains']} "
          f"times, want {steps // k}")
    check(runs["run_fused"][0] == runs["run"][0],
          f"{arch}: run_fused and run losses differ")
    pa, pb = tree_paths(runs["run_fused"][1]), tree_paths(runs["run"][1])
    check(list(pa) == list(pb) and all(torch.equal(pa[n], pb[n])
                                       for n in pa),
          f"{arch}: run_fused and run final states differ")
    print(f"  {arch}: run_fused == run, losses and final state bitwise; no "
          f"host sync inside the fused block (sync debug mode \"error\")",
          flush=True)
    return {n: runs["run_fused"][2][n] + runs["run"][2][n] for n in kernels}


def branch_reference(torch, head_dim):
    """Phase 19: the six configs' reduced widths at head_dim 64 (qwen2-vl
    with M-RoPE sections 16/8/8), or (head_dim None) at their own reduced
    head dims (12, 16, 20: the kernels run them zero-padded to 64), f32,
    on the card against the CPU: the training loss (B3 on the card), a
    prefill and 8 decode steps (B1) within 1e-3 with the same greedy
    tokens; the token LMs' engines (dense and paged) give the CPU's token
    streams."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    from repro_torch.train import DataConfig, SyntheticLM
    from repro_torch.train.tree import tree_map
    dev = torch.device("cuda")
    cpu_dev = torch.device("cpu")
    for arch in ("minicpm-2b", "stablelm-12b", "command-r-35b",
                 "qwen2.5-32b", "qwen2-vl-2b", "musicgen-medium"):
        over = dict(compute_dtype="float32")
        if head_dim is not None:
            over["head_dim"] = head_dim
            if arch == "qwen2-vl-2b":
                over["mrope_sections"] = (16, 8, 8)
        cfg = registry.get_reduced_config(arch, **over)
        fns = registry.model_fns(cfg)
        kind = registry.input_kind(arch)
        cpu = context_params(torch, fns, cfg, "cpu", seed=1)
        gpu = tree_map(lambda x: x.to(dev), cpu)
        sides = ((cpu_dev, cpu), (dev, gpu))
        loss = []
        for d, p in sides:
            batch = SyntheticLM(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=128, global_batch=2,
                n_codebooks=cfg.n_codebooks, kind=kind), d).batch_at(0)
            with torch.no_grad():
                loss.append(fns.loss_fn(p, batch, cfg).item())
        lerr = abs(loss[1] - loss[0])
        check(lerr <= 1e-3, f"{arch}: card vs CPU loss differ by {lerr}")
        rng = np.random.default_rng(2)
        shape = ((3, cfg.n_codebooks, 12) if cfg.n_codebooks > 1
                 else (3, 12))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
        caches = []
        for d, _ in sides:
            cache = fns.init_cache(cfg, 3, 64, device=d)
            cache["pos"] = torch.zeros(3, dtype=torch.int32, device=d)
            caches.append(cache)
        worst, nxt = 0.0, toks
        for i in range(9):
            lg = []
            for j, (d, p) in enumerate(sides):
                out, caches[j] = fns.decode_step(p, caches[j], nxt.to(d),
                                                 cfg)
                lg.append(out.cpu())
            worst = max(worst, (lg[1] - lg[0]).abs().max().item())
            check(torch.equal(lg[1].argmax(-1), lg[0].argmax(-1)),
                  f"{arch}: card and CPU greedy tokens differ at step {i}")
            nxt = lg[0].argmax(-1)[..., None]
        check(worst <= 1e-3, f"{arch}: card vs CPU logits differ by {worst}")
        line = (f"  {cfg.name} (head_dim {cfg.hd}) f32: loss card vs CPU "
                f"{lerr:.3e}, prefill + 8 decode steps logits max abs err "
                f"{worst:.3e} (tol 1e-3), greedy tokens equal")
        if kind == "tokens":
            prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(
                np.int32) for n in rng.integers(3, 30, 6)]
            streams = []
            for p, page in ((cpu, 0), (gpu, 0), (gpu, 16)):
                eng = ServingEngine(cfg, fns, p, EngineConfig(
                    max_batch=3, max_len=64, decode_block=4,
                    page_size=page))
                for r in _family_requests(Request, prompts, 12):
                    eng.submit(r)
                streams.append({r.uid: r.generated for r in eng.run()})
            check(streams[0] == streams[1] == streams[2],
                  f"{arch}: card (dense, paged) and CPU token streams "
                  f"differ")
            line += "; an engine's 6 streams equal on both, dense and paged"
        print(line, flush=True)


def branch_rows(torch, timer):
    """Phase 2's rows at the new decode widths and phase 2b's at the new
    training widths: {row name: row}."""
    rows = {}
    for suffix, (h, hkv, dh) in BRANCH_ROWS.items():
        print(f"  B1/B2 at H {h}/{hkv}, dh {dh}:", flush=True)
        for r in kernel_phase(torch, timer, h, hkv, ((16, 512, 232, 256),),
                              suffix, dh):
            rows[r["name"]] = r
    print("  B3 at qwen2-vl-2b's, musicgen-medium's and stablelm-12b's "
          "training widths:", flush=True)
    for r in flash_phase(torch, timer, ("flash_attention_dh128",
                                        "flash_attention_mha",
                                        "flash_attention_dh160"),
                         more=False):
        rows[r["name"]] = r
    return rows


def branch_paths(torch):
    """Phases 17-19.  Returns {row name: launches} for the rows of
    `branch_rows`."""
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 17: serve minicpm-2b, stablelm-12b, command-r-35b, "
          "qwen2.5-32b (published widths, cut in depth, bf16)")
    launches = {}
    for arch, (_, suffix) in BRANCH_SERVE.items():
        t0 = time.perf_counter()
        b1, b2 = branch_serve_phase(torch, arch)
        check(b1 > 0 and b2 > 0, f"{arch}: B1 or B2 never launched")
        for name, n in (("decode_attention" + suffix, b1),
                        ("paged_decode_attention" + suffix, b2)):
            launches[name] = launches.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    phase("phase 18: train musicgen-medium, qwen2-vl-2b and stablelm-12b "
          "(published widths, cut in depth, bf16, seq 1024, batch 8)")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for arch, name in (("qwen2-vl-2b", "flash_attention_dh128"),
                           ("musicgen-medium", "flash_attention_mha"),
                           ("stablelm-12b", "flash_attention_dh160")):
            launches[name] = branch_train_phase(torch, arch)
            check(launches[name] > 0, f"{arch}: B3 never launched")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    phase("phase 19: the six reduced configs, card vs CPU, at head_dim 64 "
          "and at their own head dims; the launchers at their defaults")
    branch_reference(torch, head_dim=64)
    branch_reference(torch, head_dim=None)
    launcher_defaults()
    return launches


# phase 21's configs: arch -> (layers kept, config overrides).
# granite-moe-1b-a400m at 12 of its 24 layers (all 24 until phase 24
# came: 1.335B params, f32 AdamW state, old and new, and remat
# activations peaked near 42 GB; cut for the run's time); xlstm-350m at
# 1 of 12 sLSTM/mLSTM pairs (the sLSTM is a Python loop over the 1024
# positions: host-bound, 6.3-8.7 s a step at 2 pairs, the longest part
# of a whole run); recurrentgemma-2b at 5
# of 26 layers, one (rec, rec, attn) group under remat and the two tail
# recurrent blocks without, with the loss in chunks of 256 positions
# ((8, 1024, 256000) f32 logits would be 8.4 GB)
FAMILY_TRAIN = {"granite-moe-1b-a400m": (12, {}),
                "xlstm-350m": (2, {}),
                "recurrentgemma-2b": (5, {"loss_chunk": 256})}
# steps a run (8 unless named): xlstm-350m 4 since slice 11, for the run's
# time (its sLSTM loop is the slowest step of the script)
FAMILY_STEPS = {"xlstm-350m": 4}


def family_launches(cfg, seq, steps):
    """The launches `steps` train steps at sequence length `seq` must
    make: {"B3": flash attention, "B4": the scan forward, "B4 bwd": its
    backward}.  Remat runs a block's forward twice (the forward and the
    recompute before its backward).  A transformer launches B3 once per
    layer per forward; recurrentgemma B4 once per recurrent block (2 per
    group, remat'd, and the tail blocks, not); xLSTM B4 once per mLSTM
    layer per chunk of `mlstm_chunk` positions (its prefix sums)."""
    from repro_torch.models.rglru import RGLRUConfig
    from repro_torch.models.xlstm import XLSTMConfig
    r = 2 if cfg.remat else 1
    if isinstance(cfg, RGLRUConfig):
        g, t = 2 * cfg.n_groups, cfg.n_tail_rec
        return {"B3": 0, "B4": steps * (r * g + t), "B4 bwd": steps * (g + t)}
    if isinstance(cfg, XLSTMConfig):
        n = -(-seq // cfg.mlstm_chunk) if seq > cfg.mlstm_chunk else 1
        return {"B3": 0, "B4": steps * r * cfg.n_pairs * n,
                "B4 bwd": steps * cfg.n_pairs * n}
    return {"B3": steps * r * cfg.n_layers, "B4": 0, "B4 bwd": 0}


def family_launchers():
    """Phase 21, last part: the train launcher on the card at its reduced
    defaults for the three families, side by side: the reference
    launcher's DiLoCo example for granite-moe-1b-a400m (`--diloco-pods 2
    --inner-steps 8 --compress int8`) and 8 steps of xlstm-350m and
    recurrentgemma-2b; each exits 0, granite launches B3 and the other two
    B4 forward and backward."""
    runs = ((("-m", "repro_torch.launch.train", "--arch",
              "granite-moe-1b-a400m", "--diloco-pods", "2", "--inner-steps",
              "8", "--compress", "int8"),
             (("B3", r"flash-attention kernel launches "),)),
            (("-m", "repro_torch.launch.train", "--arch", "xlstm-350m",
              "--steps", "8"),
             (("B4", r"scan kernel launches: forward "),
              ("B4 bwd", r"scan kernel launches: forward \d+ backward "))),
            (("-m", "repro_torch.launch.train", "--arch",
              "recurrentgemma-2b", "--steps", "8"),
             (("B4", r"scan kernel launches: forward "),
              ("B4 bwd", r"scan kernel launches: forward \d+ backward "))))
    results = _launchers([args for args, _ in runs])
    for (args, counts), (rc, out, err, dt) in zip(runs, results):
        cmd = " ".join(args)
        check(rc == 0, f"{cmd} exited {rc}:\n{err[-3000:]}")
        seen = {}
        for label, pattern in counts:
            seen[label] = _printed_count(pattern, out, cmd)
            check(seen[label] > 0, f"{cmd}: {label} never launched")
        print(f"  {cmd} (reduced config, cuda): exit 0 in {dt:.1f} s, "
              f"launches {seen}", flush=True)
        for ln in [ln for ln in out.splitlines() if ln.strip()][-3:]:
            print(f"    {ln.strip()[:300]}", flush=True)


# phase 22's limit on each gradient leaf, card against CPU, as a share of
# the leaf's own largest |grad|: the worst leaves read 7.2e-07
# (granite-moe), 1.8e-05 (xLSTM's mlstm/w_k) and 2.0e-06 (recurrentgemma)
# on an H100, so 1e-4 is about 6x the worst reading
GRAD_TOL = 1e-4


def family_train_reference(torch):
    """Phase 22: the three families' reduced configs (granite-moe at
    head_dim 64; xLSTM with mlstm_chunk 16, so the chunked form runs as it
    does at seq 1024), f32, on the card against the CPU: one batch's loss
    within 1e-3, every gradient leaf within GRAD_TOL of the leaf's own
    largest |grad|, 4 train steps' losses within 1e-3; then the
    micro recurrent DiLoCo round (recurrentgemma and xLSTM reduced, 2 pods
    x H 2, seq 8, batch 2: the reference's
    test_recurrent_fused_diloco_round_bit_identical) on the card against
    the CPU within 1e-3, and on the card bitwise equal to
    make_inner_steps + outer_step."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                                   SyntheticLM, TrainConfig, diloco_init,
                                   init_train_state, make_diloco_round,
                                   make_inner_steps, make_train_step,
                                   outer_step)
    from repro_torch.train.tree import (tree_leaves, tree_map, tree_paths,
                                        tree_unflatten)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                       total_steps=100)

    def reduced(arch):
        over = dict(compute_dtype="float32")
        if arch == "granite-moe-1b-a400m":
            over["head_dim"] = 64
        if arch == "xlstm-350m":
            over["mlstm_chunk"] = 16
        cfg = registry.get_reduced_config(arch, **over)
        return cfg, registry.model_fns(cfg)

    for arch in FAMILY_TRAIN:
        cfg, fns = reduced(arch)
        first = init_train_state(torch.Generator().manual_seed(0), cfg, fns,
                                 cpu)
        grads, losses = {}, {}
        for side, d in (("cpu", cpu), ("card", dev)):
            state = tree_map(lambda t: t.to(d), first)
            data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=64, global_batch=4), d)
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(state["params"])]
            loss = fns.loss_fn(tree_unflatten(state["params"], leaves),
                               data.batch_at(0), cfg)
            grads[side] = (loss.item(), [g.cpu() for g in
                                         torch.autograd.grad(loss, leaves)])
            step = make_train_step(cfg, fns, tcfg)
            ls = []
            for i in range(4):
                state, m = step(state, data.batch_at(i))
                ls.append(m["loss"].item())
            losses[side] = ls
        lerr = abs(grads["card"][0] - grads["cpu"][0])
        # each leaf's error relative to its own largest |grad| (floored at
        # 1e-12 only so that a leaf of zeros divides)
        gerr, worst = max(
            (((gg - gc).abs().max() / gc.abs().max().clamp(min=1e-12)
              ).item(), name)
            for name, gc, gg in zip(tree_paths(first["params"]),
                                    grads["cpu"][1], grads["card"][1]))
        serr = max(abs(a - b) for a, b in zip(losses["cpu"],
                                              losses["card"]))
        check(lerr <= 1e-3 and gerr <= GRAD_TOL and serr <= 1e-3,
              f"{cfg.name}: card vs CPU loss {lerr}, gradients {gerr} "
              f"({worst}; tol {GRAD_TOL}), 4 steps' losses {serr} "
              f"(tol 1e-3)")
        print(f"  {cfg.name} f32: one batch's loss card vs CPU {lerr:.3e} "
              f"(tol 1e-3), {len(grads['cpu'][1])} gradient leaves within "
              f"{gerr:.3e} of each leaf's max |grad| (worst {worst}; tol "
              f"{GRAD_TOL}); 4 train steps' losses within {serr:.3e} "
              f"(tol 1e-3)", flush=True)

    dcfg = DiLoCoConfig(n_pods=2, inner_steps=2)
    for arch in ("recurrentgemma-2b", "xlstm-350m"):
        cfg, fns = reduced(arch)
        params = fns.init(torch.Generator().manual_seed(0), cfg, cpu)
        got = {}
        for side, d in (("cpu", cpu), ("card", dev)):
            data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=8, global_batch=2), d)
            batches = data.batch_block(np.arange(4).reshape(2, 2))
            p_d = tree_map(lambda t: t.to(d), params)
            mask = torch.ones(2, device=d)
            thr = torch.tensor([3.0, 10.0], device=d)
            rnd = make_diloco_round(cfg, fns, tcfg, dcfg)
            out, metrics = rnd(diloco_init(p_d, dcfg), batches, mask, thr)
            got[side] = (tree_paths(out), metrics["loss"].cpu())
            if side == "card":
                inner = make_inner_steps(cfg, fns, tcfg, dcfg)
                ref, _ = inner(diloco_init(p_d, dcfg), batches)
                ref = tree_paths(outer_step(ref, dcfg, pod_mask=mask))
                check(list(ref) == list(got["card"][0]) and all(
                    bits_equal(torch, ref[k], got["card"][0][k])
                    for k in ref),
                      f"{cfg.name}: the fused round on the card differs "
                      f"from make_inner_steps + outer_step")
        (sc, lc), (sg, lg) = got["cpu"], got["card"]
        worst = max((sg[k].cpu().double() - sc[k].double()).abs().max()
                    .item() for k in sc if sc[k].is_floating_point())
        lerr = (lg - lc).abs().max().item()
        check(bool(torch.isfinite(lg).all()) and worst <= 1e-3
              and lerr <= 1e-3, f"{cfg.name}: DiLoCo round card vs CPU "
              f"state {worst}, losses {lerr} (tol 1e-3)")
        print(f"  {cfg.name} f32 DiLoCo round (2 pods x H 2): card == "
              f"make_inner_steps + outer_step bitwise; card vs CPU state "
              f"within {worst:.3e}, losses {lerr:.3e} (tol 1e-3)", flush=True)


def family_train_paths(torch):
    """Phases 21-22.  Returns {kernel label: launches} over phase 21's
    runs: "B3" (granite-moe), "B4" and "B4 bwd" (xlstm-350m,
    recurrentgemma-2b)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import kernel as b4
    from repro_torch.models import registry
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 21: train granite-moe-1b-a400m, xlstm-350m and "
          "recurrentgemma-2b (published widths, cut in depth, bf16, seq "
          "1024, batch 8)")
    kernels = {"B3": flash_attention, "B4": b4.rglru_scan_fwd,
               "B4 bwd": b4.rglru_scan_bwd}
    total = dict.fromkeys(kernels, 0)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for arch, (layers, over) in FAMILY_TRAIN.items():
            t0 = time.perf_counter()
            cfg = registry.get_config(arch, n_layers=layers, **over)
            steps = FAMILY_STEPS.get(arch, 8)
            got = train_cut_phase(torch, arch, cfg, kernels,
                                  family_launches(cfg, 1024, steps), steps)
            for n, c in got.items():
                total[n] += c
            gc.collect()
            torch.cuda.empty_cache()
            print(f"  {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    family_launchers()
    phase("phase 22: the three families' reduced configs and the recurrent "
          "DiLoCo round, card vs CPU")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        family_train_reference(torch)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    return total


CONTROL_ITERS = 25       # phase 20c's iterations (the reference test's)


def _launchers(runs, timeout=600):
    """Port launchers or examples side by side, each in a process of its
    own on the card (their default device); a run is the interpreter's
    arguments ("-m", module, ... or a script's path, ...).  Returns a list
    of (exit code, stdout, stderr, s to its exit) in the order of `runs`.
    Every process still running at the time limit, or when this fails, is
    killed."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in runs]
    procs = [subprocess.Popen([sys.executable, *args], stdout=o,
                              stderr=e, text=True, env=env, cwd=root)
             for args, (o, e) in zip(runs, files)]
    done = [None] * len(procs)
    try:
        while None in done:
            check(time.perf_counter() - t0 < timeout,
                  f"launchers still running after {timeout} s: {runs}")
            for i, p in enumerate(procs):
                if done[i] is None and p.poll() is not None:
                    done[i] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, (o, e), dt in zip(procs, files, done):
        o.seek(0)
        e.seek(0)
        out.append((p.returncode, o.read(), e.read(), dt))
        o.close()
        e.close()
    return out


def _printed_count(pattern, out, what):
    """The integer a launcher printed after `pattern` (a regex ending
    where the number starts); fails the run when it is not there."""
    m = re.search(pattern + r"(\d+)", out)
    check(m is not None, f"{what}: no count in the launcher's output:\n"
          f"{out[-2000:]}")
    return int(m.group(1))


def launcher_defaults():
    """Phase 19, last part: the train and serve launchers at their
    defaults (the reduced demo LM, head_dim 16, on the card): both exit
    0, and the counts they print show that B3 (train) and B1 (serve)
    launched there, at the reduced head dim padded to 64.  The two run
    side by side."""
    from repro_torch.models import registry
    dh = registry.get_reduced_config("suncatcher-lm-100m").hd
    check(dh < 64, f"the launchers' default config has head_dim {dh}")
    runs = ((("-m", "repro_torch.launch.train", "--steps", "8"), "B3",
             r"flash-attention kernel launches "),
            (("-m", "repro_torch.launch.serve", "--requests", "4"), "B1",
             r"decode-attention kernel launches: dense "))
    results = _launchers([args for args, _, _ in runs])
    for (args, kernel, pattern), (rc, out, err, dt) in zip(runs, results):
        check(rc == 0, f"{' '.join(args)} exited {rc}:\n{err[-3000:]}")
        n = _printed_count(pattern, out, ' '.join(args))
        check(n > 0, f"{' '.join(args)}: {kernel} never launched at dh {dh}")
        lines = [ln for ln in out.splitlines() if ln.strip()]
        print(f"  {' '.join(args)} (defaults, cuda, dh {dh}): exit 0 in "
              f"{dt:.1f} s, {kernel} launched {n} times", flush=True)
        for ln in lines[-3:]:
            print(f"    {ln.strip()[:300]}", flush=True)


def _tree_bits(torch, tree):
    """A tree's leaves as integer views (bit patterns), sorted by key."""
    from repro_torch.core.radiation.injection import _BITS_FOR
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _tree_bits(torch, v)
        else:
            out.append(v.contiguous().view(_BITS_FOR[v.dtype][0]).cpu())
    return out


def sdc_phase(torch):
    """Phase 20a: the SDC injector.  Identical bf16 and f32 trees on the
    card and the CPU take the same key's flips bitwise (also 200 flips on
    3 elements, where draws collide), with equal bit-pattern counts;
    the demo LM at full width under the per-step loop with an injector
    and a forced burst of 2,000 flips at step 3: the screens detect it,
    roll back and replay, and every kept loss is finite; the train
    launcher (6 steps; both runs side by side) with --sdc-rate-multiplier
    2e3 finishes with flips injected, detected and rolled back (its
    printed stats), and at 1e5 raises its "persistent non-finite"
    RuntimeError.  Returns B3's launches."""
    import numpy as np

    from repro_torch.core.radiation import (RadiationEnvironment,
                                            SDCInjector,
                                            count_changed_elements,
                                            flip_bits, inject_tree)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import registry
    from repro_torch.serving import prng
    from repro_torch.train import (AdamWConfig, DataConfig,
                                   FaultTolerantTrainer, FTConfig,
                                   SyntheticLM, TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(20)
    tree = {"w": torch.randn(768, 3072, generator=g),
            "embed": {"tok": torch.randn(32768, 64, generator=g).bfloat16(),
                      "b": torch.randn(7, generator=g)},
            "norm": torch.randn(768, generator=g).bfloat16()}
    for n in (1, 64, 5000):
        key = prng.PRNGKey(n)
        cpu = inject_tree(key, tree, n)
        card = inject_tree(key, tree_map(lambda x: x.to(dev), tree), n)
        a, b = _tree_bits(torch, cpu), _tree_bits(torch, card)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"SDC: {n} flips differ between the card and the CPU")
        changed = [sum(count_changed_elements(x, y) for x, y in zip(
            tree_leaves(t), tree_leaves(tree_map(lambda z: z.to(t_dev),
                                                 tree))))
                   for t, t_dev in ((cpu, "cpu"), (card, dev))]
        check(changed[0] == changed[1] and 1 <= changed[0] <= n,
              f"SDC: changed elements {changed} for {n} flips")
        print(f"  inject_tree, {n} flips over f32 + bf16 leaves: card == CPU "
              f"bitwise, {changed[0]} elements changed on both", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(3, generator=g).to(dt)
        cpu = flip_bits(prng.PRNGKey(9), x, 200)
        card = flip_bits(prng.PRNGKey(9), x.to(dev), 200)
        view = torch.int16 if dt == torch.bfloat16 else torch.int32
        check(torch.equal(cpu.view(view), card.cpu().view(view)),
              f"SDC: colliding flips ({dt}) differ between card and CPU")
    print("  200 flips on 3 elements (colliding draws), f32 and bf16: card "
          "== CPU bitwise", flush=True)

    cfg = registry.get_config("suncatcher-lm-100m")
    fns = registry.model_fns(cfg)
    steps, seq, batch, burst = 8, 1024, 8, 2000
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=2,
                       total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0), dev)
    state = init_train_state(torch.Generator(dev).manual_seed(0), cfg, fns,
                             dev)
    injector = SDCInjector(RadiationEnvironment(), n_chips=81 * 256,
                           step_time_s=1.0, rate_multiplier=0.0)
    flash_attention.launches = 0
    with tempfile.TemporaryDirectory() as d:
        tr = FaultTolerantTrainer(make_train_step(cfg, fns, tcfg), state,
                                  data, FTConfig(checkpoint_dirs=(d,),
                                                 drain_every=1),
                                  injector=injector)
        t0 = time.perf_counter()
        try:
            hist = tr.run(steps, forced_sdc_at={3: burst})
        finally:
            tr.join_checkpoints()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    st = tr.stats
    losses = [h["loss"] for h in hist]
    print(f"  {cfg.name} per-step loop, forced burst of {burst} flips at step "
          f"3: {len(hist)} steps run ({steps} kept) in {dt:.1f} s | stats "
          f"{ {k: v for k, v in st.items() if v} } | B3 launches "
          f"{flash_attention.launches}", flush=True)
    print(f"    loss {' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    check(st["sdc_injected"] == burst and st["sdc_detected"] >= 1
          and st["rollbacks"] >= 1, f"SDC burst not detected: {st}")
    check(tr.step == steps and all(np.isfinite(losses[-steps:])),
          f"SDC: the run did not recover ({tr.step} steps)")
    launches = flash_attention.launches
    del tr, state
    torch.cuda.empty_cache()

    runs = (("2e3", True), ("1e5", False))
    results = _launchers([("-m", "repro_torch.launch.train", "--steps", "6",
                           "--sdc-rate-multiplier", mult)
                          for mult, _ in runs])
    for (mult, ok), (rc, out, err, dt) in zip(runs, results):
        if ok:
            check(rc == 0, f"--sdc-rate-multiplier {mult} exited {rc}:\n"
                  f"{err[-3000:]}")
            got = {k: _printed_count(rf"'{k}': ", out, f"--sdc-rate-"
                                     f"multiplier {mult}: {k}")
                   for k in ("sdc_injected", "sdc_detected", "rollbacks")}
            check(got["sdc_injected"] > 0 and got["sdc_detected"] >= 1
                  and got["rollbacks"] >= 1,
                  f"--sdc-rate-multiplier {mult}: no injection recovered "
                  f"from: {got}")
            stats = re.search(r"ft stats (\{.*?\})", out)
            print(f"  train launcher --sdc-rate-multiplier {mult}: exit 0 in "
                  f"{dt:.1f} s | {stats.group(1) if stats else got}",
                  flush=True)
        else:
            check(rc != 0 and "RuntimeError: persistent non-finite" in err,
                  f"--sdc-rate-multiplier {mult}: exit {rc}, no persistent "
                  f"non-finite error:\n{err[-2000:]}")
            msg = [ln for ln in err.splitlines() if "RuntimeError" in ln]
            print(f"  train launcher --sdc-rate-multiplier {mult}: exit {rc} "
                  f"in {dt:.1f} s | {msg[-1].strip()}", flush=True)
    return launches


def _control_start(torch):
    """Phase 20c's problem and initial draws (the reference test's:
    3 x 3 lattice, 8 m of position noise), drawn on the CPU from seed 0,
    the same in the main process and the CPU-side worker."""
    from repro_torch.core.orbital import ClusterDesign, ControlProblem
    from repro_torch.core.orbital.control import init_policy
    prob = ControlProblem(design=ClusterDesign(n_side=3, spacing=100.0),
                          u_max=2e-5, control_dt=60.0, substeps=4,
                          dv_weight=1e3)
    g = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    p0 = init_policy(g, device=cpu)
    y0 = prob.design.initial_states(device=cpu)
    noise = 8.0 * torch.randn(y0.shape, generator=g, dtype=y0.dtype)
    noise[..., 3:] *= 1e-3
    return prob, p0, y0 + noise


def _liveness_j2():
    """Phase 20b's liveness model: 8 pods on the J2 orbit."""
    from repro_torch.core.isl import LivenessConfig
    return LivenessConfig(n_pods=8, outer_wire_bytes=430_000, integrate=True)


def slice8_cpu_side():
    """Phase 20's CPU references, run in a worker process while the card
    runs phase 20a: the J2 orbit (the paper's Fig. 2 entry: one orbit, dt
    5 s), the integrate=True
    liveness masks at 8 pods and the controller's 25 iterations, each
    timed; plain numbers and numpy arrays out."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch

    from repro_torch.core.isl import ConstellationLinkModel
    from repro_torch.core.orbital import train_controller
    from repro_torch.paper import fig2_constellation
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    out = {}
    t0 = time.perf_counter()
    lines, arrays = fig2_constellation.run(device=cpu)
    out["hill"], out["fig2_line"] = arrays["hill"].numpy(), lines[0][2]
    out["orbit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = ConstellationLinkModel(cfg=_liveness_j2(), device=cpu)
    out["liveness_s"] = time.perf_counter() - t0
    out["masks"], out["pod_bw"] = m.mask_series(256)[0], m._pod_bw
    prob, p0, y0 = _control_start(torch)
    t0 = time.perf_counter()
    _, info = train_controller(prob, n_intervals=20, iters=CONTROL_ITERS,
                               lr=3e-2, params=p0, y0=y0, device=cpu)
    out["control_s"] = time.perf_counter() - t0
    out["loss_history"] = info["loss_history"]
    return out


def orbit_phase(torch, cpu):
    """Phase 20b: the J2 orbit in float64 on the card, through the paper's
    entries (`repro_torch.paper`).  Fig. 2's (simulate_cluster of the
    81-satellite design, one orbit at dt 5 s) against the same entry on
    the CPU: Hill positions within 1e-6 m and velocities within 1e-9 m/s
    (the same elementwise IEEE operations in the same order on both), its
    printed line equal; neighbour distances 100-200 m (direct) as
    tests/test_orbital.py bounds them; the energy-matched Keplerian
    cluster closes to < 5 mm after an orbit at dt 2 s; the J2 drift
    entry's (kappa 1.0 and 0.999 over 6 orbits, both in one integration,
    `tune_axis_ratio`, each bitwise its own run): the tuned rate under
    half the base; ConstellationLinkModel(integrate=True) at 8 pods on the
    card: masks over 256 rounds equal the CPU port's.  `cpu` is the future
    of `slice8_cpu_side`, awaited first, so the card side is timed on a
    host the worker no longer contends."""
    import numpy as np

    from repro_torch.core.isl import ConstellationLinkModel
    from repro_torch.core.orbital import (ClusterDesign, neighbor_distances,
                                          simulate_cluster)
    from repro_torch.paper import fig2_constellation, j2_drift
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ref = cpu.result()
    print(f"  CPU-side worker finished ({time.perf_counter() - t0:.1f} s "
          f"waited); the card side below runs alone", flush=True)
    t0 = time.perf_counter()
    lines, arrays = fig2_constellation.run(device=dev)
    hill = arrays["hill"].cpu()
    t_card = time.perf_counter() - t0
    hill_cpu, t_cpu = torch.from_numpy(ref["hill"]), ref["orbit_s"]
    perr = (hill[..., :3] - hill_cpu[..., :3]).abs().max().item()
    verr = (hill[..., 3:] - hill_cpu[..., 3:]).abs().max().item()
    check(perr <= 1e-6 and verr <= 1e-9, f"J2 orbit card vs CPU: position "
          f"{perr} m, velocity {verr} m/s")
    check(lines[0][2] == ref["fig2_line"], f"Fig. 2 line, card: "
          f"{lines[0][2]!r}; CPU: {ref['fig2_line']!r}")
    direct, diag = neighbor_distances(hill)
    lo, hi = direct.min().item(), direct.max().item()
    check(90.0 < lo < 110.0 and 190.0 < hi < 215.0,
          f"direct neighbour distances {lo:.2f}-{hi:.2f} m")
    print(f"  paper entry fig2_constellation (simulate_cluster, 81 sats, 1 "
          f"orbit, dt 5 s, f64): card {t_card:.2f} s, CPU {t_cpu:.2f} s | "
          f"card vs CPU max |d pos| {perr:.3e} m, |d vel| {verr:.3e} m/s | "
          f"direct neighbours {lo:.2f}-{hi:.2f} m, diagonal "
          f"{diag.min().item():.2f}-{diag.max().item():.2f} m", flush=True)
    print(f"    {lines[0][0]}: {lines[0][2]} (== the CPU's)", flush=True)

    t0 = time.perf_counter()
    _, kep, _ = simulate_cluster(ClusterDesign(energy_matched=True),
                                 n_orbits=1.0, dt=2.0, j2=False, device=dev)
    closure = (kep[-1, :, :3] - kep[0, :, :3]).norm(dim=-1).max().item()
    check(closure < 5e-3, f"energy-matched Keplerian closure {closure} m")
    print(f"  energy-matched Keplerian cluster, 1 orbit at dt 2 s: closes "
          f"to {closure * 1e3:.3f} mm ({time.perf_counter() - t0:.2f} s)",
          flush=True)

    t0 = time.perf_counter()
    lines, rates = j2_drift.run(device=dev)
    base, tuned = rates[1.0], rates[0.999]
    print(f"  paper entry j2_drift (6 orbits, card, both kappas in one "
          f"integration): kappa 1.0 {base:.4f}, kappa 0.999 {tuned:.4f} "
          f"m/s/yr per km ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"    {lines[0][0]}: {lines[0][2]}", flush=True)
    check(tuned < 0.5 * base,
          f"tuned drift {tuned} not under half the base {base}")

    t0 = time.perf_counter()
    model = ConstellationLinkModel(cfg=_liveness_j2(), device=dev)
    t_live = time.perf_counter() - t0
    masks = model.mask_series(256)[0]
    check(np.array_equal(masks, ref["masks"]),
          "integrate=True masks differ between the card and the CPU")
    same_bw = model._pod_bw.tobytes() == ref["pod_bw"].tobytes()
    print(f"  ConstellationLinkModel(integrate=True, 8 pods): card "
          f"{t_live:.2f} s, CPU {ref['liveness_s']:.2f} s | masks over 256 "
          f"rounds equal | bandwidth tables "
          f"{'bitwise equal' if same_bw else 'differ'} | masked share "
          f"{1 - masks.mean():.3f}", flush=True)


def control_phase(torch, cpu):
    """Phase 20c: the formation controller at the reference test's problem
    (3 x 3 lattice, 20 intervals of 4 dopri5 substeps, 25 iterations of
    Adam, float64) from one set of initial draws on the card and on the
    CPU: loss histories within 1e-8 relative, the last loss under 0.6x
    the first, and the trained policy's rms position error under 0.8x
    free fall's, on the card.  `cpu` is the future of `slice8_cpu_side`,
    which ran the CPU side from the same draws and finished before 20b's
    card side began."""
    from repro_torch.core.orbital import rollout, train_controller
    dev = torch.device("cuda")
    prob, p0, y0 = _control_start(torch)
    iters = CONTROL_ITERS
    t0 = time.perf_counter()
    params, info = train_controller(
        prob, n_intervals=20, iters=iters, lr=3e-2,
        params={k: v.to(dev) for k, v in p0.items()}, y0=y0.to(dev),
        device=dev)
    t_card = time.perf_counter() - t0
    ref = cpu.result()
    h, hc, t_cpu = info["loss_history"], ref["loss_history"], ref["control_s"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(h, hc))
    check(rel <= 1e-8, f"controller loss history card vs CPU: {rel}")
    check(h[-1] < 0.6 * h[0], f"controller loss {h[0]} -> {h[-1]}")
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    with torch.no_grad():
        _, off = rollout(zero, prob, y0.to(dev), 0.0, 20)
        _, on = rollout(params, prob, y0.to(dev), 0.0, 20)
    check(on["rms_pos_err"].item() < 0.8 * off["rms_pos_err"].item(),
          "the trained controller does not beat free fall")
    print(f"  train_controller (9 sats, 20 x 4 dopri5 substeps, {iters} "
          f"iterations, f64): card {t_card:.1f} s ({t_card / iters:.3f} "
          f"s/iteration), CPU {t_cpu:.1f} s | loss {h[0]:.3f} -> "
          f"{h[-1]:.3f}, card vs CPU {rel:.2e} relative | rms "
          f"{info['rms_pos_err']:.3f} m (free fall "
          f"{off['rms_pos_err'].item():.3f} m), dv/sat "
          f"{info['dv_per_sat']:.5f} m/s", flush=True)


def slice8_paths(torch):
    """Phases 20a-c; their CPU references run during 20a in one worker
    process (`slice8_cpu_side`), which 20b awaits before its card side
    and which stops with the phase.  Returns B3's launches (20a's demo-LM
    training)."""
    gc.collect()
    torch.cuda.empty_cache()
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        cpu = pool.submit(slice8_cpu_side)
        phase("phase 20a: the SDC injector (card vs CPU flips; demo LM at "
              "full width under a forced burst; the launcher at 2e3 and "
              "1e5)")
        b3 = sdc_phase(torch)
        check(b3 > 0, "B3 never launched under the SDC injector")
        phase("phase 20b: the J2 orbit in float64 on the card")
        orbit_phase(torch, cpu)
        phase("phase 20c: the formation controller in float64 on the card")
        control_phase(torch, cpu)
    return b3


def _quickstart_launches(out):
    """B3 launches quickstart.py must print: 2 x n_layers (the forward and
    the remat recompute) for every train step its trainer ran, the steps
    it kept plus the one it threw away before each rollback."""
    from repro_torch.models import registry
    n_layers = registry.get_reduced_config("suncatcher-lm-100m").n_layers
    steps = _printed_count(r"(?m)^steps: ", out, "quickstart.py")
    rollbacks = _printed_count(r"'rollbacks': ", out, "quickstart.py")
    return 2 * n_layers * (steps + rollbacks), \
        f"2 x {n_layers} layers x ({steps} steps + {rollbacks} rollbacks)"


def _serve_batch_launches(out):
    """B1 launches serve_batch.py must print: n_layers for every decode
    sub-step, decode_block sub-steps in each decode block it ran."""
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig
    n_layers = registry.get_reduced_config("suncatcher-lm-100m").n_layers
    blocks = _printed_count(r"'decode_blocks': ", out, "serve_batch.py")
    sub = blocks * EngineConfig().decode_block
    return n_layers * sub, f"{n_layers} layers x {sub} sub-steps"


def _train_100m_launches(out):
    """B3 launches `train_100m.py --full --steps 16 --inner 8` must print:
    2 x n_layers for each of 2 rounds x 2 pods x 8 inner steps."""
    from repro_torch.models import registry
    n_layers = registry.get_config("suncatcher-lm-100m").n_layers
    steps = (16 // 8) * 2 * 8
    return 2 * n_layers * steps, f"2 x {n_layers} layers x {steps} steps"


# phase 23: the five examples (script, arguments, sentinel line, and the
# kernel whose launches it prints: its name, the printed text before the
# count, and the count it must be, from the example's output)
EXAMPLES = (
    ("quickstart.py", (),
     "OK: loss decreased under injected radiation faults",
     ("B3", r"flash-attention kernel launches ", _quickstart_launches)),
    ("serve_batch.py", (), "OK: 10 requests served through 4 slots",
     ("B1", r"decode-attention kernel launches: dense ",
      _serve_batch_launches)),
    ("train_100m.py", ("--full", "--steps", "16", "--inner", "8"),
     "OK: DiLoCo training complete",
     ("B3", r"flash-attention kernel launches ", _train_100m_launches)),
    ("constellation_design.py", (), "launch economics", None),
    ("formation_flight.py", ("--iters", "6", "--intervals", "8"),
     "OK: learned controller beats free fall", None))
# the runner's entries that phase 23 does not run through its CLI: Fig. 2
# and the J2 drift ran in phase 20b, diloco_traffic runs in this process
# (its B3 launches are counted here)
RUNNER_SKIP = ("fig2_constellation", "j2_drift", "diloco_traffic")
# what the micro DiLoCo run of diloco_traffic must give exactly on the
# card and the CPU: mask counts and the orbit profile
MASK_COUNTS = ("rounds_survived", "masked_pod_fraction",
               "straggler_pod_rounds", "outage_pod_rounds",
               "mask_transitions", "orbit_masked_pod_fraction",
               "orbit_mask_transitions", "round_time_s", "round_deadline_s")


def paper_cpu_side():
    """Phase 23's CPU reference, run in a worker process while the card
    works: diloco_traffic's micro DiLoCo run (`_constellation_stats`) on
    the CPU in bf16 (the entry's) and in f32, each timed."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch

    from repro_torch.paper.diloco_traffic import _constellation_stats
    torch.set_num_threads(1)
    out = {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        out[dtype] = _constellation_stats("cpu", compute_dtype=dtype)
        out[dtype + " s"] = time.perf_counter() - t0
    return out


def diloco_entry_phase(torch, cpu):
    """Phase 23: the paper's diloco_traffic entry on the card: its micro
    DiLoCo run (the reduced demo LM at 2 layers, d 32, head_dim 16, which
    B3 runs zero-padded to 64; 12 rounds of 2 pods x 4 steps under the
    supervisor with constellation masks) gives every mask count and the
    orbit profile of the CPU port's run exactly, and its bf16 losses
    within 2^-8 relative (one bf16 ulp) of the CPU's; the same run in f32
    gives the CPU's f32 counts exactly and losses within 1e-3 (phase 22's
    limit).  Returns B3's launches in the entry's run."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.paper import diloco_traffic
    dev = torch.device("cuda")
    flash_attention.launches = 0
    t0 = time.perf_counter()
    lines, rows = diloco_traffic.run(device=dev)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    launches = flash_attention.launches
    # 2 x n_layers (forward and remat recompute) a step; every pod runs its
    # inner steps in every round, masked or not
    n_layers = diloco_traffic.MICRO["n_layers"]
    rounds = rows["constellation"]["rounds_survived"]
    want = 2 * n_layers * 2 * 4 * rounds
    check(launches == want, f"B3 launched {launches} times in "
          f"diloco_traffic's run, want 2 x {n_layers} layers x 2 pods x 4 "
          f"inner steps x {rounds} rounds = {want}")
    t0 = time.perf_counter()
    f32 = diloco_traffic._constellation_stats(dev, compute_dtype="float32")
    t_f32 = time.perf_counter() - t0
    ref = cpu.result()
    losses = ("first_loss", "last_loss")
    for dtype, got in (("bfloat16", rows["constellation"]),
                       ("float32", f32)):
        want = ref[dtype]
        bad = {k: (got[k], want[k]) for k in MASK_COUNTS
               if got[k] != want[k]}
        check(not bad, f"diloco_traffic {dtype}: card vs CPU mask counts "
              f"{bad}")
    got, want = rows["constellation"], ref["bfloat16"]
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in losses)
    err = max(abs(f32[k] - ref["float32"][k]) for k in losses)
    check(rel <= 2.0 ** -8, f"diloco_traffic bf16 losses card vs CPU: "
          f"{rel} relative (limit 2^-8)")
    check(err <= 1e-3, f"diloco_traffic f32 losses card vs CPU: {err} "
          f"(limit 1e-3)")
    for name, _, derived in lines:
        print(f"    {name}: {derived}", flush=True)
    print(f"  paper entry diloco_traffic on the card: {t_bf16:.2f} s (CPU "
          f"{ref['bfloat16 s']:.2f} s), B3 launched {launches} times | mask "
          f"counts and orbit profile == the CPU's (bf16 and f32) | bf16 "
          f"loss {got['first_loss']:.4f} -> {got['last_loss']:.4f} (CPU "
          f"{want['first_loss']:.4f} -> {want['last_loss']:.4f}), "
          f"{rel:.3e} relative (limit 2^-8) | f32 loss "
          f"{f32['first_loss']:.4f} -> {f32['last_loss']:.4f}, card vs CPU "
          f"{err:.3e} (limit 1e-3; card {t_f32:.2f} s, CPU "
          f"{ref['float32 s']:.2f} s)", flush=True)
    return launches


def check_runs(results):
    """Phase 23's subprocesses: the paper runner (its host entries'
    lines equal to the same entries run here) and the five examples (exit
    0, sentinel, launches where they train or serve).  Returns {"B1": n,
    "B3": n} summed over the examples."""
    import importlib

    from repro_torch.paper import ENTRIES
    (rc, out, err, dt), results = results[0], results[1:]
    check(rc == 0, f"python -m repro_torch.paper exited {rc}:\n"
          f"{err[-3000:]}")
    want = [f'{n},"{d}"' for name in ENTRIES if name not in RUNNER_SKIP
            for n, _, d in
            importlib.import_module(f"repro_torch.paper.{name}").run()[0]]
    lines = out.splitlines()
    got = [re.sub(r",[\d.]+,", ",", ln, count=1) for ln in lines[1:]]
    check(lines[:1] == ["name,us_per_call,derived"] and got == want,
          f"the paper runner printed:\n{out[-3000:]}\nwant:\n"
          + "\n".join(want))
    print(f"  python -m repro_torch.paper --skip {','.join(RUNNER_SKIP)} "
          f"(cuda): exit 0 in {dt:.1f} s, its {len(got)} host lines == the "
          f"entries' here", flush=True)
    for ln in lines[1:]:
        print(f"    {ln[:300]}", flush=True)
    counts = {"B1": 0, "B3": 0}
    for (name, args, sentinel, kernel), (rc, out, err, dt) in zip(
            EXAMPLES, results):
        cmd = " ".join(("examples/torch_port/" + name,) + args)
        check(rc == 0, f"{cmd} exited {rc}:\n{err[-3000:]}")
        check(sentinel in out, f"{cmd}: no {sentinel!r} in:\n{out[-2000:]}")
        seen = ""
        if kernel is not None:
            n = _printed_count(kernel[1], out, cmd)
            want, how = kernel[2](out)
            check(n == want, f"{cmd}: {kernel[0]} launched {n} times, want "
                  f"{want} ({how})")
            counts[kernel[0]] += n
            seen = f", {kernel[0]} launched {n} times"
        print(f"  {cmd} (cuda): exit 0 in {dt:.1f} s{seen}", flush=True)
        for ln in [ln for ln in out.splitlines() if ln.strip()][-3:]:
            print(f"    {ln.strip()[:300]}", flush=True)
    return counts


def analytic_line(block_s, smi):
    """Phase 23: the analytic roofline of phase 5's train step (the demo
    LM at full width, batch 8, seq 1024, one chip) priced at H100_SXM,
    beside phase 5's measured fused-block step time (None where phase 5
    did not run) and useful_flops / (step time x peak)."""
    from repro_torch.analysis import analytic_roofline, useful_flops
    from repro_torch.core import H100_SXM
    from repro_torch.models import registry
    cfg = registry.get_config("suncatcher-lm-100m")
    batch, seq, k = 8, 1024, 8
    t = analytic_roofline(cfg, "train", batch, seq, chips=1, data_shards=1,
                          model_shards=1, chip=H100_SXM)
    useful = useful_flops(cfg, "train", batch, seq)
    print(f"  analytic roofline, {cfg.name} train step (batch {batch}, seq "
          f"{seq}, 1 chip) at {H100_SXM.name} "
          f"({H100_SXM.peak_bf16_flops:.4g} FLOP/s bf16, "
          f"{H100_SXM.hbm_bytes_per_s:.4g} B/s): compute "
          f"{t['compute_s'] * 1e3:.3f} ms ({t['flops_per_device']:.4e} "
          f"FLOPs), memory {t['memory_s'] * 1e3:.3f} ms "
          f"({t['bytes_per_device']:.4e} B), bound "
          f"{t['step_time_s'] * 1e3:.3f} ms ({t['dominant']}); useful_flops "
          f"{useful:.4e}", flush=True)
    if block_s is None:
        print("  measured step: phase 5 did not run", flush=True)
        return
    step = block_s / k
    print(f"  measured, phase 5's fused block of {k} steps / {k}: "
          f"{step * 1e3:.3f} ms a step = {step / t['step_time_s']:.2f}x the "
          f"analytic bound; useful_flops / (step time x peak) = "
          f"{useful / (step * H100_SXM.peak_bf16_flops):.4f} | card {smi}",
          flush=True)


def paper_paths(torch, block_s, smi):
    """Phase 23: the paper runner's CLI and the five examples, each a
    process of its own on the card, side by side, while this process runs
    the diloco_traffic entry on the card and a worker its CPU reference;
    then the analytic roofline line.  Returns {"B1": n, "B3": n}: the
    examples' launches plus the entry's B3."""
    gc.collect()
    torch.cuda.empty_cache()
    root = "examples/torch_port/"
    runs = [("-m", "repro_torch.paper", "--skip", ",".join(RUNNER_SKIP))]
    runs += [(root + name, *args) for name, args, _, _ in EXAMPLES]
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=spawn) as pool, \
            ThreadPoolExecutor(1) as threads:
        cpu = pool.submit(paper_cpu_side)
        procs = threads.submit(_launchers, runs)
        b3 = diloco_entry_phase(torch, cpu)
        counts = check_runs(procs.result())
    counts["B3"] += b3
    analytic_line(block_s, smi)
    return counts


PAPER_TITLE = ("phase 23: the paper's entries and the five examples on the "
               "card; the analytic roofline of phase 5's step")

MESH_TITLE = ("phase 24: the port on a device mesh: a one-rank NCCL mesh, "
              "the outer sync at (2, 16, 16) and stablelm-12b train_4k at "
              "(16, 16) on fake groups, rank 0 on the card")

# the reference's checked-in dry run of the demo LM's outer sync
# (benchmarks/results/dryrun/diloco_outer_suncatcher-lm-100m_*_multi.json):
# per-rank bytes by op and dtype
OUTER_SYNC_BYTES = {
    "none": {"all-reduce": {"f32": 1649664}},
    "int8": {"all-gather": {"s8": 824832, "f32": 12888}},
    "topk": {"all-gather": {"f32": 32968, "s32": 32968}},
}


def mesh_step_phase(torch):
    """24a: the one-rank NCCL mesh.  Returns B3's launches through the
    sharded step."""
    import torch.distributed as dist

    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.distributed.compression import wire_format_for
    from repro_torch.distributed.hints import on_mesh
    from repro_torch.distributed.sharding import (gather_full,
                                                  param_shapes, param_specs)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import registry
    from repro_torch.train import (AdamWConfig, DataConfig, DiLoCoConfig,
                                   SyntheticLM, TrainConfig, diloco_init,
                                   init_train_state, make_diloco_round,
                                   make_sharded_train_step, make_train_step,
                                   outer_step, shard_diloco_state)
    from repro_torch.train.tree import tree_leaves, tree_paths
    dev = torch.device("cuda")
    meshes.init_process_group("cuda")
    try:
        mesh = meshes.make_test_mesh(device_type="cuda")
        check(dist.get_backend() == "nccl" and tuple(mesh.shape) ==
              (1, 1, 1), f"not a one-rank nccl mesh: {dist.get_backend()} "
              f"{tuple(mesh.shape)}")
        print(f"  mesh {tuple(mesh.shape)} {dist.get_backend()} "
              f"{mesh.mesh_dim_names}", flush=True)
        cfg = registry.get_config("suncatcher-lm-100m")
        fns = registry.model_fns(cfg)
        seq, batch = 1024, 8
        tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3), warmup_steps=1,
                           total_steps=16)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch,
                                      seed=0), dev)
        state0 = init_train_state(torch.Generator().manual_seed(0), cfg,
                                  fns, dev)

        def leaves_equal(a, b):
            pa, pb = tree_paths(a), tree_paths(b)
            return list(pa) == list(pb) and all(
                pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k])
                for k in pa)

        plain = make_train_step(cfg, fns, tcfg)
        sharded = make_sharded_train_step(cfg, fns, tcfg, mesh)
        a, b, la, lb, secs = state0, state0, [], [], []
        for i in range(2):
            a, ma = plain(a, data.batch_at(i))
            la.append(ma["loss"])
        flash_attention.launches = 0
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b, mb = sharded(b, data.batch_at(i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            lb.append(mb["loss"])
        launches = flash_attention.launches
        print(f"  sharded step: {secs[0]:.2f} s (first, DTensor sharding "
              f"propagation included), {secs[1]:.3f} s (second) | losses "
              f"{[round(x.item(), 6) for x in lb]} | B3 launches "
              f"{launches}", flush=True)
        check(launches == 2 * 2 * cfg.n_layers,
              f"B3 launched {launches} times through the DTensor path, "
              f"want 24 a step")
        check(all(torch.equal(x, y) for x, y in zip(la, lb)),
              f"sharded losses {lb} != plain {la}")
        check(leaves_equal(a, gather_full(b)),
              "the sharded step's state differs from the plain step's")
        print("  make_sharded_train_step == make_train_step: 2 steps, "
              "losses and every state leaf bitwise", flush=True)

        dcfg = DiLoCoConfig(n_pods=2, inner_steps=2)
        params = fns.init(torch.Generator().manual_seed(1), cfg, dev)
        d0 = diloco_init(params, dcfg, compress="int8", screen_window=8)
        steps = torch.arange(4, device=dev).reshape(2, 2)
        mask = torch.ones(2, device=dev)
        thr = torch.tensor([3.0, 10.0], device=dev)
        kw = dict(compress="int8", data=data, screen_window=8,
                  supervise=True)
        r0 = make_diloco_round(cfg, fns, tcfg, dcfg, **kw)
        r1 = make_diloco_round(cfg, fns, tcfg, dcfg, mesh=mesh, **kw)
        x, mx = r0(d0, steps, mask, thr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, my = r1(d0, steps, mask, thr)
        torch.cuda.synchronize()
        t_round = time.perf_counter() - t0
        fy = gather_full(y)
        bad = [k for k in ("global_params", "outer_m", "pod_params",
                           "pod_opt", "pod_ef", "screen", "step")
               if not leaves_equal(x[k], fy[k])]
        check(not bad, f"the mesh round differs from the unmeshed at {bad}")
        check(all(torch.equal(mx[k], my[k]) for k in mx),
              "the mesh round's metrics differ")
        print(f"  make_diloco_round(mesh=, int8) == unmeshed: 2 pods x H 2, "
              f"state and metrics bitwise ({t_round:.2f} s)", flush=True)

        fmt = wire_format_for(param_shapes(cfg), param_specs(cfg), mesh,
                              dcfg.n_pods, method="int8")
        check(fmt.mesh is mesh, "the wire format did not take the mesh")
        ds = shard_diloco_state(d0, cfg, mesh)
        with on_mesh(mesh), CollectiveCounter() as cc:
            outer_step(ds, dcfg, wire=fmt)
        torch.cuda.synchronize()
        coll = cc.collective_bytes()
        n_leaves = len(tree_leaves(params))
        print(f"  wire hop on NCCL: {coll['counts']} | bytes by dtype "
              f"{coll['bytes_by_dtype']}", flush=True)
        check(coll["counts"] == {"all-gather": 2 * n_leaves},
              f"want two all-gathers per wire leaf ({2 * n_leaves}), got "
              f"{coll['counts']}")
        check(set(coll["bytes_by_dtype"]["all-gather"]) == {"s8", "f32"},
              "the hop gathered other dtypes than the int8 payload")
        del a, b, x, y, fy, ds, d0, params, state0
    finally:
        meshes.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def flash_local_check(torch):
    """B3 `_dh160` at the local shape 24c's step gives it on a rank of
    (16, 16): q (8, 4096, 2, 160), the rank's 2 of 32 query heads; k and
    v one KV head narrowed out of the 8 replicated ones, as
    `heads_local_map` narrows them (Hkv 1, a position stride of 8 x 160).
    Rank 0 reads KV head 0, rank 15 head 7 (the largest offset).  Against
    the plain version at the bf16 limit; returns the max abs err."""
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4096)
    q = torch.randn(8, 4096, 2, 160, generator=g).to(dev, torch.bfloat16)
    kv = [torch.randn(8, 4096, 8, 160, generator=g).to(dev, torch.bfloat16)
          for _ in range(2)]
    worst = 0.0
    for kvh in (0, 7):
        k, v = (t.narrow(2, kvh, 1) for t in kv)
        check(not k.is_contiguous() and k.stride(1) == 8 * 160,
              f"k is not the narrowed view: strides {k.stride()}")
        out = flash_attention(q, k, v, causal=True)
        again = flash_attention(q, k, v, causal=True)
        ref = attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True
                                  ).transpose(1, 2)
        torch.cuda.synchronize()
        err, share = plain_close(out, ref, "bfloat16")
        tag = (f"B3 at 24c's local shape B=8 H=2 Hkv=1 (KV head {kvh} of 8, "
               f"narrowed) S=4096 dh=160 bfloat16 causal")
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite")
        check(share <= 1, f"{tag}: max abs err {err}, {share:.3f} of its "
              f"limit")
        check(torch.equal(out, again), f"{tag}: two calls differ")
        print(f"  {tag}: max abs err {err:.3e} ({share:.3f} of the limit); "
              f"two calls bitwise equal", flush=True)
        worst = max(worst, err)
    del q, kv, k, v, out, again, ref
    torch.cuda.empty_cache()
    return worst


def mesh_dryrun_phase(torch, smi, out_dir, estimate):
    """24b and 24c.  `estimate` is the future of the fake-mode dry run of
    24c's cell, run in a process of its own meanwhile.  Returns B3's
    dh-160 launches in 24c's card run and its max abs err at 24c's local
    shape."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import dryrun
    for mode in ("none", "int8", "topk"):
        r = dryrun.run_outer_sync_cell(compress=mode, device="cuda",
                                       out_dir=out_dir)
        dryrun.check_outer_sync(r)
        check(r["collectives"]["bytes_by_dtype"] == OUTER_SYNC_BYTES[mode],
              f"{mode}: per-rank bytes {r['collectives']['bytes_by_dtype']}"
              f" != the reference's {OUTER_SYNC_BYTES[mode]}")
        print(f"  outer sync {mode}: per rank {r['collectives']['bytes']} "
              f"B by dtype {r['collectives']['bytes_by_dtype']} | per pod "
              f"{r['per_pod_wire_bytes']} B vs predicted "
              f"{r['predicted_outer_wire_bytes_per_pod']} B = "
              f"{r['per_pod_over_predicted']}x (budget "
              f"{r['budget_factor']}x, --check passes) | "
              f"{r['seconds']:.2f} s ({r['step_seconds']:.3f} s the hop) | "
              f"{smi}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    err = flash_local_check(torch)
    t1 = time.perf_counter()
    flash_attention.launches = 0
    real = dryrun.run_cell("stablelm-12b", "train_4k", False, out_dir,
                           device="cuda", chip="h100", verbose=False)
    launches = flash_attention.launches
    t2 = time.perf_counter()
    (rc, stdout, stderr, est_s), = estimate.result()
    check(rc == 0, f"the fake-mode dry run of stablelm-12b train_4k "
          f"failed ({rc}):\n{stdout[-2000:]}\n{stderr[-4000:]}")
    with open(os.path.join(out_dir, "fake",
                           "stablelm-12b_train_4k_single.json")) as f:
        est = json.load(f)
    print(f"  24c: the card run took {t2 - t1:.1f} s (its step "
          f"{real['seconds']:.2f} s); the fake-mode estimate, in a process "
          f"of its own since phase 24 began, {est_s:.1f} s, waited on "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    want = 2 * 40 * 2
    a = real["analytic"]
    ratio = real["own_peak_bytes"] / est["memory_peak_bytes"]
    print(f"  stablelm-12b train_4k, rank 0 of (16, 16): "
          f"max_memory_allocated {real['max_memory_allocated'] / 2**30:.2f}"
          f" GiB, the step's own peak (its state included, what earlier "
          f"phases left out) {real['own_peak_bytes'] / 2**30:.2f} GiB vs "
          f"the fake-mode MemTracker estimate "
          f"{est['memory_peak_bytes'] / 2**30:.2f} GiB (ratio {ratio:.3f}; "
          f"by category {est['memory_peak']}) | FLOPs per rank "
          f"{est['flops']['total'] / 1e12:.2f} T (aten "
          f"{est['flops']['aten'] / 1e12:.2f} T + kernels "
          f"{est['flops']['kernels'] / 1e12:.2f} T) vs analytic "
          f"{a['flops_per_device'] / 1e12:.2f} T | collective wire "
          f"{est['collectives']['wire_bytes'] / 2**30:.1f} GiB/rank | "
          f"step {real['seconds']:.2f} s on the card vs the analytic "
          f"roofline {a['step_time_s']:.3f} s ({a['dominant']}) at "
          f"H100_SXM | B3 launches {launches} | {smi}", flush=True)
    check(launches == want, f"B3 launched {launches} times in stablelm's "
          f"rank-0 step, want {want}")
    check(est["flops"]["per_kernel"]["flash_attention"]["calls"] == want,
          "the fake run counted another number of B3 calls")
    # the estimate counts the rank's own program only (the dry run's
    # MemTracker leaves DTensor's global-shape inference out on every
    # torch version); the card's peak includes the allocator's rounding
    check(0.8 <= ratio <= 1.25, f"the card's own peak is {ratio:.3f}x the "
          f"fake-mode estimate, outside 0.8-1.25x")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, err


def mesh_paths(torch, smi):
    """Phase 24; returns {"B3": 24a's launches, "B3_dh160": 24c's,
    "B3_dh160_err": B3's max abs err at 24c's local shape}.  24c's
    fake-mode estimate (host work only, ~30 s) runs in a process of its
    own beside 24a and 24b."""
    from repro_torch.launch.dryrun import RESULTS_DIR as out_dir
    est_run = ("-m", "repro_torch.launch.dryrun", "--arch", "stablelm-12b",
               "--shape", "train_4k", "--mesh", "single", "--chip", "h100",
               "--out", os.path.join(out_dir, "fake"))
    with ThreadPoolExecutor(1) as threads:
        estimate = threads.submit(_launchers, [est_run], 300)
        print("  24a: one-rank NCCL mesh", flush=True)
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            b3 = mesh_step_phase(torch)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
        print("  24b/24c: fake process groups, rank 0 on the card",
              flush=True)
        t0 = time.perf_counter()
        b3_dh160, err = mesh_dryrun_phase(torch, smi, out_dir, estimate)
        print(f"  24b/24c took {time.perf_counter() - t0:.1f} s",
              flush=True)
    return {"B3": b3, "B3_dh160": b3_dh160, "B3_dh160_err": err}


def main(argv):
    import torch
    only_2c = argv == ["--phase", "2c"]
    only_new = argv == ["--phase", "8"]
    only_plane = argv == ["--phase", "11"]
    only_family = argv == ["--phase", "14"]
    only_branch = argv == ["--phase", "17"]
    only_slice8 = argv == ["--phase", "20"]
    only_family_train = argv == ["--phase", "21"]
    only_paper = argv == ["--phase", "23"]
    only_mesh = argv == ["--phase", "24"]
    if argv and not (only_2c or only_new or only_plane or only_family
                     or only_branch or only_slice8 or only_family_train
                     or only_paper or only_mesh):
        print("usage: chip_smoke.py [--phase 2c | --phase 8 | --phase 11 | "
              "--phase 14 | --phase 17 | --phase 20 | --phase 21 | "
              "--phase 23 | --phase 24]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.decode_attention import kernel as b12
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.rglru_scan import kernel as b4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    phase("phase 1: build")
    libs = (b12.LIBRARY, b3.LIBRARY, b4.LIBRARY)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs]:
            f.result()
    for lib in libs:
        print(f"  {lib.source.name}: nvcc build {lib.seconds:.1f} s",
              flush=True)
        if not lib.log:
            print("    cached build: ptxas checks not run", flush=True)
        entry = ""
        for ln in lib.log.splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", ln)
            if found:
                entry = found.group(1)
                short = re.search(r"_cu_\w{8}\d+(\w+?)E{2,3}v", entry)
                print(f"  {short.group(1) if short else entry}:", flush=True)
            elif "registers" in ln or "spill" in ln:
                print("    " + ln.strip(), flush=True)
            elif "C7513" in ln or "C7508" in ln:   # wgmma / setmaxnreg
                # only B3's bf16 kernel uses either; the warning line
                # need not name the function
                print("    " + ln.strip(), flush=True)
                fail(f"{lib.source.name}: {ln.strip()}")
            # the bf16 B3 instances (wgmma, registers at the setmaxnreg
            # ceiling) must not spill
            if "spill" in ln and "flash_fwd_tc" in entry:
                check(" 0 bytes spill stores, 0 bytes spill loads" in ln,
                      f"B3's bf16 kernel spills: {ln.strip()}")

    timer = Timer(torch)
    if only_new:
        new_paths(torch)
        print("phases 8-10 alone: no result line")
        return 0
    if only_plane:
        plane_paths(torch)
        print("phases 11-13 alone: no result line")
        return 0
    if only_family:
        phase("phase 2: B1/B2 at granite-moe's decode widths (H 16, Hkv 8)")
        kernel_phase(torch, timer, 16, 8, ((16, 512, 232, 256),), "_h16")
        family_paths(torch)
        print("phases 14-16 alone: no result line")
        return 0
    if only_branch:
        phase("phase 2: B1/B2 at the decode widths of phase 17; 2b: B3 at "
              "the training widths of phase 18")
        new_rows = branch_rows(torch, timer)
        for n, count in branch_paths(torch).items():
            new_rows[n]["launches"] = count
        phase()
        print(json.dumps({"kernels": list(new_rows.values())}))
        print("phases 17-19 alone: no result line")
        return 0
    if only_slice8:
        slice8_paths(torch)
        phase()
        print("phase 20 alone: no result line")
        return 0
    if only_family_train:
        phase("phase 2b and 2c, new rows: B3 at granite-moe's training "
              "widths, B4's backward")
        fam_rows = family_rows(torch, timer)
        fam = family_train_paths(torch)
        fam_rows["flash_attention_h16"]["launches"] = fam["B3"]
        fam_rows["rglru_scan_bwd"]["launches"] = fam["B4 bwd"]
        phase()
        print(json.dumps({"kernels": list(fam_rows.values())}))
        print(f"phases 21-22 alone: B4 forward launches {fam['B4']}; no "
              f"result line")
        return 0
    if only_paper:
        phase(PAPER_TITLE)
        print(f"  launches: {paper_paths(torch, None, smi)}", flush=True)
        phase()
        print("phase 23 alone: no result line")
        return 0
    if only_mesh:
        phase(MESH_TITLE)
        print(f"  launches: {mesh_paths(torch, smi)}", flush=True)
        phase()
        print("phase 24 alone: no result line")
        return 0
    if only_2c:
        phase("phase 2c: RG-LRU scan kernel vs plain version; B1 at "
              "head_dim 256")
        print(json.dumps({"kernels": rglru_kernel_phase(torch, timer)}))
        print("phase 2c alone: no main path driven, no result line")
        return 0
    phase("phase 2: kernels vs plain versions")
    rows = kernel_phase(torch, timer)
    print("  granite-moe's decode widths (H 16, Hkv 8: a GQA group of 2):",
          flush=True)
    rows_h16 = kernel_phase(torch, timer, 16, 8, ((16, 512, 232, 256),),
                            "_h16")
    phase("phase 2b: flash-attention kernel vs plain version")
    rows.extend(flash_phase(torch, timer, ("flash_attention",)))
    phase("phase 2c: RG-LRU scan kernel vs plain version; B1 at head_dim "
          "256")
    rows.extend(rglru_kernel_phase(torch, timer))
    rows.extend(rows_h16)                    # rows 7 and 8
    phase("phase 2 and 2b, new rows: B1/B2 at the decode widths of phase "
          "17, B3 at the training widths of phase 18")
    new_rows = branch_rows(torch, timer)
    phase("phase 2b and 2c, new rows: B3 at granite-moe's training widths, "
          "B4's backward")
    fam_rows = family_rows(torch, timer)

    phase("phase 3: serve suncatcher-lm-100m (full width, bf16)")
    totals = serve_phase(torch)
    rows[0]["launches"], rows[1]["launches"] = totals
    check(all(r["launches"] > 0 for r in rows[:2]),
          "a decode kernel never launched")

    phase("phase 4: reference check")
    reference_phase(torch)

    phase("phase 5: train suncatcher-lm-100m (full width, bf16, seq 1024, "
          "batch 8)")
    # deterministic kernels, without the NaN fill of every fresh
    # allocation (no kernel of the path reads memory it did not write)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        rows[2]["launches"], block_s = train_phase(torch)
        train_reference(torch)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    check(rows[2]["launches"] > 0, "the flash kernel never launched")
    torch.cuda.empty_cache()

    phase("phase 6: serve recurrentgemma-2b (full width, bf16)")
    (rows[3]["launches"], rows[4]["launches"], rows[5]["launches"],
     rows[6]["launches"]) = rglru_serve_phase(torch)
    check(all(r["launches"] > 0 for r in rows[3:7]),
          "B4 or B1 never launched serving recurrentgemma-2b")

    phase("phase 7: recurrentgemma reference check")
    rglru_reference(torch)
    torch.cuda.empty_cache()

    b3, b1 = new_paths(torch)
    rows[2]["launches"] += b3
    rows[0]["launches"] += b1
    torch.cuda.empty_cache()

    b1, b2, b1_256, b4 = plane_paths(torch)
    rows[0]["launches"] += b1
    rows[1]["launches"] += b2
    rows[5]["launches"] += b1_256
    rows[3]["launches"] += b4
    torch.cuda.empty_cache()

    rows[7]["launches"], rows[8]["launches"] = family_paths(torch)
    torch.cuda.empty_cache()

    for n, count in branch_paths(torch).items():
        new_rows[n]["launches"] = count
    rows.extend(new_rows.values())
    torch.cuda.empty_cache()

    rows[2]["launches"] += slice8_paths(torch)
    torch.cuda.empty_cache()

    fam = family_train_paths(torch)
    fam_rows["flash_attention_h16"]["launches"] = fam["B3"]
    fam_rows["rglru_scan_bwd"]["launches"] = fam["B4 bwd"]
    rows[3]["launches"] += fam["B4"]         # B4's training forwards
    rows.extend(fam_rows.values())
    torch.cuda.empty_cache()

    phase(PAPER_TITLE)
    paper = paper_paths(torch, block_s, smi)
    rows[0]["launches"] += paper["B1"]       # serve_batch (dh 16 -> 64)
    rows[2]["launches"] += paper["B3"]       # diloco_traffic, the examples
    gc.collect()
    torch.cuda.empty_cache()

    phase(MESH_TITLE)
    mesh = mesh_paths(torch, smi)
    rows[2]["launches"] += mesh["B3"]        # 24a, through local_map
    named = {r["name"]: r for r in rows}
    named["flash_attention_dh160"]["launches"] += mesh["B3_dh160"]
    named["flash_attention_dh160"]["max_abs_err"] = max(
        named["flash_attention_dh160"]["max_abs_err"], mesh["B3_dh160_err"])
    check(all(r.get("launches", 0) > 0 for r in rows),
          "a kernel row was never launched on its main path")

    phase()
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in ("path",) if k in r}}
        for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
