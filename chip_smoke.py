#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --resume-child ckpt|resume DIR [OUT]
                                      # phase 13's child processes
    python3 chip_smoke.py --ranks     # phases 1-2, phase 3's decode rows
                                      # and the rank phases 21, 22, 25
    python3 chip_smoke.py --ranks-child RANK WORLD STORE OUT
                                      # the rank phases' ranks
    python3 chip_smoke.py --strict-rates
                                      # phases 1-2, then the warm rounds/s
                                      # of the strict_numerics routes
    python3 chip_smoke.py --serve-rate
                                      # phases 1-2, then phase 14's serve's
                                      # eager ms a decode step
    python3 chip_smoke.py --zoo       # phases 1-2, phase 3's decode rows
                                      # and phases 23-24 alone
    python3 chip_smoke.py --mla-ssm   # phases 1-2 and 26 alone
    python3 chip_smoke.py --hybrid    # phases 1-2, phase 3's decode rows
                                      # and phase 27 alone
    python3 chip_smoke.py --frontends # phases 1-2, phase 3's decode rows
                                      # and phase 28 alone
    python3 chip_smoke.py --layouts   # phases 1-2, phase 3's decode rows
                                      # and phase 29 alone (its (b) in a
                                      # spawn of 2 ranks of its own)
    python3 chip_smoke.py --remat     # phases 1-2 and 30 alone
    python3 chip_smoke.py --heads     # phases 1-2 and 31 alone (a spawn
                                      # of 16 ranks)
    python3 chip_smoke.py --draws     # phases 1-2 and 32 alone
    python3 chip_smoke.py --graphs    # phases 1-2 and 33 alone
    python3 chip_smoke.py --profile   # phases 1-3, then a torch.profiler
                                      # breakdown of a warm Fig. 3 sweep,
                                      # defense grid, U = 1000 grid,
                                      # showdown grid, LM lane, qwen3-4b
                                      # serve decode step and train step,
                                      # and one moonshot (MoE) decode step

Needs one CUDA card, nvcc, and this checkout.  Phases, one JSON line each
(the rank phases 21, 22 and 25 share one spawn of 2 ranks and one of 4,
`--ranks-child`, and run before 23, 24 and 26):

  1. device   card name and power limit (also printed raw), torch/CUDA
              versions; TF32 off, as the float32 reference needs.
  2. build    nvcc builds every kernel of csrc/ (seconds, ptxas -v lines),
              and the registers, shared memory and spills of the kernels
              redesigned for Hopper (decode_mma_kernel, bitonic_kernel,
              floa_combine_kernel, grad_stats_kernel, segment_parts_kernel,
              segment_fold_kernel), one per instance.
  3. kernels  the launch floor (`floor_ms`: one near-empty kernel, graph-
              replayed), then each kernel against its plain PyTorch version
              at every main-path shape (the FLOA kernels at [3|4|2|1, 10,
              D] and [1, 1000, D], grad_stats at 10-40 and 1000 rows) and
              at awkward ones (D off any tile, U = 32,
              bf16, S = 1; for the sorts U = 7, 33, 100, 4097 and the
              bitonic cap, 8192, and U = 4097 at full width (several
              warps per column; +inf-padded columns, the K-of-U
              defenses' slabs, for both sorts), the showdown's shapes (the
              combine at [36, 10, D], grad_stats at 360 rows, the odd-even
              sort at [8, 10, D] with +inf rows, and at the trainer's
              [10, D]), the plan phase's (the switch dispatch's combine at
              [6, 10, D], grad_stats at 60 rows and sort at [6, 10, D];
              `grad_stats_segments`, the strict route, over the paper
              MLP's four leaf segments at 10, 40, 60 and 1000 rows and
              the LM lane's 14 at 16, and on each leaf segment alone);
              for decode
              attention decode_32k's
              per-layer shape [128, 32768], the long-cache and serve
              shapes, the zoo's serve shapes (G = 12, 5 and 1), a rank's
              half of the serve batch (phase 22), long_500k's
              rings of 8192 and 4096 slots at pos 524 287, S = 777, MQA,
              MHA, dh 32/64, f32, pos = 0 and mid-cache; at dh 256 the
              hybrid's serve [8, 64, H16, KV1] and long_500k ring
              [1, 2048, H16, KV1] in bf16 and f32, and a rank's heads on
              (1, 2), [8, 64, H8, KV1]; the frontends' seamless decode
              [8, 64, H16, KV16, 64] and its cross-attention [8, 512,
              H16, KV16, 64] at pos 511, llava's long_500k ring [1, 4096,
              H32, KV8, 128]), with times: kernel, plain, one
              library call, and
              the bound (bytes over 3.35 TB/s vs f32 operations over
              67 TFLOP/s, the larger) and bound / time.  The sorts must
              equal torch.sort exactly.  At the serve shape the row also
              times the decode kernel at 1, 2 and 4 splits (the split
              rule's choice against its alternatives); likewise each FLOA
              row times every (V, KU) plan (`plan_ms`), each
              grad_stats row every cluster size (`cluster_ms`).  Then the
              sort past the bitonic cap (U = 8193, f32 and bf16): no
              kernel, torch.sort, equal exactly, logged once.
  4-6. main path through `repro_torch.figures.run_figure` / SweepEngine at
              the paper's full width (D = 50890, U = 10): Fig. 1's benign
              lanes, Fig. 3's Byzantine lanes, and a GAUSSIAN-jamming sweep
              (the combine-only route).  Launch counts are zeroed before and
              read after each, and must show every kernel of the path.
  7. parity   one Fig. 1 sweep through the kernels and again through the
              plain versions, from the same draws.
  8-9. the digital-defense path (grouped dispatch) at full width:
              `figures.run_defenses` (FLOA-BEV beside mean / median /
              trimmed mean / Krum / geometric median, U = 10: the odd-even
              sort) and `figures.worker_grid(1000, D)` through
              `figures.run_cases` (U = 1000, 32000 training samples = 32
              per worker: the bitonic sort and blocked Krum), counted as
              phases 4-6 are.
  10. parity  the defense grid through the kernels and again through the
              plain versions, from the same draws.
  11. trainer the looped `FLTrainer` at full width on Fig. 3's BEV lane
              (one attacker, sigma 3): `run` in FLOA mode (no kernel: the
              pytree combine is a tensordot, as in the reference),
              `run_scan(flat=True)` (one sweep lane: grad_stats and the
              fused step) and digital `run` with median and trimmed mean
              (the odd-even sort), each against its plain route from the
              same draws at rtol 1e-4, with rounds/s of each route.
  12. showdown `figures.run_showdown`: the 68 lanes of
              examples/byzantine_showdown.py at full width (Markov fading,
              K-of-U, colluding and omniscient lanes: the combine-only
              route at [36, 10, D]; median and trimmed-mean groups of 8
              lanes with +inf-padded K-of-U columns), R cut from 100 to 20,
              counted as phases 4-6 are, then against its plain route from
              the same draws.
  13. plan    the execution plan (`ExecutionPlan`) at full width, each
              counted as phases 4-6 are: (a) fig3's four lanes, R = 20,
              monolithic, chunked at C = 7 and chunked with async staging
              (pinned buffers, a side stream): bitwise equal, rounds/s of
              each; (b) the showdown with the example's checkpoint plan
              (C = 5): a child process (`--resume-child ckpt`) SIGKILLs
              itself after its 2nd checkpoint commits, a fresh child
              (`--resume-child resume`) resumes it, and its result equals
              the uninterrupted run bitwise through SweepResult.save /
              load; MB and ms per checkpoint write, the resume's seconds
              to its first round; (c) `worker_grid(1000)` at R = 20: peak
              device memory monolithic and at C = 5 with async staging;
              (d) the switch dispatch on the defense grid and the tree
              state on fig3, default and strict_numerics, each against its
              plain route (rtol 1e-4) and against the grouped / flat run
              (reported: bitwise or the largest difference), rounds/s each.
  14. serve   the serving path, `repro_torch.launch.serve.serve`, for
              qwen3-4b at full width in bf16 (36 layers, 4.41 B random
              parameters): batch 8, 32 prompt tokens decoded into the cache,
              32 generated greedily; one decode_attention launch per layer
              per step, and the weights' init one `counter_trunc_normal`
              launch per leaf it fills.
  15. parity  the serve phase's 64 tokens again, teacher-forced, through the
              kernel and through its plain version (bf16, full depth).
  16. long    8 decode steps at pos 32760-32767 against caches of 32768
              positions (decode_32k's length; its batch of 128 cut to 8 to
              fit 80 GB), filled with seeded random bf16 as if prefilled;
              ms per step against the bytes bound.
  17. parity  the same token sequence through both routes in f32 at full
              width and 2 layers, rtol 1e-4.
  18. lm_lane `figures.run_lm_lane`: examples/train_floa_lm.py's three lanes
              (clean BEV, the Thm-1 sign-flip attack, median screening of
              it) on the full lm_sweep config (qwen3-shaped, f32,
              D = 2 950 528), U = 8 workers of 2 sequences of 64 tokens,
              2 attackers, lr 0.2, R = 20: the step at [2, 8, D],
              grad_stats at 16 rows and the odd-even sort at [1, 8, D],
              counted as phases 4-6 are; rounds/s of a warm run, peak
              device memory, each lane's first-round loss and tail mean;
              the clean lane descends, the attacked lane ends above it.
  19. parity  the same 20 rounds through the plain versions from the same
              draws, rtol 1e-4 (the largest relative difference of the
              final params printed).
  20. train   `launch.steps.make_train_step` (the FLOA train step of
              `python -m repro_torch.launch.train`) on qwen3-4b at full
              width with the serve phase's weights (bf16, 4.41 B): 5 BEV
              steps at batch 8 x seq 64, U = 1, every loss finite and the
              weights moved, ms a warm step, peak device memory; then
              `make_prefill_step` at batch 8 x seq 512 (logits [8, Vp]).
              The train step's combine is the backward itself; its
              update is the `noisy_sgd` kernel, once a leaf a step, its
              noise drawn from the stream in registers, which the counts
              confirm.
  21. mesh    the sweep sharded over ranks (`plan.mesh`, a
              `launch.mesh.SweepMesh`): (1) a one-rank NCCL group, fig3's
              four lanes on its ("data",) mesh, bitwise the unmeshed run;
              (2) 2 ranks on this card over gloo (`--ranks-child`, NCCL
              refuses two ranks on one device), each against the same
              configuration run unsharded here: (a) the defense grid over
              "data", grouped (each family ghost-padded to one lane a
              rank) and switched, (b) worker_grid(1000) over "workers" (the
              bitonic sort on the gathered slab; 2 rounds), (c) the LM lane at
              D = 2 950 528 with model_shards = 2 (the step at
              [2, 8, 1 475 264]), (d) (b) and (c) under strict_numerics
              (the LM lane at 5 rounds).  (a)-(b) at rtol 5e-6 / atol 1e-6,
              (c) at rtol 5e-5 / atol 1e-5, (d) bitwise, every rank's
              result the same; each rank's launches by shard-local shape
              checked; rounds/s of a warm run, labelled "2 ranks, gloo, one
              card" (not a scaling figure).
  22. lm_mesh the LM steps over the worker axes of a mesh
              (`launch.mesh.SweepMesh` over ranks on this card, gloo:
              `--ranks-child`, `lm_mesh_parts`): (a) 2 BEV train steps of
              qwen3-4b at full width cut to 12 of its 36 layers (bf16) on
              a (2, 1) mesh, batch 8 x 64, U = 2: losses finite, the
              weights moved,
              the ranks' params bitwise equal (exact checksums of every
              leaf's bits), ms a warm step, the gradients' all_reduce ms of
              it, peak memory a rank; (b) its 2-layer f32 cut on (4, 1),
              U = 4 with one attacker, BEV and CI, 2 steps each, against
              the same steps over all 4 workers in one process
              (`WorkerAxes.every`) at rtol 1e-4, the ranks bitwise equal;
              (c) `serve` on (2, 1), batch 8, 32 + 32 tokens, each rank's
              decode kernel counted at [4, 64, H32, KV8]: the serve's
              sequence teacher-forced through the mesh's decode step at
              phase 15's bf16 bounds of phase 14's one-rank logits, greedy
              tokens equal to the one-rank serve's up to each row's first
              step whose top-2 margin is not clear, tok/s labelled "2
              ranks, gloo, one card" (not a scaling figure).
  23. zoo     `launch.serve.serve` in bf16 with random weights, batch 8,
              32 + 32 tokens (as phase 14), for granite-8b at full width
              cut to 20 of its 36 layers, starcoder2-3b (its native 4096
              window: ring caches) at full width and depth,
              moonshot-v1-16b-a3b (64 experts top-6 + 2 shared) at full
              width cut to 16 of its 48 MoE layers, and
              llama4-maverick-400b-a17b at full width cut
              to one (attn, attn_moe) super-block (2 of 48 layers; the
              full model is 795 GB), counted: ms a step eager and as one
              CUDA graph, tok/s, kernel launches a step and the device's
              busy share (torch.profiler), peak memory; the serve's 64
              tokens teacher-forced through the kernel and the plain route
              at the served depth, at phase 15's bf16 bounds (an MoE model's
              plain run replays the kernel run's expert choices, whose
              flips it counts, and is reported unreplayed beside); then
              moonshot's FLOA train step and prefill at 4 layers.
  24. long    long_500k for qwen3-4b, granite-8b (8192-slot rings) and
              starcoder2-3b (4096): batch 1, the ring filled as phase 16
              fills its cache, 8 steps at pos 524 280-524 287 (counted),
              eager and as a graph against the bytes bound; the plain
              route from the same ring at phase 15's bf16 bounds; then 2
              layers in f32 through both routes across a wrap of the ring,
              rtol 1e-4.
  25. lm_model the LM steps over a "model" axis, tensor parallel (ranks on
              this card over gloo, `--ranks-child`, `lm_model_parts`;
              every rank holds its shards of the weights,
              `launch.sharding`): (a) `serve` of qwen3-4b at full width
              on (1, 2), batch 8, 32 + 32 tokens, each rank's decode
              kernel counted at [8, 64, H16, KV4], its logits at phase
              15's bf16 bounds of phase 14's one-rank serve on the (step,
              row) pairs whose inputs agree so far, ms a step, tok/s,
              weight bytes and peak memory a rank (the weights drawn leaf
              by leaf, `steps.init_model(..., mesh=)`);
              (b) 3 BEV train steps of qwen3-4b on (1, 2), cut to 12
              layers: losses finite,
              weights moved, the replicated leaves' checksums equal across
              ranks, ms a step, the collectives' share, peak memory a
              rank; (c) its 2-layer f32 cut on (2, 2) (U = 2) against its
              one-process twin at rtol 1e-4; (d) moonshot at 4 layers,
              train and serve on (1, 2), the expert choices recorded and
              replayed on one rank (each rank in turn against its
              shards; per-leaf scalars cross the group): the serve's
              logits at phase 15's bounds, the trained params within two
              bf16 ulps, the gradient of the step's loss within 1e-1
              relative a leaf, the replicated leaves and their gradients
              bitwise across ranks; (e) starcoder2-3b at full width cut to
              4 of its 30 layers, served on (1, 4), 16 + 16 tokens (KV 2 <
              4: wk / wv split d; the kernel at [8, 32, H6, KV1]), against
              one rank teacher-forced through its sequence at phase 15's
              bounds; (f) deepseek-v2-236b (MLA) cut to 1 layer (bf16)
              and mamba2-1.3b (SSD) cut to 4 (f32) on (1, 2): served (no
              kernel), its logits against one rank replaying the expert
              choices at phase 15's bounds (f32: rtol 1e-4), the gradient
              of the step's loss within 1e-1 (f32: 1e-3) relative a leaf
              of one rank's, the replicated leaves' gradients bitwise
              across ranks; recurrentgemma-9b (RG-LRU + local attention)
              cut to 3 layers on (1, 2), in f32 (logits at rtol 1e-4,
              the gradient within 1e-3 relative a leaf) and in bf16
              (phase 15's bounds, 1e-1), its decode kernel counted at a
              rank's [8, 64, H8, KV1, 256]; llava-next-mistral-7b at 2
              layers and seamless-m4t-large-v2 at 2 + 2, f32, on (1, 2)
              (their full-sequence logits and the gradient of the
              step's loss, a prefix of 64 positions or 64 frames a row,
              within 1e-4 of one rank) and seamless's train step on
              (2, 1), the replicas bitwise.  The train and prefill steps
              split the residual stream over "model" on the sequence by
              default ("sequence", the reference's `make_constrain`);
              (g) beside each case the same work on "batch_only" (the
              stream replicated) from the same weights and draws: (b)'s
              and (d)'s train steps (losses, eps2 and params at (d)'s
              gates), (f)'s and the frontends' gradients of the step's
              loss (at their gates) and prefill logits (phase 15's
              bounds; f32: rtol 1e-4), each route's ms, collectives' ms
              and peak a rank (and above the memory held before); and
              qwen3-4b cut to 18 layers under remat, 8 x 2048, one
              train step a route, the peak a rank against
              `launch.dryrun.trace_step`'s on a fake group of 2 (within
              10 % on each route), the drop from "batch_only" to
              "sequence" within 10 % of the trace's.
              Times labelled "N ranks, gloo, one card".
  26. mla_ssm MLA and the SSD block, no kernel of the port (all counts 0):
              deepseek-v2-236b at full width (d 5120, 128 heads, q_lora
              1536, kv_lora 512, 160 experts top-6 + 2 shared) cut to 4 of
              60 layers, served as phase 14 (ms a step eager and as a
              graph, launches a step, peak memory) and long_500k at batch
              1 over a full latent cache of 524 288 slots, 8 steps at pos
              524 280-524 287; at 2 layers the absorbed decode against the
              materialized prefill in f32 (rtol 1e-4), the bf16 serve and
              long_500k steps against f32 on the same weights and cache
              (phase 15's bounds, expert choices replayed), the train step
              (8 x 64) and prefill (8 x 512).  mamba2-1.3b at full width
              and depth (48 layers): served, long_500k from filled states
              (bitwise the steps at pos 33-40 from the same states), the
              SSD duality (recurrent decode against chunked prefill, f32,
              2 layers, 2 x 320 tokens: two chunks, rtol 1e-4), the train
              step and prefill.
  27. hybrid  recurrentgemma-9b (RG-LRU + local MQA attention at head dim
              256; 38 layers, 20.89 GB in bf16) and the int8 KV cache:
              (a) served at full width, cut to 20 of its 38 layers, as
              phase 14 serves (counted: the kernel at [8, 64, H16, KV1,
              256], 6 local layers a step; ms a step eager and as one graph, launches
              a step, peak memory, against the weights' bytes bound), its
              teacher-forced logits kernel route against plain route at
              phase 15's bounds, or, failing them on the mean alone, at
              their max with every clear step agreeing and the kernel's
              mean |diff| from the f32-attention reference no larger than
              the plain route's; (b) long_500k at the same depth: batch 1,
              the
              2048-slot rings and the RG-LRU states filled as phase 16
              fills its cache, 8 steps at pos 524 280-524 287 (counted),
              eager and as a graph, the kernel route against the plain
              route as (a)'s, the states' bytes those of a 41-position
              cache; (c) at RG_CUT_LAYERS (one super-block) in f32 the
              decode against the full-sequence forward over
              RG_WRAP_SEQ tokens (the ring wraps), rtol 1e-4 of the
              largest |logit|, and bf16 against f32 on the same weights
              at phase 15's bounds; (d) the FLOA train step (8 x 64) and
              prefill (8 x 512) at RG_TRAIN_LAYERS; (e) qwen3-4b's serve
              (phase 14) and long cache (phase 16, 32 768 positions) with
              kv_cache_dtype="int8" (counted): the serve against the
              native cache at the reference's bounds
              (tests/test_kv_quant.py: max |diff| < 0.05 of the largest
              |logit|, argmax agreement > 0.9), the long cache against
              native caches holding the same quantized values at phase
              15's bounds (and against the native fill at the
              reference's bounds, reported), the bytes at rest against
              native, ms a step and the dequantization's ms apart.
  28. frontends llava-next-mistral-7b (the projected image prefix; 32
              layers, 14.5 GB in bf16) and seamless-m4t-large-v2 (the
              encoder-decoder, 12 + 12 layers): (a) llava served as
              phase 14 serves qwen3-4b (its text tokens; counted: the
              kernel at [8, 64, H32, KV8, 128]), eager and graph ms a
              step, launches a step, peak, its routes at phase 15's
              bounds at full depth; (b) its long_500k on the 4096-slot
              rings as phase 24 runs an arch; (c) at 4 layers the train
              step and prefill at train_4k's layout cut to batch 2 (2880
              prefix positions of 1024 features and 1216 text tokens);
              (d) seamless at full depth: 512 frames encoded into the
              cross K / V, 32 + 32 greedy decode steps at batch 8
              (counted: the kernel for the self-attention at [8, 64,
              H16, KV16, 64] and the cross-attention at [8, 512, H16,
              KV16, 64] in every decoder layer), eager and graph ms,
              launches a step, the routes at phase 15's bounds, the
              train step (8 x 512 frames x 513 tokens, the chunked CE
              over 256 256 columns) and prefill; (e) its f32 cut at 2 +
              2 layers, the decode against `decode_full` at rtol 1e-4
              of the largest |logit|.
  29. layouts the production layouts: (a) `launch.dryrun.trace_step`'s
              prediction (one device, the fake CPU tensors and the decode
              kernel's fake rule of every dry-run record) against the
              card for runs this script makes:
              phase 20's qwen3-4b train 8 x 64 and prefill 8 x 512, the
              serve's decode step at batch 8 on 64-slot caches, phase 28
              (d)'s seamless train 8 x 512: the argument bytes equal the
              card's, the predicted peak within 10 % of
              `max_memory_allocated` (both printed); (b) in the rank
              phases' 2-rank spawn: qwen3-4b at full width cut to 2
              layers on (2, 1), FSDP storage over "data" against the
              replicated layout: prefill logits (8 x 512) and 2
              teacher-forced decode steps (through the kernel at the
              rank's [4, 64, H32, KV8, 128]) bitwise, the f32 train step
              (2 BEV steps) within rtol 1e-5, the bf16 FSDP step's ranks
              bitwise equal, weight bytes and peak a rank and the
              gather / reduce_scatter ms ("2 ranks, gloo, one card");
              (c) --mesh single on one card raises the ValueError that
              names the 256 ranks it needs; (d) the decode kernel's host
              time a call at the serve's [8, 64, H32, KV8, 128], the
              wrapper (off the dispatcher, as the main path launches it)
              against its custom op (as the dry run traces it), 1000
              calls each, in the order wrapper, op, op, wrapper.
  30. remat   rematerialization (`cfg.remat`, the full configs'
              default): (a) phase 20's qwen3-4b train step (8 x 64) with
              remat and without, none, remat, remat, none from the same
              weights and seed: new params, stats and metrics bitwise,
              ms and peak each; (b) qwen3-4b at full depth over train_4k's
              4096 positions at 4 of its 256 rows, remat: a warm-up and a
              measured step, finite losses, ms a step, the peak within 10 %
              of `launch.dryrun.trace_step`'s prediction, beside the
              remat-free trace's peak (computed, not run); (c)
              moonshot-v1-16b-a3b cut to 4 layers at 2 x 4096: the peak
              with the expert chunks (`moe.EXPERT_CHUNK_BYTES`) against
              one forced chunk, chunks, one, one, chunks.
  31. heads   the head layouts the "model" axis does not divide, in a
              spawn of 16 ranks on this card over gloo (`--ranks-child
              ... heads`) on (1, 16): starcoder2-3b (H 24) at full width
              cut to 1 layer and llama4 (H 40) to its first,
              wq / wk / wv split d and wo hd, every rank computing every
              head: 2 BEV train steps on their own seeded draws (each
              rank drawing its part of each leaf's noise in the update
              kernel), the gradient of the step's loss, a prefill (8 x
              128) and the
              serve (8, 8 + 8 tokens: the decode kernel at [8, 16, H,
              KV, 128] on every rank, counted), ms a step and the
              collectives' ms; against one rank from the same weights at
              phase 25's gates, the replicated leaves, logits and tokens
              bitwise equal across the ranks.
  32. draws   the counter-based stream (`kernels/philox.py`): (a)
              Philox4x32-10 on the card against Random123's known
              answers, curand's `curand_Philox4x32_10` over 2^20 random
              counters and keys, and the plain stream, bitwise; (b) the
              update kernel's z at qwen3-4b's embedding against the plain
              stream (atol 1e-5), the fused update bitwise its z-given
              mode and that mode bitwise the plain update (bf16, f32),
              and each of the 256 parts of a 5.37e9-element leaf at
              (16, 16) bitwise the whole leaf's slice, for both kernels;
              (c) rows as phase 3's for `noisy_sgd` and
              `counter_trunc_normal` at the embedding, a stacked leaf
              (blocks/b0/attn/wk, [36, 2560, 1024]) and wk's part on
              one of 16 ranks split on its last dim ([36, 2560, 64]:
              rows of 64), each with its issue bound (the hot loop's
              SASS, `tools/sass_mix.py`, at the SM clock read under
              load) beside its bytes bound, the init's beside
              `torch.nn.init.trunc_normal_`; (d) phase 20's
              step on its own draws
              from a counted init: warm ms and peak beside phase 20's
              in two runs before the update kernel.
  33. graphs  compiled execution (`repro_torch.graphs`): the entry
              points replay their step captured as a CUDA graph by
              default (so every phase above runs graphed), and here
              each of (a) Fig. 3's sweep (R = 20, full width), (b) the
              defense grid, (c) qwen3-4b's serve (batch 8, 32 + 32)
              and (d) its FLOA train step (8 x 64, 3 steps, through
              `launch.train.compile_step`) runs graphed and, under
              `graphs.disable_graphs()`, eagerly: bitwise equal (lane
              losses, grad norms and final params, every lane
              generator's state; tokens and logits; params and the
              FLOA state after the steps), the same launches from
              `ops.launch_counts()`, each route's rate, peak memory,
              captures, replays and capture seconds, and a
              torch.profiler reading of a warm run, step or round
              (kernels a step, the device's busy share); (d) also
              replays the captured step from one state under two
              device seeds: two different noises.
  Then the `kernels` line (with launches and times by shape where a
  kernel runs at several main-path shapes, checked against the phases'
  shapes, and the mesh phases' launches by shard-local shape, each with
  the times of its phase-3 row: every launch shape, a rank's too, must
  have one), and the last line, {"ok": true, "device": ...}.

`--strict-rates` times the strict_numerics routes of the plan phase and the
mesh phase's unsharded U = 1000 twin, `--serve-rate` phase 14's serve (its
eager ms a decode step, SERVE_RATE_RUNS runs after a warm-up).  Copied
into the root of another checkout (`git archive` of an earlier commit),
either times that checkout's src/ the same way: two versions compared
within one call.

Any failure raises, so the script exits non-zero before the last line.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12      # f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # bf16 on the tensor cores, dense
ROUNDS = 20
ROUNDS_LARGE_U = 5           # the U = 1000 grid: keeps the script short
MESH_ROUNDS_LARGE_U = 2      # the mesh phase's U = 1000 grids (cut from 5)
RTOL_WHOLE_RUN = 1e-4        # kernel route vs plain route over 20 rounds
LM_ARCH = "qwen3-4b"
# The LM lane (phase 18): lm_sweep's flat D, examples/train_floa_lm.py's
# defaults (U = 8 workers of 2 sequences of 64 tokens, 2 attackers, lr 0.2)
LM_D = 2950528
LM_WORKERS, LM_BATCH, LM_SEQ = 8, 2, 64
# The train phase (20): launch/train.py's shape, the prefill's
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_ALPHA = 8, 64, 5, 0.02
PREFILL_BATCH, PREFILL_SEQ = 8, 512
# The plan phase: fig3 chunked at C = 7 (R % C != 0), the showdown resumed
# at the example's C = R // 4 after a SIGKILL at the 2nd checkpoint, the
# U = 1000 grid at C = 5 for its device memory; the paper MLP's leaf
# segments (b1 | b2 | w1 | w2), the strict route's grad_stats launches.
PLAN_CHUNK, MEM_CHUNK, KILL_AFTER_SAVES = 7, 5, 2
MLP_SEGMENTS = (64, 10, 50176, 640)
BATCH_MB_PER_ROUND_U1000 = 32000 * 784 * 4 / 1e6   # f32 x of one round
# The mesh phase (21): 2 ranks on one card over gloo (NCCL refuses two
# ranks on one device), each sharded configuration against its unsharded
# twin; the LM lane's strict run is cut to 5 rounds.
MESH_RANKS = 2
MESH_CASES = ("defenses", "defenses_switch", "grid_u1000", "lm",
              "grid_u1000_strict", "lm_strict")
ROUNDS_LM_STRICT = 5
# sharded vs unsharded (tests/test_sweep_workers.py:127,
# tests/test_lm_lane.py:135); the strict routes and one rank: bitwise
MESH_TOL = {"defenses": (5e-6, 1e-6), "defenses_switch": (5e-6, 1e-6),
            "grid_u1000": (5e-6, 1e-6), "lm": (5e-5, 1e-5)}
# The LM-mesh phase (22): the train step and the serve over the worker axes,
# ranks on cuda:0 over gloo: 2 steps a run (cut from 3); (a)'s full-width
# qwen3-4b cut to LM_MESH_A_LAYERS of its 36 layers (the script's time:
# each step all_reduces the gradients over gloo); (b)'s 2-layer f32 cut of
# qwen3-4b at U = 4 (one attacker) under BEV and CI
LM_MESH_STEPS, LM_MESH_A_LAYERS, LM_MESH_B_LAYERS = 2, 12, 2
LM_MESH_POLICIES = ("bev", "ci")
# The LM-model phase (25): tensor parallelism over a "model" axis, ranks on
# cuda:0 over gloo, 3 steps a train run: (a) qwen3-4b's serve and (b) its
# train step on (1, 2); (c) the 2-layer f32 cut on (2, 2) against its
# one-process twin; (d) moonshot at MOE_TRAIN_LAYERS, train and serve on
# (1, 2), against one rank replaying the expert choices; (e) starcoder2-3b's
# serve on (1, 4) at full width, cut to TP_SC_LAYERS of its 30 layers, 16 +
# 16 tokens (wk / wv split d: KV 2 < M 4)
LM_MODEL_STEPS = 3
# (b)'s full-width train step cut to TP_TRAIN_LAYERS of qwen3-4b's 36
TP_TRAIN_LAYERS = 12
TP_SC_ARCH, TP_SC_LAYERS, TP_SC_PROMPT, TP_SC_GEN = "starcoder2-3b", 4, 16, 16
# (d)'s bf16 params, TP against one rank: each element within two bf16 ulps
# (an ulp is 2^-8 to 2^-7 of the value) of the other, above a floor
TP_PARAM_ULPS, TP_PARAM_FLOOR = 2 ** -6, 1e-6
# (d)'s gradient of the step's loss, TP against one rank: each leaf's
# |a - b|_2 / |b|_2: bf16 partial sums move it by about 1e-2; a gradient
# missing a rank's share is off by a third or more
TP_GRAD_REL = 1e-1
# (f) in phase 25's 2-rank child: deepseek-v2-236b (MLA) cut to
# TP_MLA_LAYERS (bf16) and mamba2-1.3b (SSD) cut to TP_SSD_LAYERS, served
# and differentiated on (1, 2) against one rank.  mamba2 runs in f32, its
# gradient held at TP_GRAD_REL_F32: in bf16 the SSD block's gradient
# stands 18-29 % (relative L2, a leaf) from its f32 gradient in the JAX
# reference itself (4 smoke layers, CPU), so no TP-vs-one-rank gate in
# bf16 could tell a wrong backward from rounding.  In f32 the smoke cut's
# gap is 4e-5 (CPU, gloo); a gradient missing a rank's share is off by a
# third or more
TP_MLA_LAYERS, TP_SSD_LAYERS = 1, 4
TP_GRAD_REL_F32 = 1e-3
# (g) in phase 25's 2-rank child: each case on both routes of the
# residual stream; qwen3-4b cut to SEQ_PEAK_LAYERS of its 36 under remat
# at SEQ_PEAK_BATCH x SEQ_PEAK_SEQ on (1, 2), the peak a rank against the
# dry run's.  At 2 x 2048 the update's peak (the params and their
# gradients) hides the saved inputs and both routes peak alike; at
# 8 x 2048 "batch_only" peaks with every block's input whole (the dry
# run: 12.51 GB at 18 layers, 15.84 at 36) and "sequence" holds half of
# them (11.59, 15.21); the card's drop from "batch_only" to "sequence"
# within SEQ_DROP_TOL of the dry run's.  The depth cut halves the step's
# gloo calls (36 layers: 34 s a step on "sequence", 29 of them gloo's)
SEQ_ROUTES = ("sequence", "batch_only")
SEQ_PEAK_BATCH, SEQ_PEAK_SEQ, SEQ_DROP_TOL = 8, 2048, 0.10
SEQ_PEAK_LAYERS = 18
# The MLA / SSD phase (26): deepseek-v2-236b at full width cut to MLA_LAYERS
# of its 60 layers (serve, long_500k), to MLA_CUT_LAYERS for the f32 checks
# and the train step and prefill; mamba2-1.3b at full width and depth, its
# SSD duality (the recurrent decode against the chunked prefill) in f32 on
# SSD_DUAL_LAYERS, SSD_DUAL_BATCH x SSD_DUAL_SEQ tokens (two chunks of 256)
MLA_ARCH, MLA_LAYERS, MLA_CUT_LAYERS = "deepseek-v2-236b", 4, 2
SSD_ARCH, SSD_DUAL_LAYERS, SSD_DUAL_BATCH, SSD_DUAL_SEQ = (
    "mamba2-1.3b", 2, 2, 320)
# The hybrid phase (27): recurrentgemma-9b at full width cut to
# RG_SERVE_LAYERS (serve, long_500k), at RG_CUT_LAYERS (one super-block) for the f32 checks (the
# decode against the forward over RG_WRAP_SEQ tokens: past the 2048-slot
# ring, a multiple of the 1024-query chunk), at RG_TRAIN_LAYERS (one
# super-block and the two tail blocks) for the train step and prefill;
# (f) in phase 25's 2-rank child at TP_RG_LAYERS.  The int8 KV cache
# against the native one at the reference's bounds (tests/test_kv_quant.py)
RG_ARCH, RG_CUT_LAYERS, RG_TRAIN_LAYERS, TP_RG_LAYERS = (
    "recurrentgemma-9b", 3, 5, 3)
# (a) and (b) at full width cut to RG_SERVE_LAYERS of the 38 layers (six
# super-blocks and the two tail blocks: 6 of the 12 local-attention
# layers), for the script's time
RG_SERVE_LAYERS = 20
RG_WRAP_BATCH, RG_WRAP_SEQ = 1, 3072
KV_INT8_MAX_REL, KV_INT8_AGREE = 0.05, 0.9
# The frontends phase (28): llava-next-mistral-7b at full width and depth
# (served as phase 14 serves qwen3-4b; long_500k on its native 4096-slot
# rings as phase 24 runs it), cut to FRONT_CUT_LAYERS of its 32 layers for
# the train step and prefill at train_4k's layout cut in batch to
# FRONT_TRAIN_BATCH rows (its 2880 prefix positions and 1216 text tokens:
# S = FRONT_TRAIN_SEQ); seamless-m4t-large-v2 at full width and depth:
# AUDIO_FRAMES frames encoded, SERVE_PROMPT + SERVE_GEN decode steps at
# batch SERVE_BATCH, the train step at SERVE_BATCH x AUDIO_FRAMES frames
# and AUDIO_FRAMES + 1 tokens, the prefill at the same layout, and in f32
# at AUDIO_CUT + AUDIO_CUT layers its decode against `decode_full`.
# FRONT_TP_N: the prefix positions (or frames) of the rank phases' batches
# (phase 25 (f): llava at FRONT_TP_LAYERS, seamless at AUDIO_CUT +
# AUDIO_CUT, f32, on (1, 2) against one rank within FRONT_TP_RTOL)
VLM_ARCH, AUDIO_ARCH = "llava-next-mistral-7b", "seamless-m4t-large-v2"
FRONT_CUT_LAYERS, FRONT_TRAIN_BATCH, FRONT_TRAIN_SEQ = 4, 2, 4096
AUDIO_FRAMES, AUDIO_CUT = 512, 2
FRONT_TP_N, FRONT_TP_LAYERS, FRONT_TP_RTOL = 64, 2, 1e-4
# The layouts phase (29): (a) the dry run's predicted peak against the
# card's within PEAK_TOL; (b) qwen3-4b cut to FSDP_LAYERS on (2, 1), FSDP
# against the replicated layout: FSDP_TF steps of teacher-forced decode
# (each gathers every weight over gloo), FSDP_STEPS f32 train steps held at
# FSDP_RTOL (the gradients' sums in another order: reduce_scatter against
# all_reduce)
PEAK_TOL = 0.10
FSDP_LAYERS, FSDP_TF, FSDP_STEPS, FSDP_RTOL = 2, 2, 2, 1e-5
# The remat phase (30): (a) phase 20's qwen3-4b train step without and with
# remat, in the order none, remat, remat, none, each from the same weights
# and seed (bitwise); (b) train_4k's sequence at REMAT_BATCH of its 256
# rows, full depth, remat: a warm-up step and a measured one, the peak
# against `launch.dryrun.trace_step`'s within PEAK_TOL, beside the
# remat-free trace's (computed, not run); (c) moonshot cut to
# MOE_TRAIN_LAYERS at REMAT_MOE_BATCH x REMAT_SEQ: the expert chunks
# against one forced chunk, in the order chunks, one, one, chunks
REMAT_BATCH, REMAT_MOE_BATCH, REMAT_SEQ = 4, 2, 4096
# The heads phase (31): the head layouts the "model" axis does not divide
# (the reference's `_wspec` fallback: wq / wk / wv split d, wo hd, every
# rank computing every head) on HEADS_RANKS ranks on cuda:0 over gloo,
# (1, HEADS_RANKS): (arch, layers) at full width, starcoder2-3b (H 24)
# cut to 2 of its 30 layers, llama4 (H 40) to its first, dense layer,
# both training on their own seeded draws: each rank draws its part of
# each leaf's noise in the update kernel's registers (`noisy_sgd`), so
# no rank forms a leaf's noise at its full shape (llama4's embedding's
# would take 4.1 GB of f32 a rank, 66 GB over 16 ranks).
# HEADS_STEPS BEV train steps at
# TRAIN_BATCH x TRAIN_SEQ, a prefill of HEADS_PREFILL_BATCH x
# HEADS_PREFILL_SEQ, the serve of HEADS_PROMPT + HEADS_GEN tokens (a gloo
# collective takes ~80 ms over 16 ranks), each against one rank at phase
# 25's gates
HEADS_RANKS, HEADS_STEPS, HEADS_PROMPT, HEADS_GEN = 16, 2, 8, 8
HEADS_CASES = (("starcoder2-3b", 1), ("llama4-maverick-400b-a17b", 1))
HEADS_PREFILL_BATCH, HEADS_PREFILL_SEQ = 8, 128
# The draws phase (32): the counter-based stream (`kernels/philox.py`) and
# its two kernels.  (a) Random123's known answers and curand's
# `curand_Philox4x32_10` over DRAWS_CURAND_N random counters and keys;
# (b) the update kernel's z (read back through an f32 update of zeros at
# alpha -1, which returns z exactly) against the plain stream within
# DRAWS_Z_ATOL (|z| < 5.8: logf, cosf, sinf differ by a few f32 ulps),
# the fused update bitwise its z-given mode on that z, the z-given mode
# bitwise the plain update given the same z, and every part of a
# DRAWS_BIG leaf (5.37e9 elements: indices past 2^32) at DRAWS_RANKS
# ("model" on dim 0, "data" on dim 1) bitwise the whole leaf's slice, for
# both kernels; (c) phase-3 rows at qwen3-4b's embedding and a stacked
# leaf of it; (d) phase 20's step with its seeded draws from a counted
# init, DRAWS_STEPS steps.  The rows' gates against the plain version:
# bf16 outputs within one bf16 ulp (rtol 2^-7: a z that differs by an
# ulp can round scale z, then the output, the other way), f32 (1e-5,
# 1e-6).
SLOW_PLAIN_S = 0.02
DRAWS_CURAND_N = 2 ** 20
DRAWS_Z_ATOL = 1e-5
DRAWS_BIG = (16, 2 ** 28 + 2 ** 26)
DRAWS_RANKS = (16, 16)
DRAWS_SHORT_RANKS = 16   # (c)'s wk part: 1024 / 16, rows of 64
DRAWS_STEPS = 3
DRAWS_TOL = {"bfloat16": (2 ** -7, 1e-8), "float32": (1e-5, 1e-6)}
# phase 20 in two runs of this script before the update kernel (NVIDIA
# H100 80GB HBM3, 700.00 W): (warm ms a step, peak GB) each
TRAIN_BEFORE = ((501.61, 33.90), (524.09, 33.90))
# --serve-rate: phase 14's serve timed this many times after a warm-up
SERVE_RATE_RUNS = 5
T_START = time.perf_counter()
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 32, 32
LONG_BATCH, LONG_S, LONG_STEPS = 8, 32768, 8
# The zoo phase (22): each arch at full width, served as phase 14 serves
# qwen3-4b; llama4's 48 layers (795 GB) cut to one (attn, attn_moe)
# super-block.  moonshot's FLOA train step and prefill run at 4 layers.
ZOO = (("granite-8b", 20), ("starcoder2-3b", None),
       ("moonshot-v1-16b-a3b", 16), ("llama4-maverick-400b-a17b", 2))
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "moonshot-v1-16b-a3b", 4
# The long_500k phase (23): batch 1 against a ring of decode_window slots,
# 8 steps at the shape's last positions; its f32 run crosses a wrap
LONG500_ARCHS = ("qwen3-4b", "granite-8b", "starcoder2-3b")
LONG500_POS = 524287
# decode attention, kernel vs plain on the same inputs: f32 differs in
# summation order and expf only, (rtol, atol) = (1e-5, 1e-5).  A bf16 row
# is held against the plain version on its inputs upcast to f32: the kernel
# accumulates in f32 and rounds once, at the output (2^-9 relative), so
# rtol 1e-2 with atol 1e-2 of the mean |output|.  The outputs are small
# (about sqrt(e / S), 0.009 at S = 32768), so an atol fixed in absolute
# terms would pass an all-zero output; this one fails it 100x over.
DECODE_TOL_F32 = (1e-5, 1e-5)
DECODE_REL_BF16 = 1e-2
# SDPA, the library yardstick, is checked against the same f32 reference;
# its fused bf16 kernels round the probabilities to bf16 before P.V.
SDPA_REL_BF16 = 4e-2
# Teacher-forced qwen3-4b logits, kernel route vs plain route, bf16, 36
# layers: the plain route rounds each layer's scores and probabilities to
# bf16 (2^-9 relative), which the residual stream carries through 36
# layers, and both routes round the logits (std ~0.9, |max| ~5) to bf16
# (an ulp is 2^-8 relative, 0.03 at 5).  Predicted max |diff| ~0.05, mean
# ~0.005; the bounds leave 5x and 4x of room, and a wrong kernel (a wrong
# head, mask or scale) moves the logits by O(their std).
BF16_LOGIT_MAX, BF16_LOGIT_MEAN = 0.25, 0.02


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far (`t_s`)."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T_START}), flush=True)


_PHASE_T0 = [T_START]


def phase_seconds(name: str) -> None:
    """Phase `name`'s seconds (since the last call, or the start) on a
    line of its own."""
    now = time.perf_counter()
    print(json.dumps({"phase": "seconds", "of": name,
                      "seconds": now - _PHASE_T0[0],
                      "t_s": now - T_START}), flush=True)
    _PHASE_T0[0] = now


def time_ms(torch, fn, iters: int = 50) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed, timed with CUDA events (the host's launch overhead is not in
    it).  Inputs stay in the 50 MB L2 between calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def call_ms(torch, fn, iters: int = 200) -> float:
    """Time of one eager call, host launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errors(torch, got, want) -> tuple:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), float((err / w.abs().clamp_min(1e-6)).max())


def sort_ops(u: int) -> int:
    """Comparisons a column's sort needs: ceil(log2(U!)), the fewest any
    comparison sort of U values can make in the worst case (not the
    network's compare-exchanges, which a padded bitonic network inflates
    far beyond what the sort needs)."""
    return math.ceil(math.lgamma(u + 1) / math.log(2))


def combine_cases(torch, ops, rnd, gen, s, u, d, dt, main):
    """The FLOA kernels' and grad_stats' phase-3 rows at [S, U, D]."""
    eg = torch.finfo(dt).bits // 8
    # tests/test_kernels.py's tolerances: the combine 1e-5 (f32) and 0.15
    # (bf16); grad_stats (rtol 1e-4, atol 1e-3) and 2e-2 (bf16).  The f32
    # combine's atol grows with U beyond 10 workers: its U unit-size terms
    # are summed in another order by the plain version (cuBLAS), and the
    # rounding of a running sum of U such terms grows about linearly in U
    # (about 2e-5 rms at U = 1000, each route).
    f32 = dt == torch.float32
    tol = (1e-5, 1e-5 * max(1.0, u / 10)) if f32 else (0.15, 0.15)
    tol_stats = (1e-4, 1e-3) if f32 else (2e-2, 2e-2)
    w, c, g, z = rnd(s, d, dtype=dt), rnd(s, u), rnd(s, u, d, dtype=dt), \
        rnd(s, d, dtype=dt)
    bias, eps = rnd(s), rnd(s)
    alpha = torch.rand(s, generator=gen, device="cuda") * 0.2
    zb = (bias[:, None] + eps[:, None] * z.float()).to(dt)[:, None]
    label = f"S={s} U={u} D={d} {str(dt)[6:]}"
    rows = g.reshape(s * u, d)
    step_args = (w, c, g, z, bias, eps, alpha)
    s1_args = (c[:1], g[:1], z[:1], bias[:1], eps[:1])
    return [
        ("floa_step_batched", label, main,
         lambda p, a=step_args: ops.floa_step_batched(*a, plain=p),
         None,
         s * u * d * eg + 4 * s * d * eg + s * u * 4 + 3 * s * 4,
         2 * s * u * d + 4 * s * d, tol, None,
         lambda a=step_args: combine_plans_ms(torch, True, *a)),
        ("floa_aggregate_batched", label, main,
         lambda p, a=(c, g, z, bias, eps):
             ops.floa_aggregate_batched(*a, plain=p),
         lambda a=(zb, c.to(dt)[:, None], g): torch.baddbmm(*a),
         s * u * d * eg + 2 * s * d * eg + s * u * 4 + 2 * s * 4,
         2 * s * u * d + 3 * s * d, tol, None,
         lambda a=(None, c, g, z, bias, eps): combine_plans_ms(
             torch, False, *a)),
        ("floa_aggregate", f"U={u} D={d} {str(dt)[6:]} (S=1)", main,
         lambda p, a=(c[0], g[0], z[0], bias[0], eps[0]):
             ops.floa_aggregate(*a, plain=p),
         lambda a=(zb[0, 0], g[0].t(), c[0].to(dt)): torch.addmv(*a),
         u * d * eg + 2 * d * eg + u * 4 + 8,
         2 * u * d + 3 * d, tol, None,
         lambda a=(None, *s1_args): combine_plans_ms(torch, False, *a)),
        ("grad_stats", f"R={s * u} D={d} {str(dt)[6:]}", main,
         lambda p, a=rows: ops.grad_stats(a, plain=p),
         lambda a=rows: torch.var_mean(a, dim=1, correction=0),
         s * u * d * eg + s * u * 2 * 4, 3 * s * u * d, tol_stats, None,
         lambda a=rows: cluster_sizes_ms(torch, a))]


def combine_plans_ms(torch, update, w, c, g, z, bias, eps, alpha=None):
    """The FLOA kernel on one phase-3 row's inputs at every (V, KU) plan the
    shape allows (V = 1 or the widest vector; KU = 1, 2, 4, 8 worker
    slices), through its C entry point: {"V=v KU=k": ms}, and the plan the
    wrapper takes.  Not counted as launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import floa_aggregate as FA
    lib = _build.library("floa_aggregate")
    s, u, d = g.shape
    code = _build.DTYPE_CODES
    g_out = torch.empty_like(z)
    w_out = torch.empty_like(w) if update else None
    ptrs = [g.data_ptr(), z.data_ptr()] + ([w.data_ptr()] if update else [])
    wdt = w.dtype if update else g.dtype

    def launch(vec, ku):
        stream = torch.cuda.current_stream().cuda_stream  # the capture's
        if update:
            err = lib.floa_step_batched(
                w.data_ptr(), c.data_ptr(), g.data_ptr(), z.data_ptr(),
                bias.data_ptr(), eps.data_ptr(), alpha.data_ptr(),
                w_out.data_ptr(), g_out.data_ptr(), s, u, d, code[g.dtype],
                code[wdt], vec, ku, stream)
        else:
            err = lib.floa_aggregate_batched(
                c.data_ptr(), g.data_ptr(), z.data_ptr(), bias.data_ptr(),
                eps.data_ptr(), g_out.data_ptr(), s, u, d, code[g.dtype], vec,
                ku, stream)
        _build.check(err, "floa_combine_kernel")

    widest = FA.vector_width(d, g.element_size(), w_out.element_size()
                             if update else g.element_size(),
                             FA._align(*ptrs))
    times = {}
    for vec in sorted({1, widest}):
        for ku in FA.WORKER_SLICES:
            if ku <= u:
                times[f"V={vec} KU={ku}"] = time_ms(
                    torch, lambda v=vec, k=ku: launch(v, k))
    plan = FA._plan(g.device.index, s, u, d, g.dtype, wdt, FA._align(*ptrs))
    return {"plan": f"V={plan[0]} KU={plan[1]}", "plan_ms": times}


def cluster_sizes_ms(torch, rows):
    """grad_stats on one phase-3 row's rows at every cluster size C the card
    runs, through its C entry point: {C: ms}, and the C the wrapper takes.
    Not counted as launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import grad_stats as GS
    lib = _build.library("grad_stats")
    r, d = rows.shape
    code = _build.DTYPE_CODES[rows.dtype]
    out = torch.empty((r, 2), device=rows.device)
    max_c = lib.grad_stats_max_cluster(code)
    times = {}
    for c in GS.CLUSTER_SIZES:
        if c <= max_c:
            times[c] = time_ms(torch, lambda c=c: _build.check(lib.grad_stats(
                rows.data_ptr(), out.data_ptr(), r, d, code, c,
                torch.cuda.current_stream().cuda_stream), "grad_stats"))
    return {"cluster": GS._plan(rows.device.index, r, d, rows.dtype),
            "max_cluster": max_c, "cluster_ms": times}


def kernel_cases(torch, ops):
    """(kernel, label, main?, run(plain) -> outputs, library fn or None,
    bytes, flops, (rtol, atol) or "exact", want() or None, extra() or
    None) for every comparison of phase 3: want() gives the reference
    (default: the plain version), extra() more fields for the row (the
    timings of a kernel's alternative launch plans)."""
    gen = torch.Generator("cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for s, u, d, dt, main in [(4, 10, 50890, torch.float32, True),
                              (3, 32, 5000, torch.bfloat16, False)]:
        cases += combine_cases(torch, ops, rnd, gen, s, u, d, dt, main)
    # the other main-path shapes of the same kernels (PERF.md section 6):
    # fig1's 3 lanes, the combine route's 2, the single analog lane of the
    # defense grid and the trainer's flat scan (U = 10), of the U = 1000
    # grid, and the showdown's 36 analog lanes (the combine-only route)
    # (the plan phase adds the switch dispatch's analog step over all six
    # lanes of the defense grid, [6, 10, D] and 60 rows)
    for s, u, kinds in [(3, 10, ("floa_step_batched", "grad_stats")),
                        (2, 10, ("floa_aggregate_batched", "grad_stats")),
                        (1, 10, ("floa_step_batched", "grad_stats")),
                        (1, 1000, ("floa_step_batched", "grad_stats")),
                        (36, 10, ("floa_aggregate_batched", "grad_stats")),
                        (6, 10, ("floa_aggregate_batched", "grad_stats")),
                        # a rank's shapes in the mesh phase (mesh_expect):
                        # the switched defense grid's 3 lanes (its 30
                        # grad_stats rows are fig1's), and the U = 1000
                        # grid's 500 workers of a worker shard
                        (3, 10, ("floa_aggregate_batched",)),
                        (1, 500, ("grad_stats",))]:
        cases += [c for c in combine_cases(torch, ops, rnd, gen, s, u, 50890,
                                           torch.float32, True)
                  if c[0] in kinds]
    # the sorts: the defense grid's slab (U = 10), the digital trainer's
    # [U, D] slab, the showdown's median / trimmed-mean groups (8 lanes,
    # the last 4 with 3 of 10 rows +inf: K = 7), the switch dispatch's
    # every-lane sort of the defense grid (6 lanes) and the U = 1000 grid's
    for name, s, u, d, dt, main, inf in [
            ("sort_columns", 1, 10, 50890, torch.float32, True, False),
            ("sort_columns", 0, 10, 50890, torch.float32, True, False),
            ("sort_columns", 8, 10, 50890, torch.float32, True, True),
            ("sort_columns", 6, 10, 50890, torch.float32, True, False),
            ("sort_columns", 3, 10, 50890, torch.float32, True, False),
            ("sort_columns", 3, 32, 5000, torch.bfloat16, False, False),
            ("sort_columns", 2, 7, 2049, torch.float32, False, False),
            ("sort_columns_bitonic", 1, 1000, 50890, torch.float32, True,
             False),
            ("sort_columns_bitonic", 2, 33, 515, torch.float32, False, False),
            ("sort_columns_bitonic", 1, 100, 130, torch.float32, False,
             False),
            ("sort_columns_bitonic", 1, 4097, 130, torch.float32, False,
             False),
            ("sort_columns_bitonic", 1, ops.BITONIC_MAX_U, 130,
             torch.float32, False, False),
            ("sort_columns_bitonic", 1, 4097, 50890, torch.float32, False,
             False),
            ("sort_columns_bitonic", 4, 100, 515, torch.float32, False,
             True)]:
        x = rnd(max(s, 1), u, d, dtype=dt)
        label = f"S={s} U={u} D={d} {str(dt)[6:]}"
        if s == 0:          # the [U, D] form: one lane, no lane axis
            x, label = x[0], f"U={u} D={d} {str(dt)[6:]}"
        elif inf:           # K-of-U: 3 in 10 rows +inf in half the lanes
            rows = torch.randperm(u, generator=torch.Generator().manual_seed(
                u))[:3 * u // 10].to("cuda")
            x[s // 2:, rows] = torch.inf
            label += " +inf rows"
        cases.append((
            name, label, main,
            lambda p, f=ops.KERNELS[name], a=x: f(a, plain=p),
            lambda a=x: torch.sort(a, dim=-2),
            2 * x.numel() * (torch.finfo(dt).bits // 8),
            max(s, 1) * d * sort_ops(u), "exact", None, None))
    return (cases + lm_lane_cases(torch, ops, rnd, gen)
            + fixed_stats_cases(torch, ops, rnd) + decode_cases(torch, ops))


def check_kernels(torch, cases, floor_ms) -> dict:
    """Phase 3: each case's kernel against its reference at the case's
    tolerance, timed beside its plain version, its library call and its
    bound; one `kernel_check` line a case.  Returns the main-path rows by
    kernel name."""
    table = {}
    for name, label, main_shape, run, lib, nbytes, flops, tol, want_fn, \
            extra in cases:
        got = run(False)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = want_fn() if want_fn else run(True)
        torch.cuda.synchronize()
        plain_s = 0.0 if want_fn else time.perf_counter() - t_plain
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        abs_err, rel_err, typical = 0.0, 0.0, 0.0
        for g, w in zip(got, want):
            if tol == "exact" and not torch.equal(g, w):
                raise AssertionError(f"{name} [{label}] is not equal to "
                                     f"torch.sort")
            if tol != "exact" and not torch.allclose(
                    g.float(), w.float(), rtol=tol[0], atol=tol[1]):
                raise AssertionError(f"{name} [{label}] disagrees with its "
                                     f"plain version at tol {tol}")
            a, r = max_errors(torch, g, w)
            abs_err, rel_err = max(abs_err, a), max(rel_err, r)
            typical = max(typical, float(w.float().abs().mean()))
        b_ms, b_by = bound(nbytes, flops)
        # decode_32k's row (17 GB of K and V) and the U = 4097 sort at full
        # width (0.83 GB in; torch.sort's graph keeps 2.5 GB a call)
        big = nbytes > 1.5e9
        iters = 5 if big else 50
        # a plain version of SLOW_PLAIN_S or more a call (the stream's int64
        # Philox, phase 32) is timed over as few calls as a big row
        plain_iters = 5 if plain_s >= SLOW_PLAIN_S else iters
        row = {"kernel": name, "shape": label, "max_abs_err": abs_err,
               "max_rel_err": rel_err, "mean_abs_want": typical,
               "err_over_typical": abs_err / max(typical, 1e-30),
               "rtol_atol": tol,
               "ms": time_ms(torch, lambda: run(False), iters),
               "call_ms": call_ms(torch, lambda: run(False),
                                  10 if big else 200),
               "plain_ms": time_ms(torch, lambda: run(True), plain_iters),
               "library_ms": None if lib is None else time_ms(torch, lib,
                                                              iters),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops, "floor_ms": floor_ms}
        row["bound_share"] = b_ms / row["ms"]
        if extra:
            row.update(extra())
        emit("kernel_check", **row)
        if main_shape:
            table.setdefault(name, []).append(row)
    del run, lib, got, want, want_fn, extra
    cases.clear()
    torch.cuda.empty_cache()
    return table


def lm_leaf_sizes() -> list:
    """The LM lane's flat row, leaf by leaf (lm_sweep's 14 leaves, in the
    tree order the flat state keeps)."""
    import torch
    from repro_torch.configs import get_lm_sweep
    from repro_torch.fl.sweep import make_row_unflatten
    from repro_torch.models.transformer import init_lm
    return make_row_unflatten(init_lm(torch.Generator().manual_seed(0),
                                      get_lm_sweep(), "cpu"))[1]


def lm_lane_cases(torch, ops, rnd, gen):
    """The LM lane's rows (phase 18, D = 2 950 528, every input beyond the
    50 MB L2): the fused step over its two analog lanes at U = 8, their 16
    grad_stats rows, and the median lane's odd-even sort at [1, 8, D],
    which must equal torch.sort; and the same three at a model shard's
    D / 2 columns (the mesh phase's "lm" case: LM_D pads to itself)."""
    cases = []
    for d in (LM_D, LM_D // MESH_RANKS):
        cases += [c for c in combine_cases(torch, ops, rnd, gen, 2,
                                           LM_WORKERS, d, torch.float32, True)
                  if c[0] in ("floa_step_batched", "grad_stats")]
        x = rnd(1, LM_WORKERS, d)
        cases.append((
            "sort_columns", f"S=1 U={LM_WORKERS} D={d} float32", True,
            lambda p, a=x: ops.sort_columns(a, plain=p),
            lambda a=x: torch.sort(a, dim=-2), 2 * x.numel() * 4,
            d * sort_ops(LM_WORKERS), "exact", None, None))
    return cases


def sizes_label(sizes) -> str:
    """A leaf-size tuple as it stands in a phase-3 row's shape."""
    return "+".join(str(n) for n in sizes)


def fixed_stats_cases(torch, ops, rnd):
    """The strict route's `grad_stats_segments` rows: one call over every
    leaf segment of a flat [R, D] slab, at each (R, sizes) of the main
    path: the LM lane's 14 leaves at R = 16 (its two analog lanes x 8
    workers, the mesh phase's strict LM case) and the paper MLP's (b1 | b2
    | w1 | w2) at the plan phase's R: 10 (the defense grid's analog group),
    40 (fig3's four lanes) and 60 (the switch dispatch's six lanes), and
    at the mesh phase's 1000 (the U = 1000 grid's analog lane, gathered
    over the worker shards), each beside `var_mean` over the same rows.
    Then the one-segment case, `grad_stats_fixed` on each leaf segment (a
    row-strided view).  grad_stats' tolerance, (rtol 1e-4, atol 1e-3)."""
    cases = []
    lm = tuple(lm_leaf_sizes())
    shapes = [(2 * LM_WORKERS, lm), (10, MLP_SEGMENTS), (40, MLP_SEGMENTS),
              (60, MLP_SEGMENTS), (1000, MLP_SEGMENTS)]
    for r, sizes in shapes:
        slab = rnd(r, sum(sizes))
        cases.append((
            "grad_stats_segments", f"R={r} sizes={sizes_label(sizes)} float32",
            True,
            lambda p, a=slab, z=sizes: ops.grad_stats_segments(a, z, plain=p),
            lambda a=slab: torch.var_mean(a, dim=1, correction=0),
            r * sum(sizes) * 4 + r * 2 * 4, 3 * r * sum(sizes),
            (1e-4, 1e-3), None, None))
    for r, sizes in shapes:
        slab, off, seen = rnd(r, sum(sizes)), 0, set()
        for n in sizes:
            seg = slab[:, off:off + n]
            off += n
            if n in seen:
                continue
            seen.add(n)
            cases.append((
                "grad_stats_segments",
                f"R={r} sizes={n} float32 (one leaf segment)", False,
                lambda p, a=seg: ops.grad_stats_fixed(a, plain=p),
                lambda a=seg: torch.var_mean(a, dim=1, correction=0),
                r * n * 4 + r * 2 * 4, 3 * r * n, (1e-4, 1e-3), None, None))
        del slab
    return cases


def large_u_sort_check(torch, ops) -> dict:
    """The sort past the bitonic cap (U = 8193 pads to 16384): no kernel,
    `sorted_columns` takes torch.sort on the card.  Equal exactly, no
    launch, one log record for the process; ms beside torch.sort's."""
    import logging
    from repro_torch.core import defenses
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger(defenses.__name__)
    log.addHandler(handler)
    gen = torch.Generator("cuda").manual_seed(2)
    rows = []
    try:
        ops.reset_launches()
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((2, ops.BITONIC_MAX_U + 1, 130), generator=gen,
                            device="cuda").to(dt)
            if not torch.equal(defenses.sorted_columns(x),
                               torch.sort(x, dim=-2).values):
                raise AssertionError(f"U = 8193 ({dt}): sorted_columns is "
                                     f"not torch.sort")
            rows.append({"shape": f"S=2 U=8193 D=130 {str(dt)[6:]}",
                         "ms": time_ms(torch, lambda a=x:
                                       defenses.sorted_columns(a), 10),
                         "torch_sort_ms": time_ms(torch, lambda a=x:
                                                  torch.sort(a, dim=-2), 10)})
    finally:
        log.removeHandler(handler)
    if any(ops.launch_counts().values()) or len(records) != 1:
        raise AssertionError(f"U = 8193: launches {ops.launch_counts()}, "
                             f"{len(records)} log records (want 0 and 1)")
    return {"rows": rows, "route": defenses.sort_route(8193),
            "log": records[0].getMessage()}


def decode_bytes_flops(b, h, kv, dh, pos, eb) -> tuple:
    """Bytes decode attention must move (q in, out, K and V up to pos) and
    its f32 operations (q.k and p.v, 2 each per element, and ~5 for the
    softmax per score), for element size eb: the kernel module's own cost
    (`decode_attention.bytes_flops`, which the dry run adds too)."""
    from repro_torch.kernels.decode_attention import bytes_flops
    return bytes_flops(b, h, kv, dh, pos + 1, eb)


def sdpa_call(torch, q, k, v, pos, want, tol):
    """The library yardstick: one `scaled_dot_product_attention` over the
    positions <= pos, GQA in the call (enable_gqa), restricted to the
    fused backends (the math backend would repeat K/V per query head).
    None where no fused backend takes the inputs.  Checked against the
    plain version first."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    args = (q[:, :, None], k[:, :pos + 1].transpose(1, 2),
            v[:, :pos + 1].transpose(1, 2))

    def fn():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(*args, enable_gqa=True)
    try:
        got = fn()[:, :, 0]
    except RuntimeError:
        return None
    if not torch.allclose(got.float(), want.float(), rtol=tol[0],
                          atol=tol[1]):
        raise AssertionError("scaled_dot_product_attention disagrees with "
                             "the plain decode attention")
    return fn


def decode_f32_ref(torch, ops, q, k, v, pos_t, rows: int = 8):
    """The plain decode attention on q, k, v upcast to f32, a few batch rows
    at a time (decode_32k's K and V would take 34 GB at once in f32)."""
    return torch.cat([ops.decode_attention(
        q[i:i + rows].float(), k[i:i + rows].float(), v[i:i + rows].float(),
        pos_t, plain=True) for i in range(0, q.shape[0], rows)])


def decode_cases(torch, ops):
    """decode_attention's phase-3 rows; pos is a device tensor, as on the
    serving path.  Each row carries its f32 reference (see DECODE_TOL_F32
    and DECODE_REL_BF16) as its ninth element; qwen3-4b's serve row at
    pos 63 also times the kernel at 1, 2 and 4 splits, and every other row
    gives the split count the wrapper plans (from S alone: a ring at
    pos >= S is planned as the S-position cache it reads); every row gives
    the kernel's and the plain version's mean |error| against the f32
    reference, over its mean |output|."""
    from repro_torch.kernels import decode_attention as DA
    gen = torch.Generator("cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for b, s, h, kv, dh, dt, pos, main in [
            (128, LONG_S, 32, 8, 128, bf16, LONG_S - 1, False),  # decode_32k
            (LONG_BATCH, LONG_S, 32, 8, 128, bf16, LONG_S - 1, True),
            (SERVE_BATCH, 64, 32, 8, 128, bf16, 63, True),    # serve, last
            (SERVE_BATCH, 64, 32, 8, 128, bf16, 40, False),   # mid-cache
            (2, 777, 8, 8, 128, bf16, 774, False),            # MHA, ragged
            (1, 512, 4, 1, 64, bf16, 509, False),             # MQA
            (1, 513, 12, 2, 32, bf16, 512, False),            # G = 6, dh 32
            (2, 1024, 8, 2, 64, f32, 1021, False),
            (LONG_BATCH, LONG_S, 32, 8, 128, f32, 16000, False),
            (LONG_BATCH, 4096, 32, 8, 128, bf16, 0, False),   # pos = 0
            # the zoo's serve shapes (phase 23): starcoder2-3b (G = 12, two
            # blocks a KV head), llama4 (G = 5), moonshot (G = 1, MHA)
            (SERVE_BATCH, 64, 24, 2, 128, bf16, 63, True),
            (SERVE_BATCH, 64, 40, 8, 128, bf16, 63, True),
            (SERVE_BATCH, 64, 16, 16, 128, bf16, 63, True),
            # a rank's share of the serve batch on the LM-mesh phase's
            # (2, 1) mesh (phase 22)
            (SERVE_BATCH // 2, 64, 32, 8, 128, bf16, 63, True),
            # a rank's heads on the LM-model phase's meshes (phase 25):
            # qwen3-4b and moonshot on (1, 2), starcoder2-3b on (1, 4)
            (SERVE_BATCH, 64, 16, 4, 128, bf16, 63, True),
            (SERVE_BATCH, 64, 8, 8, 128, bf16, 63, True),
            (SERVE_BATCH, TP_SC_PROMPT + TP_SC_GEN, 6, 1, 128, bf16,
             TP_SC_PROMPT + TP_SC_GEN - 1, True),
            # every head on every rank in the heads phase (31):
            # starcoder2-3b (G = 12) and llama4 (G = 5) on 16-slot caches
            (SERVE_BATCH, HEADS_PROMPT + HEADS_GEN, 24, 2, 128, bf16,
             HEADS_PROMPT + HEADS_GEN - 1, True),
            (SERVE_BATCH, HEADS_PROMPT + HEADS_GEN, 40, 8, 128, bf16,
             HEADS_PROMPT + HEADS_GEN - 1, True),
            # long_500k's rings (phase 24) at its last position: qwen3-4b
            # and granite-8b (8192 slots), starcoder2-3b (4096), and both
            # in f32 (phase 24's f32 runs across a wrap)
            (1, 8192, 32, 8, 128, bf16, LONG500_POS, True),
            (1, 4096, 24, 2, 128, bf16, LONG500_POS, True),
            (1, 8192, 32, 8, 128, f32, LONG500_POS, False),
            (1, 4096, 24, 2, 128, f32, LONG500_POS, False),
            # recurrentgemma-9b (phase 27) at dh 256, MQA with G = 16: its
            # serve and its long_500k ring of 2048 slots, in bf16 and f32
            # (the f32 checks), and a rank's 8 heads on (1, 2) (phase 25)
            (SERVE_BATCH, 64, 16, 1, 256, bf16, 63, True),
            (1, 2048, 16, 1, 256, bf16, LONG500_POS, True),
            (SERVE_BATCH, 64, 16, 1, 256, f32, 63, False),
            (1, 2048, 16, 1, 256, f32, LONG500_POS, False),
            (SERVE_BATCH, 64, 8, 1, 256, bf16, 63, True),
            # the frontends (phase 28): seamless-m4t-large-v2's decode
            # self-attention and its cross-attention over AUDIO_FRAMES
            # encoder positions (dh 64, G = 1), llava-next-mistral-7b's
            # 4096-slot long_500k ring
            (SERVE_BATCH, 64, 16, 16, 64, bf16, 63, True),
            (SERVE_BATCH, AUDIO_FRAMES, 16, 16, 64, bf16, AUDIO_FRAMES - 1,
             True),
            (1, 4096, 32, 8, 128, bf16, LONG500_POS, True)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dt)
                   for shape in [(b, h, dh), (b, s, kv, dh), (b, s, kv, dh)])
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        want = decode_f32_ref(torch, ops, q, k, v, pos_t)
        typical = float(want.abs().mean())
        if dt == f32:
            tol = sdpa_tol = DECODE_TOL_F32
        else:
            tol = (DECODE_REL_BF16, DECODE_REL_BF16 * typical)
            sdpa_tol = (SDPA_REL_BF16, SDPA_REL_BF16 * typical)
        # a ring at pos >= S attends (and reads) every slot once
        nbytes, flops = decode_bytes_flops(b, h, kv, dh, min(pos, s - 1),
                                           torch.finfo(dt).bits // 8)
        cases.append((
            "decode_attention",
            f"B={b} S={s} H={h} KV={kv} dh={dh} {str(dt)[6:]} pos={pos}",
            main, lambda p, a=(q, k, v, pos_t): ops.decode_attention(
                *a, plain=p),
            sdpa_call(torch, q, k, v, pos, want, sdpa_tol), nbytes, flops,
            tol, lambda w=want: w,
            lambda a=(q, k, v, pos_t), w=want, plan=(b, h, kv, s, dh, dt),
            serve=(b, s, h, pos) == (SERVE_BATCH, 64, 32, 63):
            {**({"split_ms": decode_split_ms(torch, *a)} if serve
                else {"n_split": DA._plan(0, *plan)[0]}),
             "mean_rel_err_vs_f32": {
                 route: float((ops.decode_attention(*a, plain=p).float()
                               - w).abs().mean() / w.abs().mean())
                 for route, p in (("kernel", False), ("plain", True))}}))
    return cases


def redesigned_ptxas(ptxas: dict) -> dict:
    """Registers, static shared memory and spill bytes per instance of the
    kernels redesigned for Hopper (decode_mma_kernel and bitonic_kernel,
    floa_combine_kernel, grad_stats_kernel and the strict route's
    segment_parts_kernel and segment_fold_kernel), from the build's
    ptxas -v lines.  In a mangled name only bf16 can repeat as a substitution
    (S<n>_): f is a builtin."""
    import re
    ty = r"(f|13__nv_bfloat16|S\d*_)"
    names = {"f": "f32", "13__nv_bfloat16": "bf16"}
    patterns = [
        (r"(decode_mma_kernel|bitonic_kernel)ILi(\d+)E(f|13__nv_bfloat16)?",
         lambda m: f"{m[1]}<{m[2]}"
                   f"{', ' + names[m[3]] if m[3] else ''}>"),
        (r"floa_combine_kernelILb([01])E" + ty + ty + r"Li(\d+)ELi(\d+)E",
         lambda m: f"floa_combine_kernel<{'true' if m[1] == '1' else 'false'}"
                   f", {names.get(m[2], 'bf16')}, {names.get(m[3], 'bf16')}"
                   f", {m[4]}, {m[5]}>"),
        (r"grad_stats_kernelI(f|13__nv_bfloat16)E",
         lambda m: f"grad_stats_kernel<{names[m[1]]}>"),
        (r"segment_parts_kernelI(f|13__nv_bfloat16)E",
         lambda m: f"segment_parts_kernel<{names[m[1]]}>"),
        (r"segment_fold_kernel", lambda m: "segment_fold_kernel")]
    found, entry = {}, None
    for line in (ptxas["decode_attention"] + ptxas["defense_sort"]
                 + ptxas["floa_aggregate"] + ptxas["grad_stats"]):
        if "Compiling entry" in line:
            entry = None
            for pattern, name in patterns:
                m = re.search(pattern, line)
                if m:
                    entry = name(m)
                    found[entry] = {"registers": None, "smem_bytes": 0,
                                    "spill_store_bytes": 0}
                    break
        elif entry and "Used" in line:
            found[entry]["registers"] = int(re.search(
                r"Used (\d+) registers", line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            found[entry]["smem_bytes"] = int(smem[1]) if smem else 0
        elif entry and "spill stores" in line:
            found[entry]["spill_store_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", line)[1])
    return found


def decode_split_ms(torch, q, k, v, pos_t) -> dict:
    """The serve shape's decode kernel timed at 1, 2 and 4 splits (keyed by
    split count), through its C entry point on a phase-3 row's inputs: what
    the split rule's one pass is weighed against.  Not counted as
    launches."""
    from repro_torch.kernels import _build
    b, h, dh = q.shape
    lib = _build.library("decode_attention")
    out = torch.empty_like(q)
    times = {}
    for n in (1, 2, 4):
        ws = torch.empty(b * h * n * (dh + 2), device=q.device)

        def launch(n=n, ws=ws):
            _build.check(lib.decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
                out.data_ptr(), ws.data_ptr(), b, h, k.shape[2], k.shape[1],
                dh, n, _build.DTYPE_CODES[q.dtype],
                torch.cuda.current_stream().cuda_stream), "decode_attention")
        times[n] = time_ms(torch, launch)
    return times


def run_phase(torch, ops, name, fn, expect):
    """Drive one main-path phase with the launch counts zeroed just before
    and read just after; check them against `expect`."""
    ops.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, want in expect.items():
        if counts[k] != want:
            raise AssertionError(f"{name}: {k} launched {counts[k]} times, "
                                 f"expected {want} ({counts})")
    return result, seconds, counts


def step_launches(ops, cfg, steps: int, init: bool = False) -> dict:
    """Every kernel's launches in `steps` FLOA train steps of cfg (the
    update kernel once a leaf a step, `noisy_sgd`), after an init of cfg's
    weights when `init` (`counter_trunc_normal` once a leaf it fills)."""
    from repro_torch.launch.sharding import filled_leaves, init_params
    from repro_torch.tree import tree_leaves
    n = len(tree_leaves(init_params(cfg, None, "meta")))
    return {**{k: 0 for k in ops.KERNELS}, "noisy_sgd": steps * n,
            "counter_trunc_normal": filled_leaves(cfg) if init else 0}


def lanes_report(result):
    acc = result.metrics["accuracy"]
    return {n: {"loss_first": float(result.loss[i, 0]),
                "loss_final": float(result.loss[i, -1]),
                "accuracy_final": float(acc[i, -1])}
            for i, n in enumerate(result.names)}


def whole_run_check(name, rk, rp) -> None:
    """A sweep through the kernels (rk) against the same sweep through the
    plain versions (rp): loss, grad norm and final weights at
    RTOL_WHOLE_RUN (atol 1e-6 on the weights; nested params leaf by leaf,
    each leaf's largest |diff| and, over all leaves, the largest |diff|
    relative to its leaf's largest |value|)."""
    import numpy as np
    import torch
    from repro_torch.tree import tree_leaves, tree_paths
    diffs = {"loss": max_errors(torch, torch.as_tensor(rk.loss),
                                torch.as_tensor(rp.loss))[1],
             "grad_norm": max_errors(torch, torch.as_tensor(rk.grad_norm),
                                     torch.as_tensor(rp.grad_norm))[1]}
    ok = np.allclose(rk.loss, rp.loss, rtol=RTOL_WHOLE_RUN) and np.allclose(
        rk.grad_norm, rp.grad_norm, rtol=RTOL_WHOLE_RUN)
    params_rel = 0.0
    for path, a, b in zip(tree_paths(rk.params), tree_leaves(rk.params),
                          tree_leaves(rp.params)):
        diffs[f"params.{path}"] = max_errors(torch, a, b)[0]
        params_rel = max(params_rel, diffs[f"params.{path}"]
                         / max(float(b.float().abs().max()), 1e-30))
        ok = ok and torch.allclose(a, b, rtol=RTOL_WHOLE_RUN, atol=1e-6)
    emit(name, rtol=RTOL_WHOLE_RUN, max_rel_err=diffs,
         params_max_rel_diff=params_rel, rounds=rk.loss.shape[1],
         ok=bool(ok))
    if not ok:
        raise AssertionError(f"{name}: kernel route and plain route "
                             f"disagree")


def profile_phase(torch, fn) -> dict:
    """Where a warm call of fn() spends its time: torch.profiler over one
    call after a warm-up call, device kernels grouped by name, and the
    device's busy share of the call's wall time (one stream, so kernel
    times add up)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(evt.name, (0.0, 0))
            kernels[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                 n + 1)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "kernel_launches": sum(n for _, n in kernels.values()),
            "top_kernels": [{"name": k[:120], "ms": ms, "count": n}
                            for k, (ms, n) in top],
            "top_host_ops": [{"name": e.key[:80], "count": e.count,
                              "self_cpu_ms": e.self_cpu_time_total / 1e3}
                             for e in host[:12]]}


def engine_run(build):
    """fn() for profile_phase: one full run of the engine build() returns."""
    engine, params, batches = build()
    return lambda: engine.run(params, batches)


def lm_params(torch, cfg):
    """cfg's random weights on the card, drawn as the serve phase draws
    them (seed 0), so both give the same model."""
    from repro_torch.launch.steps import init_model
    return init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda")


def decode_steps(step):
    """fn(params, caches, tokens1, pos) -> logits of `step` (a decode
    step), replayed as `serve`'s CUDA graph (`launch.serve.
    compile_decode`) unless a MoE routing tape is active (its cursor
    moves in Python at each call): the eager step then."""
    from repro_torch.launch.serve import compile_decode
    from repro_torch.models import moe as MOE
    if MOE.active_tape() is not None:
        return lambda *args: step(*args)[0]
    return compile_decode(step)


def teacher_forced(torch, cfg, params, seq, plain):
    """Logits [steps, B, Vp] of cfg's decode steps fed seq [B, steps] one
    position at a time from empty caches (the kernel route, or its plain
    version; `decode_steps`)."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import transformer as LM
    step, _ = make_decode_step(cfg, plain=plain)
    run = decode_steps(step)
    b, n = seq.shape
    caches = LM.init_caches(cfg, b, n, device="cuda")
    positions = torch.arange(n, dtype=torch.int32, device="cuda")
    return torch.stack([run(params, caches, seq[:, i:i + 1],
                            positions[i])[:, 0].clone() for i in range(n)])


def logit_parity(torch, lk, lp, vocab) -> tuple:
    """bf16 logits [steps, B, Vp] of the kernel route (lk) against the
    plain route (lp): ({max and mean |diff|, the logits' std, the share of
    argmax agreement, the steps whose top-2 gap exceeds twice the max
    bound and whether their argmax agrees}, ok at BF16_LOGIT_MAX /
    BF16_LOGIT_MEAN with every clear step agreeing)."""
    diff = (lk.float() - lp.float()).abs()
    top2 = lk[..., :vocab].float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * BF16_LOGIT_MAX
    same = lk[..., :vocab].argmax(-1) == lp[..., :vocab].argmax(-1)
    parity = {"max_abs_diff": float(diff.max()),
              "mean_abs_diff": float(diff.mean()),
              "logit_std": float(lk.float().std()),
              "argmax_agree": float(same.float().mean()),
              "clear_steps": int(clear.sum()),
              "clear_agree": bool(same[clear].all())}
    ok = (parity["max_abs_diff"] <= BF16_LOGIT_MAX
          and parity["mean_abs_diff"] <= BF16_LOGIT_MEAN
          and parity["clear_agree"])
    return parity, ok


def result_diff(np, torch, a, b) -> dict:
    """Two sweep results: whether they are equal bit for bit (NaN == NaN
    in the metrics), the lanes that are not, and the largest |a - b| of
    each output."""
    out, equal = {}, True
    differ = np.zeros(len(a.names), bool)
    for k in ("loss", "grad_norm"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        equal = equal and np.array_equal(x, y)
        differ |= (x != y).any(axis=1)
        out[k] = float(np.abs(x - y).max()) if x.size else 0.0
    for k in a.metrics:
        equal = equal and np.array_equal(a.metrics[k], b.metrics[k],
                                         equal_nan=True)
    for k in a.params:
        x, y = a.params[k].cpu(), b.params[k].cpu()
        equal = equal and torch.equal(x, y)
        differ |= (x != y).reshape(len(a.names), -1).any(dim=1).numpy()
        out[f"params.{k}"] = float((x - y).abs().max())
    return {"bitwise": bool(equal), "max_abs_diff": out,
            "lanes_differing": [n for n, f in zip(a.names, differ) if f],
            "max_rel_diff": {
                k: float(np.max(np.abs(np.asarray(getattr(a, k))
                                       - np.asarray(getattr(b, k)))
                                / np.maximum(np.abs(np.asarray(
                                    getattr(b, k))), 1e-30)))
                for k in ("loss", "grad_norm")}}


def resume_child(args) -> int:
    """`chip_smoke.py --resume-child ckpt DIR`: the showdown with the
    example's checkpoint plan, SIGKILLed right after its KILL_AFTER_SAVES-th
    checkpoint commits.  `--resume-child resume DIR OUT`: a fresh process
    resuming it, saving the result to OUT (`SweepResult.save`) and printing
    one JSON line of its timings.  Prints no result line."""
    import signal
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import figures
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.core import scenario as SC
    mode, ckpt_dir = args[0], args[1]
    if mode == "ckpt":
        orig, count = CK.save_pytree, [0]

        def save_then_die(*a, **k):
            out = orig(*a, **k)
            count[0] += 1
            if count[0] >= KILL_AFTER_SAVES:
                os.kill(os.getpid(), signal.SIGKILL)   # no clean-up
            return out

        CK.save_pytree = save_then_die   # the engine calls it by attribute
        figures.run_showdown(ROUNDS, device="cuda", checkpoint_dir=ckpt_dir)
        print("resume child: the sweep outlived its SIGKILL", file=sys.stderr)
        return 3
    times = {}
    orig_gains, orig_restore = SC.sample_gains, CK.restore_pytree

    def first_round(*a, **k):   # the first resumed round's gain draw
        times.setdefault("first_round", time.perf_counter())
        return orig_gains(*a, **k)

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = orig_restore(*a, **k)
        times["restore_s"] = time.perf_counter() - t0
        times["resumed_at_round"] = out[1]["extra"]["t_next"]
        return out

    SC.sample_gains, CK.restore_pytree = first_round, timed_restore
    t_call = time.perf_counter()
    result = figures.run_showdown(ROUNDS, device="cuda",
                                  checkpoint_dir=ckpt_dir, resume=True)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    result.save(args[2])
    print(json.dumps({"phase": "resume_child", "mode": "resume",
                      "resumed_at_round": times["resumed_at_round"],
                      "process_to_first_round_s":
                          times["first_round"] - T_START,
                      "call_to_first_round_s": times["first_round"] - t_call,
                      "restore_s": times["restore_s"],
                      "call_s": t_end - t_call}), flush=True)
    return 0


def mesh_case(name: str, sharded: bool):
    """One configuration of the mesh phase, built but not run: (engine,
    params0, batches, rounds).  The ranks build it sharded (every rank in
    the same order: a mesh's groups are made collectively); the parent
    builds its unsharded twin.

      defenses          the defense grid, "data" over the ranks, grouped
                        (each family ghost-padded to one lane a rank)
      defenses_switch   the same, the switch dispatch (3 lanes a rank)
      grid_u1000        worker_grid(1000), "workers" over the ranks
      lm                the LM lane at D = 2 950 528, model_shards = 2
                        (`figures.lm_lane_engine`, the example's path)
      *_strict          the same under strict_numerics"""
    from repro_torch import figures
    from repro_torch.configs import PAPER_MLP
    from repro_torch.fl import ExecutionPlan, SweepEngine
    from repro_torch.launch.mesh import make_sweep_mesh
    strict = name.endswith("_strict")
    if name.startswith("defenses"):
        plan = ExecutionPlan(mesh=make_sweep_mesh() if sharded else None,
                             grouped_dispatch=name == "defenses")
        return (*figures.cases_engine(figures.defense_cases(), ROUNDS,
                                      device="cuda", plan=plan), ROUNDS)
    if name.startswith("grid_u1000"):
        mc_u = dataclasses.replace(PAPER_MLP.full(), num_workers=1000,
                                   train_samples=32000)
        mesh = make_sweep_mesh(worker_shards=MESH_RANKS) if sharded else None
        return (*figures.cases_engine(
            figures.worker_grid(1000, mc_u.dim), MESH_ROUNDS_LARGE_U,
            mc=mc_u, device="cuda", plan=ExecutionPlan(
                mesh=mesh, strict_numerics=strict)),
            MESH_ROUNDS_LARGE_U)
    if not strict:
        return (*figures.lm_lane_engine(
            ROUNDS, device="cuda", model_shards=MESH_RANKS if sharded else 1),
            ROUNDS)
    engine, params, batches = figures.lm_lane_engine(ROUNDS_LM_STRICT,
                                                     device="cuda")
    mesh = make_sweep_mesh(model_shards=MESH_RANKS) if sharded else None
    return (SweepEngine(engine.loss_fn, engine.spec, plan=ExecutionPlan(
        mesh=mesh, strict_numerics=True), device="cuda"), params, batches,
        ROUNDS_LM_STRICT)


def mesh_expect(name: str, d: int, lm_sizes) -> dict:
    """A rank's launches by shape in one sharded run of `name`: the
    shard-local shapes (lanes, workers or columns of one rank)."""
    r, ru, rl = ROUNDS, MESH_ROUNDS_LARGE_U, ROUNDS_LM_STRICT
    u, half = LM_WORKERS, LM_D // MESH_RANKS   # LM_D pads to itself
    return {
        "defenses": {"floa_step_batched": {(1, 10, d): r},
                     "grad_stats": {(10, d): r},
                     "sort_columns": {(1, 10, d): 2 * r}},
        "defenses_switch": {"floa_aggregate_batched": {(3, 10, d): r},
                            "grad_stats": {(30, d): r},
                            "sort_columns": {(3, 10, d): 2 * r}},
        "grid_u1000": {"grad_stats": {(500, d): ru},
                       "sort_columns_bitonic": {(1, 1000, d): 2 * ru}},
        "grid_u1000_strict": {
            "floa_step_batched": {(1, 1000, d): ru},
            "grad_stats_segments": {(1000, MLP_SEGMENTS): 2 * ru},
            "sort_columns_bitonic": {(1, 1000, d): 2 * ru}},
        "lm": {"floa_step_batched": {(2, u, half): r},
               "grad_stats": {(2 * u, half): r},
               "sort_columns": {(1, u, half): r}},
        "lm_strict": {"floa_step_batched": {(2, u, LM_D): rl},
                      # the analog group's 2 lanes x 8 workers, two
                      # launches a round (the parts and the fold kernel)
                      "grad_stats_segments": {(2 * u, tuple(lm_sizes)):
                                              2 * rl},
                      "sort_columns": {(1, u, LM_D): rl}}}[name]


def mesh_child_cases(torch, rank: int, out: str) -> None:
    """Phase 21's part of a 2-rank `--ranks-child`: every MESH_CASES
    configuration sharded over the MESH_RANKS ranks, the launch counts
    zeroed just before and read just after (checked against
    `mesh_expect`), then an uncounted warm run for the rate; saves each
    result to OUT/<case>.r<rank> (`SweepResult.save`) and prints one JSON
    line a case."""
    import torch.distributed as dist
    from repro_torch.fl.sweep import make_row_unflatten
    from repro_torch.kernels import ops
    if dist.get_world_size() != MESH_RANKS:
        raise AssertionError(f"mesh child: {dist.get_world_size()} ranks, "
                             f"not {MESH_RANKS}")
    print(json.dumps({"phase": "mesh_child", "rank": rank,
                      "backend": dist.get_backend(),
                      "world_size": dist.get_world_size()}), flush=True)
    for name in MESH_CASES:
        engine, params, batches, rounds = mesh_case(name, sharded=True)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = engine.run(params, batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: v for k, v in ops.launch_shapes().items() if v}
        d = engine.spec.cases[0].floa.power.dim
        want = mesh_expect(name, d, make_row_unflatten(params)[1]
                           if name == "lm_strict" else ())
        if got != want:
            raise AssertionError(f"mesh {name} rank {rank}: launches by "
                                 f"shape {got}, expected {want}")
        t0 = time.perf_counter()
        engine.run(params, batches)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        res.save(os.path.join(out, f"{name}.r{rank}"))
        print(json.dumps({
            "phase": "mesh_child", "rank": rank, "case": name,
            "rounds": rounds, "run_seconds": seconds,
            "warm_run_seconds": warm, "rounds_per_s": rounds / warm,
            "rate_label": f"{MESH_RANKS} ranks, gloo, one card",
            "launches_by_shape": {k: [[list(sh), n] for sh, n in v.items()]
                                  for k, v in got.items()}}), flush=True)
        del engine, params, batches, res
        torch.cuda.empty_cache()


def shape_key(shape) -> tuple:
    """A launch shape read back from JSON as the wrapper counted it: lists
    to tuples ((R, sizes) for `grad_stats_segments`)."""
    return tuple(tuple(x) if isinstance(x, list) else x for x in shape)


def tree_diff(np, torch, a, b, tol=None) -> dict:
    """Two sweep results with nested params: bitwise or not, the largest
    |a - b| and |a - b| / |b| of the loss, the grad norm and the params,
    and, with tol = (rtol, atol), whether they agree within it."""
    from repro_torch.tree import tree_leaves, tree_paths
    pairs = [("loss", np.asarray(a.loss), np.asarray(b.loss)),
             ("grad_norm", np.asarray(a.grad_norm), np.asarray(b.grad_norm))]
    pairs += [(k, np.asarray(a.metrics[k]), np.asarray(b.metrics[k]))
              for k in b.metrics]
    pairs += [(f"params.{p}", x.cpu().numpy(), y.cpu().numpy())
              for p, x, y in zip(tree_paths(b.params), tree_leaves(a.params),
                                 tree_leaves(b.params))]
    out = {"bitwise": a.names == b.names and all(
        np.array_equal(x, y, equal_nan=True) for _, x, y in pairs),
        "max_abs_diff": {}, "max_rel_diff": {}}
    ok = a.names == b.names
    for k, x, y in pairs:
        fin = np.isfinite(y)
        diff = np.abs(x - y)[fin]
        out["max_abs_diff"][k] = float(diff.max()) if diff.size else 0.0
        out["max_rel_diff"][k] = float((diff / np.maximum(
            np.abs(y[fin]), 1e-30)).max()) if diff.size else 0.0
        if tol is not None:
            ok = ok and np.allclose(x, y, rtol=tol[0], atol=tol[1],
                                    equal_nan=True)
    out["ok"] = bool(out["bitwise"] if tol is None else ok)
    return out


def mesh_one_rank(torch, np, ops, figures, tally, work) -> None:
    """Phase 21 (1): a one-rank NCCL group and its ("data",) mesh: Fig. 3's
    sweep bitwise the unmeshed run (the FileStore under `work`)."""
    import torch.distributed as dist
    from repro_torch.core.power_control import Policy
    from repro_torch.fl import ExecutionPlan
    from repro_torch.launch.mesh import make_sweep_mesh
    fig3 = [figures.Experiment(f"{n}@ah{ah}", p, n_attackers=1,
                               alpha_hat=ah, attacker_sigma=3.0,
                               rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(work, 'nccl')}",
        world_size=1, rank=0)
    try:
        mesh = make_sweep_mesh()
        engine, params, batches = figures.figure_engine(
            fig3, device="cuda", plan=ExecutionPlan(mesh=mesh))
        if engine._lane_group is None:
            raise AssertionError("mesh: the one-rank mesh has no group")
        meshed, seconds, counts = run_phase(
            torch, ops, "mesh_one_rank_nccl",
            lambda: engine.run(params, batches),
            {**{k: 0 for k in ops.KERNELS},
             "floa_step_batched": ROUNDS, "grad_stats": ROUNDS})
        tally(counts)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    engine, params, batches = figures.figure_engine(fig3, device="cuda")
    diff = tree_diff(np, torch, meshed, engine.run(params, batches))
    emit("mesh_one_rank", backend=backend, lanes=len(fig3),
         rounds=ROUNDS, run_seconds=seconds, vs_unmeshed=diff)
    if not diff["bitwise"]:
        raise AssertionError("mesh: the one-rank NCCL mesh differs from "
                             "the unmeshed run")
    del engine, params, batches, meshed
    torch.cuda.empty_cache()


def mesh_compare(torch, np, lines, work, shard_tally) -> None:
    """Phase 21 (2), in the parent after the 2-rank spawn: each sharded
    configuration of MESH_CASES (the ranks' results under `work`, their
    JSON `lines` by rank) against its unsharded twin run here: the defense
    grid over "data" and the U = 1000 grid over "workers" at rtol 5e-6 /
    atol 1e-6, the LM lane over "model" at rtol 5e-5 / atol 1e-5, the
    strict runs bitwise; every rank's result the same.  The ranks'
    launches go to `shard_tally`."""
    from repro_torch.fl import SweepResult
    child_lines = {(line["case"], r): line for r, rank_lines in lines.items()
                   for line in rank_lines
                   if line["phase"] == "mesh_child" and "case" in line}
    for (name, r), line in child_lines.items():
        shard_tally(name, {k: {shape_key(sh): n for sh, n in v}
                           for k, v in line["launches_by_shape"].items()})
    for name in MESH_CASES:
        got = [SweepResult.load(os.path.join(work, f"{name}.r{r}"))
               for r in range(MESH_RANKS)]
        ranks_eq = [tree_diff(np, torch, g, got[0])["bitwise"]
                    for g in got[1:]]
        engine, params, batches, rounds = mesh_case(name, sharded=False)
        want = engine.run(params, batches)
        del engine, params, batches
        tol = MESH_TOL.get(name)   # None: bitwise
        diff = tree_diff(np, torch, got[0], want, tol)
        report = {"tolerance": tol or "bitwise",
                  "ranks_bitwise_equal": all(ranks_eq), **diff,
                  **{k: child_lines[(name, 0)][k] for k in (
                      "rounds", "run_seconds", "warm_run_seconds",
                      "rounds_per_s", "rate_label")}}
        emit("mesh_compare", case=name, **report)
        if not (all(ranks_eq) and diff["ok"]):
            raise AssertionError(f"mesh: {name} sharded vs unsharded "
                                 f"failed: {report}")
        del got, want
        torch.cuda.empty_cache()
    emit("mesh", ranks=MESH_RANKS, backend="gloo", device="cuda:0",
         cases=list(MESH_CASES))


def bit_checksums(torch, leaves) -> "torch.Tensor":
    """[leaves, 2] exact int64 checksums of each leaf's bits: the sum of its
    16- or 32-bit words, and the sum of each word times (its index mod
    65521) + 1, wrapping mod 2^64 (integer sums do not depend on the order
    of the adds).  Two ranks whose leaves are equal bit for bit give equal
    rows; the rows are compared over the process group."""
    words = {2: torch.int16, 4: torch.int32}
    out = []
    for x in leaves:
        flat = x.detach().reshape(-1).view(words[x.element_size()])
        plain = weighted = torch.zeros((), dtype=torch.int64,
                                       device=x.device)
        for i in range(0, flat.numel(), 1 << 26):
            w = flat[i:i + (1 << 26)].to(torch.int64)
            pos = torch.arange(i, i + w.numel(), device=x.device) % 65521 + 1
            plain = plain + w.sum()
            weighted = weighted + (w * pos).sum()
        out.append(torch.stack([plain, weighted]))
    return torch.stack(out).cpu()


def ranks_agree(sums) -> bool:
    """Whether every rank of the process group holds the same checksums
    (`bit_checksums`, gathered on the CPU over gloo)."""
    import torch.distributed as dist
    from repro_torch.launch.distributed import all_gather
    every = all_gather(sums[None], dist.group.WORLD)
    return bool((every == every[:1]).all())


def lm_mesh_parts(torch, rank: int, world: int, out: str) -> None:
    """Phase 22's part of a `--ranks-child` (WORLD ranks on cuda:0, gloo).
    WORLD = 2: (a) LM_MESH_STEPS BEV train steps of qwen3-4b at full width,
    cut to LM_MESH_A_LAYERS layers,
    on the (2, 1) mesh from the serve weights, then (c) the serve on it,
    counted, and the serve's sequence (OUT/seq.pt) teacher-forced through
    the mesh's decode step; rank 0 saves the serve's tokens and logits and
    the teacher-forced logits to OUT/serve.pt.  WORLD = 4: (b)
    LM_MESH_STEPS train steps of the 2-layer f32 cut on (4, 1) for each
    policy of LM_MESH_POLICIES, then rank 0 the same steps over all U
    workers in one process (`WorkerAxes.every(4)`, the other ranks at a
    barrier), compared at RTOL_WHOLE_RUN.  Every rank's params are
    compared by `bit_checksums`.  One JSON line a part."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.power_control import Policy
    from repro_torch.data import sample_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import WorkerAxes, make_debug_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as LM
    from repro_torch.tree import tree_leaves, tree_map, tree_paths
    lm = get_config(LM_ARCH)
    mesh = make_debug_mesh((world, 1), ("data", "model"))
    shape = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, kind="train")
    tokens = [torch.as_tensor(sample_tokens(TRAIN_BATCH, TRAIN_SEQ + 1,
                                            lm.vocab_size, seed=t),
                              device="cuda") for t in range(LM_MESH_STEPS)]
    reduce_ms = []
    sum_over_workers = ST._sum_over_workers

    def timed_sum(grads, group):   # the gradients' all_reduce, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sum_over_workers(grads, group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    ST._sum_over_workers = timed_sum

    def train(cfg, where, policy):
        """LM_MESH_STEPS steps on `where` (a mesh or a WorkerAxes) from
        cfg's weights (`lm_params`), made here so that no caller holds the
        first step's input through the run (a step's peak is its input,
        its gradients and its output): (checksums of the weights drawn,
        params, log, meta)."""
        step, meta = ST.make_train_step(cfg, where, shape, alpha=TRAIN_ALPHA,
                                        policy=Policy(policy), fsdp=False)
        params = lm_params(torch, cfg)
        before = bit_checksums(torch, tree_leaves(params))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, log = ST.init_floa_state("cuda"), []
        for t in range(LM_MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_reduce = len(reduce_ms)
            params, state, m = step(params, state, {"tokens": tokens[t]}, t)
            torch.cuda.synchronize()
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "all_reduce_ms": sum(reduce_ms[n_reduce:]),
                        "loss": float(m["loss"]),
                        "grad_scale": float(m["grad_scale"]),
                        "gbar": float(state["gbar"]),
                        "eps2": float(state["eps2"])})
        return before, params, log, meta

    if world == 2:
        # (a) the full-width train step, cut in depth
        ops.reset_launches()
        lm_a = dataclasses.replace(lm, n_layers=LM_MESH_A_LAYERS)
        before, params, log, meta = train(lm_a, mesh, "bev")
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        counts = ops.launch_counts()
        torch.cuda.empty_cache()
        after = bit_checksums(torch, tree_leaves(params))
        equal = ranks_agree(after)
        moved = int((after != before).any(dim=1).sum())
        del params
        torch.cuda.empty_cache()
        print(json.dumps({
            "phase": "lm_mesh_child", "rank": rank, "part": "train",
            "arch": lm.name, "dtype": str(lm.dtype)[6:],
            "layers": lm_a.n_layers,
            "mesh": dict(mesh.shape), "workers": meta["num_workers"],
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": log,
            "ms_per_step_warm": sum(x["ms"] for x in log[1:])
            / (LM_MESH_STEPS - 1),
            "all_reduce_ms_warm": sum(x["all_reduce_ms"] for x in log[1:])
            / (LM_MESH_STEPS - 1),
            "grad_bytes": 2 * meta["dim"], "peak_memory_gb": peak / 1e9,
            "peak_reserved_gb": peak_reserved / 1e9,
            "leaves_moved": moved, "leaves": len(after),
            "ranks_bitwise_equal": equal, "launches": counts,
            "rate_label": f"{world} ranks, gloo, one card"}), flush=True)
        if not (equal and moved and all(math.isfinite(x["loss"])
                                        for x in log)
                and counts == step_launches(ops, lm_a, LM_MESH_STEPS,
                                            init=True)):
            raise AssertionError(f"lm mesh train: ranks equal {equal}, "
                                 f"{moved} leaves moved, {log}, {counts}")
        # (c) the serve, counted, and its sequence teacher-forced
        ops.reset_launches()
        res = serve(lm, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, device="cuda",
                    mesh=mesh, fsdp=False)
        torch.cuda.synchronize()
        shapes = {k: [[list(sh), n] for sh, n in v.items()]
                  for k, v in ops.launch_shapes().items() if v}
        equal = ranks_agree(bit_checksums(
            torch, [res.tokens.to(torch.int32), res.logits]))
        seq = torch.load(os.path.join(out, "seq.pt")).to("cuda")
        step, meta = ST.make_decode_step(lm, mesh=mesh, fsdp=False)
        rows = ST.batch_rows(mesh, SERVE_BATCH)
        params = lm_params(torch, lm)
        n = seq.shape[1]
        caches = LM.init_caches(lm, rows.stop - rows.start, n,
                                device="cuda")
        positions = torch.arange(n, dtype=torch.int32, device="cuda")
        tf = torch.stack([step(params, caches, seq[:, i:i + 1],
                               positions[i])[0][:, 0] for i in range(n)])
        if rank == 0:
            torch.save({"tokens": res.tokens.cpu(), "logits": res.logits.cpu(),
                        "teacher_forced": tf.cpu()},
                       os.path.join(out, "serve.pt"))
        print(json.dumps({
            "phase": "lm_mesh_child", "rank": rank, "part": "serve",
            "batch": SERVE_BATCH, "rank_rows": rows.stop - rows.start,
            "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN,
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "decode_tok_per_s": res.tok_per_s,
            "ms_per_step": res.decode_s * 1e3 / SERVE_GEN,
            "ranks_bitwise_equal": equal, "launches_by_shape": shapes,
            "rate_label": f"{world} ranks, gloo, one card"}), flush=True)
        del params, caches, res, tf
        if not equal:
            raise AssertionError("lm mesh serve: the ranks' tokens or "
                                 "logits differ")
    else:
        # (b) the 2-layer f32 cut, one attacker, against the one-process twin
        cfg = dataclasses.replace(lm, n_layers=LM_MESH_B_LAYERS,
                                  dtype=torch.float32)
        runs = {}
        for policy in LM_MESH_POLICIES:
            _, params, log, meta = train(cfg, mesh, policy)
            equal = ranks_agree(bit_checksums(torch, tree_leaves(params)))
            runs[policy] = (tree_map(lambda x: x.cpu(), params)
                            if rank == 0 else None, log, equal)
            del params
            torch.cuda.empty_cache()
        # rank 0: the twin, every worker in this process
        for policy, (got, log, equal) in (runs.items() if rank == 0
                                           else ()):
            _, want, wlog, wmeta = train(cfg, WorkerAxes.every(world), policy)
            worst, ok = 0.0, equal
            for path, a, b in zip(tree_paths(want), tree_leaves(got),
                                  tree_leaves(want)):
                a = a.to("cuda")
                ok = ok and bool(torch.allclose(a, b, rtol=RTOL_WHOLE_RUN,
                                                atol=1e-6))
                worst = max(worst, float((a - b).abs().max())
                            / max(float(b.abs().max()), 1e-30))
            # the metrics as the params: |a - b| <= atol + rtol |b| (gbar,
            # the mean gradient over ~1e9 cancelling terms, is ~1e-9)
            keys = ("loss", "grad_scale", "gbar", "eps2")
            metric_abs = {k: max(abs(x[k] - y[k]) for x, y in zip(log, wlog))
                          for k in keys}
            metric_rel = {k: max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                                 for x, y in zip(log, wlog)) for k in keys}
            ok = ok and all(abs(x[k] - y[k]) <= 1e-6 + RTOL_WHOLE_RUN
                            * abs(y[k]) for x, y in zip(log, wlog)
                            for k in keys)
            print(json.dumps({
                "phase": "lm_mesh_child", "rank": rank, "part": "byzantine",
                "policy": policy, "arch": cfg.name, "dtype": "float32",
                "layers": cfg.n_layers, "mesh": dict(mesh.shape),
                "workers": wmeta["num_workers"],
                "attackers": ST.default_floa(
                    WorkerAxes.every(world),
                    wmeta["dim"])["attack"].byzantine_mask,
                "steps": log, "twin_steps": wlog,
                "rtol": RTOL_WHOLE_RUN, "atol": 1e-6,
                "params_max_rel_diff": worst, "metrics_max_abs_diff":
                metric_abs, "metrics_max_rel_diff": metric_rel,
                "ranks_bitwise_equal": equal, "ok": ok}),
                flush=True)
            if not ok:
                raise AssertionError(f"lm mesh byzantine {policy}: the ranks "
                                     f"and the one-process twin disagree")
            del want
            torch.cuda.empty_cache()
        dist.barrier()
    ST._sum_over_workers = sum_over_workers


def spawn_ranks(flag: str, world: int, work: str, timeout: int,
                extra=()):
    """Run `chip_smoke.py FLAG RANK WORLD STORE WORK [EXTRA]` as `world`
    ranks on this card (a new FileStore under `work`, logs in
    work/<flag>.rank<r>.log);
    every rank must exit 0, and the first that does not (or the timeout)
    ends the others.  The ranks share the card, so their allocators
    map expandable segments (unless PYTORCH_CUDA_ALLOC_CONF says
    otherwise): a rank's cache then holds little beyond what it has
    allocated, where fixed segments fragment to half as much again and more
    and can starve the other ranks.  Returns the JSON lines each rank
    printed, by rank, and the seconds the ranks took."""
    tag = flag.strip("-")
    env = dict(os.environ)
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # a store of its own for each group: an earlier group's FileStore, left
    # behind, would hand this group's ranks its dead ranks' addresses
    store = os.path.join(work, f"{tag}.{world}.store")
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    logs = [open(os.path.join(work, f"{tag}.rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(world),
         store, work, *extra], cwd=ROOT, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        # a rank that fails ends the others at once: they would wait for
        # it in their next collective until the group's timeout
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.perf_counter() - t0 < timeout):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    lines, failed = {}, []
    for r, p in enumerate(procs):
        text = open(os.path.join(work, f"{tag}.rank{r}.log")).read()
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}: {text[-3000:]}")
        lines[r] = [json.loads(x) for x in text.splitlines()
                    if x.startswith('{"phase": ')]
    if failed:
        raise AssertionError(f"{tag}: " + "\n".join(failed))
    return lines, time.perf_counter() - t0


def lm_mesh_check(torch, lm, rs, lines, work, shard_tally) -> None:
    """Phase 22, in the parent after the spawns: the ranks' JSON `lines`
    by world size and rank; (c)'s logits (work/serve.pt) against the
    one-process serve `rs` (phase 14's) at phase 15's bf16 bounds, the
    teacher-forced ones on rs's sequence, and its greedy tokens equal to
    rs's up to each row's first step whose top-2 margin is not clear.  The
    ranks' decode launches by shape go to `shard_tally`."""
    for r, rank_lines in lines[2].items():
        for line in rank_lines:
            if line["phase"] == "lm_mesh_child" and line["part"] == "serve":
                shard_tally("lm_mesh_serve", {
                    k: {shape_key(sh): n for sh, n in v}
                    for k, v in line["launches_by_shape"].items()})
    parts = {w: [x["part"] for x in lines[w][0]
                 if x["phase"] == "lm_mesh_child"] for w in (2, 4)}
    if parts != {2: ["train", "serve"],
                 4: ["byzantine"] * len(LM_MESH_POLICIES)}:
        raise AssertionError(f"lm mesh: rank 0 reported {parts}")
    got = torch.load(os.path.join(work, "serve.pt"))
    parity, ok = logit_parity(torch, got["teacher_forced"].to("cuda"),
                              rs.logits, lm.vocab_size)
    ref = rs.logits[SERVE_PROMPT - 1:-1, :, :lm.vocab_size].float()
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 2 * BF16_LOGIT_MAX).cpu()
    same = got["tokens"] == rs.tokens.cpu()            # [B, gen]
    # a step is held where the row's earlier tokens agree (the same
    # inputs so far) and the one-rank top-2 margin is clear
    prefix = torch.cat([torch.ones(SERVE_BATCH, 1, dtype=torch.bool),
                        same[:, :-1].cumprod(dim=1).bool()], dim=1)
    held = prefix & clear.T
    tokens_ok = bool(same[held].all())
    serve_diff = (got["logits"].to("cuda").float()
                  - rs.logits.float()).abs()
    emit("lm_mesh_serve", ranks=2, backend="gloo", device="cuda:0",
         tol={"max_abs": BF16_LOGIT_MAX, "mean_abs": BF16_LOGIT_MEAN},
         teacher_forced_vs_one_rank=parity,
         serve_max_abs_diff=float(serve_diff.max()),
         serve_mean_abs_diff=float(serve_diff.mean()),
         tokens_equal_share=float(same.float().mean()),
         tokens_held=int(held.sum()), tokens_ok=tokens_ok,
         one_rank_tok_per_s=rs.tok_per_s, ok=ok and tokens_ok)
    if not (ok and tokens_ok):
        raise AssertionError("lm mesh serve: the 2-rank serve and the "
                             "one-rank serve disagree")
    emit("lm_mesh", ranks=[2, 4], backend="gloo", device="cuda:0")


def timed_collectives(torch) -> list:
    """Time every collective of the LM steps on this rank (the
    all_reduces, all_gathers and reduce_scatters of `launch.distributed`,
    the sequence split's among them; the CE's max, the stale stats' sum
    and the logits' gathers), the device synced around each: gloo
    stages CUDA tensors through the host, which syncs the stream anyway.
    Returns the one-element list the milliseconds accumulate in."""
    from repro_torch.launch import distributed as D
    from repro_torch.launch import steps as ST
    from repro_torch.models import common as C
    from repro_torch.models import transformer as LM
    acc = [0.0]

    def timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[0] += (time.perf_counter() - t0) * 1e3
            return out
        return run
    D.all_reduce_sum = timed(D.all_reduce_sum)
    D.all_gather = timed(D.all_gather)
    D.reduce_scatter = timed(D.reduce_scatter)
    C.all_reduce_max = timed(C.all_reduce_max)
    ST.all_reduce_sum = timed(ST.all_reduce_sum)
    LM.all_gather = timed(LM.all_gather)
    return acc


def tp_train(torch, cfg, mesh, coll, tape=None, params=None, draws=None,
             steps=LM_MODEL_STEPS, constrain="sequence"):
    """`steps` BEV train steps of cfg on `mesh` (a model mesh, or None / a
    WorkerAxes: one process) from cfg's weights (`lm_params`'s, this
    rank's shards of them; or `params`, given), under `tape`'s routing
    when given, each step's draws `draws[t]` (None: seeded t), the
    residual stream on `constrain`'s route: (checksums of the initial
    shards, the final shards, the log, meta, peak memory GB; meta's
    "held_gb" the memory held as the steps start).  Each step's
    collectives' ms (`timed_collectives`) in its log entry."""
    import contextlib
    from repro_torch.core.power_control import Policy
    from repro_torch.launch import steps as ST
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_leaves
    shape = dict(global_batch=TRAIN_BATCH, seq_len=tp_seq(cfg), kind="train")
    step, meta = ST.make_train_step(cfg, mesh, shape, alpha=TRAIN_ALPHA,
                                    policy=Policy.BEV, fsdp=False,
                                    constrain=constrain)
    if params is None:
        params = ST.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                               "cuda", mesh=mesh, fsdp=False)
    before = bit_checksums(torch, tree_leaves(params))
    batches = [lm_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, t, FRONT_TP_N)
               for t in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    meta["held_gb"] = torch.cuda.memory_allocated() / 1e9
    state, log = ST.init_floa_state("cuda"), []
    with (MOE.routing(tape) if tape is not None else contextlib.nullcontext()):
        for t in range(steps):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), coll[0]
            params, state, m = step(params, state, batches[t], t,
                                    draws=None if draws is None
                                    else draws[t])
            torch.cuda.synchronize()
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "collective_ms": coll[0] - c0,
                        "loss": float(m["loss"]),
                        "grad_scale": float(m["grad_scale"]),
                        "gbar": float(state["gbar"]),
                        "eps2": float(state["eps2"])})
    return (before, params, log, meta,
            torch.cuda.max_memory_allocated() / 1e9)


def tp_tape_sums(torch, tape):
    """`bit_checksums` of a RoutingTape's recorded choices (as int32)."""
    return bit_checksums(torch, [x.to(torch.int32) for x in tape.recorded])


def tp_seq(cfg) -> int:
    """The train steps' input-shape length of the rank phases: TRAIN_SEQ
    text positions, after a VLM's FRONT_TP_N prefix positions."""
    return TRAIN_SEQ + (FRONT_TP_N if cfg.arch_type == "vlm" else 0)


def tp_grads(torch, cfg, mesh, tape, params=None, sequence=False):
    """The gradient of the train step's loss at U = 1 and unit weight (the
    mean per-sequence CE plus the MoE aux term) on step 0's batch, from
    cfg's weights (`lm_params`'s, or `params`, given; this rank's shards on
    a model mesh), under `tape`'s routing, the residual stream replicated
    over "model" or (sequence) split on the sequence, the norms' scales
    then summed over "model" as the train step sums them: a list of
    leaves (this rank's shards)."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import model_axis
    from repro_torch.launch.sharding import row_leaves
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import tensor_parallel
    from repro_torch.tree import tree_flatten, tree_unflatten
    if params is None:
        params = ST.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                               "cuda", mesh=mesh)
    leaves, treedef = tree_flatten(params)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    batch = lm_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, FRONT_TP_N)
    axis = model_axis(mesh)
    with MOE.routing(tape), tensor_parallel(axis, sequence):
        per_ex, aux = ST.per_example_loss(tree_unflatten(treedef, xs),
                                          batch, cfg)
        loss = per_ex.float().mean()
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_coef * aux
    grads = list(torch.autograd.grad(loss, xs))
    if sequence:
        ST.sum_leaves(grads, row_leaves(cfg, axis.size), axis.group)
    return grads


def replaying(tape):
    """A fresh RoutingTape replaying `tape`'s recorded expert choices (its
    own flips counted), leaving `tape` as it is."""
    from repro_torch.models import moe as MOE
    twin = MOE.RoutingTape()
    twin.recorded = list(tape.recorded)
    return twin.replay()


def ranks_max(torch, values) -> list:
    """The elementwise max over the process group of a list of floats."""
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def train_route_fields(log, peak, meta) -> dict:
    """A train run's (`tp_train`'s log, peak and meta) warm ms a step,
    collectives' ms, peak a rank and peak above the memory held as it
    started, on the route it took."""
    warm = log[1:]
    return {"constrain": meta["constrain"],
            "ms_per_step_warm": sum(x["ms"] for x in warm) / len(warm),
            "collective_ms_warm": sum(x["collective_ms"] for x in warm)
            / len(warm), "peak_memory_gb": peak,
            "peak_above_held_gb": peak - meta["held_gb"]}


def train_routes(torch, cfg, mesh, coll, first, tape=None) -> dict:
    """(g) for (b) and (d): `first`, tp_train's (_, params, log, meta,
    peak) on the default "sequence" route, against the same steps on
    "batch_only" from the same weights and draws (replaying `tape`'s
    expert choices when given): each route's ms, collectives' ms and
    peak; over every rank the params' elements outside TP_PARAM_ULPS
    above TP_PARAM_FLOOR, their largest relative difference, the losses'
    largest |difference| and eps2's relative one, and the verdict (the
    same on every rank)."""
    from repro_torch.tree import tree_leaves
    _, params, log, meta, peak = first
    seq = train_route_fields(log, peak, meta)
    twin = replaying(tape) if tape is not None else None
    _, other, olog, ometa, opeak = tp_train(torch, cfg, mesh, coll, twin,
                                            constrain="batch_only")
    outside, worst = 0.0, 0.0
    for a, b in zip(tree_leaves(params), tree_leaves(other)):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        lim = TP_PARAM_ULPS * torch.maximum(a.abs(), b.abs())
        outside += float((d > lim + TP_PARAM_FLOOR).sum())
        worst = max(worst, float(d.max()) / max(float(b.abs().max()),
                                                1e-30))
    del other, a, b, d, lim
    torch.cuda.empty_cache()
    outside, worst, loss, eps2 = ranks_max(torch, [
        outside, worst, max(abs(x["loss"] - y["loss"])
                            for x, y in zip(log, olog)),
        max(abs(x["eps2"] - y["eps2"]) / abs(y["eps2"])
            for x, y in zip(log, olog))])
    ok = (seq["constrain"] == "sequence" and ometa["constrain"]
          == "batch_only" and outside == 0 and loss <= BF16_LOGIT_MEAN
          and eps2 <= 1e-2)
    return {"sequence": seq,
            "batch_only": train_route_fields(olog, opeak, ometa),
            "params_outside_max_rank": outside, "params_max_rel_diff": worst,
            "loss_max_abs_diff": loss, "eps2_max_rel_diff": eps2,
            "router_flips": int(twin.flips) if twin is not None
            and twin.flips is not None else 0,
            "param_tol": {"rel": TP_PARAM_ULPS, "floor": TP_PARAM_FLOOR},
            "loss_tol": BF16_LOGIT_MEAN, "ok": ok}


def timed_grads(torch, cfg, mesh, tape, coll, sequence) -> tuple:
    """`tp_grads` on a route, timed: (the gradient, its route's ms,
    collectives' ms, peak GB and peak above the memory held before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0, c0 = time.perf_counter(), coll[0]
    grads = tp_grads(torch, cfg, mesh, tape, sequence=sequence)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return grads, {"constrain": SEQ_ROUTES[not sequence],
                   "ms": (time.perf_counter() - t0) * 1e3,
                   "collective_ms": coll[0] - c0,
                   "peak_memory_gb": peak / 1e9,
                   "peak_above_held_gb": (peak - held) / 1e9}


def grads_routes(torch, cfg, mesh, grads, gtape, coll, first) -> dict:
    """(g) for (f) and the frontends: the gradient of the step's loss on
    "sequence" (replaying `gtape`'s expert choices) against `grads`, the
    "batch_only" one `timed_grads` gave with `first` (its route's
    fields): each route's ms, collectives' ms and peak, and each leaf's
    |a - b|_2 / |b|_2 over every rank's shards (the same on every
    rank)."""
    import torch.distributed as dist
    from repro_torch.tree import tree_leaves
    seq, fields = timed_grads(torch, cfg, mesh, replaying(gtape), coll, True)
    sums = torch.tensor([[float(torch.sum(torch.square(a.float() - b.float()),
                                          dtype=torch.float64)),
                          float(torch.sum(torch.square(b.float()),
                                          dtype=torch.float64))]
                         for a, b in zip(seq, grads)], dtype=torch.float64)
    del seq
    torch.cuda.empty_cache()
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    rel = (sums[:, 0].sqrt() / sums[:, 1].sqrt().clamp_min(1e-30)).tolist()
    return {"sequence": fields, "batch_only": first,
            "grads_rel_diff_max": max(rel)}


def prefill_routes(torch, cfg, mesh, coll) -> dict:
    """(g): cfg's prefill on both routes from its weights (this rank's
    shards) on step 0's batch less its last token, the expert choices of
    "sequence" replayed on "batch_only": each route's ms, collectives' ms,
    peak and peak above the memory held before, the logits against each other at phase 15's bf16 bounds
    (f32: rtol RTOL_WHOLE_RUN of the largest |logit|), the verdict the same
    on every rank."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import moe as MOE
    params = ST.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                           "cuda", mesh=mesh)
    batch = lm_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, FRONT_TP_N)
    batch["tokens"] = batch["tokens"][:, :-1]
    # a batch of tokens alone: the step is built for its shape, so
    # meta["constrain"] is this call's route (a frontend's prefix or
    # frames, FRONT_TP_N positions, are not its config's shape: the route
    # asked for)
    shape = None if len(batch) > 1 else dict(
        global_batch=TRAIN_BATCH, seq_len=batch["tokens"].shape[1])
    tape, out, logits = MOE.RoutingTape(), {}, {}
    for c in SEQ_ROUTES:
        step, meta = ST.make_prefill_step(cfg, mesh, shape, constrain=c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0, c0 = time.perf_counter(), coll[0]
        with MOE.routing(tape if c == "sequence" else replaying(tape)):
            logits[c] = step(params, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[c] = {"constrain": meta["constrain"],
                  "ms": (time.perf_counter() - t0) * 1e3,
                  "collective_ms": coll[0] - c0, "peak_memory_gb": peak / 1e9,
                  "peak_above_held_gb": (peak - held) / 1e9}
    a, b = logits["sequence"], logits["batch_only"]
    if cfg.dtype == torch.float32:
        atol = RTOL_WHOLE_RUN * float(b.abs().max())
        parity = {"max_abs_diff": float((a - b).abs().max()),
                  "rtol": RTOL_WHOLE_RUN, "atol": atol}
        ok = bool(torch.allclose(a, b, rtol=RTOL_WHOLE_RUN, atol=atol))
    else:
        parity, ok = logit_parity(torch, a, b, cfg.vocab_size)
    ok = ok and [out[c]["constrain"] for c in SEQ_ROUTES] == list(SEQ_ROUTES)
    out.update(logits_parity=parity,
               ok=bool(ranks_max(torch, [float(not ok)])[0] == 0))
    del params, logits, a, b
    torch.cuda.empty_cache()
    return out


def seq_peak_part(torch, cfg, mesh, coll) -> dict:
    """(g): cfg (`seq_peak_cfg`: qwen3-4b, remat) on `mesh`, train_4k's layout
    at SEQ_PEAK_BATCH x SEQ_PEAK_SEQ, on each route: the step the dry run
    traces (`steps.make_step`) from this rank's shards and the dry run's
    arguments (`dryrun.step_args`), one step (the phase's earlier parts
    built every kernel it launches): its ms, collectives' ms and peak
    above the memory held before the arguments."""
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch import steps as ST
    shape = dict(global_batch=SEQ_PEAK_BATCH, seq_len=SEQ_PEAK_SEQ,
                 kind="train")
    out = {}
    for c in SEQ_ROUTES:
        step, meta = ST.make_step(cfg, mesh, "train_4k", shape, c)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = DRY.step_args(cfg, "train_4k", shape, mesh, meta, "cuda",
                             params=ST.init_model(
                                 cfg, torch.Generator("cuda").manual_seed(0),
                                 "cuda", mesh=mesh))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0, c0 = time.perf_counter(), coll[0]
        res = step(*args, 0)
        torch.cuda.synchronize()
        out[c] = {"constrain": meta["constrain"],
                  "ms": (time.perf_counter() - t0) * 1e3,
                  "collective_ms": coll[0] - c0,
                  "loss": float(res[2]["loss"]),
                  "peak_bytes": torch.cuda.max_memory_allocated() - base}
        del res, args
        torch.cuda.empty_cache()
    return out


def one_rank_stats(torch, cfg, mesh, specs, grads, gtape, coll,
                   trained=None) -> dict:
    """cfg's gradient of the step's loss (`tp_grads`) and, with `trained`
    = (this rank's trained shards, their RoutingTape, their log), its
    train steps (`tp_train`) on one rank, replaying this rank's expert
    choices: each rank in turn (the others at a barrier) holds its shards
    (`grads`, the trained params) against its slices of the one-rank
    result, each split leaf's shard against the same slice of the whole
    leaf, a replicated leaf whole.  Only per-leaf scalars cross the group
    (in place of gathering the shards): the params' largest |diff| and
    |value| and their elements outside two bf16 ulps (TP_PARAM_ULPS above
    TP_PARAM_FLOOR), the gradient's squared L2 gap and squared norm.
    Returns the same dict on every rank: grads_rel_diff by leaf (|a - b|_2
    / |b|_2) and, with `trained`, params_max_rel_diff, params_outside (the
    leaves with an element outside), loss_max_abs_diff and
    eps2_max_rel_diff over the steps."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import model_axis
    from repro_torch.tree import tree_leaves, tree_paths
    axis = model_axis(mesh)
    split, paths = tree_leaves(specs), tree_paths(specs)
    n, world = len(split), dist.get_world_size()
    top = torch.zeros(n, 2, dtype=torch.float64)     # max |a - b|, max |b|
    sums = torch.zeros(n, 3, dtype=torch.float64)    # outside, |a-b|^2, |b|^2
    out = {}

    def mine(whole, shard, dim):
        return whole if dim is None else whole.narrow(
            dim, axis.index * shard.shape[dim], shard.shape[dim])

    for r in range(world):
        if dist.get_rank() == r and trained is not None:
            params, tape, log = trained
            _, want, wlog, _, _ = tp_train(torch, cfg, None, coll,
                                           tape.replay())
            for i, (a, b, dim) in enumerate(zip(tree_leaves(params),
                                                tree_leaves(want), split)):
                a, b = a.float(), mine(b, a, dim).float()
                d = (a - b).abs()
                lim = TP_PARAM_ULPS * torch.maximum(a.abs(), b.abs())
                top[i] = torch.stack([d.max(), b.abs().max()]).cpu()
                sums[i, 0] = float((d > lim + TP_PARAM_FLOOR).sum())
            out["loss_max_abs_diff"] = max(abs(x["loss"] - y["loss"])
                                           for x, y in zip(log, wlog))
            out["eps2_max_rel_diff"] = max(
                abs(x["eps2"] - y["eps2"]) / abs(y["eps2"])
                for x, y in zip(log, wlog))
            del want, a, b, d, lim
            torch.cuda.empty_cache()
        if dist.get_rank() == r:
            gwant = tp_grads(torch, cfg, None, gtape.replay())
            for i, (a, b, dim) in enumerate(zip(grads, gwant, split)):
                a, b = a.float(), mine(b, a, dim).float()
                sums[i, 1] = float(torch.sum(torch.square(a - b),
                                             dtype=torch.float64))
                sums[i, 2] = float(torch.sum(torch.square(b),
                                             dtype=torch.float64))
            del gwant, a, b
            torch.cuda.empty_cache()
        dist.barrier()
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    # a replicated leaf is whole on every rank: count it once (world is a
    # power of two, so the division is exact)
    sums[torch.tensor([d is None for d in split])] /= world
    out["grads_rel_diff"] = {p: float(sums[i, 1].sqrt()
                                      / max(float(sums[i, 2].sqrt()), 1e-30))
                             for i, p in enumerate(paths)}
    if trained is not None:
        out["params_max_rel_diff"] = float(
            (top[:, 0] / top[:, 1].clamp_min(1e-30)).max())
        out["params_outside"] = [p for i, p in enumerate(paths)
                                 if sums[i, 0] > 0]
        # every rank's verdict from the same numbers
        rel = torch.tensor([out["loss_max_abs_diff"],
                            out["eps2_max_rel_diff"]], dtype=torch.float64)
        dist.all_reduce(rel, op=dist.ReduceOp.MAX)
        out["loss_max_abs_diff"], out["eps2_max_rel_diff"] = rel.tolist()
    return out


def rank0_parity(torch, cfg, res, stape):
    """Rank 0: the mesh serve `res`'s sequence teacher-forced on one rank
    from the same weights (`lm_params`), replaying the serve's expert
    choices (`stape`), its logits against the serve's at phase 15's bf16
    bounds (f32: rtol 1e-4, atol 1e-4 of the largest |logit|); the other
    ranks wait at a barrier.  (parity, ok) on rank 0, ({}, True) on the
    others."""
    import torch.distributed as dist
    from repro_torch.models import moe as MOE
    parity, ok = {}, True
    if dist.get_rank() == 0:
        seq = torch.cat([res.prompts, res.tokens], dim=1)
        with MOE.routing(stape.replay()):
            one = teacher_forced(torch, cfg, lm_params(torch, cfg), seq,
                                 False)
        parity, ok = logit_parity(torch, res.logits, one, cfg.vocab_size)
        if cfg.dtype == torch.float32:
            atol = RTOL_WHOLE_RUN * float(one.abs().max())
            ok = bool(torch.allclose(res.logits, one, rtol=RTOL_WHOLE_RUN,
                                     atol=atol))
            parity.update(rtol=RTOL_WHOLE_RUN, atol=atol)
        del one
        torch.cuda.empty_cache()
    dist.barrier()
    return parity, ok


def front_cuts(torch) -> tuple:
    """The frontends' f32 cuts of the rank phases (phase 25 (f)):
    llava-next-mistral-7b at FRONT_TP_LAYERS, seamless-m4t-large-v2 at
    AUDIO_CUT + AUDIO_CUT layers, full width."""
    from repro_torch.configs import get_config
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    return (dataclasses.replace(vlm, n_layers=FRONT_TP_LAYERS,
                                dtype=torch.float32),
            dataclasses.replace(audio, dtype=torch.float32, encdec=(
                dataclasses.replace(audio.encdec, n_enc_layers=AUDIO_CUT,
                                    n_dec_layers=AUDIO_CUT))))


def front_depth(cfg):
    """cfg's layers: n_layers, or an encoder-decoder's [encoder, decoder]
    layers."""
    if cfg.encdec is None:
        return cfg.n_layers
    return [cfg.encdec.n_enc_layers, cfg.encdec.n_dec_layers]


def front_logits(torch, cfg, mesh):
    """cfg's full-sequence logits [B, S, Vp] on step 0's batch of the rank
    phases (`lm_batch`: FRONT_TP_N prefix positions or frames), from its
    weights (this rank's shards on a model mesh, the logits' vocab shards
    gathered): a VLM's forward after its projected prefix, an
    encoder-decoder's `decode_full` over its encoded frames."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import model_axis
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as LM
    from repro_torch.models.common import tensor_parallel
    params = ST.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                           "cuda", mesh=mesh)
    batch = lm_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, 0, FRONT_TP_N)
    tokens = batch["tokens"][:, :-1]
    with torch.no_grad(), tensor_parallel(model_axis(mesh)):
        if cfg.arch_type == "audio":
            return ED.decode_full(params, tokens, ED.encode(
                params, batch["frames"], cfg), cfg)
        return LM.forward(params, tokens, cfg,
                          embeds_prefix=batch["embeds_prefix"])[0]


def lm_model_parts(torch, rank: int, world: int, out: str, coll) -> None:
    """Phase 25's part of a `--ranks-child` (WORLD ranks on cuda:0, gloo;
    `coll` the collectives' ms, `timed_collectives`).  WORLD = 2, on
    (1, 2): (a) the qwen3-4b serve, counted (rank 0 saves its sequence and
    logits to OUT/serve_a.pt); (b) LM_MODEL_STEPS BEV train steps of
    qwen3-4b at TP_TRAIN_LAYERS; (d) moonshot at MOE_TRAIN_LAYERS: the train steps, the
    gradient of the step's loss (`tp_grads`) and the serve (counted), each
    recording its expert choices, then each rank in turn the same train
    steps and gradient on one rank replaying them, its shards against its
    slices of the one-rank result (`one_rank_stats`: per-leaf scalars
    cross the group), and rank 0 the serve's sequence teacher-forced on
    one rank; (f) deepseek-v2-236b (MLA) at TP_MLA_LAYERS and mamba2-1.3b
    (SSD) at TP_SSD_LAYERS, served (counted: no kernel) and
    differentiated, against one rank the same way, and recurrentgemma-9b
    at TP_RG_LAYERS in f32 and in bf16 (part "hybrid": the kernel in its
    local-attention layer, counted by shape); then the frontends in f32
    (`front_cuts`: llava-next-mistral-7b at FRONT_TP_LAYERS, seamless at
    AUDIO_CUT + AUDIO_CUT), their full-sequence logits (`front_logits`)
    and gradients against one rank within FRONT_TP_RTOL (part
    "frontend"), and seamless's train step on (2, 1), the replicas
    bitwise (part "frontend_workers").  WORLD = 4: (e) the
    starcoder2-3b serve at TP_SC_LAYERS on (1, 4), counted (rank 0 saves
    OUT/serve_e.pt); (c) the 2-layer f32 cut on (2, 2), then rank 0 its
    one-process twin (`WorkerAxes.every(2)`).  Replicated leaves and
    replicas are compared across ranks by `bit_checksums`; while rank 0
    works alone the others wait at a barrier.  One JSON line a part."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import WorkerAxes, make_debug_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.sharding import gather_params, param_specs
    from repro_torch.models import moe as MOE
    from repro_torch.models.attention import local_heads
    from repro_torch.tree import tree_leaves, tree_map
    axes = ("data", "model")
    label = f"{world} ranks, gloo, one card"

    def emit_part(part, **fields):
        print(json.dumps({"phase": "lm_model_child", "rank": rank,
                          "part": part, **fields,
                          "t_s": time.perf_counter() - T_START}), flush=True)

    def emit_routes(cfg, groutes, proutes, grad_tol):
        """(g)'s line of a gradient-and-prefill case (every rank, the same
        verdict), raising if the routes disagree."""
        ok = groutes["grads_rel_diff_max"] <= grad_tol and proutes["ok"]
        emit_part("routes", case="grads_prefill", arch=cfg.name,
                  dtype=str(cfg.dtype)[6:], layers=front_depth(cfg),
                  mesh={"data": 1, "model": 2}, grads=groutes,
                  grads_tol=grad_tol, prefill=proutes, rate_label=label,
                  ok=ok)
        if not ok:
            raise AssertionError(f"lm model {cfg.name}: the routes "
                                 f"disagree")

    def counted_serve(cfg, mesh, prompt, gen, tape=None):
        """The serve on `mesh`, its decode launches by shape, its
        collectives' ms, and whether every rank's tokens and logits are
        the same bits."""
        import contextlib
        ops.reset_launches()
        c0 = coll[0]
        with (MOE.routing(tape) if tape is not None
              else contextlib.nullcontext()):
            res = serve(cfg, SERVE_BATCH, prompt, gen, device="cuda",
                        mesh=mesh)
        torch.cuda.synchronize()
        shapes = {k: [[list(sh), n] for sh, n in v.items()]
                  for k, v in ops.launch_shapes().items() if v}
        equal = ranks_agree(bit_checksums(
            torch, [res.tokens.to(torch.int32), res.logits]))
        return res, shapes, coll[0] - c0, equal

    def serve_part(part, cfg, mesh, prompt, gen, save):
        """The counted serve on `mesh`, and its peak memory a rank (the
        weights drawn included); rank 0 saves its prompts, tokens and
        logits to OUT/save for the parent's one-rank check."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, shapes, cms, equal = counted_serve(cfg, mesh, prompt, gen)
        peak = torch.cuda.max_memory_allocated() / 1e9
        local = ST.init_model(cfg, None, "meta", mesh=mesh)
        if rank == 0:
            torch.save({"prompts": res.prompts.cpu(),
                        "tokens": res.tokens.cpu(),
                        "logits": res.logits.cpu()}, os.path.join(out, save))
        emit_part(part, arch=cfg.name, layers=cfg.n_layers,
                  mesh=dict(mesh.shape), batch=SERVE_BATCH,
                  prompt_len=prompt, gen=gen, prefill_s=res.prefill_s,
                  decode_s=res.decode_s, decode_tok_per_s=res.tok_per_s,
                  ms_per_step=res.decode_s * 1e3 / gen,
                  collective_ms=cms, weight_bytes_rank=weight_bytes(local)
                  + local["embed"].numel() * local["embed"].element_size(),
                  peak_memory_gb=peak, ranks_bitwise_equal=equal,
                  launches_by_shape=shapes,
                  rate_label=label)
        if not equal:
            raise AssertionError(f"lm model {part}: the ranks' tokens or "
                                 f"logits differ")

    lm = get_config(LM_ARCH)
    if world == 2:
        mesh = make_debug_mesh((1, 2), axes)
        # (a) the full-width serve on (1, 2)
        serve_part("serve", lm, mesh, SERVE_PROMPT, SERVE_GEN, "serve_a.pt")
        torch.cuda.empty_cache()
        # (b) the full-width train step on (1, 2), cut in depth
        ops.reset_launches()
        lm_b = dataclasses.replace(lm, n_layers=TP_TRAIN_LAYERS)
        before, params, log, meta, peak = tp_train(torch, lm_b, mesh, coll)
        counts = ops.launch_counts()
        split = tree_leaves(meta["params_specs"])
        after = bit_checksums(torch, tree_leaves(params))
        moved = int((after != before).any(dim=1).sum())
        replicated = [i for i, d in enumerate(split) if d is None]
        equal = ranks_agree(after[replicated])
        wb = sum(x.numel() * x.element_size() for x in tree_leaves(params))
        # (g): the same steps on "batch_only"
        routes = train_routes(torch, lm_b, mesh, coll,
                              (before, params, log, meta, peak))
        del params
        torch.cuda.empty_cache()
        warm = log[1:]
        emit_part("train", arch=lm.name, layers=lm_b.n_layers,
                  mesh=dict(mesh.shape), workers=meta["num_workers"],
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=log,
                  ms_per_step_warm=sum(x["ms"] for x in warm) / len(warm),
                  collective_ms_warm=sum(x["collective_ms"] for x in warm)
                  / len(warm),
                  collective_share_warm=sum(x["collective_ms"] for x in warm)
                  / sum(x["ms"] for x in warm),
                  peak_memory_gb=peak, weight_bytes_rank=wb,
                  leaves=len(split), leaves_split=len(split)
                  - len(replicated), leaves_moved=moved,
                  replicated_bitwise_equal=equal, launches=counts,
                  rate_label=label)
        if not (equal and moved and all(math.isfinite(x["loss"])
                                        for x in log)
                and counts == step_launches(ops, lm_b, LM_MODEL_STEPS,
                                            init=True)):
            raise AssertionError(f"lm model train: replicated equal {equal}, "
                                 f"{moved} leaves moved, {log}, {counts}")
        emit_part("routes", case="train", arch=lm.name, layers=lm_b.n_layers,
                  mesh=dict(mesh.shape), rate_label=label, **routes)
        if not routes["ok"]:
            raise AssertionError(f"lm model train: the routes disagree "
                                 f"{routes}")
        # (d) moonshot at MOE_TRAIN_LAYERS: train and serve, recording the
        # expert choices
        moe = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                                  n_layers=MOE_TRAIN_LAYERS)
        tape = MOE.RoutingTape()
        _, params, log, meta, peak = tp_train(torch, moe, mesh, coll, tape)
        # (g): the same steps on "batch_only", the choices replayed
        routes = train_routes(torch, moe, mesh, coll,
                              (None, params, log, meta, peak), tape)
        specs = meta["params_specs"]
        replicated = [i for i, d in enumerate(tree_leaves(specs))
                      if d is None]
        equal = ranks_agree(bit_checksums(torch, tree_leaves(params))[
            replicated])
        # the gradient of the step's loss, its replicated leaves compared
        # across the ranks
        gtape = MOE.RoutingTape()
        grads = tp_grads(torch, moe, mesh, gtape)
        grads_equal = ranks_agree(bit_checksums(torch, grads)[replicated])
        torch.cuda.empty_cache()
        routes_equal = ranks_agree(tp_tape_sums(torch, tape))
        stape = MOE.RoutingTape()
        res, shapes, cms, sequal = counted_serve(moe, mesh, SERVE_PROMPT,
                                                 SERVE_GEN, stape)
        routes_equal = (routes_equal and ranks_agree(tp_tape_sums(
            torch, stape)) and ranks_agree(tp_tape_sums(torch, gtape)))
        emit_part("moe", arch=moe.name, layers=moe.n_layers,
                  mesh=dict(mesh.shape), steps=log, peak_memory_gb=peak,
                  serve_ms_per_step=res.decode_s * 1e3 / SERVE_GEN,
                  serve_collective_ms=cms, serve_tok_per_s=res.tok_per_s,
                  replicated_bitwise_equal=equal,
                  replicated_grads_bitwise_equal=grads_equal,
                  ranks_bitwise_equal=sequal,
                  routes_bitwise_equal=routes_equal,
                  launches_by_shape=shapes, rate_label=label)
        if not (equal and grads_equal and sequal and routes_equal):
            raise AssertionError("lm model moe: the ranks' replicated "
                                 "leaves or gradients, serves or expert "
                                 "choices differ")
        emit_part("routes", case="moe", arch=moe.name, layers=moe.n_layers,
                  mesh=dict(mesh.shape), rate_label=label, **routes)
        if not routes["ok"]:
            raise AssertionError(f"lm model moe: the routes disagree "
                                 f"{routes}")
        # one rank, the same choices replayed: each rank in turn, against
        # its shards
        t0 = time.perf_counter()
        stats = one_rank_stats(torch, moe, mesh, specs, grads, gtape, coll,
                               (params, tape, log))
        del params, grads
        torch.cuda.empty_cache()
        parity, ok = rank0_parity(torch, moe, res, stape)
        ok = (ok and not stats["params_outside"]
              and stats["loss_max_abs_diff"] <= BF16_LOGIT_MEAN
              and stats["eps2_max_rel_diff"] <= 1e-2
              and max(stats["grads_rel_diff"].values()) <= TP_GRAD_REL)
        if rank == 0:
            emit_part("moe_one_rank", arch=moe.name, **stats,
                      param_tol={"rel": TP_PARAM_ULPS,
                                 "floor": TP_PARAM_FLOOR},
                      grads_tol=TP_GRAD_REL, serve_vs_one_rank=parity,
                      router_flips=int(tape.flips) + int(stape.flips),
                      seconds=time.perf_counter() - t0, ok=ok)
            if not ok:
                raise AssertionError("lm model moe: the mesh and one rank "
                                     "disagree")
        dist.barrier()
        del res
        # (f) the MLA, SSD and RG-LRU archs on (1, 2), against one rank
        for arch, layers, dtype, grad_tol in (
                (MLA_ARCH, TP_MLA_LAYERS, torch.bfloat16, TP_GRAD_REL),
                (SSD_ARCH, TP_SSD_LAYERS, torch.float32, TP_GRAD_REL_F32),
                (RG_ARCH, TP_RG_LAYERS, torch.float32, TP_GRAD_REL_F32),
                (RG_ARCH, TP_RG_LAYERS, torch.bfloat16, TP_GRAD_REL)):
            cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                      dtype=dtype)
            # the decode kernel of a local-attention layer, at this rank's
            # heads
            q, kv = local_heads(cfg, mesh.shape["model"], rank)
            want_shapes = {} if arch != RG_ARCH else {"decode_attention": [[
                [SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, q.stop - q.start,
                 kv.stop - kv.start, cfg.hd],
                attn_layers(cfg) * (SERVE_PROMPT + SERVE_GEN)]]}
            t0 = time.perf_counter()
            stape = MOE.RoutingTape()
            res, shapes, cms, sequal = counted_serve(
                cfg, mesh, SERVE_PROMPT, SERVE_GEN, stape)
            gtape = MOE.RoutingTape()
            grads, gfirst = timed_grads(torch, cfg, mesh, gtape, coll, False)
            specs = param_specs(cfg, mesh.shape["model"])
            replicated = [i for i, d in enumerate(tree_leaves(specs))
                          if d is None]
            grads_equal = ranks_agree(bit_checksums(torch, grads)[
                replicated])
            routes_equal = all(ranks_agree(tp_tape_sums(torch, t))
                               for t in (stape, gtape) if t.recorded)
            stats = one_rank_stats(torch, cfg, mesh, specs, grads, gtape,
                                   coll)
            # (g): the gradient and the prefill on both routes
            groutes = grads_routes(torch, cfg, mesh, grads, gtape, coll,
                                   gfirst)
            del grads
            proutes = prefill_routes(torch, cfg, mesh, coll)
            torch.cuda.empty_cache()
            parity, ok = rank0_parity(torch, cfg, res, stape)
            ok = (ok and sequal and grads_equal and routes_equal
                  and shapes == want_shapes
                  and max(stats["grads_rel_diff"].values()) <= grad_tol)
            if arch == RG_ARCH:   # the parent tallies each rank's launches
                emit_part("hybrid", arch=cfg.name, dtype=str(dtype)[6:],
                          launches_by_shape=shapes)
            if rank == 0:
                emit_part("mla_ssm", arch=cfg.name, layers=cfg.n_layers,
                          mesh=dict(mesh.shape), batch=SERVE_BATCH,
                          prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                          serve_ms_per_step=res.decode_s * 1e3 / SERVE_GEN,
                          serve_collective_ms=cms,
                          serve_tok_per_s=res.tok_per_s,
                          ranks_bitwise_equal=sequal,
                          replicated_grads_bitwise_equal=grads_equal,
                          routes_bitwise_equal=routes_equal,
                          launches_by_shape=shapes,
                          dtype=str(dtype)[6:], serve_vs_one_rank=parity,
                          **stats, grads_tol=grad_tol,
                          router_flips=(int(stape.flips) if stape.flips
                                        is not None else 0),
                          seconds=time.perf_counter() - t0,
                          rate_label=label, ok=ok)
                if not ok:
                    raise AssertionError(f"lm model {arch}: the mesh and "
                                         f"one rank disagree")
            dist.barrier()
            del res
            torch.cuda.empty_cache()
            emit_routes(cfg, groutes, proutes, grad_tol)
        # (f) the frontends in f32: llava at FRONT_TP_LAYERS and seamless
        # at AUDIO_CUT + AUDIO_CUT on (1, 2), logits and gradients against
        # one rank; seamless's train step on (2, 1), the replicas bitwise
        for cfg in front_cuts(torch):
            t0 = time.perf_counter()
            gtape = MOE.RoutingTape()
            grads, gfirst = timed_grads(torch, cfg, mesh, gtape, coll, False)
            specs = param_specs(cfg, mesh.shape["model"])
            replicated = [i for i, d in enumerate(tree_leaves(specs))
                          if d is None]
            grads_equal = ranks_agree(bit_checksums(torch, grads)[
                replicated])
            stats = one_rank_stats(torch, cfg, mesh, specs, grads, gtape,
                                   coll)
            # (g): the gradient and the prefill on both routes
            groutes = grads_routes(torch, cfg, mesh, grads, gtape, coll,
                                   gfirst)
            del grads
            proutes = prefill_routes(torch, cfg, mesh, coll)
            torch.cuda.empty_cache()
            logits = front_logits(torch, cfg, mesh)
            equal = ranks_agree(bit_checksums(torch, [logits]))
            parity = {}
            if rank == 0:
                one = front_logits(torch, cfg, None)
                atol = FRONT_TP_RTOL * float(one.abs().max())
                parity = {"max_abs_diff": float((logits - one).abs().max()),
                          "logit_max": float(one.abs().max()),
                          "rtol": FRONT_TP_RTOL, "atol": atol,
                          "ok": bool(torch.allclose(logits, one,
                                                    rtol=FRONT_TP_RTOL,
                                                    atol=atol))}
                del one
            del logits
            torch.cuda.empty_cache()
            worst = max(stats["grads_rel_diff"].values())
            if rank == 0:
                ok = (parity["ok"] and equal and grads_equal
                      and worst <= FRONT_TP_RTOL)
                emit_part("frontend", arch=cfg.name, dtype="float32",
                          layers=front_depth(cfg), mesh=dict(mesh.shape),
                          batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          frontend_positions=FRONT_TP_N,
                          logits_vs_one_rank=parity,
                          ranks_logits_bitwise_equal=equal,
                          replicated_grads_bitwise_equal=grads_equal,
                          grads_rel_diff_max=worst, grads_tol=FRONT_TP_RTOL,
                          **stats, seconds=time.perf_counter() - t0,
                          rate_label=label, ok=ok)
                if not ok:
                    raise AssertionError(f"lm model frontends {cfg.name}: "
                                         f"the mesh and one rank disagree")
            dist.barrier()
            emit_routes(cfg, groutes, proutes, FRONT_TP_RTOL)
        cfg = front_cuts(torch)[1]
        wmesh = make_debug_mesh((2, 1), axes)
        before, params, log, meta, peak = tp_train(torch, cfg, wmesh, coll)
        after = bit_checksums(torch, tree_leaves(params))
        equal = ranks_agree(after)
        moved = int((after != before).any(dim=1).sum())
        del params
        torch.cuda.empty_cache()
        if rank == 0:
            emit_part("frontend_workers", arch=cfg.name, dtype="float32",
                      layers=front_depth(cfg), mesh=dict(wmesh.shape),
                      workers=meta["num_workers"], batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, frames=FRONT_TP_N, steps=log,
                      peak_memory_gb=peak, leaves_moved=moved,
                      replicas_bitwise_equal=equal, rate_label=label)
        if not (equal and moved and all(math.isfinite(x["loss"])
                                        for x in log)):
            raise AssertionError(f"lm model frontends on (2, 1): replicas "
                                 f"equal {equal}, {moved} leaves moved, "
                                 f"{log}")
        dist.barrier()
        # (g): qwen3-4b under remat, both routes' peaks (the parent holds
        # them against the dry run's)
        peak_routes = seq_peak_part(torch, seq_peak_cfg(lm), mesh, coll)
        emit_part("seq_peak", arch=lm.name, layers=SEQ_PEAK_LAYERS,
                  mesh=dict(mesh.shape), batch=SEQ_PEAK_BATCH,
                  seq=SEQ_PEAK_SEQ, remat=True, routes=peak_routes,
                  rate_label=label)
        if not all(math.isfinite(r["loss"]) for r in peak_routes.values()):
            raise AssertionError(f"lm model seq_peak: {peak_routes}")
    else:
        # (e) starcoder2-3b served on (1, 4): wk / wv split d
        sc = dataclasses.replace(get_config(TP_SC_ARCH),
                                 n_layers=TP_SC_LAYERS)
        serve_part("sc_serve", sc, make_debug_mesh((1, 4), axes),
                   TP_SC_PROMPT, TP_SC_GEN, "serve_e.pt")
        torch.cuda.empty_cache()
        # (c) the 2-layer f32 cut on (2, 2) against its one-process twin
        cfg = dataclasses.replace(lm, n_layers=LM_MESH_B_LAYERS,
                                  dtype=torch.float32)
        mesh = make_debug_mesh((2, 2), axes)
        _, params, log, meta, peak = tp_train(torch, cfg, mesh, coll)
        full = gather_params(params, meta["params_specs"], mesh)
        equal = ranks_agree(bit_checksums(torch, tree_leaves(full)))
        full = tree_map(lambda x: x.cpu(), full) if rank == 0 else None
        del params
        torch.cuda.empty_cache()
        if rank == 0:
            _, want, wlog, wmeta, _ = tp_train(
                torch, cfg, WorkerAxes.every(2), coll)
            worst, ok = 0.0, equal
            for a, b in zip(tree_leaves(full), tree_leaves(want)):
                a = a.to("cuda")
                ok = ok and bool(torch.allclose(a, b, rtol=RTOL_WHOLE_RUN,
                                                atol=1e-6))
                worst = max(worst, float((a - b).abs().max())
                            / max(float(b.abs().max()), 1e-30))
            # gbar (~1e-9, the gradient's mean) at the rtol alone
            atol = {"loss": 1e-6, "grad_scale": 1e-6, "gbar": 0.0,
                    "eps2": 1e-6}
            ok = ok and all(abs(x[k] - y[k]) <= atol[k] + RTOL_WHOLE_RUN
                            * abs(y[k]) for x, y in zip(log, wlog)
                            for k in atol)
            emit_part("f32_cut", arch=cfg.name, dtype="float32",
                      layers=cfg.n_layers, mesh=dict(mesh.shape),
                      workers=wmeta["num_workers"], steps=log,
                      twin_steps=wlog, rtol=RTOL_WHOLE_RUN, atol=atol,
                      params_max_rel_diff=worst, peak_memory_gb=peak,
                      ranks_bitwise_equal=equal, ok=ok)
            if not ok:
                raise AssertionError("lm model f32 cut: the mesh and its "
                                     "one-process twin disagree")
        dist.barrier()


# the phase-25 serves' cases: (child part, shard_tally case, ranks); (f)'s
# recurrentgemma-9b serves (f32 and bf16) report their launches as part
# "hybrid"
TP_SERVES = (("serve", "lm_model_serve", 2), ("moe", "lm_model_moe_serve", 2),
             ("sc_serve", "lm_model_sc_serve", 4),
             ("hybrid", "lm_model_rg_serve", 2))


def lm_model_check(torch, lm, rs, lines, work, shard_tally) -> None:
    """Phase 25, in the parent after the spawns (the ranks' JSON `lines` by
    world size and rank, their files under `work`): at phase 15's bf16
    bounds with every clear step's argmax equal, (a)'s serve against the
    one-rank serve `rs` (phase 14's) on the (step, row) pairs whose inputs
    agree so far, and (e)'s against one rank teacher-forced through its
    sequence from the same weights (`teacher_forced`).  The ranks' decode
    launches by shape go to `shard_tally`."""
    from repro_torch.configs import get_config
    cases = {part: case for part, case, _ in TP_SERVES}
    for world in (2, 4):
        for r, rank_lines in lines[world].items():
            for line in rank_lines:
                if (line["phase"] == "lm_model_child"
                        and line["part"] in cases):
                    shard_tally(cases[line["part"]], {
                        k: {shape_key(sh): n for sh, n in v}
                        for k, v in line["launches_by_shape"].items()})
        parts = [x["part"] for x in lines[world][0]
                 if x["phase"] == "lm_model_child"]
        want = (["serve", "train", "routes", "moe", "routes",
                 "moe_one_rank", "mla_ssm", "routes", "mla_ssm", "routes",
                 "hybrid", "mla_ssm", "routes", "hybrid", "mla_ssm",
                 "routes", "frontend", "routes", "frontend", "routes",
                 "frontend_workers", "seq_peak"]
                if world == 2 else ["sc_serve", "f32_cut"])
        if parts != want:
            raise AssertionError(f"lm model: rank 0 of {world} reported "
                                 f"{parts}")
    # (a): the pairs whose inputs agree with the one-rank serve's
    got = torch.load(os.path.join(work, "serve_a.pt"))
    seq = torch.cat([got["prompts"], got["tokens"]], dim=1)
    ref = torch.cat([rs.prompts, rs.tokens], dim=1).cpu()
    held = (seq == ref).int().cumprod(dim=1).bool().T.cuda()
    parity, ok = logit_parity(torch, got["logits"].cuda()[held],
                              rs.logits[held], lm.vocab_size)
    parity["held_pairs"] = int(held.sum())
    parity["prompts_equal"] = bool(held[:SERVE_PROMPT].all())
    ok = ok and parity["prompts_equal"]
    emit("lm_model_serve", arch=lm.name, backend="gloo",
         device="cuda:0", tol={"max_abs": BF16_LOGIT_MAX,
                               "mean_abs": BF16_LOGIT_MEAN}, ok=ok,
         mesh_vs_one_rank=parity)
    del got, seq, ref, held
    if not ok:
        raise AssertionError("lm_model_serve: the mesh serve and one "
                             "rank disagree")
    # (e): one rank teacher-forced through the mesh serve's sequence
    sc = dataclasses.replace(get_config(TP_SC_ARCH), n_layers=TP_SC_LAYERS)
    got = torch.load(os.path.join(work, "serve_e.pt"))
    seq = torch.cat([got["prompts"], got["tokens"]], dim=1).cuda()
    one = teacher_forced(torch, sc, lm_params(torch, sc), seq, False)
    parity, ok = logit_parity(torch, got["logits"].cuda(), one,
                              sc.vocab_size)
    emit("lm_model_sc_serve", arch=sc.name, layers=sc.n_layers,
         backend="gloo", device="cuda:0",
         tol={"max_abs": BF16_LOGIT_MAX, "mean_abs": BF16_LOGIT_MEAN},
         ok=ok, mesh_vs_one_rank=parity)
    del got, seq, one
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("lm_model_sc_serve: the mesh serve and one "
                             "rank disagree")
    seq_peak_check(lm, lines[2][0])
    emit("lm_model", backend="gloo", device="cuda:0")


def seq_peak_cfg(lm):
    """(g)'s config: qwen3-4b cut to SEQ_PEAK_LAYERS, under remat."""
    return dataclasses.replace(lm, remat=True, n_layers=SEQ_PEAK_LAYERS)


def seq_peak_check(lm, rank_lines) -> None:
    """Phase 25 (g), in the parent: rank 0's measured peaks of qwen3-4b
    (`seq_peak_cfg`) under remat on (1, 2) (`seq_peak_part`) against
    `launch.dryrun.trace_step`'s for rank 0 of a fake group of 2, each
    route, each within PEAK_TOL, and the drop from "batch_only" to
    "sequence" within SEQ_DROP_TOL of the trace's drop."""
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.mesh import make_debug_mesh
    line = next(x for x in rank_lines if x.get("part") == "seq_peak")
    cfg = seq_peak_cfg(lm)
    shape = dict(global_batch=SEQ_PEAK_BATCH, seq_len=SEQ_PEAK_SEQ,
                 kind="train")
    rows = {}
    with DRY.fake_group(2):
        mesh = make_debug_mesh((1, 2), ("data", "model"))
        for c in SEQ_ROUTES:
            pred = DRY.trace_step(cfg, "train_4k", shape, mesh, constrain=c)
            got = line["routes"][c]
            want = pred["memory"]["peak"]
            rows[c] = {"constrain": got["constrain"],
                       "predicted_constrain": pred["meta"]["constrain"],
                       "peak_bytes": got["peak_bytes"],
                       "predicted_peak_bytes": want,
                       "peak_rel_diff": (want - got["peak_bytes"])
                       / got["peak_bytes"],
                       "ms": got["ms"], "collective_ms": got["collective_ms"],
                       "trace_s": pred["trace_s"]}
    saved = cfg.n_layers * SEQ_PEAK_BATCH * SEQ_PEAK_SEQ * cfg.d_model * 2
    drop = rows["batch_only"]["peak_bytes"] - rows["sequence"]["peak_bytes"]
    want = (rows["batch_only"]["predicted_peak_bytes"]
            - rows["sequence"]["predicted_peak_bytes"])
    ok = (all(r["constrain"] == r["predicted_constrain"] == c
              and abs(r["peak_rel_diff"]) <= PEAK_TOL
              for c, r in rows.items())
          and want > 0 and abs(drop - want) <= SEQ_DROP_TOL * want)
    emit("lm_model_seq_peak", arch=cfg.name, layers=cfg.n_layers,
         batch=SEQ_PEAK_BATCH, seq=SEQ_PEAK_SEQ, remat=True, ranks=2,
         peak_tol=PEAK_TOL, drop_tol=SEQ_DROP_TOL, routes=rows,
         saved_residual_bytes=saved, peak_drop_bytes=drop,
         predicted_peak_drop_bytes=want,
         rate_label="2 ranks, gloo, one card", ok=ok)
    if not ok:
        raise AssertionError(f"lm_model_seq_peak: {rows}")


def ranks_child(args) -> int:
    """`chip_smoke.py --ranks-child RANK WORLD STORE OUT [layouts|heads]`:
    one of the rank phases' WORLD ranks on cuda:0 in a gloo group
    (init_method file://STORE; NCCL refuses two ranks on one device).
    Each world size is started once and runs every rank phase's jobs:
    WORLD = 2 phase 21's sharded sweeps (`mesh_child_cases`), phase 22's
    (a) and (c), phase 25's (a), (b), (d) and (f) and phase 29's (b);
    WORLD = 4 phase 22's (b) and phase 25's (e) and (c) (`lm_mesh_parts`,
    `lm_model_parts`, `fsdp_parts`); "layouts" runs phase 29's (b) alone,
    "heads" phase 31 (WORLD = HEADS_RANKS, `heads_parts`).  Prints no
    result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch.launch.distributed import initialize_distributed
    rank, world, store, out = int(args[0]), int(args[1]), args[2], args[3]
    if not initialize_distributed(f"file://{store}", world_size=world,
                                  rank=rank, backend="gloo", device="cuda:0",
                                  timeout_s=600):
        raise AssertionError("ranks child: no process group")
    if args[4:] == ["heads"]:
        heads_parts(torch, rank, world, out, timed_collectives(torch))
    elif args[4:] != ["layouts"]:
        if world == MESH_RANKS:
            mesh_child_cases(torch, rank, out)
        lm_mesh_parts(torch, rank, world, out)
        torch.cuda.empty_cache()
        lm_model_parts(torch, rank, world, out, timed_collectives(torch))
        torch.cuda.empty_cache()
    if world == 2:
        fsdp_parts(torch, rank, world)
    dist.destroy_process_group()
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        raise AssertionError("ranks child: imported JAX or the JAX package")
    return 0


def rank_phases(torch, np, ops, figures, tally, shard_tally, lm, rs) -> None:
    """Phases 21, 22 and 25: phase 21's one-rank NCCL mesh here, then one
    spawn of 2 ranks and one of 4 on this card over gloo (`--ranks-child`)
    run every rank job of the three phases, and the parent holds their
    results against its own: the sharded sweeps against their unsharded
    twins (`mesh_compare`), the worker-axes serve against phase 14's
    one-rank serve `rs` (served here when None; `lm_mesh_check`), the
    tensor-parallel serves against one rank (`lm_model_check`)."""
    import shutil
    import tempfile
    from repro_torch.launch.serve import serve
    if rs is None:
        rs = serve(lm, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, device="cuda")
    torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="ranks_", dir=os.path.join(ROOT, "build"))
    try:
        mesh_one_rank(torch, np, ops, figures, tally, work)
        seq = torch.cat([rs.prompts, rs.tokens], dim=1)
        torch.save(seq.cpu(), os.path.join(work, "seq.pt"))
        torch.cuda.empty_cache()
        parent_gb = {"allocated": torch.cuda.memory_allocated() / 1e9,
                     "reserved": torch.cuda.memory_reserved() / 1e9}
        lines, walls = {}, {}
        for world in (2, 4):
            lines[world], walls[world] = spawn_ranks("--ranks-child", world,
                                                     work, 900)
            for rank_lines in lines[world].values():
                for line in rank_lines:
                    print(json.dumps(line), flush=True)
        emit("ranks", children_wall_s=walls, parent_memory_gb=parent_gb)
        mesh_compare(torch, np, lines[MESH_RANKS], work, shard_tally)
        lm_mesh_check(torch, lm, rs, lines, work, shard_tally)
        lm_model_check(torch, lm, rs, lines, work, shard_tally)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def plan_phase(torch, np, ops, figures, tally, grid_u, mc_u) -> None:
    """The execution plan at the paper's width: (a) fig3 chunked and async
    staged against monolithic, (b) the showdown resumed in a fresh process
    after a SIGKILL against the uninterrupted run, (c) the U = 1000 grid's
    peak device memory monolithic vs chunked, (d) the switch dispatch and
    the tree state (and both under strict_numerics), each against its plain
    route and against the grouped / flat run.  Every counted run's launches
    go to the main-path totals; any disagreement raises."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.core.power_control import Policy
    from repro_torch.fl import ExecutionPlan, SweepResult
    zero = {k: 0 for k in ops.KERNELS}
    fig3 = [figures.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                               attacker_sigma=3.0, rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]

    def counted(name, build, expect, steady=True):
        """build() -> (engine, params, batches): one counted run, then the
        round rate of a second, uncounted run of the same engine."""
        engine, params, batches = build()
        result, seconds, counts = run_phase(
            torch, ops, name, lambda: engine.run(params, batches),
            {**zero, **expect})
        tally(counts)
        if not np.isfinite(result.loss).all():
            raise AssertionError(f"{name}: non-finite loss")
        info = {"run_seconds": seconds, "launches": {
            k: v for k, v in counts.items() if v}}
        if steady:   # host-bound rates spread: the median of 3 runs
            rates = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine.run(params, batches)
                torch.cuda.synchronize()
                rates.append(ROUNDS / (time.perf_counter() - t0))
            info["rounds_per_s"] = sorted(rates)[1]
            info["rounds_per_s_runs"] = rates
        return result, info

    def plain(name, build):
        engine, params, batches = build()
        ops.reset_launches()
        result = engine.run(params, batches)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"{name}: the plain route launched "
                                 f"{ops.launch_counts()}")
        return result

    # (a) chunking: fig3's four lanes, R = 20, C = 7 (the last block 6)
    fused = {"floa_step_batched": ROUNDS, "grad_stats": ROUNDS}
    fig = lambda plan, fp=False: (lambda: figures.figure_engine(  # noqa
        fig3, device="cuda", plan=plan, force_plain=fp))
    runs, rates = {}, {}
    for name, plan in [
            ("monolithic", ExecutionPlan()),
            ("chunked", ExecutionPlan(chunk_rounds=PLAN_CHUNK)),
            ("chunked_async", ExecutionPlan(chunk_rounds=PLAN_CHUNK,
                                            async_staging=True))]:
        runs[name], rates[name] = counted(f"plan_fig3_{name}", fig(plan),
                                          fused)
    chunk_eq = result_diff(np, torch, runs["chunked"], runs["monolithic"])
    async_eq = result_diff(np, torch, runs["chunked_async"],
                           runs["chunked"])
    emit("plan_chunking", lanes=len(fig3), rounds=ROUNDS, chunk=PLAN_CHUNK,
         routes=rates, chunked_vs_monolithic=chunk_eq,
         async_vs_sync=async_eq)
    if not (chunk_eq["bitwise"] and async_eq["bitwise"]):
        raise AssertionError("plan: chunked or async-staged fig3 differs "
                             "from the monolithic run")

    # (b) resume after a real preemption: the showdown, R = 20, the
    # example's chunks of R // 4 = 5; a child SIGKILLs itself after its 2nd
    # checkpoint, a fresh child resumes
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="plan_resume_", dir=os.path.join(
        ROOT, "build"))
    try:
        writes = []
        orig = CK.save_pytree

        def timed_save(path, step, tree, extra=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(path, step, tree, extra=extra)
            base = out[:-len(".npz")]
            writes.append({"step": step, "ms": (time.perf_counter() - t0)
                           * 1e3, "mb": (os.path.getsize(out)
                                         + os.path.getsize(base + ".meta.json"))
                           / 1e6})
            return out

        CK.save_pytree = timed_save
        try:
            full, info = counted(
                "plan_showdown_checkpointed",
                lambda: figures.showdown_engine(
                    ROUNDS, device="cuda",
                    checkpoint_dir=os.path.join(work, "parent")),
                {"floa_aggregate_batched": ROUNDS, "grad_stats": ROUNDS,
                 "sort_columns": 2 * ROUNDS}, steady=False)
        finally:
            CK.save_pytree = orig
        full.save(os.path.join(work, "full"))
        torch.cuda.empty_cache()
        child_dir = os.path.join(work, "child")
        children = {}
        for mode, args, want_rc in [
                ("ckpt", [child_dir], -9),
                ("resume", [child_dir, os.path.join(work, "resumed")], 0)]:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--resume-child",
                 mode, *args], capture_output=True, text=True, timeout=600,
                cwd=ROOT)
            for line in proc.stdout.splitlines():
                print(line, flush=True)
            children[mode] = {"returncode": proc.returncode,
                              "wall_s": time.perf_counter() - t0}
            if proc.returncode != want_rc:
                raise AssertionError(
                    f"plan: resume child {mode} exited {proc.returncode}, "
                    f"expected {want_rc}: {proc.stderr[-2000:]}")
            if mode == "ckpt":
                at = CK.latest_step(child_dir)
                children[mode]["latest_step"] = at
                if at != KILL_AFTER_SAVES * (ROUNDS // 4):
                    raise AssertionError(f"plan: the killed child left step "
                                         f"{at}")
        resumed = SweepResult.load(os.path.join(work, "resumed"))
        saved = SweepResult.load(os.path.join(work, "full"))
        resume_eq = result_diff(np, torch, resumed, saved)
        emit("plan_resume", lanes=len(full.names), rounds=ROUNDS,
             chunk=ROUNDS // 4, checkpoint_writes=writes,
             mb_per_write=sum(w["mb"] for w in writes) / len(writes),
             ms_per_write=sum(w["ms"] for w in writes) / len(writes),
             uninterrupted=info, children=children,
             resumed_vs_uninterrupted=resume_eq)
        if not resume_eq["bitwise"]:
            raise AssertionError("plan: the resumed showdown differs from "
                                 "the uninterrupted run")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del full, resumed, saved
    torch.cuda.empty_cache()

    # (c) device memory: worker_grid(1000) at R = 20, monolithic and C = 5
    # with async staging (predicted: the difference is the batch blocks,
    # (R - 2 C) x 100.4 MB)
    mem, mem_runs = {}, {}
    large = {"floa_step_batched": ROUNDS, "grad_stats": ROUNDS,
             "sort_columns_bitonic": 2 * ROUNDS}
    for name, plan in [("monolithic", ExecutionPlan()),
                       ("chunked_async", ExecutionPlan(
                           chunk_rounds=MEM_CHUNK, async_staging=True))]:
        engine, params, batches = figures.cases_engine(
            grid_u, ROUNDS, mc=mc_u, device="cuda", plan=plan)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mem_runs[name], seconds, counts = run_phase(
            torch, ops, f"plan_memory_{name}",
            lambda: engine.run(params, batches), {**zero, **large})
        tally(counts)
        peak = torch.cuda.max_memory_allocated()
        mem[name] = {"peak_gb": peak / 1e9,
                     "peak_above_start_gb": (peak - base) / 1e9,
                     "run_seconds": seconds,
                     "rounds_per_s": ROUNDS / seconds}
        del engine, params, batches
    mem_eq = result_diff(np, torch, mem_runs["chunked_async"],
                         mem_runs["monolithic"])
    emit("plan_memory", grid="worker_grid(1000)", lanes=len(grid_u),
         rounds=ROUNDS, chunk=MEM_CHUNK, runs=mem,
         saved_gb=mem["monolithic"]["peak_gb"]
         - mem["chunked_async"]["peak_gb"],
         batches_gb_predicted_saved=(ROUNDS - 2 * MEM_CHUNK)
         * BATCH_MB_PER_ROUND_U1000 / 1e3,
         chunked_vs_monolithic=mem_eq)
    if not mem_eq["bitwise"]:
        raise AssertionError("plan: the chunked U = 1000 grid differs from "
                             "the monolithic run")
    del mem_runs
    torch.cuda.empty_cache()

    # (d) the reference paths: the switch dispatch on the defense grid and
    # the tree state on fig3, default and strict_numerics, each against
    # its plain route, and against the grouped / flat run of the same plan
    d = mc_u.dim
    fixed = {"grad_stats_segments": 2 * ROUNDS}   # parts + fold a round
    defense = lambda plan, fp=False: (lambda: figures.cases_engine(  # noqa
        figures.defense_cases(), ROUNDS, device="cuda", plan=plan,
        force_plain=fp))
    routes = {   # name: (build, plan, launches, reference route)
        "defenses_grouped": (defense, {}, {
            "floa_step_batched": ROUNDS, "grad_stats": ROUNDS,
            "sort_columns": 2 * ROUNDS}, None),
        "defenses_switch": (defense, dict(grouped_dispatch=False), {
            "floa_aggregate_batched": ROUNDS, "grad_stats": ROUNDS,
            "sort_columns": 2 * ROUNDS}, "defenses_grouped"),
        "defenses_grouped_strict": (defense, dict(strict_numerics=True), {
            "floa_step_batched": ROUNDS, **fixed,
            "sort_columns": 2 * ROUNDS}, None),
        "defenses_switch_strict": (defense, dict(
            grouped_dispatch=False, strict_numerics=True), {
            "floa_aggregate_batched": ROUNDS, **fixed,
            "sort_columns": 2 * ROUNDS}, "defenses_grouped_strict"),
        "fig3_tree": (fig, dict(flat_state=False), {
            "floa_aggregate_batched": ROUNDS}, "fig3_flat"),
        "fig3_flat_strict": (fig, dict(strict_numerics=True), {
            "floa_step_batched": ROUNDS, **fixed}, None),
        "fig3_tree_strict": (fig, dict(flat_state=False,
                                       strict_numerics=True), {
            "floa_aggregate_batched": ROUNDS, **fixed},
            "fig3_flat_strict")}
    results = {"fig3_flat": runs["monolithic"]}
    report = {"fig3_flat": rates["monolithic"]}
    for name, (build, plan, expect, ref) in routes.items():
        results[name], report[name] = counted(
            f"plan_{name}", build(ExecutionPlan(**plan)), expect)
        if ref is None:
            continue
        rp = plain(f"plan_{name}_plain", build(ExecutionPlan(**plan), True))
        whole_run_check(f"kernel_vs_plain_{name}", results[name], rp)
        report[name]["vs_reference_route"] = {
            "reference": ref, **result_diff(np, torch, results[name],
                                            results[ref])}
        diff = report[name]["vs_reference_route"]["max_rel_diff"]
        if max(diff.values()) > RTOL_WHOLE_RUN:
            raise AssertionError(f"plan: {name} differs from {ref} beyond "
                                 f"rtol {RTOL_WHOLE_RUN}: {diff}")
    emit("plan_reference_paths", rounds=ROUNDS, D=d, routes=report)


def strict_rates(torch, figures) -> dict:
    """`--strict-rates`: warm rounds/s of the strict_numerics routes (the
    defense grid grouped and switched, fig3 flat and tree, the U = 1000
    grid, and the LM lane unsharded at R = 20, built as the mesh phase
    builds its strict twin), uncounted: one run to warm up, then the
    median of 3."""
    from repro_torch.configs import PAPER_MLP
    from repro_torch.core.power_control import Policy
    from repro_torch.fl import ExecutionPlan, SweepEngine
    fig3 = [figures.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                               attacker_sigma=3.0, rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    mc_u = dataclasses.replace(PAPER_MLP.full(), num_workers=1000,
                               train_samples=32000)
    strict = dict(strict_numerics=True)

    def lm_strict():
        engine, params, batches = figures.lm_lane_engine(ROUNDS,
                                                         device="cuda")
        return (SweepEngine(engine.loss_fn, engine.spec, plan=ExecutionPlan(
            **strict), device="cuda"), params, batches)

    routes = {
        "defenses_grouped_strict": (ROUNDS, lambda: figures.cases_engine(
            figures.defense_cases(), ROUNDS, device="cuda",
            plan=ExecutionPlan(**strict))),
        "defenses_switch_strict": (ROUNDS, lambda: figures.cases_engine(
            figures.defense_cases(), ROUNDS, device="cuda",
            plan=ExecutionPlan(grouped_dispatch=False, **strict))),
        "fig3_flat_strict": (ROUNDS, lambda: figures.figure_engine(
            fig3, device="cuda", plan=ExecutionPlan(**strict))),
        "fig3_tree_strict": (ROUNDS, lambda: figures.figure_engine(
            fig3, device="cuda", plan=ExecutionPlan(flat_state=False,
                                                    **strict))),
        "grid_u1000_strict": (ROUNDS_LARGE_U, lambda: figures.cases_engine(
            figures.worker_grid(1000, mc_u.dim), ROUNDS_LARGE_U, mc=mc_u,
            device="cuda", plan=ExecutionPlan(**strict))),
        "lm_strict": (ROUNDS, lm_strict)}
    out = {}
    for name, (rounds, build) in routes.items():
        engine, params, batches = build()
        engine.run(params, batches)
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.run(params, batches)
            torch.cuda.synchronize()
            rates.append(rounds / (time.perf_counter() - t0))
        out[name] = {"rounds": rounds, "rounds_per_s": sorted(rates)[1],
                     "rounds_per_s_runs": rates}
        del engine, params, batches
        torch.cuda.empty_cache()
    return out


def lm_lane_phase(torch, np, ops, figures, tally) -> None:
    """Phases 18-19: the LM lane at the full lm_sweep config through
    `figures.run_lm_lane` (counted; its launches by shape checked), a warm
    run's rate, the example's claims, then the plain route from the same
    seeded draws."""
    from repro_torch.configs import flat_param_dim, get_lm_sweep
    cfg = get_lm_sweep()
    d = flat_param_dim(cfg)
    if d != LM_D:
        raise AssertionError(f"lm_sweep's flat D is {d}, expected {LM_D}")
    u = LM_WORKERS
    expect = {"floa_step_batched": ROUNDS, "grad_stats": ROUNDS,
              "sort_columns": ROUNDS}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, seconds, counts = run_phase(
        torch, ops, "main_lm_lane",
        lambda: figures.run_lm_lane(ROUNDS, device="cuda"),
        {**step_launches(ops, cfg, 0, init=True), **expect})
    peak = torch.cuda.max_memory_allocated()
    tally(counts)
    shapes = ops.launch_shapes()
    want = {"floa_step_batched": {(2, u, d): ROUNDS},
            "grad_stats": {(2 * u, d): ROUNDS},
            "sort_columns": {(1, u, d): ROUNDS}}
    for k, v in want.items():
        if shapes[k] != v:
            raise AssertionError(f"lm_lane: {k} launched at {shapes[k]}, "
                                 f"expected {v}")
    if not (np.isfinite(res.loss).all() and np.isfinite(res.grad_norm).all()):
        raise AssertionError("lm_lane: non-finite loss or grad norm")
    engine, params0, batches = figures.lm_lane_engine(ROUNDS, device="cuda")
    engine.run(params0, batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(params0, batches)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    del engine, params0
    tail = max(1, ROUNDS // 5)   # the example's tail
    lanes = {n: {"loss_first": float(res.loss[i, 0]),
                 "loss_tail_mean": float(np.mean(res.loss[i, -tail:])),
                 "loss_final": float(res.loss[i, -1]),
                 "grad_norm_final": float(res.grad_norm[i, -1])}
             for i, n in enumerate(res.names)}
    emit("main_lm_lane", config="qwen3-4b lm_sweep", D=d, workers=u,
         batch=LM_BATCH, seq=LM_SEQ, rounds=ROUNDS, lanes=lanes, tail=tail,
         run_seconds=seconds, steady_run_seconds=steady,
         rounds_per_s=ROUNDS / steady, peak_memory_gb=peak / 1e9,
         peak_above_start_gb=(peak - base) / 1e9, launches=counts,
         launches_by_shape={k: {str(list(sh)): n for sh, n in v.items()}
                            for k, v in want.items()})
    clean = res.loss[res.names.index("bev-clean")]
    attacked = res.loss[res.names.index("bev-signflip")]
    if not np.mean(clean[-tail:]) < clean[0]:
        raise AssertionError("lm_lane: the clean BEV lane failed to reduce "
                             "the LM loss")
    if not attacked[-1] > clean[-1]:
        raise AssertionError("lm_lane: the sign-flip lane does not end above "
                             "the clean lane")
    # 19. the same rounds through the plain versions, from the same draws
    # and the same weights (their init, as every init on the card, through
    # counter_trunc_normal)
    ops.reset_launches()
    rp = figures.run_lm_lane(ROUNDS, device="cuda", plain=True)
    if ops.launch_counts() != step_launches(ops, cfg, 0, init=True):
        raise AssertionError(f"lm_lane: the plain route launched "
                             f"{ops.launch_counts()}")
    whole_run_check("kernel_vs_plain_lm_lane", res, rp)
    del res, rp
    torch.cuda.empty_cache()


def train_phase(torch, ops, lm, params) -> dict:
    """Phase 20: the FLOA train step at full width from `params`, then the
    prefill step.  Counted: the step launches the update kernel once a
    leaf (`noisy_sgd`, its noise drawn from the stream) and nothing
    else; returns the counts."""
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import (init_floa_state, make_prefill_step,
                                          make_train_step)
    from repro_torch.models.common import count_params
    from repro_torch.tree import tree_leaves
    shape = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, kind="train")
    step, meta = make_train_step(lm, None, shape, alpha=TRAIN_ALPHA)
    tokens = [torch.as_tensor(sample_tokens(TRAIN_BATCH, TRAIN_SEQ + 1,
                                            lm.vocab_size, seed=t),
                              device="cuda") for t in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def run():
        p, state, log = params, init_floa_state("cuda"), []
        for t in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, m = step(p, state, {"tokens": tokens[t]}, t)
            torch.cuda.synchronize()
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "loss": float(m["loss"]),
                        "grad_scale": float(m["grad_scale"]),
                        "gbar": float(state["gbar"]),
                        "eps2": float(state["eps2"])})
        return p, log

    (trained, log), seconds, counts = run_phase(
        torch, ops, "main_train", run, step_launches(ops, lm, TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x["loss"]) for x in log):
        raise AssertionError(f"train: non-finite loss {log}")
    changed = [int((a != b).sum()) for a, b in
               zip(tree_leaves(trained), tree_leaves(params))]
    if not any(changed):
        raise AssertionError("train: no parameter moved in 5 steps")
    n = meta["dim"]
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    # a step's least time: 6 bf16 operations a parameter a token (forward
    # and backward) at 989 TFLOP/s, against reading the weights, writing
    # and reading the gradients and writing the weights (bf16)
    t_ops = 6 * n * tokens_step / BF16_FLOPS_PER_S * 1e3
    t_bytes = 4 * 2 * n / HBM_BYTES_PER_S * 1e3
    warm = [x["ms"] for x in log[1:]]
    pf, _ = make_prefill_step(lm, None, dict(
        global_batch=PREFILL_BATCH, seq_len=PREFILL_SEQ, kind="prefill"))
    batch = {"tokens": torch.as_tensor(sample_tokens(
        PREFILL_BATCH, PREFILL_SEQ, lm.vocab_size, seed=7), device="cuda")}
    logits = pf(trained, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = pf(trained, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if (tuple(logits.shape) != (PREFILL_BATCH, lm.padded_vocab)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    emit("main_train", arch=lm.name, dtype=str(lm.dtype)[6:],
         layers=lm.n_layers, params=n, counted_params=count_params(params),
         workers=meta["num_workers"], policy=meta["policy"],
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=log,
         ms_per_step_warm=sum(warm) / len(warm), run_seconds=seconds,
         bound_ms=max(t_ops, t_bytes),
         bound_by="operations" if t_ops >= t_bytes else "bytes",
         peak_memory_gb=peak / 1e9,
         leaves_changed=sum(c > 0 for c in changed),
         leaves=len(changed),
         elements_changed_share=sum(changed) / n, launches=counts,
         prefill={"batch": PREFILL_BATCH, "seq": PREFILL_SEQ,
                  "ms": prefill_ms, "logits_shape": list(logits.shape)})
    return counts


def weight_bytes(params) -> int:
    """Bytes a decode step reads of the weights: every leaf but the
    embedding table, of which it gathers a few rows, and the leaves only
    the full sequence reads (a VLM's projector; an encoder-decoder's
    encoder and its cross-attention's wk / wv, whose K / V a decode step
    takes precomputed)."""
    from repro_torch.tree import tree_leaves
    skip = [params["embed"], *tree_leaves(params.get("projector", {}))]
    if "dec_blocks" in params:
        cross = params["dec_blocks"]["cross_attn"]
        skip += [params["enc_in"], params["enc_norm"], cross["wk"],
                 cross["wv"], *tree_leaves(params["enc_blocks"])]
    ids = {id(x) for x in skip}
    return sum(x.numel() * x.element_size() for x in tree_leaves(params)
               if id(x) not in ids)


def attn_layers(cfg) -> int:
    """The layers of cfg whose decode step launches the decode-attention
    kernel: its GQA attn / attn_moe and local_attn blocks."""
    from repro_torch.models.transformer import ATTN_KINDS, layer_counts
    n_rep, n_tail = layer_counts(cfg)
    kinds = list(cfg.block_pattern) * n_rep + list(cfg.block_pattern[:n_tail])
    return sum(k in ATTN_KINDS and (cfg.mla is None or k == "local_attn")
               for k in kinds)


def zoo_parity(torch, ops, cfg, params, seq) -> dict:
    """Teacher-forced logits of seq through the kernel route and the plain
    route, held at phase 15's bf16 bounds.  An MoE model's plain run
    replays the kernel run's expert choices (`moe.RoutingTape`): routing
    is discontinuous, so a rounding-level difference can swap two nearly
    tied experts of a token and move its logits by a whole expert's share;
    the choices the plain run would have made otherwise are counted
    (`router_flips`), and the same plain run without the replay is
    reported beside (`unreplayed`), not held."""
    from repro_torch.models import moe as MOE
    steps = seq.shape[1]
    tape = MOE.RoutingTape()
    ops.reset_launches()
    with MOE.routing(tape):
        lk = teacher_forced(torch, cfg, params, seq, False)
        tape.replay()
        lp = teacher_forced(torch, cfg, params, seq, True)
    if ops.launch_counts()["decode_attention"] != attn_layers(cfg) * steps:
        raise AssertionError(f"{cfg.name} parity: {ops.launch_counts()}")
    parity, ok = logit_parity(torch, lk, lp, cfg.vocab_size)
    parity.update(router_flips=int(tape.flips) if tape.decisions else 0,
                  router_decisions=tape.decisions)
    if cfg.moe is not None:
        lu = teacher_forced(torch, cfg, params, seq, True)
        parity["unreplayed"] = logit_parity(torch, lk, lu,
                                            cfg.vocab_size)[0]
        del lu
    del lk, lp
    parity["ok"] = ok
    return parity


def lm_batch(torch, cfg, b, seq, seed, n_front=0) -> dict:
    """A batch of cfg on the card: tokens [b, seq + 1] of the Markov stream
    of `seed`, and a VLM's `embeds_prefix` of n_front positions or an
    encoder-decoder's `frames` of n_front positions, standard normal from
    `seed`, in bf16 (`steps.batch_shapes`' dtype)."""
    from repro_torch.data import sample_tokens
    out = {"tokens": torch.as_tensor(sample_tokens(b, seq + 1,
                                                   cfg.vocab_size, seed=seed),
                                     device="cuda")}
    if cfg.arch_type in ("vlm", "audio"):
        gen = torch.Generator("cuda").manual_seed(seed)
        name = "embeds_prefix" if cfg.arch_type == "vlm" else "frames"
        out[name] = torch.randn((b, n_front, cfg.frontend.feature_dim),
                                generator=gen, device="cuda").bfloat16()
    return out


def lm_train_prefill(torch, ops, cfg, batches=None) -> dict:
    """The FLOA train step (two BEV steps at phase 20's batch and length:
    U = 1, an MoE model's aux term in the weighted loss) and the prefill
    (phase 20's 8 x 512, on the trained weights) of cfg, from its own
    random weights; the train step launches the update kernel once a leaf
    (`noisy_sgd`), the prefill no kernel of the port.  `batches`
    replaces phase 20's: (two train batches, their input shape's seq_len,
    the prefill batch, its seq_len), for the frontends' layouts.  Nothing
    holds the drawn weights past the first step (their checksums tell the
    leaves that moved), so the peak is one step's: its input, gradients
    and output (the noise is drawn in the kernel's registers)."""
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import (init_floa_state, make_prefill_step,
                                          make_train_step, per_example_loss)
    from repro_torch.tree import tree_leaves
    if batches is None:
        batches = ([lm_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, t)
                    for t in range(2)], TRAIN_SEQ,
                   {"tokens": torch.as_tensor(sample_tokens(
                       PREFILL_BATCH, PREFILL_SEQ, cfg.vocab_size, seed=7),
                       device="cuda")}, PREFILL_SEQ)
    train_batches, seq_len, prefill_batch, prefill_seq = batches
    b = train_batches[0]["tokens"].shape[0]
    params = lm_params(torch, cfg)
    before = bit_checksums(torch, tree_leaves(params))
    shape = dict(global_batch=b, seq_len=seq_len, kind="train")
    step, meta = make_train_step(cfg, None, shape, alpha=TRAIN_ALPHA)
    with torch.no_grad():
        _, aux = per_example_loss(params, train_batches[0], cfg)
    held = [params]
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        p, state, log = held.pop(), init_floa_state("cuda"), []
        for t in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, m = step(p, state, train_batches[t], t)
            torch.cuda.synchronize()
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "loss": float(m["loss"]),
                        "grad_scale": float(m["grad_scale"])})
        return p, log

    (params, log), _, counts = run_phase(
        torch, ops, "lm_train", run, step_launches(ops, cfg, 2))
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    moved = int((bit_checksums(torch, tree_leaves(params)) != before)
                .any(dim=1).sum())
    if not (all(math.isfinite(x["loss"]) for x in log) and moved
            and (cfg.moe is None or float(aux) > 0)):
        raise AssertionError(f"{cfg.name} train: {log}, {moved} leaves "
                             f"moved, aux {float(aux)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pb, ps = prefill_batch["tokens"].shape
    pf, _ = make_prefill_step(cfg, None, dict(
        global_batch=pb, seq_len=prefill_seq, kind="prefill"))
    logits, _, pcounts = run_phase(torch, ops, "lm_prefill",
                                   lambda: pf(params, prefill_batch),
                                   {k: 0 for k in ops.KERNELS})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = pf(params, prefill_batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if (tuple(logits.shape) != (pb, cfg.padded_vocab)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill: logits "
                             f"{tuple(logits.shape)}")
    front = {k: list(v.shape) for k, v in train_batches[0].items()
             if k != "tokens"}
    return {"layers": cfg.n_layers, "params": meta["dim"],
            "batch": b, "seq": train_batches[0]["tokens"].shape[1] - 1,
            **({"frontend_inputs": front} if front else {}),
            "steps": log, "warm_step_ms": log[-1]["ms"],
            "aux_loss": float(aux), "leaves_moved": moved,
            "leaves": len(before), "peak_memory_gb": train_peak,
            "launches": counts, "prefill": {
                "batch": pb, "seq": ps, "ms": prefill_ms, "launches": pcounts,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}}


def serve_cell(torch, ops, cfg, params, expect, tally) -> tuple:
    """cfg served from `params` as phase 14 serves qwen3-4b (bf16, batch 8,
    32 + 32 tokens), counted (`expect`: every kernel's launches; `tally`
    reads them at once, by shape too), and again for the steady rates;
    its decode step at the last position as one CUDA graph, and its
    launches and the device's busy share (torch.profiler): (the first
    serve's result, the report's fields)."""
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, param_count
    from repro_torch.models import transformer as LM
    n_steps = SERVE_PROMPT + SERVE_GEN
    rs, seconds, counts = run_phase(
        torch, ops, f"serve {cfg.name}",
        lambda: serve(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                      device="cuda", params=params),
        {**{k: 0 for k in ops.KERNELS}, **expect})
    tally(counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (torch.isfinite(rs.logits).all()
            and 0 <= int(rs.tokens.min()) <= int(rs.tokens.max())
            < cfg.vocab_size):
        raise AssertionError(f"serve {cfg.name}: non-finite logits or "
                             f"tokens outside the vocabulary")
    steady = serve(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                   device="cuda", params=params)
    if not torch.equal(steady.tokens, rs.tokens):
        raise AssertionError(f"serve {cfg.name}: two runs differ")
    step, meta = make_decode_step(cfg)
    caches = LM.init_caches(cfg, SERVE_BATCH, n_steps, device="cuda")
    seq = torch.cat([rs.prompts, rs.tokens], dim=1)
    last = torch.tensor(n_steps - 1, dtype=torch.int32, device="cuda")
    one = lambda: step(params, caches, seq[:, -1:], last)  # noqa: E731
    graph_ms = time_ms(torch, one, 1)
    prof = profile_phase(torch, one)
    del caches, one
    wb = weight_bytes(params)
    return rs, dict(
        arch=cfg.name, dtype=str(cfg.dtype)[6:], layers=cfg.n_layers,
        params=param_count(cfg),
        weights_gb=(wb + params["embed"].numel() * 2) / 1e9,
        window=meta["window"], batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
        gen=SERVE_GEN, run_seconds=seconds, prefill_s=steady.prefill_s,
        decode_s=steady.decode_s,
        eager_ms_per_step=steady.decode_s * 1e3 / SERVE_GEN,
        graph_ms=graph_ms, tok_per_s=steady.tok_per_s,
        graph_tok_per_s=SERVE_BATCH / graph_ms * 1e3,
        launches_per_step=prof["kernel_launches"],
        device_busy_share_eager=prof["device_busy_share"], profile=prof,
        weights_bound_ms=wb / HBM_BYTES_PER_S * 1e3, peak_memory_gb=peak_gb,
        launches=counts, sample_tokens=rs.tokens[0, :12].tolist())


def zoo_phase(torch, ops, tally) -> None:
    """Phase 23: each ZOO arch served at full width in bf16 with random
    weights (batch 8, 32 + 32 tokens, as phase 14; counted), its decode
    step's eager and graph times, launches a step and peak memory
    (`serve_cell`), its routes held against each other (`zoo_parity`,
    full depth), and moonshot's train step and prefill at 4 layers."""
    from repro_torch.configs import get_config
    for arch, depth in ZOO:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=depth or full.n_layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm_params(torch, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rs, report = serve_cell(torch, ops, cfg, params, {
            "decode_attention": cfg.n_layers * (SERVE_PROMPT + SERVE_GEN)},
            tally)
        seq = torch.cat([rs.prompts, rs.tokens], dim=1)
        parity = zoo_parity(torch, ops, cfg, params, seq)
        emit("zoo_serve", **report, full_layers=full.n_layers,
             init_s=init_s, parity=parity)
        if not parity["ok"]:
            raise AssertionError(f"zoo {arch}: kernel route and plain route "
                                 f"disagree")
        del params, rs, seq
        torch.cuda.empty_cache()
        if arch == MOE_TRAIN_ARCH:
            emit("zoo_moe_train", arch=arch, **lm_train_prefill(
                torch, ops, dataclasses.replace(
                    full, n_layers=MOE_TRAIN_LAYERS)))
            torch.cuda.empty_cache()


def fill_caches(torch, caches, seed) -> None:
    """Every cache leaf filled with seeded standard-normal values, as if a
    prompt had been decoded into it (phase 16's fill)."""
    from repro_torch.tree import tree_leaves
    gen = torch.Generator("cuda").manual_seed(seed)
    for leaf in tree_leaves(caches):
        leaf.normal_(generator=gen)


def ring_run(torch, cfg, params, caches, tokens, first, plain=False,
             events=None):
    """len(tokens[0]) long_500k decode steps from pos `first` on, the kernel
    route or its plain version: logits [steps, B, Vp]."""
    from repro_torch.launch.steps import make_decode_step
    step, _ = make_decode_step(cfg, "long_500k", plain=plain)
    run = decode_steps(step)
    n = tokens.shape[1]
    positions = torch.arange(first, first + n, dtype=torch.int32,
                             device="cuda")
    out = []
    if events:
        events[0].record()
    for i in range(n):
        out.append(run(params, caches, tokens[:, i:i + 1],
                       positions[i])[:, 0].clone())
        if events:
            events[i + 1].record()
    return torch.stack(out)


class f32_attention:
    """Within the block, the decode attention of every route is the plain
    version on its inputs upcast to f32, cast back to their dtype: the
    reference a bf16 model's two routes are each measured against
    (`long500_phase`)."""

    def __init__(self, ops):
        self.ops, self.orig = ops, ops.decode_attention

    def __enter__(self):
        ref = self.ops.decode_attention_ref
        self.ops.decode_attention = lambda q, k, v, pos, plain=False: ref(
            q.float(), k.float(), v.float(), pos).to(q.dtype)

    def __exit__(self, *exc):
        self.ops.decode_attention = self.orig


def hybrid_routes(torch, ops, cfg, params, run) -> tuple:
    """The kernel route's logits run(False) against the plain route's
    run(True), and both against the f32-attention reference's (the plain
    route with `f32_attention`), bf16: (parity, ok).  ok at phase 15's
    bounds (`logit_parity`); failing them on the mean alone, ok when every
    clear step's argmax agrees, the max stays within BF16_LOGIT_MAX and
    the kernel route's mean |diff| from the reference is no larger than
    the plain route's (`long500_phase` holds max and mean so; over
    8 x 256 000 logits the max of two such noisy runs is a coin flip,
    the mean is not).  The plain route rounds each layer's scores and
    probabilities to bf16, and recurrentgemma-9b's RG-LRU state carries
    that rounding forward through the sequence as well as through depth:
    at full depth its kernel-vs-plain mean |diff| is 0.024 (serve) and
    0.026 (long_500k), above phase 15's 0.02, and each route stands about
    as far from exact attention (measured on an H100 80GB HBM3 at
    700 W)."""
    lk, lp = run(False), run(True)
    with f32_attention(ops):
        lf = run(True)
    parity, ok = logit_parity(torch, lk, lp, cfg.vocab_size)
    to_ref = {name: {"max_abs_diff": float((a.float() - lf.float())
                                           .abs().max()),
                     "mean_abs_diff": float((a.float() - lf.float())
                                            .abs().mean())}
              for name, a in (("kernel", lk), ("plain", lp))}
    closer = (to_ref["kernel"]["mean_abs_diff"]
              <= to_ref["plain"]["mean_abs_diff"])
    parity.update(to_f32_attention=to_ref, within_phase15_bounds=ok,
                  kernel_mean_closer_to_f32_attention=closer)
    ok = ok or (parity["clear_agree"] and closer
                and parity["max_abs_diff"] <= BF16_LOGIT_MAX)
    return {**parity, "ok": ok}, ok


def long500_phase(torch, ops, tally) -> None:
    """Phase 23: long_500k for LONG500_ARCHS at full width in bf16, batch 1
    (the shape's global_batch) against rings of decode_window slots filled
    as phase 16 fills its cache: 8 steps at pos 524 280-524 287 (counted;
    eager per step and as a graph, against the bytes bound), the same steps
    through the plain route and through the f32-attention reference
    (`f32_attention`) from the same filled ring, then 2 layers in f32
    through both routes across a wrap of the ring (pos 2 slots - 4 to
    2 slots + 3), rtol 1e-4.

    The bf16 check: the kernel route's logits no farther from the
    reference's than the plain route's (max and mean |diff|), and every
    clear step's argmax agreeing with the plain route's.  Phase 15's
    absolute bounds do not apply here: on a ring of 4096-8192 random
    slots at batch 1, even the exact-attention reference stands a mean
    |diff| of about 0.03 and a max of about 0.2 from the kernel route over
    30-36 layers (measured on an H100 80GB HBM3 at 700 W), from the
    residual stream's bf16 rounding alone."""
    for arch in LONG500_ARCHS:
        long500_arch(torch, ops, tally, arch)


def long500_arch(torch, ops, tally, arch) -> None:
    """Phase 24's run of one arch (`long500_phase`); phase 28 runs it for
    llava-next-mistral-7b's 4096-slot rings."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import decode_window
    from repro_torch.models import transformer as LM
    from repro_torch.tree import tree_map
    shape = INPUT_SHAPES["long_500k"]
    b, first = shape["global_batch"], LONG500_POS - LONG_STEPS + 1
    cfg = get_config(arch)
    window = decode_window(cfg, "long_500k")
    slots = min(shape["seq_len"], window)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm_params(torch, cfg)
    caches = LM.init_caches(cfg, b, shape["seq_len"], window=window,
                            device="cuda")
    fill_caches(torch, caches, 1)
    pristine = tree_map(lambda x: x.clone(), caches)
    tokens = torch.as_tensor(sample_tokens(b, LONG_STEPS, cfg.vocab_size,
                                           seed=2), device="cuda")
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(LONG_STEPS + 1)]
    lk, seconds, counts = run_phase(
        torch, ops, f"long_500k {arch}",
        lambda: ring_run(torch, cfg, params, caches, tokens, first,
                         events=events),
        {**{k: 0 for k in ops.KERNELS},
         "decode_attention": cfg.n_layers * LONG_STEPS})
    tally(counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not torch.isfinite(lk).all():
        raise AssertionError(f"long_500k {arch}: non-finite logits")
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(LONG_STEPS)]
    from repro_torch.launch.steps import make_decode_step
    step, _ = make_decode_step(cfg, "long_500k")
    last = torch.tensor(LONG500_POS, dtype=torch.int32, device="cuda")
    graph_ms = time_ms(torch, lambda: step(params, caches,
                                           tokens[:, -1:], last), 1)
    del caches
    ref_caches = tree_map(lambda x: x.clone(), pristine)
    lp = ring_run(torch, cfg, params, pristine, tokens, first,
                  plain=True)
    with f32_attention(ops):
        lf = ring_run(torch, cfg, params, ref_caches, tokens, first,
                      plain=True)
    parity, _ = logit_parity(torch, lk, lp, cfg.vocab_size)
    to_ref = {name: {"max_abs_diff": float((a.float() - lf.float())
                                           .abs().max()),
                     "mean_abs_diff": float((a.float() - lf.float())
                                            .abs().mean())}
              for name, a in (("kernel", lk), ("plain", lp))}
    ok = parity["clear_agree"] and all(
        to_ref["kernel"][k] <= to_ref["plain"][k]
        for k in to_ref["kernel"])
    parity["to_f32_attention"] = to_ref
    del ref_caches, lf
    cache_bytes = (2 * cfg.n_layers * b * slots * cfg.n_kv_heads
                   * cfg.hd * 2)
    wb = weight_bytes(params)
    del pristine, lk, lp, params
    torch.cuda.empty_cache()
    # f32, 2 layers, across the ring's second wrap
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params32 = lm_params(torch, cfg32)
    c32 = LM.init_caches(cfg32, b, shape["seq_len"], window=window,
                         device="cuda")
    fill_caches(torch, c32, 3)
    c32p = tree_map(lambda x: x.clone(), c32)
    ops.reset_launches()
    wrap = 2 * slots - LONG_STEPS // 2
    fk = ring_run(torch, cfg32, params32, c32, tokens, wrap)
    fp = ring_run(torch, cfg32, params32, c32p, tokens, wrap, plain=True)
    f32_counts = ops.launch_counts()
    tally(f32_counts)
    f32_ok = bool(torch.allclose(fk, fp, rtol=RTOL_WHOLE_RUN, atol=1e-5))
    emit("long_500k", arch=arch, dtype="bfloat16", layers=cfg.n_layers,
         batch=b, window=window, slots=slots, positions=[first,
                                                         LONG500_POS],
         steps=LONG_STEPS, step_ms=step_ms,
         ms_per_step=sum(step_ms[1:]) / (LONG_STEPS - 1),
         graph_ms=graph_ms,
         bound_ms=(cache_bytes + wb) / HBM_BYTES_PER_S * 1e3,
         cache_gb=cache_bytes / 1e9, weights_read_gb=wb / 1e9,
         run_seconds=seconds, peak_memory_gb=peak_gb, launches=counts,
         parity_bf16={**parity, "ok": ok},
         f32_wrap={"layers": 2, "positions": [wrap, wrap + LONG_STEPS
                                              - 1],
                   "wrap_at": 2 * slots, "ok": f32_ok,
                   "rtol": RTOL_WHOLE_RUN, "atol": 1e-5,
                   "max_abs_diff": max_errors(torch, fk, fp)[0],
                   "max_rel_diff": max_errors(torch, fk, fp)[1],
                   "launches": f32_counts})
    if not (ok and f32_ok):
        raise AssertionError(f"long_500k {arch}: kernel route and plain "
                             f"route disagree")
    del params32, c32, c32p, fk, fp
    torch.cuda.empty_cache()


def events_ms(events) -> list:
    """The ms between consecutive recorded CUDA events."""
    return [events[i].elapsed_time(events[i + 1])
            for i in range(len(events) - 1)]


def long_steps(torch, ops, name, cfg, params, caches, tokens, first) -> dict:
    """LONG_STEPS long_500k decode steps of cfg from pos `first` against
    filled caches (counted: no kernel of the port), eager ms a step
    (CUDA events) and the last step as one CUDA graph: (logits [steps, B,
    Vp], report)."""
    from repro_torch.launch.steps import make_decode_step
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(LONG_STEPS + 1)]
    logits, seconds, counts = run_phase(
        torch, ops, name, lambda: ring_run(torch, cfg, params, caches,
                                           tokens, first, events=events),
        {k: 0 for k in ops.KERNELS})
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{name}: non-finite logits")
    step, _ = make_decode_step(cfg, "long_500k")
    last = torch.tensor(first + LONG_STEPS - 1, dtype=torch.int32,
                        device="cuda")
    graph_ms = time_ms(torch, lambda: step(params, caches, tokens[:, -1:],
                                           last), 1)
    step_ms = events_ms(events)
    return logits, {"positions": [first, first + LONG_STEPS - 1],
                    "step_ms": step_ms,
                    "ms_per_step": sum(step_ms[1:]) / (LONG_STEPS - 1),
                    "graph_ms": graph_ms, "run_seconds": seconds,
                    "launches": counts}


def decode_vs_prefill(torch, cfg, params, seq) -> dict:
    """cfg's decode steps teacher-forced through seq [B, S] from empty
    caches against its full-sequence forward on the same tokens, the
    forward's expert choices replayed in the decode (an MoE model): MLA's
    absorbed decode against the materialized prefill, the SSD block's
    recurrent form against its chunked dual form.  Held at rtol 1e-4 with
    an atol of 1e-4 of the largest |logit|, as the CPU tests hold decode
    against prefill."""
    import contextlib
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as LM
    ftape = MOE.RoutingTape()
    with torch.no_grad(), MOE.routing(ftape):
        want = LM.forward(params, seq, cfg)[0].transpose(0, 1)
    b, n = seq.shape
    dtape = ftape.by_step(b, n)
    # the tape routes an MoE model's decode (so the decode runs eagerly);
    # a model without experts never reads it, and replays its graph
    with (MOE.routing(dtape) if cfg.moe is not None
          else contextlib.nullcontext()):
        got = teacher_forced(torch, cfg, params, seq, False)
    atol = RTOL_WHOLE_RUN * float(want.abs().max())
    ok = bool(torch.allclose(got, want, rtol=RTOL_WHOLE_RUN, atol=atol))
    err = (got - want).abs()
    return {"layers": cfg.n_layers, "dtype": str(cfg.dtype)[6:],
            "batch": b, "seq": n, "rtol": RTOL_WHOLE_RUN, "atol": atol,
            "max_abs_diff": float(err.max()),
            "max_excess": float((err - RTOL_WHOLE_RUN * want.abs()).max()),
            "logit_max": float(want.abs().max()),
            "router_flips": int(dtape.flips) if dtape.flips is not None
            else 0, "ok": ok}


def mla_ssm_phase(torch, ops, tally) -> None:
    """Phase 26: MLA and the SSD block, which run no kernel of the port
    (the reference computes both outside any Pallas kernel), so every
    count stays 0.  (a) deepseek-v2-236b at full width cut to MLA_LAYERS
    of 60 layers (bf16), served (`serve_cell`); (b) its long_500k: batch 1
    over a full, unwindowed latent cache of 524 288 slots filled as phase
    16 fills its cache, LONG_STEPS steps at pos 524 280-524 287
    (`long_steps`).  Then at MLA_CUT_LAYERS: the absorbed decode against
    the materialized prefill in f32 on the serve's tokens
    (`decode_vs_prefill`), and the bf16 serve's teacher-forced logits and
    the bf16 long_500k steps against f32 on the same weights (upcast) and
    cache, the bf16 run's expert choices replayed, at phase 15's bf16
    bounds; (c) the train step and prefill at MLA_CUT_LAYERS
    (`lm_train_prefill`).  (d) mamba2-1.3b at full width and depth:
    served; long_500k from filled states at pos 524 280-524 287 and from
    the same states at pos 33-40, bitwise equal (the recurrence ignores
    pos) with their ms a step; the SSD duality in f32 at SSD_DUAL_LAYERS
    on SSD_DUAL_SEQ tokens (two chunks); the train step and prefill."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import decode_window
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as LM
    from repro_torch.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    slots = INPUT_SHAPES["long_500k"]["seq_len"]
    first = LONG500_POS - LONG_STEPS + 1

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    # (a) deepseek-v2-236b at MLA_LAYERS, served
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    tokens = torch.as_tensor(sample_tokens(1, LONG_STEPS, cfg.vocab_size,
                                           seed=2), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_params(torch, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rs, report = serve_cell(torch, ops, cfg, params, {}, tally)
    emit("mla_serve", **report, full_layers=full.n_layers, init_s=init_s)
    seq = torch.cat([rs.prompts, rs.tokens], dim=1)
    # (b) long_500k over the full latent cache
    if decode_window(cfg, "long_500k") is not None:
        raise AssertionError("mla long_500k: a window")
    caches = LM.init_caches(cfg, 1, slots, device="cuda")
    fill_caches(torch, caches, 1)
    _, long_report = long_steps(torch, ops, "mla_long_500k", cfg, params,
                                caches, tokens, first)
    cache_bytes, wb = nbytes(caches), weight_bytes(params)
    long_report.update(
        arch=cfg.name, layers=cfg.n_layers, batch=1, slots=slots,
        cache_gb=cache_bytes / 1e9, weights_read_gb=wb / 1e9,
        bound_ms=(cache_bytes + wb) / HBM_BYTES_PER_S * 1e3,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, caches, rs
    torch.cuda.empty_cache()
    # (a), (b) at MLA_CUT_LAYERS: bf16 runs, then f32 on the same weights
    cut = dataclasses.replace(full, n_layers=MLA_CUT_LAYERS)
    cut32 = dataclasses.replace(cut, dtype=torch.float32)
    p16 = lm_params(torch, cut)
    stape = MOE.RoutingTape()
    with MOE.routing(stape):
        s16 = teacher_forced(torch, cut, p16, seq, False)
    c16 = LM.init_caches(cut, 1, slots, device="cuda")
    fill_caches(torch, c16, 1)
    c32 = tree_map(lambda x: x.float(), c16)
    ltape = MOE.RoutingTape()
    with MOE.routing(ltape):
        l16 = ring_run(torch, cut, p16, c16, tokens, first)
    del c16
    p32 = tree_map(lambda x: x.float(), p16)
    del p16
    torch.cuda.empty_cache()
    dual = decode_vs_prefill(torch, cut32, p32, seq)
    with MOE.routing(stape.replay()):
        s32 = teacher_forced(torch, cut32, p32, seq, False)
    serve_parity, serve_ok = logit_parity(torch, s16, s32, cut.vocab_size)
    with MOE.routing(ltape.replay()):
        l32 = ring_run(torch, cut32, p32, c32, tokens, first)
    long_parity, long_ok = logit_parity(torch, l16, l32, cut.vocab_size)
    flips = {"serve": int(stape.flips), "long": int(ltape.flips)}
    emit("mla_long_500k", **long_report, bf16_vs_f32={
        "layers": cut.n_layers, **long_parity, "ok": long_ok})
    emit("mla_parity", layers=cut.n_layers, absorbed_vs_prefill=dual,
         serve_bf16_vs_f32={**serve_parity, "ok": serve_ok},
         tol={"max_abs": BF16_LOGIT_MAX, "mean_abs": BF16_LOGIT_MEAN},
         router_flips_bf16_vs_f32=flips)
    if not (dual["ok"] and serve_ok and long_ok):
        raise AssertionError("mla parity: the absorbed decode and the "
                             "prefill, or bf16 and f32, disagree")
    del p32, c32, s16, s32, l16, l32
    torch.cuda.empty_cache()
    # (c) the train step and prefill at MLA_CUT_LAYERS
    emit("mla_train", arch=cut.name, **lm_train_prefill(torch, ops, cut))
    torch.cuda.empty_cache()

    # (d) mamba2-1.3b at full width and depth
    cfg = get_config(SSD_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_params(torch, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rs, report = serve_cell(torch, ops, cfg, params, {}, tally)
    emit("ssd_serve", **report, init_s=init_s)
    del rs
    tokens = torch.as_tensor(sample_tokens(1, LONG_STEPS, cfg.vocab_size,
                                           seed=2), device="cuda")
    caches = LM.init_caches(cfg, 1, slots, device="cuda")
    fill_caches(torch, caches, 1)
    early = tree_map(lambda x: x.clone(), caches)
    lk, long_report = long_steps(torch, ops, "ssd_long_500k", cfg, params,
                                 caches, tokens, first)
    le, early_report = long_steps(torch, ops, "ssd_long_early", cfg,
                                  params, early, tokens,
                                  SERVE_PROMPT + 1)
    same = bool(torch.equal(lk, le)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(caches),
                                          tree_leaves(early)))
    emit("ssd_long_500k", arch=cfg.name, layers=cfg.n_layers, batch=1,
         **long_report, state_gb=nbytes(caches) / 1e9,
         bound_ms=(nbytes(caches) + weight_bytes(params))
         / HBM_BYTES_PER_S * 1e3, early=early_report,
         bitwise_equal_to_early=same)
    if not same:
        raise AssertionError("ssd long_500k: the step depends on pos")
    del params, caches, early, lk, le
    torch.cuda.empty_cache()
    dual_cfg = dataclasses.replace(cfg, n_layers=SSD_DUAL_LAYERS,
                                   dtype=torch.float32)
    dseq = torch.as_tensor(sample_tokens(SSD_DUAL_BATCH, SSD_DUAL_SEQ,
                                         cfg.vocab_size, seed=5),
                           device="cuda")
    dual = decode_vs_prefill(torch, dual_cfg, lm_params(torch, dual_cfg),
                             dseq)
    emit("ssd_duality", arch=cfg.name, chunk=cfg.ssm.chunk,
         chunks=-(-SSD_DUAL_SEQ // cfg.ssm.chunk), **dual)
    if not dual["ok"]:
        raise AssertionError("ssd duality: the recurrent decode and the "
                             "chunked prefill disagree")
    torch.cuda.empty_cache()
    emit("ssd_train", arch=cfg.name, **lm_train_prefill(torch, ops, cfg))
    torch.cuda.empty_cache()
    emit("mla_ssm", seconds=time.perf_counter() - t_phase)


def state_bytes(caches, paths) -> dict:
    """Bytes of a cache tree's leaves, split into the RG-LRU states
    ("conv", "h") and the attention caches."""
    from repro_torch.tree import tree_leaves
    out = {"states": 0, "attention": 0}
    for p, x in zip(paths, tree_leaves(caches)):
        key = "states" if p.rsplit("/", 1)[-1] in ("conv", "h") else \
            "attention"
        out[key] += x.numel() * x.element_size()
    return out


def hybrid_phase(torch, ops, tally, lm) -> None:
    """Phase 27: recurrentgemma-9b (RG-LRU + local MQA attention at head
    dim 256) and the int8 KV cache.  (a) served at full width, cut to
    RG_SERVE_LAYERS,
    (`serve_cell`, counted: the kernel in each local-attention layer),
    its routes held against each other and the f32-attention reference
    at full depth (`hybrid_routes`); (b) long_500k at batch 1 over filled
    2048-slot rings and RG-LRU states, LONG_STEPS steps at pos 524 280-
    524 287 (counted), eager and as a graph, against the plain route
    from the same caches the same way; (c) at RG_CUT_LAYERS in f32 the decode against the
    forward across the ring's wrap (`decode_vs_prefill`), and the bf16
    serve's tokens teacher-forced in bf16 against f32 on the same
    weights; (d) the train step and prefill at RG_TRAIN_LAYERS; (e) the
    int8 cache on qwen3-4b (`kv_int8_part`)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import decode_window, make_decode_step
    from repro_torch.models import transformer as LM
    from repro_torch.tree import tree_map, tree_paths
    t_phase = time.perf_counter()
    full = dataclasses.replace(get_config(RG_ARCH), n_layers=RG_SERVE_LAYERS)
    local = attn_layers(full)
    n_steps = SERVE_PROMPT + SERVE_GEN
    zero = {k: 0 for k in ops.KERNELS}

    # (a) the serve at full width, cut in depth
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_params(torch, full)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rs, report = serve_cell(torch, ops, full, params,
                            {"decode_attention": local * n_steps}, tally)
    seq = torch.cat([rs.prompts, rs.tokens], dim=1)
    ops.reset_launches()
    parity, ok = hybrid_routes(torch, ops, full, params, lambda plain:
                               teacher_forced(torch, full, params, seq,
                                              plain))
    if ops.launch_counts()["decode_attention"] != local * n_steps:
        raise AssertionError(f"hybrid parity: {ops.launch_counts()}")
    emit("hybrid_serve", **report, init_s=init_s, attention_layers=local,
         parity=parity)
    if not ok:
        raise AssertionError("hybrid serve: kernel route and plain route "
                             "disagree")
    del rs

    # (b) long_500k: no window override; the local rings and the states
    shape = INPUT_SHAPES["long_500k"]
    if decode_window(full, "long_500k") is not None:
        raise AssertionError("hybrid long_500k: a window override")
    b, first = shape["global_batch"], LONG500_POS - LONG_STEPS + 1
    torch.cuda.reset_peak_memory_stats()
    caches = LM.init_caches(full, b, shape["seq_len"], device="cuda")
    paths = tree_paths(caches)
    fill_caches(torch, caches, 1)
    pristine = tree_map(lambda x: x.clone(), caches)
    tokens = torch.as_tensor(sample_tokens(b, LONG_STEPS, full.vocab_size,
                                           seed=2), device="cuda")
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(LONG_STEPS + 1)]
    lk, seconds, counts = run_phase(
        torch, ops, "hybrid_long_500k",
        lambda: ring_run(torch, full, params, caches, tokens, first,
                         events=events),
        {**zero, "decode_attention": local * LONG_STEPS})
    tally(counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not torch.isfinite(lk).all():
        raise AssertionError("hybrid long_500k: non-finite logits")
    step_ms = events_ms(events)
    step, _ = make_decode_step(full, "long_500k")
    last = torch.tensor(LONG500_POS, dtype=torch.int32, device="cuda")
    graph_ms = time_ms(torch, lambda: step(params, caches, tokens[:, -1:],
                                           last), 1)
    def from_pristine(plain):
        if not plain:
            return lk
        return ring_run(torch, full, params, tree_map(
            lambda x: x.clone(), pristine), tokens, first, plain=True)

    long_parity, long_ok = hybrid_routes(torch, ops, full, params,
                                         from_pristine)
    at_500k = state_bytes(caches, paths)
    at_40 = state_bytes(LM.init_caches(full, b, SERVE_PROMPT + 9,
                                       device="meta"), paths)
    wb = weight_bytes(params)
    emit("hybrid_long_500k", arch=full.name, layers=full.n_layers, batch=b,
         slots=full.local_window, positions=[first, LONG500_POS],
         steps=LONG_STEPS, step_ms=step_ms,
         ms_per_step=sum(step_ms[1:]) / (LONG_STEPS - 1), graph_ms=graph_ms,
         bound_ms=(at_500k["states"] + at_500k["attention"] + wb)
         / HBM_BYTES_PER_S * 1e3, state_bytes=at_500k,
         state_bytes_at_pos_40=at_40, weights_read_gb=wb / 1e9,
         run_seconds=seconds, peak_memory_gb=peak_gb, launches=counts,
         parity_bf16=long_parity)
    if not long_ok or at_500k["states"] != at_40["states"]:
        raise AssertionError("hybrid long_500k: kernel route and plain "
                             "route disagree, or the states grew")
    del caches, pristine, lk, params
    torch.cuda.empty_cache()

    # (c) one super-block: bf16 against f32, and the f32 decode against
    # the forward across the ring's wrap
    cut = dataclasses.replace(full, n_layers=RG_CUT_LAYERS)
    cut32 = dataclasses.replace(cut, dtype=torch.float32)
    p16 = lm_params(torch, cut)
    s16 = teacher_forced(torch, cut, p16, seq, False)
    p32 = tree_map(lambda x: x.float(), p16)
    del p16
    s32 = teacher_forced(torch, cut32, p32, seq, False)
    bf_parity, bf_ok = logit_parity(torch, s16, s32, cut.vocab_size)
    del s16, s32
    wseq = torch.as_tensor(sample_tokens(RG_WRAP_BATCH, RG_WRAP_SEQ,
                                         cut.vocab_size, seed=5),
                           device="cuda")
    dual = decode_vs_prefill(torch, cut32, p32, wseq)
    emit("hybrid_parity", layers=cut.n_layers, slots=cut.local_window,
         decode_vs_forward=dual,
         serve_bf16_vs_f32={**bf_parity, "ok": bf_ok},
         tol={"max_abs": BF16_LOGIT_MAX, "mean_abs": BF16_LOGIT_MEAN})
    if not (dual["ok"] and bf_ok):
        raise AssertionError("hybrid parity: the decode and the forward, "
                             "or bf16 and f32, disagree")
    del p32, wseq
    torch.cuda.empty_cache()

    # (d) the train step and prefill at RG_TRAIN_LAYERS
    emit("hybrid_train", arch=full.name, **lm_train_prefill(
        torch, ops, dataclasses.replace(full, n_layers=RG_TRAIN_LAYERS)))
    torch.cuda.empty_cache()

    # (e) the int8 KV cache on qwen3-4b
    emit("kv_int8", **kv_int8_part(torch, ops, tally, lm))
    torch.cuda.empty_cache()
    emit("hybrid", seconds=time.perf_counter() - t_phase)


def int8_contract(torch, l8, ln, vocab) -> dict:
    """The reference's int8 contract (tests/test_kv_quant.py) of int8
    logits l8 against the native cache's ln: max |diff| under
    KV_INT8_MAX_REL of the largest |logit|, greedy argmax agreement above
    KV_INT8_AGREE."""
    diff = (l8.float() - ln.float()).abs()
    rel = float(diff.max() / (ln.float().abs().max() + 1e-9))
    agree = float((l8[..., :vocab].argmax(-1)
                   == ln[..., :vocab].argmax(-1)).float().mean())
    return {"max_rel": rel, "mean_abs_diff": float(diff.mean()),
            "argmax_agree": agree,
            "ok": rel < KV_INT8_MAX_REL and agree > KV_INT8_AGREE}


def kv_int8_part(torch, ops, tally, lm) -> dict:
    """Phase 27 (e): lm (qwen3-4b) with kv_cache_dtype="int8".  The serve
    of phase 14 (counted), its tokens teacher-forced through the int8 and
    the native caches, held at the reference's bounds (`int8_contract`:
    the reference's own test fills its cache by decoding, as this does),
    ms a step of both steady serves.  Then phase 16's long cache: 8 steps
    at pos 32 760-32 767 against the native caches filled as phase 16
    fills them and against int8 caches quantized from the same fill
    (counted): ms a step of each, the caches' bytes at rest, the
    dequantization of one step (every layer's K and V,
    `attention.dequantize_kv`) timed alone, and the logits at the
    reference's bounds, reported: over 36 bf16 layers of random weights
    and 32 768 random slots any perturbation of the attention moves the
    logits about as far (the kernel and plain routes stand ~0.03 apart
    in mean on such rings, phase 24), and the argmax of a 151 936-way
    random head flips on gaps below it.  The two caches never share the
    card: each leaf of the fill is drawn again from the same generator
    (its first layer checked against the first draw's sum) and quantized
    layer by layer.  The gate at 32 768 positions is the reference's own
    setting, f32 at LM_MESH_B_LAYERS layers (its test runs the 2-layer
    f32 smoke config): the same steps from one filled cache, native and
    quantized, at the reference's bounds."""
    from repro_torch.data import sample_tokens
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import attention as ATT
    from repro_torch.models import transformer as LM
    from repro_torch.tree import tree_leaves, tree_paths
    lm8 = dataclasses.replace(lm, kv_cache_dtype="int8")
    n_steps = SERVE_PROMPT + SERVE_GEN
    zero = {k: 0 for k in ops.KERNELS}
    params = lm_params(torch, lm)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    rs8, seconds, counts = run_phase(
        torch, ops, "int8_serve",
        lambda: serve(lm8, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                      device="cuda", params=params),
        {**zero, "decode_attention": lm.n_layers * n_steps})
    tally(counts)
    steady8 = serve(lm8, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                    device="cuda", params=params)
    steady = serve(lm, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, device="cuda",
                   params=params)
    if not (torch.isfinite(rs8.logits).all()
            and torch.equal(rs8.prompts, steady.prompts)):
        raise AssertionError("int8 serve: non-finite logits or other "
                             "prompts")
    seq = torch.cat([steady.prompts, steady.tokens], dim=1)
    serve_check = int8_contract(
        torch, teacher_forced(torch, lm8, params, seq, False),
        teacher_forced(torch, lm, params, seq, False), lm.vocab_size)
    serve_bytes = {"native": nbytes(LM.init_caches(
        lm, SERVE_BATCH, n_steps, device="meta")), "int8": nbytes(
        LM.init_caches(lm8, SERVE_BATCH, n_steps, device="meta"))}
    # phase 16's long cache: native, int8, then native dequantized
    tokens = torch.as_tensor(sample_tokens(LONG_BATCH, LONG_STEPS,
                                           lm.vocab_size, seed=2),
                             device="cuda")
    positions = torch.arange(LONG_S - LONG_STEPS, LONG_S, dtype=torch.int32,
                             device="cuda")

    def run(cfg, caches):
        step, _ = make_decode_step(cfg, "decode_32k")
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(LONG_STEPS + 1)]
        out = []
        events[0].record()
        for i in range(LONG_STEPS):
            out.append(step(params, caches, tokens[:, i:i + 1],
                            positions[i])[0][:, 0])
            events[i + 1].record()
        out = torch.stack(out)
        torch.cuda.synchronize()
        ms = events_ms(events)
        return out, {"step_ms": ms, "ms_per_step": sum(ms[1:])
                     / (LONG_STEPS - 1)}

    caches = LM.init_caches(lm, LONG_BATCH, LONG_S, device="cuda")
    paths, shapes = tree_paths(caches), [x.shape for x in
                                         tree_leaves(caches)]
    native_bytes = nbytes(caches)
    fill_caches(torch, caches, 1)
    first_sums = [float(x[0].float().sum()) for x in tree_leaves(caches)]
    ln, native_ms = run(lm, caches)
    del caches
    torch.cuda.empty_cache()

    def refill(cfg, store):
        """Caches of cfg holding the fill drawn again (fill_caches'
        draws), each layer passed through `store(dst leaves, name, layer,
        values)`."""
        out = LM.init_caches(cfg, LONG_BATCH, LONG_S, device="cuda")
        gen = torch.Generator("cuda").manual_seed(1)
        for path, shp, want in zip(paths, shapes, first_sums):
            node = out
            *parents, name = path.split("/")
            for key in parents:
                node = node[key]
            leaf = torch.empty(shp, dtype=lm.dtype, device="cuda")
            leaf.normal_(generator=gen)
            if float(leaf[0].float().sum()) != want:
                raise AssertionError(f"int8 long cache: {path} drawn "
                                     f"again differs from the fill")
            for layer in range(shp[0]):
                store(node, name, layer, leaf[layer])
            del leaf
        torch.cuda.empty_cache()
        return out

    def quantized(node, name, layer, x):
        q, sc = ATT.quantize_kv(x)
        node[name][layer].copy_(q)
        node[name + "_scale"][layer].copy_(sc)

    c8 = refill(lm8, quantized)
    int8_bytes = nbytes(c8)
    torch.cuda.reset_peak_memory_stats()
    (l8, int8_ms), seconds8, counts8 = run_phase(
        torch, ops, "int8_long_cache", lambda: run(lm8, c8),
        {**zero, "decode_attention": lm.n_layers * LONG_STEPS})
    tally(counts8)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kv = c8["blocks"]["b0"]
    dequant_ms = lm.n_layers * time_ms(torch, lambda: (
        ATT.dequantize_kv(kv["k"][0], kv["k_scale"][0], lm.dtype),
        ATT.dequantize_kv(kv["v"][0], kv["v_scale"][0], lm.dtype)), 2)
    del c8, kv, params
    torch.cuda.empty_cache()
    long_check = int8_contract(torch, l8, ln, lm.vocab_size)
    # the gate: f32 at LM_MESH_B_LAYERS layers, one fill, native and int8
    lm32 = dataclasses.replace(lm, n_layers=LM_MESH_B_LAYERS,
                               dtype=torch.float32)
    params = lm_params(torch, lm32)
    c32 = LM.init_caches(lm32, LONG_BATCH, LONG_S, device="cuda")
    fill_caches(torch, c32, 1)
    c32q = LM.init_caches(dataclasses.replace(lm32, kv_cache_dtype="int8"),
                          LONG_BATCH, LONG_S, device="cuda")
    for name in ("k", "v"):
        q, sc = ATT.quantize_kv(c32["blocks"]["b0"][name])
        c32q["blocks"]["b0"][name].copy_(q)
        c32q["blocks"]["b0"][name + "_scale"].copy_(sc)
        del q, sc
    f32_check = int8_contract(
        torch, run(dataclasses.replace(lm32, kv_cache_dtype="int8"),
                   c32q)[0], run(lm32, c32)[0], lm.vocab_size)
    del c32, c32q, params
    torch.cuda.empty_cache()
    out = {
        "arch": lm.name, "batch": SERVE_BATCH,
        "serve": {"int8_contract": serve_check, "bytes": serve_bytes,
                  "bytes_ratio": serve_bytes["int8"] / serve_bytes["native"],
                  "eager_ms_per_step": {
                      "int8": steady8.decode_s * 1e3 / SERVE_GEN,
                      "native": steady.decode_s * 1e3 / SERVE_GEN},
                  "run_seconds": seconds, "launches": counts},
        "long_cache": {"batch": LONG_BATCH, "cache_len": LONG_S,
                       "vs_native_reported": long_check,
                       "f32_layers": lm32.n_layers,
                       "f32_int8_contract": f32_check,
                       "bytes": {"native": native_bytes, "int8": int8_bytes},
                       "bytes_ratio": int8_bytes / native_bytes,
                       "int8": int8_ms, "native": native_ms,
                       "dequant_ms_per_step": dequant_ms,
                       "peak_memory_gb": peak_gb, "run_seconds": seconds8,
                       "launches": counts8},
        "tol": {"max_rel": KV_INT8_MAX_REL, "agree": KV_INT8_AGREE}}
    if not (serve_check["ok"] and f32_check["ok"]):
        raise AssertionError(f"int8 cache: outside the reference's bounds "
                             f"(serve {serve_check}, f32 long cache "
                             f"{f32_check})")
    return out


def encdec_run(torch, cfg, params, cross, seq, plain=False):
    """The encoder-decoder's decode steps (`steps.make_decode_step`)
    teacher-forced through seq [B, n] from empty self-attention caches
    against the cross K / V `cross`: logits [n, B, Vp]."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import encdec as ED
    step, _ = make_decode_step(cfg, plain=plain)
    b, n = seq.shape
    caches = ED.init_dec_caches(cfg, b, n, device="cuda")
    positions = torch.arange(n, dtype=torch.int32, device="cuda")
    return torch.stack([step(params, caches, cross, seq[:, i:i + 1],
                             positions[i])[0][:, 0] for i in range(n)])


def encdec_serve(torch, cfg, params, cross, prompts, gen) -> dict:
    """Greedy decoding of the encoder-decoder as `launch.serve.serve`
    decodes a decoder-only model: the prompts [B, P] fed one position at a
    time, then `gen` tokens, each the argmax of the last logits (the
    first the prompt's), against the cross K / V `cross`, the tokens and
    positions on the device: {tokens [B, gen], logits [P + gen, B, Vp],
    prefill_s, decode_s}."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import encdec as ED
    step, _ = make_decode_step(cfg)
    b, p = prompts.shape
    n = p + gen
    caches = ED.init_dec_caches(cfg, b, n, device="cuda")
    positions = torch.arange(n, dtype=torch.int32, device="cuda")
    v, logits_all, out = cfg.vocab_size, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(p):
        logits, _ = step(params, caches, cross, prompts[:, i:i + 1],
                         positions[i])
        logits_all.append(logits[:, 0])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = logits[:, 0, :v].argmax(dim=-1, keepdim=True)
    t0 = time.perf_counter()
    for i in range(p, n):
        out.append(tok)
        logits, _ = step(params, caches, cross, tok, positions[i])
        logits_all.append(logits[:, 0])
        tok = logits[:, 0, :v].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    return {"tokens": torch.cat(out, dim=1), "logits": torch.stack(logits_all),
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0}


def frontends_phase(torch, ops, tally) -> None:
    """Phase 28: the frontends.  (a) llava-next-mistral-7b served at full
    width and depth (`serve_cell`, counted: the kernel in all 32 layers;
    the text tokens alone, as the reference serves it) and its routes
    held against each other at full depth (`zoo_parity`); (b) its
    long_500k on 4096-slot rings (`long500_arch`); (c) at
    FRONT_CUT_LAYERS the train step and prefill at train_4k's layout cut
    in batch (the projected 2880-position prefix and 1216 text tokens);
    (d) seamless-m4t-large-v2 at full width and depth: AUDIO_FRAMES frames
    encoded into the cross K / V (`steps.make_cross_kv_step`), then
    greedy decoding (`encdec_serve`, counted: the kernel twice a decoder
    layer a step, self and cross, by shape), its eager and graph ms a
    step, launches a step, the routes against each other at phase 15's
    bounds, the train step and prefill; (e) its f32 cut at AUDIO_CUT +
    AUDIO_CUT layers, the decode against `decode_full` on the same tokens
    at rtol 1e-4 of the largest |logit|."""
    from repro_torch.configs import get_config
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import (make_cross_kv_step,
                                          make_decode_step, param_count)
    from repro_torch.models import encdec as ED
    t_phase = time.perf_counter()
    zero = {k: 0 for k in ops.KERNELS}
    n_steps = SERVE_PROMPT + SERVE_GEN

    # (a) llava at full width and depth, served
    full = get_config(VLM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_params(torch, full)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rs, report = serve_cell(torch, ops, full, params, {
        "decode_attention": full.n_layers * n_steps}, tally)
    seq = torch.cat([rs.prompts, rs.tokens], dim=1)
    parity = zoo_parity(torch, ops, full, params, seq)
    emit("frontends_vlm_serve", **report, init_s=init_s, parity=parity)
    if not parity["ok"]:
        raise AssertionError("frontends: llava's kernel route and plain "
                             "route disagree")
    del params, rs, seq
    torch.cuda.empty_cache()

    # (b) llava's long_500k: its native 4096-slot rings
    long500_arch(torch, ops, tally, VLM_ARCH)

    # (c) llava at FRONT_CUT_LAYERS: train step and prefill at train_4k's
    # layout, cut in batch
    cut = dataclasses.replace(full, n_layers=FRONT_CUT_LAYERS)
    pfx = full.frontend.n_prefix
    text = FRONT_TRAIN_SEQ - pfx
    train_b = [lm_batch(torch, cut, FRONT_TRAIN_BATCH, text, t, pfx)
               for t in range(2)]
    pre_b = lm_batch(torch, cut, FRONT_TRAIN_BATCH, text, 7, pfx)
    pre_b["tokens"] = pre_b["tokens"][:, :-1]
    emit("frontends_vlm_train", arch=cut.name, full_layers=full.n_layers,
         **lm_train_prefill(torch, ops, cut, (train_b, FRONT_TRAIN_SEQ,
                                              pre_b, FRONT_TRAIN_SEQ)))
    del train_b, pre_b
    torch.cuda.empty_cache()

    # (d) seamless at full width and depth: encode, then greedy decoding
    audio = get_config(AUDIO_ARCH)
    layers = audio.encdec.n_dec_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_params(torch, audio)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = lm_batch(torch, audio, SERVE_BATCH, 0, 3, AUDIO_FRAMES)["frames"]
    encode, _ = make_cross_kv_step(audio)
    cross, encode_s, encode_counts = run_phase(
        torch, ops, "frontends_audio_encode", lambda: encode(params, frames),
        zero)
    prompts = torch.as_tensor(sample_tokens(SERVE_BATCH, SERVE_PROMPT,
                                            audio.vocab_size, seed=0),
                              device="cuda")
    res, seconds, counts = run_phase(
        torch, ops, "frontends_audio_serve",
        lambda: encdec_serve(torch, audio, params, cross, prompts,
                             SERVE_GEN),
        {**zero, "decode_attention": 2 * layers * n_steps})
    tally(counts)
    shapes = ops.launch_shapes()["decode_attention"]
    heads = (audio.n_heads, audio.n_kv_heads, audio.hd)
    want = {(SERVE_BATCH, n_steps) + heads: layers * n_steps,
            (SERVE_BATCH, AUDIO_FRAMES) + heads: layers * n_steps}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if shapes != want or not torch.isfinite(res["logits"]).all():
        raise AssertionError(f"frontends: seamless's decode launched "
                             f"{shapes}, expected {want}, or its logits "
                             f"are not finite")
    steady = encdec_serve(torch, audio, params, cross, prompts, SERVE_GEN)
    if not torch.equal(steady["tokens"], res["tokens"]):
        raise AssertionError("frontends: two seamless decodes differ")
    seq = torch.cat([prompts, res["tokens"]], dim=1)
    step, _ = make_decode_step(audio)
    caches = ED.init_dec_caches(audio, SERVE_BATCH, n_steps, device="cuda")
    last = torch.tensor(n_steps - 1, dtype=torch.int32, device="cuda")
    one = lambda: step(params, caches, cross, seq[:, -1:], last)  # noqa: E731
    graph_ms = time_ms(torch, one, 1)
    prof = profile_phase(torch, one)
    del caches, one
    ops.reset_launches()
    lk = encdec_run(torch, audio, params, cross, seq)
    lp = encdec_run(torch, audio, params, cross, seq, plain=True)
    if ops.launch_counts()["decode_attention"] != 2 * layers * n_steps:
        raise AssertionError(f"frontends parity: {ops.launch_counts()}")
    parity, ok = logit_parity(torch, lk, lp, audio.vocab_size)
    del lk, lp
    wb = weight_bytes(params)
    cross_bytes = sum(x.numel() * x.element_size() for x in cross)
    cache_bytes = 2 * layers * SERVE_BATCH * n_steps * audio.n_kv_heads \
        * audio.hd * 2
    emit("frontends_audio_serve", arch=audio.name, dtype="bfloat16",
         enc_layers=audio.encdec.n_enc_layers, dec_layers=layers,
         params=param_count(audio), weights_gb=(wb + params["embed"].numel()
                                                * 2) / 1e9,
         init_s=init_s, frames=AUDIO_FRAMES, encode_seconds=encode_s,
         encode_launches=encode_counts, cross_kv_gb=cross_bytes / 1e9,
         batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
         run_seconds=seconds, prefill_s=steady["prefill_s"],
         decode_s=steady["decode_s"],
         eager_ms_per_step=steady["decode_s"] * 1e3 / SERVE_GEN,
         graph_ms=graph_ms,
         tok_per_s=SERVE_BATCH * SERVE_GEN / steady["decode_s"],
         graph_tok_per_s=SERVE_BATCH / graph_ms * 1e3,
         launches_per_step=prof["kernel_launches"],
         device_busy_share_eager=prof["device_busy_share"], profile=prof,
         bound_ms=(wb + cross_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
         peak_memory_gb=peak_gb, launches=counts,
         decode_launches_by_kind={
             "self": shapes[(SERVE_BATCH, n_steps) + heads],
             "cross": shapes[(SERVE_BATCH, AUDIO_FRAMES) + heads]},
         parity={**parity, "ok": ok},
         tol={"max_abs": BF16_LOGIT_MAX, "mean_abs": BF16_LOGIT_MEAN},
         sample_tokens=res["tokens"][0, :12].tolist())
    if not ok:
        raise AssertionError("frontends: seamless's kernel route and plain "
                             "route disagree")
    del params, cross, res, steady
    torch.cuda.empty_cache()
    train_b = [lm_batch(torch, audio, SERVE_BATCH, AUDIO_FRAMES, t,
                        AUDIO_FRAMES) for t in range(2)]
    pre_b = lm_batch(torch, audio, SERVE_BATCH, AUDIO_FRAMES, 7,
                     AUDIO_FRAMES)
    pre_b["tokens"] = pre_b["tokens"][:, :-1]
    emit("frontends_audio_train", arch=audio.name, **lm_train_prefill(
        torch, ops, audio, (train_b, AUDIO_FRAMES, pre_b, AUDIO_FRAMES)))
    del train_b, pre_b
    torch.cuda.empty_cache()

    # (e) f32 at AUDIO_CUT + AUDIO_CUT layers: decode against decode_full
    cut = dataclasses.replace(audio, dtype=torch.float32, encdec=(
        dataclasses.replace(audio.encdec, n_enc_layers=AUDIO_CUT,
                            n_dec_layers=AUDIO_CUT)))
    params = lm_params(torch, cut)
    cross = make_cross_kv_step(cut)[0](params, frames)
    ops.reset_launches()
    got = encdec_run(torch, cut, params, cross, seq)
    f32_counts = ops.launch_counts()
    tally(f32_counts)
    with torch.no_grad():
        want = ED.decode_full(params, seq, ED.encode(params, frames, cut),
                              cut).transpose(0, 1)
    atol = RTOL_WHOLE_RUN * float(want.abs().max())
    err = (got - want).abs()
    f32_ok = bool(torch.allclose(got, want, rtol=RTOL_WHOLE_RUN, atol=atol))
    emit("frontends_audio_f32", arch=cut.name, dtype="float32",
         enc_layers=AUDIO_CUT, dec_layers=AUDIO_CUT, batch=SERVE_BATCH,
         steps=n_steps, frames=AUDIO_FRAMES, rtol=RTOL_WHOLE_RUN, atol=atol,
         max_abs_diff=float(err.max()),
         max_excess=float((err - RTOL_WHOLE_RUN * want.abs()).max()),
         logit_max=float(want.abs().max()), launches=f32_counts, ok=f32_ok)
    if not f32_ok:
        raise AssertionError("frontends: seamless's f32 decode and "
                             "decode_full disagree")
    del params, cross, got, want, err, frames
    torch.cuda.empty_cache()
    emit("frontends", seconds=time.perf_counter() - t_phase)


def fsdp_parts(torch, rank: int, world: int) -> None:
    """Phase 29 (b), in the 2-rank child: qwen3-4b at full width cut to
    FSDP_LAYERS layers on the (2, 1) mesh, with the large leaves' storage
    over "data" (FSDP, the steps' default) against the replicated layout
    (fsdp=False), each from the same seed (`steps.init_model`): the
    prefill's logits (PREFILL_BATCH x PREFILL_SEQ) and FSDP_TF
    teacher-forced decode steps of the serve batch (this rank's rows on
    SERVE_PROMPT + SERVE_GEN-slot caches, through the kernel) bitwise
    equal; FSDP_STEPS f32 BEV train steps, the gathered params and the
    stats within FSDP_RTOL; one bf16 FSDP step, every rank's params
    bitwise equal.  Each run's weight bytes a rank, peak and, under
    FSDP, the gathers' and reduce_scatters' ms.  One JSON line a part;
    any miss raises."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import sample_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import gather_params, stored_bytes
    from repro_torch.models import common as C
    from repro_torch.models import transformer as LM
    from repro_torch.tree import tree_leaves
    lm = dataclasses.replace(get_config(LM_ARCH), n_layers=FSDP_LAYERS)
    mesh = make_debug_mesh((world, 1), ("data", "model"))
    label = f"{world} ranks, gloo, one card"
    ms = {"gather": 0.0, "reduce_scatter": 0.0}

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[key] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def weights(cfg, fsdp):
        return ST.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda", mesh=mesh, fsdp=fsdp)

    gather0, scatter0 = C.gather_storage, dist.reduce_scatter
    C.gather_storage = timed(gather0, "gather")
    dist.reduce_scatter = timed(scatter0, "reduce_scatter")
    try:
        pbatch = {"tokens": torch.as_tensor(sample_tokens(
            PREFILL_BATCH, PREFILL_SEQ, lm.vocab_size, seed=7),
            device="cuda")}
        seq = torch.as_tensor(sample_tokens(SERVE_BATCH, FSDP_TF,
                                            lm.vocab_size, seed=3),
                              device="cuda")
        n = SERVE_PROMPT + SERVE_GEN
        positions = torch.arange(n, dtype=torch.int32, device="cuda")
        runs = {}
        for fsdp in (True, False):
            params = weights(lm, fsdp)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in ms:
                ms[k] = 0.0
            pf, _ = ST.make_prefill_step(lm, mesh, fsdp=fsdp)
            t0 = time.perf_counter()
            prefill = pf(params, pbatch)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            step, meta = ST.make_decode_step(lm, mesh=mesh, fsdp=fsdp)
            rows = ST.batch_rows(mesh, SERVE_BATCH)
            caches = LM.init_caches(lm, rows.stop - rows.start, n,
                                    device="cuda")
            ops.reset_launches()
            t0 = time.perf_counter()
            decode = torch.stack([step(params, caches, seq[:, i:i + 1],
                                       positions[i])[0][:, 0]
                                  for i in range(FSDP_TF)])
            torch.cuda.synchronize()
            runs[fsdp] = dict(
                prefill=prefill, decode=decode,
                weight_bytes=stored_bytes(params),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                prefill_ms=prefill_ms,
                decode_ms_per_step=(time.perf_counter() - t0) * 1e3
                / FSDP_TF, gather_ms_prefill_and_decode=ms["gather"],
                launches=ops.launch_counts()["decode_attention"],
                shapes=[[list(k), v] for k, v in ops.launch_shapes()[
                    "decode_attention"].items()])
            del params, caches
            torch.cuda.empty_cache()
        bitwise = (torch.equal(runs[True]["prefill"], runs[False]["prefill"])
                   and torch.equal(runs[True]["decode"],
                                   runs[False]["decode"]))
        launched = all(r["launches"] == FSDP_LAYERS * FSDP_TF
                       for r in runs.values())
        print(json.dumps({
            "phase": "layouts_child", "rank": rank, "part": "serve",
            "arch": lm.name, "layers": FSDP_LAYERS, "mesh": dict(mesh.shape),
            "logits_bitwise_equal": bitwise, "decode_launches_ok": launched,
            **{("fsdp" if k else "replicated"): {
                kk: v for kk, v in r.items() if kk not in ("prefill",
                                                            "decode")}
               for k, r in runs.items()}, "rate_label": label}), flush=True)
        if not (bitwise and launched):
            raise AssertionError(f"layouts (b) serve: bitwise {bitwise}, "
                                 f"launches {[r['launches'] for r in runs.values()]}")
        del runs
        # the f32 train step, both layouts, then one bf16 FSDP step
        lm32 = dataclasses.replace(lm, dtype=torch.float32)
        shape = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     kind="train")
        tokens = [torch.as_tensor(sample_tokens(
            TRAIN_BATCH, TRAIN_SEQ + 1, lm.vocab_size, seed=t),
            device="cuda") for t in range(FSDP_STEPS)]
        trained = {}
        for cfg, fsdp, steps in ((lm32, True, FSDP_STEPS),
                                 (lm32, False, FSDP_STEPS), (lm, True, 1)):
            step, meta = ST.make_train_step(cfg, mesh, shape,
                                            alpha=TRAIN_ALPHA, fsdp=fsdp)
            params = weights(cfg, fsdp)
            weight_bytes = stored_bytes(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in ms:
                ms[k] = 0.0
            state, log = ST.init_floa_state("cuda"), []
            for t in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state,
                                        {"tokens": tokens[t]}, t)
                torch.cuda.synchronize()
                log.append({"ms": (time.perf_counter() - t0) * 1e3,
                            "gather_ms": ms["gather"],
                            "reduce_scatter_ms": ms["reduce_scatter"],
                            **{k: float(v) for k, v in (
                                ("loss", m["loss"]),
                                ("grad_scale", m["grad_scale"]),
                                ("gbar", state["gbar"]),
                                ("eps2", state["eps2"]))}})
                for k in ms:
                    ms[k] = 0.0
            peak = torch.cuda.max_memory_allocated() / 1e9
            full = gather_params(params, meta["params_specs"], mesh,
                                 meta["data_specs"])
            equal = ranks_agree(bit_checksums(torch, tree_leaves(full)))
            del params
            trained[(cfg.dtype, fsdp)] = full, log
            print(json.dumps({
                "phase": "layouts_child", "rank": rank, "part": "train",
                "dtype": str(cfg.dtype)[6:], "fsdp": fsdp,
                "data_sharded_leaves": sum(
                    d is not None for d in tree_leaves(meta["data_specs"])),
                "weight_bytes": weight_bytes, "peak_memory_gb": peak,
                "steps": log, "ranks_bitwise_equal": equal,
                "rate_label": label}), flush=True)
            if not (equal and all(math.isfinite(x["loss"]) for x in log)):
                raise AssertionError(f"layouts (b) train {cfg.dtype} fsdp "
                                     f"{fsdp}: ranks equal {equal}, {log}")
            torch.cuda.empty_cache()
        (a, la), (b, lb) = (trained[(torch.float32, True)],
                            trained[(torch.float32, False)])
        worst = max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                     1e-30)
                    for x, y in zip(tree_leaves(a), tree_leaves(b)))
        ok = all(bool(torch.allclose(x, y, rtol=FSDP_RTOL, atol=1e-6))
                 for x, y in zip(tree_leaves(a), tree_leaves(b)))
        ok = ok and all(abs(x[k] - y[k]) <= 1e-6 + FSDP_RTOL * abs(y[k])
                        for x, y in zip(la, lb)
                        for k in ("loss", "grad_scale", "eps2")) and all(
            abs(x["gbar"] - y["gbar"]) <= FSDP_RTOL * abs(y["gbar"])
            for x, y in zip(la, lb))
        print(json.dumps({
            "phase": "layouts_child", "rank": rank, "part": "f32_parity",
            "rtol": FSDP_RTOL, "params_max_rel_diff": worst, "ok": ok}),
            flush=True)
        if not ok:
            raise AssertionError("layouts (b): the f32 FSDP train step and "
                                 "the replicated one disagree")
    finally:
        C.gather_storage, dist.reduce_scatter = gather0, scatter0


def layouts_phase(torch) -> None:
    """Phase 29 (a), (c) and (d), in this process (the script's (b) runs in
    the rank phases' 2-rank spawn, `fsdp_parts`): for each run of
    `layout_cases`, the dry run's prediction (`launch.dryrun.trace_step`:
    one device, the route of every dry-run record: fake CPU tensors, the
    decode kernel by its op's fake rule) and then the run on the card from the same arguments
    (`dryrun.step_args`, with cfg's random weights), once to warm up and
    once measured: the argument bytes equal, the peak above the memory
    held before the arguments within PEAK_TOL of the prediction.  Then
    --mesh single on this one process raises the ValueError naming its
    256 ranks, and the decode kernel's host time a call is taken through
    its wrapper and through its op (`dispatch_us`)."""
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.mesh import mesh_from_arg
    from repro_torch.launch.steps import make_step
    rows = []
    for name, cfg, shape in layout_cases():
        pred = DRY.trace_step(cfg, "decode_32k", shape, None, route="cuda")
        step, meta = make_step(cfg, None, "decode_32k", shape)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = DRY.step_args(cfg, "decode_32k", shape, None, meta, "cuda",
                             params=lm_params(torch, cfg))
        seed = (0,) if shape["kind"] == "train" else ()
        out = step(*args, *seed)
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(*args, *seed)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        arg = DRY.storage_bytes(args)
        del out, args
        torch.cuda.empty_cache()
        mem = pred["memory"]
        rel = (mem["peak"] - peak) / peak
        rows.append({"run": name, "arch": cfg.name, "shape": shape,
                     "argument_bytes": arg,
                     "predicted_argument_bytes": mem["argument_size"],
                     "peak_bytes": peak, "predicted_peak_bytes": mem["peak"],
                     "peak_rel_diff": rel, "ms": run_ms,
                     "predicted_flops": pred["flops_per_device"],
                     "predicted_bytes_moved": pred["bytes_per_device"],
                     "trace_s": pred["trace_s"]})
        print(f"layouts (a) {name}: peak {peak / 1e9:.3f} GB, predicted "
              f"{mem['peak'] / 1e9:.3f} GB ({100 * rel:+.2f} %); argument "
              f"bytes {arg}, predicted {mem['argument_size']}", flush=True)
    try:
        mesh_from_arg("single")
        single = None
    except ValueError as e:
        single = str(e)
    ok = (all(r["argument_bytes"] == r["predicted_argument_bytes"]
              and abs(r["peak_rel_diff"]) <= PEAK_TOL for r in rows)
          and single is not None and "needs 256 ranks" in single)
    emit("layouts", peak_tol=PEAK_TOL, runs=rows, mesh_single=single,
         dispatch_us=dispatch_us(torch),
         card_total_memory=torch.cuda.get_device_properties(0).total_memory,
         ok=ok)
    if not ok:
        raise AssertionError("layouts: a prediction missed the card, or "
                             "--mesh single did not refuse one process")


def remat_phase(torch, ops) -> None:
    """Phase 30: rematerialization at full width (`cfg.remat`, the full
    configs' default; `models.common.recompute`), every train step counted
    (no kernel of the port runs in one)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.steps import init_floa_state, make_train_step
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_leaves
    lm = get_config(LM_ARCH)
    params = lm_params(torch, lm)

    def timed(step, args, seed=0):
        """One step from args: its outputs, ms and peak above what was
        allocated before it (with the arguments' bytes added, the step's
        peak as the dry run counts it)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = step(*args, seed)
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() - base)

    # (a) phase 20's step, remat against none, after a warm-up step
    shape = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, kind="train")
    steps = {r: make_train_step(dataclasses.replace(lm, remat=r), None,
                                shape, alpha=TRAIN_ALPHA)[0]
             for r in (False, True)}
    state = init_floa_state("cuda")
    args = (params, state, lm_batch(torch, lm, TRAIN_BATCH, TRAIN_SEQ, 0))
    arg_a = DRY.storage_bytes(args)
    runs, first = [], {}

    def run_a():
        timed(steps[True], args)
        for r in (False, True, True, False):
            out, ms, peak = timed(steps[r], args)
            if r not in first:
                first[r] = out
            runs.append({"remat": r, "ms": ms, "peak_bytes": peak + arg_a,
                         "loss": float(out[2]["loss"])})
            same = (all(torch.equal(x, y) for x, y in zip(
                tree_leaves(out[0]), tree_leaves(first[False][0])))
                and all(torch.equal(out[i][k], first[False][i][k])
                        for i in (1, 2) for k in out[i]))
            runs[-1]["bitwise_no_remat"] = same
            del out

    _, seconds_a, counts_a = run_phase(torch, ops, "remat_a", run_a,
                                       step_launches(ops, lm, 5))
    first.clear()
    torch.cuda.empty_cache()
    if not all(r["bitwise_no_remat"] and math.isfinite(r["loss"])
               for r in runs):
        raise AssertionError(f"remat (a): remat differs from none: {runs}")

    # (b) train_4k's sequence, full depth, remat; the dry run's prediction
    big = dict(global_batch=REMAT_BATCH, seq_len=REMAT_SEQ, kind="train")
    pred = DRY.trace_step(lm, "train_4k", big, None)
    pred_plain = DRY.trace_step(dataclasses.replace(lm, remat=False),
                                "train_4k", big, None)
    step, _ = make_train_step(lm, None, big, alpha=TRAIN_ALPHA)
    batch = lm_batch(torch, lm, REMAT_BATCH, REMAT_SEQ, 1)
    arg_bytes = DRY.storage_bytes((params, state, batch))
    log = []

    def run_b():
        for _ in range(2):
            out, ms, peak = timed(step, (params, state, batch))
            log.append({"ms": ms, "peak_bytes": peak + arg_bytes,
                        "loss": float(out[2]["loss"])})
            del out

    _, seconds_b, counts_b = run_phase(torch, ops, "remat_b", run_b,
                                       step_launches(ops, lm, 2))
    peak = log[-1]["peak_bytes"]
    rel = (pred["memory"]["peak"] - peak) / peak
    del params, state, batch, step
    torch.cuda.empty_cache()
    if not (all(math.isfinite(x["loss"]) for x in log)
            and abs(rel) <= PEAK_TOL):
        raise AssertionError(f"remat (b): {log}, predicted peak "
                             f"{pred['memory']['peak']} ({rel:+.3f})")

    # (c) moonshot's expert chunks against one forced chunk
    moe = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    mshape = dict(global_batch=REMAT_MOE_BATCH, seq_len=REMAT_SEQ,
                  kind="train")
    mparams = lm_params(torch, moe)
    mstep, _ = make_train_step(moe, None, mshape, alpha=TRAIN_ALPHA)
    margs = (mparams, init_floa_state("cuda"),
             lm_batch(torch, moe, REMAT_MOE_BATCH, REMAT_SEQ, 2))
    arg_c = DRY.storage_bytes(margs)
    chunk_bytes = MOE.EXPERT_CHUNK_BYTES
    m = moe.moe
    tokens = REMAT_MOE_BATCH * REMAT_SEQ
    per_chunk = MOE.expert_chunk(m.num_experts, tokens, moe.d_model,
                                 m.d_expert, moe.dtype.itemsize)
    mruns = []

    def run_c():
        timed(mstep, margs)
        for one in (False, True, True, False):
            MOE.EXPERT_CHUNK_BYTES = 1 << 62 if one else chunk_bytes
            try:
                out, ms, mpeak = timed(mstep, margs)
            finally:
                MOE.EXPERT_CHUNK_BYTES = chunk_bytes
            mruns.append({"one_chunk": one, "ms": ms,
                          "peak_bytes": mpeak + arg_c,
                          "loss": float(out[2]["loss"])})
            del out

    _, seconds_c, counts_c = run_phase(torch, ops, "remat_c", run_c,
                                       step_launches(ops, moe, 5))
    del mparams, margs, mstep
    torch.cuda.empty_cache()
    peaks = {one: min(r["peak_bytes"] for r in mruns
                      if r["one_chunk"] == one) for one in (False, True)}
    if not (all(math.isfinite(r["loss"]) for r in mruns)
            and peaks[False] < peaks[True]):
        raise AssertionError(f"remat (c): {mruns}")
    emit("remat", a={"arch": lm.name, "layers": lm.n_layers,
                     "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                     "argument_bytes": arg_a, "runs": runs,
                     "seconds": seconds_a, "launches": counts_a},
         b={"arch": lm.name, "layers": lm.n_layers, "batch": REMAT_BATCH,
            "seq": REMAT_SEQ, "steps": log, "seconds": seconds_b,
            "launches": counts_b, "peak_bytes": peak,
            "predicted_peak_bytes": pred["memory"]["peak"],
            "peak_rel_diff": rel, "peak_tol": PEAK_TOL,
            "argument_bytes": arg_bytes,
            "predicted_argument_bytes": pred["memory"]["argument_size"],
            "predicted_flops": pred["flops_per_device"],
            "predicted_no_remat_peak_bytes": pred_plain["memory"]["peak"],
            "predicted_no_remat_flops": pred_plain["flops_per_device"],
            "trace_s": pred["trace_s"] + pred_plain["trace_s"]},
         c={"arch": moe.name, "layers": moe.n_layers,
            "batch": REMAT_MOE_BATCH, "seq": REMAT_SEQ,
            "expert_chunk_bytes": chunk_bytes,
            "experts_a_chunk": per_chunk, "experts": m.num_experts,
            "argument_bytes": arg_c,
            "runs": mruns, "peak_bytes_chunks": peaks[False],
            "peak_bytes_one_chunk": peaks[True], "seconds": seconds_c,
            "launches": counts_c},
         card_total_memory=torch.cuda.get_device_properties(0).total_memory)
    print(f"remat (b): peak {peak / 1e9:.3f} GB, predicted "
          f"{pred['memory']['peak'] / 1e9:.3f} GB ({100 * rel:+.2f} %), "
          f"no remat predicted {pred_plain['memory']['peak'] / 1e9:.2f} GB; "
          f"(c) peak {peaks[False] / 1e9:.2f} GB in chunks of {per_chunk}, "
          f"{peaks[True] / 1e9:.2f} GB in one", flush=True)


def heads_init(torch, cfg, mesh):
    """This rank's shards of cfg's weights (`lm_params`'s draw, seed 0:
    `steps.init_model`, each rank filling only its parts of the leaves
    through `counter_trunc_normal`)."""
    from repro_torch.launch.steps import init_model
    params = init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda",
                        mesh=mesh, fsdp=False)
    torch.cuda.synchronize()
    return params


def gather_to_zero(torch, leaves, split) -> list:
    """Rank 0's whole copy of each leaf, on the host: a leaf split over the
    process group's ranks on dim `split` (None: replicated, rank 0's own)
    gathered as bytes through gloo, leaf by leaf; None a leaf on the other
    ranks."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for x, d in zip(leaves, split):
        x = x.detach().cpu().contiguous()
        if d is None:
            out.append(x if rank == 0 else None)
            continue
        raw = x.reshape(-1).view(torch.uint8)
        parts = ([torch.empty_like(raw) for _ in range(world)] if rank == 0
                 else None)
        dist.gather(raw, parts, dst=0)
        out.append(torch.cat([p.view(x.dtype).reshape(x.shape)
                              for p in parts], dim=d) if rank == 0 else None)
    return out


def heads_parts(torch, rank: int, world: int, out: str, coll) -> None:
    """Phase 31's part of a `--ranks-child` (WORLD = HEADS_RANKS ranks on
    cuda:0, gloo, the mesh (1, WORLD); `coll` the collectives' ms,
    `timed_collectives`): for each HEADS_CASES arch, whose query heads the
    "model" axis does not divide, this rank's shards (`heads_init`),
    HEADS_STEPS BEV train steps on their own seeded draws (ms and
    collectives' ms a step; the update kernel once a leaf), the gradient
    of the
    step's loss, a prefill and the serve, counted (the decode
    kernel at every head on every rank); every rank's replicated leaves
    and gradients, prefill logits and serve bitwise equal.  Then rank 0
    alone, the others at a barrier: the same on one rank from the same
    weights, the trained shards and the gradients gathered to it through
    the host (`gather_to_zero`), at phase 25's gates: every param within
    TP_PARAM_ULPS above TP_PARAM_FLOOR, the losses within BF16_LOGIT_MEAN,
    eps2 within 1e-2, each leaf's gradient within TP_GRAD_REL (|a - b|_2 /
    |b|_2), the prefill logits and the serve's logits (teacher-forced on
    one rank) at phase 15's bf16 bounds.  One JSON line a part: "serve"
    on every rank (its launches by shape), "heads" on rank 0."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import sample_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.sharding import param_specs
    from repro_torch.models import moe as MOE
    from repro_torch.models.attention import head_dims
    from repro_torch.tree import tree_leaves, tree_paths
    mesh = make_debug_mesh((1, world), ("data", "model"))
    label = f"{world} ranks, gloo, one card"

    def emit_part(part, **fields):
        print(json.dumps({"phase": "heads_child", "rank": rank,
                          "part": part, **fields,
                          "t_s": time.perf_counter() - T_START}), flush=True)

    for arch, layers in HEADS_CASES:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        specs = param_specs(cfg, world)
        split, paths = tree_leaves(specs), tree_paths(specs)
        replicated = [i for i, d in enumerate(split) if d is None]
        params = heads_init(torch, cfg, mesh)
        ops.reset_launches()
        _, trained, log, _, _ = tp_train(torch, cfg, mesh, coll,
                                         params=params, steps=HEADS_STEPS)
        train_launches = ops.launch_counts()
        grads = tp_grads(torch, cfg, mesh, MOE.RoutingTape(), params)
        pf, _ = ST.make_prefill_step(cfg, mesh, fsdp=False)
        ptoks = {"tokens": torch.as_tensor(sample_tokens(
            HEADS_PREFILL_BATCH, HEADS_PREFILL_SEQ, cfg.vocab_size, seed=3),
            device="cuda")}
        pf(params, ptoks)                                  # warm-up
        torch.cuda.synchronize()
        tp, cp = time.perf_counter(), coll[0]
        logits = pf(params, ptoks)
        torch.cuda.synchronize()
        prefill_ms, prefill_coll = ((time.perf_counter() - tp) * 1e3,
                                    coll[0] - cp)
        ops.reset_launches()
        cs = coll[0]
        res = serve(cfg, SERVE_BATCH, HEADS_PROMPT, HEADS_GEN, device="cuda",
                    mesh=mesh, params=params, fsdp=False)
        torch.cuda.synchronize()
        serve_coll = coll[0] - cs
        shapes = {k: [[list(sh), n] for sh, n in v.items()]
                  for k, v in ops.launch_shapes().items() if v}
        peak = torch.cuda.max_memory_allocated() / 1e9
        sums = bit_checksums(torch, [x for i, x in enumerate(tree_leaves(
            trained)) if i in replicated] + [grads[i] for i in replicated]
            + [logits, res.tokens.to(torch.int32), res.logits])
        equal = ranks_agree(sums)
        emit_part("serve", arch=cfg.name, launches_by_shape=shapes)
        gathered = gather_to_zero(torch, tree_leaves(trained), split)
        ggathered = gather_to_zero(torch, grads, split)
        del trained, grads, params
        torch.cuda.empty_cache()
        if rank == 0:
            t1 = time.perf_counter()
            whole = lm_params(torch, cfg)
            _, want, wlog, _, _ = tp_train(torch, cfg, None, [0.0],
                                           params=whole, steps=HEADS_STEPS)
            top, outside = 0.0, []
            for path, a, b in zip(paths, gathered, tree_leaves(want)):
                a, b = a.to("cuda").float(), b.float()
                d = (a - b).abs()
                lim = TP_PARAM_ULPS * torch.maximum(a.abs(), b.abs())
                top = max(top, float(d.max()) / max(float(b.abs().max()),
                                                    1e-30))
                if bool((d > lim + TP_PARAM_FLOOR).any()):
                    outside.append(path)
            del want, a, b, d, lim
            gwant = tp_grads(torch, cfg, None, MOE.RoutingTape(), whole)
            grel = {}
            for path, a, b in zip(paths, ggathered, gwant):
                a, b = a.to("cuda").float(), b.float()
                grel[path] = float(torch.linalg.vector_norm(a - b)
                                   / torch.linalg.vector_norm(b).clamp_min(
                                       1e-30))
            del gwant, a, b
            pf1, _ = ST.make_prefill_step(cfg, None, fsdp=False)
            prefill_parity, pok = logit_parity(
                torch, logits[None], pf1(whole, ptoks)[None], cfg.vocab_size)
            seq = torch.cat([res.prompts, res.tokens], dim=1)
            serve_parity, sok = logit_parity(
                torch, res.logits, teacher_forced(torch, cfg, whole, seq,
                                                  False), cfg.vocab_size)
            del whole
            torch.cuda.empty_cache()
            loss_diff = max(abs(x["loss"] - y["loss"])
                            for x, y in zip(log, wlog))
            eps2_rel = max(abs(x["eps2"] - y["eps2"]) / abs(y["eps2"])
                           for x, y in zip(log, wlog))
            q_shape = [SERVE_BATCH, HEADS_PROMPT + HEADS_GEN, cfg.n_heads,
                       cfg.n_kv_heads, cfg.hd]
            want_shapes = {"decode_attention": [[q_shape, attn_layers(cfg)
                                                 * (HEADS_PROMPT
                                                    + HEADS_GEN)]]}
            warm = log[1:]
            ok = (equal and pok and sok and not outside
                  and loss_diff <= BF16_LOGIT_MEAN and eps2_rel <= 1e-2
                  and max(grel.values()) <= TP_GRAD_REL
                  and shapes == want_shapes
                  and train_launches == step_launches(ops, cfg,
                                                      HEADS_STEPS)
                  and all(math.isfinite(x["loss"]) for x in log))
            emit_part("heads", arch=cfg.name, layers=cfg.n_layers,
                      mesh=dict(mesh.shape), head_dims=list(head_dims(
                          cfg, world)), seeded_draws=True,
                      batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=log,
                      one_rank_steps=wlog,
                      ms_per_step_warm=sum(x["ms"] for x in warm) / len(warm),
                      collective_ms_warm=sum(x["collective_ms"]
                                             for x in warm) / len(warm),
                      prefill_batch=HEADS_PREFILL_BATCH,
                      prefill_seq=HEADS_PREFILL_SEQ, prefill_ms=prefill_ms,
                      prefill_collective_ms=prefill_coll,
                      serve_batch=SERVE_BATCH, prompt_len=HEADS_PROMPT,
                      gen=HEADS_GEN, serve_prefill_s=res.prefill_s,
                      serve_decode_s=res.decode_s,
                      serve_ms_per_step=res.decode_s * 1e3 / HEADS_GEN,
                      serve_collective_ms=serve_coll,
                      serve_tok_per_s=res.tok_per_s,
                      launches_by_shape=shapes,
                      train_launches=train_launches, peak_memory_gb=peak,
                      ranks_bitwise_equal=equal,
                      params_max_rel_diff=top, params_outside=outside,
                      param_tol={"rel": TP_PARAM_ULPS,
                                 "floor": TP_PARAM_FLOOR},
                      loss_max_abs_diff=loss_diff,
                      eps2_max_rel_diff=eps2_rel,
                      grads_rel_diff_max=max(grel.values()),
                      grads_tol=TP_GRAD_REL,
                      prefill_vs_one_rank=prefill_parity,
                      serve_vs_one_rank=serve_parity,
                      one_rank_seconds=time.perf_counter() - t1,
                      seconds=time.perf_counter() - t0, rate_label=label,
                      ok=ok)
            if not ok:
                raise AssertionError(f"heads {cfg.name}: the {world}-rank "
                                     f"run and one rank disagree")
        del gathered, ggathered, res, logits
        dist.barrier()


def heads_phase(torch, shard_tally) -> None:
    """Phase 31, in the parent: one spawn of HEADS_RANKS ranks on this card
    over gloo (`--ranks-child ... heads`, `heads_parts`); every rank's
    decode launches by shape go to `shard_tally`, and rank 0 must report
    each HEADS_CASES arch."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="heads_", dir=os.path.join(ROOT, "build"))
    try:
        lines, wall = spawn_ranks("--ranks-child", HEADS_RANKS, work, 600,
                                  ("heads",))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for rank_lines in lines.values():
        for line in rank_lines:
            print(json.dumps(line), flush=True)
            if line["part"] == "serve":
                shard_tally(f"heads_{line['arch']}", {
                    k: {shape_key(sh): n for sh, n in v}
                    for k, v in line["launches_by_shape"].items()})
    reported = [x["arch"] for x in lines[0] if x["part"] == "heads"]
    if reported != [arch for arch, _ in HEADS_CASES]:
        raise AssertionError(f"heads: rank 0 reported {reported}")
    emit("heads", ranks=HEADS_RANKS, backend="gloo", device="cuda:0",
         children_wall_s=wall)


def draws_phase(torch, ops, tally, floor_ms) -> dict:
    """Phase 32: the counter-based stream and its kernels (see DRAWS_*
    above).  Returns the phase-3 rows of `noisy_sgd` and
    `counter_trunc_normal` by name, for the `kernels` line."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import noisy_update as NU
    from repro_torch.kernels import philox as P
    from repro_torch.launch import steps as ST
    from repro_torch.tree import tree_leaves
    from collections import namedtuple
    ax = namedtuple("Ax", "index size")

    # (a) Philox: the known answers, then curand's over random counters
    kat = np.array([[0, 0, 0, 0, 0, 0],
                    [0xffffffff] * 6,
                    [0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344,
                     0xa4093822, 0x299f31d0]], dtype=np.uint32)
    want = np.array([[0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8],
                     [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd],
                     [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]],
                    dtype=np.uint32)
    dev = torch.from_numpy(kat.view(np.int32)).cuda()
    got = {c: NU.philox_raw(dev[:, :4].contiguous(), dev[:, 4:].contiguous(),
                            curand=c).cpu().numpy().view(np.uint32)
           for c in (False, True)}
    kat_ok = all(np.array_equal(g, want) for g in got.values())
    gen = torch.Generator("cuda").manual_seed(5)
    ctr = torch.randint(-2 ** 31, 2 ** 31, (DRAWS_CURAND_N, 4),
                        dtype=torch.int32, device="cuda", generator=gen)
    key = torch.randint(-2 ** 31, 2 ** 31, (DRAWS_CURAND_N, 2),
                        dtype=torch.int32, device="cuda", generator=gen)
    mine = NU.philox_raw(ctr, key)
    curand_equal = torch.equal(mine, NU.philox_raw(ctr, key, curand=True))
    # the plain stream's words at (q, leaf 3, NOISE) under one seed's key
    seed = (11 << 36) + 5
    q = (ctr[:, 0].to(torch.int64) & P.MASK) | (
        (ctr[:, 1].to(torch.int64) & 0xFF) << 32)
    k0, k1 = P.key_of(seed)
    cq = torch.stack([q & P.MASK, q >> 32, torch.full_like(q, 3),
                      torch.zeros_like(q)], 1).to(torch.int32)
    kq = torch.tensor([k0, k1], dtype=torch.int64).to(torch.int32).cuda(
        ).expand(DRAWS_CURAND_N, 2).contiguous()
    plain_equal = torch.equal(
        NU.philox_raw(cq, kq).to(torch.int64) & P.MASK,
        torch.stack(P.bits_at(seed, 3, P.NOISE, q), 1))
    del ctr, key, mine, q, cq, kq
    if not (kat_ok and curand_equal and plain_equal):
        raise AssertionError(f"draws (a): known answers {kat_ok}, curand "
                             f"{curand_equal}, plain {plain_equal}")
    emit("draws_philox", known_answers=kat_ok, curand_counters=DRAWS_CURAND_N,
         curand_bitwise=curand_equal, plain_bitwise=plain_equal)

    # (b) z and the update against the plain version; parts and the whole
    lm = get_config(LM_ARCH)
    emb = (lm.padded_vocab, lm.d_model)
    whole = P.Part.whole(emb)
    draw = P.Draw(seed, 0, whole)
    zeros = torch.zeros(emb, device="cuda")
    one = torch.ones((), device="cuda")
    z = ops.noisy_sgd(zeros, zeros, torch.zeros((), device="cuda"), one,
                      -1.0, draw=draw)
    del zeros
    z_plain = P.normal(draw, "cuda")
    z_err = float((z - z_plain).abs().max())
    z_ok = z_err <= DRAWS_Z_ATOL
    del z_plain
    checks = {}
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator("cuda").manual_seed(6)
        p = (torch.randn(emb, generator=gen, device="cuda") * 0.02).to(dt)
        g = (torch.randn(emb, generator=gen, device="cuda") * 1e-3).to(dt)
        shift = torch.tensor(1e-4, device="cuda").to(dt)
        scale = torch.tensor(1e-2, device="cuda")
        fused = ops.noisy_sgd(p, g, shift, scale, TRAIN_ALPHA, draw=draw)
        given = ops.noisy_sgd(p, g, shift, scale, TRAIN_ALPHA, z=z)
        plain_given = ops.noisy_sgd(p, g, shift, scale, TRAIN_ALPHA, z=z,
                                    chunk=ST.UPDATE_CHUNK, plain=True)
        checks[str(dt)[6:]] = {
            "fused_equals_given": torch.equal(fused, given),
            "given_equals_plain": torch.equal(given, plain_given)}
        del p, g, fused, given, plain_given
    del z
    torch.cuda.empty_cache()
    # parts of a leaf past 2^32 elements at (16, 16), both kernels
    big = P.Part.whole(DRAWS_BIG)
    w = torch.empty(DRAWS_BIG, dtype=torch.bfloat16, device="cuda")
    ops.counter_trunc_normal(w, seed, 9, big, 0.02)
    gw = w * 0.5
    sh = torch.tensor(1e-4, device="cuda").to(torch.bfloat16)
    sc = torch.tensor(1e-2, device="cuda")
    out = ops.noisy_sgd(w, gw, sh, sc, TRAIN_ALPHA, draw=P.Draw(seed, 9, big))
    parts_ok, n_parts = True, 0
    for mi in range(DRAWS_RANKS[0]):
        for ri in range(DRAWS_RANKS[1]):
            part = P.split_part(DRAWS_BIG, ((0, ax(mi, DRAWS_RANKS[0])),
                                            (1, ax(ri, DRAWS_RANKS[1]))))
            sl = part.slices
            piece = ops.counter_trunc_normal(torch.empty(
                part.shape, dtype=torch.bfloat16, device="cuda"), seed, 9,
                part, 0.02)
            upd = ops.noisy_sgd(w[sl].contiguous(), gw[sl].contiguous(), sh,
                                sc, TRAIN_ALPHA, draw=P.Draw(seed, 9, part))
            parts_ok &= torch.equal(piece, w[sl]) and torch.equal(
                upd, out[sl])
            n_parts += 1
    last_j = P.part_indices(part, part.numel - 1, 1, "cpu")
    del w, gw, out, piece, upd
    torch.cuda.empty_cache()
    ok = z_ok and parts_ok and all(all(v.values()) for v in checks.values())
    emit("draws_kernels", shape=list(emb), z_max_abs_err=z_err,
         z_atol=DRAWS_Z_ATOL, update_bitwise=checks, big_leaf=list(DRAWS_BIG),
         big_leaf_elements=math.prod(DRAWS_BIG), ranks=list(DRAWS_RANKS),
         parts=n_parts, last_global_index=int(last_j[0]),
         parts_bitwise_whole=parts_ok, ok=ok)
    if not ok:
        raise AssertionError(f"draws (b): z err {z_err}, updates {checks}, "
                             f"parts {parts_ok}")

    # (c) phase-3 rows: the embedding, a stacked leaf of qwen3-4b and that
    # leaf's part on one of DRAWS_SHORT_RANKS ranks split on its last dim
    # (rows of 64), each with its issue bound beside its bytes bound
    stacked = (lm.n_layers, lm.d_model, lm.n_kv_heads * lm.hd)
    issue = noisy_issue(torch, ops, P, emb, seed)
    emit("draws_issue", sm_clock_mhz=issue["clocks"],
         clock_mhz=issue["clock"], cycles_per_element=issue["cycles"],
         error=issue["error"])
    cases = []
    for label, part, fan_in in (
            ("embedding", P.Part.whole(emb), lm.d_model),
            ("stacked_wk", P.Part.whole(stacked), lm.d_model),
            ("rows_of_64", P.split_part(stacked, (
                (2, ax(0, DRAWS_SHORT_RANKS)),)), lm.d_model)):
        shape = part.shape
        gen = torch.Generator("cuda").manual_seed(8)
        p = ops.counter_trunc_normal(torch.empty(
            shape, dtype=lm.dtype, device="cuda"), seed, 1, part,
            1.0 / math.sqrt(fan_in))
        g = (torch.randn(shape, generator=gen, device="cuda")
             * 1e-3).to(lm.dtype)
        sh = torch.tensor(1e-4, device="cuda").to(lm.dtype)
        sc = torch.tensor(1e-2, device="cuda")
        d = P.Draw(seed, 2, part)
        tol = DRAWS_TOL[str(lm.dtype)[6:]]
        nb, nf = NU.bytes_flops(part, lm.dtype.itemsize, "drawn")
        dims = "x".join(str(n) for n in shape)
        if part.shape != part.full:
            dims += " of " + "x".join(str(n) for n in part.full)
        dt = "bf16" if lm.dtype == torch.bfloat16 else "f32"
        cases.append((
            "noisy_sgd", f"{label} [{dims}] {str(lm.dtype)[6:]} drawn", True,
            (lambda plain, p=p, g=g, sh=sh, sc=sc, d=d: ops.noisy_sgd(
                p, g, sh, sc, TRAIN_ALPHA, draw=d, chunk=ST.UPDATE_CHUNK,
                plain=plain)),
            None, nb, nf, tol, None,
            (lambda n=part.numel, k=f"noisy_sgd_kernel<{dt}, 2>":
             issue_row(issue, k, n))))
        # one output a route, so the kernel's and the plain version's
        # fills are held side by side; torch's own trunc_normal_ (its own
        # stream, the same transform) on a third
        outs = {r: torch.empty(shape, dtype=lm.dtype, device="cuda")
                for r in (False, True, None)}
        tb, tf = NU.trunc_bytes_flops(part, lm.dtype.itemsize)
        cases.append((
            "counter_trunc_normal", f"{label} [{dims}] "
            f"{str(lm.dtype)[6:]}", True,
            (lambda plain, outs=outs, part=part, fan_in=fan_in:
             ops.counter_trunc_normal(outs[plain], seed, 3, part,
                                      1.0 / math.sqrt(fan_in),
                                      plain=plain)),
            (lambda t=outs[None]: torch.nn.init.trunc_normal_(
                t, 0.0, 1.0, -2.0, 2.0)), tb, tf, tol, None,
            (lambda n=part.numel, k=f"counter_trunc_normal_kernel<{dt}>":
             issue_row(issue, k, n))))
        del p, g, outs
    table = check_kernels(torch, cases, floor_ms)

    # (d) phase 20's step on its own seeded draws, from a counted init
    from repro_torch.launch.steps import (init_floa_state, init_model,
                                          make_train_step)
    shape = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, kind="train")
    step, meta = make_train_step(lm, None, shape, alpha=TRAIN_ALPHA)
    batches = [lm_batch(torch, lm, TRAIN_BATCH, TRAIN_SEQ, t)
               for t in range(DRAWS_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = []

    def run():
        params = init_model(lm, torch.Generator("cuda").manual_seed(0),
                            "cuda")
        torch.cuda.synchronize()
        state = init_floa_state("cuda")
        for t in range(DRAWS_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batches[t], t)
            torch.cuda.synchronize()
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "loss": float(m["loss"]),
                        "eps2": float(state["eps2"])})
        return params

    _, seconds, counts = run_phase(
        torch, ops, "draws_train", run,
        step_launches(ops, lm, DRAWS_STEPS, init=True))
    tally(counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = [x["ms"] for x in log[1:]]
    if not all(math.isfinite(x["loss"]) for x in log):
        raise AssertionError(f"draws (d): non-finite loss {log}")
    emit("draws_train", arch=lm.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=log, ms_per_step_warm=sum(warm) / len(warm),
         peak_memory_gb=peak, before=TRAIN_BEFORE, launches=counts,
         leaves=len(tree_leaves(init_model(lm, None, "meta"))),
         run_seconds=seconds)
    return table


def graph_routes(torch, ops, name, run, expect) -> dict:
    """run() graphed and then eagerly (`graphs.disable_graphs()`), each
    counted as a phase (`run_phase`, the launches checked against
    `expect`) from a freed cache: {route: {result, seconds, launches,
    peak_memory_gb (above what was allocated before the route: the
    graphed route's results stay live through the eager one),
    captures, replays, capture_s}}; the two routes' launches by kernel
    and by shape must be equal."""
    import contextlib
    from repro_torch import graphs
    out = {}
    for route in ("graphed", "eager"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        graphs.reset_totals()
        with (contextlib.nullcontext() if route == "graphed"
              else graphs.disable_graphs()):
            result, seconds, counts = run_phase(
                torch, ops, f"graphs_{name}_{route}", run,
                {**{k: 0 for k in ops.KERNELS}, **expect})
        out[route] = {"result": result, "seconds": seconds,
                      "launches": counts, "shapes": ops.launch_shapes(),
                      "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                         - before) / 1e9,
                      "live_before_gb": before / 1e9, **graphs.totals()}
    if out["graphed"]["shapes"] != out["eager"]["shapes"]:
        raise AssertionError(f"graphs {name}: launches by shape differ: "
                             f"{out['graphed']['shapes']} vs "
                             f"{out['eager']['shapes']}")
    if out["graphed"]["captures"] < 1 or out["eager"]["captures"]:
        raise AssertionError(f"graphs {name}: captures {out}")
    return out


def route_fields(routes, extra=None) -> dict:
    """The JSON fields of `graph_routes`' two routes (and `extra`'s)."""
    keys = ("seconds", "launches", "peak_memory_gb", "live_before_gb",
            "captures", "replays", "capture_s")
    return {r: {**{k: v[k] for k in keys}, **(extra or {}).get(r, {})}
            for r, v in routes.items()}


def graphs_phase(torch, np, ops, figures, lm) -> None:
    """Phase 33: each entry point graphed against eager (module
    docstring), one JSON line each."""
    import contextlib
    from repro_torch import graphs
    from repro_torch.core.power_control import Policy
    from repro_torch.data import sample_tokens
    from repro_torch.launch import train as TR
    from repro_torch.launch.serve import compile_decode, serve
    from repro_torch.launch.steps import (init_floa_state, make_decode_step,
                                          make_train_step)
    from repro_torch.models import transformer as LM
    from repro_torch.tree import tree_leaves

    def on(route):
        return (contextlib.nullcontext() if route == "graphed"
                else graphs.disable_graphs())

    # (a), (b): sweeps through their engines; the lanes' generators kept
    fig3 = [figures.Experiment(f"{n}@ah{ah}", p, n_attackers=1,
                               alpha_hat=ah, attacker_sigma=3.0,
                               rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    fused = {"floa_step_batched": ROUNDS, "grad_stats": ROUNDS}
    sweeps = {
        "fig3": (lambda: figures.figure_engine(fig3, device="cuda"),
                 fused),
        "defenses": (lambda: figures.cases_engine(
            figures.defense_cases(), ROUNDS, device="cuda"),
            {**fused, "sort_columns": 2 * ROUNDS})}
    for name, (build, expect) in sweeps.items():
        def run(build=build):
            engine, params, batches = build()
            made = []
            seeded = engine.seeded_draws
            engine.seeded_draws = lambda d: made.append(seeded(d)) or made[0]
            res = engine.run(params, batches)
            return res, made[0].state()
        routes = graph_routes(torch, ops, name, run, expect)
        (rg, sg), (re_, se) = (routes["graphed"]["result"],
                               routes["eager"]["result"])
        equal = {"loss": bool(np.array_equal(rg.loss, re_.loss)),
                 "grad_norm": bool(np.array_equal(rg.grad_norm,
                                                  re_.grad_norm)),
                 "params": all(torch.equal(rg.params[k], re_.params[k])
                               for k in re_.params),
                 "metrics": all(np.array_equal(rg.metrics[k],
                                               re_.metrics[k], equal_nan=True)
                                for k in re_.metrics),
                 "generators": all(torch.equal(sg[k], se[k]) for k in se)}
        rates, profiles = {}, {}
        for route in ("graphed", "eager"):
            with on(route):
                engine, params, batches = build()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.run(params, batches)
                torch.cuda.synchronize()
                rates[route] = {"rounds_per_s": ROUNDS / (
                    time.perf_counter() - t0)}
                prof = profile_phase(torch, lambda: engine.run(params,
                                                               batches))
                rates[route]["profile"] = {
                    "kernels_per_round": prof["kernel_launches"] / ROUNDS,
                    "device_busy_share": prof["device_busy_share"],
                    "device_busy_ms": prof["device_busy_ms"],
                    "wall_ms": prof["wall_ms"]}
        emit("graphs", case=name, lanes=len(rg.names), rounds=ROUNDS,
             bitwise=equal, **route_fields(routes, rates))
        if not all(equal.values()):
            raise AssertionError(f"graphs {name}: graphed and eager differ "
                                 f"{equal}")
        del routes, rg, re_

    # (c) the serve: qwen3-4b, batch 8, 32 + 32, from one init
    params = lm_params(torch, lm)
    n_steps = SERVE_PROMPT + SERVE_GEN
    routes = graph_routes(
        torch, ops, "serve",
        lambda: serve(lm, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                      device="cuda", params=params),
        {"decode_attention": lm.n_layers * n_steps})
    rg, re_ = routes["graphed"]["result"], routes["eager"]["result"]
    equal = {"tokens": torch.equal(rg.tokens, re_.tokens),
             "logits": torch.equal(rg.logits, re_.logits)}
    rates = {}
    caches = LM.init_caches(lm, SERVE_BATCH, n_steps, device="cuda")
    positions = torch.arange(n_steps, dtype=torch.int32, device="cuda")
    tok = rg.tokens[:, :1]
    step, _ = make_decode_step(lm)
    for route in ("graphed", "eager"):
        res = routes[route]["result"]   # its decode phase: warm, replays
        with on(route):
            one = compile_decode(step)
            for i in range(2):    # the warm-up and the capture
                one(params, caches, tok, positions[i])
            prof = profile_phase(torch, lambda: one(params, caches, tok,
                                                    positions[2]))
        rates[route] = {
            "decode_tok_per_s": res.tok_per_s,
            "ms_per_step": res.decode_s * 1e3 / SERVE_GEN,
            "prefill_s": res.prefill_s,
            "profile_step": {"kernels": prof["kernel_launches"],
                             "device_busy_share": prof["device_busy_share"],
                             "device_busy_ms": prof["device_busy_ms"],
                             "wall_ms": prof["wall_ms"]}}
    emit("graphs", case="serve", arch=lm.name, batch=SERVE_BATCH,
         prompt_len=SERVE_PROMPT, gen=SERVE_GEN, bitwise=equal,
         **route_fields(routes, rates))
    if not all(equal.values()):
        raise AssertionError(f"graphs serve: graphed and eager differ "
                             f"{equal}")
    del routes, rg, re_, caches, step, one

    # (d) the train step, 8 x 64, 3 steps, the seed a device counter
    shape = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, kind="train")
    train, _ = make_train_step(lm, None, shape, alpha=TRAIN_ALPHA)
    steps = 3
    tokens = [torch.as_tensor(sample_tokens(TRAIN_BATCH, TRAIN_SEQ + 1,
                                            lm.vocab_size, seed=t),
                              device="cuda") for t in range(steps)]
    held = {}

    def train_run():
        graphed = graphs.graphs_enabled()
        p = _clone_tree(torch, params) if graphed else params
        step = TR.compile_step(train) if graphed else train
        state, seed, log = init_floa_state("cuda"), torch.zeros(
            (), dtype=torch.int64, device="cuda"), []
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, m = step(p, state, {"tokens": tokens[t]}, seed)
            seed += 1
            log.append({"ms": None, "loss": float(m["loss"])})
            torch.cuda.synchronize()
            log[-1]["ms"] = (time.perf_counter() - t0) * 1e3
        if graphed:
            held.update(step=step, state=state)
        return p, state, log

    routes = graph_routes(torch, ops, "train", train_run,
                          step_launches(ops, lm, steps))
    (pg, sg, lg), (pe, se, le) = (routes["graphed"]["result"],
                                  routes["eager"]["result"])
    equal = {"losses": [x["loss"] for x in lg] == [x["loss"] for x in le],
             "params": all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(pg), tree_leaves(pe))),
             "state": all(torch.equal(sg[k], se[k]) for k in se)}
    del pe, se
    # one state, replayed under two device seeds: two noises
    snap = _clone_tree(torch, pg)
    small = min(range(len(tree_leaves(pg))),
                key=lambda i: tree_leaves(pg)[i].numel())
    noises = []
    for s in (100, 101):
        for dst, src in zip(tree_leaves(pg), tree_leaves(snap)):
            dst.copy_(src)
        held["step"](pg, held["state"], {"tokens": tokens[0]},
                     torch.full((), s, dtype=torch.int64, device="cuda"))
        noises.append(tree_leaves(pg)[small].clone())
    equal["two_seeds_differ"] = not torch.equal(*noises)
    del snap
    rates = {}
    batch = {"tokens": tokens[0]}
    for route in ("graphed", "eager"):
        log = routes[route]["result"][2]
        with on(route):
            if route == "graphed":
                st, seed = held["state"], torch.zeros(
                    (), dtype=torch.int64, device="cuda")
                fn = lambda: held["step"](pg, st, batch, seed)  # noqa: E731
            else:
                st = init_floa_state("cuda")
                fn = lambda: train(params, st, batch, 0)  # noqa: E731
            prof = profile_phase(torch, fn)
        rates[route] = {"steps": log, "ms_per_step_warm":
                        sum(x["ms"] for x in log[2:]) / len(log[2:]),
                        "profile_step": {
                            "kernels": prof["kernel_launches"],
                            "device_busy_share": prof["device_busy_share"],
                            "device_busy_ms": prof["device_busy_ms"],
                            "wall_ms": prof["wall_ms"]}}
    emit("graphs", case="train", arch=lm.name, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=steps, bitwise=equal,
         **route_fields(routes, rates))
    if not all(equal.values()):
        raise AssertionError(f"graphs train: graphed and eager differ "
                             f"{equal}")
    del routes, pg, sg, held, params
    torch.cuda.empty_cache()


def _clone_tree(torch, tree):
    """A nested dict of tensors, every leaf cloned."""
    return {k: _clone_tree(torch, v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def noisy_issue(torch, ops, P, emb, seed) -> dict:
    """The issue-rate bounds of csrc/noisy_update.cu as built (the SASS of
    each kernel instance's hot loop, `tools/sass_mix.py`: SM clocks an
    element) and the SM clock `nvidia-smi -q -d CLOCK` reads while the
    bf16 update runs at `emb` (MHz); "error" where either fails."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sass_mix as SM
    from repro_torch.kernels import _build
    out = {"cycles": {}, "clocks": [], "clock": None, "error": None}
    try:
        text = SM.sass_of(str(_build._target("noisy_update")))
        for name, entry in SM.kernel_mixes(text, SM.NOISY_PATTERN,
                                           SM.noisy_name).items():
            hot = SM.summary(entry, SM.noisy_esize(name)).get("hot")
            if hot:
                out["cycles"][name] = {
                    "cycles_per_element": hot["cycles_per_element"],
                    "bound_by": hot["bound_by"],
                    "instructions_per_element": hot["per_element"]["issue"]}
        p = torch.zeros(emb, dtype=torch.bfloat16, device="cuda")
        one = torch.ones((), device="cuda")
        sh = torch.zeros((), dtype=torch.bfloat16, device="cuda")
        draw = P.Draw(seed, 0, P.Part.whole(emb))
        out["clocks"] = SM.sm_clock_under_load(
            lambda: ops.noisy_sgd(p, p, sh, one, TRAIN_ALPHA, draw=draw),
            torch.cuda.synchronize)
        out["clock"] = SM.median(out["clocks"])
        del p
    except Exception as e:   # the rows keep their bytes bound
        out["error"] = repr(e)
    return out


def issue_row(issue, kernel, numel) -> dict:
    """A phase-32 row's issue bound: `numel` elements at the instance's
    SM clocks an element, over the card's SMs at the measured clock."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sass_mix as SM
    import torch
    c = issue["cycles"].get(kernel)
    if c is None or not issue["clock"]:
        return {"issue_bound_ms": None, "issue_error": issue["error"]}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"issue_bound_ms": SM.issue_bound_ms(
        c["cycles_per_element"], numel, sms, issue["clock"]),
        "issue_bound_by": c["bound_by"], "sm_clock_mhz": issue["clock"],
        "instructions_per_element": c["instructions_per_element"]}


def dispatch_us(torch) -> dict:
    """Host microseconds a call of the decode kernel at the serve's shape
    ([SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, H, KV, dh] of LM_ARCH, bf16,
    pos a device tensor as in the decode step): 1000 eager calls with one
    synchronisation (`call_ms`; the kernel's few microseconds hide behind
    the host's launch), through the wrapper the main path calls and
    through the custom op the dry run traces, in the order wrapper, op,
    op, wrapper."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    lm = get_config(LM_ARCH)
    g = torch.Generator(device="cuda").manual_seed(0)
    s = SERVE_PROMPT + SERVE_GEN
    q = torch.randn(SERVE_BATCH, lm.n_heads, lm.hd, generator=g,
                    device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(SERVE_BATCH, s, lm.n_kv_heads, lm.hd, generator=g,
                        device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    pos = torch.tensor(s - 1, dtype=torch.int32, device="cuda")
    routes = {"wrapper": lambda: DA.decode_attention(q, k, v, pos),
              "op": lambda: DA.card_route(q, k, v, pos)}
    got = {"wrapper": [], "op": []}
    for name in ("wrapper", "op", "op", "wrapper"):
        got[name].append(call_ms(torch, routes[name], iters=1000) * 1e3)
    return {"shape": [SERVE_BATCH, s, lm.n_heads, lm.n_kv_heads, lm.hd],
            **got, "op_minus_wrapper_us": sum(got["op"]) / 2
            - sum(got["wrapper"]) / 2}


def layout_cases() -> list:
    """Phase 29 (a)'s runs: (name, config, input shape) of phase 20's
    qwen3-4b train step and prefill, the serve's decode step (batch 8,
    SERVE_PROMPT + SERVE_GEN-slot caches, at its last position) and phase
    28 (d)'s seamless-m4t-large-v2 train step."""
    from repro_torch.configs import get_config
    lm, audio = get_config(LM_ARCH), get_config(AUDIO_ARCH)
    return [("train", lm, dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               kind="train")),
            ("prefill", lm, dict(global_batch=PREFILL_BATCH,
                                 seq_len=PREFILL_SEQ, kind="prefill")),
            ("decode", lm, dict(global_batch=SERVE_BATCH,
                                seq_len=SERVE_PROMPT + SERVE_GEN,
                                kind="decode")),
            ("seamless_train", audio, dict(global_batch=SERVE_BATCH,
                                           seq_len=AUDIO_FRAMES,
                                           kind="train"))]


def decode_shapes(lm) -> dict:
    """decode_attention's main-path launches by (B, S, H, KV, dh): the
    serve (phase 14) and long-cache (16) runs of lm, the zoo's serves
    (23) and long_500k's bf16 runs and f32 wrap runs (24), the hybrid's
    serve and long_500k run (27 (a), (b)), lm's int8 serve and long
    cache (27 (e)), and the frontends' (28): llava's serve and long_500k
    run, seamless's self- and cross-attention in its bf16 serve and its
    f32 cut (`frontends_phase`)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.steps import decode_window
    n_steps = SERVE_PROMPT + SERVE_GEN
    out = {}

    def add(cfg, b, s, n):
        key = (b, s, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        out[key] = out.get(key, 0) + n

    add(lm, SERVE_BATCH, n_steps, lm.n_layers * n_steps)
    add(lm, LONG_BATCH, LONG_S, lm.n_layers * LONG_STEPS)
    for arch, depth in ZOO:
        cfg = get_config(arch)
        add(cfg, SERVE_BATCH, n_steps, (depth or cfg.n_layers) * n_steps)
    long500 = INPUT_SHAPES["long_500k"]
    for arch in LONG500_ARCHS:
        cfg = get_config(arch)
        slots = min(long500["seq_len"], decode_window(cfg, "long_500k"))
        add(cfg, long500["global_batch"], slots,
            (cfg.n_layers + 2) * LONG_STEPS)
    rg = dataclasses.replace(get_config(RG_ARCH), n_layers=RG_SERVE_LAYERS)
    add(rg, SERVE_BATCH, n_steps, attn_layers(rg) * n_steps)
    add(rg, long500["global_batch"], rg.local_window,
        attn_layers(rg) * LONG_STEPS)
    add(lm, SERVE_BATCH, n_steps, lm.n_layers * n_steps)
    add(lm, LONG_BATCH, LONG_S, lm.n_layers * LONG_STEPS)
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    add(vlm, SERVE_BATCH, n_steps, vlm.n_layers * n_steps)
    add(vlm, long500["global_batch"], decode_window(vlm, "long_500k"),
        (vlm.n_layers + 2) * LONG_STEPS)
    for s in (n_steps, AUDIO_FRAMES):   # self- and cross-attention
        add(audio, SERVE_BATCH, s,
            (audio.encdec.n_dec_layers + AUDIO_CUT) * n_steps)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--resume-child"]:
        return resume_child(sys.argv[2:])
    if sys.argv[1:2] == ["--ranks-child"]:
        return ranks_child(sys.argv[2:])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import figures
    from repro_torch.core.attacks import AttackType
    from repro_torch.core.power_control import Policy
    from repro_torch.kernels import _build, ops

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    phase_seconds("1 device")

    # 2. build
    build = _build.build_all()
    emit("build", **build)
    # decode_mma_kernel's ring is dynamic shared memory, which ptxas does
    # not report: NSTAGE = 3 stages of K and V, TK = 64 keys x dh in bf16
    # (csrc/decode_attention.cu::mma_smem_bytes)
    emit("build_redesigned", dynamic_smem_bytes={
        f"decode_mma_kernel<{dh}>": 3 * 2 * 64 * dh * 2
        for dh in (32, 64, 128, 256)}, **redesigned_ptxas(build["ptxas"]))
    phase_seconds("2 build")

    if sys.argv[1:] == ["--strict-rates"]:
        emit("strict_rates", src=os.path.join(ROOT, "src"),
             routes=strict_rates(torch, figures))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if sys.argv[1:] == ["--serve-rate"]:   # 1-2, then phase 14's rate
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import serve
        lm = get_config(LM_ARCH)
        params = lm_params(torch, lm)
        ms = [serve(lm, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, device="cuda",
                    params=params).decode_s * 1e3 / SERVE_GEN
              for _ in range(SERVE_RATE_RUNS + 1)][1:]
        emit("serve_rate", src=os.path.join(ROOT, "src"), arch=lm.name,
             batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
             eager_ms_per_step=ms, median_ms=sorted(ms)[len(ms) // 2])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if sys.argv[1:] == ["--remat"]:   # phases 1-2 and 30 alone
        remat_phase(torch, ops)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if sys.argv[1:] == ["--heads"]:   # phases 1-2 and 31 alone
        heads_phase(torch, lambda case, by_shape: None)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if sys.argv[1:] == ["--draws"]:   # phases 1-2 and 32 alone
        floor_ms = time_ms(torch, lambda: torch.empty(
            1, device="cuda").zero_())
        emit("launch_floor", floor_ms=floor_ms)
        draws_phase(torch, ops, lambda counts: None, floor_ms)
        phase_seconds("32 draws")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if sys.argv[1:] == ["--graphs"]:   # phases 1-2 and 33 alone
        from repro_torch.configs import get_config
        graphs_phase(torch, np, ops, figures, get_config(LM_ARCH))
        phase_seconds("33 graphs")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if sys.argv[1:] == ["--mla-ssm"]:   # phases 1-2 and 26 alone
        mla_ssm_phase(torch, ops, lambda counts: None)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. kernels against their plain versions, beside the launch floor: the
    # graph-replayed time of one near-empty kernel
    floor_ms = time_ms(torch, lambda: torch.empty(1, device="cuda").zero_())
    emit("launch_floor", floor_ms=floor_ms)
    if sys.argv[1:] == ["--zoo"]:   # 1-2, 3's decode rows, 23-24 alone
        check_kernels(torch, decode_cases(torch, ops), floor_ms)
        zoo_phase(torch, ops, lambda counts: None)
        long500_phase(torch, ops, lambda counts: None)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--frontends"]:   # 1-2, 3's decode rows, 28 alone
        check_kernels(torch, decode_cases(torch, ops), floor_ms)
        frontends_phase(torch, ops, lambda counts: None)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--layouts"]:   # 1-2, 3's decode rows, 29 alone
        import shutil
        import tempfile
        check_kernels(torch, decode_cases(torch, ops), floor_ms)
        layouts_phase(torch)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        work = tempfile.mkdtemp(prefix="ranks_", dir=os.path.join(ROOT,
                                                                  "build"))
        try:
            lines, wall = spawn_ranks("--ranks-child", 2, work, 600,
                                      ("layouts",))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for rank_lines in lines.values():
            for line in rank_lines:
                print(json.dumps(line), flush=True)
        emit("ranks", children_wall_s={2: wall})
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--hybrid"]:   # 1-2, 3's decode rows, 27 alone
        from repro_torch.configs import get_config
        check_kernels(torch, decode_cases(torch, ops), floor_ms)
        hybrid_phase(torch, ops, lambda counts: None, get_config(LM_ARCH))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--ranks"]:   # 1-2, 3's decode rows, 21, 22, 25
        from repro_torch.configs import get_config
        check_kernels(torch, decode_cases(torch, ops), floor_ms)
        rank_phases(torch, np, ops, figures, lambda counts: None,
                    lambda case, by_shape: None, get_config(LM_ARCH), None)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    table = check_kernels(torch, kernel_cases(torch, ops), floor_ms)
    emit("large_u_sort_route", **large_u_sort_check(torch, ops))
    phase_seconds("3 kernels")

    # 5's, 8's and 9's sweeps, profiled alone: `chip_smoke.py --profile`
    fig3 = [figures.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                               attacker_sigma=3.0, rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    from repro_torch.configs import PAPER_MLP
    mc_u = dataclasses.replace(PAPER_MLP.full(), num_workers=1000,
                               train_samples=32000)
    grid_u = figures.worker_grid(1000, mc_u.dim)
    from repro_torch.configs import get_config
    lm = get_config(LM_ARCH)
    if sys.argv[1:] == ["--profile"]:
        for sweep, rounds, build in [
                ("fig3", ROUNDS, lambda: figures.figure_engine(
                    fig3, device="cuda")),
                ("defenses", ROUNDS, lambda: figures.cases_engine(
                    figures.defense_cases(), ROUNDS, device="cuda")),
                ("worker_grid_u1000", ROUNDS_LARGE_U,
                 lambda: figures.cases_engine(grid_u, ROUNDS_LARGE_U,
                                              mc=mc_u, device="cuda")),
                ("showdown", ROUNDS, lambda: figures.showdown_engine(
                    ROUNDS, device="cuda")),
                ("lm_lane", ROUNDS, lambda: figures.lm_lane_engine(
                    ROUNDS, device="cuda"))]:
            prof = profile_phase(torch, engine_run(build))
            emit("profile", sweep=sweep, rounds=rounds,
                 launches_per_round=prof["kernel_launches"] / rounds, **prof)
        # the looped trainer on Fig. 3's BEV lane (phase 11's "loop" route)
        tr, params_t, sampler_t = figures.experiment_trainer(
            fig3[1], device="cuda")
        prof = profile_phase(torch, lambda: tr.run(
            params_t, sampler_t, ROUNDS, fig3[1].seed, eval_every=10))
        emit("profile", sweep="trainer_loop", rounds=ROUNDS,
             launches_per_round=prof["kernel_launches"] / ROUNDS, **prof)
        # one warm decode step of the serve phase: qwen3-4b, batch 8, the
        # 41st position of a 64-position cache
        from repro_torch.launch.steps import make_decode_step
        from repro_torch.models import transformer as LM
        params = lm_params(torch, lm)
        caches = LM.init_caches(lm, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN,
                                device="cuda")
        positions = torch.arange(SERVE_PROMPT + SERVE_GEN,
                                 dtype=torch.int32, device="cuda")
        step, _ = make_decode_step(lm)
        tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.long, device="cuda")
        for i in range(40):
            step(params, caches, tok, positions[i])
        emit("profile", sweep="serve_decode_step", rounds=1,
             **profile_phase(torch, lambda: step(params, caches, tok,
                                                 positions[40])))
        del caches
        # one warm FLOA train step of phase 20 on the same weights
        from repro_torch.data import sample_tokens
        from repro_torch.launch.steps import init_floa_state, make_train_step
        train, _ = make_train_step(lm, None, dict(
            global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, kind="train"),
            alpha=TRAIN_ALPHA)
        state = init_floa_state("cuda")
        batch = {"tokens": torch.as_tensor(sample_tokens(
            TRAIN_BATCH, TRAIN_SEQ + 1, lm.vocab_size, seed=0),
            device="cuda")}
        emit("profile", sweep="train_step", rounds=1,
             **profile_phase(torch, lambda: train(params, state, batch, 0)))
        del params, state, batch, train
        torch.cuda.empty_cache()
        # one warm decode step of the zoo phase's moonshot (48 MoE layers,
        # full width), batch 8, the 41st position of a 64-position cache
        moe = get_config(MOE_TRAIN_ARCH)
        params = lm_params(torch, moe)
        caches = LM.init_caches(moe, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN,
                                device="cuda")
        step, _ = make_decode_step(moe)
        for i in range(40):
            step(params, caches, tok, positions[i])
        emit("profile", sweep="serve_decode_step_moe", arch=moe.name,
             rounds=1, **profile_phase(torch, lambda: step(
                 params, caches, tok, positions[40])))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 4. main path, benign: Fig. 1's lanes at full width
    fig1 = [figures.Experiment(n, p, alpha_hat=0.1, rounds=ROUNDS)
            for n, p in [("EF", Policy.EF), ("CI", Policy.CI),
                         ("BEV", Policy.BEV)]]
    main_launches = {k: 0 for k in ops.KERNELS}
    main_shapes = {k: {} for k in ops.launch_shapes()}

    def tally(counts):
        """Add a main-path phase's launches (and by shape) to the totals."""
        for k, v in counts.items():
            main_launches[k] += v
        for k, by_shape in ops.launch_shapes().items():
            for shape, n in by_shape.items():
                main_shapes[k][shape] = main_shapes[k].get(shape, 0) + n

    shard_shapes = {k: {} for k in ops.launch_shapes()}

    def shard_tally(case, by_shape):
        """Add one rank's launches of a sharded run (the mesh phase's
        children) to the totals, by shard-local shape and case."""
        for k, shapes in by_shape.items():
            for shape, n in shapes.items():
                main_launches[k] += n
                key = (case, shape)
                shard_shapes[k][key] = shard_shapes[k].get(key, 0) + n

    def drive(name, exps, expect, run=None, engine=None, rounds=ROUNDS):
        """One main-path phase through its entry point (counted; default
        run_figure), then the steady-state round rate of the same sweep
        (uncounted: one warm-up run, one timed run of the built engine).
        `expect` lists every kernel's launches (unlisted: 0)."""
        result, seconds, counts = run_phase(
            torch, ops, name,
            run or (lambda: figures.run_figure(exps, device="cuda")),
            {**{k: 0 for k in ops.KERNELS}, **expect})
        tally(counts)
        if not np.isfinite(result.loss).all():
            raise AssertionError(f"{name}: non-finite loss")
        engine, params, batches = (engine or (lambda: figures.figure_engine(
            exps, device="cuda")))()
        engine.run(params, batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(params, batches)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        emit(name, lanes=lanes_report(result), lanes_n=len(result.names),
             rounds=rounds, run_seconds=seconds,
             steady_run_seconds=steady, rounds_per_s=rounds / steady,
             launches=counts)
        return result

    fused = {"floa_step_batched": ROUNDS, "grad_stats": ROUNDS}
    r1 = drive("main_benign", fig1, fused)
    if not (r1.loss[:, -1] < r1.loss[:, 0]).all():
        raise AssertionError(
            f"benign loss did not fall: {r1.loss[:, [0, -1]]}")
    phase_seconds("4 main_benign")

    # 5. main path, Byzantine: Fig. 3's lanes (one strong attacker, sigma 3)
    drive("main_byzantine", fig3, fused)
    phase_seconds("5 main_byzantine")

    # 6. combine route: a GAUSSIAN-jamming lane beside a STRONGEST lane
    jam = [figures.Experiment("BEV-gauss", Policy.BEV, n_attackers=1,
                              attack=AttackType.GAUSSIAN, rounds=ROUNDS),
           figures.Experiment("BEV-strong", Policy.BEV, n_attackers=1,
                              rounds=ROUNDS)]
    drive("main_combine_route", jam, {"floa_aggregate_batched": ROUNDS,
                                      "grad_stats": ROUNDS})
    phase_seconds("6 main_combine_route")

    # 7. whole run: kernel route vs plain route from the same draws
    ops.reset_launches()
    rk = figures.run_figure(fig1, device="cuda")
    rp = figures.run_figure(fig1, device="cuda", force_plain=True)
    if ops.launch_counts() != {**{k: 0 for k in ops.KERNELS}, **fused}:
        raise AssertionError(f"expected one kernel-route run's launches and "
                             f"none from the plain route: "
                             f"{ops.launch_counts()}")
    whole_run_check("kernel_vs_plain_run", rk, rp)
    phase_seconds("7 kernel_vs_plain_run")

    # 8. the digital-defense grid: one analog lane (the fused route) and
    # five digital lanes; median and trimmed mean sort once per round each
    defenses_expect = {**fused, "sort_columns": 2 * ROUNDS}
    rd = drive("main_defenses", None, defenses_expect,
               run=lambda: figures.run_defenses(ROUNDS, device="cuda"),
               engine=lambda: figures.cases_engine(
                   figures.defense_cases(), ROUNDS, device="cuda"))
    phase_seconds("8 main_defenses")

    # 9. the large-U grid at U = 1000: the bitonic sort, blocked Krum
    drive("main_defenses_large_u", None,
          {"floa_step_batched": ROUNDS_LARGE_U,
           "grad_stats": ROUNDS_LARGE_U,
           "sort_columns_bitonic": 2 * ROUNDS_LARGE_U},
          run=lambda: figures.run_cases(grid_u, ROUNDS_LARGE_U, mc=mc_u,
                                        device="cuda"),
          engine=lambda: figures.cases_engine(grid_u, ROUNDS_LARGE_U,
                                              mc=mc_u, device="cuda"),
          rounds=ROUNDS_LARGE_U)
    phase_seconds("9 main_defenses_large_u")

    # 10. the defense grid: kernel route vs plain route from the same draws
    ops.reset_launches()
    rdp = figures.run_defenses(ROUNDS, device="cuda", force_plain=True)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the plain route launched kernels: "
                             f"{ops.launch_counts()}")
    whole_run_check("kernel_vs_plain_defenses", rd, rdp)
    phase_seconds("10 kernel_vs_plain_defenses")
    del rd, rdp, r1, rk, rp
    torch.cuda.empty_cache()

    # 11. the looped trainer at full width on Fig. 3's BEV lane (one
    # attacker, sigma 3), each route against its plain route from the same
    # seeded draws; counted as the sweeps are
    from types import SimpleNamespace
    exp_t = figures.Experiment("BEV@ah0.1", Policy.BEV, n_attackers=1,
                               alpha_hat=0.1, attacker_sigma=3.0,
                               rounds=ROUNDS)
    trainer_routes = {   # mode, defense, flat, launches
        "loop": ("floa", "mean", False, {}),
        "flat": ("floa", "mean", True, {"floa_step_batched": ROUNDS,
                                        "grad_stats": ROUNDS}),
        "median": ("digital", "median", False, {"sort_columns": ROUNDS}),
        "trimmed_mean": ("digital", "trimmed_mean", False,
                         {"sort_columns": ROUNDS})}

    def trainer_run(route, plain=False, eval_every=1):
        """One route's run; its logs every eval_every rounds as [1, R']
        loss and grad-norm rows (a sweep result's layout), and the seconds
        of the run alone (set-up excluded)."""
        mode, defense, flat, _ = trainer_routes[route]
        tr, params_t, sampler = figures.experiment_trainer(
            exp_t, device="cuda", mode=mode, defense=defense,
            force_plain=plain)
        batches = sampler.stack_rounds(ROUNDS) if flat else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if flat:
            params, logs = tr.run_scan(params_t, batches, exp_t.seed,
                                       eval_every=eval_every, flat=True)
        else:
            params, logs = tr.run(params_t, sampler, ROUNDS, exp_t.seed,
                                  eval_every=eval_every)
        torch.cuda.synchronize()
        return SimpleNamespace(
            loss=np.array([[lg.loss for lg in logs]]),
            grad_norm=np.array([[lg.grad_norm for lg in logs]]),
            params=params, accuracy_final=logs[-1].accuracy,
            seconds=time.perf_counter() - t0)

    trainer_rates = {}
    for route, (_, _, _, expect) in trainer_routes.items():
        rt, seconds, counts = run_phase(
            torch, ops, f"main_trainer_{route}", lambda r=route:
            trainer_run(r), {**{k: 0 for k in ops.KERNELS}, **expect})
        tally(counts)
        if not np.isfinite(rt.loss).all():
            raise AssertionError(f"trainer {route}: non-finite loss")
        ops.reset_launches()
        rtp = trainer_run(route, plain=True)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"trainer {route}: the plain route "
                                 f"launched kernels {ops.launch_counts()}")
        whole_run_check(f"kernel_vs_plain_trainer_{route}", rt, rtp)
        # timed as the figures log: every 10th round
        trainer_rates[route] = ROUNDS / trainer_run(
            route, eval_every=10).seconds
        emit(f"main_trainer_{route}", rounds=ROUNDS, run_seconds=seconds,
             rounds_per_s=trainer_rates[route],
             loss_first=float(rt.loss[0, 0]),
             loss_final=float(rt.loss[0, -1]),
             accuracy_final=rt.accuracy_final, launches=counts)
    emit("main_trainer", lane=exp_t.name, rounds=ROUNDS,
         rounds_per_s=trainer_rates)
    phase_seconds("11 main_trainer")

    # 12. the Byzantine showdown: 68 lanes at full width, R cut to 20
    showdown_expect = {"floa_aggregate_batched": ROUNDS,
                       "grad_stats": ROUNDS, "sort_columns": 2 * ROUNDS}
    rsd = drive("main_showdown", None, showdown_expect,
                run=lambda: figures.run_showdown(ROUNDS, device="cuda"),
                engine=lambda: figures.showdown_engine(ROUNDS,
                                                       device="cuda"))
    ops.reset_launches()
    rsp = figures.run_showdown(ROUNDS, device="cuda", force_plain=True)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the plain route launched kernels: "
                             f"{ops.launch_counts()}")
    whole_run_check("kernel_vs_plain_showdown", rsd, rsp)
    phase_seconds("12 main_showdown")
    del rsd, rsp
    torch.cuda.empty_cache()

    # 13. the execution plan: chunking, resume, device memory, the
    # reference paths
    plan_phase(torch, np, ops, figures, tally, grid_u, mc_u)
    torch.cuda.empty_cache()
    phase_seconds("13 plan")

    # 14. the serving path at full width: qwen3-4b in bf16, batch 8
    from repro_torch.data import sample_tokens
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, param_count
    from repro_torch.models.common import count_params
    n_steps = SERVE_PROMPT + SERVE_GEN
    n_params = param_count(lm)
    torch.cuda.reset_peak_memory_stats()
    rs, seconds, counts = run_phase(
        torch, ops, "main_serve",
        lambda: serve(lm, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                      device="cuda"),
        {**step_launches(ops, lm, 0, init=True),
         "decode_attention": lm.n_layers * n_steps})
    tally(counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (torch.isfinite(rs.logits).all()
            and 0 <= int(rs.tokens.min()) <= int(rs.tokens.max())
            < lm.vocab_size):
        raise AssertionError("serve: non-finite logits or tokens outside "
                             "the vocabulary")
    steady = serve(lm, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, device="cuda")
    if not torch.equal(steady.tokens, rs.tokens):
        raise AssertionError("serve: two runs from one seed differ")
    steady_ms = steady.decode_s * 1e3 / SERVE_GEN
    emit("main_serve", arch=lm.name, dtype="bfloat16", layers=lm.n_layers,
         params=n_params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
         gen=SERVE_GEN, run_seconds=seconds,
         prefill_s=steady.prefill_s, decode_s=steady.decode_s,
         prefill_tok_per_s=SERVE_BATCH * SERVE_PROMPT / steady.prefill_s,
         decode_tok_per_s=steady.tok_per_s,
         ms_per_step=steady_ms,
         first_run={"prefill_s": rs.prefill_s, "decode_s": rs.decode_s},
         peak_memory_gb=peak_gb, launches=counts,
         sample_tokens=rs.tokens[0, :12].tolist())
    del steady
    phase_seconds("14 main_serve")

    # 15. parity, bf16, full depth: the serve phase's 64 tokens teacher-
    # forced through the kernel and through its plain version
    params = lm_params(torch, lm)
    seq = torch.cat([rs.prompts, rs.tokens], dim=1)
    ops.reset_launches()
    lk = teacher_forced(torch, lm, params, seq, False)
    lp = teacher_forced(torch, lm, params, seq, True)
    if ops.launch_counts()["decode_attention"] != lm.n_layers * n_steps:
        raise AssertionError(f"parity: {ops.launch_counts()}")
    parity, ok = logit_parity(torch, lk, lp, lm.vocab_size)
    parity["max_abs_vs_serve"] = float((lk.float()
                                        - rs.logits.float()).abs().max())
    emit("kernel_vs_plain_serve_bf16", layers=lm.n_layers, steps=n_steps,
         tol={"max_abs": BF16_LOGIT_MAX, "mean_abs": BF16_LOGIT_MEAN},
         ok=ok, **parity)
    if not ok:
        raise AssertionError("bf16 serve: kernel route and plain route "
                             "disagree")
    del lk, lp
    # the same step's device time without the host: one decode step at
    # the serve phase's last position, captured in a CUDA graph (pos is
    # read on the device, so the step needs no host sync)
    from repro_torch.models import transformer as LM
    step, _ = make_decode_step(lm)
    caches = LM.init_caches(lm, SERVE_BATCH, n_steps, device="cuda")
    positions = torch.arange(n_steps, dtype=torch.int32, device="cuda")
    emit("serve_step_device", batch=SERVE_BATCH, cache_len=n_steps,
         graph_ms=time_ms(torch, lambda: step(params, caches, seq[:, -1:],
                                              positions[-1]), 1),
         eager_ms=steady_ms, bound_ms=2 * (
             count_params(params) - params["embed"].numel()
             + SERVE_BATCH * lm.d_model) / HBM_BYTES_PER_S * 1e3)
    del caches
    phase_seconds("15 kernel_vs_plain_serve_bf16")

    # 16. long-cache decode at full width: 8 steps against 32768 positions
    caches = LM.init_caches(lm, LONG_BATCH, LONG_S, device="cuda")
    gen = torch.Generator("cuda").manual_seed(1)
    for layer in [*caches["blocks"]["b0"]["k"], *caches["blocks"]["b0"]["v"]]:
        layer.normal_(generator=gen)
    positions = torch.arange(LONG_S, dtype=torch.int32, device="cuda")
    tokens = torch.as_tensor(sample_tokens(LONG_BATCH, LONG_STEPS,
                                           lm.vocab_size, seed=2),
                             dtype=torch.long, device="cuda")
    step, meta = make_decode_step(lm, "decode_32k")
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(LONG_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()

    def long_run():
        events[0].record()
        for i in range(LONG_STEPS):
            logits, _ = step(params, caches, tokens[:, i:i + 1],
                             positions[LONG_S - LONG_STEPS + i])
            events[i + 1].record()
        return logits

    logits, seconds, counts = run_phase(
        torch, ops, "main_long_cache", long_run,
        {**{k: 0 for k in ops.KERNELS},
         "decode_attention": lm.n_layers * LONG_STEPS})
    tally(counts)
    if not torch.isfinite(logits).all():
        raise AssertionError("long-cache decode: non-finite logits")
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(LONG_STEPS)]
    cache_bytes = (2 * lm.n_layers * LONG_BATCH * LONG_S * lm.n_kv_heads
                   * lm.hd * 2)
    weight_bytes = 2 * (count_params(params) - params["embed"].numel()
                        + LONG_BATCH * lm.d_model)
    long_bound = (cache_bytes + weight_bytes) / HBM_BYTES_PER_S * 1e3
    emit("main_long_cache", arch=lm.name, batch=LONG_BATCH, cache_len=LONG_S,
         steps=LONG_STEPS, step_ms=step_ms,
         ms_per_step=sum(step_ms[1:]) / (LONG_STEPS - 1),
         graph_ms=time_ms(torch, lambda: step(
             params, caches, tokens[:, -1:], positions[-1]), 1),
         bound_ms=long_bound, cache_gb=cache_bytes / 1e9,
         weights_read_gb=weight_bytes / 1e9, run_seconds=seconds,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         window=meta["window"], launches=counts)
    # `layer`, the fill loop's last view, would keep a 19 GB cache alive
    del caches, logits, layer
    torch.cuda.empty_cache()
    phase_seconds("16 main_long_cache")

    # 17. parity, f32, full widths, 2 layers
    lm32 = dataclasses.replace(lm, n_layers=2, dtype=torch.float32)
    params32 = lm_params(torch, lm32)
    lk = teacher_forced(torch, lm32, params32, seq, False)
    lp = teacher_forced(torch, lm32, params32, seq, True)
    ok = torch.allclose(lk, lp, rtol=RTOL_WHOLE_RUN, atol=1e-5)
    emit("kernel_vs_plain_serve_f32", layers=2, steps=n_steps,
         rtol=RTOL_WHOLE_RUN, atol=1e-5, ok=bool(ok),
         max_abs_diff=max_errors(torch, lk, lp)[0],
         max_rel_diff=max_errors(torch, lk, lp)[1])
    if not ok:
        raise AssertionError("f32 serve: kernel route and plain route "
                             "disagree")
    del lk, lp, params32
    torch.cuda.empty_cache()
    phase_seconds("17 kernel_vs_plain_serve_f32")

    # 18-19. the LM lane at production D, and against its plain route
    lm_lane_phase(torch, np, ops, figures, tally)
    phase_seconds("18-19 lm_lane")

    # 20. the FLOA train step and the prefill step at full width, from the
    # serve phase's weights
    tally(train_phase(torch, ops, lm, params))
    del params
    torch.cuda.empty_cache()
    phase_seconds("20 train")

    # 21, 22 and 25. the rank phases, one spawn of 2 ranks and one of 4 on
    # this card over gloo: the sweep sharded over ranks (and one rank on
    # NCCL) against the unsharded runs; the LM steps over the worker axes
    # and over a "model" axis, against phase 14's one-rank serve
    rank_phases(torch, np, ops, figures, tally, shard_tally, lm, rs)
    del rs
    torch.cuda.empty_cache()
    phase_seconds("21, 22, 25 ranks")

    # 23. the zoo's dense and MoE archs served at full width
    zoo_phase(torch, ops, tally)
    phase_seconds("23 zoo")

    # 24. long_500k: rings of decode_window slots at pos 524 287
    long500_phase(torch, ops, tally)
    phase_seconds("24 long_500k")

    # 26. MLA (deepseek-v2-236b) and the SSD block (mamba2-1.3b): serve,
    # long_500k, train step and prefill; no kernel of the port
    mla_ssm_phase(torch, ops, tally)
    phase_seconds("26 mla_ssm")

    # 27. the RG-LRU hybrid (recurrentgemma-9b, the kernel at dh 256):
    # serve, long_500k, train step and prefill; the int8 KV cache
    hybrid_phase(torch, ops, tally, lm)
    phase_seconds("27 hybrid")

    # 28. the frontends: llava-next-mistral-7b's projected prefix and
    # seamless-m4t-large-v2's encoder-decoder (cross-attention through the
    # decode kernel at dh 64)
    frontends_phase(torch, ops, tally)
    phase_seconds("28 frontends")

    # 29. the production layouts: the dry run's predictions against the
    # card, --mesh single on one process ((b), FSDP on ranks, ran in the
    # rank phases' 2-rank spawn)
    layouts_phase(torch)
    phase_seconds("29 layouts")

    # 30. rematerialization: qwen3-4b's step with remat against none,
    # train_4k's sequence at full depth on one card against the dry run,
    # moonshot's expert chunks against one chunk
    remat_phase(torch, ops)
    phase_seconds("30 remat")

    # 31. the head layouts the "model" axis does not divide: starcoder2-3b
    # and llama4 on 16 ranks, every head on every rank, against one rank
    heads_phase(torch, shard_tally)
    phase_seconds("31 heads")

    # 32. the counter-based draws: Philox against its known answers and
    # curand, the update and init kernels against their plain versions,
    # by part against the whole past 2^32, their rows, and phase 20's
    # step on its own draws from a counted init
    table.update(draws_phase(torch, ops, tally, floor_ms))
    phase_seconds("32 draws")

    # 33. compiled execution: each entry point graphed against eager; the
    # phases above ran graphed by default (their captures and replays)
    from repro_torch import graphs
    so_far = graphs.totals()
    emit("graphs_so_far", **so_far)
    if so_far["captures"] < 1 or so_far["replays"] < 1:
        raise AssertionError(f"no phase replayed a graph: {so_far}")
    graphs_phase(torch, np, ops, figures, lm)
    phase_seconds("33 graphs")

    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    # every main-path shape of the FLOA kernels, grad_stats and the sorts,
    # with its launches: the paper's sweeps (3, 4 and 2 lanes of U = 10),
    # the single analog lane of the defense grid and of the trainer's flat
    # scan (U = 10), of the U = 1000 grid, and the showdown's 36 analog
    # lanes; the sorts of the defense grids' one-lane groups, the digital
    # trainer's [U, D] slab and the showdown's 8-lane groups
    # The plan phase adds: fig3 three times (monolithic, chunked, async),
    # the checkpointed showdown, the U = 1000 grid twice at R = 20, the
    # defense grid grouped and switched (each default and strict), fig3's
    # tree state and the strict flat and tree runs; the switch dispatch at
    # [6, 10, D] and 60 rows, the strict route's leaf segments at 10, 40
    # and 60 rows.  The LM lane adds the step at [2, 8, D_lm], 16 rows of
    # D_lm and the sort at [1, 8, D_lm].
    d, r = mc_u.dim, ROUNDS
    want_shapes = {
        "floa_step_batched": {(3, 10, d): r, (4, 10, d): 6 * r,
                              (1, 10, d): 4 * r,
                              (1, 1000, d): ROUNDS_LARGE_U + 2 * r,
                              (2, LM_WORKERS, LM_D): r},
        "floa_aggregate_batched": {(2, 10, d): r, (36, 10, d): 2 * r,
                                   (6, 10, d): 2 * r, (4, 10, d): 2 * r},
        "floa_aggregate": {},
        "grad_stats": {(30, d): r, (40, d): 5 * r, (20, d): r,
                       (10, d): 3 * r, (1000, d): ROUNDS_LARGE_U + 2 * r,
                       (360, d): 2 * r, (60, d): r,
                       (2 * LM_WORKERS, LM_D): r},
        "grad_stats_segments": {(rows, MLP_SEGMENTS): 2 * k * r
                                for rows, k in ((10, 1), (40, 2), (60, 1))},
        "sort_columns": {(1, 10, d): 6 * r, (10, d): 2 * r,
                         (8, 10, d): 4 * r, (6, 10, d): 4 * r,
                         (1, LM_WORKERS, LM_D): r},
        "sort_columns_bitonic": {(1, 1000, d): 2 * ROUNDS_LARGE_U + 4 * r},
        "decode_attention": decode_shapes(lm)}
    if main_shapes != want_shapes:
        raise AssertionError(f"main-path launches by shape: {main_shapes}, "
                             f"expected {want_shapes}")
    # the mesh phase's ranks: every rank at every shard-local shape
    from repro_torch.configs import flat_param_dim, get_lm_sweep
    lm_sizes = lm_leaf_sizes()
    want_shard = {k: {} for k in ops.launch_shapes()}
    for case in MESH_CASES:
        for k, shapes in mesh_expect(case, d, lm_sizes if case == "lm_strict"
                                     else ()).items():
            for shape, n in shapes.items():
                want_shard[k][(case, shape)] = MESH_RANKS * n
    # the LM-mesh phase's serve: each of its 2 ranks decodes half the batch
    want_shard["decode_attention"][(
        "lm_mesh_serve", (SERVE_BATCH // 2, SERVE_PROMPT + SERVE_GEN,
                          lm.n_heads, lm.n_kv_heads, lm.hd))] = (
        2 * lm.n_layers * (SERVE_PROMPT + SERVE_GEN))
    # the LM-model phase's serves: each rank's query heads and KV heads
    from repro_torch.models.attention import local_heads
    rg = dataclasses.replace(get_config(RG_ARCH), n_layers=TP_RG_LAYERS)
    for (_, case, ranks), (cfg, n, layers) in zip(TP_SERVES, (
            (lm, SERVE_PROMPT + SERVE_GEN, lm.n_layers),
            (get_config(MOE_TRAIN_ARCH), SERVE_PROMPT + SERVE_GEN,
             MOE_TRAIN_LAYERS),
            (get_config(TP_SC_ARCH), TP_SC_PROMPT + TP_SC_GEN,
             TP_SC_LAYERS),
            # (f)'s two serves (f32 and bf16), one local layer each
            (rg, SERVE_PROMPT + SERVE_GEN, 2 * attn_layers(rg)))):
        q, kv = local_heads(cfg, ranks, 0)
        want_shard["decode_attention"][(case, (
            SERVE_BATCH, n, q.stop - q.start, kv.stop - kv.start,
            cfg.hd))] = ranks * layers * n
    # the heads phase's serves: every rank decodes every head
    for arch, layers in HEADS_CASES:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        q, kv = local_heads(cfg, HEADS_RANKS, 0)
        want_shard["decode_attention"][(f"heads_{arch}", (
            SERVE_BATCH, HEADS_PROMPT + HEADS_GEN, q.stop - q.start,
            kv.stop - kv.start, cfg.hd))] = (
            HEADS_RANKS * attn_layers(cfg) * (HEADS_PROMPT + HEADS_GEN))
    if shard_shapes != want_shard or flat_param_dim(get_lm_sweep()) != LM_D:
        raise AssertionError(f"sharded launches by shape: {shard_shapes}, "
                             f"expected {want_shard}")

    def phase3_row(name, shape):
        """{shape, ms, bound_ms, bound_share, call_ms} of the phase-3 row
        that held `name` against its plain version at `shape`; a launch
        shape without one fails the run."""
        if name == "decode_attention":
            tag = "B={} S={} H={} KV={} dh={} ".format(*shape)
        elif len(shape) == 3:
            tag = f"S={shape[0]} U={shape[1]} D={shape[2]} "
        elif name == "grad_stats_segments":
            tag = f"R={shape[0]} sizes={sizes_label(shape[1])} "
        elif name.startswith("sort"):
            tag = f"U={shape[0]} D={shape[1]} "
        else:
            tag = f"R={shape[0]} D={shape[1]} "
        row = next((r for r in table.get(name, [])
                    if r["shape"].startswith(tag)), None)
        if row is None:
            raise AssertionError(f"{name} launched at {list(shape)} on the "
                                 f"main path, which no phase-3 row holds "
                                 f"against its plain version")
        return {k: row[k] for k in ("shape", "ms", "bound_ms", "bound_share",
                                    "call_ms")}

    def by_shape(name):
        """[{shape, launches, ms, bound_ms, bound_share, call_ms}] of a
        kernel's main-path shapes, from their phase-3 rows."""
        return [{**phase3_row(name, shape), "launches": n}
                for shape, n in main_shapes.get(name, {}).items()]

    # every launch shape of the main path, the mesh phase's ranks' too, has
    # its phase-3 row
    for name in main_launches:
        for shape in main_shapes.get(name, {}):
            phase3_row(name, shape)
        for _, shape in shard_shapes.get(name, {}):
            phase3_row(name, shape)

    # the kernel list
    sources = {"floa_step_batched": ("floa_aggregate.cu",
                                     "src/repro/kernels/floa_aggregate.py:126"),
               "floa_aggregate_batched": ("floa_aggregate.cu",
                                          "src/repro/kernels/floa_aggregate.py:82"),
               "floa_aggregate": ("floa_aggregate.cu",
                                  "src/repro/kernels/floa_aggregate.py:184"),
               "grad_stats": ("grad_stats.cu",
                              "src/repro/kernels/grad_stats.py:37"),
               "grad_stats_segments": ("grad_stats.cu",
                                    "src/repro/kernels/grad_stats.py:37"),
               "sort_columns": ("defense_sort.cu",
                                "src/repro/kernels/defense_sort.py:105"),
               "sort_columns_bitonic": ("defense_sort.cu",
                                        "src/repro/kernels/defense_sort.py:192"),
               "decode_attention": ("decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:72"),
               "noisy_sgd": ("noisy_update.cu",
                             "none: src/repro/launch/steps.py:222 (the "
                             "update, fused by XLA)"),
               "counter_trunc_normal": ("noisy_update.cu",
                                        "none: src/repro/models/common.py:169 "
                                        "(the init's truncated normal)")}
    kernels = []
    for name, (src, replaces) in sources.items():
        row = table[name][0]
        on_path = name != "floa_aggregate"
        if on_path and main_launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": main_launches[name],
            "on_main_path": on_path, "shape": row["shape"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "call_ms": row["call_ms"]})
        if "issue_bound_ms" in row:
            kernels[-1]["issue_bound_ms"] = row["issue_bound_ms"]
        if len(main_shapes.get(name, {})) > 1:
            kernels[-1]["launches_by_shape"] = by_shape(name)
        if shard_shapes.get(name):
            ranks_of = {**{case: ranks for _, case, ranks in TP_SERVES},
                        **{f"heads_{arch}": HEADS_RANKS
                           for arch, _ in HEADS_CASES}}
            kernels[-1]["launches_by_shard_shape"] = [
                {"case": case, **phase3_row(name, shape),
                 "shard_shape": list(shape), "launches": n,
                 "ranks": ranks_of.get(case, MESH_RANKS)}
                for (case, shape), n in shard_shapes[name].items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
