#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together, linked into one library under
``build/``) and runs twenty-six phases on ``cuda:0``:

  1. kernels     — all ten kernels (K1 gather_rows, K2 unmarshal, K3
                   pack_and_histogram, K4 rank_and_histogram, K5
                   scatter_rows, K6 compact_positions, K7 marshal, K8
                   rk4_step, K9 pairwise_accel, K10 track), each held against
                   its plain PyTorch version on the card at the main paths'
                   shapes (bit-equal; K8 within 1e-5; K9 and its plain
                   version against a float64 witness on a sample, each
                   within 1e-5 of the row's sum of |terms|, K9 within 2x the
                   plain version's error; K10's t within rtol 1e-6, statuses
                   equal but for near-ties) and timed beside its plain
                   version, a PyTorch library call where one exists, and its
                   bound (bytes over 3.35 TB/s or float32 operations over
                   67e12/s; K10's counted from the steps its rays take),
                   each two ways: ``device_ms`` (the device time of
                   every kernel, fill and memset of a call, from
                   ``torch.profiler`` over 20 back-to-back calls) and
                   ``call_ms`` (one CUDA event pair around one call, host
                   issue time included); K2, K4 and K6 must make one kernel
                   launch a call and no fill; K8 must give each particle
                   the same bits wherever it sits (``pos[k:]`` against
                   ``pos``); K2 and K4 also at VoPaT's shapes, K6 at the
                   streamlines and VoPaT shapes, K8 at the streamlines
                   shape; K2 also with offsets shifted by a retain spill
                   front inside (0, C) and at or past C; plus the two-pass
                   marshal path (K3 + sort + K7) against K1's fused marshal;
  2. forward     — one ``forward_work`` round of the Fig-8 44-byte ray, R=8
                   ranks × C=262,144 (2,097,152 rays, about one 1080p frame
                   of primary rays), S=65,536 peer slots, in both marshal
                   modes: the sort round equal to the onehot oracle on the
                   card and to the same round run on the CPU, the scatter
                   round equal to both; one payload and one count
                   all_to_all each; K1, K2, K3 once in the sort round, K4,
                   K5, K2 once in the scatter round; median round times and
                   the stage splits (CUDA events at the stage boundaries);
  3. lossless    — ``overflow="retain"`` and the hierarchical route, the
                   Fig-8 ray's 11 words with a scenario uid in the first:
                   (a) ``chaos.rotating_hotspot(8, 8, 32768)`` through the
                   flat padded retain drive (C=262,144, 8,192 peer slots)
                   in both marshals, equal to the port's numpy oracle
                   forward for forward (11 rounds, retained rows and their
                   largest age) and to ``expected_by_rank``, timed, with
                   the seed round's stage split; (b) one hierarchical drop
                   round of the Fig-8 rays on 2×4 and 2×2×2 in both
                   marshals, equal to the flat onehot round and to the CPU,
                   one payload and one count ``all_to_all`` per tier, timed
                   with stage splits beside the flat padded round; (c) the
                   scenario of (a) through the hierarchical retain drive at
                   tight tier capacities on both layouts: checksums equal,
                   0 drops, rows parked after a later tier, sort and
                   scatter equal after every forward; launches counted on
                   every path;
  4. telemetry   — the flight recorder and the capacity controller: (a) the
                   Fig-8 round (flat sort and scatter, 2×2×2) with
                   ``telemetry=True`` bit-equal to the telemetry-off round,
                   with its calls and launches and no more synchronizing
                   calls (``torch.cuda`` sync debug mode), its stats equal
                   to the CPU round's and across marshals, medians and
                   splits on and off; (b) phase 3 (a)'s retain drive with
                   the ring: ``ring_trace`` equal to the oracle's retained
                   and age traces; (c) ``tune.autotune_forward`` on the
                   drifting hot-spot of ``tests/test_tune.py`` (flat and
                   2×2×2): the card's report equal to the CPU's at the
                   test's size, and at card size (262,144 11-word rows a
                   rank, 24,576 emissions a round, from 2,048-row slots)
                   converged drop-free within the §6.3 bounds, wall time a
                   burst;
  5. pipeline    — ``pipeline_shards``: the Fig-8 round at 2 and 4 shards
                   (both marshals), phase 3 (a)'s retain seed round at 4
                   and the 2×2×2 round at 2, each bit-equal to one shard,
                   n payload and n count calls a tier, K1 or K5 n times a
                   tier and K2 never; medians and per-shard splits;
  6. credit      — ``flow="credit"``, the backpressure law: (a) the two
                   test-size credit drives (``sustained_overload`` C=16 S=4,
                   ``incast_collapse`` C=32 S=8) in sort, scatter and sort
                   at 2 shards, and ``sustained_overload(8,
                   emits_per_round=256)`` at C=1,024 S=128 (848 rounds),
                   each equal to ``chaos.simulate_flat_credit`` forward for
                   forward; (b) the overload shapes at full width (C=262,144,
                   S=65,536, the tests' ratios): open flow to its end,
                   dropping rows, against 48 credit forwards in sort and
                   scatter in lockstep (no drop, no wasted wire, the first
                   forward ships nothing, rows conserved), ms a forwarding
                   round and the credit drain rate; ``incast_collapse(8,
                   10, 8192)`` through the flat, 2×4 and 2×2×2 credit drives
                   to ``expected_by_rank``; (c) one credit round of the
                   Fig-8 rays, flat, 2×4 and 2×2×2, both marshals, equal to
                   the CPU (queues, ages, credits, stats), its calls the
                   open retain round's with each count call one int32
                   column wider, no more synchronizing calls, timed beside
                   the open round;
  7. balance     — the health remap, rebalancing and cycling: (a) the
                   Fig-8 round with ranks 2 and 5 unhealthy equal to the
                   round of the remapped ``dest`` and to the CPU, an
                   all-True mask equal to no mask, no call or launch added;
                   ``rank_brownout`` under ``brownout_mask`` through the
                   retain drive equal to ``simulate_flat_retain(health=)``;
                   (b) ``rebalance`` of a skewed Fig-8 population (global
                   flat, 2×4, 2×2×2; intra 2×4, 2×2×2; an evacuation):
                   floor or ceil of the mean plus the pending rows, intra
                   calls at the last tier only, equal to the CPU; (c)
                   ``deliver_by_cycling`` (sort and scatter, drop and
                   retain): each rank's rows sorted by pixel equal to the
                   padded round's, R payload and R count ``ppermute``
                   calls, K3 and K1 or K5, and K6, every hop; timed beside
                   the padded round;
  8. recovery    — the checkpointed drive, the recovery law and the chaos
                   driver, ``chaos.ChaosItem`` rows: (a)
                   ``rotating_hotspot(8, 8, 32768)`` through
                   ``chaos.run_scenario_checkpointed`` at C=262,144, 8,192
                   peer slots, retain, the ring on, a checkpoint every 3
                   rounds, sort and scatter: uninterrupted, preempted at
                   round 5 and resumed, and with no checkpoint directory —
                   SHA-256 digests equal at every common boundary, checksums
                   ``expected_by_rank``, 0 lost, 0 drops, ``run_scenario``'s
                   rounds and result, K1–K6 counted on the path
                   ``recovery``; (b) the same drive preempted at its first
                   drain-phase boundary (9) and resumed on 4 ranks at
                   C=524,288: the global checksums the schedule's, nothing
                   lost, the rows in flight and the relayout's time; (c)
                   ``incast_collapse(8, 10, 8192)`` through the credit drive
                   (S=65,536), preempted and resumed: digests equal; (d)
                   bytes and seconds a boundary (host copy, serialise,
                   SHA-256, write with fsync), device ms a round of the
                   segmented drive against ``run_until_done``'s (kernels
                   and copies apart, in turns), and a body round's syncs
                   with the accounting counters against without;
  9. streamlines — ``apps.streamlines.run`` through
                   ``RafiContext.run_until_done``, R=8, 131,072 particles,
                   64 steps, ABC field (tornado and Taylor-Green at 16,384):
                   traces equal the single-rank oracle exactly; K6 launched
                   once per ``enqueue``;
 10. vopat       — ``apps.vopat.render`` at 1024×1024 (1,048,576 primary
                   rays), R=8, ``marshal="scatter"``: drops 0, the image
                   bit-equal to the R=1 render and to the R=8 sort render,
                   finite and in [0, 1]; rounds, wall time and the
                   device-busy share; two witnesses independent of the
                   card: the threefry words of 2,097,152 (pixel, event)
                   pairs bit-equal to the same words on the CPU, and a
                   64×64 render equal to the port's plain CPU render within
                   the port-against-reference tolerance of the tests;
 11. nbody       — ``apps.nbody.run``, R=8, 262,144 particles, 8 steps (dt
                   5e-4, θ 0.3, ε² 1e-3, G = 64/N): every particle conserved
                   (totals N every step, drops 0), positions within 1e-2 of
                   the direct-sum oracle, the R=1 run within 1e-5 of it, K9
                   launched once a step and K3, K1, K2 four times (four
                   forwarding contexts a step); a 512-particle R=8 run on the
                   card against the same run on the CPU; wall time per step,
                   the device-busy share and K9's share of device time;
 12. obs         — the observation law at the Fig-8 shape (R=8, C=262,144,
                   S=65,536): (a) ``obs.phases.profile_phases`` of the flat
                   sort and scatter rounds, 2 and 4 shards, 2×4 and 2×2×2:
                   the reference's phase keys, each stage's device ms
                   beside the fused round's; (b) one Fig-8 round and one
                   ``run_until_done`` drive with ``obs.trace.capture()``
                   and without: the same calls, launches, host syncs and
                   results; (c) the flight report at card size:
                   ``incast_collapse(8, 10, 8192)`` open and credit (both
                   finish, both healthy) and ``incast_collapse(8, 10,
                   65536)`` (the tests' 2× fan-in) open to its end and
                   credit for 48 forwards (the law's floor), through
                   ``chaos.run_scenario`` → ``chaos_capture`` →
                   ``save_capture`` → ``load_capture`` → ``analyze`` and
                   ``render``: the full-fan-in open run the only degraded
                   run, every check of the others ok; (d) the Prometheus
                   text of a full-width ring parses and its drop counters
                   equal the ring's and the queue's;
 13. apps2       — the §5.2 lander and the §5.3 schlieren app at 1024×1024,
                   R=8 (32 slabs, 8 samples a slab, 12-word rays): the
                   lander's image bit-equal to R=1 with no drop; deep
                   compositing at 4 fragments dropping none and within 1e-5
                   of it, at 1 fragment dropping and off by more than 1e-3;
                   schlieren's u and v bit-equal to R=1; 64×64 renders
                   within 1e-5 of the CPU's; K3, K1, K2 once a forwarding
                   round and K6 once an ``enqueue``; rounds, wall time, peak
                   memory and the device-busy share of each;
 14. ragged      — ``exchange="ragged"`` at the Fig-8 shape (R=8,
                   C=262,144, 44-byte rays): (a) the padded round at
                   S=65,536 shown to drop nothing, then the ragged round in
                   both marshals bit-equal on lanes < count to the onehot
                   and the padded rounds (counts and totals too), sort ==
                   scatter, sort == the CPU's on every lane, 2 and 4 shards
                   == 1; one ``ragged_all_to_all`` and one count
                   ``all_gather`` (n of each at n shards); K3 + K1 twice or
                   K4 + K5 + K1, no K2; no more synchronizing calls than
                   the padded round, none added by telemetry, retain and a
                   health mask; event medians and device ms beside the
                   padded round's, the stage split, and the stacked copy's
                   device ms beside the padded ``all_to_all``'s and its
                   bound; (b) ``rotating_hotspot(8, 8, 32768)`` through the
                   ragged retain drive, open and credit: lost 0, no drop,
                   ``expected_by_rank`` and the padded retain drive's
                   checksums, rounds, peak backlog, ms a round; (c)
                   streamlines (ABC, 131,072 particles, 64 steps) on ragged
                   == its single-rank oracle bit for bit, wall beside the
                   padded run's; (d) ``obs.phases.profile_phases`` of the
                   ragged round: the reference's three keys, each stage's
                   device ms;
 15. lm          — the LM serving path: (a) llama4-scout-17b-16e at full
                   width (d_model 5,120, 40/8 heads, d_ff 8,192, 16 experts
                   top-1, vocabulary 202,048, bfloat16) at 4 of its 48
                   layers, random weights from a seeded generator on the
                   card: parameters, bytes, peak memory; (b)
                   ``launch.serve.BatchedEngine`` with 16 slots, 128
                   positions, layout (data=1, model=8), answering 16
                   requests (prompts of 8–48 tokens, 8–24 new ones, from a
                   seed) at the config's capacity_factor 1.25: steps,
                   tokens, wall time, the decode step's event median,
                   tokens a second, the MoE drops of each step; K6, K3, K1
                   and K2 launched 8 times a step each (two ``forward_work``
                   rounds a MoE layer), no other kernel; one step's device
                   time by part (attention, the expert GEMMs, the two
                   rounds) and by kernel (``torch.profiler``); (c) the
                   token stream of (b) fed again through the rafi_ep plane
                   at tp=8 and tp=1 and the dense_tp plane at
                   capacity_factor E/top_k: 0 drops, logits within
                   ``LM_TOL_PLANES`` and the argmax equal wherever the
                   top-2 margin exceeds it; (d) ``prefill_fn`` of 2 × 64
                   tokens against the last of 64 decode steps, and a
                   2,048-token prefill with ``_sdpa_blocked`` against the
                   materialising ``_sdpa``, within ``LM_TOL_PREFILL``; (e)
                   the float32 smoke config's engine on layout (2, 4) on
                   the card against the CPU (tokens equal, logits within
                   1e-4); the queue that one MoE layer's first round
                   delivers, at the decode and the prefill shapes, on the
                   card against the CPU bit for bit; K6, K3, K1 and K2 at
                   those two shapes against their plain versions, timed
                   beside them, the library call and the bound;
 16. train       — the LM training path (``launch.train.train``): (a)
                   qwen2-7b at full width (d_model 3,584, 28/4 heads, d_ff
                   18,944, vocabulary 152,064, bfloat16, remat) at 4 of its
                   28 layers, 10 steps of batch 8 × 512 from ``SyntheticLM``
                   under ``AdamWConfig(warmup_steps=20)``: losses and gnorm
                   finite, the step's event median and device time, tokens
                   a second, peak memory, model FLOPs a step against the
                   989e12 bfloat16 peak; (b) llama4-scout-17b-16e at full
                   width at 1 of 48 layers, layout (1, 8), its 4
                   microbatches, 4 steps: the same numbers, MoE drops a
                   step (the checkpoint's recompute of a dispatch round
                   dropping what forward's dropped), K6, K3, K1, K2
                   launched every step; router,
                   experts and ``ln2`` out of backward without gradient and
                   updated by weight decay alone, m and v 0 (the reference's
                   zeros through the ``rafi_ep`` plane); (c) the qwen2-7b and
                   llama4 smoke configs from one CPU draw, 3 steps on the
                   card and on the CPU: loss within 1e-4, gnorm within 1e-4
                   of itself, the
                   card's MoE through K6, K3, K1, K2, the CPU's through
                   their plain versions; (d) both smoke configs trained to
                   10 steps, and to 5 then resumed from the checkpoint:
                   losses within 1e-6 (bit-equal or not, printed); (e)
                   qwen2-7b smoke, 70 steps at lr 1e-2: the last 5 losses'
                   mean below 0.9 × the first 5's;
 17. families    — the rwkv6, griffin and encdec families at full width
                   (no kernel of the ten on their path; plain PyTorch, the
                   scans in float32 without TF32): (a) rwkv6-3b (32 layers)
                   and recurrentgemma-2b (26) at full depth from a seeded
                   generator, 16 requests through ``BatchedEngine`` at 16
                   slots (prompts of 8–48 tokens, 8–24 new ones), a
                   2,048-token prefill, and ``prefill_fn`` of 2 × 64 tokens
                   against the last of its 64 decode steps, in float32 (a
                   copy of the weights) within 1/``FAM_F32_GAIN`` of the
                   bfloat16 prefill's distance from the float32 one, in
                   bfloat16 measured; (b) seamless-m4t-medium
                   (12 + 12) at full depth: the encoder over frames (4, 512,
                   1024), prefill of 64 tokens against its 64 ``decode_fn``
                   steps as in (a), then 32 greedy steps against the
                   memory; (c) one layer of
                   each at full width in float32: the chunk scan against
                   ``naive_scan_oracle`` (and at ``W_MIN``), ``rwkv_block``
                   and ``griffin_block`` decoded token by token against
                   their parallel forms, 1 + 1 encdec layers decoded step by
                   step against the parallel decode, each within
                   ``FAM_TOL_F32`` of its scale; (d) one pattern period of
                   each, card against CPU from one draw: in float32 every
                   logit within 1/``FAM_F32_GAIN`` of the CPU's bfloat16
                   logits' distance from its float32 ones, in
                   bfloat16 the card's logits no farther from the CPU's
                   float32 ones than ``FAM_BF16_NOISE`` x the CPU's
                   bfloat16 ones are; (e) ``build_train_step``
                   at batch (8, 512) (seamless: frames and tokens of 64),
                   seamless at every layer, rwkv6-3b at 4 of 32 layers and
                   recurrentgemma-2b at 3 of 26 (``FAMILY_TRAIN_LAYERS``),
                   3 AdamW steps, losses finite; (f) the event
                   median, device ms split into the scans, attention, AdamW, the GEMMs
                   and the rest, and launches, of a decode and a train step,
                   and peak memory;
 18. dryrun      — the shape suite and the meta-device dry run
                   (``launch.dryrun``): (a) the sweep of qwen2-7b's four
                   (arch × shape) cells at full width on meta (the other
                   36 are the CPU tests'), its FLOP probes counted in
                   ``launch.dryrun.WORKERS`` processes while (b) holds the
                   card: 3 ok, 1 skip, 0 errors, one line a cell
                   (bytes of parameters, AdamW state and caches; counted
                   FLOPs, ``model_flops`` and their ratio) and the seconds;
                   (b) qwen2-7b at full width, 4 of 28 layers, batch 8 × 512
                   (phase train's config): the bytes of the parameters and
                   AdamW state that ``Model.init`` and ``adamw_init`` make on
                   the card, and of ``init_caches(8, 512)``, equal to the dry
                   run's; ``FlopCounterMode`` over one real train step on
                   the card equal to the meta count (differenced and full
                   depth); that count and ``model_flops`` over the step's
                   device time as shares of the 989e12 bf16 peak; no kernel
                   of K1–K10 launched;
 19. dist        — the ``torch.distributed`` backend (``core.collectives.
                   DistributedCollectives``) at a world of one: NCCL set up
                   through ``launch.dist.init_world`` on ``cuda:0`` with a
                   ``file://`` store in a temporary directory, the group
                   destroyed after; the Fig-8 round (R=8, C=262,144,
                   S=65,536) on padded sort, padded scatter, 2×2×2 and
                   ragged bit-equal on lanes < count to the stacked round
                   on the same queue, with the same call record and
                   launches (ragged: one more K1, the landing), no host
                   read but the ragged round's one; each route's event
                   median and device ms beside the stacked round's and its
                   device time split into NCCL's kernels, the hand kernels,
                   copies and the rest; streamlines (ABC, 131,072
                   particles, 64 steps) and N-body (4,096 bodies, 2 steps)
                   on the backend bit-equal to their stacked runs; K1–K6,
                   K8 and K9 counted on the path ``dist``;
 20. dist_paths  — the paths beside the round on the same backend, NCCL at
                   a world of one, each beside its stacked run:
                   ``rotating_hotspot(8, 8, 32768)`` through the
                   checkpointed retain drive (C=262,144, 8,192 slots, a
                   checkpoint every 3 rounds) preempted at 5 and resumed,
                   its result and every boundary's digests equal; the
                   tuner on the drift burst, burst for burst;
                   ``profile_phases`` of the Fig-8 round, keys and calls
                   equal; VoPaT (scatter), lander, deep compositing and
                   schlieren at 1024×1024, R=8, images and stats bit-equal,
                   the frame-buffer ``psum`` timed alone; a llama4-scout
                   decode step at 4 of 48 layers, layout (1, 8), 16 slots,
                   logits within phase lm's plane tolerance, tokens and
                   drops equal; a qwen2-7b train step at 4 of 28 layers,
                   8 × 512, with its ``grad_all_reduce``, parameters
                   bit-equal; each path's NCCL calls, event times and
                   device ms by part; K1–K6 counted on ``dist_paths``;
 21. shard       — the dense family's placed train state
                   (``launch.placement``): qwen2-7b at full width, 4 of 28
                   layers, ``fsdp=True``, layout (2, 4) stacked on the
                   card, batch 8 × 512: every rank's block of every
                   parameter and AdamW moment equal to the chunk of the
                   whole leaf the rule names, bit for bit, its bytes
                   ``specs.device_bytes``; the placed step's calls by kind
                   and tier, event median, device ms by part and peak GiB
                   beside the unsharded step's; the placed state
                   checkpointed (written whole) restored onto (4, 2) and
                   whole, bit for bit; the same step over NCCL at a world
                   of one bit-equal to the stacked one; at 2 layers in
                   float32, the placed step against the unsharded one
                   (loss, gnorm, every parameter); no hand kernel;
 22. serve_shard — serving the dense family on placed parameters
                   (``launch.placement.serve_placement`` and
                   ``cache_placement``): qwen2-7b at full width, 4 of 28
                   layers, bf16, layout (2, 4) stacked: every rank's block
                   of every parameter and of seeded caches (16 slots,
                   ``max_len`` 128) equal to the chunk the rule names, bit
                   for bit, its bytes ``specs.device_bytes``;
                   ``BatchedEngine`` on the placed parameters answering
                   phase lm's 16 requests beside the unsharded engine:
                   calls a step by kind and tier and their bytes, event
                   medians, device ms by part, top device events, peak
                   GiB; a decode step on caches 4,096 long at position
                   4,000 and a 2 × 2,048 prefill, placed and unsharded,
                   timed, their logits within ``FAM_BF16_NOISE`` x the
                   bfloat16 noise; the placed engine on NCCL at a world
                   of one bit-equal; at 2 layers in float32 the placed
                   decode within 1/16 of the bfloat16 distance over
                   steps that cross every model rank's block; no kernel;
 23. moe_shard   — the MoE family on placed parameters
                   (``launch.placement`` for ``kind="moe"``):
                   llama4-scout-17b-16e at full width, bf16, ``rafi_ep``
                   (each model rank its own E/model experts); 4 of 48
                   layers serve-placed on (1, 8) stacked, phase lm's
                   model and layout: the blocks equal to the chunks the
                   rule names, bit for bit, their bytes
                   ``specs.device_bytes``; ``BatchedEngine`` on the
                   placed parameters answering phase lm's 16 requests
                   beside the unsharded engine: event medians, device ms
                   by part (attention, expert GEMMs, the two rounds, the
                   collectives), calls a step by kind and tier with their
                   bytes, K6/K3/K1/K2 two rounds a layer a step on the
                   path ``moe_shard``, drops a step, peak GiB; the placed
                   decode's first dispatch round against the CPU's, bit
                   for bit; 1 of 48 layers, ``fsdp``, train-placed on
                   (2, 4), batch 8 × 512 in 4 microbatches, 3 steps: the
                   blocks and AdamW moments, losses finite, the router,
                   experts and ``ln2`` decayed alone with ``m`` and ``v``
                   zero, event median, device ms and peak beside the
                   unsharded step's; float32 at 1 layer, the placed
                   decode within 1/16 of the bfloat16 distance, drops
                   equal; both smoke configs under both planes placed,
                   card against CPU;
 24. recurrent_shard — the recurrent families on placed parameters
                   (``launch.placement`` for the ssm and hybrid kinds):
                   rwkv6-3b at 4 of 32 layers (its 40 heads over
                   ``model``) and recurrentgemma-2b at 3 of 26 (its
                   RG-LRU's 2,560 channels over ``model``, ξ gathered for
                   the gates; its local attention the dense family's) at
                   full width, bf16, layout (2, 4) stacked: (a) every
                   rank's block of the serve and fsdp train parameters, of
                   AdamW's moments and of seeded caches (16 slots,
                   ``max_len`` 128; the states' channels or heads over
                   ``model``) equal to the chunk the rule names, bit for
                   bit, its bytes ``specs.device_bytes``; (b)
                   ``BatchedEngine`` on the placed parameters answering
                   phase lm's 16 requests beside the unsharded engine:
                   calls a step by kind and tier (the pinned budget) with
                   their bytes, event medians, device ms by part (GEMMs,
                   the recurrence, attention, the collectives), peak GiB;
                   (c) fsdp, batch 8 × 512 in 2 microbatches, 3 steps:
                   losses finite, event median, device ms by part and peak
                   beside the unsharded step's; (d) float32 (rwkv6 at 1
                   layer, recurrentgemma at 3): the placed decode and a
                   2 × 64 prefill within 1/16 of the bfloat16 distance;
                   each smoke config placed, card against CPU; (e) no
                   kernel on the path;
 25. frontend_shard — the stub-frontend families on placed parameters,
                   full width, bf16, stacked: qwen2-vl-72b (the dense
                   family's placement, ``embeds`` in place of the lookup,
                   M-RoPE) and seamless-m4t-medium under ``dp_over_model``
                   (every weight whole on every rank, the rows over
                   ``(data, model)``, the decoder caches' sequence over
                   ``model``): (a) every rank's block of the serve and
                   train parameters, AdamW's moments and seeded caches
                   equal to the chunk the rule names, bit for bit, its
                   bytes ``specs.device_bytes``; (b) qwen2-vl at 2 of 80
                   layers on (2, 4): ``BatchedEngine`` answering phase
                   lm's 16 requests beside the unsharded engine, a 2 × 64
                   prefill of ``embeds``; (c) seamless at full depth on
                   (2, 4): frames (8, 512, 1,024), a placed prefill, 64
                   teacher-forced and 32 greedy ``decode_fn`` steps
                   against the memory beside the unsharded model; for (b)
                   and (c) event medians, device ms by part, calls a step
                   by kind and tier (the pinned budgets) with their bytes,
                   peak GiB; (d) training, placed then unsharded:
                   qwen2-vl at 1 layer, ``fsdp`` on (2, 4), 8 × 512 with
                   ``embeds`` and ``labels`` in 4 microbatches (``embed``
                   gathered by no call and decayed alone), seamless at
                   full depth on (2, 2), frames and tokens of 64, 3 steps
                   each: losses finite, event median, device ms by part,
                   calls, peak GiB; (e) float32 at 1 layer: each placed
                   decode within 1/16 of the bfloat16 distance; both smoke
                   configs placed, card against CPU; (f) no kernel on the
                   path; (g) seamless's full config split over ``model``
                   (the smoke config's tensor parallelism: heads, d_ff
                   and the vocabulary over ``model``, rows over
                   ``data``) at full depth: (a) and (c) on (4, 2) with
                   the decode step's top device events, (d) on (2, 2),
                   (e) at 1 + 1 layers with every greedy token placed ==
                   unsharded in float32, and its smoke config card
                   against CPU;
 26. report      — one JSON line of the kernels (launches on the paths that
                   run them, errors, bounds; ``ms``, ``plain_ms`` and
                   ``library_ms`` are device times, ``call_ms`` the event
                   pair's; device events a call), the card's name and
                   power limit, and a last line
                   ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when there is no CUDA card, when the
port's sources are not beside this script, or when any check fails.  The
full record is also written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
L2_BYTES = 50e6  # H100 L2 cache
REPS = 20
DEVICE_CALLS = 20  # calls a device_ms profile averages over

KERNELS = {  # name → (source in the repo, the TPU kernel it replaces)
    "pack_and_histogram": ("src/repro_torch/kernels/csrc/sort_keys.cu",
                           "src/repro/kernels/sort_keys/kernel.py:62"),
    "gather_rows": ("src/repro_torch/kernels/csrc/marshal.cu",
                    "src/repro/kernels/marshal/kernel.py:83"),
    "unmarshal": ("src/repro_torch/kernels/csrc/marshal.cu",
                  "src/repro/kernels/marshal/kernel.py:140"),
    "rk4_step": ("src/repro_torch/kernels/csrc/rk4_advect.cu",
                 "src/repro/kernels/rk4_advect/kernel.py:63"),
    "rank_and_histogram": ("src/repro_torch/kernels/csrc/bucket_scatter.cu",
                           "src/repro/kernels/bucket_scatter/kernel.py:82"),
    "scatter_rows": ("src/repro_torch/kernels/csrc/bucket_scatter.cu",
                     "src/repro/kernels/bucket_scatter/kernel.py:147"),
    "compact_positions": ("src/repro_torch/kernels/csrc/compact.cu",
                          "src/repro/kernels/compact/kernel.py:43"),
    "marshal": ("src/repro_torch/kernels/csrc/marshal.cu",
                "src/repro/kernels/marshal/kernel.py:50"),
    "pairwise_accel": ("src/repro_torch/kernels/csrc/nbody_forces.cu",
                       "src/repro/kernels/nbody_forces/kernel.py:41"),
    "track": ("src/repro_torch/kernels/csrc/delta_tracking.cu",
              "src/repro/kernels/delta_tracking/kernel.py:64"),
}
# the paths whose launches the report counts, per kernel (each path is run
# with the counts set to 0 just before it and read just after)
LOSSLESS_PATHS = tuple(
    [f"lossless_flat_{m}" for m in ("sort", "scatter")]
    + [f"hier_round_{t}_{m}" for t in ("2x4", "2x2x2") for m in ("sort", "scatter")]
    + [f"lossless_hier_{t}" for t in ("2x4", "2x2x2")]
)
TELEMETRY_PATHS = tuple(
    [f"telemetry_round_{t}_{m}" for t in ("flat", "2x2x2") for m in ("sort", "scatter")]
    + [f"telemetry_retain_{m}" for m in ("sort", "scatter")] + ["autotune_padded", "autotune_hierarchical"]
)
PIPELINE_PATHS = tuple(
    [f"pipeline_flat_{m}_S{n}" for m in ("sort", "scatter") for n in (2, 4)]
    + [f"pipeline_retain_seed_{m}_S4" for m in ("sort", "scatter")]
    + [f"pipeline_2x2x2_{m}_S2" for m in ("sort", "scatter")]
)
_LAYOUTS = ("2x4", "2x2x2")
CREDIT_PATHS = tuple(
    [f"credit_twin_{n}_{m}" for n in ("sustained_overload", "incast_collapse") for m in ("sort", "scatter", "sort_S2")]
    + ["credit_twin_big"]
    + [f"credit_{k}_{n}" for k in ("open", "full") for n in ("incast_collapse", "sustained_overload")]
    + [f"credit_fit_{t}_{m}" for t in ("flat",) + _LAYOUTS for m in ("sort", "scatter")]
    + [f"credit_round_{t}_{m}" for t in ("flat",) + _LAYOUTS for m in ("sort", "scatter")]
)
BALANCE_PATHS = tuple(
    [f"balance_{k}_{m}" for k in ("masked", "brownout") for m in ("sort", "scatter")]
    + [f"balance_rebalance_{v}" for v in ("global_flat",) + tuple(f"{s}_{t}" for t in _LAYOUTS
                                                                    for s in ("global", "intra")) + ("evacuate_flat",)]
    + [f"balance_cycle_{m}_{o}" for m in ("sort", "scatter") for o in ("drop", "retain")]
)
RECOVERY_PATHS = ("recovery", "recovery_elastic", "recovery_credit")
OBS_PATHS = tuple(
    [f"obs_phases_{c}" for c in ("flat_sort", "flat_scatter", "flat_S2", "flat_S4", "2x4", "2x2x2")]
    + [f"obs_{w}{t}" for w in ("round", "drive") for t in ("", "_traced")]
)
RAGGED_PATHS = tuple(
    [f"ragged_{w}_{m}" for w in ("round", "phases") for m in ("sort", "scatter")]
    + [f"ragged_drive_{f}" for f in ("open", "credit")] + ["ragged_streamlines"]
)
ROUND_PATHS = (LOSSLESS_PATHS + TELEMETRY_PATHS + PIPELINE_PATHS + CREDIT_PATHS + BALANCE_PATHS + RECOVERY_PATHS
               + OBS_PATHS + RAGGED_PATHS)
APP_PATHS = ("streamlines", "nbody", "lander", "schlieren")  # the sort-marshal apps: K3, K1, K2, K6
# the MoE dispatch rounds of the LM paths (phase moe_shard's on placed parameters): K6, K3, K1, K2
LM_PATHS = ("lm_serve", "lm_prefill", "lm_train", "moe_shard")
# every run on the torch.distributed backend (NCCL, a world of one): phase
# dist's round, streamlines and N-body; phase dist_paths' drives, tuner,
# phases, apps and LM steps
DIST_PATHS = ("dist", "dist_paths")
LAUNCH_PATHS = {
    "pack_and_histogram": APP_PATHS + ROUND_PATHS + LM_PATHS + DIST_PATHS,
    "gather_rows": APP_PATHS + ROUND_PATHS + LM_PATHS + DIST_PATHS,
    "unmarshal": APP_PATHS + ("vopat",) + ROUND_PATHS + LM_PATHS + DIST_PATHS,
    "rk4_step": ("streamlines", "ragged_streamlines") + DIST_PATHS,
    "compact_positions": APP_PATHS + ("vopat",) + ROUND_PATHS + LM_PATHS + DIST_PATHS,
    "rank_and_histogram": ("vopat",) + ROUND_PATHS + DIST_PATHS, "scatter_rows": ("vopat",) + ROUND_PATHS + DIST_PATHS,
    "marshal": ("two_pass_marshal",),
    "pairwise_accel": ("nbody",) + DIST_PATHS, "track": ("woodcock_check",),
}

FAILURES: list = []


def check(cond: bool, what: str) -> bool:
    print(f"  check {'ok  ' if cond else 'FAIL'} {what}", flush=True)
    if not cond:
        FAILURES.append(what)
    return cond


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up: one
    event pair around one call, so the span also holds the host's issue
    time (allocations, the library load, the ``ctypes`` call) whenever the
    card waits on it.  Reported as ``call_ms``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof):
    """Device-side events of a profile (kernels, copies, fills, memsets):
    an aten op's own entry repeats the device time of the kernels it
    launched, so only these are summed."""
    import torch

    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def _short(key: str) -> str:
    """A device event's name without its argument list."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0][:90] if not key.startswith("Mem") else key


def device_ms(fn, calls: int = DEVICE_CALLS, warmup: int = 3, attempts: int = 3):
    """Device time of one call of ``fn``: ``calls`` back-to-back calls after
    warm-up under ``torch.profiler``; for every device event (kernels,
    fills, memsets, copies) its mean ``self_device_time_total`` times its
    launches a call, summed.  The host's issue time is left out.  The
    profiler may miss a few of an event's launches (on the H100 it
    recorded 15 to 19 of 20 in some profiles), so launches a call are the
    recorded count over ``calls`` rounded, and at least 1.  Returns ``(ms,
    events)``, ``events`` the launches a call by event name.  A profile
    that recorded no device event is taken again, up to ``attempts`` times
    in all; after that the calls are timed between one CUDA event pair (an
    upper bound: it also holds any host time the card waits on) and
    ``events`` is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        stats = [e for e in _device_events(prof) if e.count > 0]
        if sum(e.self_device_time_total for e in stats) > 0:
            break
    else:
        print(f"  device_ms: the profiler saw no device time in {attempts} profiles; timing "
              f"{calls} calls between one CUDA event pair instead", flush=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls, None
    us, events = 0.0, {}
    for e in stats:
        per_call = max(1, round(e.count / calls))
        us += e.self_device_time_total / e.count * per_call
        events[_short(e.key)] = events.get(_short(e.key), 0) + per_call
        if e.count != per_call * calls:
            print(f"  device_ms: the profiler recorded {e.count} launches of {_short(e.key)} "
                  f"in {calls} calls; counted {per_call} a call", flush=True)
    return us / 1e3, events


def kernels_a_call(events):
    """Kernel launches a call among ``device_ms``'s events (copies and
    memsets are not kernels); None where the profiler recorded none."""
    return None if events is None else sum(v for k, v in events.items() if not k.startswith("Mem"))


def _timed(timer, dtimer, kernel, plain, library=None, *, reps=REPS, calls=DEVICE_CALLS, warmup=3):
    """The kernel's wrapper, its plain version and the library call (where
    there is one), each timed by the event pair (``call_ms``,
    ``plain_call_ms``, ``library_call_ms``) and by device time
    (``device_ms``, ``events``, and the same with the prefixes)."""
    out = {}
    for pre, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:
            out.update({f"{pre}call_ms": None, f"{pre}device_ms": None, f"{pre}events": None})
            continue
        out[f"{pre}call_ms"] = timer(fn, reps=reps, warmup=warmup)
        out[f"{pre}device_ms"], out[f"{pre}events"] = dtimer(fn, calls=calls, warmup=warmup)
    return out


def bound_ms(nbytes: float, ops: float = 0.0):
    """Least time for the work on the card: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- 1. kernels
def _fig8_dest(gen, R, C, dev):
    """Uniform destinations with ~6% DISCARD lanes."""
    import torch

    dest = torch.randint(0, R, (R, C), generator=gen, device=dev, dtype=torch.int32)
    discard = torch.rand((R, C), generator=gen, device=dev) < 0.06
    return torch.where(discard, -1, dest)


def phase_kernels(dev, R=8, C=262144, S=65536, W=11, N_PART=2097152,
                  MASKS=((8, 131072), (8, 1048576)), NBODY=(8, 262144, 262288), SAMPLE=4096,
                  RAYS=1024, K2_VOPAT=(8, 8, 1048576, 15), K4_VOPAT=(8, 1048576),
                  K8_STREAMLINES=1048576, timer=cuda_ms, dtimer=device_ms):
    import torch

    from repro_torch import kernels as KN
    from repro_torch.core import stages as ST
    from repro_torch.kernels.bucket_scatter import ops as BS
    from repro_torch.kernels.compact import ops as CO
    from repro_torch.kernels.marshal import ops as MO
    from repro_torch.kernels.rk4_advect import ops as RO
    from repro_torch.kernels.sort_keys import ops as SO

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {}
    T = lambda *fns: _timed(timer, dtimer, *fns)

    # K3: dest (R, C) with DISCARD, out-of-range lanes and count < C on some ranks
    dest = _fig8_dest(gen, R, C, dev)
    dest[:, ::997] = R + 3
    count = torch.full((R,), C, dtype=torch.int32, device=dev)
    count[1::3] = C - 12345
    ib = max(1, (C - 1).bit_length())
    k_keys, k_hist = SO.pack_and_histogram(dest, count, num_ranks=R, idx_bits=ib)
    p_keys, p_hist = SO.pack_and_histogram_plain(dest, count, num_ranks=R, idx_bits=ib)
    ok = torch.equal(k_keys, p_keys) and torch.equal(k_hist, p_hist)
    check(ok, f"K3 pack_and_histogram dest {tuple(dest.shape)}: keys and histogram bit-equal to plain")
    # the function writes 4-byte uint32 keys: the bound counts those; the
    # kernel writes them widened to int64 for torch.sort (printed beside)
    nbytes = dest.numel() * 4 + count.numel() * 4 + k_keys.numel() * 4 + k_hist.numel() * 4
    int64_bytes = nbytes + k_keys.numel() * 4
    print(f"  pack_and_histogram: bound counts 4-byte keys ({nbytes} B); with the "
          f"int64 keys it writes, {int64_bytes} B = {bound_ms(int64_bytes)[0]:.4f} ms", flush=True)
    rows["pack_and_histogram"] = dict(
        max_abs_err=0.0 if ok else float((k_keys - p_keys).abs().max()),
        **T(lambda: SO.pack_and_histogram(dest, count, num_ranks=R, idx_bits=ib),
            lambda: SO.pack_and_histogram_plain(dest, count, num_ranks=R, idx_bits=ib)),
        nbytes=nbytes, ops=0.0,
        library_call=None, int64_key_bytes=int64_bytes,
    )

    # K1: the forward round's composed send gather
    src = torch.randint(-2**31, 2**31 - 1, (R, C, W), generator=gen, device=dev, dtype=torch.int32)
    count_full = torch.full((R,), C, dtype=torch.int32, device=dev)
    perm, _, hist = SO.sort_permutation(_fig8_dest(gen, R, C, dev), count_full, R)
    idx = ST.send_rows(perm, hist[:, :R], peer_capacity=S)  # (R, R·S)
    k_out = MO.gather_rows(src, idx)
    p_out = MO.gather_rows_plain(src, idx)
    b_idx, idx_long = torch.arange(R, device=dev)[:, None], idx.long()
    lib_out = src[b_idx, idx_long]
    ok = torch.equal(k_out, p_out) and torch.equal(lib_out, p_out)
    check(ok, f"K1 gather_rows src {tuple(src.shape)} idx {tuple(idx.shape)}: bit-equal to plain")
    uniq = sum(int(torch.unique(idx[r]).numel()) for r in range(R))
    nbytes = idx.numel() * 4 + uniq * W * 4 + k_out.numel() * 4
    rows["gather_rows"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: MO.gather_rows(src, idx), lambda: MO.gather_rows_plain(src, idx),
            lambda: src[b_idx, idx_long]),
        nbytes=nbytes, ops=0.0,
        library_call="advanced indexing src[b, idx]",
    )
    del k_out, p_out, lib_out, src

    # K2: received blocks, rank 0's counts overflow the capacity
    recv = torch.randint(-2**31, 2**31 - 1, (R, R, S, W), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.randint(S // 3, S // 2, (R, R), generator=gen, device=dev, dtype=torch.int32)
    counts[0] = S  # 8 full blocks = 2·C rows into rank 0: half are cut
    off = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    k_out = MO.unmarshal(recv, off, counts, capacity=C)
    p_out = MO.unmarshal_plain(recv, off, counts, capacity=C)
    s_ar = torch.arange(S, device=dev)
    dst = off[:, :, None].long().clamp(0, C) + s_ar
    keep = (s_ar < counts[:, :, None]) & (dst < C)
    dst = torch.where(keep, dst, C).reshape(R, R * S)
    bb = torch.arange(R, device=dev)[:, None].expand(R, R * S)
    flat = recv.reshape(R, R * S, W)

    def library():
        out = torch.zeros(R, C + 1, W, dtype=torch.int32, device=dev)
        return out.index_put_((bb, dst), flat)

    ok = torch.equal(k_out, p_out) and torch.equal(library()[:, :C], p_out)
    check(ok, f"K2 unmarshal recv {tuple(recv.shape)} capacity {C}, rank 0 overflowing: bit-equal to plain")
    landed = int(keep.sum())
    check(landed < int(counts.sum()), f"K2 input really overflows: {int(counts.sum())} rows offered, {landed} land")
    nbytes = landed * W * 4 + 2 * off.numel() * 4 + k_out.numel() * 4
    rows["unmarshal"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: MO.unmarshal(recv, off, counts, capacity=C),
            lambda: MO.unmarshal_plain(recv, off, counts, capacity=C), library),
        nbytes=nbytes, ops=0.0,
        library_call="zeros + index_put_ at precomputed positions",
    )
    _one_launch("unmarshal", "unmarshal_kernel", rows["unmarshal"]["events"], dev)
    # the retain round's compaction: offsets shifted by a spill front inside
    # (0, C) on six ranks, at C and past it on two (nothing lands there)
    front = torch.randint(1, C, (R,), generator=gen, device=dev, dtype=torch.int32)
    front[2], front[5] = C, C + 4096
    k_f = MO.unmarshal(recv, off + front[:, None], counts, capacity=C)
    p_f = MO.unmarshal_plain(recv, off + front[:, None], counts, capacity=C)
    below = torch.arange(C, device=dev)[None, :] < front[:, None]
    check(torch.equal(k_f, p_f) and not bool(k_f[below].any()) and not bool(k_f[[2, 5]].any()),
          f"K2 unmarshal with a spill front (fronts {front.tolist()}): bit-equal to plain, rows below "
          "the front zero, nothing lands at or past capacity")
    del k_out, p_out, k_f, p_f, recv, flat, dst, bb, keep
    rows["unmarshal"]["vopat_shape"] = _kernel_k2_at(dev, gen, timer, dtimer, *K2_VOPAT)

    # K8: all three fields; the ABC timing goes in the report
    pos = torch.rand((N_PART, 3), generator=gen, device=dev) * 6.283185307179586
    errs = []
    for fid, name in ((RO.ABC, "ABC"), (RO.TORNADO, "tornado"), (RO.TAYLOR_GREEN, "Taylor-Green")):
        kn, kv = RO.rk4_step(pos, dt=0.1, field_id=fid)
        pn, pv = RO.rk4_step_plain(pos, dt=0.1, field_id=fid)
        err = max(float((kn - pn).abs().max()), float((kv - pv).abs().max()))
        errs.append(err)
        check(err <= 1e-5, f"K8 rk4_step pos {tuple(pos.shape)} {name}: max abs diff {err:.3e} <= 1e-5")
        # each particle in another thread, slot and alignment: the streamlines oracle's need
        same = all(torch.equal(a, b[k:]) for k in (1, 2, 3)
                   for a, b in zip(RO.rk4_step(pos[k:], dt=0.1, field_id=fid), (kn, kv)))
        check(same, f"K8 {name}: rk4_step(pos[k:]) == rk4_step(pos)[k:] bit for bit, k = 1, 2, 3")
    rows["rk4_step"] = dict(
        max_abs_err=max(errs),
        **T(lambda: RO.rk4_step(pos, dt=0.1, field_id=RO.ABC),
            lambda: RO.rk4_step_plain(pos, dt=0.1, field_id=RO.ABC)),
        **_k8_work(N_PART), library_call=None,
    )
    del pos, kn, kv, pn, pv
    rows["rk4_step"]["streamlines_shape"] = _kernel_k8_at(dev, gen, timer, dtimer, K8_STREAMLINES)
    # K4: the scatter plan, on K3's destinations (DISCARD, out-of-range
    # lanes, count < C on some ranks)
    k4 = BS.rank_and_histogram(dest, count, num_ranks=R)
    p4 = BS.rank_and_histogram_plain(dest, count, num_ranks=R)
    ok = all(torch.equal(a, b) for a, b in zip(k4, p4))
    check(ok, f"K4 rank_and_histogram dest {tuple(dest.shape)}: d_clean, rank and histogram bit-equal to plain")
    rows["rank_and_histogram"] = dict(
        max_abs_err=0.0 if ok else float(max((a - b).abs().max() for a, b in zip(k4, p4))),
        **T(lambda: BS.rank_and_histogram(dest, count, num_ranks=R),
            lambda: BS.rank_and_histogram_plain(dest, count, num_ranks=R)),
        nbytes=dest.numel() * 4 * 3 + count.numel() * 4 + k4[2].numel() * 4,
        ops=0.0, library_call=None,
    )
    _one_launch("rank_and_histogram", "rank_hist_kernel", rows["rank_and_histogram"]["events"], dev)
    rows["rank_and_histogram"]["vopat_shape"] = _kernel_k4_at(dev, gen, timer, dtimer, *K4_VOPAT)

    # K5: the scatter marshal's send pass at the round's positions
    # d_clean·S + rank (rank >= S and invalid lanes dropped)
    src = torch.randint(-2**31, 2**31 - 1, (R, C, W), generator=gen, device=dev, dtype=torch.int32)
    d_clean, rank, _ = k4
    keep = (d_clean < R) & (rank < S)
    dstpos = torch.where(keep, d_clean * S + rank, R * S)
    k_out = BS.scatter_rows(src, dstpos, num_slots=R * S)
    p_out = BS.scatter_rows_plain(src, dstpos, num_slots=R * S)
    bb, pos_long = torch.arange(R, device=dev)[:, None].expand(R, C), dstpos.long()

    def library_k5():
        out = torch.zeros(R, R * S + 1, W, dtype=torch.int32, device=dev)
        return out.index_put_((bb, pos_long), src)

    ok = torch.equal(k_out, p_out) and torch.equal(library_k5()[:, :R * S], p_out)
    check(ok, f"K5 scatter_rows src {tuple(src.shape)} -> {tuple(k_out.shape)}: bit-equal to plain")
    landed = int(keep.sum())
    rows["scatter_rows"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: BS.scatter_rows(src, dstpos, num_slots=R * S),
            lambda: BS.scatter_rows_plain(src, dstpos, num_slots=R * S), library_k5),
        nbytes=landed * W * 4 + dstpos.numel() * 4 + k_out.numel() * 4, ops=0.0,
        library_call="zeros + index_put_ at the positions",
    )
    del k_out, p_out

    # K6: emit masks of the streamlines shape and of the VoPaT shape; the
    # last (VoPaT's) goes in the report, each one is kept under at_shapes
    at_shapes = {}
    for shape in MASKS:
        mask = torch.rand(shape, generator=gen, device=dev) < 0.6
        kp, kt = CO.compact_positions(mask)
        pp, pt = CO.compact_positions_plain(mask)
        ok = torch.equal(kp, pp) and torch.equal(kt, pt)
        check(ok, f"K6 compact_positions mask {shape}: positions and totals bit-equal to plain")
        r = dict(
            max_abs_err=0.0 if ok else float((kp - pp).abs().max()),
            **T(lambda: CO.compact_positions(mask), lambda: CO.compact_positions_plain(mask),
                lambda: torch.cumsum(mask, dim=1, dtype=torch.int32)),
            nbytes=mask.numel() * (1 + 4) + kt.numel() * 4, ops=0.0,
            library_call="torch.cumsum", shape=shape,
        )
        _one_launch("compact_positions", "compact_kernel", r["events"], dev)
        _print_row(f"compact_positions {shape}", r)
        at_shapes[str(shape)] = {k: v for k, v in r.items() if k != "at_shapes"}
        rows["compact_positions"] = r
    rows["compact_positions"]["at_shapes"] = at_shapes

    # K7 on the sorted Fig-8 payload.  The two-pass marshal path is timed
    # from the counts set to 0: K3 + sort, the sorted payload (K1 gathers
    # it, with an S-row tail so no segment start is clipped), K7 copies the
    # segments; it must give K1's fused send buffer on every valid row.
    KN.reset_launch_counts()
    perm, _, hist = SO.sort_permutation(dest, count, R)
    tail = torch.zeros(R, S, dtype=torch.int32, device=dev)
    sorted_buf = MO.gather_rows(src, torch.cat([perm, tail], dim=1))  # (R, C+S, W)
    off = torch.cumsum(hist[:, :R], 1, dtype=torch.int32) - hist[:, :R]
    two_pass = MO.marshal(sorted_buf, off, num_ranks=R, slot=S)
    two_pass_launches = KN.launch_counts()
    fused = ST.padded_send_buffer(src, perm, hist[:, :R], num_ranks=R, peer_capacity=S)
    valid = torch.arange(S, device=dev) < torch.clamp(hist[:, :R], max=S)[:, :, None]
    check(torch.equal(two_pass[valid], fused[valid]),
          f"K3 + sort + K7 == K1's fused marshal on the {int(valid.sum())} valid rows")
    if dev.type == "cuda":
        check(two_pass_launches["marshal"] == 1, f"two-pass marshal launched K7 once: {two_pass_launches}")
    k_out = MO.marshal(sorted_buf, off, num_ranks=R, slot=S)
    p_out = MO.marshal_plain(sorted_buf, off, num_ranks=R, slot=S)
    cap2 = sorted_buf.shape[1]
    seg = (off.long().clamp(0, cap2 - S)[:, :, None] + torch.arange(S, device=dev)).reshape(R, -1)
    seg_w = seg[:, :, None].expand(-1, -1, W)
    ok = torch.equal(k_out, p_out) and torch.equal(torch.gather(sorted_buf, 1, seg_w).reshape(k_out.shape), p_out)
    check(ok, f"K7 marshal sorted {tuple(sorted_buf.shape)} -> {tuple(k_out.shape)}: bit-equal to plain")
    read = torch.zeros(R, cap2, dtype=torch.bool, device=dev).scatter_(1, seg, True)
    rows["marshal"] = dict(
        max_abs_err=0.0 if ok else float((k_out - p_out).abs().max()),
        **T(lambda: MO.marshal(sorted_buf, off, num_ranks=R, slot=S),
            lambda: MO.marshal_plain(sorted_buf, off, num_ranks=R, slot=S),
            lambda: torch.gather(sorted_buf, 1, seg_w)),
        nbytes=int(read.sum()) * W * 4 + off.numel() * 4 + k_out.numel() * 4, ops=0.0,
        library_call="torch.gather at the segment rows",
    )
    del k_out, p_out, two_pass, fused, sorted_buf, src

    rows["pairwise_accel"] = _kernel_k9(dev, gen, timer, dtimer, *NBODY, SAMPLE)
    KN.reset_launch_counts()
    rows["track"], woodcock_launches = _kernel_k10(dev, gen, timer, dtimer, RAYS)

    for name, r in rows.items():
        _print_row(name, r)
    return rows, {"two_pass_marshal": two_pass_launches, "woodcock_check": woodcock_launches}


def _print_row(name, r):
    """Bound, L2 state and one line of times: device ms (call ms) of the
    kernel, its plain version and the library call."""
    r["bound_ms"], r["bound_by"] = bound_ms(r["nbytes"], r["ops"])
    r["l2_warm"] = r["nbytes"] <= L2_BYTES  # back-to-back calls find the working set in L2
    fmt = lambda pre: ("n/a" if r[f"{pre}device_ms"] is None
                       else f"{r[f'{pre}device_ms']:.4f} ({r[f'{pre}call_ms']:.4f})")
    print(f"  {name}: device ms (call ms) kernel {fmt('')} plain {fmt('plain_')} library "
          f"{fmt('library_')}; bound {r['bound_ms']:.4f} ({r['bound_by']}: {r['nbytes']} B, "
          f"{r['ops']:.0f} ops; L2-{'warm' if r['l2_warm'] else 'cold'}); "
          f"{kernels_a_call(r['events'])} kernels a call {r['events']}; "
          f"max_abs_err {r['max_abs_err']:.3e}", flush=True)


def _one_launch(name, kernel, events, dev):
    """The wrapper ``name`` made one launch of its CUDA ``kernel`` a call, at
    most one memset, and no other device work (no fill kernel)."""
    if dev.type != "cuda":
        return
    if events is None:
        check(False, f"{name}: launches a call not seen (the profiler recorded no device event)")
        return
    kern = {k: v for k, v in events.items() if not k.startswith("Mem")}
    memset = sum(v for k, v in events.items() if k.startswith("Memset"))
    other = sum(v for k, v in events.items() if k.startswith("Memcpy"))
    check(len(kern) == 1 and kernel in next(iter(kern)) and next(iter(kern.values())) == 1
          and memset <= 1 and other == 0,
          f"{name}: one kernel launch a call, at most one memset, no fill: {events}")


def _kernel_k2_at(dev, gen, timer, dtimer, B, G, S, W):
    """K2 at VoPaT's shape (capacity S): counts uniform in [0, S/4), about
    S rows offered a rank, so some ranks overflow; bit-equal to plain, and
    the kernel's times beside its bound."""
    import torch

    from repro_torch.kernels.marshal import ops as MO

    recv = torch.randint(-2**31, 2**31 - 1, (B, G, S, W), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.randint(0, S // 4, (B, G), generator=gen, device=dev, dtype=torch.int32)
    off = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    ok = torch.equal(MO.unmarshal(recv, off, counts, capacity=S),
                     MO.unmarshal_plain(recv, off, counts, capacity=S))
    check(ok, f"K2 unmarshal recv {(B, G, S, W)} capacity {S}: bit-equal to plain")
    landed = int(torch.clamp(counts.sum(1), max=S).sum())
    r = dict(max_abs_err=0.0 if ok else float("nan"), shape=(B, G, S, W), offered=int(counts.sum()),
             **_timed(timer, dtimer, lambda: MO.unmarshal(recv, off, counts, capacity=S), None),
             nbytes=landed * W * 4 + 2 * counts.numel() * 4 + B * S * W * 4, ops=0.0)
    _print_row(f"unmarshal at {(B, G, S, W)}", r)
    return r


def _k8_work(n):
    """K8's bytes (12 B read, 24 B written a particle) and float32
    operations: per particle 4 velocity evaluations of 6 sin/cos + 9 flops
    (ABC), 18 flops forming the stage inputs, 21 in the final combination."""
    return dict(nbytes=n * 12 + 2 * n * 12, ops=n * (4 * 15 + 18 + 21))


def _kernel_k8_at(dev, gen, timer, dtimer, n):
    """K8 at the streamlines drive's shape (8 ranks x 131,072 particles):
    ABC within 1e-5 of plain, and the kernel's times beside its bound."""
    import torch

    from repro_torch.kernels.rk4_advect import ops as RO

    pos = torch.rand((n, 3), generator=gen, device=dev) * 6.283185307179586
    err = max(float((a - b).abs().max()) for a, b in
              zip(RO.rk4_step(pos, dt=0.1), RO.rk4_step_plain(pos, dt=0.1)))
    check(err <= 1e-5, f"K8 rk4_step pos {(n, 3)} ABC: max abs diff {err:.3e} <= 1e-5")
    r = dict(max_abs_err=err, shape=(n, 3), **_timed(timer, dtimer, lambda: RO.rk4_step(pos, dt=0.1), None),
             **_k8_work(n))
    _print_row(f"rk4_step at {(n, 3)}", r)
    return r


def _kernel_k4_at(dev, gen, timer, dtimer, B, C):
    """K4 at VoPaT's shape (the scatter marshal's plan of its 1,048,576-lane
    queues): Fig-8-like destinations, count < C on some rows; bit-equal to
    plain, one launch a call, and the kernel's times beside its bound."""
    import torch

    from repro_torch.kernels.bucket_scatter import ops as BS

    dest = _fig8_dest(gen, B, C, dev)
    count = torch.full((B,), C, dtype=torch.int32, device=dev)
    count[1::3] = C // 3
    got = BS.rank_and_histogram(dest, count, num_ranks=B)
    ok = all(torch.equal(a, b) for a, b in zip(got, BS.rank_and_histogram_plain(dest, count, num_ranks=B)))
    check(ok, f"K4 rank_and_histogram dest {(B, C)}: d_clean, rank and histogram bit-equal to plain")
    r = dict(max_abs_err=0.0 if ok else float("nan"), shape=(B, C),
             **_timed(timer, dtimer, lambda: BS.rank_and_histogram(dest, count, num_ranks=B), None),
             nbytes=dest.numel() * 4 * 3 + count.numel() * 4 + got[2].numel() * 4, ops=0.0)
    _one_launch(f"rank_and_histogram at {(B, C)}", "rank_hist_kernel", r["events"], dev)
    _print_row(f"rank_and_histogram at {(B, C)}", r)
    return r


def _kernel_k9(dev, gen, timer, dtimer, B, N, M, sample, eps2=1e-3):
    """K9 at the nbody path's shape: B ranks × N targets (every rank's queue
    capacity) against M = N + 2·72 sources (the local lanes, the roots and
    the octants), positions drawn like the app's (0.5 ± 0.15, clipped), the
    last 144 sources spread over the box with octant-sized masses or none.
    K9 and the float32 plain version are held against a float64 evaluation
    of the first ``sample`` targets of ranks 0 and B-1: per component, the
    error over the row's sum of |terms| must be at most 1e-5, and K9's at
    most 2× the plain version's."""
    import torch

    from repro_torch.kernels.nbody_forces import ops as NO

    xi = torch.clamp(0.5 + 0.15 * torch.randn((B, N, 3), generator=gen, device=dev), 0.05, 0.95)
    extra = M - N
    xj = torch.cat([xi, torch.rand((B, extra, 3), generator=gen, device=dev)], dim=1)
    m_far = (N / 64) * (0.5 + torch.rand((B, extra), generator=gen, device=dev))
    m_far[:, extra // 2:] = 0.0
    mj = torch.cat([0.5 + torch.rand((B, N), generator=gen, device=dev), m_far], dim=1)
    got = NO.pairwise_accel(xi, xj, mj, eps2=eps2)
    rows = [0, B - 1]
    sx, sj, sm = xi[rows, :sample], xj[rows], mj[rows]
    plain = NO.pairwise_accel_plain(sx, sj, sm, eps2=eps2)
    want, scale = _accel_float64(sx, sj, sm, eps2)
    k_err = ((got[rows, :sample].double() - want).abs() / scale).max().item()
    p_err = ((plain.double() - want).abs() / scale).max().item()
    kp_err = ((got[rows, :sample] - plain).abs().double() / scale).max().item()
    max_abs = (got[rows, :sample] - plain).abs().max().item()
    print(f"  K9 against float64 on {len(rows)}x{sample} targets x {M} sources: error / sum|terms| "
          f"K9 {k_err:.3e}, plain {p_err:.3e}, K9 - plain {kp_err:.3e} (max abs {max_abs:.3e})", flush=True)
    check(bool(torch.isfinite(got).all()), f"K9 pairwise_accel ({B}, {N}) x ({B}, {M}): finite")
    check(k_err <= 1e-5 and p_err <= 1e-5,
          "K9 and its plain version within 1e-5 of the float64 sum (relative to sum|terms|)")
    check(k_err <= 2 * p_err, f"K9's error {k_err:.3e} <= 2x the plain version's {p_err:.3e}")
    return dict(
        max_abs_err=max_abs,
        **_timed(timer, dtimer, lambda: NO.pairwise_accel(xi, xj, mj, eps2=eps2),
                 lambda: NO.pairwise_accel_plain(sx, sj, sm, eps2=eps2), reps=5, warmup=1),
        plain_shape=f"({len(rows)}, {sample}) targets x ({len(rows)}, {M}) sources",
        library_call=None,
        nbytes=B * N * 12 + B * M * 16 + B * N * 12, ops=20.0 * B * N * M,
        float64_err={"kernel": k_err, "plain": p_err, "kernel_vs_plain": kp_err},
    )


def _accel_float64(xi, xj, mj, eps2, rows=64):
    """The accelerations in float64 and, per component, the sum of the
    absolute terms, a few targets at a time."""
    import torch

    xi, xj, mj = xi.double(), xj.double(), mj.double()
    acc, scale = torch.empty_like(xi), torch.empty_like(xi)
    for s in range(0, xi.shape[1], rows):
        dx = xj[:, None] - xi[:, s:s + rows, None]
        r2 = (dx * dx).sum(-1) + eps2
        terms = (mj[:, None] / (r2 * torch.sqrt(r2)))[..., None] * dx
        acc[:, s:s + rows], scale[:, s:s + rows] = terms.sum(2), terms.abs().sum(2)
    return acc, scale


def k10_inputs(dev, gen, size, steps=8):
    """K10's inputs at the VoPaT scene's shape: the ``size``² camera rays
    that enter [0,1]³, from the domain entry to the domain exit, uniforms
    ``(N, steps, 2)`` drawn from ``gen``, and the scene's 6 blobs.  Returns
    ``(args, majorant)``, ``args`` as ``track`` takes them."""
    import torch

    from repro_torch.apps import fields as F

    o, d = F.camera_rays(size, size, device=dev)
    t_in, inside = F.ray_domain_entry(o, d)
    o, d, t0 = o[inside].contiguous(), d[inside].contiguous(), t_in[inside]
    t_exit, _, _ = F.ray_box_exit(o, d, t0, torch.zeros_like(t0), torch.ones_like(t0))
    blobs = torch.from_numpy(F.default_blobs(6, 0)).to(dev)
    u = torch.rand((o.shape[0], steps, 2), generator=gen, device=dev)
    return (o, d, t0, t_exit, u, blobs), F.majorant(blobs)


def k10_work(steps_taken, blobs):
    """K10's bound inputs, counted from the steps each ray takes (the walk
    ends at the first status change): a ray reads o, d (12 B each), t0,
    t_exit and writes t, status (4 B each), and reads 8 B of uniforms a step
    it takes; 14 float32 operations a blob a step.  Returns ``(bytes, ops)``."""
    n, total = steps_taken.numel(), int(steps_taken.sum())
    return n * (12 + 12 + 4 + 4 + 4 + 4) + 8 * total + blobs.numel() * 4, float(total * blobs.shape[0] * 14)


def _kernel_k10(dev, gen, timer, dtimer, size, steps=8):
    """K10 at the VoPaT scene's shape (``k10_inputs``), K = 8 steps through
    the scene's 6 blobs.  ``t`` within rtol 1e-6 and statuses equal to the
    plain version's, except on near-ties (|u₁·μ̄ − σ| < 1e-5·μ̄ at a step the
    ray took), which must be under 0.01% of the rays.  The bound counts the
    steps the rays take in the plain version's walk (``k10_work``).  Its
    launches are those of the one checked call."""
    import torch

    from repro_torch import kernels as KN
    from repro_torch.kernels.delta_tracking import ops as DO

    args, maj = k10_inputs(dev, gen, size, steps)
    kt, ks = DO.track(*args, majorant=maj, steps=steps)
    launches = KN.launch_counts()
    pt, ps = DO.track_plain(*args, majorant=maj, steps=steps)
    tie, taken = _woodcock_near_tie(*args, maj, steps)
    n, n_tie = args[0].shape[0], int(tie.sum())
    differ = ks != ps
    t_bad = ~torch.isclose(kt, pt, rtol=1e-6, atol=0.0) & ~tie
    hist = torch.bincount(taken, minlength=steps + 1).tolist()
    nbytes, ops = k10_work(taken, args[5])
    print(f"  K10 track on {n} rays x {steps} steps: statuses differ on {int(differ.sum())} rays, "
          f"all near-ties: {not bool((differ & ~tie).any())}; near-ties {n_tie}; "
          f"statuses STILL/HIT/EXITED {[int((ps == k).sum()) for k in (0, 1, 2)]}; "
          f"steps taken over 0..{steps} {hist}, mean {int(taken.sum()) / n:.4f}, "
          f"so {nbytes / n:.2f} B a ray", flush=True)
    check(not bool((differ & ~tie).any()) and not bool(t_bad.any()),
          f"K10 track ({n} rays): t within rtol 1e-6 and statuses equal to plain but for near-ties")
    check(int(differ.sum()) < 1e-4 * n, f"K10: {int(differ.sum())} status differences < 0.01% of {n} rays")
    return dict(
        max_abs_err=(kt - pt)[~tie].abs().max().item(),
        **_timed(timer, dtimer, lambda: DO.track(*args, majorant=maj, steps=steps),
                 lambda: DO.track_plain(*args, majorant=maj, steps=steps)),
        library_call=None, nbytes=nbytes, ops=ops, rays=n, near_ties=n_tie,
        steps_histogram=hist, mean_steps=int(taken.sum()) / n,
    ), launches


def _woodcock_near_tie(o, d, t0, t_exit, u, blobs, maj, steps):
    """The plain version's walk, replayed: ``(tie, taken)``.  ``tie`` marks
    the rays that meet |u₁·μ̄ − σ| < 1e-5·μ̄ at a step where the ray is still
    tracking and inside its exit (an ulp of ``expf`` or ``log1pf`` may flip
    such a step); ``taken`` (int64) counts the steps each ray takes, those
    at which it is still tracking."""
    import torch

    from repro_torch.kernels.delta_tracking import ops as DO

    mu = torch.tensor(maj, dtype=torch.float32, device=t0.device)
    t, status = t0, torch.zeros_like(t0, dtype=torch.int32)
    tie = torch.zeros_like(t0, dtype=torch.bool)
    taken = torch.zeros_like(t0, dtype=torch.int64)
    for k in range(steps):
        active = status == DO.STILL
        taken += active
        t_new = t - torch.log1p(-u[:, k, 0]) / mu
        sigma = DO.density(o + t_new[:, None] * d, blobs)
        inside = active & (t_new < t_exit)
        tie |= inside & ((u[:, k, 1] * mu - sigma).abs() < 1e-5 * mu)
        hit = inside & (u[:, k, 1] * mu < sigma)
        t = torch.where(active, t_new, t)
        status = torch.where(active & ~inside, DO.EXITED, torch.where(hit, DO.HIT, status)).to(torch.int32)
    return tie, taken


# --------------------------------------------------------------- 2. forward
def _ray44_types():
    import dataclasses

    import torch

    from repro_torch.core import work_item

    @work_item
    @dataclasses.dataclass
    class Ray44:
        """The paper's Fig-8 payload: a 44-byte ray (11 × f32/i32)."""

        origin: torch.Tensor
        direction: torch.Tensor
        tmin: torch.Tensor
        pixel: torch.Tensor
        integral: torch.Tensor
        extra: torch.Tensor

    return Ray44


def _same_queue(a, b, *, all_lanes: bool) -> bool:
    import torch

    from repro_torch.core import types as T

    if not (torch.equal(a.count.cpu(), b.count.cpu()) and torch.equal(a.drops.cpu(), b.drops.cpu())):
        return False
    pa, _ = T.pack_payload(a.items, batch_dims=2)
    pb, _ = T.pack_payload(b.items, batch_dims=2)
    pa, pb = pa.cpu(), pb.cpu()
    if all_lanes:
        return torch.equal(pa, pb)
    lane = torch.arange(pa.shape[1])
    mask = lane[None, :] < a.count.cpu()[:, None]
    return torch.equal(pa[mask], pb[mask])


def phase_forward(dev, R=8, C=262144, S=65536, reps=10, timer_events=True):
    from repro_torch import kernels as KN
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work

    q = _fig8_queue(dev, R, C)
    cfg = ForwardConfig(R, C, peer_capacity=S)
    comm = StackedCollectives()
    KN.reset_launch_counts()
    new_q, total = forward_work(q, cfg, comm=comm)
    launches = KN.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(pack_and_histogram=1, gather_rows=1, unmarshal=1)
    if dev.type == "cuda":
        check(launches == want, f"one padded round launched K3, K1, K2 once each: {launches}")
    kinds = sorted((c.kind, c.shape) for c in comm.calls.elements())
    check(kinds == sorted([("all_to_all", (R, R, 1)), ("all_to_all", (R, R, S, 11)), ("psum", (R,))]),
          f"call recorder: one payload and one count all_to_all + the psum: {kinds}")

    oq, ototal = forward_work(q, ForwardConfig(R, C, exchange="onehot"))
    check(_same_queue(new_q, oq, all_lanes=False) and int(total) == int(ototal),
          f"padded round == onehot oracle on {dev.type}: count, drops, total {int(total)}, lanes < count")
    cq, ctotal = forward_work(_to_cpu(q), cfg)
    check(_same_queue(new_q, cq, all_lanes=True) and int(total) == int(ctotal),
          "round on the card == the same round on the CPU (plain versions), every lane")
    print(f"  round: {R}x{C} rays of 44 B, S={S}: delivered {int(total)}, "
          f"drops {int(new_q.drops.sum())}", flush=True)

    # the scatter round: K4 plans, K5 marshals, K2 compacts; no K1, no K3
    scfg = ForwardConfig(R, C, peer_capacity=S, marshal="scatter")
    scomm = StackedCollectives()
    KN.reset_launch_counts()
    sq, stotal = forward_work(q, scfg, comm=scomm)
    launches = KN.launch_counts()
    if dev.type == "cuda":
        want = dict.fromkeys(launches, 0)
        want.update(rank_and_histogram=1, scatter_rows=1, unmarshal=1)
        check(launches == want, f"one scatter round launched K4, K5, K2 once each and no K1, K3: {launches}")
    skinds = sorted((c.kind, c.shape) for c in scomm.calls.elements())
    check(skinds == kinds, f"scatter round: one payload and one count all_to_all + the psum: {skinds}")
    check(_same_queue(sq, new_q, all_lanes=False) and int(stotal) == int(total),
          "scatter round == sort round: count, drops, total, lanes < count")
    check(_same_queue(sq, oq, all_lanes=False) and int(stotal) == int(ototal),
          "scatter round == onehot oracle: count, drops, total, lanes < count")

    if not timer_events:
        return {"delivered": int(total)}
    out = {"delivered": int(total)}
    for label, c in (("sort", cfg), ("scatter", scfg)):
        whole, split = _time_round(q, c, reps)
        out[label] = {"round_ms": whole, "stages_ms": split}
        print(f"  {label} round median {whole:.3f} ms; stages of forward_work (median ms, sum "
              f"{sum(split.values()):.3f}): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
              flush=True)
    return out


def _print_split(label, whole, split):
    print(f"  {label}: median {whole:.3f} ms; stages (median ms, sum {sum(split.values()):.3f}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)


def _time_round(q, cfg, reps):
    """Median round time, then the stage split of the same ``forward_work``
    call, with a CUDA event recorded at each stage boundary (``on_stage``)."""
    import torch

    from repro_torch.core import forward_work

    whole = cuda_ms(lambda: forward_work(q, cfg), reps=reps)
    splits, marked = {}, []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marked.append((name, ev))

    for i in range(reps + 3):
        marked.clear()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        forward_work(q, cfg, on_stage=mark)
        marked[-1][1].synchronize()
        if i >= 3:
            prev = start
            for name, ev in marked:
                splits.setdefault(name, []).append(prev.elapsed_time(ev))
                prev = ev
    return whole, {k: statistics.median(v) for k, v in splits.items()}


# -------------------------------------------------------------- 3. lossless
def _chaos_ray_type():
    import dataclasses

    import torch

    from repro_torch.core import work_item

    @work_item
    @dataclasses.dataclass
    class ChaosRay:
        """The Fig-8 ray's 11 words, the scenario's uid in the first."""

        uid: torch.Tensor  # () i32
        ballast: torch.Tensor  # (10,) f32, derived from the uid

    return ChaosRay


def _ballast(uid):
    import torch

    return uid.to(torch.float32)[..., None] * torch.arange(1, 11, device=uid.device) * 0.25


def expected_fast(sc):
    """``chaos.expected_by_rank`` vectorised (uint64 sums wrap mod 2⁶⁴, so
    mod 2³² they agree): the full-width schedules have ~10⁷ entries."""
    import numpy as np

    d = np.asarray(sc.dests)
    R, E = sc.num_ranks, sc.emits_per_round
    uid = ((np.arange(sc.rounds)[:, None, None] * R + np.arange(R)[None, :, None]) * E
           + np.arange(E)[None, None, :]).astype(np.uint64)
    sq = (uid * uid) & np.uint64(0xFFFFFFFF)
    out = np.zeros((R, 3), np.uint64)
    for r in range(R):
        sel = d == r
        out[r] = (sel.sum(), uid[sel].sum(dtype=np.uint64), sq[sel].sum(dtype=np.uint64))
    return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)


class ScenarioDrive:
    """A schedule of ``repro_torch.chaos`` driven through ``run_until_done``'s
    pieces, as ``repro.chaos.run_scenario`` drives it: round 0's emissions
    seed the queue; body round ``rnd`` folds its arrivals into per-rank
    (count, Σuid, Σuid²) mod 2³² checksums (and counts arrivals whose
    ballast lost its bits) and emits schedule row ``rnd + 1`` (K6 under
    ``enqueue``).  ``step()`` runs one forwarding round; ``observe()`` reads
    the retained rows, their largest age, and how many of them sit on a
    rank other than their source (parked after a later tier).  With a
    telemetry config, ``result()`` and ``run()`` leave the drive's
    ``StatsRing`` in ``self.ring``.

    With ``gated`` the emitter is the credit law's (``repro.chaos.driver.
    _make_gated_round_fn``): a cursor walks the flattened schedule
    (``repro_torch.chaos.driver._flat_schedule``) and each round emits the
    due entries that fit the drive's ``headroom``.  ``health`` is a constant ``(R,) bool`` mask
    or ``forward_idx -> mask`` (forward 0 is the seed routing), re-read at
    every ``step()``; ``run()`` takes a constant mask only."""

    def __init__(self, sc, cfg, dev, *, gated=False, health=None):
        import torch

        from repro_torch.core import DISCARD, StackedCollectives, enqueue, make_queue
        from repro_torch.core import termination as TERM

        self.sc, self.cfg, self.dev, self.TERM = sc, cfg, dev, TERM
        self.gated, self.health = gated, health
        R, E, C = sc.num_ranks, sc.emits_per_round, cfg.capacity
        ChaosRay = _chaos_ray_type()
        proto = ChaosRay(uid=torch.zeros((), dtype=torch.int32), ballast=torch.zeros(10))
        dests = torch.from_numpy(sc.dests).to(dev)
        me = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
        lane = torch.arange(C, device=dev)[None, :]
        e_idx = torch.arange(E, device=dev)

        def emit(rnd):
            q = make_queue(proto, C, num_ranks=R, device=dev)
            row = dests[min(rnd, sc.rounds - 1)]
            mask = (row >= 0) & (rnd < sc.rounds)
            uid = ((rnd * R + me) * E + e_idx).to(torch.int32)
            return enqueue(q, ChaosRay(uid=uid, ballast=_ballast(uid)), torch.where(mask, row, DISCARD), mask)

        def consume(q_in, acc):
            valid = lane < q_in.count[:, None]
            u = q_in.items.uid.to(torch.int64)
            bad = (valid[:, :, None] & (q_in.items.ballast != _ballast(q_in.items.uid))).sum(1).sum(1)
            z = torch.zeros_like(u)
            acc = acc + torch.stack([valid.sum(1), torch.where(valid, u, z).sum(1),
                                     torch.where(valid, u * u, z).sum(1), bad], dim=1)
            return acc & 0xFFFFFFFF

        def round_fn(q_in, acc, rnd):
            return emit(rnd + 1), consume(q_in, acc)

        if gated:
            from repro_torch.chaos.driver import _flat_schedule

            f_dest, f_uid, prefix = (torch.from_numpy(a).to(dev) for a in _flat_schedule(sc))
            K = f_dest.shape[1]

            def round_fn(q_in, aux, rnd, headroom):
                acc, cursor = aux
                acc = consume(q_in, acc)
                n = torch.minimum(torch.clamp(prefix[:, min(rnd + 1, sc.rounds - 1)] - cursor, min=0), headroom)
                idx = (cursor[:, None] + lane).clamp(0, K - 1)
                mask = lane < n[:, None]
                uid = torch.gather(f_uid, 1, idx)
                out = enqueue(make_queue(proto, C, num_ranks=R, device=dev), ChaosRay(uid=uid, ballast=_ballast(uid)),
                              torch.where(mask, torch.gather(f_dest, 1, idx), DISCARD), mask)
                return out, (acc, (cursor + n).to(torch.int32))

            self.cursor0 = prefix[:, 0].clone()

        self.round_fn, self.emit, self.lane, self.me = round_fn, emit, lane, me
        self.comm = StackedCollectives()
        self.carry = self.ring = None

    def _aux0(self):
        import torch

        acc0 = torch.zeros(self.sc.num_ranks, 4, dtype=torch.int64, device=self.dev)
        return (acc0, self.cursor0) if self.gated else acc0

    def _mask(self, f):
        import numpy as np
        import torch

        if self.health is None:
            return None
        h = self.health(f) if callable(self.health) else self.health
        return torch.from_numpy(np.asarray(h, bool)).to(self.dev)

    def start(self):
        self.carry = self.TERM.drive_start(self.emit(0), self._aux0(), self.cfg, health=self._mask(0), comm=self.comm)

    def running(self, max_rounds=64):
        return self.carry["rnd"] < max_rounds and int(self.carry["total"]) > 0

    def step(self):
        self.carry = self.TERM.drive_segment(self.round_fn, self.carry, self.cfg, seg_end=self.carry["rnd"] + 1,
                                             health=self._mask(self.carry["rnd"] + 1), comm=self.comm)

    def observe(self):
        import torch

        q = self.carry["q"]
        held = (self.lane < q.count[:, None]) & (q.dest >= 0)
        src = (q.items.uid.to(torch.int64) // self.sc.emits_per_round) % self.sc.num_ranks
        return (int(held.sum()), int(self.carry["age"].max()), int((held & (src != self.me)).sum()))

    def result(self):
        q, aux, rounds, done, _age, *ring = self.TERM.drive_finalize(self.carry, self.cfg)
        self.ring = ring[0] if ring else None
        return self._result(q, aux, rounds, done)

    def _result(self, q, aux, rounds, done):
        import numpy as np

        acc = (aux[0] if self.gated else aux).cpu().numpy()
        res = {"delivered": acc[:, :3].astype(np.uint32), "bad_ballast": int(acc[:, 3].sum()),
               "drops": int(q.drops.sum()), "rounds": rounds, "done": done, "resident": int(q.count.sum())}
        if self.gated:
            res["emitted"] = int(aux[1].sum())
        return res

    def run(self, max_rounds=64):
        """The whole drive through ``run_until_done`` (one host sync a
        round); returns ``(result, wall seconds)``."""
        import time as _time

        import torch

        from repro_torch.core import run_until_done

        q0, aux0 = self.emit(0), self._aux0()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = _time.perf_counter()
        q, aux, rounds, done, _age, *ring = run_until_done(self.round_fn, q0, aux0, self.cfg, max_rounds=max_rounds,
                                                           health=self._mask(0))
        self.ring = ring[0] if ring else None
        res = self._result(q, aux, rounds, done)
        return res, _time.perf_counter() - t0


def _same_result(a, b) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _same_state(a, b):
    """Two drives' carries hold the same queue, drops and ages, bit for bit."""
    import torch

    from repro_torch.core import types as T

    qa, qb = a.carry["q"], b.carry["q"]
    same = (torch.equal(qa.count, qb.count) and torch.equal(qa.drops, qb.drops)
            and torch.equal(a.carry["age"], b.carry["age"]) and int(a.carry["total"]) == int(b.carry["total"]))
    if not same:
        return False
    mask = a.lane < qa.count[:, None]
    pa, _ = T.pack_payload(qa.items, batch_dims=2)
    pb, _ = T.pack_payload(qb.items, batch_dims=2)
    return torch.equal(pa[mask], pb[mask]) and torch.equal(qa.dest[mask], qb.dest[mask])


_ORACLE: dict = {}


def lossless_oracle(sc, S, C):
    """``chaos.simulate_flat_retain`` of phase ``lossless`` (a), computed once
    a process: phase ``telemetry`` holds its ring against the same run."""
    from repro_torch import chaos as TC

    key = (sc.name, sc.num_ranks, sc.emits_per_round, S, C)
    if key not in _ORACLE:
        _ORACLE[key] = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=C)
    return _ORACLE[key]


def phase_lossless(dev, R=8, C=262144, E=32768, S=8192, FIG8_S=65536, reps=10,
                   HIER_CAPS=(((2, 4), (32768, 16384)), ((2, 2, 2), (32768, 32768, 32768))),
                   oracle_numbers=(11, 246311, 3), cpu_witness=True, timer=cuda_ms, stage_split=True):
    """``overflow="retain"`` and the hierarchical route on the card:
    (a) the flat padded retain drive of ``rotating_hotspot(R, 8, E)`` in both
    marshals against the port's numpy oracle, forward for forward; (b) one
    hierarchical drop round of the Fig-8 rays on 2×4 and 2×2×2 against the
    flat onehot round and the CPU, with its collective budget and times
    beside the flat padded round's; (c) the scenario of (a) through the
    hierarchical retain drive at tight tier capacities, sort and scatter in
    lockstep, rows parked after a later tier.  Round times are medians of
    ``reps``; with ``stage_split`` (CUDA events at the ``on_stage`` marks)
    each comes with its stage split, and the seed round of (a) is timed so
    too.  Returns ``(record, launches per path)``."""
    import numpy as np

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work

    out, paths = {}, {}
    sc = TC.rotating_hotspot(R, 8, E)
    expected = TC.expected_by_rank(sc)
    t0 = time.perf_counter()
    sim = lossless_oracle(sc, S, C)
    oracle_s = time.perf_counter() - t0
    peak = max(sim["retained_trace"])
    print(f"  oracle: rotating_hotspot({R}, 8, {E}), capacity {C}, peer_capacity {S}: {sim['rounds']} "
          f"rounds, retained peak {peak}, age max {sim['age_max']}, drops {sim['drops']} ({oracle_s:.1f} s)",
          flush=True)
    check((sim["rounds"], peak, sim["age_max"]) == oracle_numbers and sim["drops"] == 0 and sim["done"],
          f"oracle: (rounds, retained peak, age max) {(sim['rounds'], peak, sim['age_max'])} == "
          f"{oracle_numbers}, 0 drops")
    check(np.array_equal(sim["delivered"], expected), "oracle delivers expected_by_rank")

    # (a) the flat retain drive, each marshal: observed forward by forward,
    # then (warm) through run_until_done, timed, its launches counted
    for marshal in ("sort", "scatter"):
        cfg = ForwardConfig(R, C, peer_capacity=S, marshal=marshal, overflow="retain")
        d = ScenarioDrive(sc, cfg, dev)
        d.start()
        trace = [d.observe()]
        while d.running():
            d.step()
            trace.append(d.observe())
        res = d.result()
        ok = ([t[0] for t in trace] == sim["retained_trace"] and [t[1] for t in trace] == sim["age_trace"]
              and res["rounds"] == sim["rounds"] and res["done"] and res["drops"] == 0
              and np.array_equal(res["delivered"], expected) and res["bad_ballast"] == 0)
        check(ok, f"(a) flat retain drive, {marshal}: rounds {res['rounds']}, retained and age traces, "
                  f"drops {res['drops']}, done, checksums == oracle and expected_by_rank")
        check(d.comm.count("all_to_all") == 2 * (res["rounds"] + 1),
              f"(a) {marshal}: one payload and one count all_to_all a forward")
        KN.reset_launch_counts()
        res2, wall = d.run()
        launches = KN.launch_counts()
        paths[f"lossless_flat_{marshal}"] = launches
        f = res2["rounds"] + 1
        check(_same_result(res2, res), f"(a) {marshal}: run_until_done == the observed drive")
        if dev.type == "cuda":
            # a forward: the plan, the send pass, the spill gather (K1), K2;
            # an enqueue (K6) seeds the drive and ends every body round
            want = dict.fromkeys(launches, 0)
            want.update(compact_positions=f, unmarshal=f)
            if marshal == "sort":
                want.update(pack_and_histogram=f, gather_rows=2 * f)
            else:
                want.update(rank_and_histogram=f, scatter_rows=f, gather_rows=f)
            check(launches == want, f"(a) {marshal}: launches over {f} forwards {launches}")
        print(f"  (a) {marshal}: {res['rounds']} rounds, wall {wall:.4f} s, {1e3 * wall / f:.3f} ms a "
              f"forwarding round (round_fn included); launches {launches}", flush=True)
        out[f"flat_retain_{marshal}"] = {"rounds": res["rounds"], "wall_s": wall, "ms_per_round": 1e3 * wall / f,
                                         "retained_trace": [t[0] for t in trace], "age_trace": [t[1] for t in trace]}
        if stage_split:  # the seed forward: round 0's emissions, the most spilled
            whole, split = _time_round(d.emit(0), cfg, reps)
            out[f"flat_retain_{marshal}"].update(seed_round_ms=whole, seed_stages_ms=split)
            _print_split(f"(a) {marshal} seed round ({sim['retained_trace'][0]} rows retained)", whole, split)
    out["oracle"] = {"rounds": sim["rounds"], "retained_peak": peak, "age_max": sim["age_max"], "seconds": oracle_s}

    # (b) one hierarchical drop round of the Fig-8 rays, default tier capacities
    q = _fig8_queue(dev, R, C, seed=45)
    cpu_q = _to_cpu(q)
    oq, ototal = forward_work(q, ForwardConfig(R, C, exchange="onehot"))
    times, splits = {}, {}

    def timed(label, c):
        if stage_split:
            times[label], splits[label] = _time_round(q, c, reps)
            _print_split(f"(b) {label}", times[label], splits[label])
        else:
            times[label] = timer(lambda: forward_work(q, c), reps=reps)

    for marshal in ("sort", "scatter"):
        timed(f"flat_padded_{marshal}", ForwardConfig(R, C, peer_capacity=FIG8_S, marshal=marshal))
    for sizes, _caps in HIER_CAPS:
        tiers = [l for l in range(len(sizes)) if sizes[l] > 1]
        for marshal in ("sort", "scatter"):
            cfg = ForwardConfig(R, C, exchange="hierarchical", level_sizes=sizes, marshal=marshal)
            comm = StackedCollectives()
            KN.reset_launch_counts()
            hq, htotal = forward_work(q, cfg, comm=comm)
            launches = KN.launch_counts()
            name = "x".join(map(str, sizes))
            paths[f"hier_round_{name}_{marshal}"] = launches
            check(_same_queue(hq, oq, all_lanes=False) and int(htotal) == int(ototal),
                  f"(b) {name} {marshal} round == flat onehot round: count, drops, total {int(htotal)}, lanes < count")
            a2a = sorted((c.tier, len(c.shape)) for c in comm.calls.elements() if c.kind == "all_to_all")
            check(a2a == sorted([(l, 3) for l in tiers] + [(l, 4) for l in tiers]) and comm.count("psum") == 1,
                  f"(b) {name} {marshal}: one count and one payload all_to_all per tier {tiers}: {a2a}")
            if cpu_witness:
                cq, ctotal = forward_work(cpu_q, cfg)
                check(_same_queue(hq, cq, all_lanes=True) and int(htotal) == int(ctotal),
                      f"(b) {name} {marshal} round on {dev.type} == the same round on the CPU, every lane")
            if dev.type == "cuda":
                # the first tier's send pass is K1 (sort) or K5 (scatter), every
                # later tier gathers its buffer (K1), K2 compacts the last one
                want = dict.fromkeys(launches, 0)
                want.update(unmarshal=1)
                if marshal == "sort":
                    want.update(pack_and_histogram=1, gather_rows=len(tiers))
                else:
                    want.update(rank_and_histogram=1, scatter_rows=1, gather_rows=len(tiers) - 1)
                check(launches == want, f"(b) {name} {marshal}: launches {launches}")
            timed(f"hier_{name}_{marshal}", cfg)
    print("  (b) median round ms: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
    out["round_ms"], out["stages_ms"] = times, splits
    out["hier_delivered"] = int(ototal)
    del oq, hq, cpu_q

    # (c) the hierarchical retain drive at tight tier capacities; sort and
    # scatter in lockstep, equal after every forward
    for sizes, caps in HIER_CAPS:
        name = "x".join(map(str, sizes))
        drives = {m: ScenarioDrive(sc, ForwardConfig(R, C, exchange="hierarchical", level_sizes=sizes,
                                                     level_capacities=caps, marshal=m, overflow="retain"), dev)
                  for m in ("sort", "scatter")}
        KN.reset_launch_counts()
        for d in drives.values():
            d.start()
        same, trace = _same_state(drives["sort"], drives["scatter"]), [drives["sort"].observe()]
        while drives["sort"].running() and drives["scatter"].running():
            for d in drives.values():
                d.step()
            same = same and _same_state(drives["sort"], drives["scatter"])
            trace.append(drives["sort"].observe())
        launches = KN.launch_counts()
        paths[f"lossless_hier_{name}"] = launches
        res = {m: d.result() for m, d in drives.items()}
        parked = sum(t[2] for t in trace)
        print(f"  (c) {name} caps {caps}: {res['sort']['rounds']} rounds, retained peak {max(t[0] for t in trace)}, "
              f"age max {max(t[1] for t in trace)}, rows parked after a later tier {parked} "
              f"(peak {max(t[2] for t in trace)}); launches (sort + scatter) {launches}", flush=True)
        r = res["sort"]
        check(np.array_equal(r["delivered"], expected) and r["drops"] == 0 and r["done"] and r["resident"] == 0
              and r["bad_ballast"] == 0,
              f"(c) {name} retain drive: checksums == expected_by_rank, 0 drops, done")
        check(parked > 0, f"(c) {name}: {parked} rows parked after a later tier (> 0)")
        check(same and _same_result(res["sort"], res["scatter"]), f"(c) {name}: scatter drive == sort drive after every forward")
        res2, wall = drives["sort"].run()  # warm: the whole sort drive through run_until_done
        check(_same_result(res2, r), f"(c) {name}: run_until_done == the observed drive")
        print(f"  (c) {name} sort drive: wall {wall:.4f} s, {1e3 * wall / (r['rounds'] + 1):.3f} ms a "
              "forwarding round (round_fn included)", flush=True)
        out[f"hier_retain_{name}"] = {"caps": caps, "rounds": r["rounds"], "parked_after_later_tier": parked,
                                      "retained_trace": [t[0] for t in trace], "age_trace": [t[1] for t in trace],
                                      "parked_trace": [t[2] for t in trace], "sort_wall_s": wall,
                                      "ms_per_round": 1e3 * wall / (r["rounds"] + 1)}
    return out, paths


# -------------------------------------------------------------- 4. telemetry
def _fig8_queue(dev, R, C, seed=44):
    """Phase ``forward``'s Fig-8 queue (the same generator and seed)."""
    import torch

    from repro_torch.core import WorkQueue

    Ray44 = _ray44_types()
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = lambda *s: torch.randn((R, C) + s, generator=gen, device=dev)
    pixel = torch.arange(R * C, dtype=torch.int32, device=dev).reshape(R, C)
    return WorkQueue(
        items=Ray44(origin=f32(3), direction=f32(3), tmin=f32(), pixel=pixel, integral=f32(), extra=f32(2)),
        dest=_fig8_dest(gen, R, C, dev),
        count=torch.full((R,), C, dtype=torch.int32, device=dev),
        drops=torch.zeros(R, dtype=torch.int32, device=dev),
    )


def _to_cpu(q):
    from repro_torch.core import WorkQueue
    from repro_torch.core import types as T

    return WorkQueue(items=T.tree_map(lambda t: t.cpu(), q.items), dest=q.dest.cpu(), count=q.count.cpu(),
                     drops=q.drops.cpu())


def _same_stats(a, b) -> bool:
    import dataclasses

    import torch

    return all(torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu()) for f in dataclasses.fields(a))


def _sync_warnings(fn, calls: int = 2) -> int:
    """Synchronizing calls ``fn`` makes, as ``torch.cuda``'s sync debug mode
    warns them: the fewest over ``calls`` calls (a sync of every call shows
    in each; the mode's own first-use warning in one only)."""
    import warnings

    import torch

    counts = []
    for _ in range(calls):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    return min(counts)


def drift_run_burst(dev, *, capacity, n_emit, rounds, R=8, words=1, comm=None):
    """``tests/test_tune.py``'s drifting hot-spot burst through the port's
    drive: half of each rank's ``n_emit`` emissions chase a hot destination
    that moves every second round, the rest spread; body round ``rnd`` emits
    round ``rnd + 1``'s, DISCARD from ``rounds`` on.  Rows are ``words``
    words (1: the test's unit item; 11: the Fig-8 ray, a uid and ten words
    of ballast).  Returns ``run_burst(cfg) -> (cumulative drops, ring)``;
    with ``comm`` (a ``DistributedCollectives``) the burst of the process's
    ranks on that backend."""
    import dataclasses

    import torch

    from repro_torch.core import DISCARD, enqueue, make_queue, run_until_done, work_item

    @work_item
    @dataclasses.dataclass
    class DriftRow:
        uid: torch.Tensor  # () i32
        ballast: torch.Tensor  # (words - 1,) f32

    proto = DriftRow(uid=torch.zeros((), dtype=torch.int32), ballast=torch.zeros(words - 1))
    me = torch.arange(R, device=dev)[:, None] if comm is None else comm.ranks(R, dev)[:, None]
    L = me.shape[0]
    lane = torch.arange(n_emit, device=dev)[None, :]
    ones = torch.ones(L, n_emit, dtype=torch.bool, device=dev)

    def emits(rnd):
        hot = (rnd // 2) % R
        dest = torch.where(lane % 2 == 0, hot, (me + lane) % R).to(torch.int32)
        uid = ((rnd * R + me) * n_emit + lane).to(torch.int32)
        ballast = uid.to(torch.float32)[..., None] * torch.ones(words - 1, device=dev)
        return DriftRow(uid=uid, ballast=ballast), dest if rnd < rounds else torch.full_like(dest, DISCARD)

    def round_fn(q_in, acc, rnd):
        items, dest = emits(rnd + 1)
        return enqueue(make_queue(proto, capacity, num_ranks=L, device=dev), items, dest, ones), acc

    def run_burst(cfg):
        items, dest = emits(0)
        q0 = enqueue(make_queue(proto, capacity, num_ranks=L, device=dev), items, dest, ones)
        q, _acc, _rounds, _done, ring = run_until_done(round_fn, q0, torch.zeros(L, device=dev), cfg,
                                                       max_rounds=rounds + 2, comm=comm)
        return int(q.drops.sum()), ring

    return run_burst


def _autotune(dev, exchange, *, capacity, n_emit, rounds, caps, words=1, max_bursts=8, comm=None):
    """``autotune_forward`` on the drift burst from ``caps``: ``(final cfg,
    report, bounds, wall seconds a burst)``; the bounds are the §6.3 worst
    case, ``(n_emit,)`` flat and ``(4, 2, 1)·n_emit`` on 2×2×2; ``comm`` the
    backend (None: stacked)."""
    import torch

    from repro_torch.core import ForwardConfig
    from repro_torch.tune import TunePolicy, autotune_forward

    R = 8
    kw = dict(telemetry=True, telemetry_window=rounds + 2, telemetry_buckets=8)
    if exchange == "padded":
        cfg, bounds = ForwardConfig(R, capacity, peer_capacity=caps[0], **kw), (n_emit,)
    else:
        cfg = ForwardConfig(R, capacity, exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=caps, **kw)
        bounds = (4 * n_emit, 2 * n_emit, n_emit)
    run_burst = drift_run_burst(dev, capacity=capacity, n_emit=n_emit, rounds=rounds, words=words, comm=comm)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, report = autotune_forward(run_burst, cfg, policy=TunePolicy(headroom=1.25, granularity=8), bounds=bounds,
                                     max_bursts=max_bursts, comm=comm)
    return final, report, bounds, (time.perf_counter() - t0) / max(report.bursts, 1)


def phase_telemetry(dev, R=8, C=262144, S=65536, reps=10, E=32768, RETAIN_S=8192,
                    TUNE_TEST=(1024, 96, 8), TUNE_CARD=(262144, 24576, 8, 2048), cpu_witness=True,
                    stage_split=True):
    """The flight recorder and the capacity controller on the card: (a) the
    Fig-8 round (flat sort and scatter, and 2×2×2) with ``telemetry=True``
    against the telemetry-off round (queue bit-equal, the same calls and
    launches, no more synchronizing calls), its stats against the CPU's and
    across marshals, medians and splits on and off; (b) phase ``lossless``
    (a)'s flat retain drive with the ring, its ``ring_trace`` against the
    oracle's traces; (c) ``autotune_forward`` on the drifting hot-spot of
    ``tests/test_tune.py``, flat and 2×2×2, at the test's size against the
    CPU's report step for step, and at card size (11-word rays, ``n_emit``
    at the test's ratio) to a drop-free fixed point within the §6.3 bounds.
    Returns ``(record, launches per path)``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch import telemetry as TM
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work

    out, paths = {}, {}
    q = _fig8_queue(dev, R, C)
    cpu_q = _to_cpu(q) if cpu_witness else None
    cases = [(f"flat_{m}", dict(peer_capacity=S, marshal=m)) for m in ("sort", "scatter")]
    cases += [(f"2x2x2_{m}", dict(exchange="hierarchical", level_sizes=(2, 2, 2), marshal=m))
              for m in ("sort", "scatter")]
    stats = {}
    for label, kw in cases:
        off_cfg, on_cfg = ForwardConfig(R, C, **kw), ForwardConfig(R, C, telemetry=True, **kw)
        comm_off, comm_on = StackedCollectives(), StackedCollectives()
        KN.reset_launch_counts()
        oq, ototal = forward_work(q, off_cfg, comm=comm_off)
        off_launches = KN.launch_counts()
        KN.reset_launch_counts()
        nq, total, st = forward_work(q, on_cfg, comm=comm_on)
        paths[f"telemetry_round_{label}"] = launches = KN.launch_counts()
        stats[label] = st
        check(_same_queue(nq, oq, all_lanes=True) and int(total) == int(ototal),
              f"(a) {label}: telemetry round == telemetry-off round, every lane, drops, total {int(total)}")
        check(comm_on.calls == comm_off.calls,
              f"(a) {label}: telemetry adds no collective call ({sum(comm_on.calls.values())} calls)")
        if dev.type == "cuda":
            check(launches == off_launches, f"(a) {label}: the same kernel launches as telemetry off: {launches}")
            syncs = {k: _sync_warnings(lambda c=c: forward_work(q, c)) for k, c in (("off", off_cfg), ("on", on_cfg))}
            check(syncs["on"] <= syncs["off"],
                  f"(a) {label}: synchronizing calls in the round, telemetry on {syncs['on']} <= off {syncs['off']}")
            out[f"syncs_{label}"] = syncs
        if cpu_witness and label.endswith("sort"):
            cst = forward_work(cpu_q, on_cfg)[-1]
            check(_same_stats(st, cst), f"(a) {label}: RoundStats == the CPU round's, field by field")
        print(f"  (a) {label}: demand max per tier {st.demand_max.amax(0).tolist()}, stage drops "
              f"{st.stage_drops.sum(0).tolist()}, recv drops {int(st.recv_drops.sum())}, sent "
              f"{st.sent_rows.sum(0).tolist()}", flush=True)
        if stage_split:
            for tag, c in (("off", off_cfg), ("on", on_cfg)):
                out[f"{label}_{tag}"] = _time_and_profile(f"(a) {label} telemetry {tag}", q, c, reps)
    for layout in ("flat", "2x2x2"):
        check(_same_stats(stats[f"{layout}_sort"], stats[f"{layout}_scatter"]),
              f"(a) {layout}: the same RoundStats from the sort and the scatter marshal")
    del cpu_q

    # (b) the flat retain drive of phase lossless (a), with the ring
    sc = TC.rotating_hotspot(R, 8, E)
    sim = lossless_oracle(sc, RETAIN_S, C)
    window = sim["rounds"] + 1
    for marshal in ("sort", "scatter"):
        cfg = ForwardConfig(R, C, peer_capacity=RETAIN_S, marshal=marshal, overflow="retain", telemetry=True,
                            telemetry_window=max(12, window))
        d = ScenarioDrive(sc, cfg, dev)
        KN.reset_launch_counts()
        res, wall = d.run()
        paths[f"telemetry_retain_{marshal}"] = KN.launch_counts()
        tr = TM.ring_trace(d.ring)
        check(tr["retained_rows"].tolist() == sim["retained_trace"] and tr["age_max"].tolist() == sim["age_trace"],
              f"(b) {marshal}: ring_trace retained_rows and age_max == the oracle's traces over {window} forwards")
        check(res["rounds"] == sim["rounds"] and res["drops"] == 0 and res["done"]
              and np.array_equal(res["delivered"], TC.expected_by_rank(sc)),
              f"(b) {marshal}: {res['rounds']} rounds, 0 drops, checksums == expected_by_rank")
        summ = TM.summarize(d.ring, tier_capacities=TM.tier_capacities(cfg))
        print(f"  (b) {marshal}: wall {wall:.4f} s, {1e3 * wall / window:.3f} ms a forwarding round; summary: "
              f"{summ['retained_rows']} retained row-rounds, age max {summ['age_max']}, rows held "
              f"{summ['rows_held'].tolist()}, drops {summ['drops']}", flush=True)
        out[f"retain_drive_{marshal}"] = {"wall_s": wall, "ms_per_round": 1e3 * wall / window,
                                          "retained_trace": tr["retained_rows"].tolist()}

    # (c) the capacity controller on the drifting hot-spot
    cap, n_emit, rounds = TUNE_TEST
    for exchange, caps in (("padded", (8,)), ("hierarchical", (8, 8, 8))):
        final, rep_card, _b, _w = _autotune(dev, exchange, capacity=cap, n_emit=n_emit, rounds=rounds, caps=caps)
        if cpu_witness:
            _f, rep_cpu, _b, _w = _autotune(torch.device("cpu"), exchange, capacity=cap, n_emit=n_emit,
                                            rounds=rounds, caps=caps)
            same = (rep_card.converged == rep_cpu.converged and rep_card.bursts == rep_cpu.bursts
                    and all(dataclasses.asdict(a) == dataclasses.asdict(b)
                            for a, b in zip(rep_card.steps, rep_cpu.steps)))
            check(same, f"(c) test size {exchange}: the card's TuneReport == the CPU's, step by step "
                        f"({rep_card.bursts} bursts, final {TM.tier_capacities(final)})")
    cap, n_emit, rounds, start = TUNE_CARD
    for exchange, caps in (("padded", (start,)), ("hierarchical", (start,) * 3)):
        KN.reset_launch_counts()
        final, report, bounds, wall = _autotune(dev, exchange, capacity=cap, n_emit=n_emit, rounds=rounds,
                                                caps=caps, words=11)
        paths[f"autotune_{exchange}"] = KN.launch_counts()
        caps_f = TM.tier_capacities(final)
        ok = (report.converged and report.steps[0].drops > 0 and report.final_drops == 0
              and all(c <= b for c, b in zip(caps_f, bounds)) and (exchange == "padded" or report.bursts > 2))
        check(ok, f"(c) card size {exchange}: converged in {report.bursts} bursts {caps} -> {caps_f} <= {bounds}, "
                  f"first burst drops {report.steps[0].drops}, final drops {report.final_drops}")
        for s in report.steps:
            print(f"    burst {s.burst}: caps {s.capacities} -> {s.planned}, drops {s.drops}, demand max "
                  f"{s.demand_max}, rounds {s.rounds}", flush=True)
        print(f"  (c) card size {exchange}: {wall:.4f} s a burst ({rounds + 1} forwards of {R}x{cap} "
              f"11-word rows, {n_emit} emissions a rank a round)", flush=True)
        out[f"autotune_{exchange}"] = {"bursts": report.bursts, "final": list(caps_f), "bounds": list(bounds),
                                       "wall_s_per_burst": wall,
                                       "steps": [dataclasses.asdict(s) for s in report.steps]}
    return out, paths


# --------------------------------------------------------------- 5. pipeline
def phase_pipeline(dev, R=8, C=262144, S=65536, reps=10, E=32768, RETAIN_S=8192, stage_split=True):
    """Micro-shard pipelining on the card: the Fig-8 round at 2 and 4
    shards (both marshals, drop), phase ``lossless`` (a)'s retain seed round
    at 4 shards and the 2×2×2 round at 2 shards (both marshals), each
    bit-equal on every lane to its one-shard round, with n payload and n
    count calls per tier and the launches of each path (K1 or K5 n times a
    tier, K2 none); medians beside one shard, with the per-shard split.
    Returns ``(record, launches per path)``."""
    import dataclasses

    import torch

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work

    out, paths = {}, {}
    q = _fig8_queue(dev, R, C)
    sc = TC.rotating_hotspot(R, 8, E)
    seed_q = ScenarioDrive(sc, ForwardConfig(R, C, peer_capacity=RETAIN_S, overflow="retain"), dev).emit(0)
    cases = [(f"flat_{m}", q, dict(peer_capacity=S, marshal=m), (2, 4), 1) for m in ("sort", "scatter")]
    cases += [(f"retain_seed_{m}", seed_q, dict(peer_capacity=RETAIN_S, marshal=m, overflow="retain"), (4,), 1)
              for m in ("sort", "scatter")]
    cases += [(f"2x2x2_{m}", q, dict(exchange="hierarchical", level_sizes=(2, 2, 2), marshal=m), (2,), 3)
              for m in ("sort", "scatter")]
    for label, qq, kw, shards, L in cases:
        base = ForwardConfig(R, C, **kw)
        ref = forward_work(qq, base)
        for n in shards:
            comm = StackedCollectives()
            KN.reset_launch_counts()
            got = forward_work(qq, dataclasses.replace(base, pipeline_shards=n), comm=comm)
            paths[f"pipeline_{label}_S{n}"] = launches = KN.launch_counts()
            same = _same_queue(got[0], ref[0], all_lanes=True) and int(got[1]) == int(ref[1])
            if len(got) == 3:  # retain: the destinations and ages too
                same = same and torch.equal(got[2], ref[2]) and torch.equal(got[0].dest, ref[0].dest)
            check(same, f"{label} at {n} shards == one shard: every lane, drops, total {int(got[1])}")
            pay = sorted(c.tier or 0 for c in comm.calls.elements() if c.kind == "all_to_all" and len(c.shape) == 4)
            cnt = sorted(c.tier or 0 for c in comm.calls.elements() if c.kind == "all_to_all" and len(c.shape) == 3)
            check(len(set(pay)) == L and pay == cnt and pay == sorted(sorted(set(pay)) * n),
                  f"{label} at {n} shards: {n} payload and {n} count all_to_all on each of {L} tier(s)")
            if dev.type == "cuda":
                retain = kw.get("overflow") == "retain"
                want = dict.fromkeys(launches, 0)
                if kw["marshal"] == "sort":
                    want.update(pack_and_histogram=1, gather_rows=n * L + retain)
                else:
                    want.update(rank_and_histogram=1, scatter_rows=n, gather_rows=n * (L - 1) + retain)
                check(launches == want, f"{label} at {n} shards: launches {launches} (K2 none)")
        if stage_split:
            for n in (1,) + shards:
                c = dataclasses.replace(base, pipeline_shards=n)
                out[f"{label}_S{n}"] = rec = _time_and_profile(f"{label} at {n} shard(s)", qq, c, reps)
                rec["sync_warnings"] = _sync_warnings(lambda: forward_work(qq, c))
                print(f"    synchronizing calls in the round: {rec['sync_warnings']}", flush=True)
    return out, paths


def _time_and_profile(label, q, cfg, reps):
    """The round's median (one CUDA event pair a round, host issue
    included), its stage split, and its device time (``device_ms``: the
    kernels, copies and fills of a round under ``torch.profiler``, no
    idle): where the median exceeds the device time, the card waited on
    the host."""
    from repro_torch.core import forward_work

    whole, split = _time_round(q, cfg, reps)
    busy, _events = device_ms(lambda: forward_work(q, cfg), calls=reps)
    _print_split(f"{label} (device time {busy:.3f} ms)", whole, split)
    return {"round_ms": whole, "device_ms": busy, "stages_ms": split}


# ----------------------------------------------------------------- 6. credit
CREDIT_TWIN_CASES = (("sustained_overload", 16, 4, 73), ("incast_collapse", 32, 8, 80))
CREDIT_MODES = (("sort", {"marshal": "sort"}), ("scatter", {"marshal": "scatter"}),
                ("sort_S2", {"marshal": "sort", "pipeline_shards": 2}))


def _widened(calls):
    """A round's calls with every count call (a 3-d ``all_to_all``) one
    int32 column wider: what a credit round must record."""
    out = []
    for c in calls.elements():
        shape = c.shape
        if c.kind == "all_to_all" and len(shape) == 3:
            shape = shape[:-1] + (shape[-1] + 1,)
        out.append((c.kind, -1 if c.tier is None else c.tier, shape))
    return sorted(out)


def _calls(comm):
    return sorted((c.kind, -1 if c.tier is None else c.tier, c.shape) for c in comm.calls.elements())


def _twin_drive(sc, cfg, dev, tw, label, max_rounds):
    """A gated credit drive observed forward by forward against the twin
    ``tw``: ``(ok, launches, rounds)``."""
    import numpy as np

    from repro_torch import kernels as KN
    from repro_torch.telemetry import stats as TS

    KN.reset_launch_counts()
    d = ScenarioDrive(sc, cfg, dev, gated=True)
    d.start()
    trace = [d.observe()]
    while d.running(max_rounds):
        d.step()
        trace.append(d.observe())
    res = d.result()
    launches = KN.launch_counts()
    tr = TS.ring_trace(d.ring)
    summary = TS.summarize(d.ring, tier_capacities=TS.tier_capacities(cfg))
    ok = (res["rounds"] == tw["rounds"] and res["done"] and res["drops"] == 0 and res["bad_ballast"] == 0
          and np.array_equal(res["delivered"], tw["delivered"]) and res["emitted"] == tw["emitted"]
          and [t[0] for t in trace] == tw["retained_trace"] and [t[1] for t in trace] == tw["age_trace"]
          and tr["recv_total"].tolist() == tw["recv_trace"] and tw["recv_trace"][0] == 0
          and summary["emit_overflow"] == 0 and summary["wasted_wire_rows"] == 0)
    check(ok, f"(a) {label}: {res['rounds']} rounds, delivered, retained / age / receive traces == the twin, "
              "0 drops, 0 emission cut, 0 wasted wire, first forward ships nothing")
    return ok, launches, res["rounds"]


def phase_credit(dev, R=8, C=262144, S=65536, TWIN_BIG=(256, 1024, 128, 848),
                 FULL=(("incast_collapse", 10, 65536), ("sustained_overload", 12, 196608)), FULL_ROUNDS=48,
                 FIT=("incast_collapse", 10, 8192), HIER=((2, 4), (2, 2, 2)), reps=10, cpu_witness=True,
                 timer=cuda_ms, dtimer=device_ms, syncs=True):
    """Credit flow control (the backpressure law) on the card: (a) the two
    test-size credit drives (``sustained_overload`` C=16 S=4, 73 rounds;
    ``incast_collapse`` C=32 S=8, 80 rounds) in sort, scatter and sort at 2
    shards, and ``sustained_overload(8, emits_per_round=256)`` at C=1,024,
    S=128 (848 rounds), each equal to the port's numpy twin forward for
    forward; (b) the overload shapes at full width (C=262,144, S=65,536, the
    tests' ratios): open flow to its end, dropping rows, against credit flow
    for ``FULL_ROUNDS`` forwards in sort and scatter in lockstep — no drop,
    no wasted wire, the first forward ships nothing, rows conserved — with
    ms a forwarding round and the credit drain rate; then ``FIT`` (a shape
    whose hot receiver keeps up) through the flat and hierarchical credit
    drives to its end, delivering ``expected_by_rank``; (c) one credit round
    of the Fig-8 rays, flat and on each layout of ``HIER``, both marshals,
    equal to the CPU round (queues, ages, credits, stats), its calls the
    open retain round's with each count call one column wider, no more
    synchronizing calls than the open round, timed beside it (event medians
    and device time).  Returns ``(record, launches per path)``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work
    from repro_torch.telemetry import stats as TS

    out, paths = {}, {}

    def credit_cfg(Cc, Sc, window=0, **kw):
        tel = dict(telemetry=True, telemetry_window=window) if window else {}
        return ForwardConfig(R, Cc, peer_capacity=Sc, overflow="retain", flow="credit", **tel, **kw)

    # (a) the twin, at the tests' sizes and at 256 emissions a rank a round
    for name, Ct, St, rounds in CREDIT_TWIN_CASES:
        sc = getattr(TC, name)(R)
        tw = TC.simulate_flat_credit(sc, peer_capacity=St, capacity=Ct, max_rounds=256)
        check(tw["rounds"] == rounds and tw["done"] and tw["drops"] == 0, f"(a) twin {name}: {tw['rounds']} rounds")
        for label, kw in CREDIT_MODES:
            _ok, launches, _r = _twin_drive(sc, credit_cfg(Ct, St, 257, **kw), dev, tw, f"{name} {label}", 256)
            paths[f"credit_twin_{name}_{label}"] = launches
    E_big, C_big, S_big, r_big = TWIN_BIG
    sc = TC.sustained_overload(R, emits_per_round=E_big)
    t0 = time.perf_counter()
    tw = TC.simulate_flat_credit(sc, peer_capacity=S_big, capacity=C_big, max_rounds=2048)
    twin_s = time.perf_counter() - t0
    check(tw["rounds"] == r_big and tw["done"], f"(a) twin sustained_overload E={E_big}: {tw['rounds']} rounds "
                                                f"({twin_s:.1f} s on the host)")
    _ok, launches, _r = _twin_drive(sc, credit_cfg(C_big, S_big, 2049), dev, tw, f"sustained_overload E={E_big}", 2048)
    paths["credit_twin_big"] = launches
    out["twin"] = {"big_rounds": tw["rounds"], "big_twin_s": twin_s}
    print(f"  (a) twin drives equal; sustained_overload E={E_big} C={C_big} S={S_big}: {tw['rounds']} rounds "
          f"(twin {twin_s:.1f} s on the host)", flush=True)

    # (b) full width, the tests' ratios: open to its end, credit for FULL_ROUNDS
    for name, rounds_sc, E in FULL:
        sc = getattr(TC, name)(R, rounds_sc, E)
        total_rows = sc.emitted
        KN.reset_launch_counts()
        od = ScenarioDrive(sc, ForwardConfig(R, C, peer_capacity=S, overflow="retain", telemetry=True,
                                             telemetry_window=129), dev)
        ores, owall = od.run(max_rounds=128)
        paths[f"credit_open_{name}"] = KN.launch_counts()
        osum = TS.summarize(od.ring, tier_capacities=(S,))
        otr = TS.ring_trace(od.ring)
        delivered = int(ores["delivered"][:, 0].sum())
        check(ores["done"] and ores["drops"] > 0 and ores["drops"] == osum["emit_overflow"] + osum["wasted_wire_rows"]
              and delivered + ores["drops"] == total_rows and ores["bad_ballast"] == 0,
              f"(b) {name} open: {ores['rounds']} rounds, drops {ores['drops']} == emission cut "
              f"{osum['emit_overflow']} + wasted wire {osum['wasted_wire_rows']}, delivered {delivered} + drops == "
              f"{total_rows}")
        o_ms = 1e3 * owall / (ores["rounds"] + 1)
        drives = {m: ScenarioDrive(sc, credit_cfg(C, S, FULL_ROUNDS + 1, marshal=m), dev, gated=True)
                  for m in ("sort", "scatter")}
        KN.reset_launch_counts()
        for d in drives.values():
            d.start()
        first = drives["sort"].observe()
        in_flight = int(drives["sort"].carry["q"].count.sum())
        same = _same_state(drives["sort"], drives["scatter"])
        while drives["sort"].running(FULL_ROUNDS):
            for d in drives.values():
                d.step()
            same = same and _same_state(drives["sort"], drives["scatter"])
        paths[f"credit_full_{name}"] = KN.launch_counts()
        res = {m: d.result() for m, d in drives.items()}
        r = res["sort"]
        csum = TS.summarize(drives["sort"].ring, tier_capacities=(S,))
        ctr = TS.ring_trace(drives["sort"].ring)
        got = int(r["delivered"][:, 0].sum())
        check(first[0] == in_flight and ctr["recv_total"][0] == 0,
              f"(b) {name} credit: the first forward ships nothing ({first[0]} of {in_flight} rows held)")
        check(r["drops"] == 0 and csum["emit_overflow"] == 0 and csum["wasted_wire_rows"] == 0
              and got + r["resident"] == r["emitted"] and r["bad_ballast"] == 0,
              f"(b) {name} credit, {r['rounds']} forwards: 0 drops, 0 emission cut, 0 wasted wire, delivered "
              f"{got} + in flight {r['resident']} == emitted {r['emitted']}")
        if r["done"]:
            check(np.array_equal(r["delivered"], expected_fast(sc)), f"(b) {name} credit: checksums == expected_by_rank")
        check(same and _same_result(res["sort"], res["scatter"]), f"(b) {name} credit: scatter == sort after every forward")
        _cres, cwall = ScenarioDrive(sc, credit_cfg(C, S), dev, gated=True).run(max_rounds=FULL_ROUNDS)
        c_ms = 1e3 * cwall / (r["rounds"] + 1)
        tail = ctr["recv_total"][len(ctr["recv_total"]) // 2:]
        tail_rate = float(np.mean(tail)) if len(tail) else 0.0
        print(f"  (b) {name}({R}, {rounds_sc}, {E}) C={C} S={S}: {total_rows} rows. open: {ores['rounds']} rounds, "
              f"drops {ores['drops']} (emission cut {osum['emit_overflow']}, wasted wire {osum['wasted_wire_rows']} "
              f"of {int(otr['recv_total'].sum())}), {o_ms:.3f} ms a forwarding round. credit: {r['rounds']} forwards "
              f"delivered {got}, {c_ms:.3f} ms a forwarding round, arrivals a forward over the last half "
              f"{tail_rate:.1f} (projected rounds to drain {total_rows / max(tail_rate, 1):.0f})", flush=True)
        out[f"full_{name}"] = {"rows": total_rows, "open_rounds": ores["rounds"], "open_drops": ores["drops"],
                               "open_emit_overflow": osum["emit_overflow"], "open_wasted": osum["wasted_wire_rows"],
                               "open_wire": int(otr["recv_total"].sum()), "open_ms_per_round": o_ms,
                               "credit_forwards": FULL_ROUNDS, "credit_delivered": got, "credit_ms_per_round": c_ms,
                               "credit_done": r["done"], "credit_recv_trace": ctr["recv_total"].tolist(),
                               "credit_tail_rate": tail_rate}

    # (b) FIT: a full-width shape whose hot receiver keeps up, to its end
    name, rounds_sc, E = FIT
    sc = getattr(TC, name)(R, rounds_sc, E)
    expected = expected_fast(sc)
    fit = {}
    for label, cfg in [("flat", credit_cfg(C, S))] + [
            ("x".join(map(str, sizes)), ForwardConfig(R, C, exchange="hierarchical", level_sizes=sizes,
                                                      level_capacities=(S,) * len(sizes), overflow="retain",
                                                      flow="credit")) for sizes in HIER]:
        runs = {}
        for m in ("sort", "scatter"):
            KN.reset_launch_counts()
            d = ScenarioDrive(sc, dataclasses.replace(cfg, marshal=m), dev, gated=True)
            d.start()
            first = (d.observe()[0], int(d.carry["q"].count.sum()))
            while d.running(1024):
                d.step()
            runs[m] = d.result()
            paths[f"credit_fit_{label}_{m}"] = KN.launch_counts()
        r = runs["sort"]
        check(np.array_equal(r["delivered"], expected) and r["drops"] == 0 and r["done"] and r["resident"] == 0
              and r["bad_ballast"] == 0 and first[0] == first[1] and _same_result(runs["sort"], runs["scatter"]),
              f"(b) {name}({R}, {rounds_sc}, {E}) {label} credit drive: {r['rounds']} rounds, checksums == "
              "expected_by_rank, 0 drops, first forward ships nothing, scatter == sort")
        _res, wall = ScenarioDrive(sc, cfg, dev, gated=True).run(max_rounds=1024)
        fit[label] = {"rounds": r["rounds"], "wall_s": wall, "ms_per_round": 1e3 * wall / (r["rounds"] + 1)}
        print(f"  (b) {name}({R}, {rounds_sc}, {E}) {label}: {r['rounds']} rounds, {fit[label]['ms_per_round']:.3f} ms "
              "a forwarding round", flush=True)
    ores, owall = ScenarioDrive(sc, ForwardConfig(R, C, peer_capacity=S, overflow="retain"), dev).run(max_rounds=1024)
    fit["open_flat"] = {"rounds": ores["rounds"], "drops": ores["drops"], "ms_per_round": 1e3 * owall / (ores["rounds"] + 1)}
    print(f"  (b) the same shape under open flow: {ores['rounds']} rounds, drops {ores['drops']}, "
          f"{fit['open_flat']['ms_per_round']:.3f} ms a forwarding round", flush=True)
    out["fit"] = fit

    # (c) one credit round of the Fig-8 rays against the CPU; calls, syncs, times
    q = _fig8_queue(dev, R, C, seed=46)
    cpu_q = _to_cpu(q)
    gen = torch.Generator(device="cpu").manual_seed(46)
    credits = torch.randint(-64, C // 2, (R, R), generator=gen, dtype=torch.int32)
    credits_dev = credits.to(dev)
    full = torch.full((R, R), C, dtype=torch.int32, device=dev)
    times = {}
    for layout in ("flat",) + tuple("x".join(map(str, s)) for s in HIER):
        sizes = None if layout == "flat" else tuple(int(a) for a in layout.split("x"))
        for m in ("sort", "scatter"):
            kw = dict(overflow="retain", marshal=m, telemetry=True)
            if sizes:
                kw.update(exchange="hierarchical", level_sizes=sizes)
            else:
                kw.update(peer_capacity=S)
            ccfg, ocfg = ForwardConfig(R, C, flow="credit", **kw), ForwardConfig(R, C, **kw)
            comm, ocomm = StackedCollectives(), StackedCollectives()
            KN.reset_launch_counts()
            nq, total, age, cr, st = forward_work(q, ccfg, credits=credits_dev, comm=comm)
            paths[f"credit_round_{layout}_{m}"] = KN.launch_counts()
            forward_work(q, ocfg, comm=ocomm)
            check(_calls(comm) == _widened(ocomm.calls),
                  f"(c) {layout} {m}: the open retain round's calls, each count call one column wider")
            held = int(((torch.arange(C, device=dev)[None] < nq.count[:, None]) & (nq.dest >= 0)).sum())
            if cpu_witness:
                cq, ctotal, cage, ccr, cst = forward_work(cpu_q, ccfg, credits=credits)
                check(_same_queue(nq, cq, all_lanes=True) and torch.equal(nq.dest.cpu(), cq.dest)
                      and torch.equal(age.cpu(), cage) and torch.equal(cr.cpu(), ccr) and _same_stats(st, cst)
                      and int(total) == int(ctotal),
                      f"(c) {layout} {m} credit round on the card == on the CPU: every lane, ages, credits, stats "
                      f"({held} rows held for want of credit)")
            if syncs and dev.type == "cuda":
                cs = _sync_warnings(lambda: forward_work(q, ccfg, credits=credits_dev))
                os_ = _sync_warnings(lambda: forward_work(q, ocfg))
                check(cs <= os_, f"(c) {layout} {m}: synchronizing calls, credit {cs} <= open retain {os_}")
            tc = dataclasses.replace(ccfg, telemetry=False)
            to = dataclasses.replace(ocfg, telemetry=False)
            times[f"{layout}_{m}"] = {"credit_ms": timer(lambda: forward_work(q, tc, credits=full), reps=reps),
                                      "open_retain_ms": timer(lambda: forward_work(q, to), reps=reps),
                                      "credit_device_ms": dtimer(lambda: forward_work(q, tc, credits=full))[0],
                                      "open_retain_device_ms": dtimer(lambda: forward_work(q, to))[0]}
    print("  (c) round ms, credit (fully credited) / open retain: event medians " + ", ".join(
        f"{k} {v['credit_ms']:.3f} / {v['open_retain_ms']:.3f}" for k, v in times.items()) + "; device "
        + ", ".join(f"{k} {v['credit_device_ms']:.3f} / {v['open_retain_device_ms']:.3f}" for k, v in times.items()),
        flush=True)
    out["round_ms"] = times
    if syncs and dev.type == "cuda":
        # the drive's emission gate (the merge's limit cut) adds no sync: a
        # body round of the credit drive makes the open retain drive's syncs
        n = {}
        for flow in ("credit", "open"):
            cfg = ForwardConfig(R, C, peer_capacity=S, overflow="retain", flow=flow)
            d = ScenarioDrive(TC.incast_collapse(R, 10, FIT[2]), cfg, dev, gated=flow == "credit")
            d.start()
            d.step()
            n[flow] = _sync_warnings(d.step, calls=2)
        check(n["credit"] <= n["open"], f"(c) a body round of the drive: synchronizing calls, credit {n['credit']} "
                                        f"<= open retain {n['open']}")
        out["drive_round_syncs"] = n
    return out, paths


# ---------------------------------------------------------------- 7. balance
def _rebalance_population(dev, R, C, N1, P, seed=49):
    """Rank 0 full (C residents), every other rank ``N1`` residents behind
    ``P`` pending rows to its ring successor; Fig-8 rays."""
    import torch

    q = _fig8_queue(dev, R, C, seed=seed)
    lane = torch.arange(C, device=dev)[None, :]
    me = torch.arange(R, device=dev)[:, None]
    count = torch.full((R,), P + N1, dtype=torch.int32, device=dev)
    count[0] = C
    pending = (me > 0) & (lane < P)
    dest = torch.where(pending, (me + 1) % R, -1).to(torch.int32)
    dest = torch.where(lane < count[:, None], dest, -1)
    return type(q)(items=q.items, dest=dest, count=count, drops=q.drops)


def _sorted_by_pixel(q, r):
    """Rank ``r``'s rows of ``q`` (lanes < count) as packed words, in pixel order."""
    import torch

    from repro_torch.core import types as T

    n = int(q.count[r])
    packed, _ = T.pack_payload(q.items, batch_dims=2)
    order = torch.argsort(q.items.pixel[r, :n])
    return packed[r, :n][order]


def phase_balance(dev, R=8, C=262144, S=65536, N1=65536, P=4096, BROWNOUT=(8, 16384, 2048), reps=5,
                  cpu_witness=True, timer=cuda_ms, dtimer=device_ms,
                  cycle_cpu=(("sort", "drop"), ("scatter", "retain"))):
    """The health remap, rebalancing and queue cycling on the card, Fig-8
    rays at R=8, C=262,144: (a) the padded round with ranks 2 and 5
    unhealthy (both marshals) equal to the round whose ``dest`` was remapped
    before the call and to the CPU, an all-True mask bit-equal to no mask,
    the unmasked round's calls and launches, timed beside it (event medians
    and device time); ``rank_brownout`` under
    ``brownout_mask`` through the retain drive equal to the port's
    ``simulate_flat_retain(health=)`` forward for forward; (b) ``rebalance``
    of a skewed population (rank 0 full, the others ``N1`` residents behind
    ``P`` pending rows): global on the flat, 2×4 and 2×2×2 routes, intra on
    2×4 and 2×2×2, and a health-aware evacuation, slots sized so no clamp
    fires: every rank ends at floor or ceil of its mean plus the pending
    rows addressed to it, the intra round calls the last tier only, each
    equal to the CPU; (c) ``deliver_by_cycling`` of the Fig-8 rays (sort and
    scatter, drop and retain): every rank's delivered rows, sorted by
    pixel, those of the padded round; R payload and R count ``ppermute``
    calls; K3 and K1, or K5, and K6 every hop; equal to the CPU on
    ``cycle_cpu``; timed beside one padded round.  Returns ``(record,
    launches per path)``."""
    import numpy as np
    import torch

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.core import (ForwardConfig, StackedCollectives, WorkQueue, deliver_by_cycling, forward_work,
                                  rebalance, remap_dest)

    out, paths = {}, {}
    cuda = dev.type == "cuda"

    # (a) the masked round, and the brownout drive against the oracle
    q = _fig8_queue(dev, R, C, seed=47)
    cpu_q = _to_cpu(q)
    h = torch.ones(R, dtype=torch.bool)
    h[[2, 5]] = False
    masked = {}
    for m in ("sort", "scatter"):
        cfg = ForwardConfig(R, C, peer_capacity=S, marshal=m)
        comm, pcomm = StackedCollectives(), StackedCollectives()
        KN.reset_launch_counts()
        nq, total = forward_work(q, cfg, health=h.to(dev), comm=comm)
        launches = KN.launch_counts()
        paths[f"balance_masked_{m}"] = launches
        KN.reset_launch_counts()
        pq, ptotal = forward_work(q, cfg, comm=pcomm)
        plain_launches = KN.launch_counts()
        check(comm.calls == pcomm.calls and launches == plain_launches,
              f"(a) {m}: the health mask adds no call and no launch ({launches})")
        pre = WorkQueue(items=q.items, dest=remap_dest(q.dest, h.to(dev)), count=q.count, drops=q.drops)
        rq, rtotal = forward_work(pre, cfg)
        check(_same_queue(nq, rq, all_lanes=True) and int(total) == int(rtotal),
              f"(a) {m}: masked round == the round of the remapped dest, every lane")
        tq, ttotal = forward_work(q, cfg, health=torch.ones(R, dtype=torch.bool, device=dev))
        check(_same_queue(tq, pq, all_lanes=True) and torch.equal(tq.dest, pq.dest) and int(ttotal) == int(ptotal),
              f"(a) {m}: an all-True mask == no mask, every lane")
        check(int(nq.count[2]) == 0 and int(nq.count[5]) == 0 and int(total) == int(nq.count.sum()),
              f"(a) {m}: ranks 2 and 5 receive nothing; drops at the doubled ranks {nq.drops.tolist()}")
        if cpu_witness:
            cq, ctotal = forward_work(cpu_q, cfg, health=h)
            check(_same_queue(nq, cq, all_lanes=True) and int(total) == int(ctotal),
                  f"(a) {m}: masked round on the card == on the CPU, every lane")
        hd = h.to(dev)
        masked[m] = {"masked_ms": timer(lambda: forward_work(q, cfg, health=hd), reps=reps),
                     "plain_ms": timer(lambda: forward_work(q, cfg), reps=reps),
                     "masked_device_ms": dtimer(lambda: forward_work(q, cfg, health=hd))[0],
                     "plain_device_ms": dtimer(lambda: forward_work(q, cfg))[0]}
    print("  (a) round ms, masked / unmasked: " + ", ".join(
        f"{m} {v['masked_ms']:.3f} / {v['plain_ms']:.3f} (device {v['masked_device_ms']:.3f} / "
        f"{v['plain_device_ms']:.3f})" for m, v in masked.items()), flush=True)
    out["masked_round_ms"] = masked
    rounds_b, E_b, S_b = BROWNOUT
    sc = TC.rank_brownout(R, rounds_b, E_b)
    t0 = time.perf_counter()
    sim = TC.simulate_flat_retain(sc, peer_capacity=S_b, capacity=C, health=TC.brownout_mask(R))
    oracle_s = time.perf_counter() - t0
    check(sim["done"] and sim["drops"] == 0, f"(a) oracle: rank_brownout({R}, {rounds_b}, {E_b}) with the brownout "
                                             f"mask, S={S_b}: {sim['rounds']} rounds ({oracle_s:.1f} s on the host)")
    for m in ("sort", "scatter"):
        KN.reset_launch_counts()
        d = ScenarioDrive(sc, ForwardConfig(R, C, peer_capacity=S_b, marshal=m, overflow="retain"), dev,
                          health=TC.brownout_mask(R))
        d.start()
        trace = [d.observe()]
        while d.running():
            d.step()
            trace.append(d.observe())
        res = d.result()
        paths[f"balance_brownout_{m}"] = KN.launch_counts()
        check(res["rounds"] == sim["rounds"] and res["done"] and res["drops"] == 0 and res["bad_ballast"] == 0
              and np.array_equal(res["delivered"], sim["delivered"]) and [t[0] for t in trace] == sim["retained_trace"]
              and [t[1] for t in trace] == sim["age_trace"],
              f"(a) brownout drive {m}: {res['rounds']} rounds, checksums, retained and age traces == the oracle")
    out["brownout"] = {"rounds": sim["rounds"], "retained_peak": max(sim["retained_trace"]), "oracle_s": oracle_s}

    # (b) rebalance of a skewed population
    pq = _rebalance_population(dev, R, C, N1, P)
    cpu_pq = _to_cpu(pq)
    n_res = np.array([C] + [N1] * (R - 1))
    pend_to = np.zeros(R, np.int64)
    for r in range(1, R):
        pend_to[(r + 1) % R] += P
    variants = [("global_flat", ForwardConfig(R, C, peer_capacity=C // 2), "global", None)]
    for sizes in ((2, 4), (2, 2, 2)):
        caps = tuple(C * int(np.prod(sizes[l + 1:])) for l in range(len(sizes)))
        name = "x".join(map(str, sizes))
        hcfg = ForwardConfig(R, C, exchange="hierarchical", level_sizes=sizes, level_capacities=caps)
        variants += [(f"global_{name}", hcfg, "global", None), (f"intra_{name}", hcfg, "intra", None)]
    hbad = torch.ones(R, dtype=torch.bool)
    hbad[3] = False
    variants.append(("evacuate_flat", ForwardConfig(R, C, peer_capacity=C // 2), "global", hbad))
    times = {}
    for label, cfg, scope, health in variants:
        comm = StackedCollectives()
        KN.reset_launch_counts()
        bq, btotal = rebalance(pq, cfg, scope=scope, health=None if health is None else health.to(dev), comm=comm)
        paths[f"balance_rebalance_{label}"] = KN.launch_counts()
        counts = bq.count.cpu().numpy().astype(np.int64)
        ok = int(bq.drops.sum()) == 0 and int(btotal) == int(pq.count.sum()) == counts.sum()
        if scope == "intra":
            F = cfg.level_sizes[-1]
            want = np.zeros(R, np.int64)
            for g in range(R // F):
                grp = slice(g * F, (g + 1) * F)
                want[grp] = n_res[grp].sum() // F
                for r in range(g * F, (g + 1) * F):
                    src = (r - 1) % R
                    if src > 0 and src // F == g:  # in-group pending delivered
                        want[r] += P
                    if r > 0 and (r + 1) % R // F != g:  # cross-group pending held back
                        want[r] += P
            ok = ok and (counts == want).all()
            fast = len(cfg.level_sizes) - 1
            tiers = sorted((c.kind, -1 if c.tier is None else c.tier) for c in comm.calls.elements())
            check(tiers == sorted([("all_gather", fast), ("all_to_all", fast), ("all_to_all", fast), ("psum", fast),
                                   ("psum", -1)]),
                  f"(b) {label}: every call at the last tier but the total's psum: {tiers}")
        elif health is None:
            mean = n_res.sum() / R
            base = counts - pend_to
            ok = ok and set(base.tolist()) <= {int(np.floor(mean)), int(np.ceil(mean))}
        else:
            ok = ok and counts[3] == 0
        check(ok, f"(b) rebalance {label}: counts {counts.tolist()}, 0 drops, conserved")
        if cpu_witness:
            cq, ctotal = rebalance(cpu_pq, cfg, scope=scope, health=health)
            check(_same_queue(bq, cq, all_lanes=False) and torch.equal(
                      torch.where(torch.arange(C)[None] < cq.count[:, None], bq.dest.cpu(), 0),
                      torch.where(torch.arange(C)[None] < cq.count[:, None], cq.dest, 0)),
                  f"(b) rebalance {label} on the card == on the CPU, lanes < count")
        times[label] = timer(lambda: rebalance(pq, cfg, scope=scope, health=None if health is None else health.to(dev)),
                             reps=reps)
    print("  (b) rebalance median ms: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
    out["rebalance_ms"] = times

    # (c) queue cycling of the Fig-8 rays
    q = _fig8_queue(dev, R, C, seed=48)
    cpu_q = _to_cpu(q)
    pcfg = ForwardConfig(R, C, peer_capacity=S)
    fq, ftotal = forward_work(q, pcfg)
    check(int(fq.drops.sum()) == 0, "(c) the padded round drops nothing")
    ref_rows = [_sorted_by_pixel(fq, r) for r in range(R)]
    cyc = {}
    first = None
    for m in ("sort", "scatter"):
        for ov in ("drop", "retain"):
            cfg = ForwardConfig(R, C, marshal=m, overflow=ov)
            comm = StackedCollectives()
            KN.reset_launch_counts()
            absorbed, total = deliver_by_cycling(q, cfg, comm=comm)
            launches = KN.launch_counts()
            paths[f"balance_cycle_{m}_{ov}"] = launches
            kinds = sorted((c.kind, c.shape) for c in comm.calls.elements())
            check(kinds == sorted([("ppermute", (R, C, 12))] * R + [("ppermute", (R,))] * R + [("psum", (R,))]),
                  f"(c) cycling {m} {ov}: {R} payload and {R} count ppermute calls, one psum")
            if cuda:
                want = dict.fromkeys(launches, 0)
                park = 1 if ov == "retain" else 0
                if m == "sort":
                    want.update(pack_and_histogram=R, gather_rows=R, compact_positions=R + park)
                else:
                    want.update(scatter_rows=R, compact_positions=2 * R + park)
                check(launches == want, f"(c) cycling {m} {ov}: launches {launches}")
            ok = int(total) == int(ftotal) and int(absorbed.drops.sum()) == 0 and torch.equal(absorbed.count, fq.count)
            ok = ok and all(torch.equal(_sorted_by_pixel(absorbed, r), ref_rows[r]) for r in range(R))
            check(ok, f"(c) cycling {m} {ov}: every rank's rows, sorted by pixel, == the padded round's")
            if first is None:
                first = absorbed
            else:
                check(_same_queue(absorbed, first, all_lanes=False), f"(c) cycling {m} {ov} == sort drop, lanes < count")
            if cpu_witness and (m, ov) in cycle_cpu:
                ca, ctotal = deliver_by_cycling(cpu_q, cfg)
                check(_same_queue(absorbed, ca, all_lanes=False) and int(total) == int(ctotal),
                      f"(c) cycling {m} {ov} on the card == on the CPU, lanes < count")
            cyc[f"{m}_{ov}"] = timer(lambda: deliver_by_cycling(q, cfg), reps=reps)
    for m in ("sort", "scatter"):
        cyc[f"padded_round_{m}"] = timer(lambda: forward_work(q, ForwardConfig(R, C, peer_capacity=S, marshal=m)),
                                         reps=reps)
    print("  (c) median ms: " + ", ".join(f"{k} {v:.3f}" for k, v in cyc.items()), flush=True)
    out["cycling_ms"] = cyc
    return out, paths


# --------------------------------------------------------------- 8. recovery
def _manifest_bytes(ckpt_dir, step):
    import numpy as np

    from repro_torch import ckpt

    return sum(int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize
               for e in ckpt.load_manifest(ckpt_dir, step)["leaves"])


def _kernel_copy_ms(fn, calls=2, warmup=1):
    """Device ms of one call of ``fn`` under ``torch.profiler``: its
    kernels, and its copies and memsets, apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    copies = sum(e.self_device_time_total for e in events if _short(e.key).startswith("Mem"))
    kernels = sum(e.self_device_time_total for e in events) - copies
    return kernels / 1e3 / calls, copies / 1e3 / calls


def _boundary_split(ctx, carry, where, reps=3):
    """One boundary's host work on ``carry``, split: the host copy (one
    device-to-host copy a leaf), ``np.save`` serialisation and SHA-256 of
    every leaf, and ``ckpt.save_checkpoint`` whole (serialise, hash, write
    with fsync, publish); medians of ``reps``, in seconds."""
    import torch

    from repro_torch import ckpt
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.core import recovery as TREC

    parts = {"copy": [], "serialise": [], "sha256": [], "save": []}
    for i in range(reps):
        if carry["total"].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = TREC._host_carry(carry, ctx.cfg)
        t1 = time.perf_counter()
        raws = [CK.npy_bytes(a) for a in ckpt.tree_flatten(host)[0]]
        t2 = time.perf_counter()
        for raw in raws:
            CK.digest(raw)
        t3 = time.perf_counter()
        ckpt.save_checkpoint(where, i, host, keep=1, meta=TREC._meta_of(ctx, carry["rnd"]))
        t4 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(v)
    out = {k: statistics.median(v) for k, v in parts.items()}
    out["write_fsync"] = out["save"] - out["serialise"] - out["sha256"]
    out["bytes"] = sum(len(r) for r in raws)
    return out


def phase_recovery(dev, R=8, E=32768, C=262144, S=8192, EVERY=3, PREEMPT=5, DRAIN_AT=9, R4=4, C4=524288,
                   CREDIT=(10, 8192, 65536), oracle=True, profile=True):
    """The recovery law at full width on the card, ``chaos.ChaosItem`` rows
    (3 words): (a) ``rotating_hotspot(R, 8, E)`` through
    ``chaos.run_scenario_checkpointed`` at C, S peer slots, retain, the
    ring on, a checkpoint every ``EVERY`` rounds, in both marshals:
    uninterrupted, preempted at ``PREEMPT`` and resumed, and with no
    checkpoint directory — equal digests at every common boundary, the
    checksums ``expected_by_rank``, nothing lost or dropped, the rounds and
    result of ``run_scenario`` (and the oracle's traces); (b) the same drive
    preempted at its first drain-phase boundary and resumed on ``R4`` ranks
    at ``C4``: the global checksums the schedule's, nothing lost or dropped,
    the relayout timed; (c) ``incast_collapse(R, *CREDIT[:2])`` through the
    credit drive (S = ``CREDIT[2]``), preempted and resumed: equal digests;
    (d) the cost: bytes and seconds a boundary (host copy, serialise,
    SHA-256, write with fsync), the segmented drive's device time a round
    against ``run_until_done``'s (kernels and copies apart, each drive
    twice, in turns), and the syncs of a body round with the accounting
    counters against one without.  Returns ``(record, launches
    per path)``."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import chaos as TC
    from repro_torch import ckpt
    from repro_torch import kernels as KN
    from repro_torch.chaos import driver as TD
    from repro_torch.core import recovery as TREC
    from repro_torch.core import termination as TERM

    out, paths = {}, {}
    sc = TC.rotating_hotspot(R, 8, E)
    expected = expected_fast(sc)
    root = pathlib.Path(tempfile.mkdtemp(prefix="rafi_recovery_"))
    fs = subprocess.run(["df", "-T", str(root)], capture_output=True, text=True).stdout.strip().splitlines()[-1:]
    print(f"  checkpoints under {root} ({' '.join(fs[0].split()[:2]) if fs else 'filesystem unknown'})", flush=True)
    kw = dict(capacity=C, peer_capacity=S, overflow="retain", device=dev)
    try:
        refs = {m: TC.run_scenario(R, sc, marshal=m, **kw) for m in ("sort", "scatter")}
        for m, ref in refs.items():
            check(ref["done"] and ref["drops"] == 0 and ref["lost"] == 0 and np.array_equal(ref["delivered"], expected),
                  f"(a) run_scenario {m}: {ref['rounds']} rounds, checksums == expected_by_rank, 0 drops, 0 lost")
        if oracle:
            sim = lossless_oracle(sc, S, C)
            check(all(list(r["retained_trace"]) == sim["retained_trace"] and list(r["age_trace"]) == sim["age_trace"]
                      and r["rounds"] == sim["rounds"] for r in refs.values()),
                  f"(a) run_scenario's ring traces == the oracle's, {sim['rounds']} rounds")

        # (a) the main path, launches counted from 0 over every drive of it
        KN.reset_launch_counts()
        runs, walls = {}, {}
        for m in ("sort", "scatter"):
            for label, extra in (("a", {}), ("b", {"preempt_at": PREEMPT}), ("none", {})):
                where = None if label == "none" else root / f"{m}_{label}"
                t0 = time.perf_counter()
                runs[m, label] = TC.run_scenario_checkpointed(R, sc, marshal=m, ckpt_dir=where, checkpoint_every=EVERY,
                                                              keep=99, **extra, **kw)
                walls[m, label] = time.perf_counter() - t0
        paths["recovery"] = KN.launch_counts()
        skip = ("ckpt_dir", "steps", "preempted")
        for m in ("sort", "scatter"):
            a, b, none = runs[m, "a"], runs[m, "b"], runs[m, "none"]
            da, db = TC.boundary_digests(root / f"{m}_a"), TC.boundary_digests(root / f"{m}_b")
            common = sorted(set(da) & set(db))
            check(b["preempted"] and not a["preempted"] and len(common) >= 3 and all(da[s] == db[s] for s in common)
                  and a["steps"] == b["steps"],
                  f"(a) {m}: preempted at {PREEMPT} and resumed, digests == uninterrupted at boundaries {common}")
            check(all(np.array_equal(r["delivered"], expected) and r["lost"] == 0 and r["drops"] == 0 and r["done"]
                      and r["rounds"] == refs[m]["rounds"] for r in (a, b, none)),
                  f"(a) {m}: uninterrupted, resumed, no directory: checksums == expected_by_rank, 0 lost, 0 drops, "
                  f"{refs[m]['rounds']} rounds (run_scenario's)")
            check(none["steps"] == [] and sorted(k for k in none if k not in skip) == sorted(refs[m])
                  and _same_result({k: none[k] for k in refs[m]}, refs[m]),
                  f"(a) {m}: ckpt_dir=None == run_scenario, every key")
            nb = _manifest_bytes(root / f"{m}_a", a["steps"][0])
            print(f"  (a) {m}: {a['rounds']} rounds, boundaries {a['steps']}, {nb:,} B a boundary; wall s "
                  f"uninterrupted {walls[m, 'a']:.3f}, preempted + resumed {walls[m, 'b']:.3f}, no directory "
                  f"{walls[m, 'none']:.3f}", flush=True)
            out[f"a_{m}"] = {"rounds": a["rounds"], "steps": a["steps"], "bytes_a_boundary": nb,
                             "wall_s": {k[1]: walls[k] for k in walls if k[0] == m}}
        rounds = refs["sort"]["rounds"]
        if dev.type == "cuda":
            # a forward: the sort plan (K3), send and spill gathers (K1), K2;
            # the scatter plan (K4, K5), the spill gather (K1), K2; K6 in every
            # body round's enqueue (the seed queue comes from the host)
            f, n = 3 * (rounds + 1), 3 * rounds
            want = dict.fromkeys(paths["recovery"], 0)
            want.update(pack_and_histogram=f, gather_rows=3 * f, unmarshal=2 * f, rank_and_histogram=f,
                        scatter_rows=f, compact_positions=2 * n)
            check(paths["recovery"] == want, f"(a) launches over six drives of {rounds + 1} forwards: "
                                             f"{paths['recovery']}")
        da, db = TC.boundary_digests(root / "sort_a"), TC.boundary_digests(root / "scatter_a")
        same = [i for i in range(len(da[0])) if all(da[s][i] == db[s][i] for s in da)]
        print(f"  (a) sort and scatter checkpoints digest-equal on {len(same)} of {len(da[0])} leaves", flush=True)
        out["sort_scatter_equal_leaves"] = same
        for m in ("sort", "scatter"):
            for label in ("a", "b"):
                shutil.rmtree(root / f"{m}_{label}")

        # (b) preempted at the first drain-phase boundary, resumed on R4 ranks
        KN.reset_launch_counts()
        t0 = time.perf_counter()
        el = TC.run_scenario_checkpointed(R, sc, ckpt_dir=root / "elastic", checkpoint_every=EVERY, keep=99,
                                          preempt_at=DRAIN_AT, resume_ranks=R4, resume_capacity=C4, **kw)
        wall_el = time.perf_counter() - t0
        paths["recovery_elastic"] = KN.launch_counts()
        got = el["delivered"].astype(np.uint64)
        exp = expected.astype(np.uint64)
        check(el["preempted"] and el["done"] and el["lost"] == 0 and el["drops"] == 0 and got.shape[0] == R4
              and all(int(got[:, i].sum() % (1 << 32)) == int(exp[:, i].sum() % (1 << 32)) for i in range(3)),
              f"(b) preempted at {DRAIN_AT}, resumed on {R4} ranks at C={C4}: global checksums == the schedule's, "
              f"0 lost, 0 drops, {el['rounds']} rounds")
        man = ckpt.load_manifest(root / "elastic", DRAIN_AT)
        check(man["meta"]["num_ranks"] == R4, f"(b) boundary {DRAIN_AT} republished on {R4} ranks")
        # the relayout alone, from the 8-rank boundary the drive halted at
        ctx8 = TD._make_ctx(R, **kw)
        ctx4 = TD._make_ctx(R4, capacity=C4, peer_capacity=S, overflow="retain", device=dev)
        halted = TREC.run_checkpointed(ctx8, TD._make_round_fn(ctx8, sc), TD._seed_queue(sc, C, device=dev),
                                       TD._aux0(R, dev), ckpt_dir=root / "halt", checkpoint_every=EVERY, keep=99,
                                       halt_after_round=DRAIN_AT)
        man8 = ckpt.load_manifest(root / "halt", DRAIN_AT)
        aux_like = tuple(np.zeros((R4,), np.uint32) for _ in range(3))
        _, treedef = ckpt.tree_flatten(TREC._carry_like(ctx4, aux_like))
        like8 = ckpt.tree_unflatten(treedef, [np.zeros(tuple(e["shape"]), np.dtype(e["dtype"])) for e in man8["leaves"]])
        old = ckpt.restore_checkpoint(root / "halt", DRAIN_AT, like8, device=dev)
        in_flight = int(old["total"])
        relayout = []
        for _ in range(3):
            t0 = time.perf_counter()
            new = TREC._elastic_restore(old, ctx4, R_old=R, C_old=C, aux_restore=None)
            int(new["total"])  # waits for the relayout's last kernel
            relayout.append(time.perf_counter() - t0)
        check(halted is None and int(new["total"]) == in_flight and int(new["drops"].sum()) == int(old["drops"].sum()),
              f"(b) relayout of boundary {DRAIN_AT}: {in_flight} rows in flight, all placed on {R4} ranks")
        print(f"  (b) boundary {DRAIN_AT}: {in_flight:,} rows in flight; relayout 8 -> {R4} ranks "
              f"{1e3 * statistics.median(relayout):.1f} ms (median of 3); the elastic drive {wall_el:.3f} s, "
              f"{el['rounds']} rounds", flush=True)
        out["elastic"] = {"rows_in_flight": in_flight, "relayout_ms": 1e3 * statistics.median(relayout),
                          "rounds": el["rounds"], "wall_s": wall_el}
        shutil.rmtree(root / "elastic")

        # (c) the credit drive, preempted and resumed
        rounds_c, E_c, S_c = CREDIT
        csc = TC.incast_collapse(R, rounds_c, E_c)
        ckw = dict(capacity=C, peer_capacity=S_c, overflow="retain", flow="credit", device=dev)
        KN.reset_launch_counts()
        ca = TC.run_scenario_checkpointed(R, csc, ckpt_dir=root / "credit_a", checkpoint_every=EVERY, keep=99, **ckw)
        cb = TC.run_scenario_checkpointed(R, csc, ckpt_dir=root / "credit_b", checkpoint_every=EVERY, keep=99,
                                          preempt_at=PREEMPT, **ckw)
        paths["recovery_credit"] = KN.launch_counts()
        da, db = TC.boundary_digests(root / "credit_a"), TC.boundary_digests(root / "credit_b")
        common = sorted(set(da) & set(db))
        cexp = expected_fast(csc)
        check(cb["preempted"] and len(common) >= 3 and all(da[s] == db[s] for s in common)
              and all(np.array_equal(r["delivered"], cexp) and r["lost"] == 0 and r["drops"] == 0 and r["done"]
                      for r in (ca, cb)) and ca["rounds"] == cb["rounds"],
              f"(c) incast_collapse({R}, {rounds_c}, {E_c}) credit drive: {ca['rounds']} rounds, preempted at "
              f"{PREEMPT} and resumed, digests == uninterrupted at {common}, checksums == expected_by_rank")
        out["credit"] = {"rounds": ca["rounds"], "steps": ca["steps"]}
        shutil.rmtree(root / "credit_a")
        shutil.rmtree(root / "credit_b")

        # (d) the cost of a boundary and of the segmented drive
        ctx = TD._make_ctx(R, **kw)
        rfn = TD._make_round_fn(ctx, sc)
        carry = TERM.drive_start(TD._seed_queue(sc, C, device=dev), TD._aux0(R, dev), ctx.cfg, comm=ctx.comm,
                                 accounting=True)
        carry = TERM.drive_segment(rfn, carry, ctx.cfg, seg_end=EVERY, comm=ctx.comm)
        split = _boundary_split(ctx, carry, root / "cost")
        print(f"  (d) a boundary at round {carry['rnd']}: {split['bytes']:,} B; s: host copy {split['copy']:.4f}, "
              f"serialise {split['serialise']:.4f}, SHA-256 {split['sha256']:.4f}, write with fsync "
              f"{split['write_fsync']:.4f} (save whole {split['save']:.4f})", flush=True)
        out["boundary"] = split
        if dev.type == "cuda":
            plain = {k: v for k, v in carry.items() if k not in ("emitted", "delivered")}
            syncs = {name: _sync_warnings(lambda c=c: TERM.drive_segment(rfn, c, ctx.cfg, seg_end=c["rnd"] + 1,
                                                                       comm=ctx.comm))
                     for name, c in (("accounting", carry), ("plain", plain))}
            check(syncs["accounting"] <= syncs["plain"], f"(d) a body round with the accounting counters: syncs "
                                                         f"{syncs['accounting']} <= {syncs['plain']} without")
            out["round_syncs"] = syncs
        if profile:  # in turns: segmented, run_until_done, run_until_done, segmented
            f1 = refs["sort"]["rounds"] + 1
            drives = {"segmented": lambda: TC.run_scenario_checkpointed(R, sc, ckpt_dir=None, checkpoint_every=EVERY,
                                                                        **kw),
                      "run_until_done": lambda: TC.run_scenario(R, sc, **kw)}
            split = {k: [] for k in drives}
            for k in ("segmented", "run_until_done", "run_until_done", "segmented"):
                split[k].append(tuple(ms / f1 for ms in _kernel_copy_ms(drives[k])))
            for k, v in split.items():
                print(f"  (d) {k}: device ms a forwarding round, kernels / copies: "
                      + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in v) + f" ({f1} forwards a drive)", flush=True)
            out["device_ms_a_round"] = {k: [{"kernels": a, "copies": b} for a, b in v] for k, v in split.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, paths


# ----------------------------------------------------------- 9. streamlines
def profile_drive(run, dev, kernel=None):
    """Device-busy share of one drive under ``torch.profiler``: summed
    device time of every kernel and copy over the drive's wall time (the
    profiler's own overhead lengthens the wall time, so the share is a
    lower bound), and, given a ``kernel`` name, that kernel's share of the
    device time.  Returns None when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = _device_events(prof)
    dev_us = lambda e: e.self_device_time_total
    busy_us = sum(dev_us(e) for e in stats)
    if busy_us <= 0:
        print("  device-busy share: not measured (the profiler saw no device time)", flush=True)
        return None
    top = sorted(stats, key=dev_us, reverse=True)[:6]
    share = busy_us / 1e6 / wall
    print(f"  profiled drive: wall {wall:.3f} s, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * share:.1f}%), top device time: "
          + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.2f} ms" for e in top), flush=True)
    out = {"wall_s": wall, "device_busy_ms": busy_us / 1e3, "busy_share": share,
           "top": [(e.key[:200], dev_us(e) / 1e3) for e in top]}
    if kernel is not None:
        k_us = sum(dev_us(e) for e in stats if kernel in e.key)
        out[f"{kernel}_share"] = k_us / busy_us
        print(f"  {kernel}: {k_us / 1e3:.1f} ms, {100 * k_us / busy_us:.1f}% of the device time", flush=True)
    return out


def phase_streamlines(dev, fields=(("ABC", 0, 131072), ("tornado", 1, 16384), ("Taylor-Green", 2, 16384)),
                      max_steps=64, exact=True, profile=True):
    import numpy as np

    from repro_torch import kernels as KN
    from repro_torch.apps import streamlines as sl

    main_launches, out = None, {}
    for name, fid, n in fields:
        cfg = sl.StreamlineConfig(num_particles=n, max_steps=max_steps, dt=0.1, field_id=fid)
        KN.reset_launch_counts()
        t0 = time.perf_counter()
        traces, lengths, stats = sl.run(cfg, num_ranks=8, device=dev)
        wall = time.perf_counter() - t0
        run_launches = KN.launch_counts()
        if main_launches is None:
            main_launches = run_launches  # the main path: reset just before, read just after
        orc = sl.oracle(cfg, device=dev)
        after_oracle = KN.launch_counts()
        same_mask = np.array_equal(np.isfinite(traces), np.isfinite(orc))
        m = np.isfinite(traces) & np.isfinite(orc)
        err = float(np.abs(traces[m] - orc[m]).max()) if m.any() else 0.0
        rounds = stats["rounds"]
        print(f"  {name}: N={n} rounds {rounds} mean streamline length {lengths.mean():.2f} "
              f"wall {wall:.3f} s oracle max err {err!r}", flush=True)
        check(same_mask, f"{name}: finite masks of run and oracle identical")
        check(err == 0.0 if exact else err <= 5e-4, f"{name}: multi-rank traces == single-rank oracle (max err {err!r})")
        check(stats["drops"] == 0, f"{name}: drops == 0")
        if dev.type == "cuda":
            check(after_oracle["rk4_step"] == rounds + max_steps,
                  f"{name}: K8 launches {after_oracle['rk4_step']} == body rounds {rounds} + oracle steps {max_steps}")
            for k in ("pack_and_histogram", "gather_rows", "unmarshal"):
                check(run_launches[k] == rounds + 1,
                      f"{name}: {k} launches {run_launches[k]} == forwarding rounds {rounds + 1}")
            # one enqueue builds the first queue, one per body round re-emits
            check(run_launches["compact_positions"] == rounds + 1,
                  f"{name}: K6 launches {run_launches['compact_positions']} == enqueue calls {rounds + 1}")
        out[name] = {"n": n, "rounds": rounds, "mean_length": float(lengths.mean()),
                     "wall_s": wall, "oracle_max_err": err}
        if profile and dev.type == "cuda" and name == fields[0][0]:
            out[name]["profile"] = profile_drive(lambda: sl.run(cfg, num_ranks=8, device=dev), dev)
    return out, main_launches


# ---------------------------------------------------------------- 10. vopat
def phase_vopat(dev, size=1024, R=8, profile=True, N_WORDS=2097152, CPU_SIZE=64):
    """The VoPaT main path: ``render`` through ``run_until_done`` with the
    scatter marshal, held against the R=1 render and the R=8 sort render,
    and against the CPU (the uniforms, and a ``CPU_SIZE``² render)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.apps import rng, vopat

    scene = vopat.VopatScene(width=size, height=size, spp=1, max_bounces=4, albedo=0.85, num_blobs=6)
    render = lambda r, marshal: vopat.render(scene, num_ranks=r, marshal=marshal, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    img, st = render(R, "scatter")  # ends in a copy to the host: synchronised
    wall = time.perf_counter() - t0
    launches = KN.launch_counts()
    rounds = st["rounds"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")
    print(f"  {size}x{size}, R={R}, scatter: rounds {rounds} wall {wall:.3f} s "
          f"({1e3 * wall / (rounds + 1):.2f} ms per forwarding round) drops {st['drops']} "
          f"queue capacity {st['capacity']} peak device memory {peak:.2f} GiB", flush=True)
    check(st["drops"] == 0, f"vopat: drops == 0 ({st['drops']})")
    if dev.type == "cuda":
        for k in ("rank_and_histogram", "scatter_rows", "unmarshal"):
            check(launches[k] == rounds + 1, f"vopat: {k} launches {launches[k]} == forwarding rounds {rounds + 1}")
        check(launches["compact_positions"] == rounds + 1,
              f"vopat: K6 launches {launches['compact_positions']} == enqueue calls {rounds + 1}")
        check(launches["gather_rows"] == 0 and launches["pack_and_histogram"] == 0,
              f"vopat: the scatter drive launched no K1 and no K3: {launches}")
    t1 = time.perf_counter()
    img1, st1 = render(1, "sort")
    wall1 = time.perf_counter() - t1
    t1 = time.perf_counter()
    img_sort, st_sort = render(R, "sort")
    wall_sort = time.perf_counter() - t1
    print(f"  R=1 render: rounds {st1['rounds']} wall {wall1:.3f} s; R={R} sort render: rounds "
          f"{st_sort['rounds']} wall {wall_sort:.3f} s; image mean {img.mean():.6f}", flush=True)
    check(np.array_equal(img, img1), f"vopat: R={R} scatter image == R=1 image, bit for bit")
    check(np.array_equal(img, img_sort), f"vopat: R={R} scatter image == R={R} sort image, bit for bit")
    check(bool(np.isfinite(img).all()) and img.min() >= 0.0 and img.max() <= 1.0,
          f"vopat: image finite and in [0, 1] (min {img.min()}, max {img.max()})")
    check(img.std() > 0.01, f"vopat: image is not constant (std {img.std():.4f})")

    # witnesses that share no arithmetic with the card: the uniforms'
    # threefry words on the CPU (bit for bit), and a small render on the CPU
    # (>= 99% of pixels within 1e-5, means within 1e-4: the tolerance of
    # tests/test_torch_vopat.py, since the card's expf/logf may differ by ulps)
    gen = torch.Generator().manual_seed(2024)
    pix = torch.randint(0, 2**31 - 1, (N_WORDS,), generator=gen, dtype=torch.int32)
    ev = torch.randint(0, 2**31 - 1, (N_WORDS,), generator=gen, dtype=torch.int32)
    u_dev = rng.event_uniforms(rng.key_from_seed(scene.seed, device=dev), pix.to(dev), ev.to(dev), 3).cpu()
    u_cpu = rng.event_uniforms(rng.key_from_seed(scene.seed), pix, ev, 3)
    check(torch.equal(u_dev.view(torch.int32), u_cpu.view(torch.int32)),
          f"vopat: uniforms of {N_WORDS} (pixel, event) pairs on {dev.type} == on the CPU, bit for bit")
    small = dataclasses.replace(scene, width=CPU_SIZE, height=CPU_SIZE)
    img_dev, _ = vopat.render(small, num_ranks=R, marshal="scatter", device=dev)
    img_cpu, _ = vopat.render(small, num_ranks=R, marshal="scatter", device="cpu")
    close = float((np.abs(img_dev - img_cpu) <= 1e-5).mean())
    mean_gap = abs(float(img_dev.mean()) - float(img_cpu.mean()))
    print(f"  {CPU_SIZE}x{CPU_SIZE} render on {dev.type} against the CPU: max abs diff "
          f"{float(np.abs(img_dev - img_cpu).max())!r}, share within 1e-5 {close!r}, "
          f"mean gap {mean_gap!r}", flush=True)
    check(close >= 0.99 and mean_gap <= 1e-4,
          f"vopat: {CPU_SIZE}x{CPU_SIZE} R={R} scatter render on {dev.type} == CPU render "
          f"({100 * close:.2f}% of pixels within 1e-5, mean gap {mean_gap:.2e})")
    out = {"size": size, "num_ranks": R, "rounds": rounds, "wall_s": wall,
           "ms_per_round": 1e3 * wall / (rounds + 1), "peak_gib": peak, "r1_wall_s": wall1,
           "sort_wall_s": wall_sort, "image_mean": float(img.mean()),
           "cpu_witness": {"size": CPU_SIZE, "max_abs_diff": float(np.abs(img_dev - img_cpu).max()),
                           "share_within_1e-5": close, "mean_gap": mean_gap}}
    if profile and dev.type == "cuda":
        out["profile"] = profile_drive(lambda: render(R, "scatter"), dev)
    return out, launches


# ---------------------------------------------------------------- 11. nbody
def phase_nbody(dev, N=262144, R=8, steps=8, WITNESS_N=512, profile=True):
    """The N-body main path: ``run`` at R=8 against the direct-sum oracle,
    the R=1 run, launches per run, and a small run on the card against the
    same run on the CPU.  G = 64/N keeps G·M_total at the value of the
    64-particle, G = 1 system under which the reference set its 1e-2 bound
    (``tests/test_apps.py``); at the 256-particle example's G·M_total of 256
    the reference itself misses that bound (``examples/nbody_sim.py``)."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as KN
    from repro_torch.apps import nbody

    cfg = nbody.NBodyConfig(num_particles=N, steps=steps, dt=5e-4, theta=0.3, eps2=1e-3, g=64.0 / N)
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    pos, vel, st = nbody.run(cfg, num_ranks=R, device=dev)  # ends in copies to the host
    wall = time.perf_counter() - t0
    launches = KN.launch_counts()
    po, vo = nbody.oracle(cfg, device=dev)
    err = float(np.abs(pos - po).max())
    t1 = time.perf_counter()
    p1, _, st1 = nbody.run(cfg, num_ranks=1, device=dev)
    wall1 = time.perf_counter() - t1
    err1 = float(np.abs(p1 - po).max())
    print(f"  N={N}, R={R}, {steps} steps: wall {wall:.3f} s ({1e3 * wall / steps:.1f} ms per step), "
          f"totals {st['totals']}, drops {st['drops']}, max |pos - oracle| {err!r}, "
          f"rms |vel - oracle| {float(np.sqrt(((vel - vo) ** 2).mean()))!r}; R=1: wall {wall1:.3f} s, "
          f"max |pos - oracle| {err1!r}", flush=True)
    # K9 runs over every lane of every rank's queue (capacity N), as the
    # reference does; the final owners say how many of those pairs are live
    cell = lambda a, g: np.clip((a * g).astype(np.int32), 0, g - 1)
    gx, gy, gz = st["dims"]
    live = np.bincount(cell(pos[:, 0], gx) + gx * (cell(pos[:, 1], gy) + gy * cell(pos[:, 2], gz)),
                       minlength=R)
    m_src = N + 2 * max(16, 9 * R)
    live_share = float((live * (live + m_src - N)).sum()) / (R * N * m_src)
    print(f"  particles per rank at the end {live.tolist()}; K9 computes {R * N * m_src:.3e} pairs a step, "
          f"{100 * live_share:.2f}% of them between live lanes", flush=True)
    check(st["totals"] == [N] * steps and st["drops"] == 0,
          f"nbody: every particle conserved (totals {N} each step, drops {st['drops']})")
    check(bool(np.isfinite(pos).all() and np.isfinite(vel).all()), "nbody: positions and velocities finite")
    check(err < 1e-2, f"nbody: R={R} positions within 1e-2 of the direct-sum oracle ({err:.3e})")
    check(st1["totals"] == [N] * steps and err1 <= 1e-5, f"nbody: R=1 positions within 1e-5 of the oracle ({err1!r})")
    if dev.type == "cuda":
        want = dict.fromkeys(launches, 0)
        want.update(pairwise_accel=steps, pack_and_histogram=4 * steps, gather_rows=4 * steps,
                    unmarshal=4 * steps, compact_positions=4 * steps + 1)
        check(launches == want, f"nbody: K9 once a step, K3/K1/K2 four times, K6 once per enqueue: {launches}")

    # a witness off the card: the same small run on the CPU (plain versions)
    small = dataclasses.replace(cfg, num_particles=WITNESS_N, g=64.0 / WITNESS_N)
    t2 = time.perf_counter()
    pd, vd, sd = nbody.run(small, num_ranks=R, device=dev)
    wall_small = time.perf_counter() - t2  # a step's fixed cost: launches of four small rounds
    pc, vc, sc = nbody.run(small, num_ranks=R, device="cpu")
    gap_p, gap_v = float(np.abs(pd - pc).max()), float(np.abs(vd - vc).max())
    print(f"  N={WITNESS_N} R={R} on {dev.type}: wall {wall_small:.3f} s ({1e3 * wall_small / steps:.2f} ms "
          f"per step); against the CPU: max |pos| gap {gap_p!r}, max |vel| gap {gap_v!r}", flush=True)
    check(sd == sc and gap_p <= 1e-5 and gap_v <= 1e-4,
          f"nbody: N={WITNESS_N} run on {dev.type} == CPU run (totals, drops; pos 1e-5, vel 1e-4)")
    out = {"n": N, "num_ranks": R, "steps": steps, "g": cfg.g, "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
           "oracle_max_err": err, "r1_wall_s": wall1, "live_per_rank": live.tolist(), "k9_live_pair_share": live_share, "r1_oracle_max_err": err1,
           "cpu_witness": {"n": WITNESS_N, "pos_gap": gap_p, "vel_gap": gap_v, "wall_s": wall_small}}
    if profile and dev.type == "cuda":
        out["profile"] = profile_drive(lambda: nbody.run(cfg, num_ranks=R, device=dev), dev,
                                       kernel="pairwise_accel")
    return out, launches


# ------------------------------------------------------------------ 12. obs
PHASE_CASES = (  # (label, ForwardConfig keywords) of phase obs (a)
    ("flat_sort", {}), ("flat_scatter", {"marshal": "scatter"}),
    ("flat_S2", {"pipeline_shards": 2}), ("flat_S4", {"pipeline_shards": 4}),
    ("2x4", {"exchange": "hierarchical", "level_sizes": (2, 4)}),
    ("2x2x2", {"exchange": "hierarchical", "level_sizes": (2, 2, 2)}),
)


def phase_vocabulary(cfg):
    """The phase keys ``obs.phases.profile_phases`` must give ``cfg``, in
    order (the reference's vocabulary)."""
    flat = ["marshal", "count_collective", "payload_collective", "unmarshal"]
    if cfg.exchange == "hierarchical":
        tiers = [l for l in reversed(range(len(cfg.level_sizes))) if cfg.level_sizes[l] > 1]
        return [f"tier{l}_{p}" for l in tiers for p in flat[:3]] + ["unmarshal"]
    return flat + [f"shard{k}_{p}" for k in range(cfg.pipeline_shards if cfg.pipeline_shards > 1 else 0)
                   for p in ("marshal", "payload_collective", "unmarshal")]


def _prom_values(text):
    """``{name{labels}: value}`` of a Prometheus text exposition; raises on
    a line that is not a comment or a sample."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        key, value = line.rsplit(" ", 1)
        if not key or " " in key:
            raise ValueError(f"not a sample line: {line!r}")
        out[key] = float(value)
    return out


def phase_obs(dev, R=8, C=262144, S=65536, FIT=(10, 8192), FULL=(10, 65536), FULL_ROUNDS=48,
              timeit=None, round_timer=None):
    """The observation law on the card: (a) ``obs.phases.profile_phases``
    of the Fig-8 round (R, C, S, the 44-byte ray) in each of ``cases``: the
    reference's keys, each stage's device ms beside the fused round's; (b)
    one Fig-8 round and one ``run_until_done`` drive (the FIT incast, open,
    retain) with ``obs.trace.capture()`` and without: the same calls,
    launches, host syncs and results; (c) the flight report at card size:
    ``incast_collapse(R, *FIT)`` open and credit (both finish) and
    ``incast_collapse(R, *FULL)`` (the tests' 2× fan-in) open to its end and
    credit for ``FULL_ROUNDS`` forwards (the law's floor, PERF.md §6),
    through ``chaos.run_scenario`` → ``chaos_capture`` → ``save_capture`` →
    ``load_capture`` → ``analyze`` and ``render``: the full open run the
    only degraded run, every check of the others ok; (d) the Prometheus
    text of the FULL open drive's ring parses and its drop counters equal
    the ring's and the queue's.  Returns ``(record, launches per path)``."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.chaos import driver as TD
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work
    from repro_torch.obs import metrics as OM
    from repro_torch.obs import phases as OP
    from repro_torch.obs import report as OR
    from repro_torch.obs import trace as OT

    cuda = dev.type == "cuda"
    if timeit is None:  # device ms of a stage: 20 calls under torch.profiler
        timeit = lambda fn, x: (1e3 * device_ms(lambda: fn(x))[0], None)
    if round_timer is None:
        round_timer = lambda fn: device_ms(fn)[0]
    out, paths = {"phases": {}}, {}
    Ray44 = _ray44_types()
    proto = Ray44(origin=torch.zeros(3), direction=torch.zeros(3), tmin=torch.zeros(()),
                  pixel=torch.zeros((), dtype=torch.int32), integral=torch.zeros(()), extra=torch.zeros(2))
    q = _fig8_queue(dev, R, C)

    # (a) the stage split of each round, beside the fused round's device time
    for label, kw in PHASE_CASES:
        cfg = ForwardConfig(R, C, peer_capacity=S, **kw) if "level_sizes" not in kw else ForwardConfig(R, C, **kw)
        KN.reset_launch_counts()
        phase_us = OP.profile_phases(cfg, n_emit=C, cap=C, proto=proto, timeit=timeit, device=dev)
        paths[f"obs_phases_{label}"] = KN.launch_counts()
        check(list(phase_us) == phase_vocabulary(cfg),
              f"(a) {label}: phase keys == the reference's vocabulary {phase_vocabulary(cfg)}")
        fused = round_timer(lambda: forward_work(q, cfg))
        stage_ms = {k: v / 1e3 for k, v in phase_us.items()}
        out["phases"][label] = {"stage_ms": stage_ms, "fused_round_ms": fused}
        print(f"  (a) {label}: fused round {fused:.4f} ms of {'device' if cuda else 'host'} time; stages standalone (sum "
              f"{sum(stage_ms.values()):.4f}): " + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items()),
              flush=True)
    doc = OP.to_perfetto(phase_us, num_ranks=R, tag=label)
    check(sum(e["ph"] == "X" for e in doc["traceEvents"]) == R * len(phase_us),
          f"(a) to_perfetto: one span a stage and rank ({R * len(phase_us)})")

    # (b) observation adds no call, launch or sync
    cfg = ForwardConfig(R, C, peer_capacity=S)
    sc = TC.incast_collapse(R, FIT[0], FIT[1])
    ctx = TD._make_ctx(R, capacity=C, peer_capacity=S, overflow="retain", device=dev)
    rfn, aux_base = TD._drive_parts(ctx, sc)
    seed = TD._seed_queue(sc, C, device=dev)
    calls = {
        "round": lambda comm: forward_work(q, cfg, comm=comm),
        "drive": lambda comm: ctx.run_until_done(rfn, max_rounds=64)(seed, tuple(a.clone() for a in aux_base)),
    }
    seen = {}
    for traced in (False, True):
        for what, fn in calls.items():
            comm = ctx.comm if what == "drive" else StackedCollectives()
            comm.reset()
            KN.reset_launch_counts()
            with (OT.capture() if traced else contextlib.nullcontext()) as tr:
                res = fn(comm)
                launches = KN.launch_counts()
                syncs = _sync_warnings(lambda: fn(StackedCollectives())) if cuda else 0
            paths[f"obs_{what}{'_traced' if traced else ''}"] = launches
            seen[what, traced] = (dict(comm.calls), launches, syncs, res, tr)
    for what in calls:
        (c0, l0, s0, r0, _), (c1, l1, s1, r1, _) = seen[what, False], seen[what, True]
        check(c0 == c1 and l0 == l1 and s0 == s1 and _same_output(r0, r1),
              f"(b) {what}: traced == untraced: calls ({sum(c0.values())}), launches {l0}, syncs {s0}, results")
        out[f"{what}_calls"], out[f"{what}_syncs"] = sum(c0.values()), s0
    spans = seen["drive", True][4].select(name="drive.run_until_done")
    check(len(spans) == (3 if cuda else 1), f"(b) the traced drive recorded its spans ({len(spans)})")

    # (c) the flight report at card size
    runs, results = [], {}
    for tag, (rounds_sc, E), max_rounds in (("fit", FIT, 1024), ("full", FULL, FULL_ROUNDS)):
        for flow in ("open", "credit"):
            sc = TC.incast_collapse(R, rounds_sc, E)
            t0 = time.perf_counter()
            res = TC.run_scenario(R, sc, capacity=C, peer_capacity=S, overflow="retain", flow=flow,
                                  max_rounds=max_rounds if flow == "credit" else 1024, device=dev)
            wall = time.perf_counter() - t0
            name = f"{sc.name}_{tag}_{flow}"
            results[name] = {k: res[k] for k in ("rounds", "done", "drops", "delivered_total", "emitted", "resident",
                                                  "goodput", "wasted_wire_rows", "emit_overflow")}
            results[name]["wall_s"] = wall
            runs.append(OR.chaos_capture(name, res, flow=flow, tier_capacities=(S,), capacity=C))
            print(f"  (c) {name}: {res['rounds']} rounds, done {res['done']}, delivered {res['delivered_total']} of "
                  f"{res['emitted']}, drops {res['drops']}, goodput {res['goodput']:.4f}, wall {wall:.3f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "capture.json"
        OR.save_capture(path, runs, meta={"source": "chip_smoke", "shape": [R, C, S]})
        report = OR.analyze(OR.load_capture(path))
    print("  " + OR.render(report).rstrip().replace("\n", "\n  "), flush=True)
    full_open = "incast_collapse_full_open"
    check(report["degraded_runs"] == [full_open], f"(c) degraded runs == [{full_open}]: {report['degraded_runs']}")
    for r in report["runs"]:
        if r["name"] != full_open:
            check(all(c["ok"] for c in r["checks"]), f"(c) {r['name']}: every check ok")
    out["report"] = {"runs": results, "degraded_runs": report["degraded_runs"],
                     "flags": {r["name"]: r["flags"] for r in report["runs"]}}

    # (d) the Prometheus text of a full-width ring: parses, drops == the ring's
    sc = TC.incast_collapse(R, *FULL)
    ctx = TD._make_ctx(R, capacity=C, peer_capacity=S, overflow="retain", device=dev)
    rfn, aux0 = TD._drive_parts(ctx, sc)
    qd, *_rest, ring = ctx.run_until_done(rfn, max_rounds=1024)(TD._seed_queue(sc, C, device=dev), aux0)
    text = OM.to_prometheus(OM.burst_metrics(ring, ctx.cfg))
    vals = _prom_values(text)
    st = ring.stats
    ring_drops = int(st.stage_drops.sum()) + int(st.recv_drops.sum())
    check(vals["rafi_drops_total"] == ring_drops and vals["rafi_recv_drops_total"] == int(st.recv_drops.sum())
          and vals['rafi_stage_drops_total{tier="0"}'] == int(st.stage_drops.sum())
          and vals["rafi_wasted_wire_rows_total"] == int(st.wasted_wire_rows.sum())
          and vals["rafi_emit_overflow_total"] == int(st.emit_overflow.sum())
          and vals["rafi_drops_total"] + vals["rafi_emit_overflow_total"] == int(qd.drops.sum()) > 0,
          f"(d) Prometheus text of the ring ({len(vals)} samples) parses; drops {vals['rafi_drops_total']:.0f} == "
          f"the ring's, + emission cuts == the queue's {int(qd.drops.sum())}")
    out["prometheus_samples"] = len(vals)
    return out, paths


def _same_output(a, b) -> bool:
    """Two outputs of ``forward_work`` or of a drive, equal: queues on every
    lane, tensors and tuples of tensors bit for bit, stats rings leaf for
    leaf, everything else by ``==``."""
    import torch

    from repro_torch.core import WorkQueue
    from repro_torch.telemetry import StatsRing

    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, WorkQueue):
            ok = _same_queue(x, y, all_lanes=True) and torch.equal(x.dest.cpu(), y.dest.cpu())
        elif isinstance(x, StatsRing):
            ok = _same_stats(x.stats, y.stats) and torch.equal(x.pos.cpu(), y.pos.cpu())
        elif torch.is_tensor(x):
            ok = torch.equal(x.cpu(), y.cpu())
        elif isinstance(x, tuple):
            ok = _same_output(x, y)
        else:
            ok = x == y
        if not ok:
            return False
    return True


# ---------------------------------------------------------------- 13. apps2
def phase_apps2(dev, size=1024, R=8, CPU_SIZE=64, PROFILE_ROUNDS=4, profile=True):
    """The §5.2 lander and the §5.3 schlieren app at ``size``² (VoPaT's
    frame size, the scenes' 32 slabs and 8 samples a slab): the lander's
    forwarding image at R equal bit for bit to R=1 with no drop; deep
    compositing at 4 fragments dropping none and within 1e-5 of it, at 1
    dropping fragments and off by more than 1e-3; schlieren's u and v at R
    equal to R=1 bit for bit; a ``CPU_SIZE``² render of each on the card
    within the CPU tests' 1e-5 of the CPU render (the forwarding renders
    on one CPU rank); rounds, wall time,
    launches, peak memory, and the device-busy share of each over its
    first ``PROFILE_ROUNDS`` + 1 forwarding rounds.  Returns
    ``(record, launches per path)``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.apps import lander, schlieren
    from repro_torch.core import pack_spec

    cuda = dev.type == "cuda"
    out, paths = {}, {}

    def timed(label, fn):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        KN.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()  # ends in a copy to the host: synchronised
        wall = time.perf_counter() - t0
        paths[label] = KN.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
        return res, wall, paths[label], peak

    def check_launches(label, launches, rounds):
        if not cuda:
            return
        want = dict.fromkeys(launches, 0)
        want.update(pack_and_histogram=rounds + 1, gather_rows=rounds + 1, unmarshal=rounds + 1,
                    compact_positions=rounds + 1)
        check(launches == want, f"{label}: K3, K1, K2 once a forwarding round ({rounds + 1}), K6 once an enqueue: "
                                f"{launches}")

    hw = size * size
    words = pack_spec(lander._proto()).total_words
    print(f"  {size}x{size}, R={R}: queue (R, {hw}, {words}) words {R * hw * words * 4 / 1e9:.2f} GB, padded send "
          f"and receive buffers (R, R, {hw}, {words}) {R * R * hw * words * 4 / 1e9:.2f} GB each", flush=True)

    # the lander: forwarding at R and at 1, deep compositing at 4 and 1 fragments
    scene = lander.LanderScene(width=size, height=size)
    (img, st), wall, launches, peak = timed("lander", lambda: lander.render_forwarding(scene, num_ranks=R, device=dev))
    check(st["drops"] == 0, f"lander: drops == 0 ({st['drops']})")
    check_launches("lander", launches, st["rounds"])
    (img1, st1), wall1, _l1, _p1 = timed("lander_r1", lambda: lander.render_forwarding(scene, num_ranks=1, device=dev))
    print(f"  lander: R={R} {st['rounds']} rounds, wall {wall:.3f} s ({1e3 * wall / (st['rounds'] + 1):.1f} ms a "
          f"forwarding round), peak device memory {peak:.2f} GiB; R=1 {st1['rounds']} rounds, wall {wall1:.3f} s",
          flush=True)
    check(np.array_equal(img, img1), f"lander: R={R} image == R=1 image, bit for bit")
    check(bool(np.isfinite(img).all()) and img.std() > 0.01, f"lander: image finite, not constant (std {img.std():.4f})")
    dc = {}
    for f in (4, 1):
        (dimg, dst), dwall, _dl, dpeak = timed(f"lander_dc{f}", lambda: lander.render_deep_compositing(
            scene, num_ranks=R, max_fragments=f, device=dev))
        err = float(np.abs(dimg - img).max())
        dc[f] = {"dropped_fragments": dst["dropped_fragments"], "max_abs_diff": err, "wall_s": dwall, "peak_gib": dpeak}
        print(f"  deep compositing, {f} fragment(s): dropped {dst['dropped_fragments']}, max |dc - forwarding| "
              f"{err!r}, wall {dwall:.3f} s, peak {dpeak:.2f} GiB", flush=True)
    check(dc[4]["dropped_fragments"] == 0 and dc[4]["max_abs_diff"] <= 1e-5,
          f"lander: deep compositing at 4 fragments drops none and lies within 1e-5 ({dc[4]['max_abs_diff']:.2e})")
    check(dc[1]["dropped_fragments"] > 0 and dc[1]["max_abs_diff"] > 1e-3,
          f"lander: at 1 fragment it drops {dc[1]['dropped_fragments']} and errs by {dc[1]['max_abs_diff']:.3f} > 1e-3")
    out["lander"] = {"size": size, "num_ranks": R, "rounds": st["rounds"], "wall_s": wall,
                     "ms_per_round": 1e3 * wall / (st["rounds"] + 1), "peak_gib": peak, "r1_wall_s": wall1,
                     "image_mean": float(img.mean()), "deep_compositing": dc}

    # schlieren: both knife edges at R and at 1
    sscene = schlieren.SchlierenScene(width=size, height=size)
    (u, v, sst), swall, slaunches, speak = timed("schlieren", lambda: schlieren.render(sscene, num_ranks=R, device=dev))
    check(sst["drops"] == 0, f"schlieren: drops == 0 ({sst['drops']})")
    check_launches("schlieren", slaunches, sst["rounds"])
    (u1, v1, sst1), swall1, _l, _p = timed("schlieren_r1", lambda: schlieren.render(sscene, num_ranks=1, device=dev))
    print(f"  schlieren: R={R} {sst['rounds']} rounds, wall {swall:.3f} s ({1e3 * swall / (sst['rounds'] + 1):.1f} ms "
          f"a forwarding round), peak {speak:.2f} GiB; R=1 {sst1['rounds']} rounds, wall {swall1:.3f} s", flush=True)
    check(np.array_equal(u, u1) and np.array_equal(v, v1), f"schlieren: R={R} u and v == R=1, bit for bit")
    check(float(np.abs(u - v).max()) > 0.01, "schlieren: the knife edges differ")
    out["schlieren"] = {"size": size, "num_ranks": R, "rounds": sst["rounds"], "wall_s": swall,
                        "ms_per_round": 1e3 * swall / (sst["rounds"] + 1), "peak_gib": speak, "r1_wall_s": swall1}

    # witnesses off the card: CPU_SIZE² renders on the CPU (plain versions);
    # the forwarding renders are R-invariant bit for bit on either device, so
    # the CPU renders them on one rank (an eighth of the lanes)
    t0 = time.perf_counter()
    small, ssmall = (dataclasses.replace(s, width=CPU_SIZE, height=CPU_SIZE) for s in (scene, sscene))
    gaps = {
        "lander": np.abs(lander.render_forwarding(small, num_ranks=R, device=dev)[0]
                         - lander.render_forwarding(small, num_ranks=1, device="cpu")[0]).max(),
        "lander_dc4": np.abs(lander.render_deep_compositing(small, num_ranks=R, device=dev)[0]
                             - lander.render_deep_compositing(small, num_ranks=R, device="cpu")[0]).max(),
    }
    ud, vd, _ = schlieren.render(ssmall, num_ranks=R, device=dev)
    uc, vc, _ = schlieren.render(ssmall, num_ranks=1, device="cpu")
    gaps["schlieren"] = max(np.abs(ud - uc).max(), np.abs(vd - vc).max())
    gaps = {k: float(g) for k, g in gaps.items()}
    check(all(g <= 1e-5 for g in gaps.values()),
          f"{CPU_SIZE}x{CPU_SIZE} renders on {dev.type} (R={R}) within 1e-5 of the CPU's (R=1; deep compositing "
          f"R={R}): {gaps}, {time.perf_counter() - t0:.1f} s")
    out["cpu_witness"] = {"size": CPU_SIZE, "max_abs_diff": gaps}
    if profile and cuda:  # a steady window: raygen and the first PROFILE_ROUNDS + 1 forwarding rounds
        for app, fn in (("lander", lambda: lander.render_forwarding(scene, num_ranks=R, max_rounds=PROFILE_ROUNDS,
                                                                     device=dev)),
                        ("schlieren", lambda: schlieren.render(sscene, num_ranks=R, max_rounds=PROFILE_ROUNDS,
                                                               device=dev))):
            t0 = time.perf_counter()
            out[app]["profile"] = profile_drive(fn, dev)
            print(f"  {app}: profiled its first {PROFILE_ROUNDS + 1} forwarding rounds in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out, paths


# --------------------------------------------------------------- 14. ragged
RAGGED_CASES = (("sort", {}), ("scatter", {"marshal": "scatter"}))


def _ragged_copy_inputs(q, R, C):
    """The sort round's send buffer and control plane (the inputs of its
    ``ragged_all_to_all``), built as ``exchange_ragged`` builds them."""
    from repro_torch.core import StackedCollectives
    from repro_torch.core import stages as ST
    from repro_torch.core import types as T
    from repro_torch.kernels.sort_keys import ops as sk_ops

    perm, _sorted, hist = sk_ops.sort_permutation(q.dest, q.count, R)
    packed, _spec = T.pack_payload(q.items, batch_dims=2)
    send = ST.ragged_send_buffer(packed, perm, hist[:, :R], num_ranks=R)
    cnt = StackedCollectives().all_gather(hist[:, :R])[0]
    ss, oo, rs = ST.ragged_control_plane(cnt, C)
    return packed, perm, hist[:, :R], send, dict(input_offsets=ST._excl_cumsum(hist[:, :R], 1), send_sizes=ss,
                                                 output_offsets=oo, recv_sizes=rs, capacity=C)


def phase_ragged(dev, R=8, C=262144, S=65536, E=32768, PAD_S=8192, STREAMLINES=(131072, 64), reps=10,
                 cpu_witness=True, timer=cuda_ms, dtimer=None):
    """``exchange="ragged"`` on the card: (a) the Fig-8 round (R, C, 44-byte
    rays, uniform destinations and ~6% DISCARD) in both marshals, the padded
    round at S peer slots first shown to drop nothing: ragged == onehot ==
    padded on lanes < count with equal counts and totals, sort == scatter,
    the sort round == the CPU's on every lane, 2 and 4 shards == 1; one
    ``ragged_all_to_all`` and one count ``all_gather`` a round (n of each
    at n shards), K3 + K1 twice (sort) or K4 + K5 + K1 (scatter), no K2;
    event medians and device ms beside the padded round's, the stage split,
    and the stacked copy's device ms beside the padded ``all_to_all``'s
    and its bound (2 × live rows × 44 B over 3.35 TB/s); (b)
    ``rotating_hotspot(R, 8, E)`` through the ragged retain drive open and
    under credit (the gated emitter) at C: nothing lost, no drop, the
    padded retain drive's (PAD_S slots) checksums and ``expected_by_rank``;
    rounds, peak backlog, ms a round; (c) streamlines (ABC, STREAMLINES =
    (particles, steps)) on ragged == its single-rank oracle bit for bit,
    wall beside the padded run's; (d) ``obs.phases.profile_phases`` of the
    ragged round: the reference's three keys and each stage's device ms
    beside the fused round's.  Returns ``(record, launches per path)``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.apps import streamlines as sl
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work
    from repro_torch.core import stages as ST
    from repro_torch.obs import phases as OP

    cuda = dev.type == "cuda"
    if dtimer is None:
        dtimer = lambda fn: device_ms(fn)[0]
    out, paths = {}, {}
    q = _fig8_queue(dev, R, C)
    words = 11

    # (a) the Fig-8 round against the onehot and padded placements
    pcfg = ForwardConfig(R, C, peer_capacity=S)
    pq, ptotal = forward_work(q, pcfg)
    check(int(pq.drops.sum()) == 0, f"(a) the padded round drops nothing at S={S}: {int(pq.drops.sum())}")
    oq, ototal = forward_work(q, ForwardConfig(R, C, exchange="onehot"))
    rounds = {}
    for label, kw in RAGGED_CASES:
        cfg = ForwardConfig(R, C, exchange="ragged", **kw)
        comm = StackedCollectives()
        KN.reset_launch_counts()
        gq, gtotal = forward_work(q, cfg, comm=comm)
        launches = KN.launch_counts()
        paths[f"ragged_round_{label}"] = launches
        rounds[label] = (gq, gtotal)
        if cuda:
            want = dict.fromkeys(launches, 0)
            want.update(pack_and_histogram=1, gather_rows=2) if label == "sort" else want.update(
                rank_and_histogram=1, scatter_rows=1, gather_rows=1)
            check(launches == want, f"(a) {label}: the plan, the send pass and K1's stacked copy, no K2: {launches}")
        kinds = sorted((c.kind, c.shape, n) for c, n in comm.calls.items())
        check(kinds == sorted([("all_gather", (R, R), 1), ("ragged_all_to_all", (R, C, words), 1), ("psum", (R,), 1)]),
              f"(a) {label}: one ragged_all_to_all, one count all_gather, the psum: {kinds}")
        for other, total, name in ((oq, ototal, "onehot"), (pq, ptotal, "padded")):
            check(_same_queue(gq, other, all_lanes=False) and int(gtotal) == int(total),
                  f"(a) ragged {label} == {name}: count, drops, total {int(gtotal)}, lanes < count")
        for n in (2, 4):
            scomm = StackedCollectives()
            sq, stotal = forward_work(q, dataclasses.replace(cfg, pipeline_shards=n), comm=scomm)
            check(_same_queue(sq, gq, all_lanes=False) and int(stotal) == int(gtotal)
                  and scomm.count("ragged_all_to_all") == n and scomm.count("all_gather") == n,
                  f"(a) {label} at {n} shards == 1 shard, {n} payload and {n} count calls")
    check(_same_queue(rounds["sort"][0], rounds["scatter"][0], all_lanes=False), "(a) ragged sort == scatter")
    if cuda:
        # telemetry, retain and a health mask add no call (the tests) and no host sync
        healthy = torch.ones(R, dtype=torch.bool, device=dev)
        syncs = {name: _sync_warnings(lambda: forward_work(q, c, health=h)) for name, c, h in (
            ("padded", pcfg, None), ("ragged", ForwardConfig(R, C, exchange="ragged"), None),
            ("ragged_telemetry_retain_health", ForwardConfig(R, C, exchange="ragged", telemetry=True,
                                                             overflow="retain"), healthy))}
        out["syncs"] = syncs
        check(syncs["ragged_telemetry_retain_health"] == syncs["ragged"] <= syncs["padded"],
              f"(a) synchronizing calls: ragged no more than padded, telemetry + retain + health add none: {syncs}")
    if cpu_witness:
        t0 = time.perf_counter()
        cq, ctotal = forward_work(_to_cpu(q), ForwardConfig(R, C, exchange="ragged"))
        check(_same_queue(rounds["sort"][0], cq, all_lanes=True) and int(rounds["sort"][1]) == int(ctotal),
              f"(a) the ragged sort round on the card == the CPU's, every lane ({time.perf_counter() - t0:.1f} s)")
    live = int(rounds["sort"][0].count.sum())
    print(f"  (a) {R}x{C} rays of 44 B: live rows {live}, total {int(rounds['sort'][1])}", flush=True)
    out["live_rows"] = live
    for label, kw in RAGGED_CASES:
        for ex, extra in (("ragged", {}), ("padded", {"peer_capacity": S})):
            cfg = ForwardConfig(R, C, exchange=ex, **kw, **extra)
            rec = {"round_ms": timer(lambda: forward_work(q, cfg), reps=reps),
                   "device_ms": dtimer(lambda: forward_work(q, cfg))}
            if ex == "ragged" and cuda:
                rec["round_ms_split"], rec["stages_ms"] = _time_round(q, cfg, reps)
            out[f"{ex}_{label}"] = rec
            print(f"  (a) {ex} {label}: median {rec['round_ms']:.4f} ms, device {rec['device_ms']:.4f} ms"
                  + (("; stages " + ", ".join(f"{k} {v:.3f}" for k, v in rec["stages_ms"].items()))
                     if "stages_ms" in rec else ""), flush=True)
    packed, perm, send_counts, send, plane = _ragged_copy_inputs(q, R, C)
    comm = StackedCollectives()
    copy_ms = dtimer(lambda: comm.ragged_all_to_all(send, None, **plane))
    pad_buf = ST.padded_send_buffer(packed, perm, send_counts, num_ranks=R, peer_capacity=S)
    a2a_ms = dtimer(lambda: comm.all_to_all(pad_buf))
    copy_bound = bound_ms(2 * live * words * 4)[0]
    out["copy"] = {"ragged_all_to_all_ms": copy_ms, "padded_all_to_all_ms": a2a_ms, "bound_ms": copy_bound,
                   "share_of_bound": copy_bound / copy_ms}
    print(f"  (a) the stacked ragged copy: {copy_ms:.4f} ms of device time, bound {copy_bound:.4f} ms "
          f"(2 x {live} live rows x 44 B / 3.35 TB/s), {100 * copy_bound / copy_ms:.1f}% of it; the padded "
          f"round's all_to_all {a2a_ms:.4f} ms", flush=True)

    # (b) the lossless drive, open and under credit, against the padded drive
    sc = TC.rotating_hotspot(R, 8, E)
    expected = expected_fast(sc)
    emitted = int(expected[:, 0].astype(np.int64).sum())
    pad = ScenarioDrive(sc, ForwardConfig(R, C, peer_capacity=PAD_S, overflow="retain"), dev)
    pad_res, pad_wall = pad.run()
    out["drive_padded"] = {"rounds": pad_res["rounds"], "wall_s": pad_wall}
    for label, kw, gated in (("open", {}, False), ("credit", {"flow": "credit"}, True)):
        cfg = ForwardConfig(R, C, exchange="ragged", overflow="retain", **kw)
        d = ScenarioDrive(sc, cfg, dev, gated=gated)
        d.start()
        trace = [d.observe()]
        while d.running(max_rounds=256):
            d.step()
            trace.append(d.observe())
        res = d.result()
        KN.reset_launch_counts()
        res2, wall = d.run(max_rounds=256)
        paths[f"ragged_drive_{label}"] = KN.launch_counts()
        lost = emitted - int(res["delivered"][:, 0].astype(np.int64).sum()) - res["resident"] - res["drops"]
        peak = max(t[0] for t in trace)
        check(lost == 0 and res["drops"] == 0 and res["done"] and res["bad_ballast"] == 0
              and np.array_equal(res["delivered"], expected) and np.array_equal(res["delivered"], pad_res["delivered"])
              and _same_result(res2, res),
              f"(b) ragged retain drive, {label}: lost {lost}, drops {res['drops']}, done, checksums == "
              f"expected_by_rank and the padded drive's ({pad_res['rounds']} rounds at {PAD_S} slots)")
        out[f"drive_{label}"] = {"rounds": res["rounds"], "peak_backlog": peak, "lost": lost, "wall_s": wall,
                                 "ms_a_round": 1e3 * wall / (res["rounds"] + 1)}
        print(f"  (b) {label}: rounds {res['rounds']}, peak backlog {peak}, lost {lost}, wall {wall:.3f} s, "
              f"{1e3 * wall / (res['rounds'] + 1):.2f} ms a round (padded: {pad_res['rounds']} rounds, "
              f"{pad_wall:.3f} s)", flush=True)

    # (c) streamlines on ragged against its oracle, beside the padded run
    n, steps = STREAMLINES
    scfg = sl.StreamlineConfig(num_particles=n, max_steps=steps, dt=0.1, field_id=0)
    walls = {}
    for ex in ("padded", "ragged"):
        KN.reset_launch_counts()
        t0 = time.perf_counter()
        traces, _lengths, stats = sl.run(scfg, num_ranks=R, exchange=ex, device=dev)
        walls[ex] = time.perf_counter() - t0
        if ex == "ragged":
            paths["ragged_streamlines"] = KN.launch_counts()
            orc = sl.oracle(scfg, device=dev)
            same = np.array_equal(np.isfinite(traces), np.isfinite(orc)) and np.array_equal(
                traces.view(np.uint32), orc.view(np.uint32))
            check(same and stats["drops"] == 0, f"(c) streamlines on ragged == the single-rank oracle, bit for bit "
                                                f"({stats['rounds']} rounds)")
    out["streamlines"] = walls
    print(f"  (c) streamlines {n} particles, {steps} steps: ragged {walls['ragged']:.3f} s, padded "
          f"{walls['padded']:.3f} s", flush=True)

    # (d) the phase split of the ragged round
    Ray44 = _ray44_types()
    proto = Ray44(origin=torch.zeros(3), direction=torch.zeros(3), tmin=torch.zeros(()),
                  pixel=torch.zeros((), dtype=torch.int32), integral=torch.zeros(()), extra=torch.zeros(2))
    timeit = lambda fn, x: (1e3 * dtimer(lambda: fn(x)), None)
    out["phases"] = {}
    for label, kw in RAGGED_CASES:
        cfg = ForwardConfig(R, C, exchange="ragged", **kw)
        KN.reset_launch_counts()
        phase_us = OP.profile_phases(cfg, n_emit=C, cap=C, proto=proto, timeit=timeit, device=dev)
        paths[f"ragged_phases_{label}"] = KN.launch_counts()
        keys = ["marshal", "count_collective", "payload_collective"]
        check(list(phase_us) == keys, f"(d) {label}: phase keys == the reference's {keys}")
        stage_ms = {k: v / 1e3 for k, v in phase_us.items()}
        out["phases"][label] = {"stage_ms": stage_ms, "fused_round_ms": out[f"ragged_{label}"]["device_ms"]}
        print(f"  (d) {label}: fused round {out[f'ragged_{label}']['device_ms']:.4f} ms; stages standalone: "
              + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items()), flush=True)
    return out, paths


# ------------------------------------------------------------------- 15. lm
LM_ARCH = "llama4-scout-17b-16e"
LM_KERNELS = ("compact_positions", "pack_and_histogram", "gather_rows", "unmarshal")  # K6, K3, K1, K2
# stated tolerances of phase lm (PERF.md §6), in logit units: the
# bfloat16 logits of the dispatch planes (c), which build the same expert
# buffers (measured bit-equal), and of decode against prefill and blocked
# against materialising attention (d), which round through other GEMM
# shapes; the logits' standard deviation is about 0.02·√5120·0.88 ≈ 1.26
LM_TOL_PLANES = 0.125
LM_TOL_PREFILL = 0.25
LM_TOL_SMOKE = 1e-4  # (e): the float32 smoke engine, card against CPU


def _lm_requests(vocab, n, prompt, new, seed=23):
    import numpy as np

    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(prompt[0], prompt[1] + 1))).astype(np.int32),
                    max_new_tokens=int(rng.integers(new[0], new[1] + 1))) for i in range(n)]


class _StepRecorder:
    """Stands in for ``engine.step_fn``: keeps every step's token batch,
    its CUDA event pair and (``keep_logits``) its logits on the host."""

    def __init__(self, engine, keep_logits=False):
        self.inner, self.keep = engine.step_fn, keep_logits
        engine.step_fn = self
        self.tokens, self.events, self.logits, self.last = [], [], [], None

    def __call__(self, params, token, caches):
        import torch

        self.tokens.append(token.clone())
        cuda = token.device.type == "cuda"
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        logits, caches = self.inner(params, token, caches)
        self.last = logits
        if cuda:
            ev[1].record()
            self.events.append(ev)
        if self.keep:
            self.logits.append(logits.float().cpu())
        return logits, caches


class _FirstRoute:
    """Keeps the first ``Route`` that ``moe.rafi_ep_dispatch`` is given."""

    def __enter__(self):
        from repro_torch.models import moe as M

        self.orig, self.route = M.rafi_ep_dispatch, None

        def keep(route, **kw):
            if self.route is None:
                self.route = route
            return self.orig(route, **kw)

        M.rafi_ep_dispatch = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M

        M.rafi_ep_dispatch = self.orig


class _KernelCalls:
    """Records the arguments of every K6, K3, K1 and K2 wrapper call."""

    def __enter__(self):
        from repro_torch.kernels.compact import ops as CO
        from repro_torch.kernels.marshal import ops as MO
        from repro_torch.kernels.sort_keys import ops as SO

        self.mods = {"compact_positions": CO, "pack_and_histogram": SO, "gather_rows": MO, "unmarshal": MO}
        self.orig = {k: getattr(m, k) for k, m in self.mods.items()}
        self.calls = {k: [] for k in self.mods}
        for k, m in self.mods.items():
            def wrap(*a, _k=k, **kw):
                self.calls[_k].append((a, kw))
                return self.orig[_k](*a, **kw)
            wrap.launches = 0  # the wrapped function counts its launches here meanwhile
            setattr(m, k, wrap)
        return self

    def __exit__(self, *exc):
        for k, m in self.mods.items():
            setattr(m, k, self.orig[k])


def _bits(t):
    import torch

    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32) if t.element_size() == 4 else t


def _same_delivered(a, b) -> bool:
    """Two delivered queues: counts and drops equal, every leaf bit-equal on lanes < count."""
    import dataclasses as dc

    import torch

    from repro_torch.models import moe as M

    if not (torch.equal(a.count.cpu(), b.count.cpu()) and torch.equal(a.drops.cpu(), b.drops.cpu())):
        return False
    for f in dc.fields(M.TokenItem):
        x, y = getattr(a.items, f.name).cpu(), getattr(b.items, f.name).cpu()
        for r in range(a.count.shape[0]):
            n = int(b.count[r])
            if not torch.equal(_bits(x[r, :n].contiguous()), _bits(y[r, :n].contiguous())):
                return False
    return True


def _lm_kernel_rows(route, label, timer, dtimer):
    """K6, K3, K1 and K2 at the shapes one dispatch round of ``route`` gives
    them, each timed beside its plain version, its library call where one
    exists, and its bound."""
    import torch

    from repro_torch.kernels.compact import ops as CO
    from repro_torch.kernels.marshal import ops as MO
    from repro_torch.kernels.sort_keys import ops as SO
    from repro_torch.models import moe as M

    with _KernelCalls() as kc:
        M.rafi_ep_dispatch(route)
    T = lambda *fns: _timed(timer, dtimer, *fns)
    rows = {}
    (mask,), _ = kc.calls["compact_positions"][0]
    rows["compact_positions"] = dict(
        shape=tuple(mask.shape), nbytes=mask.numel() * (1 + 4) + mask.shape[0] * 4, ops=0.0,
        library_call="torch.cumsum",
        **T(lambda: CO.compact_positions(mask), lambda: CO.compact_positions_plain(mask),
            lambda: torch.cumsum(mask, dim=1, dtype=torch.int32)))
    (dest, count), kw = kc.calls["pack_and_histogram"][0]
    keys, hist = SO.pack_and_histogram(dest, count, **kw)
    rows["pack_and_histogram"] = dict(
        shape=tuple(dest.shape), nbytes=(dest.numel() + count.numel() + keys.numel() + hist.numel()) * 4, ops=0.0,
        library_call=None,
        **T(lambda: SO.pack_and_histogram(dest, count, **kw), lambda: SO.pack_and_histogram_plain(dest, count, **kw)))
    (src, idx), _ = kc.calls["gather_rows"][0]
    B, C, W = src.shape
    uniq = sum(int(torch.unique(idx[r].clamp(0, C - 1)).numel()) for r in range(B))
    b_idx, idx_long = torch.arange(B, device=src.device)[:, None], idx.long().clamp(0, C - 1)
    rows["gather_rows"] = dict(
        shape=(tuple(src.shape), tuple(idx.shape)), words_a_rank=max(idx.shape[1], C) * W,
        nbytes=idx.numel() * 4 + uniq * W * 4 + idx.numel() * W * 4, ops=0.0,
        library_call="advanced indexing src[b, idx]",
        **T(lambda: MO.gather_rows(src, idx), lambda: MO.gather_rows_plain(src, idx),
            lambda: src[b_idx, idx_long]))
    (recv, off, counts), kw = kc.calls["unmarshal"][0]
    R, G, S, W = recv.shape
    cap = kw["capacity"]
    s_ar = torch.arange(S, device=recv.device)
    dst = off[:, :, None].long().clamp(0, cap) + s_ar
    keep = (s_ar < counts[:, :, None]) & (dst < cap)
    dst = torch.where(keep, dst, cap).reshape(R, G * S)
    bb = torch.arange(R, device=recv.device)[:, None].expand(R, G * S)
    flat = recv.reshape(R, G * S, W)

    def library():
        return torch.zeros(R, cap + 1, W, dtype=torch.int32, device=recv.device).index_put_((bb, dst), flat)

    ok = torch.equal(library()[:, :cap], MO.unmarshal_plain(recv, off, counts, capacity=cap))
    check(ok, f"(e) {label}: K2's library call == its plain version")
    rows["unmarshal"] = dict(
        shape=(tuple(recv.shape), cap), words_a_rank=max(G * S, cap) * W,
        nbytes=int(keep.sum()) * W * 4 + 2 * off.numel() * 4 + R * cap * W * 4, ops=0.0,
        library_call="zeros + index_put_ at precomputed positions",
        **T(lambda: MO.unmarshal(recv, off, counts, capacity=cap),
            lambda: MO.unmarshal_plain(recv, off, counts, capacity=cap), library))
    for k, r in rows.items():
        args, kw = kc.calls[k][0]
        a, b = getattr(kc.mods[k], k)(*args, **kw), getattr(kc.mods[k], f"{k}_plain")(*args, **kw)
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        check(same, f"(e) {label}: {k} {r['shape']} bit-equal to its plain version")
        r["max_abs_err"] = 0.0 if same else float(max((x.double() - y.double()).abs().max() for x, y in zip(a, b)))
        _print_row(f"{k} at the {label} shape", r)
    return rows


def _lm_step_split(step, params, token, caches, calls=3, comm=None):
    """Device time of one decode step by part, from ``torch.profiler``:
    the attention layers (whole or placed), the expert GEMMs
    (``moe._expert_ffn``), the two forwarding rounds, with ``comm`` the
    ``psum`` and ``all_gather`` calls of that backend (the tensor-parallel
    collectives, the combine's gather, and the rounds' count ``psum``s),
    and K1, K2, K3, K6 by kernel; each part's kernels are found through a
    ``record_function`` range around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import attention as A
    from repro_torch.models import moe as M

    parts = {"attention": [(A, "self_attention"), (A, "self_attention_placed")], "expert_ffn": [(M, "_expert_ffn")],
             "dispatch_round": [(M, "rafi_ep_dispatch")], "return_round": [(M, "rafi_ep_return")]}
    if comm is not None:
        parts["collectives"] = [(comm, "psum"), (comm, "all_gather")]
    orig = [(m, n, getattr(m, n)) for targets in parts.values() for m, n in targets]

    def ranged(name, fn):
        def w(*a, **kw):
            with record_function(f"lm.{name}"):
                return fn(*a, **kw)
        return w

    for k, targets in parts.items():
        for m, n in targets:
            setattr(m, n, ranged(k, getattr(m, n)))
    try:
        step(params, token, caches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                step(params, token, caches)
            torch.cuda.synchronize()
    finally:
        for m, n, f in orig:
            if m is comm:
                delattr(m, n)
            else:
                setattr(m, n, f)
    dev_us = lambda e: getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
    avgs = prof.key_averages()
    split = {k: None for k in parts}
    for e in avgs:
        if e.key.startswith("lm.") and e.device_type != torch.autograd.DeviceType.CUDA:
            split[e.key[3:]] = dev_us(e) / calls / 1e3
    kern, spans = {}, {}
    total = 0.0
    for e in _device_events(prof):
        if e.key.startswith("lm."):  # a range's span on the device timeline, idle gaps included
            spans[e.key[3:]] = e.self_device_time_total / calls / 1e3
            continue
        total += e.self_device_time_total
        for k, name in (("gather_rows", "gather_rows_kernel"), ("unmarshal", "unmarshal_kernel"),
                        ("pack_and_histogram", "pack_hist_kernel"), ("compact_positions", "compact_kernel")):
            if name in e.key:
                kern[k] = kern.get(k, 0.0) + e.self_device_time_total / calls / 1e3
    split = {k: (None if v is None or v == 0 else v) for k, v in split.items()}
    return {"step_device_ms": total / calls / 1e3, "parts_ms": split, "kernels_ms": kern, "spans_ms": spans}


def _lockstep(planes, params, tokens, slots, max_len, dev):
    """Teacher forcing: the same token batches through every plane's decode
    step from fresh caches, in lockstep.  Yields (step, {plane: (logits,
    drops)})."""
    from repro_torch.models.api import build_model

    steppers = {}
    for name, (cfg, layout) in planes.items():
        model = build_model(cfg)
        steppers[name] = [model.decode_fn(layout, drops=True), model.init_caches(slots, max_len, device=dev)]
    for i, tok in enumerate(tokens):
        out = {}
        for name, st in steppers.items():
            logits, st[1], d = st[0](params, tok, st[1])
            out[name] = (logits.float(), d)
        yield i, out


def _margin_compare(ref, other, tol):
    """(max |Δ|, rows whose top-2 margin is at or under ``tol``, argmax
    disagreements among the other rows, ‖Δ‖ / ‖ref‖, max |ref|)."""
    import torch

    diff = float((ref - other).abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    bad = int(((ref.argmax(-1) != other.argmax(-1)) & clear).sum())
    rel = float(torch.linalg.vector_norm(ref - other) / torch.linalg.vector_norm(ref))
    return diff, int((~clear).sum()), bad, rel, float(ref.abs().max())


def phase_lm(dev, LAYERS=4, SLOTS=16, MAX_LEN=128, LAYOUT=(1, 8), N_REQ=16, PROMPT=(8, 48), NEW=(8, 24),
             PREFILL=(2, 64), LONG=2048, SMOKE=(4, 8, 12, 12), widths=None, profile=True,
             timer=cuda_ms, dtimer=device_ms):
    """Phase lm: the LM serving path at full width (``widths`` narrows it
    for a rehearsal on the CPU)."""
    import copy
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.serve import BatchedEngine
    from repro_torch.models import moe as M
    from repro_torch.models.api import build_model

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out, paths = {}, {}
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()  # the earlier phases' cached blocks: this phase needs ~30 GiB at once

    # (a) the model: every field of CONFIG but the depth
    cfg = dc.replace(get_config(LM_ARCH), num_layers=LAYERS, **(widths or {}))
    model = build_model(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(2323), device=dev)
    sync()
    n_params = model.param_count()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(n_params == sum(p.numel() for p in params.parameters()), f"(a) param_count() {n_params} == the allocated parameters")
    out["model"] = {"params": n_params, "bytes": n_bytes, "init_s": time.perf_counter() - t0,
                    "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
                    "config": {k: v for k, v in dc.asdict(cfg).items() if k != "source"}}
    print(f"  (a) {cfg.name} at {LAYERS} of {get_config(LM_ARCH).num_layers} layers: {n_params} parameters, "
          f"{n_bytes} B ({cfg.dtype}), init {out['model']['init_s']:.2f} s, peak "
          f"{out['model']['peak_gib']} GiB", flush=True)

    # (b) serve: SLOTS slots over the (data, model) layout, capacity_factor of CONFIG
    layout = Layout(*LAYOUT)
    requests = _lm_requests(cfg.vocab_size, N_REQ, PROMPT, NEW)
    engine = BatchedEngine(model, params, slots=SLOTS, max_len=MAX_LEN, layout=layout, device=dev)
    rec = _StepRecorder(engine)
    first = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    engine._step(params, first, model.init_caches(SLOTS, MAX_LEN, device=dev))  # warm-up: first-use costs
    KN.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    served = engine.run(requests)
    sync()
    wall = time.perf_counter() - t0
    paths["lm_serve"] = KN.launch_counts()
    steps = engine.steps
    n_tok = sum(len(v) for v in served.values())
    drops = [int(d) for d in engine.step_drops]
    check(all(len(served[r.rid]) == r.max_new_tokens for r in requests),
          f"(b) all {N_REQ} requests answered with their max_new_tokens ({n_tok} tokens in {steps} steps)")
    step_ms = [a.elapsed_time(b) for a, b in rec.events] if cuda else []
    out["serve"] = {"steps": steps, "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
                    "step_ms_median": statistics.median(step_ms) if step_ms else None,
                    "step_ms_min": min(step_ms) if step_ms else None, "drops_per_step": drops,
                    "drops_total": sum(drops), "launches": paths["lm_serve"]}
    print(f"  (b) served {N_REQ} requests, {n_tok} tokens in {steps} steps, {wall:.3f} s wall, "
          f"{n_tok / wall:.1f} tokens/s; decode step (event median) {out['serve']['step_ms_median']} ms; "
          f"MoE drops {sum(drops)} (per step {drops})", flush=True)
    if cuda:
        per_step = {k: paths["lm_serve"][k] / steps for k in LM_KERNELS}
        out["serve"]["launches_per_step"] = per_step
        for k in LM_KERNELS:
            check(paths["lm_serve"][k] == 2 * LAYERS * steps,
                  f"(b) {k}: {paths['lm_serve'][k]} launches in {steps} steps = {per_step[k]} a step "
                  f"(two rounds a MoE layer, {LAYERS} layers: {2 * LAYERS})")
        others = {k: v for k, v in paths["lm_serve"].items() if k not in LM_KERNELS and v}
        check(not others, f"(b) no other kernel launched on the LM path: {others}")
    if profile and cuda:
        caches = model.init_caches(SLOTS, MAX_LEN, device=dev)
        split = _lm_step_split(engine._step, params, rec.tokens[-1], caches)
        out["serve"]["step_split"] = split
        print(f"  (b) one decode step, device ms: total {split['step_device_ms']:.4f}; parts "
              + ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in split["parts_ms"].items())
              + "; kernels " + ", ".join(f"{k} {v:.4f}" for k, v in split["kernels_ms"].items()), flush=True)

    # (c) the dispatch planes held against each other on the stream of (b),
    # at capacity_factor = E / top_k: no token can drop
    free = dc.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    planes = {f"rafi_ep tp={layout.model}": (free, layout), "rafi_ep tp=1": (free, Layout(1, 1)),
              "dense_tp": (dc.replace(free, moe_dispatch="dense_tp"), None)}
    ref_name = next(iter(planes))
    worst = {n: [0.0, 0, 0, True, 0.0] for n in planes}
    plane_drops = {n: 0 for n in planes}
    t0 = time.perf_counter()
    for i, res in _lockstep(planes, params, rec.tokens, SLOTS, MAX_LEN, dev):
        ref = res[ref_name][0]
        for name, (logits, d) in res.items():
            plane_drops[name] += int(d)
            diff, under, bad, _, top = _margin_compare(ref, logits, LM_TOL_PLANES)
            w = worst[name]
            w[0], w[1], w[2] = max(w[0], diff), w[1] + under, w[2] + bad
            w[3] = w[3] and torch.equal(ref, logits)
            w[4] = max(w[4], top)
    out["planes"] = {n: {"max_abs_diff": w[0], "rows_under_margin": w[1], "argmax_disagreements": w[2],
                         "bit_equal": w[3], "max_abs_logit": w[4], "drops": plane_drops[n]}
                     for n, w in worst.items()}
    out["planes_s"] = time.perf_counter() - t0
    for n, r in out["planes"].items():
        check(r["drops"] == 0, f"(c) {n} at capacity_factor {free.capacity_factor}: {r['drops']} drops")
        check(r["max_abs_diff"] <= LM_TOL_PLANES and r["argmax_disagreements"] == 0,
              f"(c) {n} against {ref_name}, {len(rec.tokens)} steps of {SLOTS} rows: max |dlogit| "
              f"{r['max_abs_diff']:.4g} <= {LM_TOL_PLANES} (bit-equal: {r['bit_equal']}; max |logit| "
              f"{r['max_abs_logit']:.3f}); argmax equal on every row whose top-2 margin exceeds it "
              f"({r['rows_under_margin']} rows under it)")

    # (d) decode against prefill, and the KV-blocked prefill against the
    # materialising one at S=LONG
    rng = np.random.default_rng(64)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, PREFILL).astype(np.int32)).to(dev)
    with _FirstRoute() as fr:
        pre = build_model(free).prefill_fn(layout)(params, {"tokens": prompts}).float()
    step = build_model(free).decode_fn(layout, drops=True)
    caches = model.init_caches(PREFILL[0], MAX_LEN, device=dev)
    dec_drops = 0
    for t in range(PREFILL[1]):
        last, caches, d = step(params, prompts[:, t:t + 1], caches)
        dec_drops += int(d)
    diff, under, bad, rel, top = _margin_compare(pre, last.float(), LM_TOL_PREFILL)
    out["prefill"] = {"max_abs_diff": diff, "rows_under_margin": under, "argmax_disagreements": bad,
                      "rel_l2": rel, "max_abs_logit": top, "decode_drops": dec_drops}
    check(diff <= LM_TOL_PREFILL and bad == 0 and dec_drops == 0,
          f"(d) prefill_fn of {PREFILL} tokens == the last of {PREFILL[1]} decode steps: max |dlogit| {diff:.4g} "
          f"<= {LM_TOL_PREFILL} (||d|| / ||logits|| {rel:.3g}, max |logit| {top:.3f}), argmax equal ({under} "
          f"rows under the margin), decode drops {dec_drops}")
    long_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LONG)).astype(np.int32)).to(dev)
    res = {}
    for blocked in (True, False):
        c = dc.replace(free, blocked_attention=blocked)
        sync()
        KN.reset_launch_counts()
        t0 = time.perf_counter()
        with _FirstRoute() as fr_long:
            res[blocked] = build_model(c).prefill_fn(layout)(params, {"tokens": long_toks}).float()
        sync()
        res[f"s{blocked}"] = time.perf_counter() - t0
        if blocked:
            long_route = fr_long.route
            paths["lm_prefill"] = KN.launch_counts()
    if cuda:
        check(all(paths["lm_prefill"][k] == 2 * LAYERS for k in LM_KERNELS)
              and not any(v for k, v in paths["lm_prefill"].items() if k not in LM_KERNELS),
              f"(d) the {LONG}-token prefill: K6, K3, K1, K2 launched {2 * LAYERS} times each, no other kernel "
              f"({paths['lm_prefill']})")
    diff, under, bad, rel, top = _margin_compare(res[False], res[True], LM_TOL_PREFILL)
    out["prefill_long"] = {"S": LONG, "max_abs_diff": diff, "rows_under_margin": under, "argmax_disagreements": bad,
                           "rel_l2": rel, "max_abs_logit": top, "blocked_s": res["sTrue"],
                           "materialising_s": res["sFalse"]}
    check(diff <= LM_TOL_PREFILL and bad == 0,
          f"(d) prefill at S={LONG}: _sdpa_blocked == the materialising _sdpa, max |dlogit| {diff:.4g} <= "
          f"{LM_TOL_PREFILL} (||d|| / ||logits|| {rel:.3g}, max |logit| {top:.3f}), argmax equal ({under} rows "
          f"under the margin); {res['sTrue']:.3f} s against {res['sFalse']:.3f} s")

    # (e) the kernels against their plain versions: the f32 smoke engine on
    # the card and on the CPU; the delivered queue of one dispatch round;
    # K6, K3, K1 and K2 at the decode and the prefill shapes
    scfg = get_smoke_config(LM_ARCH)
    s_slots, s_req, s_prompt, s_new = SMOKE
    lm_cpu = build_model(scfg).init(torch.Generator().manual_seed(5), device="cpu")
    runs = {}
    for where, p in (("card", copy.deepcopy(lm_cpu).to(dev)), ("cpu", lm_cpu)):
        d = dev if where == "card" else torch.device("cpu")
        eng = BatchedEngine(build_model(scfg), p, slots=s_slots, max_len=64, layout=Layout(2, 4), device=d)
        r = _StepRecorder(eng, keep_logits=True)
        runs[where] = (eng.run(_lm_requests(scfg.vocab_size, s_req, (2, s_prompt), (4, s_new), seed=5)), r.logits)
    same_tokens = runs["card"][0] == runs["cpu"][0]
    sdiff = max(float((a - b).abs().max()) for a, b in zip(runs["card"][1], runs["cpu"][1]))
    out["smoke"] = {"same_tokens": same_tokens, "max_abs_diff": sdiff, "steps": len(runs["cpu"][1])}
    check(same_tokens and sdiff <= LM_TOL_SMOKE,
          f"(e) {scfg.name} (float32) engine on layout (2, 4): the card's tokens == the CPU's, logits within "
          f"{sdiff:.3g} <= {LM_TOL_SMOKE} over {len(runs['cpu'][1])} steps")
    with _FirstRoute() as fr_dec:
        engine._step(params, rec.tokens[0], model.init_caches(SLOTS, MAX_LEN, device=dev))
    decode_route = fr_dec.route
    out["kernels"] = {}
    for label, route in (("decode", decode_route), ("prefill", long_route)):
        same = _same_delivered(M.rafi_ep_dispatch(route), M.rafi_ep_dispatch(route.to("cpu")))
        W = route.items.h.shape[-1] * route.items.h.element_size() // 4 + 4
        check(same, f"(e) the {label} dispatch round (R={route.fcfg.num_ranks}, C={route.fcfg.capacity}, "
                    f"S={route.fcfg.peer_capacity}, W={W} words): the delivered queue == the CPU's, bit for bit")
        if cuda:
            out["kernels"][label] = _lm_kernel_rows(route, label, timer, dtimer)
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase lm: {out['phase_s']:.1f} s, peak memory {out.get('peak_gib')} GiB", flush=True)
    return out, paths


# ---------------------------------------------------------------- 16. train
TRAIN_RUNS = (("qwen2-7b", 4, 10), (LM_ARCH, 1, 4))  # (arch, layers of CONFIG kept, steps)
BF16_PEAK = 989e12  # H100 SXM dense bfloat16 (NVIDIA data sheet)
MOE_LEAVES = ("blocks.k0_moe.moe.router", "blocks.k0_moe.moe.wi", "blocks.k0_moe.moe.wg", "blocks.k0_moe.moe.wo",
              "blocks.k0_moe.ln2")
# (c): the float32 smoke configs, card against CPU: the loss absolute, gnorm
# relative (the first tolerance, 1e-4 absolute for both, failed on gnorm:
# PERF.md §6)
TRAIN_TOL_WITNESS = 1e-4
TRAIN_TOL_RESUME = 1e-6  # (d): resumed against uninterrupted losses on the card


def _tree_paths(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_tree_paths(v, pre + k + ".") if isinstance(v, dict) else {pre + k: v})
    return out


class _TrainRecorder:
    """Stands in for ``launch.train.build_train_step``, ``launch.steps.
    adamw_update`` and ``models.moe.moe_block`` while a ``train`` call
    runs: each step's CUDA event pair, metrics (kept on the device) and
    launches; the gradients that came out of backward as ``None``; the
    watched leaves' first elements before and after each update; and each
    MoE call's drops, with whether backward ran it (a checkpoint's
    recompute)."""

    def __init__(self, watch=(), sample=1 << 20):
        self.watch, self.sample = watch, sample
        self.events, self.metrics, self.launches, self.none_grads, self.updates = [], [], [], [], []
        self.moe = []
        self.step = None

    def __enter__(self):
        import torch

        from repro_torch import kernels as KN
        from repro_torch.launch import steps as ST
        from repro_torch.launch import train as TR
        from repro_torch.models import moe as M

        self.mods = (TR, ST, M)
        self.orig = (TR.build_train_step, ST.adamw_update, M.moe_block)
        build, update, moe_block = self.orig

        def build_train_step(*a, **kw):
            inner = build(*a, **kw)

            def step(params, opt, batch):
                cuda = next(iter(params.parameters())).device.type == "cuda"
                before = KN.launch_counts()
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) if cuda else None
                if cuda:
                    ev[0].record()
                params, opt, met = inner(params, opt, batch)
                if cuda:
                    ev[1].record()
                self.events.append(ev)
                self.metrics.append(met)
                after = KN.launch_counts()
                self.launches.append({k: after[k] - before[k] for k in LM_KERNELS})
                return params, opt, met

            self.step = step
            return step

        def adamw_update(params, grads, state, cfg):
            self.none_grads.append({k for k, g in _tree_paths(grads).items() if g is None})
            flat = _tree_paths(params.tree() if hasattr(params, "tree") else params)
            take = lambda: {k: flat[k].detach().reshape(-1)[:self.sample].clone() for k in self.watch if k in flat}
            was = take()
            out = update(params, grads, state, cfg)
            lr = torch.clamp(state["step"].to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0) * cfg.lr
            self.updates.append((was, take(), lr, cfg.weight_decay))
            return out

        def moe(params, x, cfg, *, layout=None):
            in_backward = torch._C._current_graph_task_id() != -1  # a checkpoint's recompute
            y, d = moe_block(params, x, cfg, layout=layout)
            self.moe.append((len(self.metrics), in_backward, d))
            return y, d

        TR.build_train_step, ST.adamw_update, M.moe_block = build_train_step, adamw_update, moe
        return self

    def __exit__(self, *exc):
        TR, ST, M = self.mods
        TR.build_train_step, ST.adamw_update, M.moe_block = self.orig


def _attn_model_flops(cfg, tokens, seq):
    """Model FLOPs of one train step: 6 × the parameters a token's matmuls
    use (all but the embedding table; the experts at top_k / E) × tokens,
    plus the attention products, 12 × layers × seq × heads × head_dim ×
    tokens (forward and backward over the full S × S, as ``_sdpa``
    computes it).  The checkpoint's recompute is not counted.  This is not
    ``roofline.analysis.model_flops`` (the reference's 6·N·D, N with the
    embedding and without attention), which phase dryrun reports."""
    import math

    from repro_torch.models.api import build_model

    model = build_model(cfg)
    n = model.param_count() - math.prod(model.defs["embed"].shape)
    if cfg.kind == "moe":
        experts = sum(math.prod(model.defs["blocks"]["k0_moe"]["moe"][k].shape) for k in ("wi", "wg", "wo"))
        n -= experts * (1 - cfg.top_k / cfg.num_experts)
    return 6 * n * tokens + 12 * cfg.num_layers * seq * cfg.num_heads * cfg.head_dim * tokens


def _step_device_ms(step, params, opt, batch, calls=1):
    """Device time of one train step from ``torch.profiler``, by part:
    ``adamw`` (the kernels launched inside ``adamw_update``, through a
    ``record_function`` range), ``gemm`` (cuBLAS and CUTLASS kernels
    elsewhere in the step), ``rafi`` (K6, K3, K1, K2) and ``other`` (the
    rest: elementwise, reductions, copies); ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import steps as ST

    update = ST.adamw_update

    def ranged(*a, **kw):
        with record_function("train.adamw"):
            return update(*a, **kw)

    ST.adamw_update = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                step(params, opt, batch)
            torch.cuda.synchronize()
    finally:
        ST.adamw_update = update
    ms = lambda us: us / calls / 1e3
    total, gemm, rafi = 0.0, 0.0, 0.0
    for e in _device_events(prof):
        if e.key == "train.adamw":  # the range's span on the device timeline
            continue
        total += e.self_device_time_total
        if any(k in e.key for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
            gemm += e.self_device_time_total
        elif any(k in e.key for k in ("gather_rows_kernel", "unmarshal_kernel", "pack_hist_kernel", "compact_kernel")):
            rafi += e.self_device_time_total
    adamw = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
                if e.key == "train.adamw" and e.device_type != torch.autograd.DeviceType.CUDA)
    return {"total": ms(total), "adamw": ms(adamw), "gemm_outside_adamw": ms(gemm), "rafi_kernels": ms(rafi),
            "other": ms(total - adamw - gemm - rafi)}


def _train_full(dev, arch, layers, steps, *, batch, seq, layout, widths, profile, timer=cuda_ms, dtimer=device_ms):
    """(a) or (b): ``train()`` of CONFIG at ``layers`` layers, every other
    field as published, from a fresh checkpoint directory.  For an MoE
    config, the first dispatch round of the first step is held against the
    CPU's and K6, K3, K1 and K2 against their plain versions at its shape."""
    import dataclasses as dc
    import gc
    import math
    import tempfile

    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import train
    from repro_torch.models import moe as M
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig

    cuda = dev.type == "cuda"
    cfg = dc.replace(get_config(arch), num_layers=layers, **(widths or {}))
    moe = cfg.kind == "moe"
    n_params = build_model(cfg).param_count()
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()  # the earlier runs' cached blocks
        torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    with _TrainRecorder(watch=MOE_LEAVES if moe else ()) as rec, _FirstRoute() as fr, \
            tempfile.TemporaryDirectory() as ckpt_dir:
        params, opt, losses = train(arch=cfg, steps=steps, batch=batch, seq=seq, ckpt_dir=ckpt_dir, ckpt_every=0,
                                    layout=layout, opt_cfg=AdamWConfig(warmup_steps=20), verbose=False, device=dev)
        wall = time.perf_counter() - t0
        launches = KN.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
        gnorms = [float(m["gnorm"]) for m in rec.metrics]
        label = f"{'(b)' if moe else '(a)'} {cfg.name} at {layers} of {get_config(arch).num_layers} layers"
        r = {"params": n_params, "layers": layers, "steps": steps, "batch": batch, "seq": seq,
             "microbatches": cfg.microbatches, "remat": cfg.remat, "losses": [l for _, l in losses], "gnorms": gnorms,
             "wall_s": wall, "peak_gib": peak, "launches": launches, "launches_per_step": rec.launches}
        check(len(losses) == steps and all(math.isfinite(l) for _, l in losses) and all(map(math.isfinite, gnorms)),
              f"{label}: {steps} steps, losses and gnorm finite: losses {[round(l, 4) for _, l in losses]}, gnorm "
              f"{[round(g, 4) for g in gnorms]}")
        check(n_params == sum(p.numel() for p in params.parameters()),
              f"{label}: {n_params} parameters allocated")
        tokens = batch * seq
        r["model_flops"] = _attn_model_flops(cfg, tokens, seq)
        if cuda:
            ms = [a.elapsed_time(b) for a, b in rec.events]
            r["step_ms"] = ms
            r["first_step_ms"], r["step_ms_median"] = ms[0], statistics.median(ms[1:])
            r["tokens_per_s"] = tokens / (r["step_ms_median"] / 1e3)
            r["mfu_bf16_peak"] = r["model_flops"] / (r["step_ms_median"] / 1e3) / BF16_PEAK
            if profile:
                r["device_split_ms"] = _step_device_ms(rec.step, params, opt, SyntheticLM(cfg.vocab_size, seq, batch)
                                                       .batch_at(steps))
                r["device_ms"] = r["device_split_ms"]["total"]
                r["mfu_device"] = r["model_flops"] / (r["device_ms"] / 1e3) / BF16_PEAK
        print(f"  {label}: {n_params} parameters, batch {batch} x {seq}, {cfg.microbatches} microbatch(es), remat "
              f"{cfg.remat}; {steps} steps in {wall:.2f} s (init included); step event median "
              f"{r.get('step_ms_median')} ms (first {r.get('first_step_ms')}), device {r.get('device_split_ms')} ms, "
              f"{r.get('tokens_per_s')} tokens/s, model FLOPs {r['model_flops']:.4e} a step = "
              f"{r.get('mfu_bf16_peak')} of the 989e12 bf16 peak (device time: {r.get('mfu_device')}); peak "
              f"{peak} GiB", flush=True)
        dead = set(MOE_LEAVES) if moe and cfg.moe_dispatch == "rafi_ep" else set()
        check(all(s == dead for s in rec.none_grads),
              f"{label}: the gradients out of backward without a value: {sorted(set().union(*rec.none_grads))} "
              f"== {sorted(dead)} in every step")
    if moe:
        r.update(_moe_train_checks(rec, opt, label, cfg, cuda))
        route = fr.route
        W = route.items.h.shape[-1] * route.items.h.element_size() // 4 + 4
        shape = f"R={route.fcfg.num_ranks}, C={route.fcfg.capacity}, S={route.fcfg.peer_capacity}, W={W} words"
        r["route"] = shape
        check(_same_delivered(M.rafi_ep_dispatch(route), M.rafi_ep_dispatch(route.to("cpu"))),
              f"{label}: the train step's dispatch round ({shape}): the delivered queue == the CPU's, bit for bit")
        if cuda:
            r["kernels"] = _lm_kernel_rows(route, "train", timer, dtimer)
    return r


def _moe_train_checks(rec, opt, label, cfg, cuda):
    """(b): drops a step, no MoE call in the checkpoint's recompute,
    launches a step (two rounds, one ``enqueue`` each, a layer call), and
    the MoE leaves' update = weight decay alone, m and v zero."""
    import torch

    out = {}
    steps = range(len(rec.metrics))
    calls = cfg.microbatches * cfg.num_layers
    moe = [[int(d) for s, bw, d in rec.moe if s == i and not bw] for i in steps]
    rcp = [sum(1 for s, bw, _ in rec.moe if s == i and bw) for i in steps]
    out["drops_per_step"] = [sum(m) for m in moe]
    out["moe_drops"] = moe
    check(all(len(m) == calls for m in moe) and not any(rcp),
          f"{label}: {calls} MoE layer calls a step in forward ({[len(m) for m in moe]}), none in the checkpoint's "
          f"recompute ({rcp})")
    print(f"  {label}: MoE drops a step {out['drops_per_step']} (by layer call {moe})", flush=True)
    if cuda:
        per = rec.launches
        check(all(all(p[k] == 2 * calls for k in LM_KERNELS) for p in per),
              f"{label}: K6, K3, K1, K2 launched {2 * calls} times every step: {per}")
    ulps, exact = 0, 0
    for was, now, lr, wd in rec.updates:
        for k in was:
            b32 = was[k].to(torch.float32)
            want = (b32 - (b32 * wd) * lr).to(was[k].dtype)
            same = now[k].view(torch.int16) == want.view(torch.int16)
            exact += int(same.sum())
            ulps = max(ulps, int((now[k].view(torch.int16).to(torch.int32) - want.view(torch.int16).to(torch.int32))
                                 .abs().max()))
    n = sum(v.numel() for was, _, _, _ in rec.updates for v in was.values())
    out["decay_only"] = {"elements": n, "bit_equal": exact, "max_ulp": ulps}
    check(ulps == 0, f"{label}: {', '.join(k.rsplit('.', 1)[1] for k in MOE_LEAVES)} updated by weight decay alone: "
                     f"{exact} of {n} sampled elements bit-equal to bf16(p - lr·wd·p), max {ulps} ulp")
    m, v = _tree_paths(opt["m"]), _tree_paths(opt["v"])
    check(not any(bool(m[k].any()) or bool(v[k].any()) for k in MOE_LEAVES), f"{label}: m and v of the MoE leaves 0")
    return out


def _train_witness(dev, arch, steps=3, batch=8, seq=64, seed=24):
    """(c): the smoke config from one CPU draw, trained on the card and on
    the CPU in turn: (loss, gnorm) per step, and each run's launches."""
    import copy

    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_test_layout
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    lm_cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
    ds = SyntheticLM(cfg.vocab_size, seq, batch)
    out = {}
    for where, lm in (("card", copy.deepcopy(lm_cpu).to(dev)), ("cpu", lm_cpu)):
        step = build_train_step(model, make_test_layout(2, 4), AdamWConfig(warmup_steps=20))
        opt = adamw_init(lm, AdamWConfig(warmup_steps=20))
        KN.reset_launch_counts()
        mets = [step(lm, opt, ds.batch_at(i))[2] for i in range(steps)]
        out[where] = [(float(m["loss"]), float(m["gnorm"])) for m in mets]
        out[f"{where}_launches"] = {k: v for k, v in KN.launch_counts().items() if v}
    out["loss_max_abs_diff"] = max(abs(x[0] - y[0]) for x, y in zip(out["card"], out["cpu"]))
    out["gnorm_max_rel_diff"] = max(abs(x[1] - y[1]) / abs(y[1]) for x, y in zip(out["card"], out["cpu"]))
    return out


def _train_resume(dev, arch, steps=10, at=5, **kw):
    """(d): ``train`` uninterrupted to ``steps``, and to ``at`` then
    resumed from its checkpoint to ``steps``.  Returns both loss lists."""
    import tempfile

    from repro_torch.launch.train import train

    with tempfile.TemporaryDirectory() as d:
        _, _, full = train(arch=arch, steps=steps, ckpt_dir=f"{d}/full", ckpt_every=0, verbose=False, device=dev, **kw)
        train(arch=arch, steps=at, ckpt_dir=f"{d}/cut", ckpt_every=at, verbose=False, device=dev, **kw)
        _, _, resumed = train(arch=arch, steps=steps, ckpt_dir=f"{d}/cut", ckpt_every=at, verbose=False, device=dev,
                              **kw)
    return full, resumed


def phase_train(dev, RUNS=TRAIN_RUNS, BATCH=(8, 512), LAYOUT=(1, 8), SMOKE_BATCH=(4, 64), FALL_STEPS=70,
                widths=None, profile=True):
    """Phase train: the LM training path at full width (``widths``
    narrows it for a rehearsal on the CPU)."""
    import math
    import tempfile

    import numpy as np

    from repro_torch.launch.mesh import Layout
    from repro_torch.optim import AdamWConfig

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out, paths = {}, {}
    for arch, layers, steps in RUNS:
        moe = arch == LM_ARCH
        r = _train_full(dev, arch, layers, steps, batch=BATCH[0], seq=BATCH[1], layout=Layout(*LAYOUT) if moe else None,
                        widths=widths, profile=profile)
        out[arch] = r
        if moe:
            paths["lm_train"] = r["launches"]

    for arch in ("qwen2-7b", LM_ARCH):  # (c)
        w = _train_witness(dev, arch)
        out[f"witness_{arch}"] = w
        ran = all(w["card_launches"].get(k, 0) > 0 for k in LM_KERNELS) and not w["cpu_launches"]
        check(w["loss_max_abs_diff"] <= TRAIN_TOL_WITNESS and w["gnorm_max_rel_diff"] <= TRAIN_TOL_WITNESS
              and (arch != LM_ARCH or not cuda or ran),
              f"(c) {arch} smoke, 3 steps from one CPU draw: (loss, gnorm) card {w['card']} against CPU {w['cpu']}: "
              f"loss max |d| {w['loss_max_abs_diff']:.3g}, gnorm max |d|/gnorm {w['gnorm_max_rel_diff']:.3g}, both "
              f"<= {TRAIN_TOL_WITNESS}; launches card {w['card_launches']}, CPU {w['cpu_launches']}")

    for arch in ("qwen2-7b", LM_ARCH):  # (d)
        full, resumed = _train_resume(dev, arch, batch=SMOKE_BATCH[0], seq=SMOKE_BATCH[1])
        tail = dict(full)
        diff = max(abs(tail[s] - l) for s, l in resumed)
        exact = all(tail[s] == l for s, l in resumed)
        out[f"resume_{arch}"] = {"full": full, "resumed": resumed, "max_abs_diff": diff, "bit_equal": exact}
        check([s for s, _ in resumed] == list(range(5, 10)) and diff <= TRAIN_TOL_RESUME,
              f"(d) {arch} smoke resumed at step 5 to 10: losses {[round(l, 6) for _, l in resumed]}, max |d| "
              f"{diff:.3g} <= {TRAIN_TOL_RESUME} against the uninterrupted run (bit-equal: {exact})")

    from repro_torch.launch.train import train  # (e)
    _, _, losses = train(arch="qwen2-7b", steps=FALL_STEPS, batch=8, seq=64, ckpt_every=0, verbose=False, device=dev,
                         opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=10, weight_decay=0.0))
    first, last = np.mean([l for _, l in losses[:5]]), np.mean([l for _, l in losses[-5:]])
    out["loss_falls"] = {"first5": float(first), "last5": float(last), "losses": [l for _, l in losses]}
    check(all(math.isfinite(l) for _, l in losses) and last < 0.9 * first,
          f"(e) qwen2-7b smoke, {FALL_STEPS} steps at lr 1e-2: mean of the last 5 losses {last:.4f} < 0.9 x the "
          f"first 5's {first:.4f}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase train: {out['phase_s']:.1f} s", flush=True)
    return out, paths


# ---------------------------------------------------------- 17. families
FAMILY_ARCHS = ("rwkv6-3b", "recurrentgemma-2b", "seamless-m4t-medium")
# stated tolerances of phase families (PERF.md §6):
# (c) float32, one layer at full width, the two forms of one computation:
# max |d| <= FAM_TOL_F32 x the reference form's largest |value| (the layers'
# outputs reach ~1e2-1e4, where an absolute bound means nothing)
FAM_TOL_F32 = 1e-4
# (a, b, d) float32 logits, full depth (prefill against decode) or one
# period (card against CPU): max |d| <= 1 / FAM_F32_GAIN x how far the
# model's bfloat16 logits lie from its float32 ones on the same inputs
# (float32 carries 16 more bits).  The attention of these random models is
# saturated (scores ~1e3), so float32 rounding alone moves their logits by
# up to ~6e-3 of the largest on the H100, and a fixed bound of 1e-3 of it
# fails (PERF.md §6)
FAM_F32_GAIN = 16.0
# (d) bfloat16 logits, card against the CPU's float32 logits: no farther
# than FAM_BF16_NOISE x the CPU's own bfloat16 logits are.  The reference's
# init draws a stacked leaf at 1/sqrt(its layer count), so one layer's
# attention scores reach ~1e3 and its softmax picks near-ties by bfloat16
# rounding: a fixed bound on bfloat16 logits fails (PERF.md §6)
FAM_BF16_NOISE = 2.0
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
# (e): the recurrent archs' train steps cut in depth (rwkv6-3b 4 of 32
# layers, recurrentgemma-2b one period of 3 of 26): the RG-LRU's backward
# issues tens of thousands of launches a step, and a step under the
# profiler took 75 s at full depth; serving stays at full depth
FAMILY_TRAIN_LAYERS = {"rwkv6-3b": 4, "recurrentgemma-2b": 3}


def _ranged_kernels(raw, prefix):
    """``[(part or None, device event)]`` of a profile's raw events
    (``kineto_results.events()``): each device event (kernel, copy,
    memset) with the innermost ``record_function`` range named
    ``prefix + part`` open on its thread when the host op it was launched
    from began (a sweep over each thread's ranges and launches in time
    order).  A device event names its host op by ``linked_correlation_id``,
    the op's ``correlation_id``, as ``torch.profiler`` links them.  The raw
    events are read as they are, without building ``torch.profiler``'s
    event tree, whose cost grows with a train step's tens of thousands of
    launches."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host, ranges, device = {}, {}, []
    for e in raw:
        if e.device_type() == cpu and e.linked_correlation_id() == 0 and not e.is_async():
            if e.name().startswith(prefix):
                ranges.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns(), e.name()[len(prefix):]))
            host[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif e.device_type() == cuda and not e.name().startswith(prefix):
            device.append(e)
    launches = {}
    out = []
    for i, e in enumerate(device):
        thread, t = host.get(e.linked_correlation_id(), (None, None))
        if t is None:
            out.append((None, e))
        else:
            launches.setdefault(thread, []).append((t, 1, i))
            out.append(None)
    for thread, points in launches.items():
        sweep = sorted([(s, 0, (s, end, name)) for s, end, name in ranges.get(thread, [])] + points,
                       key=lambda p: (p[0], p[1]))
        stack = []
        for t, kind, item in sweep:
            while stack and stack[-1][1] < t:
                stack.pop()
            if kind == 0:
                stack.append(item)
            else:
                out[item] = (stack[-1][2] if stack else None, device[item])
    return out


def _family_split(fn, calls=1, comm=None, warmup=True, more=()):
    """Device time of ``fn()`` by part, ms a call, from ``torch.profiler``:
    each kernel goes to the innermost ``record_function`` range around it
    (``_ranged_kernels``): ``scan`` (the recurrences, ``rwkv6.
    _chunk_scan`` and ``_state_step``, ``griffin._lru_scan`` and
    ``_lru_step``; the checkpoint's recompute included, their backward
    not), ``attention`` (``attention.self_attention`` and
    ``self_attention_placed``), ``adamw`` (inside ``adamw_update``), with
    ``comm`` ``collectives`` (its ``psum``, ``all_gather`` and
    ``reduce_scatter`` calls); elsewhere ``gemm`` (cuBLAS and CUTLASS
    kernels: the projections and the MLP) and ``rest``; and the device
    launches a call (kernels, copies, memsets), in all and by part.
    ``warmup``: one call before the profile; ``more``: ``((part, [(module,
    name), …]), …)`` further functions whose kernels go to a part."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import steps as ST
    from repro_torch.models import attention as A
    from repro_torch.models import griffin as G
    from repro_torch.models import rwkv6 as W

    targets = {"scan": [(W, "_chunk_scan"), (W, "_state_step"), (G, "_lru_scan"), (G, "_lru_step")],
               "attention": [(A, "self_attention"), (A, "self_attention_placed")], "adamw": [(ST, "adamw_update")]}
    if comm is not None:
        targets["collectives"] = [(comm, "psum"), (comm, "all_gather"), (comm, "reduce_scatter")]
    for part, items in more:
        targets[part] = targets.get(part, []) + list(items)
    orig = [(m, n, getattr(m, n)) for items in targets.values() for m, n in items]

    def ranged(part, f):
        def w(*a, **kw):
            with record_function(f"fam.{part}"):
                return f(*a, **kw)
        return w

    for part, items in targets.items():
        for m, n in items:
            setattr(m, n, ranged(part, getattr(m, n)))
    t0 = time.perf_counter()
    try:
        if warmup:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    finally:
        for m, n, f in orig:
            if m is comm:
                delattr(m, n)
            else:
                setattr(m, n, f)
    us = {k: 0.0 for k in list(targets) + ["gemm", "rest"]}
    n = {k: 0 for k in us}
    for part, e in _ranged_kernels(prof.profiler.kineto_results.events(), "fam."):
        p = part or ("gemm" if any(t in e.name().lower() for t in GEMM_NAMES) else "rest")
        us[p] += e.duration_ns() / 1e3
        n[p] += 1
    return {"device_ms": sum(us.values()) / calls / 1e3, "parts_ms": {k: v / calls / 1e3 for k, v in us.items()},
            "launches": sum(n.values()) / calls, "launches_by_part": {k: v / calls for k, v in n.items()},
            "profile_s": time.perf_counter() - t0}


def _as_float32(model, params):
    """The model and a float32 copy of its parameters (same draw)."""
    import dataclasses as dc

    import torch

    from repro_torch.models.api import build_model

    model32 = build_model(dc.replace(model.cfg, dtype="float32"))
    p32 = type(params)(model32.cfg, device=next(params.parameters()).device)
    with torch.no_grad():
        for a, b in zip(p32.parameters(), params.parameters()):
            a.copy_(b)
    return model32, p32


def _prefill_against_decode(model, params, batch, max_len, dev, memory=None):
    """``prefill_fn`` of ``batch`` against the last of its tokens' decode
    steps from fresh caches (teacher forcing): (max |d|, ||d|| / ||logits||,
    max |logit|), and the last step's logits and caches."""
    import torch

    pre = model.prefill_fn()(params, batch).float()
    toks = batch["tokens"]
    step = model.decode_fn()
    caches = model.init_caches(toks.shape[0], max_len, device=dev)
    for t in range(toks.shape[1]):
        args = (params, toks[:, t:t + 1], caches) + ((memory,) if memory is not None else ())
        last, caches = step(*args)
    d = pre - last.float()
    return (float(d.abs().max()), float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(pre)),
            float(pre.abs().max())), pre, last, caches


def _prefill_checks(dev, model, params, batch, max_len, label, memory=None):
    """Prefill against decode at full depth: in float32 (a copy of the
    weights), held within 1/``FAM_F32_GAIN`` of the bfloat16 prefill's
    distance from the float32 one; in the model's bfloat16, measured.  Returns the record and the bfloat16 run's last
    logits and caches."""
    import gc

    import torch

    from repro_torch.models import encdec as ED

    model32, p32 = _as_float32(model, params)
    mem32 = None
    if memory is not None:
        with torch.no_grad():
            mem32 = ED.encode(p32, batch["frames"], model32.cfg)
    (d32, rel32, top32), pre32, _, _ = _prefill_against_decode(model32, p32, batch, max_len, dev, mem32)
    del p32, mem32
    gc.collect()
    (d16, rel16, top16), pre16, last, caches = _prefill_against_decode(model, params, batch, max_len, dev, memory)
    gap = float((pre16 - pre32).abs().max())
    r = {"shape": tuple(batch["tokens"].shape), "float32": {"max_abs_diff": d32, "rel_l2": rel32, "max_abs_logit": top32},
         "bfloat16": {"max_abs_diff": d16, "rel_l2": rel16, "max_abs_logit": top16, "to_float32": gap}}
    check(d32 <= gap / FAM_F32_GAIN,
          f"{label}: prefill_fn of {r['shape']} tokens == the last of its {r['shape'][1]} decode steps at full depth in "
          f"float32: max |dlogit| {d32:.4g} <= 1/{FAM_F32_GAIN:g} x {gap:.4g}, the bfloat16 prefill's distance from "
          f"the float32 one (||d|| / ||logits|| {rel32:.3g}, max |logit| {top32:.4g}); in bfloat16, measured: max "
          f"|dlogit| {d16:.4g}, ||d|| / ||logits|| {rel16:.3g}")
    return r, last, caches


def _family_serve(dev, model, params, label, out, *, slots, n_req, prompt, new, max_len, long, prefill, profile):
    """(a): ``BatchedEngine`` over ``n_req`` requests, the decode step's
    split, a ``long``-token prefill, and prefill against decode."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import BatchedEngine

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = model.cfg
    requests = _lm_requests(cfg.vocab_size, n_req, prompt, new, seed=25)
    engine = BatchedEngine(model, params, slots=slots, max_len=max_len, device=dev)
    rec = _StepRecorder(engine)
    engine._step(params, torch.zeros((slots, 1), dtype=torch.int32, device=dev),
                 model.init_caches(slots, max_len, device=dev))  # warm-up: first-use costs
    sync()
    t0 = time.perf_counter()
    served = engine.run(requests)
    sync()
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in served.values())
    step_ms = [a.elapsed_time(b) for a, b in rec.events] if cuda else []
    r = {"requests": n_req, "slots": slots, "steps": engine.steps, "tokens": n_tok, "wall_s": wall,
         "tokens_per_s": n_tok / wall, "step_ms_median": statistics.median(step_ms) if step_ms else None,
         "step_ms_min": min(step_ms) if step_ms else None}
    check(all(len(served[q.rid]) == q.max_new_tokens for q in requests),
          f"(a) {label}: {n_req} requests through {slots} slots answered with their max_new_tokens ({n_tok} tokens in "
          f"{engine.steps} steps, {wall:.3f} s, {n_tok / wall:.1f} tokens/s; decode step event median "
          f"{r['step_ms_median']} ms)")
    if profile and cuda:
        caches = model.init_caches(slots, max_len, device=dev)
        r["decode_split"] = _family_split(lambda: engine._step(params, rec.tokens[-1], caches))
    rng = np.random.default_rng(26)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, long)).astype(np.int32)).to(dev)
    sync()
    t0 = time.perf_counter()
    logits = model.prefill_fn()(params, {"tokens": toks})
    sync()
    r["prefill_long"] = {"S": long, "s": time.perf_counter() - t0}
    check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"(a) {label}: a {long}-token prefill gives finite logits (1, {cfg.vocab_size}) in {r['prefill_long']['s']:.3f} s")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, prefill).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    r["prefill_vs_decode"], _, _ = _prefill_checks(dev, model, params, {"tokens": toks}, max_len, f"(a) {label}")
    r["prefill_vs_decode"]["s"] = time.perf_counter() - t0
    out["serve"] = r


def _family_seamless(dev, model, params, label, out, *, frames, new, max_len, profile):
    """(b): ``prefill_fn`` of ``frames`` (B, T, D) and tokens, prefill
    against its decode steps, then ``new`` greedy steps against the memory."""
    import numpy as np
    import torch

    from repro_torch.models import encdec as ED

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = model.cfg
    b, t, s = frames
    gen = torch.Generator(device=dev).manual_seed(27)
    batch = {"frames": torch.randn((b, t, cfg.d_model), generator=gen, device=dev),
             "tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev, dtype=torch.int32)}
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        memory = ED.encode(params, batch["frames"], cfg)
    sync()
    r = {"frames": (b, t, cfg.d_model), "tokens": (b, s), "encode_s": time.perf_counter() - t0}
    r["prefill_vs_decode"], logits, caches = _prefill_checks(
        dev, model, params, batch, max_len, f"(b) {label}, frames {r['frames']}, decode_fn against the memory", memory)
    step = model.decode_fn()
    greedy, events = [], []
    for _ in range(new):
        tok = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        greedy.append(tok)
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        logits, caches = step(params, tok, caches, memory)
        if cuda:
            ev[1].record()
            events.append(ev)
    sync()
    ms = [a.elapsed_time(b_) for a, b_ in events]
    r["greedy"] = {"steps": new, "step_ms_median": statistics.median(ms) if ms else None,
                   "pos": int(caches["pos"][0, 0])}
    check(bool(torch.isfinite(logits).all()) and r["greedy"]["pos"] == s + new,
          f"(b) {label}: {new} greedy decode_fn steps against the memory: finite logits, position {r['greedy']['pos']} "
          f"== {s} + {new}; decode step event median {r['greedy']['step_ms_median']} ms")
    if profile and cuda:
        fixed = model.init_caches(b, max_len, device=dev)
        r["decode_split"] = _family_split(lambda: step(params, tok, fixed, memory))
    out["serve"] = r


def _family_train(dev, model, params, label, out, *, batch, steps, profile):
    """(e): ``build_train_step`` at (B, S) (the encoder-decoder: frames and
    tokens of S // 8, as the reference's ``input_specs``), ``steps`` steps
    under AdamW; the step's event median, split and peak memory."""
    import math

    import numpy as np
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = dev.type == "cuda"
    cfg = model.cfg
    b, s = batch
    if cfg.kind == "encdec":
        rng = np.random.default_rng(28)
        batches = [{"frames": rng.standard_normal((b, s // 8, cfg.d_model)).astype(np.float32),
                    "tokens": rng.integers(0, cfg.vocab_size, (b, s // 8)).astype(np.int32)} for _ in range(steps + 1)]
    else:
        ds = SyntheticLM(cfg.vocab_size, s, b)
        batches = [ds.batch_at(i) for i in range(steps + 1)]
    opt_cfg = AdamWConfig(warmup_steps=20)
    opt = adamw_init(params, opt_cfg)
    step = build_train_step(model, None, opt_cfg)
    mets, ms = [], []
    for i in range(steps):
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        _, opt, met = step(params, opt, batches[i])
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        mets.append((float(met["loss"]), float(met["gnorm"])))
    depth = f"{cfg.num_layers}" + (f" + {cfg.encoder_layers}" if cfg.kind == "encdec" else "")
    r = {"batch": (b, s), "steps": steps, "depth": depth, "losses": [l for l, _ in mets],
         "gnorms": [g for _, g in mets], "step_ms": ms, "step_ms_median": statistics.median(ms[1:]) if ms else None,
         "tokens_per_s": b * (s // 8 if cfg.kind == "encdec" else s) / (statistics.median(ms[1:]) / 1e3) if ms else None}
    if profile and cuda:
        r["split"] = _family_split(lambda: step(params, opt, batches[steps]))
    if cuda:
        r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(math.isfinite(l) and math.isfinite(g) for l, g in mets),
          f"(e) {label} at depth {depth}, batch {r['batch']}"
          f"{' (frames and tokens of S // 8)' if cfg.kind == 'encdec' else ''}: {steps} AdamW steps, losses "
          f"{[round(l, 4) for l in r['losses']]}, gnorm {[round(g, 3) for g in r['gnorms']]} finite; step event median "
          f"{r['step_ms_median']} ms, {r['tokens_per_s']} tokens/s, peak {r.get('peak_gib')} GiB")
    del opt
    out["train"] = r


def _family_layer_checks(dev, seed=29, S=256, DEC=64):
    """(c): each family's layer at full width in float32 on ``dev``: the
    chunk scan against ``naive_scan_oracle`` (the decays as drawn, and all
    at ``W_MIN``); ``rwkv_block`` and ``griffin_block`` decoded token by
    token against their parallel forms; one encoder and one decoder layer
    of the encoder-decoder, decoded step by step against the parallel
    decode."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ED
    from repro_torch.models import griffin as G
    from repro_torch.models import rwkv6 as W
    from repro_torch.models.api import build_model
    from repro_torch.models.common import ParamTree, init_params

    out = {}
    gen = torch.Generator(device=dev).manual_seed(seed)

    def scaled(name, got, want):
        want = want.float()
        diff, top = float((got.float() - want).abs().max()), float(want.abs().max())
        out[name] = {"max_abs_diff": diff, "max_abs": top, "rel": diff / top}
        check(diff <= FAM_TOL_F32 * top and bool(torch.isfinite(got).all()),
              f"(c) {name}: max |d| {diff:.4g} <= {FAM_TOL_F32} x {top:.4g}")

    def layer(defs):
        return init_params(ParamTree(defs, dtype=torch.float32, device=dev), gen).tree()

    rw = dc.replace(get_config("rwkv6-3b"), dtype="float32")
    p = layer(W.rwkv_defs(rw))
    x = torch.randn((2, S, rw.d_model), generator=gen, device=dev)
    r, k, v, logw, _, _, _ = W._project(p, x, rw)
    scaled(f"rwkv6-3b chunk scan (2, {S}) against naive_scan_oracle", W._chunk_scan(r, k, v, logw, p["u"]),
           W.naive_scan_oracle(r, k, v, logw, p["u"]))
    floor = torch.full_like(logw, W.W_MIN)
    scaled(f"rwkv6-3b chunk scan (2, {S}) at W_MIN against naive_scan_oracle", W._chunk_scan(r, k, v, floor, p["u"]),
           W.naive_scan_oracle(r, k, v, floor, p["u"]))
    for name, cfg, block, state, defs in (
            ("rwkv6-3b rwkv_block", rw, W.rwkv_block, W.rwkv_state, None),
            ("recurrentgemma-2b griffin_block", dc.replace(get_config("recurrentgemma-2b"), dtype="float32"),
             G.griffin_block, G.griffin_state, G.griffin_defs)):
        lp = p if defs is None else layer(defs(cfg))
        xs = torch.randn((2, DEC, cfg.d_model), generator=gen, device=dev)
        par, _ = block(lp, xs, cfg)
        st, steps = state(cfg, 2, device=dev), []
        for t in range(DEC):
            y, st = block(lp, xs[:, t:t + 1], cfg, state=st)
            steps.append(y)
        scaled(f"{name} decoded token by token ({DEC} steps) against the parallel form", torch.cat(steps, 1), par)
    ed = dc.replace(get_config("seamless-m4t-medium"), dtype="float32", encoder_layers=1, num_layers=1)
    model = build_model(ed)
    m = model.init(gen, device=dev)
    frames = torch.randn((2, DEC, ed.d_model), generator=gen, device=dev)
    toks = torch.randint(0, ed.vocab_size, (2, 16), generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad():
        mem = ED.encode(m, frames, ed)
        par, _ = ED.decode(m, toks, mem, ed)
    step, caches, rows = model.decode_fn(), model.init_caches(2, 32, device=dev), []
    for t in range(toks.shape[1]):
        y, caches = step(m, toks[:, t:t + 1], caches, mem)
        rows.append(y[:, None])
    scaled("seamless-m4t-medium (1 + 1 layers) decode_fn step by step against the parallel decode", torch.cat(rows, 1),
           par)
    return out


def _family_card_cpu(dev, arch, seed=30, B=2, S=32):
    """(d): the port at full width, one pattern period deep, on the card and
    on the CPU from the same draw and inputs, in bfloat16 and in float32
    (a copy of the weights): every logit."""
    import copy
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as TF
    from repro_torch.models.api import build_model

    cfg = get_config(arch)
    cfg = dc.replace(cfg, num_layers=len(cfg.pattern), **({"encoder_layers": 1} if cfg.kind == "encdec" else {}))
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(cfg)
    card = model.init(gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev, dtype=torch.int32)
    frames = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    t0 = time.perf_counter()
    logits = {}

    def run(m, q):
        d = next(q.parameters()).device
        with torch.no_grad():
            if cfg.kind == "encdec":
                y, _ = ED.decode(q, toks[:, :S // 2].to(d), ED.encode(q, frames.to(d), m.cfg), m.cfg)
            else:
                y, _, _ = TF.forward(q, toks.to(d), m.cfg)
        return y.float().cpu().reshape(-1, cfg.vocab_size)

    for prec in ("bfloat16", "float32"):
        m, p = (model, card) if prec == "bfloat16" else _as_float32(model, card)
        logits[prec, "card"], logits[prec, "cpu"] = run(m, p), run(m, copy.deepcopy(p).to("cpu"))
    top = float(logits["float32", "cpu"].abs().max())
    dev_of = lambda a, b: float((logits[a] - logits[b]).abs().max())
    r = {"layers": cfg.num_layers, "rows": logits["float32", "cpu"].shape[0], "max_abs_logit": top,
         "f32_card_cpu": dev_of(("float32", "card"), ("float32", "cpu")),
         "bf16_card_cpu": dev_of(("bfloat16", "card"), ("bfloat16", "cpu")),
         "bf16_card_to_f32_cpu": dev_of(("bfloat16", "card"), ("float32", "cpu")),
         "bf16_cpu_to_f32_cpu": dev_of(("bfloat16", "cpu"), ("float32", "cpu")), "s": time.perf_counter() - t0}
    label = (f"(d) {arch} at full width, {cfg.num_layers} layer(s){' + 1 encoder layer' if cfg.kind == 'encdec' else ''}"
             f", {r['rows']} logit rows")
    check(r["f32_card_cpu"] <= r["bf16_cpu_to_f32_cpu"] / FAM_F32_GAIN,
          f"{label}: float32, the card's == the CPU's within max |d| {r['f32_card_cpu']:.4g} <= 1/{FAM_F32_GAIN:g} x "
          f"{r['bf16_cpu_to_f32_cpu']:.4g}, the CPU's bfloat16 logits' distance from its float32 ones (max |logit| "
          f"{top:.4g})")
    check(r["bf16_card_to_f32_cpu"] <= FAM_BF16_NOISE * r["bf16_cpu_to_f32_cpu"],
          f"{label}: bfloat16, the card's logits are within max |d| {r['bf16_card_to_f32_cpu']:.4g} of the CPU's "
          f"float32 ones, <= {FAM_BF16_NOISE} x the CPU's bfloat16 logits' {r['bf16_cpu_to_f32_cpu']:.4g} (card "
          f"against CPU in bfloat16: {r['bf16_card_cpu']:.4g})")
    return r


def phase_families(dev, ARCHS=FAMILY_ARCHS, SLOTS=16, N_REQ=16, PROMPT=(8, 48), NEW=(8, 24), MAX_LEN=128, LONG=2048,
                   PREFILL=(2, 64), FRAMES=(4, 512, 64), GREEDY=32, TRAIN=(8, 512), TRAIN_STEPS=3,
                   TRAIN_LAYERS=FAMILY_TRAIN_LAYERS, configs=None, layer_checks=None, card_cpu=None, profile=True):
    """Phase families: rwkv6-3b, recurrentgemma-2b and seamless-m4t-medium
    at full width and full depth (``configs`` replaces them, and
    ``layer_checks`` / ``card_cpu`` the (c) / (d) functions, for a
    rehearsal on the CPU); the train steps of an arch in ``TRAIN_LAYERS``
    run at that depth, on a model of its own drawn from the same seed."""
    import dataclasses
    import gc

    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out, paths = {"tf32": torch.backends.cuda.matmul.allow_tf32}, {}
    check(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
          f"float32 products without TF32 (allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, matmul precision "
          f"{torch.get_float32_matmul_precision()!r}): the chunk scan's factors reach e^40")
    for arch in ARCHS:
        cfg = (configs or {}).get(arch) or get_config(arch)
        label = f"{cfg.name} ({cfg.kind})"
        r = out[arch] = {}
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(2525), device=dev)
        n = model.param_count()
        r["model"] = {"params": n, "bytes": sum(p.numel() * p.element_size() for p in params.parameters()),
                      "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers, "init_s": time.perf_counter() - t0}
        check(n == sum(p.numel() for p in params.parameters()),
              f"{label} at full depth: param_count() {n} == the allocated parameters ({r['model']['bytes']} B)")
        KN.reset_launch_counts()
        if cfg.kind == "encdec":
            _family_seamless(dev, model, params, label, r, frames=FRAMES, new=GREEDY, max_len=MAX_LEN,
                             profile=profile)
        else:
            _family_serve(dev, model, params, label, r, slots=SLOTS, n_req=N_REQ, prompt=PROMPT, new=NEW,
                          max_len=MAX_LEN, long=LONG, prefill=PREFILL, profile=profile)
        if cuda:
            r["serve"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        r["serve"]["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        layers = min(TRAIN_LAYERS.get(arch, cfg.num_layers), cfg.num_layers)
        if layers < cfg.num_layers:  # the train steps on a model cut in depth, drawn from the same seed
            del params
            if cuda:
                gc.collect()
                torch.cuda.empty_cache()
            model = build_model(dataclasses.replace(cfg, num_layers=layers))
            params = model.init(torch.Generator(device=dev).manual_seed(2525), device=dev)
        _family_train(dev, model, params, f"{cfg.name} ({cfg.kind}, {cfg.num_layers} layers)", r, batch=TRAIN,
                      steps=TRAIN_STEPS, profile=profile)
        r["train"]["s"] = time.perf_counter() - t0
        paths[f"families_{arch}"] = KN.launch_counts()
        check(not any(paths[f"families_{arch}"].values()),
              f"{label}: none of the ten kernels on this path ({paths[f'families_{arch}']})")
        for part in ("serve", "train"):
            sp = r[part].get("decode_split" if part == "serve" else "split")
            if sp:
                what = "decode" if part == "serve" else f"train (depth {r['train']['depth']})"
                print(f"  (f) {label} {what} step: device {sp['device_ms']:.3f} ms "
                      f"(" + ", ".join(f"{k} {v:.3f}" for k, v in sp["parts_ms"].items()) + f"), {sp['launches']:.0f} "
                      f"launches a step (scan {sp['launches_by_part']['scan']:.0f}); event median "
                      f"{r[part].get('step_ms_median') or r[part].get('greedy', {}).get('step_ms_median')} ms; peak "
                      f"{r[part].get('peak_gib')} GiB", flush=True)
        del params
    t0 = time.perf_counter()
    out["layer_checks"] = (layer_checks or _family_layer_checks)(dev)
    out["layer_checks_s"] = time.perf_counter() - t0
    out["card_cpu"] = {arch: (card_cpu or _family_card_cpu)(dev, arch) for arch in ARCHS}
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase families: {out['phase_s']:.1f} s", flush=True)
    return out, paths


# ------------------------------------------------------------ 18. dryrun
# (a) sweeps one arch's cells: the 40 cells' meta sweep (host work of about
# two minutes, its records independent of the card) is
# tests/test_torch_dryrun.py's on the CPU
DRYRUN_ARCHS = ("qwen2-7b",)
DRYRUN_CELLS = (3, 1, 0)  # ok, skip, error


def _dryrun_sweep(out_dir, res):
    """(a), run on a thread while (b) holds the card: ``launch.dryrun``'s
    sweep of ``DRYRUN_ARCHS``' cells on meta, its probes counted in its
    worker processes; records, lines and seconds into ``res``."""
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    res["lines"] = []
    try:
        res["records"] = DR.sweep(force=True, out_dir=out_dir, log=res["lines"].append, archs=DRYRUN_ARCHS)
    except Exception:  # reported by the phase
        res["error"] = traceback.format_exc()
    res["seconds"] = time.perf_counter() - t0


# the band meta's peak of a step's own bytes (its peak above the inputs it
# holds) must fall in, as a share of the card's (max_memory_allocated above
# what was allocated before the step), as PERF.md states it: the caching
# allocator rounds each block up (512 B, and a large block's unsplit tail of
# up to 1 MB) and a kernel may take a temporary meta never sees, so the card
# may hold more; never much less
DRYRUN_PEAK_BANDS = {"train": (0.90, 1.02), "decode": (0.80, 1.02)}


def phase_dryrun(dev, ARCH="qwen2-7b", LAYERS=4, BATCH=(8, 512), sweep=True, widths=None):
    """Phase dryrun: (a) the meta sweep, its records' roofline terms and
    memory, and the report table; (b) phase train's qwen2-7b (4 of 28
    layers, batch 8 × 512) on the card against its dry run: the bytes of
    its parameters, AdamW state and caches, and the FLOPs of a train step
    that ``FlopCounterMode`` counts on the card, each equal to the meta
    count; the count over the step's device time as a share of the bf16
    peak beside ``model_flops``' share; a train and a decode step's peak
    bytes on meta against ``max_memory_allocated`` (within
    ``DRYRUN_PEAK_BANDS``), and each step's device time no shorter than
    its roofline bound on one card, ``max(t_compute, t_memory)``; no
    kernel launched."""
    import dataclasses as dc
    import threading

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels as KN
    from repro_torch.configs import Cell, ShapeSpec, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.roofline import report as RP
    from repro_torch.roofline.analysis import RooflineTerms, model_flops

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out, res = {}, {}
    KN.reset_launch_counts()
    worker = None
    sweep_dir = ROOT / "chiprun_out" / "dryrun_torch"
    if sweep:
        worker = threading.Thread(target=_dryrun_sweep, args=(sweep_dir, res))
        worker.start()

    # (b): the dry run of the config, then the same config on the device
    cfg = dc.replace(get_config(ARCH), num_layers=LAYERS, **(widths or {}))
    label = f"(b) {ARCH} at {LAYERS} of {get_config(ARCH).num_layers} layers, batch {BATCH[0]} x {BATCH[1]}"
    model = build_model(cfg)
    b, s = BATCH
    spec = {k: ShapeSpec(f"{k}_{s}", s, b, k) for k in ("train", "decode")}
    cells = {"train": Cell(ARCH, spec["train"], "train", {"tokens": torch.empty((b, s), dtype=torch.int32,
                                                                                   device="meta")}),
             "decode": Cell(ARCH, spec["decode"], "decode", {"token": torch.empty((b, 1), dtype=torch.int32,
                                                                                     device="meta")})}
    t0 = time.perf_counter()
    meta = {"train": DR.footprint(model, cells["train"]), "decode": DR.footprint(model, cells["decode"]),
            "flops": DR.cell_flops(cfg, cells["train"]), "flops_full_depth": DR.count_flops(model, cells["train"])}
    # the steps the card runs below (no layout: one card), counted in one pass each
    counts = {k: DR.count_cell(model, cells[k]) for k in ("train", "decode")}
    meta["seconds"] = time.perf_counter() - t0
    terms = {k: RooflineTerms(c["flops"], c["bytes_accessed"], 0.0, 1, {}) for k, c in counts.items()}
    opt_cfg = AdamWConfig(warmup_steps=20)
    lm = model.init(torch.Generator(device=dev).manual_seed(31), device=dev)
    opt = adamw_init(lm, opt_cfg)
    caches = model.init_caches(b, s, device=dev)
    card = {"params": DR.nbytes(lm), "opt_state": DR.nbytes(opt), "caches": DR.nbytes(caches)}
    check(card["params"] == meta["train"]["params"] and card["opt_state"] == meta["train"]["opt_state"],
          f"{label}: bytes of the parameters {card['params']} and the AdamW state {card['opt_state']} that "
          f"Model.init and adamw_init make on {dev.type} == the dry run's {meta['train']['params']} and "
          f"{meta['train']['opt_state']}")
    check(card["caches"] == meta["decode"]["caches"],
          f"{label}: bytes of init_caches({b}, {s}) on {dev.type} {card['caches']} == the dry run's "
          f"{meta['decode']['caches']}")
    data = SyntheticLM(cfg.vocab_size, s, b)
    step = build_train_step(model, None, opt_cfg)
    step(lm, opt, data.batch_at(0))  # warm-up
    with FlopCounterMode(display=False) as fc:
        step(lm, opt, data.batch_at(1))
    counted = int(fc.get_total_flops())
    check(counted == meta["flops"] == meta["flops_full_depth"] == counts["train"]["flops"],
          f"{label}: FLOPs of one train step counted on {dev.type} {counted} == the dry run's differenced count "
          f"{meta['flops']} == its full-depth count {meta['flops_full_depth']} == its one-pass count "
          f"{counts['train']['flops']}")
    mf = model_flops(cfg, spec["train"])
    r = {"arch": ARCH, "layers": LAYERS, "batch": list(BATCH), "card_bytes": card, "meta": meta, "counted_flops": counted,
         "model_flops": mf, "useful_flops_ratio": mf / counted,
         "roofline_one_card": {k: {"t_compute_ms": t.t_compute * 1e3, "t_memory_ms": t.t_memory * 1e3,
                                   "bound_ms": max(t.t_compute, t.t_memory) * 1e3,
                                   "bytes_accessed": counts[k]["bytes_accessed"],
                                   "meta_peak_bytes": counts[k]["peak_bytes_one_device"],
                                   "meta_step_bytes": counts[k]["peak_bytes_one_device"] - counts[k]["held_bytes"]}
                               for k, t in terms.items()}}
    if cuda:
        split = _step_device_ms(step, lm, opt, data.batch_at(2))
        r["device_split_ms"] = split
        r["step_ms_median"] = cuda_ms(lambda: step(lm, opt, data.batch_at(3)), reps=3, warmup=1)
        sec = split["total"] / 1e3
        r["counted_share_bf16_peak"] = counted / sec / BF16_PEAK
        r["model_share_bf16_peak"] = mf / sec / BF16_PEAK
        r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        decode = model.decode_fn(None)
        token = torch.from_numpy(np.random.default_rng(32).integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)).to(dev)

        def decode_step():
            with torch.no_grad():  # as the dry run's parameters, which ask for no gradient
                return decode(lm, token, caches)

        decode_step()  # warm-up
        device_ms = {"train": split["total"], "decode": sum(_device_split(decode_step, calls=5, warmup=2).values())}
        for k, run in (("train", lambda: step(lm, opt, data.batch_at(4))), ("decode", decode_step)):
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            run()
            torch.cuda.synchronize(dev)
            got = r["roofline_one_card"][k]
            got.update(card_step_bytes=torch.cuda.max_memory_allocated(dev) - before, held_before_bytes=before,
                       device_ms=device_ms[k])
            got["meta_over_card"] = got["meta_step_bytes"] / got["card_step_bytes"]
            lo, hi = DRYRUN_PEAK_BANDS[k]
            check(lo <= got["meta_over_card"] <= hi,
                  f"{label}: a {k} step's own peak bytes on meta {got['meta_step_bytes']} against the card's "
                  f"max_memory_allocated above the {before} bytes held before it, {got['card_step_bytes']}: "
                  f"{got['meta_over_card']:.4f} in [{lo}, {hi}] (PERF.md); whole step on meta "
                  f"{got['meta_peak_bytes'] / 2**30:.3f} GiB")
            check(got["device_ms"] >= got["bound_ms"],
                  f"{label}: a {k} step's device time {got['device_ms']:.3f} ms >= its roofline bound on one H100, "
                  f"max(t_compute {got['t_compute_ms']:.3f}, t_memory {got['t_memory_ms']:.3f}) ms "
                  f"({got['bytes_accessed']:.4e} bytes accessed)")
    del caches
    print(f"  {label}: bytes {card}; FLOPs a step counted {counted:.6e} (meta, {meta['seconds']:.1f} s), "
          f"model_flops {mf:.6e} (ratio {mf / counted:.4f}); device {r.get('device_split_ms')} ms, event median "
          f"{r.get('step_ms_median')} ms; share of the 989e12 bf16 peak: counted {r.get('counted_share_bf16_peak')}, "
          f"model_flops {r.get('model_share_bf16_peak')}; roofline and peak on one card {r['roofline_one_card']} "
          f"[{nvidia_smi() if cuda else 'cpu'}]", flush=True)
    out["card"] = r
    del lm, opt

    if worker is not None:  # (a)
        worker.join()
        for line in res["lines"]:
            print(f"  (a) {line}", flush=True)
        if "error" in res:
            print(res["error"], flush=True)
        recs = res.get("records", [])
        n = tuple(sum(1 for x in recs if x["status"] == k) for k in ("ok", "skip", "error"))
        out["sweep"] = {"seconds": res["seconds"], "counts": n, "records": recs}
        check("error" not in res and n == DRYRUN_CELLS and all(x["counted_flops"] for x in recs if x["status"] == "ok"),
              f"(a) the meta sweep of {'/'.join(DRYRUN_ARCHS)}'s (arch x shape) cells at full width ({DR.WORKERS} "
              f"worker processes): "
              f"{n[0]} ok, {n[1]} skip, {n[2]} error == {DRYRUN_CELLS}, every ok cell counted, in "
              f"{res['seconds']:.1f} s")
        keys = set(RooflineTerms(1.0, 1.0, 1.0, 1, {}).as_dict())
        check(all(set(x["roofline"]) == keys and x["roofline"]["chips"] == 256
                  and {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes_per_device"} <= set(x["memory"])
                  for x in recs if x["status"] == "ok"),
              "(a) every ok record carries the reference's roofline keys over 256 chips and its four memory keys")
        if recs:
            for line in RP.roofline_table("pod1", root=sweep_dir).splitlines():
                print(f"  (a) {line}", flush=True)
    launches = KN.launch_counts()
    check(not any(launches.values()), f"dryrun: no kernel of K1-K10 launched: {launches}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase dryrun: {out['phase_s']:.1f} s", flush=True)
    return out, {"dryrun": launches}


# ------------------------------------------------------------------- main
# ----------------------------------------------------------------- 19. dist
DIST_ROUTES = (  # (label, ForwardConfig keywords) of the Fig-8 round on the distributed backend
    ("padded_sort", {"peer_capacity": 65536}),
    ("padded_scatter", {"peer_capacity": 65536, "marshal": "scatter"}),
    ("hier_2x2x2", {"exchange": "hierarchical", "level_sizes": (2, 2, 2)}),
    ("ragged", {"exchange": "ragged"}),
)
HAND_KERNELS = ("compact_kernel", "gather_rows_kernel", "marshal_kernel", "pack_hist_kernel",
                "pairwise_accel_kernel", "quotients_kernel", "rank_hist_kernel", "rk4_kernel",
                "scatter_rows_kernel", "track_kernel", "unmarshal_kernel")  # the __global__s of csrc/


def _device_split(fn, calls=5, warmup=2):
    """Device ms a call of ``fn`` by part, from ``torch.profiler``: NCCL's
    kernels, the hand kernels (``HAND_KERNELS``), copies and memsets, and
    every other kernel (PyTorch's); None where the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {"nccl": 0.0, "hand": 0.0, "copy": 0.0, "other": 0.0}
    for e in _device_events(prof):
        key = e.key.lower()
        part = ("nccl" if "nccl" in key else "copy" if e.key.startswith("Mem")
                else "hand" if any(k in e.key for k in HAND_KERNELS) else "other")
        parts[part] += e.self_device_time_total / 1e3 / calls
    return parts if sum(parts.values()) > 0 else None


def phase_dist(dev, R=8, C=262144, reps=10, SL=("ABC", 0, 131072), SL_STEPS=64, NB=(4096, 2)):
    """The ``torch.distributed`` backend at a world of one on the card:
    NCCL set up through ``launch.dist.init_world`` (a ``file://`` store in a
    temporary directory; the group destroyed after), the Fig-8 round on
    four routes against the stacked backend bit for bit on the same queue
    with equal call records, timed beside the stacked round with NCCL's
    device time apart, and the streamlines and N-body runs against their
    stacked runs bit for bit.  Launches of every run on the backend summed
    on the path ``dist``."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch import kernels as KN
    from repro_torch.apps import nbody
    from repro_torch.apps import streamlines as sl
    from repro_torch.core import ForwardConfig, StackedCollectives, forward_work
    from repro_torch.launch import dist as LD

    out, launches = {"routes": {}}, {}

    def count(fn):
        KN.reset_launch_counts()
        res = fn()
        for k, v in KN.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        return res

    tmp = tempfile.mkdtemp(prefix="rafi_dist_")
    t0 = time.perf_counter()
    try:
        comm = LD.init_world(dev, world=1, rank=0, store=f"file://{tmp}/store")
        out["init_s"] = time.perf_counter() - t0
        check(tdist.get_backend() == "nccl" and comm.world == 1,
              f"dist: NCCL set up at a world of one in {out['init_s']:.2f} s ({tdist.get_backend()})")
        q = _fig8_queue(dev, R, C)
        for label, kw in DIST_ROUTES:
            cfg = ForwardConfig(R, C, **kw)
            scomm = StackedCollectives()
            KN.reset_launch_counts()
            sq, stotal = forward_work(q, cfg, comm=scomm)
            s_launch = KN.launch_counts()
            comm.reset()
            KN.reset_launch_counts()
            dq, dtotal = count(lambda: forward_work(q, cfg, comm=comm))
            d_launch = KN.launch_counts()
            reads = comm.host_reads
            check(_same_queue(dq, sq, all_lanes=False) and int(dtotal) == int(stotal),
                  f"dist {label}: the round on NCCL == the stacked round: count, drops, total {int(dtotal)}, "
                  "lanes < count")
            check(dict(comm.calls) == dict(scomm.calls),
                  f"dist {label}: the same call record as the stacked round: "
                  f"{sorted((c.kind, c.tier, c.shape) for c in comm.calls)}")
            ragged = kw.get("exchange") == "ragged"
            want = dict(s_launch)
            if ragged:  # the pack and the landing of the rows over the wire: two K1 gathers for the stacked one
                want["gather_rows"] = want.get("gather_rows", 0) + 1
            if dev.type == "cuda":
                check(d_launch == want, f"dist {label}: kernel launches {d_launch} (stacked {s_launch})")
            check(reads == (1 if ragged else 0), f"dist {label}: {reads} host read(s) a round")
            rec = {
                "stacked_ms": cuda_ms(lambda: forward_work(q, cfg, comm=scomm), reps=reps),
                "dist_ms": cuda_ms(lambda: forward_work(q, cfg, comm=comm), reps=reps),
                "stacked_device_ms": device_ms(lambda: forward_work(q, cfg, comm=scomm), calls=reps)[0],
                "dist_device_ms": device_ms(lambda: forward_work(q, cfg, comm=comm), calls=reps)[0],
                "stacked_split": _device_split(lambda: forward_work(q, cfg, comm=scomm)),
                "dist_split": _device_split(lambda: forward_work(q, cfg, comm=comm)),
                "host_reads_a_round": reads,
            }
            out["routes"][label] = rec
            fmt = lambda d: "not measured" if d is None else ", ".join(f"{k} {v:.4f}" for k, v in d.items())
            print(f"  {label}: event median {rec['dist_ms']:.4f} ms (stacked {rec['stacked_ms']:.4f}); device "
                  f"{rec['dist_device_ms']:.4f} ms (stacked {rec['stacked_device_ms']:.4f}); by part: "
                  f"{fmt(rec['dist_split'])} (stacked: {fmt(rec['stacked_split'])}); host reads {reads}",
                  flush=True)

        # a lone collective's event median: the host's issue cost of an NCCL call
        small = torch.ones(R, R, 1, dtype=torch.int32, device=dev)
        out["call_ms"] = {
            f"{kind}_{backend}": cuda_ms(fn, reps=reps)
            for backend, c in (("stacked", StackedCollectives()), ("nccl", comm))
            for kind, fn in (("count_all_to_all", lambda c=c: c.all_to_all(small)),
                             ("psum", lambda c=c: c.psum(small[:, 0, 0])))}
        print("  a lone call's event median (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in out["call_ms"].items()),
              flush=True)

        def walls(fn):
            """``fn``'s result and wall time, after one untimed run (first-use costs)."""
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = fn()
            return res, time.perf_counter() - t1

        name, fid, n = SL
        cfg = sl.StreamlineConfig(num_particles=n, max_steps=SL_STEPS, dt=0.1, field_id=fid)
        (st, st_len, st_stats), s_wall = walls(lambda: sl.run(cfg, num_ranks=R, device=dev))
        (dt, dt_len, dt_stats), d_wall = walls(lambda: sl.run(cfg, num_ranks=R, device=dev, comm=comm))
        count(lambda: sl.run(cfg, num_ranks=R, device=dev, comm=comm))
        check(np.array_equal(dt, st, equal_nan=True) and dt_stats == st_stats and dt_stats["drops"] == 0,
              f"dist streamlines {name} N={n}: traces == the stacked run's bit for bit, {dt_stats}")
        out["streamlines"] = {"n": n, "rounds": dt_stats["rounds"], "wall_s": d_wall, "stacked_wall_s": s_wall}
        print(f"  streamlines {name} N={n}: {dt_stats['rounds']} rounds, wall {d_wall:.3f} s "
              f"(stacked {s_wall:.3f} s)", flush=True)

        n_b, steps = NB
        ncfg = nbody.NBodyConfig(num_particles=n_b, steps=steps, dt=5e-4, theta=0.3, eps2=1e-3, g=64.0 / n_b)
        (sp, sv, sst), s_wall = walls(lambda: nbody.run(ncfg, num_ranks=R, device=dev))
        (dp, dv, dst), d_wall = walls(lambda: nbody.run(ncfg, num_ranks=R, device=dev, comm=comm))
        count(lambda: nbody.run(ncfg, num_ranks=R, device=dev, comm=comm))
        check(np.array_equal(dp, sp) and np.array_equal(dv, sv) and dst == sst and dst["drops"] == 0,
              f"dist nbody N={n_b} {steps} steps: positions and velocities == the stacked run's bit for bit, "
              f"totals {dst['totals']}")
        out["nbody"] = {"n": n_b, "steps": steps, "wall_s": d_wall, "stacked_wall_s": s_wall}
        print(f"  nbody N={n_b}: wall {d_wall:.3f} s (stacked {s_wall:.3f} s)", flush=True)
    finally:
        LD.destroy_world()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    return out, {"dist": launches}


# ------------------------------------------------------------ 20. dist_paths
def _call_counts(comm):
    """A backend's call record as ``{kind[tier]: calls}``."""
    out = {}
    for c, n in comm.calls.items():
        key = c.kind if c.tier is None else f"{c.kind}{c.tier}"
        out[key] = out.get(key, 0) + n
    return out


def _once(fn):
    """``(fn(), ms)``: one call timed by a CUDA event pair (host time on the CPU)."""
    import torch

    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def _paired(label, stacked_fn, dist_fn, same, comm, *, reps=1, profile=True):
    """One path on the stacked backend and on the distributed one: each run
    once, event-timed (the dist run's calls recorded), its result checked
    with ``same(stacked, dist)``; with ``reps > 1`` the event median of
    ``reps`` further runs of each instead of the first; with ``profile`` one
    profiled run of each (``_device_split``).  Returns ``(record, same,
    dist result)`` and prints one line."""
    import torch

    s_res, s_ms = _once(stacked_fn)
    comm.reset()
    d_res, d_ms = _once(dist_fn)
    rec = {"nccl_calls": _call_counts(comm)}
    ok = same(s_res, d_res)
    if reps > 1:
        s_ms, d_ms = cuda_ms(stacked_fn, reps=reps, warmup=0), cuda_ms(dist_fn, reps=reps, warmup=0)
    rec.update(stacked_ms=s_ms, dist_ms=d_ms)
    if profile and torch.cuda.is_available():
        rec["stacked_split"] = _device_split(stacked_fn, calls=1, warmup=0)
        rec["dist_split"] = _device_split(dist_fn, calls=1, warmup=0)
        total = lambda d: None if d is None else sum(d.values())
        rec["stacked_device_ms"], rec["dist_device_ms"] = total(rec["stacked_split"]), total(rec["dist_split"])
    fmt = lambda d: "not measured" if d is None else ", ".join(f"{k} {v:.4f}" for k, v in d.items())
    print(f"  {label}: event {'median ' if reps > 1 else ''}{d_ms:.4f} ms (stacked {s_ms:.4f}); device "
          f"{fmt(rec.get('dist_split'))} (stacked: {fmt(rec.get('stacked_split'))}); NCCL calls {rec['nccl_calls']}",
          flush=True)
    return rec, ok, d_res


def phase_dist_paths(dev, R=8, E=32768, C=262144, S=8192, EVERY=3, PREEMPT=5, TUNE=(262144, 24576, 8, 2048),
                     FIG8_S=65536, APP_SIZE=1024, LM_LAYERS=4, SLOTS=16, MAX_LEN=128, LAYOUT=(1, 8),
                     TRAIN_LAYERS=4, BATCH=(8, 512), widths=None, profile=True, reps=3):
    """The paths beside the round on the ``torch.distributed`` backend, NCCL
    at a world of one (``launch.dist.init_world``), each beside the stacked
    run: (a) ``rotating_hotspot(R, 8, E)`` through the checkpointed retain
    drive at C, S peer slots, a checkpoint every ``EVERY`` rounds, preempted
    at ``PREEMPT`` and resumed: result dict and every boundary's digests
    equal; (b) ``autotune_forward`` on the drift burst (``TUNE``: capacity,
    emits, rounds, first slots): every burst's record and the final config
    equal; (c) ``profile_phases`` of the Fig-8 round (flat sort, ``FIG8_S``
    slots): the phase keys and the call record equal, each stage's time
    beside the other's; (d) VoPaT (scatter), lander (forwarding and deep
    compositing at 4 fragments) and schlieren at ``APP_SIZE``², R: images
    and stats bit-equal, the frame-buffer merge's ``psum`` timed alone;
    (e) a llama4-scout decode step at ``LM_LAYERS`` of 48 layers, layout
    ``LAYOUT``, ``SLOTS`` slots: logits within phase lm's plane tolerance,
    greedy tokens and drops equal; (f) one qwen2-7b train step at
    ``TRAIN_LAYERS`` of 28 layers, batch ``BATCH``, with the gradient
    ``grad_all_reduce`` (one term at a world of one): the parameters equal
    the stacked step's bit for bit.  The NCCL calls each path makes (the
    stacked run makes the same calls as tensor operations), the event
    times (the median of ``reps`` runs after the first for (a), (b), (e)
    and (f); the one checked run for the renders) and device ms by part
    (``_device_split``) beside the stacked ones, and the launches of
    every backend run on the path ``dist_paths``.  ``widths`` narrows the
    LM configs for a rehearsal."""
    import dataclasses as dc
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch import chaos as TC
    from repro_torch import kernels as KN
    from repro_torch.apps import lander, schlieren, vopat
    from repro_torch.chaos import driver as TD
    from repro_torch.configs import get_config
    from repro_torch.core import ForwardConfig, StackedCollectives
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dist as LD
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.obs import phases as OP
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out, launches = {}, {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="rafi_dist_paths_"))
    t_phase = time.perf_counter()

    def counted(fn):
        """``fn`` on the backend with its launches summed on the path."""
        def run():
            KN.reset_launch_counts()
            res = fn()
            sync()
            for k, v in KN.launch_counts().items():
                launches[k] = launches.get(k, 0) + v
            return res
        return run

    try:
        comm = LD.init_world(dev, world=1, rank=0, store=f"file://{tmp}/store")
        check(tdist.get_backend() == ("nccl" if cuda else "gloo") and comm.world == 1,
              f"dist_paths: {tdist.get_backend()} set up at a world of one")

        # (a) the checkpointed drive, preempted and resumed
        sc = TC.rotating_hotspot(R, 8, E)
        kw = dict(capacity=C, peer_capacity=S, overflow="retain", device=dev, checkpoint_every=EVERY, keep=99,
                  preempt_at=PREEMPT)
        n_run = {"stacked": 0, "dist": 0}

        def drive(backend):
            def run():
                n_run[backend] += 1
                d = tmp / f"{backend}_{n_run[backend]}"
                res = TC.run_scenario_checkpointed(R, sc, ckpt_dir=d, comm=comm if backend == "dist" else None, **kw)
                return res, TD.boundary_digests(d)
            return run

        def same_drive(a, b):
            skip = ("ckpt_dir",)
            return (_same_result({k: v for k, v in a[0].items() if k not in skip},
                                 {k: v for k, v in b[0].items() if k not in skip}) and a[1] == b[1])

        rec, ok, (res, digests) = _paired("(a) checkpointed drive", drive("stacked"), counted(drive("dist")),
                                          same_drive, comm, reps=reps, profile=profile)
        check(ok and res["preempted"] and res["done"] and res["lost"] == 0 and res["drops"] == 0,
              f"(a) rotating_hotspot({R}, 8, {E}) checkpointed, preempted at {PREEMPT} and resumed on NCCL == "
              f"stacked: result dict and the digests of {len(digests)} boundaries, {res['rounds']} rounds")
        out["drive"] = rec

        # (b) the tuner
        cap, n_emit, rounds, start = TUNE

        def tune(c):
            final, report, _b, _w = _autotune(dev, "padded", capacity=cap, n_emit=n_emit, rounds=rounds, caps=(start,),
                                              words=11, comm=c)
            return final, [dc.asdict(s) for s in report.steps], report.converged

        rec, ok, (final, steps, conv) = _paired("(b) autotune_forward", lambda: tune(None), counted(lambda: tune(comm)),
                                                lambda a, b: (a[0].peer_capacity, a[1], a[2]) == (
                                                    b[0].peer_capacity, b[1], b[2]), comm, reps=reps, profile=False)
        check(ok and conv, f"(b) the tuner on NCCL reaches the stacked run's capacities burst for burst: "
                           f"{[s['capacities'] for s in steps]} -> {final.peer_capacity}, converged {conv}")
        out["tune"] = dict(rec, bursts=len(steps), final=final.peer_capacity)

        # (c) the phase profiler at the Fig-8 shape
        Ray44 = _ray44_types()
        proto = Ray44(origin=torch.zeros(3), direction=torch.zeros(3), tmin=torch.zeros(()),
                      pixel=torch.zeros((), dtype=torch.int32), integral=torch.zeros(()), extra=torch.zeros(2))
        cfg = ForwardConfig(R, C, peer_capacity=FIG8_S)
        scomm = StackedCollectives()
        phases = {}
        for label, c in (("stacked", scomm), ("dist", comm)):
            c.reset()
            run = (lambda c=c: OP.profile_phases(cfg, n_emit=C, cap=C, proto=proto, device=dev, comm=c))
            phases[label] = (counted(run) if label == "dist" else run)()
            phases[label + "_calls"] = dict(c.calls)
        out["phases_nccl_calls"] = _call_counts(comm)
        check(list(phases["dist"]) == list(phases["stacked"]) == phase_vocabulary(cfg)
              and phases["dist_calls"] == phases["stacked_calls"],
              f"(c) profile_phases on NCCL: the stacked keys {list(phases['stacked'])} and call record")
        out["phases"] = {k: phases[k] for k in ("stacked", "dist")}
        print("  (c) stage us (NCCL / stacked): " + ", ".join(f"{k} {phases['dist'][k]:.1f} / {v:.1f}"
                                                            for k, v in phases["stacked"].items()), flush=True)

        # (d) the apps at APP_SIZE², R ranks
        def same_image(a, b):  # every image and every statistic, bit for bit
            return (all(np.array_equal(x, y) for x, y in zip(a[:-1], b[:-1])) and a[-1].keys() == b[-1].keys()
                    and all(np.array_equal(a[-1][k], b[-1][k]) for k in a[-1]))

        apps = {
            "vopat": lambda c: vopat.render(vopat.VopatScene(width=APP_SIZE, height=APP_SIZE), num_ranks=R,
                                            marshal="scatter", device=dev, comm=c),
            "lander": lambda c: lander.render_forwarding(lander.LanderScene(width=APP_SIZE, height=APP_SIZE),
                                                         num_ranks=R, device=dev, comm=c),
            "deep_compositing": lambda c: lander.render_deep_compositing(
                lander.LanderScene(width=APP_SIZE, height=APP_SIZE), num_ranks=R, max_fragments=4, device=dev,
                comm=c),
            "schlieren": lambda c: schlieren.render(schlieren.SchlierenScene(width=APP_SIZE, height=APP_SIZE),
                                                    num_ranks=R, device=dev, comm=c),
        }
        out["apps"] = {}
        for name, fn in apps.items():
            rec, ok, res = _paired(f"(d) {name} {APP_SIZE}x{APP_SIZE}", lambda fn=fn: fn(None),
                                   counted(lambda fn=fn: fn(comm)), same_image, comm, profile=False)
            stats = {k: v for k, v in res[-1].items() if k != "raw"}
            check(ok, f"(d) {name} at {APP_SIZE}x{APP_SIZE}, R={R}, on NCCL == stacked, images and stats bit for bit: "
                      f"{stats}")
            out["apps"][name] = rec
        fb = torch.rand((R, APP_SIZE * APP_SIZE + 1), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
        merge = {"stacked_ms": cuda_ms(lambda: scomm.psum(fb), reps=10) if cuda else None,
                 "dist_ms": cuda_ms(lambda: comm.psum(fb), reps=10) if cuda else None}
        if profile and cuda:
            merge["stacked_device_ms"] = device_ms(lambda: scomm.psum(fb), calls=10)[0]
            merge["dist_device_ms"] = device_ms(lambda: comm.psum(fb), calls=10)[0]
        check(torch.equal(comm.psum(fb), scomm.psum(fb)), "(d) a frame buffer's psum on NCCL == stacked bit for bit")
        out["apps"]["merge"] = merge
        print(f"  (d) the frame-buffer merge alone ({R} x {APP_SIZE}² float32): {merge}", flush=True)

        # (e) the llama4-scout decode step on layout (1, tp)
        if cuda:
            torch.cuda.empty_cache()
        cfg = dc.replace(get_config(LM_ARCH), num_layers=LM_LAYERS, **(widths or {}))
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(2828), device=dev)
        token = torch.randint(0, cfg.vocab_size, (SLOTS, 1), generator=torch.Generator(device=dev).manual_seed(5),
                              device=dev, dtype=torch.int32)
        caches = model.init_caches(SLOTS, MAX_LEN, device=dev)
        steps = {b: model.decode_fn(layout=Layout(*LAYOUT, comm=c), drops=True)
                 for b, c in (("stacked", None), ("dist", comm))}

        def same_step(a, b):
            d = (a[0].float() - b[0].float()).abs().max().item()
            out["decode_max_abs_logit_diff"] = d
            return d <= LM_TOL_PLANES and torch.equal(a[0].argmax(-1), b[0].argmax(-1)) and int(a[2]) == int(b[2])

        with torch.no_grad():
            rec, ok, res = _paired(f"(e) {cfg.name} decode step, {LM_LAYERS} layers, layout {LAYOUT}, {SLOTS} slots",
                                   lambda: steps["stacked"](params, token, caches),
                                   counted(lambda: steps["dist"](params, token, caches)), same_step, comm,
                                   reps=10 if cuda else 1, profile=profile)
        check(ok, f"(e) the decode step on NCCL: logits within {LM_TOL_PLANES} of the stacked step's "
                  f"(max {out['decode_max_abs_logit_diff']}), greedy tokens and drops ({int(res[2])}) equal")
        out["decode"] = rec
        del params, caches, res, steps
        if cuda:
            torch.cuda.empty_cache()

        # (f) one qwen2-7b train step with the gradient all-reduce
        cfg = dc.replace(get_config("qwen2-7b"), num_layers=TRAIN_LAYERS, **(widths or {}))
        model = build_model(cfg)
        opt_cfg = AdamWConfig(warmup_steps=20)
        b, s = BATCH
        batch = SyntheticLM(cfg.vocab_size, s, b).batch_at(0)

        def fresh():
            lm = model.init(torch.Generator(device=dev).manual_seed(4141), device=dev)
            return lm, adamw_init(lm, opt_cfg)

        lm, opt = fresh()
        step = build_train_step(model, None, opt_cfg)
        step(lm, opt, batch)
        want = [p.detach().cpu() for p in lm.parameters()]
        stacked_ms = cuda_ms(lambda: step(lm, opt, batch), reps=reps, warmup=0) if cuda else None
        stacked_split = _device_split(lambda: step(lm, opt, batch), calls=1, warmup=0) if profile and cuda else None
        del lm, opt
        if cuda:
            torch.cuda.empty_cache()
        lm, opt = fresh()
        dstep = build_train_step(model, None, opt_cfg, comm=comm)
        comm.reset()
        counted(lambda: dstep(lm, opt, batch))()
        rec = {"nccl_calls": _call_counts(comm), "grad_all_reduce_bytes": sum(c.nbytes * n for c, n in comm.calls.items())}
        ok = all(torch.equal(p.detach().cpu(), w) for p, w in zip(lm.parameters(), want))
        check(ok, f"(f) {cfg.name} at {TRAIN_LAYERS} layers, batch {b} x {s}: one step with the gradient all-reduce "
                  f"on NCCL == the stacked step, every parameter bit for bit ({len(want)} leaves, "
                  f"{rec['grad_all_reduce_bytes']} B reduced in {sum(comm.calls.values())} calls)")
        rec["dist_ms"] = cuda_ms(lambda: dstep(lm, opt, batch), reps=reps, warmup=0) if cuda else None
        rec["dist_split"] = _device_split(lambda: dstep(lm, opt, batch), calls=1, warmup=0) if profile and cuda else None
        rec.update(stacked_ms=stacked_ms, stacked_split=stacked_split)
        fmt = lambda d: "not measured" if d is None else ", ".join(f"{k} {v:.4f}" for k, v in d.items())
        print(f"  (f) train step: event median {rec['dist_ms']} ms (stacked {stacked_ms}); device "
              f"{fmt(rec['dist_split'])} (stacked: {fmt(stacked_split)}); calls {rec['nccl_calls']}", flush=True)
        out["train"] = rec
        del lm, opt, want
        if cuda:
            torch.cuda.empty_cache()
    finally:
        LD.destroy_world()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    return out, {"dist_paths": launches}


# ----------------------------------------------------------------- 21. shard
SHARD_TOL = {"loss": 1e-5, "gnorm": 1e-4}  # (b): float32 placed against whole, relative
SHARD_K = 4  # (b): the gradient's distance to float64 against K times the whole float32 step's


def _chunked(whole, spec, axes, rank):
    """Rank ``rank``'s block of ``whole`` under the resolved ``spec``, cut by
    ``torch.chunk`` (a second cut, beside ``launch.specs.cut``'s slices)."""
    from repro_torch.launch import specs as S

    coords = S.rank_coords(rank, axes)
    out = whole
    for dim, part in enumerate(spec):
        pieces, index = 1, 0
        for ax in S.spec_axes(part):
            pieces, index = pieces * axes[ax], index * axes[ax] + coords[ax]
        if pieces > 1:
            out = out.chunk(pieces, dim=dim)[index]
    return out


def _same_tensor(a, b):
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _blocks_match(placed, whole, placement):
    """Leaves of ``placed`` whose rank blocks are not, bit for bit, the
    chunks of ``whole`` that the rule names (every rank)."""
    bad = []
    for path, spec in placement.specs.items():
        p, w = placed, whole
        for k in path:
            p, w = p[k], w[k]
        if not all(_same_tensor(p[r], _chunked(w, spec, placement.axes, r)) for r in range(p.shape[0])):
            bad.append(".".join(path))
    return bad


def _leaf_items(tree):
    from repro_torch.launch import specs as S

    return dict(S.named_leaves(tree))


def _close(got, want, lr):
    """Leaves of ``got`` (gathered placed parameters) farther from ``want``
    (the whole step's) than two first-step learning rates plus 2^-20 of
    the value, element by element, and the largest |difference|."""
    bad, worst = [], 0.0
    for path, g in got.items():
        d = (g - want[path]).abs()
        worst = max(worst, float(d.max()))
        if bool((d > 2 * lr + want[path].abs() * 2.0 ** -20).any()):
            bad.append(".".join(path))
    return bad, worst


def _top_events(fn, n=12):
    """The ``n`` device events of one call of ``fn`` with the most device
    time: ``[(name, ms, launches)]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(_short(e.key), e.self_device_time_total / 1e3, e.count) for e in _device_events(prof) if e.count]
    return sorted(rows, key=lambda r: -r[1])[:n]


def _float64_config(cfg):
    """``cfg`` with float64 parameters and activations (the attention
    scores and the loss stay float32, as the port computes them)."""
    import dataclasses as dc

    import torch

    from repro_torch.models.common import ModelConfig

    @dc.dataclass(frozen=True)
    class Float64Config(ModelConfig):
        @property
        def torch_dtype(self):
            return torch.float64

    return Float64Config(**{f.name: getattr(cfg, f.name) for f in dc.fields(cfg)})


class _GradCapture:
    """The gradients AdamW receives, each leaf whole (placed gradients
    gathered first), handed to ``keep(path, grad)`` before the update."""

    def __init__(self, keep):
        self.keep = keep

    def __enter__(self):
        from repro_torch.launch import placement as PL
        from repro_torch.launch import steps as ST

        self._ST, update = ST, ST.adamw_update

        def capture(params, grads, *a, **kw):
            whole = params.placement.gather(PL.Placed(grads, params.placement)) if PL.is_placed(params) else grads
            for k, g in _leaf_items(whole).items():
                self.keep(k, g)
            del whole
            return update(params, grads, *a, **kw)

        self._update, ST.adamw_update = update, capture
        return self

    def __exit__(self, *exc):
        self._ST.adamw_update = self._update


def _conditioned(lm, n_blocks):
    """The column-parallel weights of every block (``wq``, ``wk``, ``wv``,
    ``wi``, ``wg``, drawn at 1/sqrt(n_blocks)) scaled to 0.02, so that the
    attention is not saturated (module docstring of phase ``shard``)."""
    import math

    import torch

    with torch.no_grad():
        for name, p in lm.named_parameters():
            if name.startswith("blocks.") and name.rsplit(".", 1)[1] in ("wq", "wk", "wv", "wi", "wg"):
                p.mul_(0.02 * math.sqrt(n_blocks))
    return lm


def phase_shard(dev, ARCH="qwen2-7b", LAYERS=4, CHECK_LAYERS=2, LAYOUT=(2, 4), ELASTIC=(4, 2), BATCH=(8, 512),
                widths=None, profile=True, reps=3):
    """The dense family's placed train state (``launch.placement``) at full
    width: ARCH with ``fsdp=True`` placed on the ``LAYOUT`` layout stacked in
    one process.  At ``LAYERS`` layers in bfloat16 (the config as
    published): (a) every rank's block of every parameter, and after a step
    of every AdamW moment, equals bit for bit the chunk of the whole leaf
    that the rule names (a ``torch.chunk`` cut beside ``specs.cut``'s), and
    a rank's bytes ``specs.device_bytes`` on the mesh; the placed step at
    ``BATCH``: loss and gnorm finite, the recorder's calls by kind and tier
    for one step, event median, device ms by part (``_step_device_ms``), its
    top device events and its peak GiB above what it holds, beside the
    unsharded step's; (c) the placed parameters checkpointed (written
    whole) restore onto the ``ELASTIC`` placement and whole, bit for bit,
    each part's seconds (the moments' checkpoint is the tests' on the
    CPU: the whole state's 20.2 GB took 75.7 s to write and 45–49 s to
    restore on the card, over the phase's share); (d) the same step over NCCL at a world of
    one (``launch.dist.init_world``): loss, gnorm and the gathered
    parameters bit-equal to the stacked placed step's, timed.  (b) At
    ``CHECK_LAYERS`` layers in float32, on conditioned weights (the
    blocks' column weights at 0.02, ``_conditioned``), one placed step
    against the unsharded step from the same weights: loss and gnorm
    within ``SHARD_TOL`` relative; the gradient's distance to a float64
    step's within ``SHARD_K`` times the unsharded float32 step's; every
    gathered parameter within two first-step learning rates (Adam's first
    move is lr·sign(g), so a component whose gradient is near 0 may move
    either way) plus 2^-20 of its value.  Conditioned, because at the
    config's own draw (block weights at 1/sqrt(layers)) the attention is
    saturated and the gradient ill-conditioned: there the unsharded
    float32 step's gradient lies 19–22% (relative L2, layer 0's attention
    leaves) from float64's and every placed layout's 23–27%, FSDP alone
    as far as FSDP with tensor parallelism (``tools/shard_grad_errors.py``).
    No hand kernel is on this path.  ``widths``
    narrows the config for a rehearsal on the CPU."""
    import dataclasses as dc
    import gc
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dist as LD
    from repro_torch.launch import placement as PL
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    opt_cfg = AdamWConfig(warmup_steps=20)
    b, s = BATCH
    out = {"layers": LAYERS, "check_layers": CHECK_LAYERS, "layout": LAYOUT, "batch": BATCH}

    def free(where=None):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            if where:
                out.setdefault("allocated_gib", {})[where] = torch.cuda.memory_allocated(dev) / 2**30

    def setup(layers, **changes):
        cfg = dc.replace(get_config(ARCH), num_layers=layers, fsdp=True, **(widths or {}), **changes)
        model = build_model(cfg)
        return cfg, model, build_train_step(model, None, opt_cfg), SyntheticLM(cfg.vocab_size, s, b).batch_at(0)

    def init(model):
        return model.init(torch.Generator(device=dev).manual_seed(3131), device=dev)

    def gathered_cpu(placement, tree):
        return {k: v.cpu() for k, v in _leaf_items(placement.gather(tree)).items()}

    cfg, model, step, batch = setup(LAYERS)
    label = f"{cfg.name} at {LAYERS} of {get_config(ARCH).num_layers} layers, fsdp, layout {LAYOUT}"
    out["remat"] = cfg.remat

    # (a) the placement, then one placed step and its timing
    placement = PL.train_placement(model, Layout(*LAYOUT))
    lm = init(model)
    params = placement.place(lm)
    bad = _blocks_match(params, lm.tree(), placement)
    rule = sum(S.device_bytes(torch.empty(placement.shapes[k], dtype=cfg.torch_dtype, device="meta"), spec,
                              placement.axes) for k, spec in placement.specs.items())
    sizes = [sum(p[r].numel() * p.element_size() for p in _leaf_items(params).values())
             for r in range(LAYOUT[0] * LAYOUT[1])]
    out["param_bytes_per_rank"] = sizes
    out["param_bytes_whole"] = sum(p.numel() * p.element_size() for p in lm.parameters())
    check(not bad and set(sizes) == {rule},
          f"(a) {label}: every rank's block of the {len(placement.specs)} parameter leaves == the chunk the rule "
          f"names, bit for bit (mismatched: {bad}); {sizes[0]} B a rank == specs.device_bytes {rule} (whole "
          f"{out['param_bytes_whole']} B)")
    del lm
    free()
    opt = adamw_init(params, opt_cfg)
    if cuda:
        out["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
    placement.comm.reset()
    met = step(params, opt, batch)[2]  # no name keeps the state alive
    out["calls"] = _call_counts(placement.comm)
    out["call_bytes"] = {}
    for c, n in placement.comm.calls.items():
        key = c.kind if c.tier is None else f"{c.kind}{c.tier}"
        out["call_bytes"][key] = out["call_bytes"].get(key, 0) + c.nbytes * n
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    placed_met = (float(met["loss"]), float(met["gnorm"]))
    placed_after = gathered_cpu(placement, params)
    bad = [f"{k}.{p}" for k in ("m", "v") for p in _blocks_match(opt[k], placement.gather(opt[k]), placement)]
    opt_rank = sum(v[0].numel() * v.element_size() for k in ("m", "v") for v in _leaf_items(opt[k]).values())
    out["opt_bytes_per_rank"] = opt_rank
    check(all(map(math.isfinite, placed_met)) and not bad and opt_rank == 2 * rule * 4 // cfg.torch_dtype.itemsize,
          f"(a) {label}, batch {b} x {s}: the placed step's loss and gnorm {placed_met} finite; every rank's block of "
          f"AdamW's m and v == the chunk of the gathered leaf, bit for bit (mismatched: {bad}); {opt_rank} B a rank")
    if cuda:
        out["step_ms_median"] = cuda_ms(lambda: step(params, opt, batch), reps=reps, warmup=0)
        if profile:
            out["device_split_ms"] = _step_device_ms(step, params, opt, batch)
            out["top_events"] = _top_events(lambda: step(params, opt, batch))

    # (c) the placed parameters written whole, restored onto another
    # factorization and whole
    state_dir = pathlib.Path(tempfile.mkdtemp(prefix="rafi_shard_"))
    try:
        free("after the placed timing")
        del opt
        free("without the placed moments")
        whole_state = {"params": placement.gather(params)}
        t0 = time.perf_counter()
        save_checkpoint(state_dir, 1, {"params": params})
        out["ckpt_save_s"] = time.perf_counter() - t0
        out["ckpt_bytes"] = sum(f.stat().st_size for f in state_dir.rglob("*.npy"))
        del params
        free("without the placed parameters")
        like = {"params": _nest({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                                 for k, v in _leaf_items(whole_state["params"]).items()})}
        other = PL.train_placement(model, Layout(*ELASTIC))
        t0 = time.perf_counter()
        moved = restore_checkpoint(state_dir, 1, like, device=dev, shardings={"params": other})
        out["ckpt_restore_placed_s"] = time.perf_counter() - t0
        bad = _blocks_match(moved["params"], whole_state["params"], other)
        check(PL.is_placed(moved["params"]) and not bad,
              f"(c) the placed parameters checkpointed ({out['ckpt_bytes']} B in {out['ckpt_save_s']:.1f} s) restore "
              f"onto {ELASTIC} ({out['ckpt_restore_placed_s']:.1f} s): every rank's block == the chunk of the whole "
              f"leaf, bit for bit (mismatched: {bad})")
        del moved
        free()
        t0 = time.perf_counter()
        back = _leaf_items(restore_checkpoint(state_dir, 1, like, device=dev))
        out["ckpt_restore_whole_s"] = time.perf_counter() - t0
        want = _leaf_items(whole_state)
        check(set(back) == set(want) and all(_same_tensor(back[k], v) for k, v in want.items()),
              f"(c) and restores whole ({out['ckpt_restore_whole_s']:.1f} s), all {len(want)} leaves bit for bit")
        del back, want, whole_state
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)
    free("after the checkpoint")

    # the unsharded step beside it
    lm = init(model)
    wopt = adamw_init(lm, opt_cfg)
    if cuda:
        out["whole_held_gib"] = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
    wmet = step(lm, wopt, batch)[2]
    out["whole"] = (float(wmet["loss"]), float(wmet["gnorm"]))
    if cuda:
        out["whole_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["whole_step_ms_median"] = cuda_ms(lambda: step(lm, wopt, batch), reps=reps, warmup=0)
        if profile:
            out["whole_device_split_ms"] = _step_device_ms(step, lm, wopt, batch)
            out["whole_top_events"] = _top_events(lambda: step(lm, wopt, batch))
    del lm, wopt
    free()
    out["placed"] = placed_met
    print(f"  (a) placed step: calls {out['calls']} (bytes {out['call_bytes']}); event median "
          f"{out.get('step_ms_median')} ms, device {out.get('device_split_ms')} ms, peak {out.get('peak_gib')} GiB "
          f"({out.get('held_gib')} held before); whole step: event median {out.get('whole_step_ms_median')} ms, device "
          f"{out.get('whole_device_split_ms')} ms, peak {out.get('whole_peak_gib')} GiB ({out.get('whole_held_gib')} "
          f"held); (loss, gnorm) placed {placed_met}, whole {out['whole']}; top device events placed "
          f"{out.get('top_events')}, whole {out.get('whole_top_events')}", flush=True)

    # (d) the same placed step over NCCL (gloo on the CPU) at a world of one
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="rafi_shard_dist_"))
    try:
        dcomm = LD.init_world(dev, world=1, rank=0, store=f"file://{tmp}/store")
        dplacement = PL.train_placement(model, Layout(*LAYOUT, comm=dcomm))
        lm = init(model)
        dparams = dplacement.place(lm)
        del lm
        free()
        dopt = adamw_init(dparams, opt_cfg)
        dcomm.reset()
        dmet = step(dparams, dopt, batch)[2]
        out["nccl_calls"] = _call_counts(dcomm)
        dist_met = (float(dmet["loss"]), float(dmet["gnorm"]))
        after = gathered_cpu(dplacement, dparams)
        same = dist_met == placed_met and all(_same_tensor(after[k], v) for k, v in placed_after.items())
        check(same and out["nccl_calls"] == out["calls"],
              f"(d) the placed step on {'NCCL' if cuda else 'gloo'} at a world of one == the stacked placed step: "
              f"(loss, gnorm) {dist_met}, every gathered parameter bit for bit, calls {out['nccl_calls']}")
        if cuda:
            out["nccl_step_ms_median"] = cuda_ms(lambda: step(dparams, dopt, batch), reps=reps, warmup=0)
            if profile:
                out["nccl_split_ms"] = _device_split(lambda: step(dparams, dopt, batch), calls=1, warmup=0)
        print(f"  (d) NCCL placed step: event median {out.get('nccl_step_ms_median')} ms, device "
              f"{out.get('nccl_split_ms')} ms", flush=True)
        del dparams, dopt, after
    finally:
        LD.destroy_world()
        shutil.rmtree(tmp, ignore_errors=True)
    del placed_after
    free()

    # (b) float32 at CHECK_LAYERS layers, conditioned weights: the placed
    # step against the whole step, each against a float64 witness
    lr1 = opt_cfg.lr / opt_cfg.warmup_steps
    runs, truth = {}, {}
    for name, placed in (("whole64", False), ("whole32", False), ("placed32", True)):
        cfg_b, model_b, step_b, batch_b = setup(CHECK_LAYERS, dtype="float32")
        if name == "whole64":
            model_b = build_model(_float64_config(cfg_b))
            step_b = build_train_step(model_b, None, opt_cfg)
        lm = _conditioned(init(model_b), CHECK_LAYERS)
        params = PL.train_placement(model_b, Layout(*LAYOUT)).place(lm) if placed else lm
        del lm
        free()
        err = {}

        def keep(path, g):
            if name == "whole64":
                truth[path] = g.detach().cpu()
            else:
                t = truth[path].to(g.device)
                err[path] = (float((g.double() - t).norm()), float(t.norm()))

        with _GradCapture(keep):
            met = step_b(params, adamw_init(params, opt_cfg), batch_b)[2]
        whole = params.placement.gather(params) if placed else params.tree()
        runs[name] = {"loss": float(met["loss"]), "gnorm": float(met["gnorm"]), "err": err,
                      "params": None if name == "whole64" else {k: v.detach().cpu() for k, v in _leaf_items(whole).items()}}
        del params, whole
        free()
    total = math.sqrt(sum(n * n for _d, n in runs["whole32"]["err"].values()))
    rel_err = lambda r: math.sqrt(sum(d * d for d, _n in runs[r]["err"].values())) / total
    worst_leaf = lambda r: max(((".".join(k), d / total) for k, (d, _n) in runs[r]["err"].items()), key=lambda t: t[1])
    bad, worst = _close(runs["placed32"]["params"], runs["whole32"]["params"], lr1)
    rel = lambda x, y: abs(x - y) / abs(y)
    fc = {k: {"loss": v["loss"], "gnorm": v["gnorm"]} for k, v in runs.items()}
    fc.update(param_max_abs_diff=worst, grad_rel_err={r: rel_err(r) for r in ("whole32", "placed32")},
              worst_leaf={r: worst_leaf(r) for r in ("whole32", "placed32")})
    out["float32_check"] = fc
    own = max(fc["grad_rel_err"]["whole32"], 1e-7)
    check(rel(runs["placed32"]["loss"], runs["whole32"]["loss"]) <= SHARD_TOL["loss"]
          and rel(runs["placed32"]["gnorm"], runs["whole32"]["gnorm"]) <= SHARD_TOL["gnorm"]
          and fc["grad_rel_err"]["placed32"] <= SHARD_K * own and not bad,
          f"(b) {ARCH} at {CHECK_LAYERS} layers in float32, conditioned weights, batch {b} x {s}: the placed step's "
          f"(loss, gnorm) ({runs['placed32']['loss']}, {runs['placed32']['gnorm']}) against the whole step's "
          f"({runs['whole32']['loss']}, {runs['whole32']['gnorm']}), relative <= {SHARD_TOL}; its gradient's "
          f"distance to the float64 step's {fc['grad_rel_err']['placed32']:.3g} of the gradient's norm <= "
          f"{SHARD_K} x the whole float32 step's {own:.3g} (worst leaves {fc['worst_leaf']}); every gathered "
          f"parameter within 2 lr1 + 2^-20 |p| (max |d| {worst:.3g}; beyond: {bad})")
    out["wall_s"] = time.perf_counter() - t_phase
    return out, {}


# -------------------------------------------------------------- 22. serve_shard
def _seeded_caches(model, slots, max_len, depths, seed, dev):
    """Decode caches with k and v drawn from ``seed`` (normal) and each
    slot's ``pos`` at ``depths``."""
    import torch

    caches = model.init_caches(slots, max_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for path, leaf in _leaf_items(caches).items():
        if path[-1] == "pos":
            leaf.copy_(torch.as_tensor(depths, dtype=leaf.dtype, device=dev).expand_as(leaf))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev, dtype=torch.float32))
    return caches


def _cast_tree(tree, dtype):
    """A nested dict of tensors with every floating leaf cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _serve_split(step, params, token, caches, comm=None, calls=3):
    """Device ms of one decode step by part, from ``torch.profiler``: each
    part's kernels found through a ``record_function`` range around it
    (the attention layers, the MLPs, the sequence split's combine, the
    collectives of ``comm``, the gather of the whole logits; a range's
    time holds the ranges inside it), and the step's total."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import api as API
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as TF

    parts = {"attention": [(A, "self_attention"), (A, "self_attention_placed")],
             "mlp": [(TF, "glu_mlp"), (TF, "glu_mlp_placed")], "combine": [(A, "_combine")],
             "whole_logits": [(API, "_whole_logits")]}
    if comm is not None:
        parts["collectives"] = [(comm, "psum"), (comm, "all_gather")]
    orig = [(m, n, getattr(m, n)) for targets in parts.values() for m, n in targets]

    def ranged(name, fn):
        def w(*a, **kw):
            with record_function(f"ss.{name}"):
                return fn(*a, **kw)
        return w

    for name, targets in parts.items():
        for m, n in targets:
            setattr(m, n, ranged(name, getattr(m, n)))
    try:
        step(params, token, caches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                step(params, token, caches)
            torch.cuda.synchronize()
    finally:
        for m, n, f in orig:
            if m is comm:
                delattr(m, n)
            else:
                setattr(m, n, f)
    dev_us = lambda e: getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
    split = {k: None for k in parts}
    for e in prof.key_averages():
        if e.key.startswith("ss.") and e.device_type != torch.autograd.DeviceType.CUDA:
            split[e.key[3:]] = dev_us(e) / calls / 1e3 or None
    total = sum(e.self_device_time_total for e in _device_events(prof) if not e.key.startswith("ss."))
    return {"step_device_ms": total / calls / 1e3, "parts_ms": split}


def _peak_above_held(fn, dev):
    """GiB ``fn`` takes on the card above what was allocated before it."""
    import torch

    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - before) / 2**30


def phase_serve_shard(dev, ARCH="qwen2-7b", LAYERS=4, CHECK_LAYERS=2, LAYOUT=(2, 4), SLOTS=16, MAX_LEN=128,
                      N_REQ=16, PROMPT=(8, 48), NEW=(8, 24), LONG=4096, LONG_POS=4000, PREFILL=(2, 2048),
                      CHECK_STEPS=16, widths=None, profile=True, reps=5):
    """Serving the dense family on placed parameters (``launch.placement.
    serve_placement``: FSDP dropped, every weight split over ``model`` and
    replicated over ``data``; ``cache_placement``: the slots over ``data``,
    the sequence over ``model``): ARCH at full width, ``LAYERS`` layers in
    bfloat16, on the ``LAYOUT`` layout stacked in one process.  (a) Every
    rank's block of every parameter and of seeded caches (``SLOTS`` slots,
    ``MAX_LEN``) equals bit for bit the chunk of the whole leaf the rule
    names (``torch.chunk``), a rank's bytes ``specs.device_bytes``.  (b)
    ``BatchedEngine`` on the placed parameters answers phase lm's
    ``N_REQ`` requests, each with its ``max_new_tokens``, beside the
    unsharded engine on the same weights: each engine's event median a
    step, one step's device ms by part (``_serve_split``), top device
    events and peak GiB above what is held; the recorder's calls a step
    by kind and tier (a layer: three ``all_gather``s and three ``psum``s
    over ``model``; the embedding's ``psum``, the logits' two gathers) and
    their bytes; a decode step on caches ``LONG`` long, seeded, every slot
    at ``LONG_POS`` (live positions on every model rank), placed and
    unsharded, timed; a ``PREFILL`` placed prefill beside the unsharded
    one, timed.  The long decode's and the prefill's bfloat16 logits lie
    no farther from the unsharded bfloat16 ones than ``FAM_BF16_NOISE``
    times those lie from the float32 model's on the same inputs.  (c) At
    ``CHECK_LAYERS`` layers in float32, teacher-forced over
    ``CHECK_STEPS`` steps from seeded caches whose rows start at depths
    spread over the sequence, so that they cross every model rank's
    block: the placed step's logits within 1 / ``FAM_F32_GAIN`` of the
    bfloat16 model's distance from the unsharded float32 step's, ``pos``
    equal.  (d) The placed engine on NCCL at a world of one (gloo on the
    CPU): tokens, last logits and calls equal to the stacked run's,
    timed.  (e) No kernel of K1–K10 is launched.  ``widths`` narrows the
    config for a rehearsal on the CPU."""
    import dataclasses as dc
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.launch import dist as LD
    from repro_torch.launch import placement as PL
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.serve import BatchedEngine
    from repro_torch.models.api import build_model

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    KN.reset_launch_counts()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    d, m = LAYOUT
    out = {"layers": LAYERS, "check_layers": CHECK_LAYERS, "layout": LAYOUT, "slots": SLOTS, "max_len": MAX_LEN}

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def timed(fn):
        return cuda_ms(fn, reps=reps, warmup=1) if cuda else None

    free()
    cfg = dc.replace(get_config(ARCH), num_layers=LAYERS, **(widths or {}))
    model = build_model(cfg)
    label = f"{cfg.name} at {LAYERS} of {get_config(ARCH).num_layers} layers, layout {LAYOUT}"
    lm = model.init(torch.Generator(device=dev).manual_seed(3232), device=dev)
    whole = lm.tree()

    # (a) the placements, bit for bit
    sp = PL.serve_placement(model, Layout(*LAYOUT))
    params = sp.place(lm)
    meta_bytes = lambda pl, k, dt: S.device_bytes(torch.empty(pl.shapes[k], dtype=dt, device="meta"), pl.specs[k],
                                                  pl.axes)
    rank_bytes = lambda tree: [sum(t[r].numel() * t.element_size() for t in _leaf_items(tree).values())
                               for r in range(d * m)]
    bad = _blocks_match(params, whole, sp)
    rule = sum(meta_bytes(sp, k, cfg.torch_dtype) for k in sp.specs)
    sizes = rank_bytes(params)
    out["param_bytes_per_rank"], out["param_bytes_whole"] = sizes, sum(t.numel() * t.element_size()
                                                                       for t in lm.parameters())
    check(not bad and set(sizes) == {rule} and not any(S.DATA in S.spec_axes(p) for s in sp.specs.values() for p in s),
          f"(a) {label}: every rank's block of the {len(sp.specs)} parameter leaves == the chunk the serve rule names, "
          f"bit for bit (mismatched: {bad}), nothing split over data; {sizes[0]} B a rank == specs.device_bytes "
          f"{rule} (whole {out['param_bytes_whole']} B)")
    depths = [(s * (MAX_LEN - CHECK_STEPS)) // SLOTS for s in range(SLOTS)]
    cp = PL.cache_placement(model, Layout(*LAYOUT), SLOTS, MAX_LEN)
    wcaches = _seeded_caches(model, SLOTS, MAX_LEN, depths, 3233, dev)
    pcaches = cp.place(wcaches)
    bad = _blocks_match(pcaches, wcaches, cp)
    rule = sum(meta_bytes(cp, k, cp.dtypes[k]) for k in cp.specs)
    sizes = rank_bytes(pcaches)
    out["cache_bytes_per_rank"] = sizes
    check(not bad and set(sizes) == {rule},
          f"(a) the caches ({SLOTS} slots, max_len {MAX_LEN}): every rank's block of the {len(cp.specs)} leaves == "
          f"the chunk the rule names, bit for bit (mismatched: {bad}); {sizes[0]} B a rank == specs.device_bytes "
          f"{rule}")

    # (b) the placed engine beside the unsharded one, on the same weights
    requests = _lm_requests(cfg.vocab_size, N_REQ, PROMPT, NEW)
    token = torch.from_numpy(np.random.default_rng(3234).integers(0, cfg.vocab_size, (SLOTS, 1))
                             .astype(np.int32)).to(dev)
    engines = {}
    for name, p, c in (("placed", params, pcaches), ("whole", lm, wcaches)):
        engine = BatchedEngine(model, p, slots=SLOTS, max_len=MAX_LEN, device=dev)
        rec = _StepRecorder(engine)
        engine._step(p, token, c)  # warm-up: first-use costs
        sp.comm.reset()
        sync()
        t0 = time.perf_counter()
        served = engine.run(requests)
        sync()
        wall = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in rec.events] if cuda else []
        r = {"steps": engine.steps, "tokens": sum(map(len, served.values())), "wall_s": wall,
             "step_ms_median": statistics.median(step_ms) if step_ms else None}
        check(all(len(served[q.rid]) == q.max_new_tokens for q in requests),
              f"(b) the {name} engine answers all {N_REQ} requests with their max_new_tokens ({r['tokens']} tokens "
              f"in {r['steps']} steps)")
        if name == "placed":
            calls = _call_counts(sp.comm)
            r["calls_per_step"] = {k: v / engine.steps for k, v in calls.items()}
            r["call_bytes_per_step"] = {}
            for c_, n in sp.comm.calls.items():
                key = c_.kind if c_.tier is None else f"{c_.kind}{c_.tier}"
                r["call_bytes_per_step"][key] = r["call_bytes_per_step"].get(key, 0) + c_.nbytes * n / engine.steps
            want = {"all_gather1": 3 * LAYERS + 1, "psum1": 3 * LAYERS + 1, "all_gather0": 1}
            check(r["calls_per_step"] == want,
                  f"(b) the placed step's calls by kind and tier {r['calls_per_step']} == {want}")
        if cuda:
            r["peak_gib_above_held"] = _peak_above_held(lambda: engine._step(p, token, c), dev)
            if profile:
                r["split"] = _serve_split(engine._step, p, token, c, comm=sp.comm if name == "placed" else None)
                r["top_events"] = _top_events(lambda: engine._step(p, token, c))
        engines[name] = (r, served, rec)
        out[f"{name}_engine"] = r
    agree = sum(a == b for q in requests for a, b in zip(engines["placed"][1][q.rid], engines["whole"][1][q.rid]))
    out["engine_tokens_agree"] = (agree, sum(q.max_new_tokens for q in requests))
    print(f"  (b) engines: placed {out['placed_engine']}, whole {out['whole_engine']}; tokens equal "
          f"{agree} of {out['engine_tokens_agree'][1]} (bfloat16)", flush=True)
    del pcaches, wcaches
    free()

    # float32 twins of the weights (the bfloat16 ones widened) for the noise
    # the long decode and the prefill are held against
    cfg32 = dc.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    whole32 = _cast_tree(whole, torch.float32)

    def noise_check(what, placed_l, whole_l, f32_l):
        dp = float((placed_l.float() - whole_l.float()).abs().max())
        db = float((whole_l.float() - f32_l.float()).abs().max())
        fin = bool(torch.isfinite(placed_l).all()) and bool(torch.isfinite(whole_l).all())
        check(fin and dp <= FAM_BF16_NOISE * db,
              f"(b) {what}: placed bfloat16 logits {tuple(placed_l.shape)} finite, max |placed - unsharded| {dp:.4g} "
              f"<= {FAM_BF16_NOISE} x the unsharded bfloat16 logits' distance from float32's {db:.4g}")
        return {"placed_vs_whole": dp, "bf16_vs_f32": db}

    # a decode step on caches LONG long, every slot at LONG_POS
    step = model.decode_fn()
    cpl = PL.cache_placement(model, Layout(*LAYOUT), SLOTS, LONG)
    wlong = _seeded_caches(model, SLOTS, LONG, [LONG_POS] * SLOTS, 3235, dev)
    plong = cpl.place(wlong)
    lp, new = step(params, token, plong)
    lw, _ = step(lm, token, wlong)
    l32, _ = model32.decode_fn()(whole32, token, _cast_tree(wlong, torch.float32))
    pos = cpl.gather(new)["blocks"]
    long = noise_check(f"a decode step on caches {LONG} long at position {LONG_POS}", lp, lw, l32)
    check(all(bool((c["pos"] == LONG_POS + 1).all()) for c in pos.values()),
          f"(b) the long decode's pos all {LONG_POS + 1}")
    del lp, lw, l32, new
    if cuda:
        long.update(placed_ms=timed(lambda: step(params, token, plong)),
                    whole_ms=timed(lambda: step(lm, token, wlong)))
        if profile:
            long.update(placed_device_ms=device_ms(lambda: step(params, token, plong), calls=5, warmup=1)[0],
                        whole_device_ms=device_ms(lambda: step(lm, token, wlong), calls=5, warmup=1)[0])
    out["long_decode"] = long
    del plong, wlong
    free()

    # a placed prefill of PREFILL tokens
    b, s = PREFILL
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3236).integers(0, cfg.vocab_size, (b, s))
                                        .astype(np.int32)).to(dev)}
    prefill = model.prefill_fn()
    pre = noise_check(f"a prefill of {b} x {s} tokens", prefill(params, batch), prefill(lm, batch),
                      model32.prefill_fn()(whole32, batch))
    if cuda:
        pre.update(placed_ms=timed(lambda: prefill(params, batch)), whole_ms=timed(lambda: prefill(lm, batch)))
        pre["placed_peak_gib_above_held"] = _peak_above_held(lambda: prefill(params, batch), dev)
    out["prefill"] = pre
    del whole32
    free()
    print(f"  (b) long decode {out['long_decode']}; prefill {out['prefill']}", flush=True)

    # (d) the placed engine over NCCL (gloo on the CPU) at a world of one
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="rafi_serve_shard_"))
    try:
        dcomm = LD.init_world(dev, world=1, rank=0, store=f"file://{tmp}/store")
        dparams = PL.serve_placement(model, Layout(*LAYOUT, comm=dcomm)).place(lm)
        engine = BatchedEngine(model, dparams, slots=SLOTS, max_len=MAX_LEN, device=dev)
        rec = _StepRecorder(engine)
        dcomm.reset()
        served = engine.run(requests)
        sync()
        r, want, wrec = engines["placed"][0], engines["placed"][1], engines["placed"][2]
        step_ms = [a.elapsed_time(b) for a, b in rec.events] if cuda else []
        nccl = {"steps": engine.steps, "step_ms_median": statistics.median(step_ms) if step_ms else None,
                "calls_per_step": {k: v / engine.steps for k, v in _call_counts(dcomm).items()}}
        out["nccl_engine"] = nccl
        check(served == want and _same_tensor(rec.last, wrec.last) and nccl["calls_per_step"] == r["calls_per_step"],
              f"(d) the placed engine on {'NCCL' if cuda else 'gloo'} at a world of one == the stacked run: tokens, "
              f"last logits bit for bit, calls {nccl['calls_per_step']}; event median a step "
              f"{nccl['step_ms_median']} ms (stacked {r['step_ms_median']})")
        del dparams, engine, rec
    finally:
        LD.destroy_world()
        shutil.rmtree(tmp, ignore_errors=True)
    del params, lm, whole, engines
    free()

    # (c) float32 at CHECK_LAYERS layers, teacher-forced
    cfg_c = dc.replace(get_config(ARCH), num_layers=CHECK_LAYERS, dtype="float32", **(widths or {}))
    model_c, model_b = build_model(cfg_c), build_model(dc.replace(cfg_c, dtype="bfloat16"))
    lm32 = model_c.init(torch.Generator(device=dev).manual_seed(3237), device=dev)
    p32 = PL.serve_placement(model_c, Layout(*LAYOUT)).place(lm32)
    w16 = _cast_tree(lm32.tree(), torch.bfloat16)
    cpc = PL.cache_placement(model_c, Layout(*LAYOUT), SLOTS, MAX_LEN)
    c16 = _seeded_caches(model_b, SLOTS, MAX_LEN, depths, 3238, dev)
    runs = {"placed": [p32, cpc.place(_cast_tree(c16, torch.float32)), model_c.decode_fn()],
            "whole": [lm32, _cast_tree(c16, torch.float32), model_c.decode_fn()],
            "bf16": [w16, c16, model_b.decode_fn()]}
    gen = np.random.default_rng(3239)
    d_placed = d_bf16 = 0.0
    for _ in range(CHECK_STEPS):
        tok = torch.from_numpy(gen.integers(0, cfg_c.vocab_size, (SLOTS, 1)).astype(np.int32)).to(dev)
        lg = {}
        for name, run in runs.items():
            lg[name], run[1] = run[2](run[0], tok, run[1])
        d_placed = max(d_placed, float((lg["placed"] - lg["whole"]).abs().max()))
        d_bf16 = max(d_bf16, float((lg["bf16"].float() - lg["whole"]).abs().max()))
    pos_p = cpc.gather(runs["placed"][1])["blocks"]
    pos_ok = all(torch.equal(pos_p[k]["pos"], c["pos"]) for k, c in runs["whole"][1]["blocks"].items())
    tm = MAX_LEN // m
    crossed = sorted({p // tm for p in depths} | {min(p + CHECK_STEPS - 1, MAX_LEN - 1) // tm for p in depths})
    out["float32_check"] = {"placed_vs_whole": d_placed, "bf16_vs_f32": d_bf16, "blocks_crossed": crossed}
    check(d_placed <= d_bf16 / FAM_F32_GAIN and pos_ok and crossed == list(range(m)),
          f"(c) {ARCH} at {CHECK_LAYERS} layers in float32, {CHECK_STEPS} teacher-forced steps from depths "
          f"{depths[0]}-{depths[-1]} (model blocks {crossed} of {m}): max |placed - unsharded| {d_placed:.4g} <= "
          f"1/{FAM_F32_GAIN:g} of the bfloat16 model's distance {d_bf16:.4g}; pos equal")
    del runs, lm32, p32, w16, c16
    free()

    # (e)
    launches = KN.launch_counts()
    check(not any(launches.values()), f"(e) serve_shard: no kernel of K1-K10 launched: {launches}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase serve_shard: {out['wall_s']:.1f} s", flush=True)
    return out, {"serve_shard": launches}


MOE_SHARD_TOL_SMOKE = 1e-4  # (d): the float32 smoke configs' placed train step, card against CPU


def _rank_bytes(tree, R):
    """Each of the ``R`` ranks' bytes of a placed tree."""
    return [sum(t[r].numel() * t.element_size() for t in _leaf_items(tree).values()) for r in range(R)]


def _rule_bytes(pl, dtype):
    """A rank's bytes of a placement's leaves in ``dtype`` by the rule
    (``specs.device_bytes``)."""
    import torch

    from repro_torch.launch import specs as S

    return sum(S.device_bytes(torch.empty(pl.shapes[k], dtype=dtype, device="meta"), spec, pl.axes)
               for k, spec in pl.specs.items())


def _calls_and_bytes(comm, steps):
    """The backend's calls a step by kind and tier, and their bytes."""
    calls = {k: v / steps for k, v in _call_counts(comm).items()}
    nbytes = {}
    for c, n in comm.calls.items():
        key = c.kind if c.tier is None else f"{c.kind}{c.tier}"
        nbytes[key] = nbytes.get(key, 0) + c.nbytes * n / steps
    return calls, nbytes


def _decayed(b16, steps, opt_cfg):
    """A bfloat16 leaf after ``steps`` AdamW updates of zero gradient, in
    the update's own float32 operations: weight decay alone at each
    step's learning rate, rounded to bfloat16 after each."""
    import torch

    p = b16
    for t in range(1, steps + 1):
        warm = torch.clamp(torch.tensor(float(t), device=p.device) / max(opt_cfg.warmup_steps, 1), max=1.0)
        lr = warm * opt_cfg.lr
        b32 = p.to(torch.float32)
        p = (b32 - (b32 * opt_cfg.weight_decay) * lr).to(p.dtype)
    return p


def _moe_smoke_card_cpu(dev, arch, batch, seed=33):
    """(d): ``arch``'s float32 smoke config with ``fsdp``, placed on (2, 4)
    under each plane on the card and on the CPU from one CPU draw: one
    placed train step's loss, and the drops of the placed forward on its
    batch, ``{where: {plane: (loss, drops)}}``."""
    import copy
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import placement as PL
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api as API
    from repro_torch.models import transformer as TF
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dc.replace(get_smoke_config(arch), fsdp=True)
    out = {}
    lm_cpu = build_model(cfg).init(torch.Generator().manual_seed(seed), device="cpu")
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, batch).astype(np.int32)
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        res = {}
        for name in ("rafi_ep", "dense_tp"):
            c = dc.replace(cfg, moe_dispatch=name)
            model = build_model(c)
            pl = PL.train_placement(model, Layout(2, 4))
            params = pl.place(copy.deepcopy(lm_cpu).to(d))
            ranks = pl.ranks(d)
            tok = torch.from_numpy(tokens).to(d)
            with torch.no_grad():
                drops = int(TF.forward_placed(pl.unshard(params, ranks), API._group_rows(tok, ranks), c, ranks)[2])
            opt_cfg = AdamWConfig(warmup_steps=2)
            met = build_train_step(model, None, opt_cfg)(params, adamw_init(params, opt_cfg), {"tokens": tokens})[2]
            res[name] = (float(met["loss"]), drops)
        out[where] = res
    return out


def phase_moe_shard(dev, LAYERS=4, TRAIN_LAYERS=1, CHECK_LAYERS=1, SERVE_LAYOUT=(1, 8), TRAIN_LAYOUT=(2, 4),
                    SLOTS=16, MAX_LEN=128, N_REQ=16, PROMPT=(8, 48), NEW=(8, 24), BATCH=(8, 512), TRAIN_STEPS=3,
                    CHECK_STEPS=16, SMOKE_BATCH=(8, 16), widths=None, profile=True, reps=3):
    """The MoE family on placed parameters (``launch.placement``:
    ``rafi_ep``'s experts split over ``model``, E/model a rank; the router
    and the norms whole): llama4-scout-17b-16e at full width in bfloat16
    with its config's ``rafi_ep``, stacked in one process.  (a) Every
    rank's block of every parameter (and of AdamW's moments under the
    train placement) equals bit for bit the chunk of the whole leaf the
    rule names, a rank's bytes ``specs.device_bytes``.  (b) Serving at
    ``LAYERS`` layers (phase lm's model and seed) serve-placed on
    ``SERVE_LAYOUT``, phase lm's layout, where each rank's 2 experts are
    the bytes the unsharded engine reads for it: ``BatchedEngine`` on the
    placed parameters answers phase lm's ``N_REQ`` requests beside the
    unsharded engine on the same weights: event median a step, one step's
    device ms by part (attention, the expert GEMMs, the two rounds, the
    backend's ``psum``/``all_gather`` calls; ``_lm_step_split``), calls a
    step by kind and tier with their bytes (two rounds a layer: four
    ``all_to_all``), K6, K3, K1 and K2 launched two rounds a layer a step
    on the path ``moe_shard``, drops a step, peak GiB.  (c) Training at
    ``TRAIN_LAYERS`` layer(s), ``fsdp``, train-placed on ``TRAIN_LAYOUT``,
    ``BATCH`` in the config's 4 microbatches, ``TRAIN_STEPS`` AdamW steps:
    losses finite, the router, the experts and ``ln2`` (no gradient under
    ``rafi_ep``) updated by weight decay alone, bit for bit, their ``m``
    and ``v`` zero; event median, device ms by part and peak GiB beside
    the unsharded step's on the same weights (freed in turn: the two
    AdamW states do not fit together).  (d) float32: at ``CHECK_LAYERS``
    layer(s), teacher-forced over ``CHECK_STEPS`` steps from seeded
    caches, the placed decode against the unsharded one on
    ``SERVE_LAYOUT``: logits within 1/``FAM_F32_GAIN`` of the bfloat16
    model's distance from the unsharded float32 step's, drops equal each
    step; both smoke configs under both planes placed on (2, 4), the card
    against the CPU from one draw: a placed train step's loss within
    ``MOE_SHARD_TOL_SMOKE`` and the placed forward's drops equal.  (e) The
    queue one placed MoE layer's first round delivers at the decode shape
    equals the same round on the CPU through the plain versions, bit for
    bit.  ``widths`` narrows the configs for a rehearsal on the CPU."""
    import dataclasses as dc
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import placement as PL
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.serve import BatchedEngine
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import moe as M
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    full = get_config(LM_ARCH)
    out, paths = {}, {}

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def peak_reset():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None

    free()
    # (a), (b) serving: phase lm's model, serve-placed on SERVE_LAYOUT
    cfg = dc.replace(full, num_layers=LAYERS, **(widths or {}))
    model = build_model(cfg)
    label = f"{cfg.name} at {LAYERS} of {full.num_layers} layers, {cfg.moe_dispatch}"
    lm = model.init(torch.Generator(device=dev).manual_seed(2323), device=dev)
    sp = PL.serve_placement(model, Layout(*SERVE_LAYOUT))
    params = sp.place(lm)
    bad = _blocks_match(params, lm.tree(), sp)
    rule, R = _rule_bytes(sp, cfg.torch_dtype), SERVE_LAYOUT[0] * SERVE_LAYOUT[1]
    sizes = _rank_bytes(params, R)
    wi = sp.specs[("blocks", "k0_moe", "moe", "wi")]
    serve = {"layout": SERVE_LAYOUT, "param_bytes_per_rank": sizes,
             "param_bytes_whole": sum(t.numel() * t.element_size() for t in lm.parameters()),
             "experts_per_rank": cfg.num_experts // SERVE_LAYOUT[1], "wi_spec": wi}
    check(not bad and set(sizes) == {rule} and wi[1] == S.MODEL,
          f"(a) {label}, serve placement on {SERVE_LAYOUT}: every rank's block of the {len(sp.specs)} parameter "
          f"leaves == the chunk the rule names, bit for bit (mismatched: {bad}), the experts over model {wi}; "
          f"{sizes[0]} B a rank == specs.device_bytes {rule} (whole {serve['param_bytes_whole']} B)")

    requests = _lm_requests(cfg.vocab_size, N_REQ, PROMPT, NEW)
    first = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    engines = {}
    for name, p, lay in (("placed", params, None), ("whole", lm, Layout(*SERVE_LAYOUT))):
        engine = BatchedEngine(model, p, slots=SLOTS, max_len=MAX_LEN, layout=lay, device=dev)
        rec = _StepRecorder(engine)
        caches0 = (engine.cache_placement.zeros(dev) if name == "placed"
                   else model.init_caches(SLOTS, MAX_LEN, device=dev))
        engine._step(p, first, caches0)  # warm-up: first-use costs
        sp.comm.reset()
        KN.reset_launch_counts()
        peak_reset()
        sync()
        t0 = time.perf_counter()
        served = engine.run(requests)
        sync()
        wall = time.perf_counter() - t0
        launches = KN.launch_counts()
        step_ms = [a.elapsed_time(b) for a, b in rec.events] if cuda else []
        drops = [int(d) for d in engine.step_drops]
        r = {"steps": engine.steps, "tokens": sum(map(len, served.values())), "wall_s": wall,
             "step_ms_median": statistics.median(step_ms) if step_ms else None, "drops_per_step": drops,
             "drops_total": sum(drops), "peak_gib": peak()}
        check(all(len(served[q.rid]) == q.max_new_tokens for q in requests),
              f"(b) the {name} engine answers all {N_REQ} requests with their max_new_tokens ({r['tokens']} tokens "
              f"in {r['steps']} steps)")
        if name == "placed":
            paths["moe_shard"] = launches
            r["calls_per_step"], r["call_bytes_per_step"] = _calls_and_bytes(sp.comm, engine.steps)
            check(r["calls_per_step"].get("all_to_all") == 4 * LAYERS,
                  f"(b) the placed step's rounds: {r['calls_per_step'].get('all_to_all')} all_to_all a step == two "
                  f"rounds of a payload and a count call a layer ({4 * LAYERS}); calls {r['calls_per_step']}")
            if cuda:
                r["launches_per_step"] = {k: launches[k] / engine.steps for k in LM_KERNELS}
                check(all(launches[k] == 2 * LAYERS * engine.steps for k in LM_KERNELS)
                      and not any(v for k, v in launches.items() if k not in LM_KERNELS),
                      f"(b) path moe_shard: K6, K3, K1, K2 launched two rounds a layer a step "
                      f"({2 * LAYERS} a step, {engine.steps} steps), no other kernel: {launches}")
        if cuda:
            c = engine.cache_placement.zeros(dev) if name == "placed" else model.init_caches(SLOTS, MAX_LEN,
                                                                                               device=dev)
            r["peak_gib_above_held"] = _peak_above_held(lambda: engine._step(p, rec.tokens[-1], c), dev)
            if profile:
                r["split"] = _lm_step_split(engine._step, p, rec.tokens[-1], c,
                                            comm=sp.comm if name == "placed" else None)
            del c
        engines[name] = (r, served, rec)
        serve[f"{name}_engine"] = r
    del engine, p, rec, caches0  # the loop's last engine holds the whole tree
    agree = sum(a == b for q in requests for a, b in zip(engines["placed"][1][q.rid], engines["whole"][1][q.rid]))
    serve["engine_tokens_agree"] = (agree, sum(q.max_new_tokens for q in requests))
    print(f"  (b) engines: placed {serve['placed_engine']}, whole {serve['whole_engine']}; tokens equal "
          f"{agree} of {serve['engine_tokens_agree'][1]} (bfloat16)", flush=True)

    # (e) the first round of one placed MoE layer at the decode shape, card against CPU
    with _FirstRoute() as fr:
        model.decode_fn()(params, engines["placed"][2].tokens[0],
                          PL.cache_placement(model, Layout(*SERVE_LAYOUT), SLOTS, MAX_LEN).zeros(dev))
    route = fr.route
    W = route.items.h.shape[-1] * route.items.h.element_size() // 4 + 4
    check(route.ranked and _same_delivered(M.rafi_ep_dispatch(route), M.rafi_ep_dispatch(route.to("cpu"))),
          f"(e) the placed decode's first dispatch round (R={route.fcfg.num_ranks}, C={route.fcfg.capacity}, "
          f"S={route.fcfg.peer_capacity}, W={W} words, rank-stacked rows): the delivered queue == the CPU's, bit "
          f"for bit")
    out["serve"] = serve
    del params, lm, engines, route, fr
    free()

    # (a), (c) training: TRAIN_LAYERS layer(s), fsdp, train-placed on TRAIN_LAYOUT
    opt_cfg = AdamWConfig(warmup_steps=20)
    cfg_t = dc.replace(full, num_layers=TRAIN_LAYERS, **(widths or {}))
    model_t = build_model(cfg_t)
    b, s = BATCH
    batch = SyntheticLM(cfg_t.vocab_size, s, b).batch_at(0)
    step = build_train_step(model_t, None, opt_cfg)
    pl = PL.train_placement(model_t, Layout(*TRAIN_LAYOUT))
    lm = model_t.init(torch.Generator(device=dev).manual_seed(2424), device=dev)
    params = pl.place(lm)
    bad = _blocks_match(params, lm.tree(), pl)
    rule, R = _rule_bytes(pl, cfg_t.torch_dtype), TRAIN_LAYOUT[0] * TRAIN_LAYOUT[1]
    sizes = _rank_bytes(params, R)
    wi = pl.specs[("blocks", "k0_moe", "moe", "wi")]
    label_t = f"{cfg_t.name} at {TRAIN_LAYERS} of {full.num_layers} layers, fsdp, {TRAIN_LAYOUT}"
    train = {"layout": TRAIN_LAYOUT, "batch": BATCH, "microbatches": cfg_t.microbatches, "wi_spec": wi,
             "param_bytes_per_rank": sizes}
    check(not bad and set(sizes) == {rule},
          f"(a) {label_t}: every rank's block of the {len(pl.specs)} parameter leaves == the chunk the train rule "
          f"names, bit for bit (mismatched: {bad}); the experts {wi}; {sizes[0]} B a rank == specs.device_bytes "
          f"{rule}")
    del lm
    free()
    dead = [p for p in pl.paths if p[-2:-1] == ("moe",) or p[-1] == "ln2"]
    sample = lambda t: t.reshape(t.shape[0], -1)[:, :4096].clone()
    before = {p: sample(_tree_paths(params)[".".join(p)]) for p in dead}
    opt = adamw_init(params, opt_cfg)
    pl.comm.reset()
    peak_reset()
    ev, losses, gnorms = [], [], []
    for _ in range(TRAIN_STEPS):
        if cuda:
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
        met = step(params, opt, batch)[2]
        if cuda:
            e[1].record()
            ev.append(e)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["gnorm"]))
    train["calls_per_step"], train["call_bytes_per_step"] = _calls_and_bytes(pl.comm, TRAIN_STEPS)
    ms = [a.elapsed_time(z) for a, z in ev] if cuda else []
    placed_t = {"losses": losses, "gnorms": gnorms, "peak_gib": peak(),
                "step_ms": ms, "step_ms_median": statistics.median(ms[1:]) if len(ms) > 1 else None}
    check(all(map(math.isfinite, losses + gnorms)),
          f"(c) {label_t}, batch {b} x {s}, {cfg_t.microbatches} microbatches: {TRAIN_STEPS} placed steps, losses "
          f"{[round(l, 4) for l in losses]} and gnorms {[round(g, 4) for g in gnorms]} finite")
    now = _tree_paths(params)
    m_, v_ = _tree_paths(opt["m"]), _tree_paths(opt["v"])
    ulps = max(int((sample(now[".".join(p)]).view(torch.int16).to(torch.int32)
                    - _decayed(before[p], TRAIN_STEPS, opt_cfg).view(torch.int16).to(torch.int32)).abs().max())
               for p in dead)
    zero = not any(bool(m_[".".join(p)].any()) or bool(v_[".".join(p)].any()) for p in dead)
    placed_t["decay_only_max_ulp"] = ulps
    check(len(dead) == 5 and ulps == 0 and zero,
          f"(c) {label_t}: {', '.join(p[-1] for p in dead)} (no gradient under rafi_ep) updated by weight decay "
          f"alone, bit for bit on {4096} sampled elements a rank (max {ulps} ulp), m and v zero: {zero}")
    bad = [f"{k}.{p}" for k in ("m", "v") for p in _blocks_match(opt[k], pl.gather(opt[k]), pl)]
    check(not bad, f"(a) {label_t}: every rank's block of AdamW's m and v == the chunk of the gathered leaf, bit for "
                   f"bit (mismatched: {bad})")
    if cuda and profile:
        placed_t["device_split_ms"] = _step_device_ms(step, params, opt, batch)
        placed_t["top_events"] = _top_events(lambda: step(params, opt, batch), n=16)
    train["placed"] = placed_t
    del params, opt, before, now, m_, v_
    free()
    # the unsharded step on the same weights (the rafi_ep plane on the same layout)
    lm = model_t.init(torch.Generator(device=dev).manual_seed(2424), device=dev)
    wstep = build_train_step(model_t, Layout(*TRAIN_LAYOUT), opt_cfg)
    opt = adamw_init(lm, opt_cfg)
    peak_reset()
    ev, losses = [], []
    for _ in range(TRAIN_STEPS):
        if cuda:
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
        met = wstep(lm, opt, batch)[2]
        if cuda:
            e[1].record()
            ev.append(e)
        losses.append(float(met["loss"]))
    ms = [a.elapsed_time(z) for a, z in ev] if cuda else []
    whole_t = {"losses": losses, "peak_gib": peak(), "step_ms": ms,
               "step_ms_median": statistics.median(ms[1:]) if len(ms) > 1 else None}
    if cuda and profile:
        whole_t["device_split_ms"] = _step_device_ms(wstep, lm, opt, batch)
        whole_t["top_events"] = _top_events(lambda: wstep(lm, opt, batch), n=16)
    train["whole"] = whole_t
    out["train"] = train
    print(f"  (c) train: placed {placed_t}; whole {whole_t}", flush=True)
    del lm, opt
    free()

    # (d) float32 at CHECK_LAYERS layer(s): the placed decode against the unsharded one, teacher-forced
    cfg_c = dc.replace(full, num_layers=CHECK_LAYERS, dtype="float32", **(widths or {}))
    model_c, model_b = build_model(cfg_c), build_model(dc.replace(cfg_c, dtype="bfloat16"))
    lm32 = model_c.init(torch.Generator(device=dev).manual_seed(2525), device=dev)
    lay = Layout(*SERVE_LAYOUT)
    p32 = PL.serve_placement(model_c, lay).place(lm32)
    w16 = _cast_tree(lm32.tree(), torch.bfloat16)
    cpc = PL.cache_placement(model_c, lay, SLOTS, MAX_LEN)
    depths = [(q * (MAX_LEN - CHECK_STEPS)) // SLOTS for q in range(SLOTS)]
    c16 = _seeded_caches(model_b, SLOTS, MAX_LEN, depths, 2526, dev)
    runs = {"placed": [p32, cpc.place(_cast_tree(c16, torch.float32)), model_c.decode_fn(drops=True)],
            "whole": [lm32, _cast_tree(c16, torch.float32), model_c.decode_fn(lay, drops=True)],
            "bf16": [w16, c16, model_b.decode_fn(lay, drops=True)]}
    gen = np.random.default_rng(2527)
    d_placed = d_bf16 = 0.0
    drops = {k: [] for k in runs}
    for _ in range(CHECK_STEPS):
        tok = torch.from_numpy(gen.integers(0, cfg_c.vocab_size, (SLOTS, 1)).astype(np.int32)).to(dev)
        lg = {}
        for name, run in runs.items():
            lg[name], run[1], dd = run[2](run[0], tok, run[1])
            drops[name].append(int(dd))
        d_placed = max(d_placed, float((lg["placed"] - lg["whole"]).abs().max()))
        d_bf16 = max(d_bf16, float((lg["bf16"].float() - lg["whole"]).abs().max()))
    out["float32_check"] = {"placed_vs_whole": d_placed, "bf16_vs_f32": d_bf16, "drops": drops}
    check(d_placed <= d_bf16 / FAM_F32_GAIN and drops["placed"] == drops["whole"],
          f"(d) {cfg_c.name} at {CHECK_LAYERS} layer(s) in float32 on {SERVE_LAYOUT}, {CHECK_STEPS} teacher-forced "
          f"steps: max |placed - unsharded| {d_placed:.4g} <= 1/{FAM_F32_GAIN:g} of the bfloat16 model's distance "
          f"{d_bf16:.4g}; drops a step equal {drops['placed']} == {drops['whole']}")
    del runs, lm32, p32, w16, c16
    free()
    smoke = {a: _moe_smoke_card_cpu(dev, a, SMOKE_BATCH) for a in (LM_ARCH, "dbrx-132b")}
    out["smoke"] = smoke
    for a, r in smoke.items():
        for plane in ("rafi_ep", "dense_tp"):
            (lc, dc_), (lp, dp) = r["card"][plane], r["cpu"][plane]
            check(abs(lc - lp) <= MOE_SHARD_TOL_SMOKE and dc_ == dp,
                  f"(d) the {a} smoke config under {plane}, placed on (2, 4), one train step: the card's loss "
                  f"{lc:.6f} within {MOE_SHARD_TOL_SMOKE} of the CPU's {lp:.6f}, drops {dc_} == {dp}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase moe_shard: {out['phase_s']:.1f} s", flush=True)
    return out, paths


# ------------------------------------------------------ 24. recurrent_shard
# (arch, layers of CONFIG kept, layers of the float32 check (d)): rwkv6-3b at
# one layer; recurrentgemma-2b at one period, so that (d) holds its local
# attention layer too
RECURRENT_SHARD_ARCHS = (("rwkv6-3b", 4, 1), ("recurrentgemma-2b", 3, 3))
RECURRENT_SHARD_TOL_SMOKE = 1e-4  # (d): the float32 smoke configs' placed train step, card against CPU


def _recurrent_decode_calls(cfg):
    """The pinned calls of one placed decode step (``tests/
    test_torch_recurrent_shard.py``'s budget): over ``model`` an rwkv layer
    two ``psum``s, a recurrent layer ξ's ``all_gather`` and two ``psum``s,
    a local attention layer three ``all_gather``s and three ``psum``s; the
    embedding's ``psum`` and the logits' ``all_gather`` over ``model``,
    the logits' rows' over ``data``."""
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.num_layers)]
    gathers = sum({"recurrent": 1, "local": 3, "global": 3}.get(k, 0) for k in kinds)
    psums = sum({"rwkv": 2, "recurrent": 2, "local": 3, "global": 3}[k] for k in kinds)
    return {"all_gather1": gathers + 1, "psum1": psums + 1, "all_gather0": 1}


def _placed_smoke_card_cpu(dev, cfg, batch, seed):
    """A float32 smoke config placed on (2, 4) on the card and on the CPU
    from one CPU draw: one placed train step's loss on ``batch`` (host
    arrays or CPU tensors), ``{where: loss}``."""
    import copy

    import torch

    from repro_torch.launch import placement as PL
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    model = build_model(cfg)
    lm_cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        pl = PL.train_placement(model, Layout(2, 4))
        params = pl.place(copy.deepcopy(lm_cpu).to(d))
        opt_cfg = AdamWConfig(warmup_steps=2)
        out[where] = float(build_train_step(model, None, opt_cfg)(params, adamw_init(params, opt_cfg), batch)[2]["loss"])
    return out


def phase_recurrent_shard(dev, ARCHS=RECURRENT_SHARD_ARCHS, LAYOUT=(2, 4), SLOTS=16, MAX_LEN=128, N_REQ=16,
                          PROMPT=(8, 48), NEW=(8, 24), BATCH=(8, 512), MICRO=2, TRAIN_STEPS=3, CHECK_STEPS=16,
                          PREFILL=(2, 64), SMOKE_BATCH=(8, 16), widths=None, profile=True):
    """The recurrent families on placed parameters (``launch.placement``
    for ``kind`` "ssm" and "hybrid"): rwkv6-3b (its heads over ``model``)
    and recurrentgemma-2b (its RG-LRU's d_rnn channels over ``model``,
    its local attention as the dense family's) at full width in bfloat16,
    cut in depth (``ARCHS``), on ``LAYOUT`` stacked in one process.  For
    each: (a) every rank's block of every parameter (serve and train
    placements, and AdamW's moments) and of seeded decode caches equals
    bit for bit the chunk of the whole leaf the rule names, a rank's bytes
    ``specs.device_bytes``.  (b) ``BatchedEngine`` on the serve-placed
    parameters answers phase lm's ``N_REQ`` requests at ``SLOTS`` slots,
    ``MAX_LEN``, beside the unsharded engine on the same weights: event
    median a step, one step's device ms by part (``_family_split``),
    calls a step by kind and tier (the pinned budget,
    ``_recurrent_decode_calls``) with their bytes, peak GiB.  (c)
    ``fsdp``, ``BATCH`` in ``MICRO`` microbatches, ``TRAIN_STEPS`` AdamW
    steps train-placed: losses finite, event median, device ms by part and
    peak GiB beside the unsharded step's on the same weights.  (d)
    float32 at the check depth: the placed decode against the unsharded
    one, teacher-forced over ``CHECK_STEPS`` steps from seeded caches, and
    a ``PREFILL`` placed prefill against the unsharded one, each within
    1/``FAM_F32_GAIN`` of the bfloat16 model's distance from the unsharded
    float32 logits; the smoke config placed on (2, 4), the card against
    the CPU from one draw: a placed train step's loss within
    ``RECURRENT_SHARD_TOL_SMOKE``.  (e) None of the ten kernels is
    launched on the path ``recurrent_shard``.  ``widths`` (``{arch:
    {field: value}}``) narrows the configs for a rehearsal on the CPU."""
    import dataclasses as dc
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import placement as PL
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.serve import BatchedEngine
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out, launched = {}, {}
    R = LAYOUT[0] * LAYOUT[1]

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def peak_reset():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None

    def count_launches():
        for k, v in KN.launch_counts().items():
            launched[k] = launched.get(k, 0) + v

    def timed_steps(step, params, opt, batch):
        ev, losses, gnorms = [], [], []
        for _ in range(TRAIN_STEPS):
            if cuda:
                e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                e[0].record()
            met = step(params, opt, batch)[2]
            if cuda:
                e[1].record()
                ev.append(e)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["gnorm"]))
        ms = [a.elapsed_time(z) for a, z in ev] if cuda else []
        return {"losses": losses, "gnorms": gnorms, "step_ms": ms,
                "step_ms_median": statistics.median(ms[1:]) if len(ms) > 1 else None}

    free()
    for arch, layers, check_layers in ARCHS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        narrow = (widths or {}).get(arch, {})
        cfg = dc.replace(full, num_layers=layers, **narrow)
        model = build_model(cfg)
        label = f"{cfg.name} at {layers} of {full.num_layers} layers on {LAYOUT}"
        rec = out[arch] = {}
        lm = model.init(torch.Generator(device=dev).manual_seed(2626), device=dev)
        whole_bytes = sum(t.numel() * t.element_size() for t in lm.parameters())

        # (a) the serve placement and the caches
        sp = PL.serve_placement(model, Layout(*LAYOUT))
        params = sp.place(lm)
        bad = _blocks_match(params, lm.tree(), sp)
        rule, sizes = _rule_bytes(sp, cfg.torch_dtype), _rank_bytes(params, R)
        key = ("blocks", "k0_rwkv", "rwkv", "u") if cfg.kind == "ssm" else ("blocks", "k0_recurrent", "rglru", "wr")
        want_spec = (None, S.MODEL, None) if cfg.kind == "ssm" else (None, None, S.MODEL)
        serve = {"param_bytes_per_rank": sizes, "param_bytes_whole": whole_bytes,
                 "split_spec": {".".join(key): sp.specs[key]}}
        check(not bad and set(sizes) == {rule} and sp.specs[key] == want_spec,
              f"(a) {label}, serve placement: every rank's block of the {len(sp.specs)} parameter leaves == the "
              f"chunk the rule names, bit for bit (mismatched: {bad}); {'.'.join(key)} {sp.specs[key]}; "
              f"{sizes[0]} B a rank == specs.device_bytes {rule} (whole {whole_bytes} B)")
        cp = PL.cache_placement(model, Layout(*LAYOUT), SLOTS, MAX_LEN)
        depths = [(q * (MAX_LEN - 1)) // SLOTS for q in range(SLOTS)]
        seeded = _seeded_caches(model, SLOTS, MAX_LEN, depths, 2627, dev)
        pc = cp.place(seeded)
        bad = _blocks_match(pc, seeded, cp)
        csizes, crule = _rank_bytes(pc, R), sum(S.device_bytes(torch.empty(cp.shapes[k], dtype=cp.dtypes[k],
                                                                           device="meta"), spec, cp.axes)
                                                for k, spec in cp.specs.items())
        states = {".".join(k): v for k, v in cp.specs.items() if k[-1] in ("h", "conv") or k[1].endswith("rwkv")}
        serve["cache_bytes_per_rank"], serve["state_specs"] = csizes, states
        check(not bad and set(csizes) == {crule} and all(S.MODEL in s and S.DATA in s for s in states.values()),
              f"(a) {label}: every rank's block of the {len(cp.specs)} cache leaves ({SLOTS} slots, max_len "
              f"{MAX_LEN}) == the chunk the rule names, bit for bit (mismatched: {bad}); the states {states}; "
              f"{csizes[0]} B a rank == specs.device_bytes {crule}")
        del pc, seeded

        # (b) the engines, placed and whole, on the same weights
        requests = _lm_requests(cfg.vocab_size, N_REQ, PROMPT, NEW)
        first = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
        engines = {}
        for name, p in (("placed", params), ("whole", lm)):
            engine = BatchedEngine(model, p, slots=SLOTS, max_len=MAX_LEN, device=dev)
            srec = _StepRecorder(engine)
            zeros = lambda: (cp.zeros(dev) if name == "placed" else model.init_caches(SLOTS, MAX_LEN, device=dev))
            engine._step(p, first, zeros())  # warm-up: first-use costs
            sp.comm.reset()
            KN.reset_launch_counts()
            peak_reset()
            sync()
            t0 = time.perf_counter()
            served = engine.run(requests)
            sync()
            wall = time.perf_counter() - t0
            if name == "placed":
                count_launches()
            step_ms = [a.elapsed_time(b) for a, b in srec.events] if cuda else []
            r = {"steps": engine.steps, "tokens": sum(map(len, served.values())), "wall_s": wall,
                 "step_ms_median": statistics.median(step_ms) if step_ms else None, "peak_gib": peak()}
            check(all(len(served[q.rid]) == q.max_new_tokens for q in requests),
                  f"(b) {label}: the {name} engine answers all {N_REQ} requests with their max_new_tokens "
                  f"({r['tokens']} tokens in {r['steps']} steps)")
            if name == "placed":
                r["calls_per_step"], r["call_bytes_per_step"] = _calls_and_bytes(sp.comm, engine.steps)
                want = _recurrent_decode_calls(cfg)
                check(r["calls_per_step"] == want,
                      f"(b) {label}: the placed decode step's calls {r['calls_per_step']} == the pinned budget {want}; "
                      f"bytes a step {r['call_bytes_per_step']}")
            if cuda:
                c = zeros()
                r["peak_gib_above_held"] = _peak_above_held(lambda: engine._step(p, srec.tokens[-1], c), dev)
                if profile:
                    r["split"] = _family_split(lambda: engine._step(p, srec.tokens[-1], c),
                                               comm=sp.comm if name == "placed" else None, calls=3)
                del c
            engines[name] = (r, served)
            serve[f"{name}_engine"] = r
        del engine, p, srec
        agree = sum(a == b for q in requests for a, b in zip(engines["placed"][1][q.rid], engines["whole"][1][q.rid]))
        serve["engine_tokens_agree"] = (agree, sum(q.max_new_tokens for q in requests))
        pe, we = serve["placed_engine"], serve["whole_engine"]
        if pe["step_ms_median"] and we["step_ms_median"]:
            serve["placed_over_whole_step"] = pe["step_ms_median"] / we["step_ms_median"]
        print(f"  (b) {label}: placed {pe}; whole {we}; tokens equal {agree} of {serve['engine_tokens_agree'][1]} "
              f"(bfloat16)", flush=True)
        rec["serve"] = serve
        del params, engines
        free()

        # (a), (c) training: fsdp, MICRO microbatches, train-placed on LAYOUT
        opt_cfg = AdamWConfig(warmup_steps=20)
        cfg_t = dc.replace(cfg, fsdp=True, microbatches=MICRO)
        model_t = build_model(cfg_t)
        b, s = BATCH
        batch = SyntheticLM(cfg_t.vocab_size, s, b).batch_at(0)
        pl = PL.train_placement(model_t, Layout(*LAYOUT))
        params = pl.place(lm)
        bad = _blocks_match(params, lm.tree(), pl)
        rule, sizes = _rule_bytes(pl, cfg_t.torch_dtype), _rank_bytes(params, R)
        train = {"batch": BATCH, "microbatches": MICRO, "param_bytes_per_rank": sizes}
        check(not bad and set(sizes) == {rule},
              f"(a) {label}, fsdp train placement: every rank's block of the {len(pl.specs)} parameter leaves == the "
              f"chunk the rule names, bit for bit (mismatched: {bad}); {sizes[0]} B a rank == specs.device_bytes "
              f"{rule}")
        step = build_train_step(model_t, None, opt_cfg)
        opt = adamw_init(params, opt_cfg)
        pl.comm.reset()
        KN.reset_launch_counts()
        peak_reset()
        placed_t = timed_steps(step, params, opt, batch)
        count_launches()
        placed_t["peak_gib"] = peak()
        train["calls_per_step"], train["call_bytes_per_step"] = _calls_and_bytes(pl.comm, TRAIN_STEPS)
        check(all(map(math.isfinite, placed_t["losses"] + placed_t["gnorms"])),
              f"(c) {label}, fsdp, batch {b} x {s} in {MICRO} microbatches: {TRAIN_STEPS} placed steps, losses "
              f"{[round(l, 4) for l in placed_t['losses']]} and gnorms {[round(g, 4) for g in placed_t['gnorms']]} "
              f"finite")
        bad = [f"{k}.{p}" for k in ("m", "v") for p in _blocks_match(opt[k], pl.gather(opt[k]), pl)]
        check(not bad, f"(a) {label}: every rank's block of AdamW's m and v == the chunk of the gathered leaf, bit "
                       f"for bit (mismatched: {bad})")
        if cuda and profile:
            placed_t["split"] = _family_split(lambda: step(params, opt, batch), comm=pl.comm, warmup=False)
        train["placed"] = placed_t
        del params, opt
        free()
        wstep = build_train_step(model_t, None, opt_cfg)
        opt = adamw_init(lm, opt_cfg)
        peak_reset()
        whole_t = timed_steps(wstep, lm, opt, batch)
        whole_t["peak_gib"] = peak()
        if cuda and profile:
            whole_t["split"] = _family_split(lambda: wstep(lm, opt, batch), warmup=False)
        train["whole"] = whole_t
        if placed_t["step_ms_median"] and whole_t["step_ms_median"]:
            train["placed_over_whole_step"] = placed_t["step_ms_median"] / whole_t["step_ms_median"]
        rec["train"] = train
        print(f"  (c) {label}: placed {placed_t}; whole {whole_t}", flush=True)
        del lm, opt
        free()

        # (d) float32 at check_layers: the placed decode and prefill against the unsharded ones
        cfg_c = dc.replace(full, num_layers=check_layers, dtype="float32", **narrow)
        model_c, model_b = build_model(cfg_c), build_model(dc.replace(cfg_c, dtype="bfloat16"))
        lay = Layout(*LAYOUT)
        lm32 = model_c.init(torch.Generator(device=dev).manual_seed(2628), device=dev)
        p32 = PL.serve_placement(model_c, lay).place(lm32)
        w16 = _cast_tree(lm32.tree(), torch.bfloat16)
        cpc = PL.cache_placement(model_c, lay, SLOTS, MAX_LEN)
        depths = [(q * (MAX_LEN - CHECK_STEPS)) // SLOTS for q in range(SLOTS)]
        c16 = _seeded_caches(model_b, SLOTS, MAX_LEN, depths, 2629, dev)
        runs = {"placed": [p32, cpc.place(_cast_tree(c16, torch.float32)), model_c.decode_fn()],
                "whole": [lm32, _cast_tree(c16, torch.float32), model_c.decode_fn()],
                "bf16": [w16, c16, model_b.decode_fn()]}
        gen = np.random.default_rng(2630)
        d_placed = d_bf16 = 0.0
        for _ in range(CHECK_STEPS):
            tok = torch.from_numpy(gen.integers(0, cfg_c.vocab_size, (SLOTS, 1)).astype(np.int32)).to(dev)
            lg = {}
            for name, run in runs.items():
                lg[name], run[1] = run[2](run[0], tok, run[1])
            d_placed = max(d_placed, float((lg["placed"] - lg["whole"]).abs().max()))
            d_bf16 = max(d_bf16, float((lg["bf16"].float() - lg["whole"]).abs().max()))
        pairs = [(a, b) for (k, a), b in zip(_leaf_items(cpc.gather(runs["placed"][1])).items(),
                                             _leaf_items(runs["whole"][1]).values()) if k[-1] != "pos"]
        state_gap = max(float((a - b).abs().max()) for a, b in pairs)
        state_scale = max(float(b.abs().max()) for _, b in pairs)
        tokens = torch.from_numpy(gen.integers(0, cfg_c.vocab_size, PREFILL).astype(np.int32)).to(dev)
        pf = {name: m.prefill_fn()(p, {"tokens": tokens}).float()
              for name, m, p in (("placed", model_c, p32), ("whole", model_c, lm32), ("bf16", model_b, w16))}
        p_placed, p_bf16 = float((pf["placed"] - pf["whole"]).abs().max()), float((pf["bf16"] - pf["whole"]).abs().max())
        rec["float32_check"] = {"layers": check_layers, "decode_placed_vs_whole": d_placed, "decode_bf16_vs_f32": d_bf16,
                                "state_gap": state_gap, "state_scale": state_scale, "prefill_placed_vs_whole": p_placed,
                                "prefill_bf16_vs_f32": p_bf16}
        check(d_placed <= d_bf16 / FAM_F32_GAIN and p_placed <= p_bf16 / FAM_F32_GAIN,
              f"(d) {cfg_c.name} at {check_layers} layer(s) in float32 on {LAYOUT}: {CHECK_STEPS} teacher-forced decode "
              f"steps max |placed - unsharded| {d_placed:.4g} <= 1/{FAM_F32_GAIN:g} of the bfloat16 model's distance "
              f"{d_bf16:.4g}; a {PREFILL} prefill {p_placed:.4g} <= 1/{FAM_F32_GAIN:g} of {p_bf16:.4g}; the caches "
              f"{state_gap:.4g} apart (largest |value| {state_scale:.4g})")
        del runs, lm32, p32, w16, c16, pf, pairs
        free()
        smoke_cfg = dc.replace(get_smoke_config(arch), fsdp=True)
        tokens = np.random.default_rng(34).integers(0, smoke_cfg.vocab_size, SMOKE_BATCH).astype(np.int32)
        smoke = _placed_smoke_card_cpu(dev, smoke_cfg, {"tokens": tokens}, 34)
        rec["smoke"] = smoke
        check(abs(smoke["card"] - smoke["cpu"]) <= RECURRENT_SHARD_TOL_SMOKE,
              f"(d) the {arch} smoke config, fsdp, placed on (2, 4), one train step: the card's loss "
              f"{smoke['card']:.6f} within {RECURRENT_SHARD_TOL_SMOKE} of the CPU's {smoke['cpu']:.6f}")
        rec["s"] = time.perf_counter() - t_arch
    check(not any(launched.values()),
          f"(e) path recurrent_shard: none of the ten kernels launched on the placed engines and steps ({launched})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase recurrent_shard: {out['phase_s']:.1f} s", flush=True)
    return out, {"recurrent_shard": launched}


# ------------------------------------------------------ 25. frontend_shard
FRONTEND_SHARD_TOL_SMOKE = 1e-4  # (e): the float32 smoke configs' placed train step, card against CPU
VL_ARCH, SM_ARCH = "qwen2-vl-72b", "seamless-m4t-medium"
SM_TP = SM_ARCH + " split over model"  # (g): the full config without dp_over_model
SM_TP_LAYOUT = (4, 2)  # (g)'s serving layout: the vocabulary 256,206 = 2 × 128,103 takes a model of 1 or 2
ARGMAX_K = 2  # (g): a row's argmax is held where its top-2 margin exceeds this many times the largest logit gap
ARGMAX_HELD = 0.75  # (g): the least share of the rows that must clear that margin


def _dense_decode_calls(layers):
    """The pinned calls of one placed dense decode step (``tests/
    test_torch_frontend_shard.py``'s budget): over ``model`` a layer's q,
    (k, v) and maxima ``all_gather``s and three ``psum``s, the embedding's
    ``psum`` and the logits' vocabulary ``all_gather``; over ``data`` the
    logits' rows."""
    return {"all_gather1": 3 * layers + 1, "psum1": 3 * layers + 1, "all_gather0": 1}


def _encdec_decode_calls(layers):
    """The pinned calls of one placed encoder-decoder decode step under
    ``dp_over_model``: over ``model`` a decoder layer's gather of q, k and v
    on the rows, the maxima's and one ``psum``, and the logits' rows; over
    ``data`` the logits' rows."""
    return {"all_gather1": 2 * layers + 1, "psum1": layers, "all_gather0": 1}


def _encdec_tp_decode_calls(layers):
    """The pinned calls of one placed encoder-decoder decode step split over
    ``model`` (``tests/test_torch_encdec_shard.py``'s budget): a decoder
    layer's cached self-attention as the dense family's (q, (k, v) and the
    maxima ``all_gather``s, the partials' and ``wo``'s ``psum``s), the
    cross-attention's and the MLP's ``psum``s; the embedding's ``psum`` and
    the logits' vocabulary ``all_gather`` over ``model``, their rows' over
    ``data``."""
    return {"all_gather1": 3 * layers + 1, "psum1": 4 * layers + 1, "all_gather0": 1}


def _encdec_tp_train_calls(cfg, leaves):
    """The pinned calls of one placed encoder-decoder train step split over
    ``model``, one microbatch, no FSDP, of ``leaves`` leaves (``tests/
    test_torch_encdec_shard.py``'s budget): over ``model`` 4 ``psum``s an
    encoder layer and 6 a decoder layer (each row-parallel product's sum
    forward, each column-parallel input's backward), 4 once (the
    embedding's, the loss's sums', the memory's and the head input's
    backward), and with ``remat`` the sums each layer's recompute issues
    again before the checkpoint stops it (the attention ``wo``'s: one an
    encoder layer, two a decoder layer; the MLP's output is saved by no
    backward); the loss's maxima ``all_gather``; over ``data`` each leaf's
    gradient ``psum`` and the loss's; the norm's flat ``psum``."""
    e, n = cfg.encoder_layers, cfg.num_layers
    again = e + 2 * n if cfg.remat else 0
    return {"psum1": 4 * e + 6 * n + 4 + again, "all_gather1": 1, "psum0": leaves + 1, "psum": 1}


def _frontend_batch(cfg, b, s, dev, seed):
    """A train batch on the card from ``seed``: qwen2-vl's ``tokens``,
    ``embeds`` and ``labels`` (b, s), seamless's ``frames`` and ``tokens``
    (b, s) as ``input_specs`` lays them out."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = lambda n: torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device=dev, dtype=torch.int32)
    if cfg.kind == "encdec":
        return {"frames": torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(cfg.torch_dtype),
                "tokens": tok(s)}
    return {"tokens": tok(s), "embeds": torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(cfg.torch_dtype),
            "labels": tok(s - 1)}


def phase_frontend_shard(dev, LAYOUT=(2, 4), SM_TRAIN_LAYOUT=(2, 2), VL_LAYERS=(2, 1, 1), SM_LAYERS=(None, 1), SLOTS=16,
                         MAX_LEN=128, N_REQ=16, PROMPT=(8, 48), NEW=(8, 24), VL_PREFILL=(2, 64), FRAMES=(4, 512, 64),
                         GREEDY=32, VL_TRAIN=(8, 512), SM_TRAIN=(8, 64), TRAIN_STEPS=3,
                         CHECK_STEPS=16, widths=None, profile=True):
    """The stub-frontend families on placed parameters (``launch.placement``
    for qwen2-vl's vision stub and the encoder-decoder under
    ``dp_over_model``) at full width in bfloat16, stacked in one process.
    qwen2-vl-72b at ``VL_LAYERS`` = (serve, train, float32 check) of its 80
    layers, placed as the dense family on ``LAYOUT``; seamless-m4t-medium
    at ``SM_LAYERS`` = (serve and train: None for its full 12 + 12, float32
    check) under ``dp_over_model``: every weight whole on every rank, the
    rows over ``(data, model)``.  (a) Every rank's block of every
    parameter (serve and train placements), of AdamW's moments and of
    seeded decode caches equals bit for bit the chunk of the whole leaf the
    rule names, a rank's bytes ``specs.device_bytes``.  (b) qwen2-vl:
    ``BatchedEngine`` on the serve-placed parameters answers phase lm's
    ``N_REQ`` requests at ``SLOTS`` slots, ``MAX_LEN``, beside the
    unsharded engine on the same weights; a ``VL_PREFILL`` prefill of
    ``embeds``.  (c) seamless on ``LAYOUT``: ``FRAMES`` = (rows, frames,
    tokens), the rows taken up to the ranks so that they split over every
    rank: a placed prefill beside the unsharded one, then the prompt
    teacher-forced and ``GREEDY`` greedy ``decode_fn`` steps against the
    memory, placed and unsharded in lockstep on the unsharded run's
    tokens.  For (b) and (c): event median and device ms of a decode step
    by part (``_family_split``: GEMMs, attention, the collectives), its
    calls by kind and tier (the pinned budgets) with their bytes, peak
    GiB.  (d) Training, ``TRAIN_STEPS`` AdamW steps, placed then unsharded
    on the same weights (the whole tree drawn again from the seed between,
    so that one state is on the card at a time): qwen2-vl with ``fsdp`` on
    ``LAYOUT``, ``VL_TRAIN`` with ``embeds`` and ``labels`` in the config's
    microbatches (``embed`` read by no forward: gathered by no call, no
    gradient, decayed alone with its moments at zero); seamless on
    ``SM_TRAIN_LAYOUT``, ``SM_TRAIN`` frames and tokens; losses finite,
    event median, device ms by part, calls a step, peak GiB.  (e) float32
    at the check depths: each placed decode against the unsharded one,
    teacher-forced over ``CHECK_STEPS`` steps from seeded caches, within
    1/``FAM_F32_GAIN`` of the bfloat16 model's distance from the unsharded
    float32 logits; both smoke configs placed on (2, 4), the card against
    the CPU from one draw: a placed train step's loss within
    ``FRONTEND_SHARD_TOL_SMOKE``.  (f) None of the ten kernels is launched
    on the path ``frontend_shard``.  (g) seamless-m4t-medium split over
    ``model`` (its full config with ``dp_over_model`` off, at
    ``SM_LAYERS``): (a) and (c) serve-placed on ``SM_TP_LAYOUT``, the
    decode step's calls ``_encdec_tp_decode_calls`` and its top device
    events; (d) on ``SM_TRAIN_LAYOUT``, its calls
    ``_encdec_tp_train_calls``; (e) at the check depth on
    ``SM_TP_LAYOUT``, in float32 each step's argmax (the greedy token)
    placed == unsharded on every row whose unsharded top-2 margin exceeds
    ``ARGMAX_K`` times the largest placed-against-unsharded logit gap (no
    rounding within that gap can swap its top two), with at least
    ``ARGMAX_HELD`` of the rows so held (in bfloat16 the tokens are
    recorded: its own rounding moves the logits by ~3), and its smoke
    config (tensor parallel as it ships) card against CPU.  ``widths``
    (``{arch: {field: value}}``; (g) reads seamless's) narrows the configs
    for a rehearsal on the CPU."""
    import dataclasses as dc
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch import kernels as KN
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import placement as PL
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import Layout
    from repro_torch.launch.serve import BatchedEngine
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import attention as A
    from repro_torch.models import encdec as ED
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out, launched = {VL_ARCH: {}, SM_ARCH: {}, SM_TP: {}}, {}
    attention = (("attention", [(A, "decode_rows_placed"), (A, "_decode_placed"), (A, "cross_attention"),
                                (ED, "_bidir_attention")]),)

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def peak_reset():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None

    def count_launches():
        for k, v in KN.launch_counts().items():
            launched[k] = launched.get(k, 0) + v

    def events(n):
        return [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]

    def median_ms(evs):
        ms = [a.elapsed_time(b) for a, b in evs]
        return statistics.median(ms) if ms else None

    def config(arch, layers, **changes):
        full = get_config(arch)
        cfg = dc.replace(full, **(widths or {}).get(arch, {}), **changes)
        if layers is not None:
            cfg = dc.replace(cfg, num_layers=layers, **({"encoder_layers": layers} if cfg.kind == "encdec" else {}))
        return cfg, full

    def init(model, seed):
        return model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)

    def smoke(arch):
        """(e), (g): the float32 smoke config (qwen2-vl with ``fsdp``,
        seamless under ``dp_over_model`` or split over ``model`` as it
        ships), card against CPU."""
        if arch == SM_TP:
            cfg = get_smoke_config(SM_ARCH)
        else:
            cfg = dc.replace(get_smoke_config(arch), **({"dp_over_model": True} if arch == SM_ARCH else {"fsdp": True}))
        return _placed_smoke_card_cpu(dev, cfg, _frontend_batch(cfg, 8, 16, torch.device("cpu"), 35), 35)

    def rule_and_blocks(placement, placed, whole, label, what):
        """(a): the blocks against the chunks, a rank's bytes against the rule."""
        bad = _blocks_match(placed, whole, placement)
        sizes, leaves = _rank_bytes(placed, placement.layout.num_ranks), _leaf_items(placed)
        rule = sum(S.device_bytes(torch.empty(placement.shapes[k], dtype=leaves[k].dtype, device="meta"), spec,
                                  placement.axes) for k, spec in placement.specs.items())
        check(not bad and set(sizes) == {rule},
              f"(a) {label}, {what}: every rank's block of the {len(placement.specs)} leaves == the chunk the rule "
              f"names, bit for bit (mismatched: {bad}); {sizes[0]} B a rank == specs.device_bytes {rule}")
        return sizes

    def timed_steps(step, params, opt, batch):
        ev, losses, gnorms = events(TRAIN_STEPS) if cuda else [], [], []
        for i in range(TRAIN_STEPS):
            if cuda:
                ev[i][0].record()
            met = step(params, opt, batch)[2]
            if cuda:
                ev[i][1].record()
            losses.append(float(met["loss"]))
            gnorms.append(float(met["gnorm"]))
        ms = [a.elapsed_time(z) for a, z in ev]
        return {"losses": losses, "gnorms": gnorms, "step_ms": ms,
                "step_ms_median": statistics.median(ms[1:]) if len(ms) > 1 else None}

    def train_pair(cfg_t, layout, batch, label, seed):
        """(a), (d): the placed steps, then the unsharded ones on the same draw."""
        opt_cfg = AdamWConfig(warmup_steps=20)
        model_t = build_model(cfg_t)
        pl = PL.train_placement(model_t, Layout(*layout))
        lm = init(model_t, seed)
        params = pl.place(lm)
        rec = {"layout": layout, "batch": {k: tuple(v.shape) for k, v in batch.items()},
               "microbatches": cfg_t.microbatches,
               "param_bytes_per_rank": rule_and_blocks(pl, params, lm.tree(), label, f"train placement (fsdp "
                                                                                     f"{cfg_t.fsdp})")}
        rec["param_bytes_whole"] = sum(t.numel() * t.element_size() for t in lm.parameters())
        del lm
        free()
        step = build_train_step(model_t, None, opt_cfg)
        opt = adamw_init(params, opt_cfg)
        pl.comm.reset()
        KN.reset_launch_counts()
        peak_reset()
        placed_t = timed_steps(step, params, opt, batch)
        count_launches()
        placed_t["peak_gib"] = peak()
        if cuda:
            check(placed_t["peak_gib"] < 70, f"(d) {label}: the placed steps' peak {placed_t['peak_gib']:.2f} GiB < 70")
        rec["calls_per_step"], rec["call_bytes_per_step"] = _calls_and_bytes(pl.comm, TRAIN_STEPS)
        check(all(map(math.isfinite, placed_t["losses"] + placed_t["gnorms"])),
              f"(d) {label}, {rec['batch']} in {cfg_t.microbatches} microbatch(es): {TRAIN_STEPS} placed steps, losses "
              f"{[round(l, 4) for l in placed_t['losses']]} and gnorms {[round(g, 4) for g in placed_t['gnorms']]} "
              f"finite; calls a step {rec['calls_per_step']}")
        bad = [f"{k}.{p}" for k in ("m", "v") for p in _blocks_match(opt[k], pl.gather(opt[k]), pl)]
        check(not bad, f"(a) {label}: every rank's block of AdamW's m and v == the chunk of the gathered leaf, bit "
                       f"for bit (mismatched: {bad})")
        if "embeds" in batch:
            quiet = not bool(opt["m"]["embed"].any()) and not bool(opt["v"]["embed"].any())
            split = [k for k, spec in pl.specs.items() if any(S.DATA in S.spec_axes(part) for part in spec)]
            want = (len(split) - (("embed",) in split)) * cfg_t.microbatches
            got = rec["calls_per_step"].get("all_gather0")
            check(quiet and got == want,
                  f"(d) {label}: embed (read by no forward under embeds) is gathered by no call ({got} all_gathers "
                  f"over data a step == {len(split)} FSDP leaves less embed, x {cfg_t.microbatches} microbatches) and "
                  f"gets no gradient: its m and v stay zero")
        if cuda and profile:
            placed_t["split"] = _family_split(lambda: step(params, opt, batch), comm=pl.comm, warmup=False)
        rec["placed"] = placed_t
        del params, opt
        free()
        lm = init(model_t, seed)
        wstep = build_train_step(model_t, None, opt_cfg)
        opt = adamw_init(lm, opt_cfg)
        peak_reset()
        whole_t = timed_steps(wstep, lm, opt, batch)
        whole_t["peak_gib"] = peak()
        if cuda and profile:
            whole_t["split"] = _family_split(lambda: wstep(lm, opt, batch), warmup=False)
        rec["whole"] = whole_t
        if placed_t["step_ms_median"] and whole_t["step_ms_median"]:
            rec["placed_over_whole_step"] = placed_t["step_ms_median"] / whole_t["step_ms_median"]
        print(f"  (d) {label}: placed {placed_t}; whole {whole_t}", flush=True)
        del lm, opt
        free()
        return rec

    def cache_check(model, layout, slots, label, seed):
        cp = PL.cache_placement(model, Layout(*layout), slots, MAX_LEN)
        depths = [(q * (MAX_LEN - 1)) // slots for q in range(slots)]
        seeded = _seeded_caches(model, slots, MAX_LEN, depths, seed, dev)
        pc = cp.place(seeded)
        sizes = rule_and_blocks(cp, pc, seeded, label, f"decode caches ({slots} slots, max_len {MAX_LEN}, specs "
                                                       f"{ {'.'.join(k): v for k, v in cp.specs.items()} })")
        return cp, sizes

    # ------------------------------------------------ (a), (b) qwen2-vl serving
    t_arch = time.perf_counter()
    rec = out[VL_ARCH]
    cfg, full = config(VL_ARCH, VL_LAYERS[0])
    model = build_model(cfg)
    label = f"{cfg.name} at {VL_LAYERS[0]} of {full.num_layers} layers on {LAYOUT}"
    lm = init(model, 3535)
    sp = PL.serve_placement(model, Layout(*LAYOUT))
    params = sp.place(lm)
    serve = {"param_bytes_per_rank": rule_and_blocks(sp, params, lm.tree(), label, "serve placement"),
             "param_bytes_whole": sum(t.numel() * t.element_size() for t in lm.parameters())}
    cp, serve["cache_bytes_per_rank"] = cache_check(model, LAYOUT, SLOTS, label, 3536)
    requests = _lm_requests(cfg.vocab_size, N_REQ, PROMPT, NEW)
    first = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    engines = {}
    for name, p in (("placed", params), ("whole", lm)):
        engine = BatchedEngine(model, p, slots=SLOTS, max_len=MAX_LEN, device=dev)
        srec = _StepRecorder(engine)
        zeros = lambda: (cp.zeros(dev) if name == "placed" else model.init_caches(SLOTS, MAX_LEN, device=dev))
        engine._step(p, first, zeros())  # warm-up: first-use costs
        sp.comm.reset()
        KN.reset_launch_counts()
        peak_reset()
        sync()
        t0 = time.perf_counter()
        served = engine.run(requests)
        sync()
        wall = time.perf_counter() - t0
        if name == "placed":
            count_launches()
        r = {"steps": engine.steps, "tokens": sum(map(len, served.values())), "wall_s": wall,
             "step_ms_median": median_ms(srec.events), "peak_gib": peak()}
        check(all(len(served[q.rid]) == q.max_new_tokens for q in requests),
              f"(b) {label}: the {name} engine answers all {N_REQ} requests with their max_new_tokens "
              f"({r['tokens']} tokens in {r['steps']} steps)")
        if name == "placed":
            r["calls_per_step"], r["call_bytes_per_step"] = _calls_and_bytes(sp.comm, engine.steps)
            want = _dense_decode_calls(cfg.num_layers)
            check(r["calls_per_step"] == want,
                  f"(b) {label}: the placed decode step's calls {r['calls_per_step']} == the pinned budget {want}; "
                  f"bytes a step {r['call_bytes_per_step']}")
        if cuda:
            c = zeros()
            r["peak_gib_above_held"] = _peak_above_held(lambda: engine._step(p, srec.tokens[-1], c), dev)
            if profile:
                r["split"] = _family_split(lambda: engine._step(p, srec.tokens[-1], c),
                                           comm=sp.comm if name == "placed" else None, calls=3)
            del c
        engines[name] = served
        serve[f"{name}_engine"] = r
    del engine, srec
    agree = sum(a == b for q in requests for a, b in zip(engines["placed"][q.rid], engines["whole"][q.rid]))
    serve["engine_tokens_agree"] = (agree, sum(q.max_new_tokens for q in requests))
    pe, we = serve["placed_engine"], serve["whole_engine"]
    if pe["step_ms_median"] and we["step_ms_median"]:
        serve["placed_over_whole_step"] = pe["step_ms_median"] / we["step_ms_median"]
    print(f"  (b) {label}: placed {pe}; whole {we}; tokens equal {agree} of {serve['engine_tokens_agree'][1]} "
          f"(bfloat16)", flush=True)
    b, s = VL_PREFILL
    batch = {k: v for k, v in _frontend_batch(cfg, b, s, dev, 3537).items() if k != "labels"}
    logits = {}
    for name, p in (("placed", params), ("whole", lm)):
        sync()
        t0 = time.perf_counter()
        logits[name] = model.prefill_fn()(p, batch).float()
        sync()
        serve[f"prefill_{name}_s"] = time.perf_counter() - t0
    serve["prefill_placed_vs_whole"] = float((logits["placed"] - logits["whole"]).abs().max())
    check(tuple(logits["placed"].shape) == (b, cfg.vocab_size) and bool(torch.isfinite(logits["placed"]).all()),
          f"(b) {label}: a {VL_PREFILL} prefill of embeds gives finite logits ({b}, {cfg.vocab_size}), "
          f"{serve['prefill_placed_vs_whole']:.4g} from the unsharded prefill's (bfloat16)")
    rec["serve"] = serve
    del params, lm, engines, logits
    free()

    # --------------------------------------------- (a), (d) qwen2-vl training
    cfg_t, _ = config(VL_ARCH, VL_LAYERS[1], fsdp=True)
    b, s = VL_TRAIN
    rec["train"] = train_pair(cfg_t, LAYOUT, _frontend_batch(cfg_t, b, s, dev, 3538),
                              f"{cfg.name} at {VL_LAYERS[1]} of {full.num_layers} layers, fsdp, on {LAYOUT}", 3539)

    # ------------------------------------------------- (e) qwen2-vl float32
    cfg_c, _ = config(VL_ARCH, VL_LAYERS[2], dtype="float32")
    rec["float32_check"] = _frontend_f32(dev, cfg_c, LAYOUT, SLOTS, MAX_LEN, CHECK_STEPS, None, 3540)
    free()
    rec["smoke"] = smoke(VL_ARCH)
    rec["s"] = time.perf_counter() - t_arch

    def serve_seamless(cfg, layout, label, seed, want):
        """(a), (c), (g): seamless serve-placed on ``layout``: the blocks, a
        placed prefill beside the unsharded one, then the prompt
        teacher-forced and ``GREEDY`` greedy steps in lockstep; the decode
        step's calls held at ``want``."""
        model = build_model(cfg)
        R = layout[0] * layout[1]
        lm = init(model, seed)
        sp = PL.serve_placement(model, Layout(*layout))
        params = sp.place(lm)
        serve = {"layout": layout,
                 "param_bytes_per_rank": rule_and_blocks(sp, params, lm.tree(), label, "serve placement"),
                 "param_bytes_whole": sum(t.numel() * t.element_size() for t in lm.parameters())}
        rows, t_enc, s = FRAMES
        rows = max(rows, R)
        cp, serve["cache_bytes_per_rank"] = cache_check(model, layout, rows, label, seed + 1)
        batch = _frontend_batch(cfg, rows, s, dev, seed + 2)
        batch["frames"] = torch.randn((rows, t_enc, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(
            seed + 3), device=dev).to(cfg.torch_dtype)
        logits = {}
        for name, p in (("placed", params), ("whole", lm)):
            sync()
            t0 = time.perf_counter()
            logits[name] = model.prefill_fn()(p, batch).float()
            sync()
            serve[f"prefill_{name}_s"] = time.perf_counter() - t0
        serve["frames"], serve["prefill_placed_vs_whole"] = (rows, t_enc, cfg.d_model), float(
            (logits["placed"] - logits["whole"]).abs().max())
        check(tuple(logits["placed"].shape) == (rows, cfg.vocab_size) and bool(torch.isfinite(logits["placed"]).all()),
              f"(c) {label}: a placed prefill of frames {serve['frames']} and {s} tokens gives finite logits, "
              f"{serve['prefill_placed_vs_whole']:.4g} from the unsharded prefill's (bfloat16)")
        with torch.no_grad():
            memory = ED.encode(lm, batch["frames"], cfg)
        step = model.decode_fn()
        caches = {"placed": cp.zeros(dev), "whole": model.init_caches(rows, MAX_LEN, device=dev)}
        toks = [batch["tokens"][:, t:t + 1] for t in range(s)]
        evs = {"placed": events(s + GREEDY) if cuda else [], "whole": events(s + GREEDY) if cuda else []}
        sp.comm.reset()
        KN.reset_launch_counts()
        peak_reset()
        gap, agree, greedy_agree = 0.0, 0, 0
        for t in range(s + GREEDY):
            lg = {}
            for name, p in (("placed", params), ("whole", lm)):
                if cuda:
                    evs[name][t][0].record()
                lg[name], caches[name] = step(p, toks[t], caches[name], memory)
                if cuda:
                    evs[name][t][1].record()
            gap = max(gap, float((lg["placed"].float() - lg["whole"].float()).abs().max()))
            same = int((lg["placed"].argmax(-1) == lg["whole"].argmax(-1)).sum())
            agree += same
            if t + 1 >= s:  # the greedy tokens: the argmax after the prompt's last token and each greedy step
                greedy_agree += same
                toks.append(lg["whole"].argmax(-1, keepdim=True).to(torch.int32))
        count_launches()
        steps_run = s + GREEDY
        r = {"steps": steps_run, "step_ms_median": median_ms(evs["placed"]),
             "whole_step_ms_median": median_ms(evs["whole"]), "peak_gib": peak(), "logits_placed_vs_whole": gap,
             "argmax_agree": (agree, steps_run * rows), "greedy_agree": (greedy_agree, (GREEDY + 1) * rows),
             "pos": int(caches["placed"]["pos"][0, 0, 0])}
        r["calls_per_step"], r["call_bytes_per_step"] = _calls_and_bytes(sp.comm, steps_run)
        check(r["calls_per_step"] == want and r["pos"] == min(s + GREEDY, MAX_LEN - 1),
              f"(c) {label}: {s} teacher-forced and {GREEDY} greedy placed decode_fn steps against the memory beside "
              f"the unsharded model (max |dlogit| {gap:.4g}, argmax equal {agree} of {steps_run * rows}, greedy "
              f"{greedy_agree} of {(GREEDY + 1) * rows}, bfloat16); position {r['pos']}; calls a step "
              f"{r['calls_per_step']} == the pinned budget {want}; bytes a step {r['call_bytes_per_step']}")
        if cuda:
            fixed = {"placed": cp.zeros(dev), "whole": model.init_caches(rows, MAX_LEN, device=dev)}
            tok = toks[-1]
            r["peak_gib_above_held"] = _peak_above_held(lambda: step(params, tok, fixed["placed"], memory), dev)
            if profile:
                r["split"] = _family_split(lambda: step(params, tok, fixed["placed"], memory), comm=sp.comm, calls=3,
                                           more=attention)
                r["whole_split"] = _family_split(lambda: step(lm, tok, fixed["whole"], memory), calls=3,
                                                 more=attention)
                r["top_events"] = _top_events(lambda: step(params, tok, fixed["placed"], memory))
                r["whole_top_events"] = _top_events(lambda: step(lm, tok, fixed["whole"], memory))
            del fixed
        serve["decode"] = r
        print(f"  (c) {label}: {r}", flush=True)
        del params, lm, caches, memory, logits
        free()
        return serve

    # ------------------------------------------------ (a), (c) seamless serving
    t_arch = time.perf_counter()
    rec = out[SM_ARCH]
    cfg, full = config(SM_ARCH, SM_LAYERS[0])
    model = build_model(cfg)
    R = LAYOUT[0] * LAYOUT[1]
    label = f"{cfg.name} at {cfg.encoder_layers} + {cfg.num_layers} layers, dp_over_model, on {LAYOUT}"
    rec["serve"] = serve_seamless(cfg, LAYOUT, label, 3541, _encdec_decode_calls(cfg.num_layers))

    # --------------------------------------------- (a), (d) seamless training
    b, s = SM_TRAIN
    rec["train"] = train_pair(cfg, SM_TRAIN_LAYOUT, _frontend_batch(cfg, b, s, dev, 3545),
                              f"{cfg.name} at {cfg.encoder_layers} + {cfg.num_layers} layers, dp_over_model, on "
                              f"{SM_TRAIN_LAYOUT}", 3546)
    want = {"psum": len(PL.train_placement(model, Layout(*SM_TRAIN_LAYOUT)).specs) + 2}
    check(rec["train"]["calls_per_step"] == want,
          f"(d) {cfg.name}: a placed train step's calls {rec['train']['calls_per_step']} == one flat psum a leaf over "
          f"both batch axes and the loss's and the norm's, {want}")

    # ------------------------------------------------- (e) seamless float32
    cfg_c, _ = config(SM_ARCH, SM_LAYERS[1], dtype="float32")
    rec["float32_check"] = _frontend_f32(dev, cfg_c, LAYOUT, R, MAX_LEN, CHECK_STEPS, FRAMES[1], 3547)
    free()
    rec["smoke"] = smoke(SM_ARCH)
    rec["s"] = time.perf_counter() - t_arch

    # ----------------------------- (g) seamless split over model: serving
    t_arch = time.perf_counter()
    rec = out[SM_TP]
    cfg, _ = config(SM_ARCH, SM_LAYERS[0], dp_over_model=False)
    label = f"{cfg.name} at {cfg.encoder_layers} + {cfg.num_layers} layers, split over model, on {SM_TP_LAYOUT}"
    rec["serve"] = serve_seamless(cfg, SM_TP_LAYOUT, label, 3551, _encdec_tp_decode_calls(cfg.num_layers))

    # ---------------------------- (g) seamless split over model: training
    b, s = SM_TRAIN
    model = build_model(cfg)
    rec["train"] = train_pair(cfg, SM_TRAIN_LAYOUT, _frontend_batch(cfg, b, s, dev, 3555),
                              f"{cfg.name} at {cfg.encoder_layers} + {cfg.num_layers} layers, split over model, on "
                              f"{SM_TRAIN_LAYOUT}", 3556)
    want = _encdec_tp_train_calls(cfg, len(PL.train_placement(model, Layout(*SM_TRAIN_LAYOUT)).specs))
    check(rec["train"]["calls_per_step"] == want,
          f"(g) {cfg.name} split over model: a placed train step's calls {rec['train']['calls_per_step']} == the "
          f"pinned budget {want}")

    # ----------------------------- (g) seamless split over model: float32
    cfg_c, _ = config(SM_ARCH, SM_LAYERS[1], dtype="float32", dp_over_model=False)
    f32 = rec["float32_check"] = _frontend_f32(dev, cfg_c, SM_TP_LAYOUT, R, MAX_LEN, CHECK_STEPS, FRAMES[1], 3557)
    same, held, rows = f32["argmax_held"]
    check(same == held >= ARGMAX_HELD * rows,
          f"(g) {cfg_c.name} split over model at 1 + 1 layers in float32 on {SM_TP_LAYOUT}: the greedy tokens (each "
          f"step's argmax) placed == unsharded on {same} of the {held} rows whose top-2 margin exceeds {ARGMAX_K} x the "
          f"largest logit gap {f32['decode_placed_vs_whole']:.3g}, {held} >= {ARGMAX_HELD:g} of {rows} rows (all rows: "
          f"{f32['argmax_agree'][0]} equal; bfloat16's own rounding moves the logits {f32['decode_bf16_vs_f32']:.3g}: "
          f"its tokens are recorded, not held)")
    free()
    rec["smoke"] = smoke(SM_TP)
    rec["s"] = time.perf_counter() - t_arch

    for arch in (VL_ARCH, SM_ARCH, SM_TP):
        smoke = out[arch]["smoke"]
        check(abs(smoke["card"] - smoke["cpu"]) <= FRONTEND_SHARD_TOL_SMOKE,
              f"(e) the {arch} smoke config placed on (2, 4), one train step: the card's loss {smoke['card']:.6f} "
              f"within {FRONTEND_SHARD_TOL_SMOKE} of the CPU's {smoke['cpu']:.6f}")
    check(not any(launched.values()),
          f"(f) path frontend_shard: none of the ten kernels launched on the placed engines and steps ({launched})")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase frontend_shard: {out['phase_s']:.1f} s", flush=True)
    return out, {"frontend_shard": launched}


def _frontend_f32(dev, cfg_c, layout, slots, max_len, steps, frames, seed):
    """(e): ``cfg_c`` (float32) serve-placed on ``layout`` against its
    unsharded twin and a bfloat16 copy of the same weights, teacher-forced
    over ``steps`` decode steps from seeded caches (an encoder-decoder
    against the memory of ``frames`` seeded frames a row, each run's own
    encoder): the largest |placed - unsharded| and |bfloat16 - float32|
    logit differences, held at 1/``FAM_F32_GAIN``; the argmax tokens placed
    against unsharded and the unsharded logits' smallest top-2 margin,
    recorded, and ``argmax_held``: (equal, rows, all rows) over the rows
    whose top-2 margin exceeds ``ARGMAX_K`` times the largest placed
    against unsharded gap."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.launch import placement as PL
    from repro_torch.launch.mesh import Layout
    from repro_torch.models import encdec as ED
    from repro_torch.models.api import build_model

    model_c, model_b = build_model(cfg_c), build_model(dc.replace(cfg_c, dtype="bfloat16"))
    lay = Layout(*layout)
    lm32 = model_c.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    p32 = PL.serve_placement(model_c, lay).place(lm32)
    w16 = _cast_tree(lm32.tree(), torch.bfloat16)
    cpc = PL.cache_placement(model_c, lay, slots, max_len)
    depths = [(q * (max_len - steps)) // slots for q in range(slots)]
    c16 = _seeded_caches(model_b, slots, max_len, depths, seed + 1, dev)
    mem = {}
    if frames is not None:
        x = torch.randn((slots, frames, cfg_c.d_model), generator=torch.Generator(device=dev).manual_seed(seed + 2),
                        device=dev)
        with torch.no_grad():
            mem = {"placed": ED.encode(lm32, x, cfg_c), "bf16": ED.encode(w16, x, model_b.cfg)}
        mem["whole"] = mem["placed"]
    runs = {"placed": [p32, cpc.place(_cast_tree(c16, torch.float32)), model_c.decode_fn()],
            "whole": [lm32, _cast_tree(c16, torch.float32), model_c.decode_fn()],
            "bf16": [w16, c16, model_b.decode_fn()]}
    gen = np.random.default_rng(seed + 3)
    d_placed = d_bf16 = 0.0
    same, margins = [], []
    for _ in range(steps):
        tok = torch.from_numpy(gen.integers(0, cfg_c.vocab_size, (slots, 1)).astype(np.int32)).to(dev)
        lg = {}
        for name, run in runs.items():
            extra = (mem[name],) if mem else ()
            lg[name], run[1] = run[2](run[0], tok, run[1], *extra)
        d_placed = max(d_placed, float((lg["placed"] - lg["whole"]).abs().max()))
        d_bf16 = max(d_bf16, float((lg["bf16"].float() - lg["whole"]).abs().max()))
        same.append((lg["placed"].argmax(-1) == lg["whole"].argmax(-1)).reshape(-1).cpu())
        top2 = lg["whole"].topk(2, dim=-1).values
        margins.append((top2[..., 0] - top2[..., 1]).reshape(-1).cpu())
    pairs = [(a, b) for (k, a), b in zip(_leaf_items(cpc.gather(runs["placed"][1])).items(),
                                         _leaf_items(runs["whole"][1]).values()) if k[-1] != "pos"]
    cache_gap = max(float((a - b).abs().max()) for a, b in pairs)
    same, margins = torch.cat(same), torch.cat(margins)
    held = margins > ARGMAX_K * d_placed
    rec = {"layers": cfg_c.num_layers, "slots": slots, "decode_placed_vs_whole": d_placed, "decode_bf16_vs_f32": d_bf16,
           "cache_gap": cache_gap, "argmax_agree": (int(same.sum()), len(same)), "min_top2_margin": float(margins.min()),
           "argmax_held": (int(same[held].sum()), int(held.sum()), len(same))}
    check(d_placed <= d_bf16 / FAM_F32_GAIN,
          f"(e) {cfg_c.name} at {cfg_c.num_layers} layer(s) in float32 on {layout}: {steps} teacher-forced decode steps "
          f"of {slots} slots max |placed - unsharded| {d_placed:.4g} <= 1/{FAM_F32_GAIN:g} of the bfloat16 model's "
          f"distance {d_bf16:.4g}; the caches {cache_gap:.4g} apart")
    return rec


def _nest(flat):
    """``{path: leaf}`` → the nested dict."""
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    print(smi, flush=True)
    t_build = build.build()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}; "
          f"kernel build {t_build:.1f} s; card {torch.cuda.get_device_name(0)} [{smi}]", flush=True)
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": t_build}

    run = {"kernels": lambda: phase_kernels(dev), "forward": lambda: phase_forward(dev),
           "lossless": lambda: phase_lossless(dev), "telemetry": lambda: phase_telemetry(dev),
           "pipeline": lambda: phase_pipeline(dev), "credit": lambda: phase_credit(dev),
           "balance": lambda: phase_balance(dev), "recovery": lambda: phase_recovery(dev),
           "streamlines": lambda: phase_streamlines(dev), "vopat": lambda: phase_vopat(dev),
           "nbody": lambda: phase_nbody(dev), "obs": lambda: phase_obs(dev), "apps2": lambda: phase_apps2(dev),
           "ragged": lambda: phase_ragged(dev), "lm": lambda: phase_lm(dev), "train": lambda: phase_train(dev),
           "families": lambda: phase_families(dev), "dryrun": lambda: phase_dryrun(dev),
           "dist": lambda: phase_dist(dev), "dist_paths": lambda: phase_dist_paths(dev),
           "shard": lambda: phase_shard(dev), "serve_shard": lambda: phase_serve_shard(dev),
           "moe_shard": lambda: phase_moe_shard(dev), "recurrent_shard": lambda: phase_recurrent_shard(dev),
           "frontend_shard": lambda: phase_frontend_shard(dev)}
    kernels, paths = {}, {}  # paths: launches per path, counted from 0
    for title in run:
        print(f"# phase {title}", flush=True)
        t0 = time.perf_counter()
        try:
            res = run[title]()
        except Exception:  # report every phase; any failure fails the run below
            traceback.print_exc()
            FAILURES.append(f"phase {title} raised")
            continue
        if title == "kernels":
            kernels, more = res
            paths.update(more)
        elif title in ("lossless", "telemetry", "pipeline", "credit", "balance", "recovery", "obs", "apps2", "ragged",
                       "lm", "train", "families", "dryrun", "dist", "dist_paths", "shard", "serve_shard",
                       "moe_shard", "recurrent_shard", "frontend_shard"):
            record[title], more = res
            paths.update(more)
        elif title in ("streamlines", "vopat", "nbody"):
            record[title], paths[title] = res
        else:
            record[title] = res
        print(f"# phase {title} done in {time.perf_counter() - t0:.1f} s", flush=True)

    launches = {}
    for k in KERNELS:
        launches[k] = sum(paths.get(p, {}).get(k, 0) for p in LAUNCH_PATHS[k])
        check(launches[k] > 0, f"{k}: {launches[k]} launches on {' + '.join(LAUNCH_PATHS[k])}")
    report = []
    for k, (source, replaces) in KERNELS.items():
        r = kernels.get(k)
        if r is None:
            continue
        report.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            "ms": r["device_ms"], "plain_ms": r["plain_device_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_device_ms"],
            "device_ms": r["device_ms"], "call_ms": r["call_ms"],
            "kernels_a_call": kernels_a_call(r["events"]), "device_events": r["events"],
            "l2_warm": r["l2_warm"],
        })
    record["kernels"] = report
    record["kernel_details"] = kernels
    record["paths"] = paths
    record["failures"] = FAILURES
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    if len(report) != len(KERNELS):
        FAILURES.append("a kernel has no measurement")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
