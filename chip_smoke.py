#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card (an H100 for the kernels' ``sm_90a`` target) and the
CUDA toolkit; imports nothing of JAX or of the JAX package.  Prints one
JSON object per line:

1. ``device``: the card, and ``nvidia-smi``'s name and power limit;
2. ``build``: the hand-written kernels of ``src/repro_torch/kernels/csrc``
   compiled with one ``nvcc`` each, all started together, the seconds it
   took, and ptxas's registers, spills and wgmma warnings (the
   tensor-core kernels, ``flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu``,
   ``ssd_sm90.cu`` and ``ssd_bwd_sm90.cu``, and the decode kernel
   ``flash_decode.cu`` must spill
   nothing, and ptxas must not serialize the tensor-core kernels' wgmma);
3. ``kernel`` lines: each kernel against its plain PyTorch version on the
   card at the serving and training paths' shapes, with its tolerance, its
   visit counters against the ``tiling`` twins, and its time (CUDA events
   around one call queued behind a device spin, median of 25 calls after
   warm-up, L2 flushed before each), the plain version's time, the bound
   (the larger of bytes over 3.35 TB/s and operations over the peak rate
   of their type) and, where one PyTorch call computes the same function,
   its time (``F.scaled_dot_product_attention``, forward or backward, a
   boolean band ``attn_mask`` for a window or ``kv_len``) as a yardstick
   the port never calls.  The flash forward's lines name the design that
   ``ops.fwd_route`` chose and the backward's the dQ / dKV design that
   ``ops.bwd_route`` chose (``sm90``: the tensor-core kernels, for bf16 at
   head_dim 64 / 128 / 160; ``fma``: the f32 kernels), and check that the call
   launched that design's kernels and not the other's.  The decode lines
   also report the rate their bytes moved at (``GBps``) and the share of
   the byte bound reached; GQA group 6 is checked at a small shape,
   untimed (groups 16, 1 and 3 are timed at full size in item 21, 6 in
   item 28);
4. ``model``: a 2-layer model at head_dim 128 run through prefill and
   decode, and through ``loss_fn`` and its backward, on the card (kernels)
   and on the CPU (plain versions) from the same weights: logits, int8
   caches, the loss and every parameter's gradient compared;
5. ``serve``: the full-width, full-depth llama3-8b (random bf16 weights from
   ``--seed``) served by ``ServeEngine`` over a 16-request synthetic trace;
   the kernels' launch counters are zeroed just before the run and read
   just after it;
6. ``profile``: ``torch.profiler`` over a short serve run after that one
   (``PROFILE_REQUESTS`` requests), device time by kernel and the card's
   idle share, and over ``PROFILE_WINDOW`` engine steps that only decode
   (8 requests resident): the device time of one decode round; then
   ``serve_budget``:
   an engine with ``mem_budget_bytes`` of 5.5 slots at ``max_len`` 2048
   and 8 slots asked for must clamp to 5 (``capacity_report``), a pool of
   5 slots must allocate exactly 5 x ``bytes_per_slot`` on the card (its
   ``pos`` lengths aside), and the trace's first 6 requests must finish
   with never more than 5 resident;
6b. ``fleet``: the serving fleet on that trace and the serve cell's model
   cut to ``FLEET_LAYERS`` (16) of its 32 layers, from ``--seed``
   (``serve/router.py``, ``faults.py``, ``journal.py``, ``worker.py``): 2
   in-process replicas
   (8 slots, ``max_len`` 2048, int8, ``kv_splits`` 4, request keys), one
   line a sub-phase: (a) ``fleet_reference``, greedy and fault-free, each
   token's top-1 / top-2 logit gap recorded; (b) ``fleet_chaos``, the same
   under ``chaos_plan`` seed 33 (a replica crash with requests resident, a
   slow replica) and a ``nan_logits``; (c) ``fleet_recover``, a journaled
   run crashed by ``crash_after_appends`` and finished by ``recover()`` on
   a new router over fresh engines; (d) ``fleet_request_keys``, sampling
   at temperature 0.8, top-k 50, one request evicted mid-stream and
   resubmitted with its emitted tokens and key on the other replica; (e)
   ``fleet_workers``, 2 subprocess workers (their own weights from
   ``--seed``, at the same depth: ``fleet_worker``) on the first 8
   requests, one SIGKILLed, the
   survivor's kernel launches and no ``nvcc`` in the children; (f)
   ``fleet_traced``, (b) again with tracers on the engines, the router
   and the journal: spans by name and the median host duration of an
   engine step beside ``profile``'s device time of a decode round.
   Between (a) and (b), ``fleet_replay``: every request of (a) decoded
   again and submitted again with its first j tokens as ``emitted`` (j
   its first, middle and last draw), which re-prefills them as a replay
   does, the draw's logits against the same draw decoded, within
   ``REPLAY_PREMISE_ULPS``, and a replay fed a wrong last token beyond
   it.  Tokens of (b)-(f) equal the reference's or differ first at a
   near-tie: the reference's top-2 gap within 2 bf16 ulps of its top
   logit and the held run's token among its best within that much;
   where the held run ran in this process ((b)-(d), (f)) also the
   reverse, and the two runs' top logits within 2 ulps of each other
   (``top_logit_drift`` reads that drift over every draw both runs
   recorded).  A stream the held run replayed before its first
   difference is held instead, from the replay on, to its twin, the same
   replay made again here, by the same near-tie rule
   (``hold_replayed``).  The launch counters are
   zeroed before each of (a)-(c), (d)'s migrated run and (f), and read
   after: one launch a layer for each prefill and each decode round;
6c. ``serve_tp``: serving over a (data, model) mesh, after the fleet:
   (a) ``kernel`` lines ``flash_decode_partials`` /
   ``flash_decode_bias_partials``: the decode kernel's partials form on
   each of n sequence shards of one cache (llama3-8b's decode shape in 2
   shards, glm4-9b's (2 KV heads, G 16) in 4, hymba's band in 2), the
   shards merged in process by ``collectives.merge_partials``, against
   the unsharded kernel (1e-5) and the plain version (1e-3), a shard past
   a row's length exactly 0, shard 0's call timed; (b)-(d) ranks spawned
   from this script (``--tp-child``; gloo on this card, since NCCL takes
   one rank a device and gloo stages every reduction through the host:
   the times are a correctness run's), each building its block of the
   weights from ``--seed``: (b) llama3-8b at 2 layers, f32, on (1, 2),
   teacher-forced serve steps (``train/serve_step.py``; prefill 4 x 128,
   16 decode steps fed the unsharded run's greedy tokens) against the
   unsharded run here: the prefill's logits within ``TP_B_PREFILL`` and
   every decode step's within ``TP_B_DECODE`` (from the rank's own cache
   and from its block of the unsharded run's), each rank's int8 prefill
   cache within one rounding step of its block of the unsharded one,
   greedy equal at every step; (c) llama3-8b at ``TP_C_LAYERS`` (4) of
   its 32 layers, bf16, on (1, 2) (heads mode) and (d) glm4-9b at
   ``GLM_TP_LAYERS`` (2) of its 40 layers on (1, 4) (sequence mode),
   each against an unsharded run of the same depth here: the serve
   cell's engine on the serve trace (16 of 16,
   no fault, the pool audit clean, every rank's streams equal, launches
   exactly one flash forward a layer an admission and one decode a layer
   a round) and the teacher-forced logits, prefill and decode steps,
   within ``TP_BOUND_C`` / ``_D``, (c)'s two ranks and (d)'s four at
   once, the bf16 control (the unsharded run's logits against the same
   weights at f32) reported beside; each teacher-forced run is read again
   under the planted faults (``TP_FAULTS``), and each must break its
   bounds; per rank the launches, the peak memory and the host time of a
   decode round beside the unsharded run's; (e) the fleet on (1, 2)
   (``launch/serve.py``'s pieces, as its ``--replicas 2 --chaos-seed 0
   --journal`` then ``--recover`` run them): (c)'s llama3-8b, 2 replicas
   of the serve cell on the mesh, the chaos plan of seed 0, the journal
   killed at append ``FLEET_CRASH_AT`` (rank 0 writes it, rank 1 mirrors
   it), the fleet recovered on the same engines and the trace finished;
   every request done and reconciled, no slot leak, the ranks' streams
   and decision digests equal, launches exact a rank, and rank 0's
   streams held to the unsharded fleet's here by the replay gate
   (``hold_to``); the streams equal to the
   unsharded run's reported;
7. ``train``: llama3-8b at full width and 4 layers (random f32 master
   weights from ``--seed``), policy bf16, remat on every block, AdamW,
   batch 1 x 4096 tokens, through ``build_train_step``: 2 warm-up steps,
   then 5 timed steps with the launch counters zeroed before and read
   after (the forward and the backward's dQ / dKV on the tensor-core
   kernels only), then ``torch.profiler`` over one more step;
7a. ``dryrun``: ``launch/dryrun.py``'s predictions held against the
   card, one line a sub-phase: (a) ``dryrun_train``, the ``train`` cell
   (llama3-8b at 4 layers, 1 x 4096, bf16 policy, f32 masters, remat
   every block, AdamW, no mesh): the dry run's fake-tensor trace of one
   step on the host (``dryrun.build_lowerable`` / ``trace_step``), then
   one real step of the same step function from ``--seed`` on the card
   under ``FlopCounterMode``: the traced kernel calls must equal the
   launch counters' deltas and the traced FLOPs the real step's,
   exactly, and the traced peak of live bytes must be within
   ``DRYRUN_PEAK_TOL`` (10%) of ``max_memory_allocated`` after
   ``reset_peak_memory_stats`` (the bytes held before the state was
   built taken off), while a control -- the prediction less the AdamW
   moments (2 x 4 bytes a parameter) -- must miss it; (b)
   ``dryrun_decode``, one decode step of full-depth llama3-8b (bf16
   weights from ``--seed``, 8 slots x 2048 int8, ``kv_splits`` 4, no
   mesh, ``make_serve_steps``): the same checks (32 ``flash_decode``
   launches, the splits merged in PyTorch), the control the prediction
   less the 32 blocks' weights; (c) ``dryrun_cli``, ``python -m
   repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
   --json`` in a subprocess on the (data 16, model 16) mesh: exit 0,
   one cell OK, and that process never initialized CUDA (its
   ``torch.cuda.memory_allocated()`` 0); the seconds of each part;
7b. ``train_dp``: data-parallel training (``train_step`` with a
   ``launch/mesh.py`` ``Mesh``): (a) the ``train`` cell through
   ``make_train_step(mesh=Mesh(data=1, model=1))`` in a world-1 NCCL
   group (``file://`` rendezvous in a temporary directory), its gradients,
   loss and finite flag through NCCL's all-reduce: losses and grad norms
   bit-equal to ``train``'s, or within what a second meshless run differs
   by (the line says which), and the same launches; (b) two ranks on this
   card, processes spawned from this script (``--dp-child``; gloo, since
   NCCL takes one rank a device), smoke-width llama3-8b, batch 2 x 1024,
   bf16, 5 steps: losses within 1e-3 rel of a 1-rank run at the global
   batch here, each rank's launches what ``flash/ops.py``'s routes give
   at head_dim 16, and ``compressed_psum_grads`` on each rank's CUDA
   gradients (the mean within the int8 step, the payload a quarter of the
   f32 bytes plus the scales).  The ranks only load the libraries the
   ``build`` line built; each is joined with a timeout and killed if it
   fails;
7c. ``train_tp``: tensor-parallel training (``make_train_step`` on a
   (1, n) mesh: ``copy_to_model`` / ``reduce_from_model``, the
   vocab-parallel CE, the sharded clip norm), ranks spawned from this
   script (``--tp-train-child``; gloo on this card, whose reductions go
   through the host: the step times are a correctness run's), each
   building its block of the f32 master weights and AdamW state from
   ``--seed``, one sub-phase after another: (a) llama3-8b at full width,
   ``TPT_A_LAYERS`` layers, f32, 1 x ``TPT_A_SEQ``, ``TPT_A_STEPS``
   steps on (1, 2) (heads mode); (b) the ``train`` cell's llama3-8b
   cut to ``TPT_B_LAYERS`` (2) layers, bf16, at 1 x ``TPT_BC_SEQ``
   (1024) on (1, 2), its ranks started with (a)'s; (c) glm4-9b at
   ``TPT_C_LAYERS`` (2) of its 40 layers, bf16, 1 x 1024, on (1, 4)
   (sequence mode: the attention whole on every rank, the FFN and the
   vocab split); (b) and (c) one warm-up and 3 timed steps.  Before
   each sub-phase's ranks use it, the unsharded run of the same seed,
   batch and config runs here (in bf16 also its f32 control), each
   rank's windows of the saved leaves' first-step gradients (a column-
   and a row-parallel leaf of the middle layer, the embedding, the head,
   a norm) are written for it, and every device tensor is freed; each
   rank's peak is reckoned from ``train``'s bytes per parameter and the
   depth cut where the ranks together would pass ``TPT_FIT_BYTES``.  Per
   rank: launches on the route's design exactly the meshless counts, the
   losses and grad norms equal rank 0's, the replicated leaves'
   gradients and parameters bit-equal across ranks, the readings within
   ``TPT_A_BOUNDS`` ((a), f32) or ``TPT_BOUNDS`` (3x the larger of the
   sound reading and the bf16 control), and the first step read again
   under each planted fault (``TPT_FAULTS``; in (a) also the steps under
   a moment one row off its parameter), each beyond a bound; the peak,
   the median step time beside the unsharded run's;
7d. ``moe_tp``: the MoE FFN over a model axis (``models/moe.py`` with
   ``mesh=``), ranks spawned as in 7c and 6c, one sub-phase after
   another: (a) deepseek-moe-16b TP-experts (``w_gate`` / ``w_up`` /
   ``w_down`` and the shared experts split on F), f32, 2 layers, 1 x
   ``MOE_TP_SEQ`` (512), 3 steps on (1, 2); (b) granite-moe-3b-a800m with
   ``expert_mode="ep"`` (10 of its 40 experts a rank), likewise on
   (1, 4); both as 7c's (a) (``MOE_TP_BOUNDS``), the saved leaves the
   middle layer's router, ``w_gate``, ``w_down``, shared experts and
   ``ln2``, the embedding and the head, and every routing call of the
   first step (its forward and its recompute) against the unsharded
   run's: the top-k indices, equal or different only at near-ties (the
   ``moe_model`` rule), and the kept assignments, each rank's (TP) or
   the ranks' sum (EP) equal call for call; (c) deepseek TP serving,
   bf16, 4 layers on (1, 2): the serve cell's engine and trace and the
   teacher-forced steps, as 6c's (c); (d) granite EP serving, bf16, 2
   layers on (1, 4), teacher-forced (routing reported, ungated in
   bf16); (c) and (d)'s ranks at once, within ``MOE_TP_BOUND_C`` /
   ``_D`` (3x the larger of the sound reading and the bf16 control);
   (c) and (d) again at f32 (``c_f32`` / ``d_f32``: 2 layers each,
   teacher-forced only, routing exact; their ranks started with the
   others, building nothing until (a)'s have ended): the prefill and the
   decode steps from the unsharded run's cache within
   ``MOE_TP_F32_BOUNDS`` (``serve_tp`` (b)'s), each rank's int8 prefill
   cache within one step of its block of the unsharded one, greedy
   equal, the decode steps from the rank's own cache reported (the
   one-step differences compound there).
   Each sub-phase is read again under its planted faults
   (``MOE_TP_FAULTS``), each beyond a bound, the f32 readings' by more
   than ``FAULT_MARGIN`` (10x);
7e. ``ssm_tp``: the SSM mixers and the encoder over a model axis, ranks
   spawned as in 7d, all at once: (a) hymba-1.5b at 4 layers (global
   layer 0, windowed 1-3), f32, 1 x 2048 (past its 1024 window), 3 steps
   on (1, 2) (sequence mode: 5 KV heads, the attention and the SSM whole
   on every rank, the FFN and the vocab split); (b) mamba2-130m at 6 of
   its 24 layers, f32, 1 x 2048, 3 steps on (1, 4); (c) whisper-base at 4 + 4
   layers, f32, 2 x 448, 1500 seeded frames a row, 3 steps on (1, 2)
   (heads mode: the encoder, the cross-attention and the GELU MLP split);
   each as 7d's (a) (``MOE_TP_BOUNDS``), launches exactly the meshless
   counts (the flash kernels and the SSD chunk and its backward, each on
   its route's design), the replicated leaves (every ``ssm`` leaf among
   them) bit-equal across ranks; (d) f32 serving, teacher-forced through
   ``make_serve_steps`` on (1, 2): hymba at 4 layers, 4 x 1536 (its
   global layer decoding by length over a sequence-split cache, its
   windowed ones by the band's bias, both through the decode kernel's
   partials) and whisper at 6 + 6, 4 x 64 over 1500 frames (each decode
   step taking the encoder's output), 16 steps each, gated as 7d's f32
   readings, launches exact, the same weights in bf16 reported beside,
   ungated; (e) ``launch/serve.py``'s lockstep for
   mamba2-130m under ``torch.distributed.run`` with 2 ranks
   (``--max-model 2``): rank 0's tokens equal a 1-rank run's, rank 1
   serves nothing and never creates a CUDA context; (f) MLA training,
   minicpm3-4b at 4 layers, f32, 1 x 1024, 3 steps on (1, 2) (``q_b`` /
   ``kv_b`` / ``wo`` by its 40 heads), as (a) (no kernel launched: MLA
   runs the plain attention); (g) MLA serving through
   ``make_serve_steps`` on (1, 2), 4 x 1024 + 16 steps, the latent cache
   split by sequence, gated as (d) (each rank's bf16 latents within one
   rounding step of its block of the unsharded run's and the prefill's
   bound beyond it, and half the unsharded bytes; the decode steps from
   the unsharded run's cache with the latents in f32, greedy equal; from
   the rank's own cache reported), the bf16 policy reported; (h) the two-tier cache, hymba at 4 layers,
   f32, both tiers by sequence on (1, 2): the cache built here from the
   unsharded prefill of 4 x 1016, then 16 decode steps whose rolling
   write wraps past slot 1024 across the ranks' blocks, against the
   unsharded two-tier decode (``MOE_TP_F32_BOUNDS``' decode bound, greedy
   equal, ``flash_decode`` once a layer a step).  The GELU MLPs' biases
   are drawn from the seed (the reference starts them at zero), and each
   sub-phase is read again under its planted faults (``SSM_TP_FAULTS``),
   each beyond its bound by more than 10x;
8. ``train_plan``: the ``train`` configuration from the same weights and
   batch under eight remat settings: (a) off, (b) ``full`` on every block,
   (c) the trainer's ``--remat auto`` without a budget (its
   ``_auto_remat``: ``plan_min_peak`` at isqrt(L) checkpoints), (d)
   ``TrainConfig.mem_budget_mb`` at the midpoint of (c)'s planned peak and
   the profile's ``no_remat_bytes`` (``make_train_step`` solves it with
   ``plan_for_budget``), (e) ``dots``, (f) ``dots_nobatch``, (g) ``full``
   with ``save_names=("attn_out", "ffn_out")``, (h) (b) with the chunked
   CE (``ce_chunk=512``).  Each: a warm-up step and 3 timed steps through
   ``make_train_step``, the flash
   launch counters zeroed before the timed steps and read after, one
   forward and backward of ``loss_fn`` for the bytes still allocated after
   the forward and the peak above what was allocated before, and
   ``torch.profiler``'s count of GEMM launches in one step; the planner's
   ``peak_bytes`` beside the measured bytes;
9. ``train_cli``: ``python -m repro_torch.launch.train --smoke`` on the
   card for 4 steps with checkpoints, then again to 6 steps, which must
   resume from step 4; then a run of 2 steps with ``--remat auto
   --mem-budget-mb 1 --events F --trace --metrics-every 1``, whose
   ``remat_plan.json`` and event file are checked; then ``--arch
   mamba2-130m --smoke`` for 4 steps and again to 6, which must resume,
   mamba2 for 2 steps under ``--no-remat``, and ``--arch hymba-1.5b``
   for 2 under ``--remat auto --mem-budget-mb 1 --policy full --guard``;
   the five independent chains of runs at once;
10. ``kernel`` lines for the E-D codec's decode and encode kernels against
   their plain versions, for equality, at the CIFAR batch (8 containers of
   32x32x3) and the memory shape (4 containers of 512x512x3);
11. ``cifar_model``: full-width ResNet-18 from one set of weights through
    ``loss_fn`` on one packed batch of 32, on the card (decode kernel) and
    on the CPU (plain version): logits, loss and every gradient;
12. ``cifar_train``: ``examples/cifar_optorch_torch.py``'s ``train()`` for
    the paper's four pipelines (baseline, ED, ED+SC, ED+SC+MP), ResNet-18
    at full width, 200 steps each, the launch counters zeroed before each
    and read after it; accuracy parity, step time, images/s, peak memory,
    and ``torch.profiler`` over ``CIFAR_PROFILE_STEPS`` steps of ED+SC+MP;
13. ``cifar_memory``: the paper's memory experiment at the repo's fig8
    shape (ResNet-18, ``stem_stride=2``, 16 x 512x512x3): one forward and
    backward for each of B, ED, SC, ED+SC, ED+SC+MP, peak device memory
    above the parameters and gradients;
14. ``kernel`` lines for the SSM slice: the flash forward at hymba's
    prefill shape (B=8, 25 / 5 heads of 64, S=2048, bf16; window 1024 and
    full causal), the SSD chunk kernel against its plain version at
    mamba2's and hymba's serve shapes, at Q=64 and for a single chunk
    (tolerance 1e-4 of max|y| and of max|state|; ``ops.ssd_route``'s
    design, the tensor-core ``ssd_sm90.cu`` at head_p 64, with a sweep of
    the heads a CTA walks; the FMA ``ssd.cu`` once, at head_p 16; bounds
    from the bytes and the operations at the rate of the route's units,
    three TF32 passes at 495 TFLOP/s or f32 at 67, the f32 bound beside
    as ``bound_fma_ms``), and the decode kernel's
    dense-bias entry point (splits 1 and 4) and its GQA group 5 on the
    lengths path at hymba's decode shape (tolerance 1e-5);
15. ``ssm_model``: a 2-layer mamba2 (N=128, P=64) and a 2-layer hymba
    (head_dim 64, group 5, window 64, global layer 0) at full width,
    prefill 256 tokens and decode 80 steps past the window, on the card
    (kernels) and on the CPU (plain versions), same weights: logits,
    conv / SSM / int8 K/V caches, greedy tokens;
16. ``serve_ssm``: ``launch/serve.py``'s lockstep at full width and a
    quarter of their depth (``SSM_CELL_LAYERS``: 6 and 8 layers) for
    mamba2-130m and hymba-1.5b (random bf16 weights, batch 8, prompt
    2048, 32 new tokens, int8 cache) after a one-step warm-up run, the
    launch counters zeroed just before each run and read just after, then
    ``torch.profiler`` over its prefill and its first 4 decode steps run
    again, the prefill's SSD op split by its profiler ranges;
17. ``kernel`` lines for the SSD chunk's backward (no TPU kernel: the JAX
    package differentiates ``ssd_chunk_ref``) against
    ``ref.ssd_chunk_bwd_ref``: ``ops.ssd_bwd_route``'s design, the
    tensor-core ``ssd_bwd_sm90.cu`` (one launch a call) at mamba2's and
    hymba's train shapes (batch 8 x 2048), the FMA ``ssd_bwd.cu`` at head_p
    16 at mamba2's train shape and at the smoke configs' widths: dc, db,
    dxbar, dacum within 1e-4 of the largest entry of each, run twice for
    determinism; bound from the bytes and the head-summed operations (the
    scores and dc / db once a (batch, chunk)) at the route's rate, three
    TF32 passes or f32, with the f32 bound and the per-head operation
    count beside;
18. ``ssm_train_model``: 2-layer mamba2 and hymba (window 64) at full
    width, policy full, the loss and every gradient on the card (the SSD
    chunk forward and its tensor-core backward, the FMA flash kernels)
    against the CPU, with the ``model`` line's tolerances and exact
    launches;
19. ``train_ssm``: mamba2-130m and hymba-1.5b at full width and
    ``SSM_CELL_LAYERS`` (6 / 8) layers through ``build_train_step``
    (random f32 masters, bf16, remat every block, AdamW, batch 8 x 2048):
    2 warm-up and 5 timed steps with the launch counters zeroed before and
    read after (``ssd_chunk_sm90`` 2 x L x 5, ``ssd_chunk_bwd_sm90`` L x
    5, hymba's flash forward 2 x L x 5 and delta / dQ / dKV L x 5, the FMA
    routes 0), one profiled step, then
    saved-after-forward bytes and the fwd+bwd peak under remat off and on
    (hymba at ``SSM_MEM_LAYERS`` layers);
20. ``two_tier``: the two-tier rolling cache against the uniform cache:
    a 2-layer hymba (window 64) decoding 160 greedy steps from an empty
    cache (tokens held by ``hold_to``, decode launches exact), and
    full-depth hymba at batch 8, s_max 4096: each cache's bytes against
    the arithmetic, to the byte, and ms/token over ``TWO_TIER_TIMED``
    (16) steps from position 0 and from 4079;
21. ``kernel`` lines for the MoE family and glm4-9b, each arch's
    attention heads (glm4-9b 32 / 2 of 128, G=16;
    deepseek-moe-16b 16 / 16 of 128, G=1; granite-moe-3b-a800m 24 / 8 of
    64, G=3): the flash forward and backward (bf16, the tensor-core
    designs) at the train shape B=1 x S=4096 with SDPA beside, and the
    decode kernel at B=8, S=2048, ragged lengths, splits 4 (lengths
    entry), each against its plain version and its ``tiling`` twin; then
    ``variant_kernels``, the seconds they took;
22. ``moe_model``: deepseek-moe-16b and granite-moe-3b-a800m at 1 layer
    (``MODEL_CHECK_LAYERS``) and full width, policy full, card against
    CPU from one set of weights
    (``bridge``): prefill logits and int8 caches, 4 decode steps, the
    loss with its ``moe_aux`` and every gradient (remat on every block,
    so each layer routes again in the backward), at the ``model`` line's
    tolerances; every routing call's top-k indices token for token (a
    differing choice must sit at a near-tie, the CPU's k-th and (k+1)-th
    probabilities within 2 f32 ulps; the count is reported either way)
    and its dropped assignments, which must be equal;
23. ``serve_variants``: glm4-9b, deepseek-moe-16b, granite-moe-3b-a800m
    and stablelm-12b (head_dim 160) at full width and an eighth of their
    depth (``SERVE_VARIANT_LAYERS``: 5 / 4 / 4 / 5 layers; random bf16
    weights from ``--seed``), one at a time, each freed before the
    next, served by ``ServeEngine`` as ``serve`` is (8 slots, ``max_len``
    2048, int8, ``kv_splits`` 4, the same 16-request trace): 16 of 16
    done, tok/s, TTFT, ITL, peak memory, and the launches counted exactly
    (one flash forward a layer an admission, one decode a layer a round);
    for the two MoE archs ``torch.profiler`` over ``MOE_PROFILE_ROUNDS``
    decode-only rounds (8 requests resident): device ms a round by the
    MoE FFN's ranges
    (``moe.router``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
    ``moe.shared``), the decode kernel and the GEMMs;
24. ``train_variants``: those four and minicpm3-4b at full width with
    depth cut (``VARIANT_TRAIN_LAYERS``: 4, 2, 4, 4 and 6 layers), as
    ``train`` runs (f32 masters, bf16, remat every block, AdamW, batch 1 x
    4096, 2 warm-up and 5 timed steps, launches exact: none for MLA), with
    ``moe_aux`` from one more forward, the peak, and the arithmetic that
    chose the depth (the ``train`` phase's bytes per parameter times each
    cut model's parameters);
25. ``kernel`` lines at head_dim 160, stablelm-12b's heads (32 / 8, G=4):
    the flash forward and backward (bf16, the tensor-core designs) at the
    train shape B=1 x S=4096 with SDPA beside and ragged (S=100; S=1000,
    kv_len 777), the FMA designs (f32, and bf16 residuals under f32
    compute) at S=1024 and windowed, the decode kernel's lengths entry at
    B=8, S=2048, ragged lengths, splits 4 and 1, and its dense-bias entry
    on a band of 1024 at serve_ssm's decode shape; then
    ``head160_kernels``, the seconds they took;
26. ``head160_model`` and ``mla_model``: stablelm-12b and minicpm3-4b cut
    to ``MODEL_CHECK_LAYERS`` (1) at full width, policy full, card against CPU from one set
    of weights: prefill logits and caches (int8 K/V; MLA's bf16 latents),
    4 lockstep decode steps, the loss and every gradient, at the
    ``model`` line's tolerances, the launches exact in each part (none
    for MLA: no kernel lies on the reference's MLA path);
27. ``serve_mla``: ``launch/serve.py``'s lockstep for minicpm3-4b at full
    width and an eighth of its depth (``MLA_SERVE_LAYERS``: 8 of 62 layers;
    batch 8, prompt 1024, 16 new tokens, bf16 latent
    cache) after a one-step warm-up, no kernel launched, then
    ``torch.profiler`` over its prefill and first 4 decode steps;
28. ``kernel`` lines for whisper-base and qwen2-vl-2b: the flash forward
    and backward (bf16, the tensor-core designs) at whisper's decoder
    heads (8 / 8 of 64, G = 1) at B=16 x S=448, its text context, with
    SDPA beside; the decode kernel's lengths entry at whisper's G = 1,
    D = 64 (B=16, 8 KV heads, S=512, ragged, splits 1 and 4) and at
    qwen2-vl's G = 6, D = 128 (B=8, 2 KV heads, S=2048, ragged, splits 4
    and 1); then ``encdec_vlm_kernels``, the seconds they took;
29. ``whisper_model`` and ``qwen2vl_model``: each cut to 1 decoder layer
    (whisper: 1 encoder layer too) at full width, policy full, card
    against CPU from one set of weights, as ``head160_model``: whisper on
    1500 frames a row, qwen2-vl with a 16-patch grid prefix and 3-stream
    positions whose streams differ; the loss's gradients include the
    encoder's and ``patch_proj``'s; launches exact (whisper: one flash
    forward a decoder layer, none for the encoder or the cross-attention;
    qwen2-vl: no flash kernel, one decode a layer a step);
30. ``serve_encdec``: ``launch/serve.py``'s lockstep for whisper-base at
    full depth (batch 16, 1500 frames of seeded normal values, prompt 64,
    192 new tokens, int8, bf16) after a one-step warm-up: prefill ms with
    the encoder, ms/token, tok/s, peak, launches exact (6 flash forwards,
    6 x 191 decodes), then ``torch.profiler`` over the prefill and 4
    decode steps: device ms of the encoder, the cross-attention, the
    decode kernel and the GEMMs, the idle share;
31. ``serve_variants`` for qwen2-vl-2b at 4 of its 28 layers (the serve
    cell's engine and trace: 16 of 16, no flash launch, one decode a
    layer a round) and
    ``train_variants`` for qwen2-vl-2b at ``QWEN_TRAIN_LAYERS`` (7) of its
    28 layers (batch 1 x 4096:
    a 32 x 32 patch prefix and 3-stream positions; no kernel) and
    whisper-base at 6 + 6 layers (batch 16 x 448, 1500 frames a row;
    the decoder's flash kernels only);
32. the ``{"kernels": [...]}`` summary (each row with its launches in
    ``serve_variants`` and ``train_variants`` by arch, in
    ``serve_encdec``, in ``train_dp`` (a) and each rank of (b), in
    ``train_tp`` (a)-(c), rank 0's, in ``moe_tp`` (a)-(d), rank 0's,
    in ``ssm_tp`` (a)-(h), rank 0's, and in ``serve_tp`` (b)-(e), rank
    0's, beside; the decode rows with
    ``serve_tp`` (a)'s partials times; the head_dim 160 rows apart, with
    stablelm-12b's launches), the ``nvidia-smi`` line, and last
    ``{"ok": true, "device": {...}}``.

Any failed check raises after the lines are printed, and the script exits
non-zero without the final ``ok`` line.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12,    # dense tensor cores
              "float32": 67e12}                       # f32 off the TCs
L2_FLUSH_BYTES = 256 * 2**20     # > the 50 MB L2
SLEEP_CYCLES = 2_000_000         # ~1 ms of device spin before each timing

FLASH_SRC = "src/repro_torch/kernels/csrc/flash_fwd.cu"
FLASH_SM90_SRC = "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu"
DECODE_SRC = "src/repro_torch/kernels/csrc/flash_decode.cu"
BWD_SRC = "src/repro_torch/kernels/csrc/flash_bwd.cu"
BWD_SM90_SRC = "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu"
FLASH_TPU = "src/repro/kernels/flash/kernel.py:175"
DECODE_TPU = "src/repro/kernels/kvq/kernel.py:163"
BWD_TPU = {"delta": "src/repro/kernels/flash/kernel.py:418",
           "dq": "src/repro/kernels/flash/kernel.py:434",
           "dkv": "src/repro/kernels/flash/kernel.py:478"}
TRAIN_LAYERS, TRAIN_SEQ = 4, 4096   # full width, depth cut to 4 layers
TRAIN_PLAN_STEPS = 3                # timed steps of each train_plan run
DRYRUN_PEAK_TOL = 0.10              # dryrun: predicted vs measured peak
DRYRUN_SLOTS, DRYRUN_LEN = 8, 2048  # dryrun (b): the decode step's cache
CE_CHUNK = 512                      # train_plan (h)'s chunk of the CE
#: cuBLAS / CUTLASS GEMM kernel names on Hopper (nvjet: cuBLAS 12.8's)
GEMM_NAME = re.compile(r"gemm|nvjet|xmma|cutlass", re.I)
PACK_SRC = "src/repro_torch/kernels/csrc/pack.cu"
PACK_TPU = {"decode": "src/repro/kernels/pack/kernel.py:44",
            "encode": "src/repro/kernels/pack/kernel.py:63"}
CIFAR_STEPS = 200
SSD_SRC = "src/repro_torch/kernels/csrc/ssd.cu"
SSD_SM90_SRC = "src/repro_torch/kernels/csrc/ssd_sm90.cu"
SSD_TPU = "src/repro/kernels/ssd/kernel.py:42"
SSM_PROMPT, SSM_GEN, SSM_BATCH = 2048, 32, 8   # the serve_ssm lockstep
# train_ssm's remat-off against remat-on memory: hymba at this depth
SSM_MEM_LAYERS = 8
# serve_ssm's and train_ssm's depth: a quarter of each arch's (full depth
# until the whole run needed room for ssm_tp, half until it needed room
# for ssm_tp (f)-(h) and serve_tp (e); hymba keeps global layer 0)
SSM_CELL_LAYERS = {"mamba2-130m": 6, "hymba-1.5b": 8}
# the two-tier cache: the 2-layer run's window and steps, the full run's
# s_max (its window stays hymba's 1024)
TWO_TIER_WINDOW, TWO_TIER_STEPS, TWO_TIER_SMAX = 64, 160, 4096
# two_tier (b)'s timed decode steps from each start (64 until the whole
# run needed room for train_tp, 32 until it needed room for moe_tp)
TWO_TIER_TIMED = 16
SSD_BWD_SRC = "src/repro_torch/kernels/csrc/ssd_bwd.cu"
SSD_BWD_SM90_SRC = "src/repro_torch/kernels/csrc/ssd_bwd_sm90.cu"
SSD_REF_JAX = "src/repro/kernels/ssd/ref.py:22"    # what JAX differentiates
# the fleet phase over the serve trace, 2 replicas of the serve engine (the
# schedule depends on the trace's lengths only, so these land as planned):
# (b)'s chaos plan is a replica_crash of replica 0 at router step 8 (2
# requests resident, 1 queued there) and a replica_slow of the survivor at
# step 19 for 3 steps, plus a nan_logits on the survivor's slot 0 at its
# engine step 20; (c) crashes at journal append 200 of the run's 444; (d)
# evicts after 6 steps; (e) SIGKILLs worker 1 at router step 6
FLEET_CHAOS = dict(seed=33, steps=40, n_events=2)
FLEET_NAN = (1, 20, 0)                  # (replica, engine step, slot)
FLEET_CRASH_AT = 200
FLEET_EVICT_AFTER = 6
FLEET_SIGKILL_STEP = 6
FLEET_SLOTS, FLEET_LEN = 8, 2048
# the fleet's depth: half the serve cell's 32 layers (all 32 until the
# whole run needed room for train_tp, moe_tp and ssm_tp at their
# sequences)
FLEET_LAYERS = 16
# serve_tp (e): the fleet on (1, 2), llama3-8b at TP_C_LAYERS layers in
# heads mode, bf16: 2 replicas under the serve CLI's chaos plan (--chaos-seed
# FLEET_TP_CHAOS), the journal crashed at append FLEET_CRASH_AT, then a
# recovery on the same engines; the unsharded fleet runs the same here
FLEET_TP_CHAOS = 0
# the replay gate (fleet (b)-(f)): a held stream equals the reference's
# or first leaves it at a near-tie within 2 bf16 ulps of the top logit
# in both runs (hold_to).  Where the held run replayed the request (a
# prefill over its prompt and first j tokens: a failover, a recovery, a
# migration, a NaN's replay) at a draw j > 0 at or before that first
# difference, the stream is held from there to its twin instead: the
# same replay made again on a fresh engine here (the prompt and the
# reference's first j tokens), decoded to the difference; it must equal
# the twin's or leave it at a near-tie as above (hold_replayed).  A
# replay reads the prompt's K / V whole where a decode reads the int8
# cache, so it moves a draw's scores: REPLAY_PREMISE_ULPS bounds that
# move, in bf16 ulps of the draw's top logit, on fleet_replay's draws
# and on every twin's replay draw.  It decides no token (the twins do):
# it refuses a replay that computes something else.  One H100 read 2
# ulps at most over 48 draws (PERF.md); the bound is twice that, and
# fleet_replay's planted replay, fed a wrong last token, must pass it
REPLAY_PREMISE_ULPS = 4
# the MoE family, glm4-9b (GQA groups 16, 1 and 3), stablelm-12b and
# minicpm3-4b and the depth train_variants cuts each to; the depths keep
# AdamW's peak near the train phase's (the arithmetic: its bytes per
# parameter, printed by the phase, times each cut model's parameters:
# 48.6 GB at stablelm's 4 layers, 42.7 GB at minicpm3's 24; minicpm3 at
# 12 since the whole run needed room for ssm_tp, granite and minicpm3 at
# half that since it needed room for ssm_tp (f)-(h) and serve_tp (e))
VARIANT_TRAIN_LAYERS = {"glm4-9b": 4, "deepseek-moe-16b": 2,
                        "granite-moe-3b-a800m": 4, "stablelm-12b": 4,
                        "minicpm3-4b": 6}
# head_dim 160 (stablelm-12b: 32 / 8 heads, G = 4) and MLA (minicpm3-4b)
HEAD160, MLA_ARCH = "stablelm-12b", "minicpm3-4b"
# the serve_mla lockstep (prompt 2048 and 32 new tokens until the whole
# run needed room for moe_tp) and its depth (minicpm3-4b's 62 layers until
# the whole run needed room for ssm_tp, 31 until it needed room for ssm_tp
# (f)-(h) and serve_tp (e), 16 until those were measured at their
# sequences)
MLA_BATCH, MLA_PROMPT, MLA_GEN = 8, 1024, 16
MLA_SERVE_LAYERS = 8
# whisper-base and qwen2-vl-2b: whisper's lockstep (batch, prompt, new
# tokens: 256 of its 448-token text context) and its train batch (16 x the
# 448-token context, 1500 frames a row); qwen2-vl's train sequence opens
# with a 32 x 32 patch grid (Sp = min(1024, S / 4), the reference's
# input_specs), and its model phase with a 4 x 4 one
WHISPER, QWEN = "whisper-base", "qwen2-vl-2b"
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = 16, 64, 192
WHISPER_CTX = 448
QWEN_GRID = 32
# train_variants' depth for qwen2-vl-2b (its 28 layers until the whole run
# needed room for ssm_tp, 14 until it needed room for ssm_tp (f)-(h) and
# serve_tp (e))
QWEN_TRAIN_LAYERS = 7
# the depth the card-vs-CPU phases of the variant archs (moe_model,
# head160_model, mla_model, whisper_model, qwen2vl_model) cut each model
# to (2 until the whole run needed room for ssm_tp; whisper's encoder too)
MODEL_CHECK_LAYERS = 1
MODEL_PHASE = {HEAD160: "head160_model", MLA_ARCH: "mla_model",
               WHISPER: "whisper_model", QWEN: "qwen2vl_model"}
# the train phase's peak when that phase did not run in this process
# (llama3-8b at 4 layers: 43.71 GB in every chip run since PR 12, NVIDIA
# H100 80GB HBM3 at 700 W)
TRAIN_PEAK_FALLBACK = 43.71e9
DP_BATCH, DP_SEQ, DP_STEPS = 2, 1024, 5   # train_dp (b): 2 ranks, one card
DP_JOIN_S = 300
TOP_N = 4                       # best scores the fleet records per draw
# profile: the profiled serve run (requests of 256 prompt tokens, new
# tokens each) and the decode-only window (engine steps, 8 resident);
# 8 / 16 / 8 until the whole run needed room for serve_tp
PROFILE_REQUESTS, PROFILE_NEW, PROFILE_WINDOW = 4, 8, 4
# cifar_train's profiled ED+SC+MP steps (30 before) and the decode-only
# rounds serve_variants profiles for an MoE arch (4 before)
CIFAR_PROFILE_STEPS, MOE_PROFILE_ROUNDS = 15, 2
# serve_variants' depth: an eighth of each arch's (full depth until the
# whole run needed room for train_tp, half until it needed room for
# ssm_tp, a quarter until it needed room for ssm_tp (f)-(h) and serve_tp
# (e); every check counts the layers it serves)
SERVE_VARIANT_LAYERS = {"glm4-9b": 5, "deepseek-moe-16b": 4,
                        "granite-moe-3b-a800m": 4, "stablelm-12b": 5,
                        "qwen2-vl-2b": 4}
# serve_tp: the teacher-forced runs (batch, prompt, decode steps), the
# decode kernel's splits (the serve cell's), (a)'s ragged lengths (rows
# 1 and 7 live in the first shard only), (b)'s depth, (d)'s depth cut
TP_BATCH, TP_PROMPT, TP_STEPS = 4, 128, 16
TP_SPLITS = 4
TP_LENGTHS = [1, 2048, 513, 1024, 7, 1500, 1025, 64]
# (c) at 4 layers since the whole run needed room for ssm_tp (its bound
# below stays the one derived at 8); (b) at 2 (4 until the whole run
# needed room for ssm_tp (f)-(h) and serve_tp (e))
TP_B_LAYERS, TP_C_LAYERS, GLM_TP_LAYERS = 2, 4, 2
TP_JOIN_S = 420
# the bounds of the teacher-forced logits (max |diff| over the unsharded
# run's max |logit|, the prefill's and every decode step's, from the
# rank's own cache and from its block of the unsharded run's): (b) f32,
# its prefill 1e-4 and its decode steps TP_B_DECODE (readings on one
# H100: 3.13e-6, and 1.74e-4 / 3.67e-4, an f32 reorder turned into whole
# int8 steps by the cache); (c) / (d) bf16, 3x the largest sound reading
# at these depths (0.013889 / 0.0071839, one H100 at 8 and 2 layers;
# the bf16 control, the unsharded run against the same weights at f32,
# reads 0.0185 / 0.0173 and the smallest planted fault 0.2535 / 0.3405,
# PERF.md)
TP_B_PREFILL, TP_B_DECODE = 1e-4, 1e-3
TP_BOUND_C, TP_BOUND_D = 3 * 0.013889, 3 * 0.0071839
# the planted faults each sharded run is read again under: the last
# rank's w_down partial dropped in the middle layer or in every layer,
# and (sequence mode) shard 0's softmax partials dropped from the merge
TP_FAULTS = ("w_down_mid", "w_down_all", "merge_drop0")
# train_tp: tensor-parallel training, ranks spawned on this card over gloo
# (--tp-train-child): (a) llama3-8b at full width, TPT_A_LAYERS layers,
# f32, 1 x TPT_A_SEQ, TPT_A_STEPS steps on (1, 2); (b) the train cell's
# llama3-8b at TPT_B_LAYERS layers, bf16, 1 x TPT_BC_SEQ, on (1, 2), its
# ranks started with (a)'s; then (c) glm4-9b at TPT_C_LAYERS of its 40
# layers, bf16, 1 x TPT_BC_SEQ, on (1, 4): (b) and (c) TPT_WARMUP
# warm-up and TPT_TIMED timed steps.  Each rank's peak is
# reckoned before its spawn from the train phase's bytes per parameter;
# a sub-phase whose ranks together pass TPT_FIT_BYTES is cut in depth
# (c) at 2 layers since the whole run needed room for ssm_tp (its bounds
# below stay the ones derived at 4 layers)
TPT_A_LAYERS, TPT_A_SEQ, TPT_A_STEPS = 2, 1024, 3
TPT_C_LAYERS = 2
# (b)'s depth and (b) and (c)'s sequence: the train cell's 4 layers at
# 1 x TRAIN_SEQ (4096) until the whole run needed room for moe_tp (gloo's
# host-staged reductions grow with the tokens; at 2 layers (b)'s
# unsharded run fits beside (a)'s ranks, which end before (b)'s allocate)
TPT_B_LAYERS, TPT_BC_SEQ = 2, 1024
TPT_WARMUP, TPT_TIMED = 1, 3
TPT_WINDOW = 8192       # vocab entries of each rank's embed / head block read
TPT_EXPERT_WINDOW = 8   # experts of each rank's expert block read (moe_tp)
TPT_JOIN_S = 420
TPT_FIT_BYTES = 76e9
# the gates: max |diff| over the unsharded run's, the losses and grad
# norms relative, every step; the step-1 gradients of the saved leaves
# (_tpt_leaves) over each leaf's largest |gradient|; (a) also the saved
# leaves after the steps over each leaf's largest |parameter|.  (a) f32:
# the f32 partials summed in another order.  (b) / (c) bf16: 3x the larger
# of the sound reading and the bf16 control (the unsharded run against
# the same weights at f32), from one H100's readings (PERF.md)
TPT_A_BOUNDS = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-4,
                "params": 1e-3, "params_floor": 1e-5}
# (a)'s parameters after the steps, two gates.  "params": the update's
# relative error in norm, |p - p_ref| / |p_ref - p_init| over each leaf's
# window (one H100: 4.32e-4), which the planted moment fault
# (nu_shifted) must break.  "params_floor": the largest |diff| over the
# leaf's largest |parameter|, over the entries whose step-1 gradient is
# at least TPT_A_GRAD_FLOOR of the leaf's largest.  AdamW's first steps
# move an entry by about lr x g / (|g| + eps), so an entry whose gradient
# sits at the f32 noise floor (the step-1 gradients agree to ~1e-5 of
# max) moves by a different fraction of lr in each run: the elementwise
# reading over every entry ("params_max", one H100: 1.42e-5 where 1e-5
# was predicted) and the step-1 |gradient| at its worst entry over the
# leaf's largest ("params_max_grad") are reported beside, ungated
TPT_A_GRAD_FLOOR = 1e-3
TPT_BOUNDS = {
    # (b) readings at 2 layers, 1 x 1024 (PR 30): sound 3.591e-5 /
    # 1.071e-4 / 0.01761, the bf16 control 5.362e-5 / 2.236e-4 / 0.02238
    "b": {"loss": 3 * 5.362e-5, "grad_norm": 3 * 2.236e-4,
          "grads": 3 * 0.02238},
    # (c) readings at 1 x 1024 (PR 30): sound 4.043e-5 / 3.206e-4 /
    # 0.01544, the control 7.045e-5 / 2.648e-4 / 0.02904
    "c": {"loss": 3 * 7.045e-5, "grad_norm": 3 * 3.206e-4,
          "grads": 3 * 0.02904}}
# the planted faults each sub-phase's first step is read again under:
# copy_to_model's backward sum dropped at the middle layer's FFN input;
# the vocab-parallel CE's sum of exp left unreduced on every rank; and
# (sequence mode) copy_to_model put on the replicated attention's input.
# (a) also runs its steps again under nu_shifted, every rank's AdamW
# second moment of each sharded leaf read one row off its parameter
# block, and reads the parameters after them
TPT_FAULTS = ("copy_mid_ffn", "ce_sum_unreduced", "copy_seq_attn",
              "nu_shifted")
# moe_tp: the MoE FFN over a model axis, ranks on this card over gloo as
# in train_tp and serve_tp, one sub-phase after another: (a) deepseek-
# moe-16b TP-experts, f32, 1 x MOE_TP_SEQ, MOE_TP_STEPS steps on (1, 2);
# (b) granite-moe-3b-a800m expert-parallel (expert_mode "ep": 10 of its
# 40 experts a rank), f32, likewise on (1, 4); (c) deepseek TP serving,
# bf16, on (1, 2): the serve cell's engine and trace and the teacher-forced
# steps; (d) granite EP serving, bf16, on (1, 4), teacher-forced.  Depths:
MOE_TP_LAYERS = {"a": 2, "b": 2, "c": 4, "d": 2}
# (1024 until the whole run needed room for ssm_tp)
MOE_TP_SEQ, MOE_TP_STEPS = 512, 3
# the gates of (a) and (b), f32 (train_tp (a)'s; the update-norm reading
# "params" is reported beside, ungated): losses and grad norms relative,
# step-1 gradients of the saved leaves over each leaf's largest, the
# parameters after the steps over the leaf's largest where the step-1
# gradient is at least TPT_A_GRAD_FLOOR of the leaf's largest
MOE_TP_BOUNDS = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-4,
                 "params_floor": 1e-5}
# (c) / (d) bf16: the teacher-forced logits' bounds, the prefill's and
# the decode steps', each 3x the larger of the sound reading and the bf16
# control (one H100, PERF.md PR 30; bf16 routing flips at random weights
# make both large): (c) prefill sound 0.08061, control 0.07015; decode
# sound 0.21526, control 0.24206; (d) prefill sound 0.11803, control
# 0.12214; decode sound 0.21122, control 0.25782
MOE_TP_BOUND_C = {"prefill": 3 * 0.08061, "decode": 3 * 0.24206}
MOE_TP_BOUND_D = {"prefill": 3 * 0.12214, "decode": 3 * 0.25782}
# the planted faults each sub-phase is read again under: the last rank's
# MoE partial left out of the sum at the middle layer; every rank's
# experts taken from offset 0; copy_to_model left off the combine weights
# (the router's gradient a rank's partial); copy_to_model put on the
# router's input (the aux's input gradient summed over the model axis)
MOE_TP_FAULTS = {"a": ("moe_partial_dropped", "combine_weights_unsummed",
                       "router_input_summed"),
                 "b": ("ep_offset_zero", "combine_weights_unsummed"),
                 "c": ("moe_partial_dropped",), "d": ("ep_offset_zero",)}
# moe_tp (c) / (d) read again at f32 (policy full), teacher-forced, at
# serve_tp (b)'s bounds (prefill 1e-4, decode 1e-3 of max: routing is
# exact at f32) on the prefill and the decode path (the decode steps from
# the unsharded run's cache), each planted fault beyond its bound by more
# than FAULT_MARGIN x
MOE_TP_F32_BOUNDS = {"prefill": TP_B_PREFILL, "decode": TP_B_DECODE}
MOE_TP_F32_LAYERS = {"c": 2, "d": 2}
FAULT_MARGIN = 10
# ssm_tp: the SSM mixers and the encoder over a model axis, ranks on this
# card over gloo as in moe_tp, all started together: (a) hymba-1.5b at 4
# layers (global layer 0, windowed 1-3), f32, 1 x SSM_TP_SEQ (past the
# 1024 window), on (1, 2) (sequence mode: 5 KV heads); (b) mamba2-130m at
# SSM_TP_LAYERS, f32, 1 x SSM_TP_SEQ, on (1, 4); (c) whisper-base at 6 + 6
# layers, f32, WHISPER_TP_BATCH x WHISPER_CTX, 1500 frames a row, on (1, 2)
# (heads mode); each SSM_TP_STEPS steps, gated as moe_tp (a); (d) f32
# serving, teacher-forced through make_serve_steps on (1, 2): hymba at 4
# layers, TP_BATCH x SSM_TP_PROMPT (the global layer decoding by length
# over a sequence-split cache, the windowed ones by the band's bias), and
# whisper at 6 + 6, TP_BATCH x WHISPER_TP_PROMPT, 1500 frames, the decode
# steps taking the encoder's output; TP_STEPS steps each, gated as
# moe_tp's f32 readings; (e) launch/serve.py's lockstep for mamba2-130m under
# torchrun, 2 ranks, --max-model 2, against a 1-rank run.  The GELU MLPs'
# biases are drawn from the seed (_seed_biases), so b2_per_rank shows
# ((b) at 6 of mamba2's 24 layers and (c) at 4 + 4 (24 and 6 + 6
# before) since the whole run needed room for (f)-(h))
SSM_TP_LAYERS = {"a": 4, "b": 6, "c": 4, "d_hymba": 4, "d_whisper": 6}
SSM_TP_SEQ, SSM_TP_STEPS, WHISPER_TP_BATCH = 2048, 3, 2
SSM_TP_PROMPT, WHISPER_TP_PROMPT = 1536, 64
SSM_TP_LOCKSTEP = ["--arch", "mamba2-130m", "--max-model", "2", "--batch",
                   "4", "--prompt-len", "256", "--gen", "16"]
SSM_TP_FAULTS = {"a": ("ffn_partial_dropped", "ssm_input_copied"),
                 "b": ("ssm_input_copied",),
                 "c": ("ffn_partial_dropped", "b2_per_rank",
                       "xattn_unreduced"),
                 "d_hymba": ("ffn_partial_dropped", "band_local_positions"),
                 "d_whisper": ("xattn_unreduced", "b2_per_rank")}
# ssm_tp (f)-(h), in the same spawn: (f) MLA training, minicpm3-4b at
# MLA_TP_LAYERS layers, f32, 1 x MLA_TP_SEQ, SSM_TP_STEPS steps on (1, 2)
# (q_b / kv_b / wo by its 40 heads), gated as (a); (g) MLA serving,
# minicpm3-4b at MLA_TP_LAYERS, TP_BATCH x MLA_TP_PROMPT through
# make_serve_steps on (1, 2), the latent cache split by sequence, gated at
# f32 latents as (d) (its bf16-latent reading reported); (h) the two-tier
# cache, hymba-1.5b at TWO_TIER_TP_LAYERS (global 0, windowed 1-3), f32,
# both tiers split by sequence on (1, 2) (5 KV heads): its cache built
# from the unsharded prefill of TP_BATCH x TWO_TIER_TP_PROMPT (the window
# tier the prompt's first 1024 slots), then TP_STEPS decode steps, whose
# rolling write wraps past slot 1024 across the ranks' blocks, against the
# unsharded two-tier decode at (d)'s decode bound
MLA_TP_LAYERS, MLA_TP_SEQ, MLA_TP_PROMPT = 4, 1024, 1024
TWO_TIER_TP_LAYERS, TWO_TIER_TP_PROMPT = 4, 1016
# the planted faults: the rope key, the latents or wo's partials without
# their collective (training), a latent written at its local slot on every
# rank (serving), the window's rolling write at the local slot
SSM_TP_FAULTS.update({
    "f": ("mla_rope_uncopied", "mla_wo_unreduced", "mla_latent_uncopied"),
    "g": ("mla_latent_local_positions",), "h": ("window_write_local",)})
# the reference for the baseline's accuracy: examples/cifar_optorch.py's
# train("baseline", *make_cifar_like(n=2048, seed=0), 200), the JAX
# package on the CPU: mean accuracy of its last 20 steps
JAX_CPU_BASELINE_ACC = 1.0
# the CPU threads of the model phase's reference: a fixed count, so its
# numbers do not follow the host's core count
MODEL_CPU_THREADS = 4


def _host_cpu() -> dict:
    """The host's CPU model and core count, read from /proc/cpuinfo."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    names = re.findall(r"^model name\s*:\s*(.*)$", text, re.M)
    return {"model": names[0] if names else None, "cores": os.cpu_count()}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def hold_to(ref: dict, recs: dict, got: dict, got_recs=None):
    """Hold token streams to a reference.  ``recs[(key, index)] = (top
    logit, the TOP_N best scores, their token ids)`` of the reference's
    draws, scores in logit units (``_record_scores``); ``got_recs`` the
    same of the held run where it ran in this process.  Per key:
    ``equal``; ``near_tie`` when the streams first differ at a draw where
    the reference's top-2 gap was within 2 bf16 ulps of its top logit, the
    held run's token is among the reference's scores within that much of
    its best, and -- where ``got_recs`` has the draw -- the reference's
    token is within 2 ulps of the held run's best too and the two runs'
    top logits agree within 2 ulps (a near-tie in both runs, on logits
    that agree); else ``diverged`` (a missing stream too).  Returns (the
    counts, the first differences, the top-logit drift between the runs
    over every draw both recorded up to a stream's first difference)."""
    counts = {"equal": 0, "near_tie": 0, "diverged": 0}
    firsts, drift = [], []
    nan = (float("nan"), [float("nan")] * TOP_N, [-1] * TOP_N)

    def within(rec, tok, tol):          # tok's score is near rec's best
        _, vals, ids = rec
        return tok in ids and vals[0] - vals[ids.index(tok)] <= tol

    for key, want in ref.items():
        have = got.get(key) or []
        n = min(len(want), len(have))
        i = next((j for j in range(n) if want[j] != have[j]), n)
        if got_recs is not None:
            drift += [abs(recs[(key, j)][0] - got_recs[(key, j)][0])
                      for j in range(min(i + 1, len(want)))
                      if (key, j) in recs and (key, j) in got_recs]
        if have == want:
            counts["equal"] += 1
            continue
        a = recs.get((key, i), nan)
        tol = 2 * bf16_ulp(a[0]) if a[0] == a[0] else 0.0
        first = {"key": key, "index": i, "top": a[0],
                 "gap": a[1][0] - a[1][1], "tol": tol}
        ok = i < n and first["gap"] <= tol and within(a, have[i], tol)
        if ok and got_recs is not None:
            b = got_recs.get((key, i), nan)
            first.update(got_top=b[0], got_gap=b[1][0] - b[1][1])
            ok = (b[0] == b[0] and within(b, want[i], 2 * bf16_ulp(b[0]))
                  and abs(a[0] - b[0]) <= tol)
        first["kind"] = kind = "near_tie" if ok else "diverged"
        counts[kind] += 1
        firsts.append(first)
    return counts, firsts, {"n": len(drift),
                            "n_nonzero": sum(d > 0 for d in drift),
                            "max": max(drift, default=None)}


def hold_replayed(ref: dict, recs: dict, got: dict, got_recs, replays,
                  twin):
    """:func:`hold_to` under the replay gate (``REPLAY_PREMISE_ULPS``).
    ``replays[key]``: the draws the held run re-prefilled ``key`` at (a
    replay); ``twin({key: (j, i)})`` makes each such replay again on a
    fresh engine (the prompt and ``ref[key][:j]``) and decodes it to draw
    ``i`` -> (the twins' streams, their draws' scores).  A stream first
    different from ``ref`` at draw ``i`` that was replayed at a draw ``j``
    (the last, 0 < j <= i) is held to its twin instead, up to ``i``:
    ``replayed`` where it equals it, ``replayed_near_tie`` where
    :func:`hold_to` calls the difference from the twin a near-tie, else
    ``diverged``; ``diverged`` too where the twin's draw ``j`` moved the
    top logit from the reference's by more than REPLAY_PREMISE_ULPS.  ->
    :func:`hold_to`'s (counts, first differences, drift)."""
    counts, firsts, drift = hold_to(ref, recs, got, got_recs)
    counts.update(replayed=0, replayed_near_tie=0)
    cases = {}
    for f in firsts:
        js = [j for j in replays.get(f["key"], ()) if 0 < j <= f["index"]]
        if js:
            cases[f["key"]] = (max(js), f["index"])
    if not cases:
        return counts, firsts, drift
    streams, twin_recs = twin(cases)
    for f in firsts:
        if f["key"] not in cases:
            continue
        key, (j, i) = f["key"], cases[f["key"]]
        held, vs, _ = hold_to({key: streams[key][:i + 1]},
                              {**recs, **twin_recs}, {key: got[key][:i + 1]},
                              got_recs)
        a, b = recs[(key, j)], twin_recs.get((key, j))
        moved = float("inf") if b is None else abs(a[0] - b[0]) \
            / bf16_ulp(a[0])
        kind = ("diverged" if held["diverged"]
                or moved > REPLAY_PREMISE_ULPS else
                "replayed" if held["equal"] else "replayed_near_tie")
        counts[f["kind"]] -= 1
        counts[kind] += 1
        f.update(kind=kind, replayed_at=j, replay_moved_ulps=moved,
                 vs_twin=vs[0] if vs else None)
    return counts, firsts, drift


class _Replays:
    """A ``Router`` event sink that keeps, of each failover and each
    recovery, the draw its replay re-prefills (the tokens emitted then):
    ``replays[gid]``, for ``hold_replayed`` where the replicas are
    subprocesses."""

    def __init__(self):
        self.replays: dict = {}

    def emit(self, kind: str, step=None, **fields) -> None:
        if kind in ("failover", "recover"):
            self.replays.setdefault(fields["gid"], set()).add(
                fields["emitted"])


def grid_positions(b: int, s: int, rows: int, cols: int):
    """(3, B, S) int32 M-RoPE positions: a rows x cols patch prefix (t = 0,
    h = row, w = col), then text on all three streams from the grid's
    largest position + 1.  The streams differ, so a wrong section order or
    stream would show."""
    import torch
    sp = rows * cols
    i = torch.arange(sp)
    grid = torch.stack([torch.zeros_like(i), i // cols, i % cols])
    text = (max(rows, cols) + torch.arange(s - sp)).expand(3, s - sp)
    return torch.cat([grid, text], dim=1)[:, None].expand(3, b, s) \
        .to(torch.int32).contiguous()


def live_pairs(s: int, *, causal: bool = True, window: int = 0,
               kv_len=None) -> int:
    """The (query, key) entries of one head that pass the attention mask
    (``flash/ref.py``'s ``_mask``): the work this run's inputs need."""
    kvl = s if kv_len is None else kv_len
    if not causal:
        return s * kvl
    return sum(max(0, min(i, kvl - 1) - (max(0, i - window + 1) if window
                                         else 0) + 1) for i in range(s))


class Smoke:
    def __init__(self, args):
        import torch
        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda", 0)
        self.failures: list[str] = []
        self.records: list[dict] = []
        self.variant_launches: dict = {}    # arch -> serve / train launches
        self.t0 = time.time()
        self._flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                      device=self.dev)

    # -- helpers -----------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize(self.dev)

    def record(self, obj: dict) -> dict:
        obj["elapsed_s"] = time.time() - self.t0      # since the phases began
        self.records.append(obj)
        emit(obj)
        if not obj.get("ok", True):
            self.failures.append(f"{obj.get('phase')}: {obj}")
        return obj

    def time_ms(self, fn, n: int = 25, warmup: int = 3) -> float:
        """Median device time of ``fn`` over ``n`` calls, L2 flushed
        before each (the serving path meets these operands cold)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self._flush_buf.zero_()
            # keep the card busy while the host enqueues fn, so the events
            # time device work and not Python dispatch
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    # -- phases ------------------------------------------------------------
    def check_flash(self, s: int, dtype, window: int = 0, *, b: int = 1,
                    h: int = 32, hkv: int = 8, d: int = 128,
                    arch: str | None = None) -> dict:
        """The flash forward against its plain version; by default at
        llama3-8b's heads (32 / 8 of 128), one row.  The kernel is the one
        ``ops.fwd_route`` names (``sm90``: flash_fwd_sm90.cu, ``fma``:
        flash_fwd.cu): the checked call must launch it and not the other
        design."""
        torch = self.torch
        from repro_torch.kernels.flash import ops, ref
        route = ops.fwd_route(dtype, d)
        designs = {"fma": ops.KERNEL, "sm90": ops.FWD_SM90}
        before = {r: k.launches for r, k in designs.items()}
        gen = torch.Generator(device=self.dev).manual_seed(s + window)
        q = torch.randn((b * h, s, d), generator=gen, device=self.dev,
                        dtype=dtype)
        k = torch.randn((b * hkv, s, d), generator=gen, device=self.dev,
                        dtype=dtype)
        v = torch.randn((b * hkv, s, d), generator=gen, device=self.dev,
                        dtype=dtype)
        o, m, l, cnt = ops.flash_attention_fwd(q, k, v, causal=True,
                                               window=window, counts=True)
        route_ok = all(k.launches - before[r] == int(r == route)
                       for r, k in designs.items())
        o_r, m_r, l_r = ref.flash_fwd_ref(q, k, v, causal=True,
                                          window=window)
        self.sync()
        err = float((o.float() - o_r.float()).abs().max())
        err_m = float((m - m_r).abs().max())
        err_l = float(((l - l_r).abs() / l_r).max())
        want = ops.expected_counts(s, window=window)
        counts_ok = cnt.cpu().tolist() == [want] * (b * h)
        # bf16: kernel and plain both sum in f32 from the same bf16 inputs
        # and each rounds o once to bf16; |o| < 4, so one bf16 ulp (2^-8
        # relative) bounds the gap; the sm90 kernel also rounds P to bf16
        # before P V (<= 2.2e-3 before o's rounding in the CPU emulation,
        # tests/test_torch_flash_fwd_sm90.py).  f32: summation order only.
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        ok = (err <= tol and err_m <= 1e-3 and err_l <= 1e-3 and counts_ok
              and route_ok)

        ms = self.time_ms(lambda: ops.flash_attention_fwd(
            q, k, v, causal=True, window=window))
        plain_ms = self.time_ms(lambda: ref.flash_fwd_ref(
            q, k, v, causal=True, window=window), n=20)
        q4, k4, v4 = (x.reshape(b, -1, s, d) for x in (q, k, v))
        library_ms = self.time_ms(lambda: self._sdpa(q4, k4, v4,
                                                     window=window))
        flops = 4 * b * h * d * live_pairs(s, window=window)
        es = q.element_size()
        nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * es \
            + 2 * b * h * s * 4
        dname = str(dtype).removeprefix("torch.")
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return self.record({
            "phase": "kernel", "name": "flash_fwd", "ok": ok, "arch": arch,
            "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                      "window": window, "dtype": dname},
            "route": route, "route_ok": route_ok,
            "max_abs_err": err, "tol": tol, "max_abs_err_m": err_m,
            "max_rel_err_l": err_l, "counts_ok": counts_ok,
            "counts_per_head": want, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes})

    def _sdpa(self, q, k, v, *, causal: bool = True, window: int = 0,
              kv_len=None):
        """``F.scaled_dot_product_attention`` on the same function: causal
        through ``is_causal``, a window or ``kv_len`` through a boolean
        ``attn_mask`` of the live (query, key) entries (``flash/ref.py``'s
        mask).  A yardstick only: the port never calls it."""
        import torch.nn.functional as F
        s = q.shape[-2]
        if window == 0 and kv_len is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        pos = self.torch.arange(s, device=q.device)
        ok = (pos[None, :] < (s if kv_len is None else kv_len)).expand(s, s)
        if causal:
            ok = ok & (pos[:, None] >= pos[None, :])
            if window > 0:
                ok = ok & (pos[:, None] - pos[None, :] < window)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=ok,
                                              enable_gqa=True)

    def check_flash_bwd(self, s: int, rdt, gdt, *, causal: bool = True,
                        window: int = 0, kv_len=None, b: int = 1,
                        h: int = 32, hkv: int = 8, d: int = 128,
                        arch: str | None = None) -> dict:
        """The three backward kernels (delta, dQ, dKV) against their plain
        versions on the same residuals, from the forward kernel; ``rdt``
        is the dtype of the saved q, k, v, o, ``gdt`` that of dO and of
        the gradients.  dQ and dKV are the kernels ``ops.bwd_route``
        names (``sm90``: flash_bwd_sm90.cu, ``fma``: flash_bwd.cu): the
        checked call must launch those and not the other design's.  By
        default at llama3-8b's heads (32 / 8 of 128), one row."""
        torch = self.torch
        from repro_torch.kernels.flash import ops, ref
        g = h // hkv
        route = ops.bwd_route(rdt, gdt, gdt, d)
        designs = {"fma": (ops.BWD_DQ, ops.BWD_DKV),
                   "sm90": (ops.BWD_DQ_SM90, ops.BWD_DKV_SM90)}
        before = {r: [k.launches for k in ks] for r, ks in designs.items()}
        gen = torch.Generator(device=self.dev).manual_seed(s + window + 7)
        q, k, v = (torch.randn((b * n, s, d), generator=gen, device=self.dev)
                   .to(rdt) for n in (h, hkv, hkv))
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        o, m, l = ops.flash_attention_fwd(q, k, v, **kw)
        do = torch.randn((b * h, s, d), generator=gen, device=self.dev).to(gdt)
        scale = d ** -0.5
        kvl = s if kv_len is None else kv_len
        dq, dk, dv, cq, ck = ops.flash_attention_bwd(
            q, k, v, o, m, l, do, grad_dtypes=(gdt,) * 3, counts=True, **kw)
        route_ok = all([k.launches - n for k, n in zip(ks, before[r])]
                       == [int(r == route)] * 2 for r, ks in designs.items())
        delta = ops._bwd_delta(o, do)
        pkw = dict(causal=causal, window=window, sm_scale=scale, kv_len=kvl)
        delta_r = ref.bwd_delta_ref(o, do)
        dq_r = ref.bwd_dq_ref(q, k, v, do, m, l, delta_r, dtype=gdt, **pkw)
        dk_r, dv_r = ref.bwd_dkv_ref(q, k, v, do, m, l, delta_r,
                                     dk_dtype=gdt, dv_dtype=gdt, **pkw)
        self.sync()
        # f32 gradients: summation order only; bf16 gradients: kernel and
        # plain both accumulate in f32 and each rounds once to bf16
        rel = 1e-4 if gdt == torch.float32 else 2e-2
        errs, tols = {}, {}
        for name, got, want in (("delta", delta, delta_r), ("dq", dq, dq_r),
                                ("dk", dk, dk_r), ("dv", dv, dv_r)):
            errs[name] = float((got.float() - want.float()).abs().max())
            tols[name] = rel * float(want.float().abs().max()) + 1e-6
        twin_q, twin_k = ops.expected_bwd_counts(s, g, **kw)
        counts_ok = (cq.cpu().tolist() == [twin_q] * (b * h)
                     and ck.cpu().tolist() == [twin_k] * (b * hkv))
        # keys at or past kv_len: exact zeros
        zeros_ok = kv_len is None or not (dk[:, kv_len:].any()
                                          or dv[:, kv_len:].any())
        ok = counts_ok and route_ok and zeros_ok \
            and all(errs[n] <= tols[n] for n in errs)

        args = (q, k, v, do, m, l, delta)
        ckw = dict(dtype=gdt, counts=False, **pkw)
        ms = {"delta": self.time_ms(lambda: ops._bwd_delta(o, do)),
              "dq": self.time_ms(lambda: ops._bwd_dq(*args, **ckw)),
              "dkv": self.time_ms(lambda: ops._bwd_dkv(*args, **ckw)),
              "total": self.time_ms(lambda: ops.flash_attention_bwd(
                  q, k, v, o, m, l, do, grad_dtypes=(gdt,) * 3, **kw))}
        pargs = (q, k, v, do, m, l, delta_r)
        plain_ms = {
            "delta": self.time_ms(lambda: ref.bwd_delta_ref(o, do), n=20),
            "dq": self.time_ms(lambda: ref.bwd_dq_ref(
                *pargs, dtype=gdt, **pkw), n=20),
            "dkv": self.time_ms(lambda: ref.bwd_dkv_ref(
                *pargs, dk_dtype=gdt, dv_dtype=gdt, **pkw), n=20),
            "total": self.time_ms(lambda: ref.flash_bwd_ref(
                q, k, v, o, m, l, do, grad_dtypes=(gdt,) * 3, **kw), n=20)}
        library_ms = None
        if rdt == gdt:             # SDPA takes one dtype
            library_ms = self._sdpa_bwd_ms(q, k, v, do, b, s, d, **kw)

        # bound: each input read once, each output written once; five
        # products over the live (q, k) entries for the whole backward
        # (QK^T and dO V^T recomputed, dS K, P^T dO, dS^T Q), 2 D flops
        # per entry each: three of them are dQ's, four dKV's (both
        # recompute QK^T and dO V^T)
        pairs = live_pairs(s, **kw) * b * h
        gemm = 2 * d * pairs
        er, eg = q.element_size(), do.element_size()
        qo = b * h * s * d
        kv = b * hkv * s * d
        rows = b * h * s * 4
        work = {"delta": (2 * qo, qo * (er + eg) + rows, "float32"),
                "dq": (3 * gemm, (qo + 2 * kv) * er + qo * eg + 3 * rows
                       + qo * eg, str(rdt)),
                "dkv": (4 * gemm, (qo + 2 * kv) * er + qo * eg + 3 * rows
                        + 2 * kv * eg, str(rdt)),
                "total": (5 * gemm, (2 * qo + 2 * kv) * er + qo * eg
                          + 2 * rows + (qo + 2 * kv) * eg, str(rdt))}
        bound_ms, bound_by = {}, {}
        for name, (flops, nbytes, dt) in work.items():
            t_ops = flops / PEAK_FLOPS[dt.removeprefix("torch.")] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ms[name] = max(t_ops, t_bytes)
            bound_by[name] = "operations" if t_ops >= t_bytes else "bytes"
        dname = lambda t: str(t).removeprefix("torch.")  # noqa: E731
        return self.record({
            "phase": "kernel", "name": "flash_bwd", "ok": ok, "arch": arch,
            "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                      "causal": causal, "window": window, "kv_len": kv_len,
                      "residual_dtype": dname(rdt),
                      "grad_dtype": dname(gdt)},
            "route": route, "route_ok": route_ok,
            "max_abs_err": errs, "tol": tols, "tol_rel": rel,
            "counts_ok": counts_ok, "zeros_past_kv_len": zeros_ok,
            "live_entries": pairs,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by})

    def _sdpa_bwd_ms(self, q, k, v, do, b, s, d, **mask) -> float:
        """The backward alone of ``scaled_dot_product_attention`` on the
        same inputs (a retained graph, ``torch.autograd.grad``)."""
        torch = self.torch
        q4, k4, v4 = (x.detach().reshape(b, -1, s, d).requires_grad_()
                      for x in (q, k, v))
        out = self._sdpa(q4, k4, v4, **mask)
        do4 = do.reshape(b, -1, s, d)
        return self.time_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), do4, retain_graph=True))

    def check_decode(self, splits: int, *, hkv: int = 8, g: int = 4,
                     d: int = 128, arch: str = "llama3-8b", b: int = 8,
                     s: int = 2048, lengths_list=None) -> dict:
        """The lengths entry point against its plain version at B=8,
        S=2048, ragged lengths (or ``b`` rows of ``s`` slots with
        ``lengths_list``); by default at llama3-8b's heads (8 KV heads,
        G=4, D=128)."""
        torch = self.torch
        from repro_torch.kernels import tiling
        from repro_torch.kernels.kvq import ops, ref
        if lengths_list is None:
            lengths_list = [1, 2048, 513, 512, 7, 1500, 1024, 64]
        gen = torch.Generator(device=self.dev).manual_seed(splits + 100 * g)
        q = torch.randn((b, hkv * g, d), generator=gen, device=self.dev)
        kq, ks = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        vq, vs = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        lengths = torch.tensor(lengths_list, dtype=torch.int32,
                               device=self.dev)
        out, cnt = ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths,
                                        splits=splits, counts=True)
        qg = q.reshape(b, hkv, g, d)
        sm = d ** -0.5
        if splits == 1:
            plain = lambda: ref.decode_attention_ref(  # noqa: E731
                qg, kq, ks, vq, vs, None, sm, lengths=lengths)
        else:
            plain = lambda: ref.decode_attention_splitk_ref(  # noqa: E731
                qg, kq, ks, vq, vs, sm, lengths=lengths, splits=splits)
        out_r = plain().reshape(b, hkv * g, d)
        self.sync()
        err = float((out - out_r).abs().max())
        twin = tiling.decode_tile_step_counts(s, lengths_list, splits=splits)
        want = [[row] * hkv for row in twin["counts"]]
        counts_ok = cnt.cpu().tolist() == want
        tol = 1e-4                 # f32 both; summation order only
        ok = err <= tol and counts_ok
        ms = self.time_ms(lambda: ops.decode_attention(
            q, kq, ks, vq, vs, lengths=lengths, splits=splits))
        plain_ms = self.time_ms(plain, n=20)
        live = sum(lengths_list)
        nbytes = hkv * live * (2 * d + 8) + q.numel() * 4 * 2 + b * 4
        flops = 4 * hkv * g * d * live
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return self.record({
            "phase": "kernel", "name": "flash_decode", "ok": ok,
            "arch": arch,
            "shape": {"B": b, "Hkv": hkv, "G": g, "D": d, "S": s,
                      "splits": twin["splits"], "lengths": lengths_list},
            **self._rate(nbytes, ms, max(t_ops, t_bytes)),
            "max_abs_err": err, "tol": tol, "counts_ok": counts_ok,
            "tiles_visited": twin["visited"] * hkv,
            "tiles_dense": twin["dense"] * hkv,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes})

    @staticmethod
    def _rate(nbytes: int, ms: float, bound_ms: float) -> dict:
        """The rate a decode line's bytes moved at, and its share of the
        byte bound."""
        return {"GBps": nbytes / (ms * 1e-3) / 1e9,
                "bound_share": bound_ms / ms}

    def check_decode_group(self, g: int, d: int, splits: int) -> dict:
        """The decode kernel at a GQA group no main path runs (6: G / GH
        head groups of CTAs), small, against its plain version;
        correctness only."""
        torch = self.torch
        from repro_torch.kernels import tiling
        from repro_torch.kernels.kvq import ops, ref
        b, hkv, s = 3, 2, 1024
        lengths_list = [1, 1024, 513]
        gen = torch.Generator(device=self.dev).manual_seed(g)
        q = torch.randn((b, hkv * g, d), generator=gen, device=self.dev)
        kq, ks = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        vq, vs = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        lengths = torch.tensor(lengths_list, dtype=torch.int32,
                               device=self.dev)
        out, cnt = ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths,
                                        splits=splits, counts=True)
        out_r = ref.decode_attention_ref(
            q.reshape(b, hkv, g, d), kq, ks, vq, vs, None, d ** -0.5,
            lengths=lengths).reshape(b, hkv * g, d)
        self.sync()
        err = float((out - out_r).abs().max())
        twin = tiling.decode_tile_step_counts(s, lengths_list, splits=splits)
        counts_ok = cnt.cpu().tolist() == [[row] * hkv
                                           for row in twin["counts"]]
        tol = 1e-5                 # f32 both; summation order only
        return self.record({
            "phase": "kernel", "name": "flash_decode", "timed": False,
            "ok": err <= tol and counts_ok
            and bool(torch.isfinite(out).all()),
            "shape": {"B": b, "Hkv": hkv, "G": g, "D": d, "S": s,
                      "splits": twin["splits"], "lengths": lengths_list},
            "max_abs_err": err, "tol": tol, "counts_ok": counts_ok})

    def check_model(self) -> dict:
        """A 2-layer model through prefill + decode and through the loss
        and its backward, on the card (kernels) and on the CPU (plain
        versions, MODEL_CPU_THREADS threads), same weights, f32 policy.
        Each side's prefill runs twice (the CPU's also on 1 thread) and
        the line records how far each repeats itself, the int8 caches'
        rounding steps that differ in each layer, and the host's CPU."""
        threads = self.torch.get_num_threads()
        self.torch.set_num_threads(MODEL_CPU_THREADS)
        try:
            return self._check_model()
        finally:
            self.torch.set_num_threads(threads)

    def _check_model(self) -> dict:
        import numpy as np
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.core.mixed_precision import Policy
        from repro_torch.models import bridge, transformer as tf
        cfg = dataclasses.replace(
            configs.get_config("llama3-8b"), n_layers=2, d_model=512,
            n_heads=4, n_kv=1, head_dim=128, d_ff=1024, vocab=1000)
        cpu = tf.init_params(cfg, self.args.seed, device="cpu")
        gpu = bridge.load_jax_params(cfg, bridge.export_params(cpu),
                                     device=self.dev)
        rng = np.random.default_rng(self.args.seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100))
                                  .astype(np.int32))
        pol = Policy.full()
        with torch.no_grad():
            want, aux_c = tf.forward(cpu, cfg, {"tokens": tokens},
                                     policy=pol, build_cache=True)
            got, aux_g = tf.forward(gpu, cfg, {"tokens": tokens.to(self.dev)},
                                    policy=pol, build_cache=True)
            live = slice(0, cfg.vocab)
            rel = lambda a, b: float(  # noqa: E731
                (a.cpu() - b).abs().max() / b.abs().max())
            prefill_err = rel(got[..., live], want[..., live])
            rerun = {
                "cpu": rel(tf.forward(cpu, cfg, {"tokens": tokens},
                                      policy=pol, build_cache=True)[0][
                                          ..., live],
                           want[..., live]),
                "card": rel(tf.forward(gpu, cfg, {"tokens": tokens.to(
                    self.dev)}, policy=pol, build_cache=True)[0][..., live],
                    got[..., live].cpu())}
            torch.set_num_threads(1)          # the same reference on 1
            rerun["cpu_1_thread"] = rel(tf.forward(
                cpu, cfg, {"tokens": tokens}, policy=pol,
                build_cache=True)[0][..., live], want[..., live])
            torch.set_num_threads(MODEL_CPU_THREADS)
            off_by_layer = {n: (aux_g["cache"][n].cpu().int()
                                - aux_c["cache"][n].int()).ne(0).flatten(1)
                            .sum(1).tolist() for n in ("k", "v")}
            cache_c = tf.grow_cache(aux_c["cache"], 1024)
            cache_g = {n: t.to(self.dev) for n, t in cache_c.items()}
            off = [int((aux_g["cache"][n].cpu().int()
                        - aux_c["cache"][n].int()).abs().gt(0).sum())
                   for n in ("k", "v")]
            off_frac = sum(off) / (2 * aux_c["cache"]["k"].numel())
            pos = torch.tensor([100, 60], dtype=torch.int32)
            cache_c["pos"], cache_g["pos"] = pos, pos.to(self.dev)
            decode_err = 0.0
            for _ in range(4):
                toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2,))
                                        .astype(np.int32))
                act = torch.tensor([True, True])
                lw, cache_c = tf.decode_step(cpu, cfg, cache_c, toks,
                                             policy=pol, active=act)
                lg, cache_g = tf.decode_step(gpu, cfg, cache_g,
                                             toks.to(self.dev), policy=pol,
                                             kvq_splits=2,
                                             active=act.to(self.dev))
                decode_err = max(decode_err, rel(lg[:, live], lw[:, live]))
        # training: loss_fn and its backward (remat on every block), the
        # flash backward kernels on the card, the plain versions on the CPU
        labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100))
                                  .astype(np.int32))
        losses = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, self.dev)):
            model.requires_grad_()
            loss, _ = tf.loss_fn(model, cfg, {"tokens": tokens.to(dev),
                                              "labels": labels.to(dev)},
                                 policy=pol, remat=CheckpointConfig())
            loss.backward()
            losses[name] = float(loss.detach())
        self.sync()
        loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        grads_c = dict(cpu.named_parameters())
        grad_err = max(
            float((p.grad.cpu() - grads_c[n].grad).abs().max()
                  / grads_c[n].grad.abs().max())
            for n, p in gpu.named_parameters())
        # f32 on both sides, summation order only; the gradients compound
        # it through two layers of backward
        ok = (prefill_err <= 1e-4 and decode_err <= 1e-3 and off_frac <= 1e-3
              and loss_err <= 1e-5 and grad_err <= 1e-3)
        return self.record({
            "phase": "model", "ok": ok, "cfg": {
                "n_layers": 2, "d_model": 512, "n_heads": 4, "n_kv": 1,
                "head_dim": 128, "vocab": 1000, "prompt": [2, 100]},
            "prefill_logits_rel_err": prefill_err, "prefill_tol": 1e-4,
            "int8_cache_off_by_one_frac": off_frac,
            "int8_cache_off_by_layer": off_by_layer,
            "prefill_rerun_rel_diff": rerun,
            "cpu_threads": MODEL_CPU_THREADS, "host_cpu": _host_cpu(),
            "decode_logits_rel_err": decode_err, "decode_tol": 1e-3,
            "loss": losses, "loss_rel_err": loss_err, "loss_tol": 1e-5,
            "grad_rel_err_max": grad_err, "grad_tol": 1e-3})

    def _serve_trace(self, cfg):
        """``cfg`` at full size (random bf16 weights from ``--seed``)
        served by ``ServeEngine`` (8 slots, ``max_len`` 2048, bf16, int8,
        ``kv_splits`` 4) over the serve trace (16 requests), after a
        warm-up, the serving kernels' launch counters zeroed just before
        the run and read just after.  Returns (the model, the engine, the
        trace, the launches, the line's fields with its checks)."""
        torch = self.torch
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.kvq import ops as kvq_ops
        from repro_torch.models import transformer
        from repro_torch.serve import (ServeEngine, kernel_launches,
                                       synthetic_trace)
        t0 = time.time()
        model = transformer.init_params(cfg, self.args.seed, device=self.dev,
                                        dtype=torch.bfloat16)
        self.sync()
        init_s = time.time() - t0
        engine = ServeEngine(model, cfg, max_slots=8, max_len=2048,
                             policy_name="bf16", quantized=True, kv_splits=4)
        t0 = time.time()
        engine.warmup()
        self.sync()
        warmup_s = time.time() - t0
        trace = synthetic_trace(16, seed=0, vocab=cfg.vocab, mean_prompt=256,
                                max_prompt=1024, mean_gen=32, max_gen=64)
        torch.cuda.reset_peak_memory_stats(self.dev)
        for kern in (flash_ops.KERNEL, flash_ops.FWD_SM90, kvq_ops.KERNEL,
                     kvq_ops.BIAS_KERNEL):
            kern.launches = 0
        t0 = time.time()
        summary = engine.run(trace)
        self.sync()
        wall = time.time() - t0
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated(self.dev)
        diag = summary["diagnostics"]
        tokens = [t for r in engine._requests_done for t in r.tokens]
        L = cfg.n_layers
        # M-RoPE (qwen2-vl): the prefill takes the plain attention, as the
        # reference's does, so no flash forward
        flash = cfg.mrope_sections is None
        checks = {
            "n_done": summary["n_done"] == len(trace),
            "no_faults": summary["n_faults"] == 0,
            "tokens_in_vocab": all(0 <= t < cfg.vocab for t in tokens),
            # one flash forward a layer an admission, one decode a layer a
            # round, on the tensor-core forward (policy bf16 at head_dim
            # 64 / 128) and the lengths entry only
            "flash_launches": launches["flash_fwd_sm90"]
            == L * diag["prefills"] * flash and diag["prefills"] > 0
            and launches["flash_fwd"] == 0,
            "decode_launches": launches["flash_decode"]
            == L * diag["decode_rounds"] > 0
            and launches["flash_decode_bias"] == 0,
            "no_slot_leak": engine.pool.occupancy == 0
            and engine.pool.allocs == engine.pool.frees,
            "not_stalled": not summary["stalled"],
            "fits": peak < 80e9,
        }
        return model, engine, trace, launches, {
            "ok": all(checks.values()), "checks": checks,
            "arch": cfg.arch_id, "n_layers": L, "d_model": cfg.d_model,
            "max_slots": 8, "max_len": 2048, "policy": "bf16",
            "kv_splits": 4, "n_requests": len(trace),
            "n_done": summary["n_done"], "n_faults": summary["n_faults"],
            "total_tokens": summary["total_tokens"],
            "n_steps": summary["n_steps"],
            "prefills": diag["prefills"],
            "decode_rounds": diag["decode_rounds"],
            "kernel_launches": launches, "wall_s": wall,
            "tokens_per_s": summary["tokens_per_s"],
            "ttft_mean_s": summary["ttft_mean_s"],
            "ttft_p95_s": summary["ttft_p95_s"],
            "itl_mean_s": summary["itl_mean_s"],
            "occupancy_mean": summary["occupancy_mean"],
            "max_memory_allocated_bytes": peak, "init_s": init_s,
            "warmup_s": warmup_s}

    def run_serve(self) -> dict:
        torch = self.torch
        from repro_torch import configs
        from repro_torch.models import transformer
        cfg = configs.get_config("llama3-8b")
        model, engine, trace, launches, fields = self._serve_trace(cfg)
        self.serve_launches = launches
        rec = self.record({
            "phase": "serve", **fields,
            "kv_pool_bytes": engine.pool.bytes_per_slot() * 8})
        self.profile_serve(engine, cfg)
        self.check_serve_budget(model, cfg, trace[:6],
                                engine.pool.bytes_per_slot())
        # the fleet at FLEET_LAYERS, its workers making their own weights:
        # free the serve cell first
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
        cfg_f = dataclasses.replace(cfg, n_layers=FLEET_LAYERS)
        model = transformer.init_params(cfg_f, self.args.seed,
                                        device=self.dev,
                                        dtype=torch.bfloat16)
        self.run_fleet(model, cfg_f, trace, dict(
            n_layers=FLEET_LAYERS, init_seed=self.args.seed))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        self.run_serve_tp(cfg)
        return rec

    # -- serving over a model axis (serve_tp) ------------------------------
    def check_decode_partials(self, n: int, *, hkv: int, g: int, d: int,
                              arch: str, bias: bool = False) -> dict:
        """The decode kernel's partials form (``decode_attention(
        partials=True)``) over ``n`` sequence shards of one cache, each
        shard's (o, m, l) merged in process by ``collectives
        .merge_partials`` (the collective's merge), against the unsharded
        kernel and the plain version.  Lengths: B 8, S 2048, ragged (rows
        1 and 7 live in shard 0 only), ``TP_SPLITS`` splits resolved on
        each shard's S / n; bias: hymba's row-5b shape (B 8, S 2080,
        window 1024 at the last slot: shard 0 lies outside every band).
        The kernel line times shard 0's call."""
        torch = self.torch
        from repro_torch.distributed.collectives import merge_partials
        from repro_torch.kernels import tiling
        from repro_torch.kernels.kvq import ops, ref
        from repro_torch.models import attention
        b = 8
        s = SSM_PROMPT + SSM_GEN if bias else 2048
        s_l = s // n
        gen = torch.Generator(device=self.dev).manual_seed(n + 7 * g)
        q = torch.randn((b, hkv * g, d), generator=gen, device=self.dev)
        kq, ks = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        vq, vs = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        if bias:
            _, mask = attention.decode_mask(
                torch.tensor(s - 2, dtype=torch.int32, device=self.dev), b,
                s, 1024)
            lens = [s] * b                  # every slot is read
            whole = dict(bias=mask)
            local = [dict(bias=mask[:, r * s_l:(r + 1) * s_l].contiguous())
                     for r in range(n)]
        else:
            lens = TP_LENGTHS
            lengths = torch.tensor(lens, dtype=torch.int32, device=self.dev)
            whole = dict(lengths=lengths)
            local = [dict(lengths=torch.clamp(lengths - r * s_l, 0, s_l)
                          .to(torch.int32)) for r in range(n)]
        shards = [[c[:, :, r * s_l:(r + 1) * s_l].contiguous()
                   for c in (kq, ks, vq, vs)] for r in range(n)]
        parts = [ops.decode_attention(q, *shards[r], splits=TP_SPLITS,
                                      partials=True, **local[r])
                 for r in range(n)]
        o, m, l = (torch.stack(t) for t in zip(*parts))
        got = merge_partials(o, m, l)
        unsharded = ops.decode_attention(q, kq, ks, vq, vs,
                                         splits=TP_SPLITS, **whole)
        qg = q.reshape(b, hkv, g, d)
        sm = d ** -0.5
        plain = ref.decode_attention_ref(
            qg, kq, ks, vq, vs, whole.get("bias"), sm,
            lengths=whole.get("lengths")).reshape(b, hkv * g, d)
        self.sync()
        err_whole = float((got - unsharded).abs().max())
        err_plain = float((got - plain).abs().max())
        # a shard past a row's length reads nothing and gives (0, NEG_INF,
        # 0); dropping it from the merge changes no bit
        dead_exact = True
        if not bias:
            for r in range(n):
                dead = (torch.tensor(lens, device=self.dev) <= r * s_l)
                if dead.any():
                    dead_exact &= bool(
                        (m[r][dead] == tiling.NEG_INF).all()
                        and (l[r][dead] == 0).all()
                        and (o[r][dead] == 0).all())
            for row in range(b):
                k = -(-lens[row] // s_l)
                dead_exact &= bool(torch.equal(
                    merge_partials(o[:k, row], m[:k, row], l[:k, row]),
                    got[row]))
        tol_whole, tol_plain = 1e-5, 1e-3
        ok = (err_whole <= tol_whole and err_plain <= tol_plain
              and dead_exact and bool(torch.isfinite(got).all()))
        ms = self.time_ms(lambda: ops.decode_attention(
            q, *shards[0], splits=TP_SPLITS, partials=True, **local[0]))
        plain_ms = self.time_ms(lambda: ref.decode_partials_ref(
            qg, *shards[0], local[0].get("bias"), sm,
            lengths=local[0].get("lengths")), n=20)
        merge_ms = self.time_ms(lambda: merge_partials(o, m, l))
        # shard 0's call: its live slots (every slot under a bias) of K
        # and V with their scales, q, the (o, m, l) it writes
        live = b * s_l if bias else sum(min(x, s_l) for x in lens)
        nbytes = hkv * live * (2 * d + 8) + q.numel() * 4 * 2 \
            + 2 * b * hkv * g * 4 + (b * s_l * 4 if bias else b * 4)
        flops = 4 * hkv * g * d * live
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return self.record({
            "phase": "kernel", "ok": ok, "arch": arch,
            "name": "flash_decode_bias_partials" if bias
            else "flash_decode_partials",
            "shape": {"B": b, "Hkv": hkv, "G": g, "D": d, "S": s,
                      "shards": n, "S_shard": s_l,
                      "splits": tiling.resolve_decode_grid(
                          s_l, splits=TP_SPLITS)[2],
                      "lengths": None if bias else lens,
                      "window": 1024 if bias else 0},
            "max_abs_err": err_plain, "tol": tol_plain,
            "err_vs_unsharded": err_whole, "tol_unsharded": tol_whole,
            "dead_shards_exact": dead_exact,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "merge_in_process_ms": merge_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            **self._rate(nbytes, ms, max(t_ops, t_bytes)),
            "flops": flops, "bytes": nbytes})

    def _spawn_tp(self, specs: list, tmp: str, flag: str = "--tp-child",
                  join_s: int = TP_JOIN_S, meanwhile=None) -> list:
        """For each (spec, world) of ``specs``, ``world`` ranks (the spec's
        ``flag``, else ``flag``: ``--tp-child`` or ``--tp-train-child``)
        on this card over gloo
        (NCCL takes one rank a device), all started together, then
        ``meanwhile()`` here while they start, each joined with a timeout
        and all killed if one fails; -> each spec's list of its ranks'
        result dicts."""
        groups = []
        try:
            for spec, world in specs:
                path = os.path.join(tmp, f"{spec['part']}.json")
                spec = dict(spec, world=world, rdv=os.path.join(
                    tmp, f"{spec['part']}.rdv"), out=os.path.join(
                    tmp, f"{spec['part']}.out"), seed=self.args.seed,
                    device=str(self.dev),
                    cfg=dataclasses.asdict(spec["cfg"]))
                pathlib.Path(path).write_text(json.dumps(spec))
                groups.append((spec, [subprocess.Popen(
                    [sys.executable, str(pathlib.Path(__file__).resolve()),
                     spec.get("flag", flag), f"{path},{r}"],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                    for r in range(world)]))
            if meanwhile is not None:
                meanwhile()
            for spec, procs in groups:
                for r, p in enumerate(procs):
                    out, _ = p.communicate(timeout=join_s)
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"{spec.get('flag', flag)} ({spec['part']}) "
                            f"rank {r} exited "
                            f"{p.returncode}:\n{out[-4000:]}")
        finally:
            for _, procs in groups:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
        return [[json.loads(pathlib.Path(f"{spec['out']}.{r}").read_text())
                 for r in range(spec["world"])] for spec, _ in groups]

    def _tp_reference(self, model, cfg, policy: str, tmp: str,
                      part: str, prompt: int = TP_PROMPT
                      ) -> tuple[str, dict | None]:
        """The unsharded teacher-forced run in this process (its own
        greedy tokens; an MoE's routing calls beside; an encoder arch on
        seeded normal frames, saved with it), TP_BATCH x ``prompt``,
        saved for the ranks; in bf16 also the bf16
        control: the same weights at f32 (policy ``full``) fed the same
        tokens, the bf16 run's logits against its.  -> (the file, the
        control's ``_tf_compare`` or None)."""
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed)
        prompts = torch.randint(0, cfg.vocab, (TP_BATCH, prompt),
                                generator=gen, device=self.dev,
                                dtype=torch.int32)
        frames = None if cfg.encoder is None else torch.randn(
            (TP_BATCH, cfg.encoder.n_frames, cfg.d_model), generator=gen,
            device=self.dev)
        routing = []
        with _routing_spy(routing, cfg.n_layers * (TP_STEPS + 1)
                          if cfg.moe is not None else 0):
            logits, tokens, cache = tp_forced(model, cfg, policy, prompts,
                                              frames=frames)
        path = os.path.join(tmp, f"{part}.ref.pt")
        torch.save({"prompts": prompts.cpu(), "tokens": tokens,
                    "logits": logits, "cache": cache, "routing": routing,
                    "frames": None if frames is None else frames.cpu()},
                   path)
        control = None
        if policy == "bf16":
            m32 = copy.deepcopy(model).float()
            logits32, _, _ = tp_forced(m32, cfg, "full", prompts,
                                       forced=tokens, frames=frames)
            del m32
            gc.collect()
            torch.cuda.empty_cache()
            control = {k: v for k, v in _tf_compare(logits, logits32).items()
                       if k in ("prefill_rel", "decode_rel", "max_rel")}
        return path, control

    @staticmethod
    def _unsharded(fields: dict, streams: dict) -> dict:
        """What ``serve_tp`` holds a sharded engine run against: the
        unsharded run's streams and host times (``_serve_trace``'s
        fields)."""
        return {"streams": streams, "itl_mean_s": fields["itl_mean_s"],
                "tokens_per_s": fields["tokens_per_s"],
                "round_host_ms": fields["wall_s"]
                / max(1, fields["n_steps"]) * 1e3}

    def _tp_unsharded(self, cfg, part: str, tmp: str) -> tuple:
        """(c)'s or (d)'s unsharded side here: ``cfg`` served by
        :meth:`_serve_trace`, then its teacher-forced run and bf16 control
        (:meth:`_tp_reference`), every device tensor freed after.  ->
        (the trace, what the engine run is held against, the reference
        file, the control)."""
        model, engine, trace, _, fields = self._serve_trace(cfg)
        unsharded = self._unsharded(fields, {
            str(r.rid): list(r.tokens) for r in engine._requests_done})
        del engine
        ref, control = self._tp_reference(model, cfg, "bf16", tmp, part)
        del model
        gc.collect()
        self.torch.cuda.empty_cache()
        return trace, unsharded, ref, control

    def run_serve_tp(self, cfg) -> dict:
        """Serving over a (data, model) mesh (see the module docstring,
        item 6c): (a) the decode kernel's partials form over sequence
        shards; (b) heads mode at f32 on (1, 2), llama3-8b (``cfg``) at
        ``TP_B_LAYERS`` layers, teacher-forced; (c) heads mode, llama3-8b
        at ``TP_C_LAYERS`` layers in bf16 on (1, 2): the serve cell's
        engine and trace and the teacher-forced logits; (d) sequence mode,
        glm4-9b at ``GLM_TP_LAYERS`` layers on (1, 4), likewise; (b)'s,
        (c)'s and (d)'s ranks at once.  The ranks are ``--tp-child`` processes
        on this card over gloo, which stages every reduction through the
        host: the times are a correctness run's, not tensor parallelism's
        speed."""
        torch = self.torch
        from repro_torch import configs
        t0 = time.time()
        llama = configs.get_config("llama3-8b")
        glm = configs.get_config("glm4-9b")
        part_a = [self.check_decode_partials(
                      2, hkv=llama.n_kv, g=llama.n_heads // llama.n_kv,
                      d=llama.head_dim, arch=llama.arch_id),
                  self.check_decode_partials(
                      4, hkv=glm.n_kv, g=glm.n_heads // glm.n_kv,
                      d=glm.head_dim, arch=glm.arch_id),
                  self.check_decode_partials(
                      2, hkv=5, g=5, d=64, arch="hymba-1.5b", bias=True)]
        self.tp_partials = part_a
        secs = {"a": time.time() - t0}
        tmp = tempfile.mkdtemp(prefix="serve_tp_")
        parts, checks = {}, {}
        try:
            tb = time.time()
            cfg_b, ref_b = self._serve_tp_b_reference(cfg, tmp)
            secs["b_ref"] = time.time() - tb
            # (c)'s and (d)'s unsharded runs: llama3-8b and glm4-9b cut to
            # TP_C_LAYERS and GLM_TP_LAYERS
            tc = time.time()
            cfg_c = dataclasses.replace(cfg, n_layers=TP_C_LAYERS)
            trace, unsharded_c, ref_c, control_c = self._tp_unsharded(
                cfg_c, "c", tmp)
            secs["c_ref"] = time.time() - tc
            td = time.time()
            cfg_d = dataclasses.replace(glm, n_layers=GLM_TP_LAYERS)
            trace_d, unsharded_d, ref_d, control_d = self._tp_unsharded(
                cfg_d, "d", tmp)
            secs["d_ref"] = time.time() - td
            te = time.time()
            fleet_e = self._fleet_tp_unsharded(cfg_c, tmp)
            secs["e_ref"] = time.time() - te
            # (b)'s and (c)'s two ranks (heads mode) and (d)'s four
            # (sequence mode) at once: eight processes share the card and
            # the host
            tcd = time.time()
            ranks_b, ranks_c, ranks_d, ranks_e = self._spawn_tp([
                (dict(part="b", cfg=cfg_b, policy="full", ref=ref_b,
                      engine=False), 2),
                (dict(part="c", cfg=cfg_c, policy="bf16", ref=ref_c,
                      engine=True), 2),
                (dict(part="d", cfg=cfg_d, policy="bf16", ref=ref_d,
                      engine=True), 4),
                (dict(part="e", cfg=cfg_c, policy="bf16", ref="",
                      engine=False, fleet=True), 2)], tmp)
            parts["b"] = self._tp_part(
                ranks_b, cfg_b, "full", engine=None,
                bounds={"prefill": TP_B_PREFILL, "decode": TP_B_DECODE})
            parts["c"] = self._tp_part(
                ranks_c, cfg_c, "bf16", engine=unsharded_c,
                n_req=len(trace),
                bounds={"prefill": TP_BOUND_C, "decode": TP_BOUND_C},
                control=control_c)
            parts["d"] = self._tp_part(
                ranks_d, cfg_d, "bf16", engine=unsharded_d,
                n_req=len(trace_d),
                bounds={"prefill": TP_BOUND_D, "decode": TP_BOUND_D},
                control=control_d)
            parts["e"] = self._fleet_tp_part(ranks_e, cfg_c, fleet_e)
            secs["b_c_d_e_ranks"] = time.time() - tcd
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        checks["a"] = all(r["ok"] for r in part_a)
        for p in parts:
            for k, v in parts[p].pop("checks").items():
                checks[f"{p}_{k}"] = v
        self.tp_launches = {p: parts[p]["launches_rank0"] for p in parts}
        return self.record({
            "phase": "serve_tp", "ok": all(checks.values()),
            "checks": checks, "partials": [
                {k: r[k] for k in ("name", "arch", "shape", "max_abs_err",
                                   "err_vs_unsharded", "dead_shards_exact",
                                   "kernel_ms", "plain_ms", "bound_ms")}
                for r in part_a],
            "b": parts["b"], "c": parts["c"], "d": parts["d"],
            "e": parts["e"],
            "gloo_note": "gloo stages every reduction through the host",
            "phase_seconds": secs, "seconds": time.time() - t0})

    def _fleet_tp_unsharded(self, cfg, tmp: str) -> dict:
        """``serve_tp`` (e)'s unsharded fleet here (:func:`fleet_tp_run`,
        no mesh; ``cfg`` in bf16 from ``--seed``), every device tensor
        freed after."""
        torch = self.torch
        from repro_torch.models import transformer
        model = transformer.init_params(cfg, self.args.seed, device=self.dev,
                                        dtype=torch.bfloat16)
        counters = self._all_counters()

        def zero():
            for k in counters.values():
                k.launches = 0
        out = fleet_tp_run(model, cfg, None, os.path.join(tmp, "e_ref.jsonl"),
                           self.args.seed, zero, lambda: {
                               n: k.launches for n, k in counters.items()},
                           self.sync)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def _fleet_tp_part(self, ranks: list, cfg, ref: dict) -> dict:
        """``serve_tp`` (e)'s ranks against the unsharded fleet: every
        request done and reconciled with the journal, no slot leak, the
        crash landed and every request live at it recovered, the ranks'
        streams and decision digests equal (at the crash and at the end),
        launches a rank exact (the tensor-core forward once a layer an
        admission, the decode kernel once a layer a round), and rank 0's
        streams held to the unsharded fleet's, equal or first different
        at a near-tie within 2 bf16 ulps in both (``hold_to``): the two
        fleets decide alike, so they replay at the same draws."""
        fl = [r["fleet"] for r in ranks]
        recs = lambda f: {(k, i): (t, v, ids)      # noqa: E731
                          for k, i, t, v, ids in f["recs"]}
        key = lambda f: {int(g): t for g, t in f["streams"].items()}  # noqa
        held, firsts, drift = hold_to(key(ref), recs(ref), key(fl[0]),
                                      recs(fl[0]))
        L = cfg.n_layers
        want = {k: 0 for k in fl[0]["launches"]}
        want["flash_fwd_sm90"] = L * fl[0]["prefills"]
        want["flash_decode"] = L * fl[0]["decode_rounds"]
        checks = {
            "all_done": all(len(f["streams"]) == f["n_requests"]
                            for f in fl),
            "crashed_and_recovered": all(
                f["crashed"] and f["n_live_at_crash"] > 0
                and f["recovered"] == f["n_live_at_crash"] for f in fl),
            "reconcile": all(f["reconcile"] for f in fl),
            "no_slot_leak": all(f["leak_free"] for f in fl),
            "ranks_same_streams": all(f["streams"] == fl[0]["streams"]
                                      for f in fl),
            "ranks_same_decisions": all(f["digests"] == fl[0]["digests"]
                                        for f in fl),
            "launches": all(f["launches"] == want for f in fl)
            and fl[0]["prefills"] > 0 and fl[0]["decode_rounds"] > 0,
            "tokens_held": held["diverged"] == 0,
            "fits": max(r["peak"] for r in ranks) < 80e9}
        return {"arch": cfg.arch_id, "layers": L, "policy": "bf16",
                "world": len(ranks), "mode": ranks[0]["mode"],
                "chaos_seed": FLEET_TP_CHAOS, "crash_after_appends":
                FLEET_CRASH_AT, "crash_router_step":
                fl[0]["crash_router_step"],
                "live_at_crash": fl[0]["n_live_at_crash"],
                "injected": fl[0]["injected"],
                "failovers": fl[0]["failovers"],
                "decisions": fl[0]["decisions"],
                "digests_equal_unsharded": fl[0]["digests"]
                == ref["digests"],
                "tokens_vs_unsharded": held, "first_differences": firsts,
                "top_logit_drift": drift, "gate": "2 bf16 ulps",
                "prefills": fl[0]["prefills"],
                "decode_rounds": fl[0]["decode_rounds"],
                "launches_rank0": fl[0]["launches"],
                "expected_launches": want,
                "unsharded_launches": ref["launches"],
                "wall_s": [f["wall_s"] for f in fl],
                "unsharded_wall_s": ref["wall_s"],
                "max_memory_allocated_bytes": [r["peak"] for r in ranks],
                "checks": checks}

    def _serve_tp_b_reference(self, cfg, tmp: str) -> tuple:
        """``serve_tp`` (b)'s config (``cfg`` at ``TP_B_LAYERS`` layers,
        f32) and its unsharded teacher-forced run's file, every device
        tensor freed after."""
        torch = self.torch
        from repro_torch.models import transformer
        cfg_b = dataclasses.replace(cfg, n_layers=TP_B_LAYERS)
        m_b = transformer.init_params(cfg_b, self.args.seed, device=self.dev,
                                      dtype=torch.float32)
        ref_b, _ = self._tp_reference(m_b, cfg_b, "full", tmp, "b")
        del m_b
        gc.collect()
        torch.cuda.empty_cache()
        return cfg_b, ref_b

    def _tp_part(self, ranks: list, cfg, policy: str, engine: dict | None,
                 n_req: int = 0, *, bounds: dict, control=None,
                 margin: float = 0.0, gate_own_cache: bool = True) -> dict:
        """One sub-phase's ranks against the unsharded run: launches,
        memory, streams, host times, teacher-forced logits (``bounds``:
        the prefill's and the decode steps' limits), the planted faults
        (each beyond the decode bound or the prefill's; with ``margin``,
        beyond it by more than that factor), the bf16 control beside.  At
        f32 each rank's int8 prefill cache must also be within one step of
        its block of the unsharded one, and the greedy tokens equal.
        ``gate_own_cache`` False gates the decode steps (and their greedy
        tokens) from the unsharded run's cache only -- the decode path --
        and reports those from the rank's own cache: there the one-step
        int8 differences the cache gate allows (an f32 reorder at a
        rounding boundary) compound over the steps, and an MoE's routing
        can flip at them."""
        from repro_torch.kernels.flash import ops as flash_ops
        L = cfg.n_layers
        fwd = "flash_fwd_sm90" if cfg.mla is None and flash_ops.fwd_route(
            self.torch.bfloat16 if policy == "bf16" else self.torch.float32,
            cfg.head_dim) == "sm90" else "flash_fwd"
        out = {"arch": cfg.arch_id, "layers": L, "policy": policy,
               "world": len(ranks), "mode": ranks[0]["mode"],
               "max_memory_allocated_bytes": [r["peak"] for r in ranks],
               "launches_rank0": (ranks[0].get("engine")
                                  or ranks[0]["tf"])["launches"]}
        checks = {}
        tf = [r["tf"] for r in ranks if r.get("tf")]
        if tf:
            out["tf"] = {
                # the prefill's logits (no cache read), the decode steps'
                # from the unsharded run's prefill cache, and the decode
                # steps' from this rank's own cache
                "prefill_rel": max(t["prefill_rel"] for t in tf),
                "decode_rel_ref_cache": max(t["from_ref_cache"]["decode_rel"]
                                            for t in tf),
                "decode_rel_own_cache": max(t["decode_rel"] for t in tf),
                "max_abs": max(t["max_abs"] for t in tf),
                "greedy_equal_steps": min(t["greedy_equal"] for t in tf),
                "greedy_equal_steps_ref_cache": min(
                    t["from_ref_cache"]["greedy_equal"] for t in tf),
                "first_diff_top2_gap": tf[0]["first_diff_gap"],
                "cache_vs_unsharded": [t["cache"] for t in tf],
                "launches": [t["launches"] for t in tf],
                "ranks_agree": all(t["digest"] == tf[0]["digest"]
                                   for t in tf)}
            want = _serve_want(cfg, policy, tf[0]["launches"])
            checks["launches"] = all(t["launches"] == want for t in tf)
            checks["tf_ranks_agree"] = out["tf"]["ranks_agree"]
            # the logits gates: the prefill's, and the decode steps' from
            # the rank's own cache and from the unsharded run's
            t = out["tf"]
            checks["prefill_within_bound"] = \
                t["prefill_rel"] <= bounds["prefill"]
            checks["decode_within_bound"] = max(
                t["decode_rel_own_cache"] if gate_own_cache else 0.0,
                t["decode_rel_ref_cache"]) <= bounds["decode"]
            out["own_cache_gated"] = gate_own_cache
            if policy == "full" and cfg.mla is not None:
                # the bf16 latents within one rounding step of the
                # unsharded run's and the prefill's bound beyond it, 1 / n
                # a rank; greedy equal from the unsharded run's cache
                checks["latents_within_bound"] = all(
                    max(c["mla_lat_excess_rel"], c["mla_rope_excess_rel"])
                    <= bounds["prefill"] for c in t["cache_vs_unsharded"])
                checks["latents_split"] = all(
                    c["latent_bytes"] * len(ranks)
                    == c["unsharded_latent_bytes"]
                    for c in t["cache_vs_unsharded"])
                checks["greedy_equal"] = \
                    t["greedy_equal_steps_ref_cache"] == TP_STEPS + 1
            elif policy == "full":
                checks["cache_within_one_step"] = all(
                    c["k_int8_max_steps"] <= 1 and c["v_int8_max_steps"] <= 1
                    for c in t["cache_vs_unsharded"])
                checks["greedy_equal"] = TP_STEPS + 1 == (
                    t["greedy_equal_steps"] if gate_own_cache
                    else t["greedy_equal_steps_ref_cache"])
            out["bounds"] = bounds
            out["bf16_control"] = control
            if "tf_bf16" in ranks[0]:
                out["bf16_ungated"] = {
                    k: (min if k == "greedy_equal" else max)(
                        r["tf_bf16"][k] for r in ranks)
                    for k in ranks[0]["tf_bf16"]}
            if "routing" in tf[0]:
                # bf16: reported, not gated (a bf16 partial sum moves the
                # router's input by more than its f32 near-ties)
                out["routing"] = _routing_summary(
                    tf, tf[0]["routing"]["ref_kept"],
                    ep=cfg.moe.expert_mode == "ep",
                    key=lambda t: t["routing"])
            faults = [r["faults"] for r in ranks]
            out["faults"] = faults[0]
            for f in faults[0]:
                # a fault the gates refuse: some step beyond its bound
                checks[f"fault_{f}_refused"] = all(
                    x[f]["prefill_rel"] > bounds["prefill"]
                    or x[f]["decode_rel"] > bounds["decode"]
                    for x in faults)
                if margin:
                    checks[f"fault_{f}_beyond_{margin:g}x"] = all(
                        max(x[f]["prefill_rel"] / bounds["prefill"],
                            x[f]["decode_rel"] / bounds["decode"]) > margin
                        for x in faults)
        if engine is not None:
            e0 = ranks[0]["engine"]
            want = {k: 0 for k in e0["launches"]}
            want[fwd] = L * e0["prefills"]
            want["flash_decode"] = L * e0["decode_rounds"]
            same = sum(e0["streams"].get(k) == v
                       for k, v in engine["streams"].items())
            out["engine"] = {
                "n_done": [r["engine"]["n_done"] for r in ranks],
                "n_faults": [r["engine"]["n_faults"] for r in ranks],
                "prefills": e0["prefills"],
                "decode_rounds": e0["decode_rounds"],
                "launches": [r["engine"]["launches"] for r in ranks],
                "wall_s": [r["engine"]["wall_s"] for r in ranks],
                "tokens_per_s": e0["tokens_per_s"],
                "itl_mean_s": e0["itl_mean_s"],
                "round_host_ms": e0["round_host_ms"],
                "unsharded": {k: engine[k] for k in
                              ("tokens_per_s", "itl_mean_s",
                               "round_host_ms")},
                "streams_equal_unsharded": same,
                "n_streams": len(engine["streams"])}
            checks.update({
                "all_done": all(r["engine"]["n_done"] == n_req
                                for r in ranks),
                "no_faults": all(r["engine"]["n_faults"] == 0
                                 for r in ranks),
                "pool_audit_clean": all(r["engine"]["audit_clean"]
                                        for r in ranks),
                "ranks_same_streams": all(r["engine"]["streams"]
                                          == e0["streams"] for r in ranks),
                "engine_launches": all(r["engine"]["launches"] == want
                                       for r in ranks),
                "fits": max(r["peak"] for r in ranks) < 80e9})
        out["checks"] = checks
        return out

    def check_serve_budget(self, model, cfg, trace, bytes_per_slot) -> dict:
        """``ServeEngine(mem_budget_bytes=)`` at 5.5 slots of llama3-8b's
        int8 cache at ``max_len`` 2048, 8 slots asked for: the capacity
        report must admit 5; a pool of 5 slots must take exactly 5 x
        ``bytes_per_slot`` of device memory beside its (5,) int32 ``pos``
        lengths; and ``trace`` (6 requests) must finish with never more
        than 5 resident."""
        torch = self.torch
        from repro_torch.serve import ServeEngine, SlotPool
        budget = int(5.5 * bytes_per_slot)
        gc.collect()
        self.sync()
        base = torch.cuda.memory_allocated(self.dev)
        pos = torch.zeros((5,), dtype=torch.int32, device=self.dev)
        pos_block = torch.cuda.memory_allocated(self.dev) - base
        del pos
        base = torch.cuda.memory_allocated(self.dev)
        pool = SlotPool(cfg, 5, 2048, device=self.dev)
        pool_bytes = torch.cuda.memory_allocated(self.dev) - base - pos_block
        del pool
        engine = ServeEngine(model, cfg, max_slots=8, max_len=2048,
                             policy_name="bf16", quantized=True, kv_splits=4,
                             mem_budget_bytes=budget)
        resident = []
        engine.hooks["pre_decode"] = \
            lambda e: resident.append(e.scheduler.resident)
        summary = engine.run(trace)
        self.sync()
        cap = engine.capacity_report
        checks = {
            "max_slots_5": cap["max_slots"] == 5
            and engine.pool.max_slots == 5,
            "pool_bytes_exact": pool_bytes == 5 * bytes_per_slot,
            "report_bytes_per_slot": cap["bytes_per_slot"] == bytes_per_slot,
            "n_done_6": summary["n_done"] == len(trace) == 6,
            "never_more_than_5": max(resident) <= 5,
        }
        return self.record({
            "phase": "serve_budget", "ok": all(checks.values()),
            "checks": checks, "budget_bytes": budget,
            "bytes_per_slot": bytes_per_slot,
            "bytes_per_slot_arithmetic": cfg.n_layers * cfg.n_kv * 2048
            * (2 * cfg.head_dim + 2 * 4),
            "capacity_report": cap, "pool_5_bytes": pool_bytes,
            "pos_block_bytes": pos_block, "max_resident": max(resident),
            "n_done": summary["n_done"],
            "tokens_per_s": summary["tokens_per_s"]})

    # -- the fault-tolerant fleet -------------------------------------------
    def _fleet_engines(self, model, cfg, n: int = 2, **extra) -> list:
        """``n`` warmed engines of the serve phase's configuration in
        request-key mode, on one shared model, with the fleet's buckets
        (``launch/serve.py``: a ``max_len`` bucket so a replay fits)."""
        from repro_torch.launch.serve import _fleet_buckets
        from repro_torch.serve import ServeEngine
        out = [ServeEngine(model, cfg, max_slots=FLEET_SLOTS,
                           max_len=FLEET_LEN,
                           prompt_buckets=_fleet_buckets(FLEET_LEN),
                           policy_name="bf16", quantized=True, kv_splits=4,
                           sampler_keys="request", seed=self.args.seed,
                           **extra) for _ in range(n)]
        for e in out:
            e.warmup()
        return out

    @staticmethod
    def _fresh(engines) -> list:
        for e in engines:
            e.reset()
            e.hooks.clear()
            e.tracer = None
        return engines

    @contextlib.contextmanager
    def _record_scores(self, engines, vocab: int, out: dict,
                       temperature: float = 0.0, replays=None):
        """Record through the engines' ``post_logits`` hook, for every
        token they draw, its logits' top value and the ``TOP_N`` best
        sampling scores with their token ids into ``out[(key_id,
        index)]``, in logit units (scores times T when sampling): the
        first token's from the prefill, the rest from each decode round.
        A later draw of the same token (a replay) replaces an earlier one;
        ``replays[key_id]`` (when given) gathers the draws a prefill made
        past the first (a replay's, ``hold_replayed``).  The values stay
        on the device until the run ends, so recording adds a top-k a
        draw and no host sync."""
        kept: list = []
        scale = temperature if temperature > 0.0 else 1.0

        def hook(e, logits, scores, rows):
            vals, ids = scores[..., :vocab].topk(TOP_N, dim=-1)
            # a prefill draws one row, a decode round every slot's
            kept.append(({r: (q.key_id, len(q.tokens))
                          for r, q in rows.items()},
                         logits[..., :vocab].amax(-1), vals, ids,
                         logits.shape[0] == 1 < e.pool.max_slots))

        for e in engines:
            e.hooks["post_logits"] = hook
        try:
            yield
        finally:
            for e in engines:
                e.hooks.pop("post_logits", None)
        for rows, top, vals, ids, prefill in kept:
            top = top.float().tolist()
            vals = (vals.double() * scale).tolist()
            ids = ids.tolist()
            for r, key in rows.items():
                out[key] = (top[r], vals[r], ids[r])
                if replays is not None:
                    got = replays.setdefault(key[0], set())
                    (got.add if prefill and key[1] else got.discard)(key[1])

    @staticmethod
    def _rates(summary: dict, hists: dict) -> dict:
        """Tokens/s and goodput from a ``fleet_summary``; TTFT and ITL
        means from the replicas' merged registry histograms."""
        mean = lambda h: h["sum"] / h["n"] if h.get("n") else None  # noqa: E731
        return {"tokens_per_s": summary["tokens_per_s"],
                "goodput_tokens_per_s": summary["goodput_tokens_per_s"],
                "ttft_mean_s": mean(hists.get("serve.ttft_s", {})),
                "itl_mean_s": mean(hists.get("serve.itl_s", {}))}

    def _fleet_counts(self, router, summary: dict, wall: float,
                      launches: dict, engines) -> dict:
        """One sub-phase's numbers: the fleet summary's rates, the fleet's
        TTFT / ITL means from the merged registries, the router's ledger
        and the launch counts beside what the engines' prefills and
        decode rounds predict."""
        fleet = summary["fleet"]
        return {
            "wall_s": wall,
            **self._rates(summary, router.registry_snapshot()["hists"]),
            "n_done": fleet["n_done"], "n_failed": fleet["n_failed"],
            "failovers": fleet["failovers"],
            "n_migrations": fleet["n_migrations"],
            "replay_success_rate": fleet["replay_success_rate"],
            "health": summary["health"], "kernel_launches": launches,
            "prefills": sum(e.n_prefills for e in engines),
            "decode_rounds": sum(e.n_decode_rounds for e in engines)}

    def _launches_follow(self, rec: dict, n_layers: int,
                         prefills=None, rounds=None) -> bool:
        """Every prefill ran the tensor-core forward once a layer and every
        decode round the decode kernel once a layer, and nothing else."""
        got = rec["kernel_launches"]
        p = rec["prefills"] if prefills is None else prefills
        r = rec["decode_rounds"] if rounds is None else rounds
        return (got["flash_fwd_sm90"] == n_layers * p > 0
                and got["flash_decode"] == n_layers * r > 0
                and got["flash_fwd"] == got["flash_decode_bias"] == 0)

    def _replay_drift(self, engine, cfg, prompts: dict,
                      lengths: dict) -> dict:
        """What a replay does to a draw: every request (``prompts[g]``,
        ``lengths[g]`` tokens) decoded again on ``engine`` (fresh), and
        then submitted again with ``emitted=`` its first j tokens of that
        run, j its first, middle and last draw, and one token to go (a
        re-prefill, as a replay makes): the prefill's draw j against the
        decode's.  The readings: the largest move of the decoded draw's
        TOP_N best logits and of its top logit, in bf16 ulps of the top
        logit (which must stay within REPLAY_PREMISE_ULPS), the largest
        |top logit difference|, the draws whose greedy token changed.
        Then the planted replay: each request's middle draw again with
        the last emitted token replaced by the next token id, which must
        move a draw beyond REPLAY_PREMISE_ULPS."""
        torch = self.torch
        vocab = cfg.vocab

        def run(reqs):
            """{(g, j): the draw's logits} of ``reqs`` = [(g, n, emitted,
            the draws to keep)] -> (those, {g: tokens})."""
            kept: dict = {}
            e = self._fresh([engine])[0]

            def hook(e_, logits, scores, rows):
                for r, q in rows.items():
                    key = (q.key_id, len(q.tokens))
                    if key in want:
                        kept[key] = logits[r, :vocab].float().clone()

            want = {(g, j) for g, _, _, js in reqs for j in js}
            e.hooks["post_logits"] = hook
            rids = {g: e.submit(prompts[g], n, key_id=g, emitted=em)
                    for g, n, em, _ in reqs}
            while e.scheduler.has_work():
                e.step()
            self.sync()
            e.hooks.clear()
            states = e.request_states()
            return kept, {g: states[rid]["tokens"] for g, rid in rids.items()}

        draws = {g: sorted({1, n // 2, n - 1} - {0, n})
                 for g, n in lengths.items()}
        decoded, toks = run([(g, n, None, draws[g])
                             for g, n in lengths.items()])
        prefilled, _ = run([(g, j + 1, toks[g][:j], [j])
                            for g in draws for j in draws[g]])
        planted = {g: js[len(js) // 2] for g, js in draws.items() if js}
        bad, _ = run([(g, j + 1, toks[g][:j - 1]
                       + [(toks[g][j - 1] + 1) % vocab], [j])
                      for g, j in planted.items()])

        def moved(key, other):
            """The largest move of the decoded draw's TOP_N best logits
            and of the top logit, in ulps of the top logit; the top
            logit's move; whether the greedy token changed."""
            a, b = decoded[key], other[key]
            best = a.topk(TOP_N).indices
            top = abs(float(a.max()) - float(b.max()))
            return max(float((a[best] - b[best]).abs().max()), top) \
                / bf16_ulp(float(a.max())), top, \
                int(a.argmax()) != int(b.argmax())

        keys = [(g, j) for g in draws for j in draws[g]]
        reads = [moved(k, prefilled) for k in keys]
        bad_reads = [moved(k, bad)[0] for k in planted.items()]
        checks = {"draws_read": len(keys) > 0
                  and all(k in decoded and k in prefilled for k in keys),
                  "within_premise": max(r[0] for r in reads)
                  <= REPLAY_PREMISE_ULPS,
                  "planted_refused": len(bad_reads) == len(planted) > 0
                  and min(bad_reads) > REPLAY_PREMISE_ULPS}
        del decoded, prefilled, bad
        torch.cuda.empty_cache()
        return {"draws": len(keys),
                "max_drift_ulps": max(r[0] for r in reads),
                "median_drift_ulps": statistics.median(
                    r[0] for r in reads),
                "max_top_drift": max(r[1] for r in reads),
                "greedy_changed": sum(r[2] for r in reads),
                "premise_ulps": REPLAY_PREMISE_ULPS,
                "planted_wrong_token": {
                    "draws": len(planted),
                    "min_moved_ulps": min(bad_reads, default=None),
                    "median_moved_ulps": statistics.median(bad_reads)
                    if bad_reads else None},
                "checks": checks}

    def _twins(self, engine, cfg, prompts: dict, ref: dict,
               temperature: float = 0.0):
        """-> ``hold_replayed``'s ``twin``: each case ``key: (j, i)``
        submitted to ``engine`` (fresh) with ``emitted=ref[key][:j]`` and
        ``i + 1`` tokens in all, the replay made again; -> (its stream,
        its draws' scores)."""
        def twin(cases):
            recs: dict = {}
            e = self._fresh([engine])[0]
            with self._record_scores([e], cfg.vocab, recs, temperature):
                rids = {k: e.submit(prompts[k], i + 1, key_id=k,
                                    emitted=ref[k][:j])
                        for k, (j, i) in cases.items()}
                while e.scheduler.has_work():
                    e.step()
            self.sync()
            states = e.request_states()
            return {k: states[rid]["tokens"] for k, rid in rids.items()}, \
                recs
        return twin

    def run_fleet(self, model, cfg, trace, worker_kwargs: dict) -> dict:
        """The serving fleet over the serve phase's model and trace: (a) a
        fault-free 2-replica ``Router`` (greedy, request keys), recording
        each token's top-1 / top-2 logit gap; (b) the same under a chaos
        plan and one ``nan_logits``; (c) a journaled run crashed by
        ``crash_after_appends`` and recovered by a new router over fresh
        engines; (d) request-key sampling across a migration; (e) two
        subprocess workers with their own weights, one SIGKILLed; (f) (b)
        again with tracers on the engines, the router and the journal.
        Tokens of (b)-(f) are held to (a)'s (or (d)'s unmigrated run's)
        by ``hold_replayed``: equal, or first different at a near-tie in
        both runs, or, past a replay, held to the replay made again."""
        torch = self.torch
        from repro_torch.events import EventSink, read_events
        from repro_torch.kernels import build
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.kvq import ops as kvq_ops
        from repro_torch.obs import MetricsRegistry, Tracer
        from repro_torch.serve import (DONE, TERMINAL, FaultInjector,
                                       FaultPlan, FleetFaultInjector,
                                       RequestJournal, Router, SimulatedCrash,
                                       chaos_plan, crash_after_appends,
                                       fleet_summary, kernel_launches,
                                       spawn_workers)
        counters = (flash_ops.KERNEL, flash_ops.FWD_SM90, kvq_ops.KERNEL,
                    kvq_ops.BIAS_KERNEL)
        L, n_req = cfg.n_layers, len(trace)
        tmp = tempfile.mkdtemp(prefix="fleet_")
        lines = {}

        def zero():
            for k in counters:
                k.launches = 0

        def timed_run(router, reqs):
            t0 = time.time()
            summary = router.run(reqs)
            self.sync()
            return summary, time.time() - t0

        def tokens_of(router):
            return {g: list(fr.tokens) for g, fr in router._reqs.items()
                    if fr.state == DONE}

        def leak_free(engines):
            return all(e.pool.occupancy == 0
                       and e.pool.allocs == e.pool.frees for e in engines)

        def emit_line(name, rec, checks, **extra):
            rec = {"phase": f"fleet_{name}", "ok": all(checks.values()),
                   "checks": checks, **rec, **extra}
            lines[name] = self.record(rec)
            return rec

        t_start = time.time()
        engines = self._fleet_engines(model, cfg)
        warm_s = time.time() - t_start

        # (a) fault-free reference ------------------------------------------
        recs: dict = {}
        zero()
        router = Router(self._fresh(engines))
        with self._record_scores(engines, cfg.vocab, recs):
            summary, wall = timed_run(router, trace)
        ref = tokens_of(router)
        rec = self._fleet_counts(router, summary, wall, kernel_launches(),
                                 engines)
        emit_line("reference", rec, {
            "n_done": rec["n_done"] == n_req,
            "reconcile": summary["reconcile"]["ok"],
            "no_slot_leak": leak_free(engines),
            "scores_recorded": len(recs) == sum(map(len, ref.values())),
            "launches": self._launches_follow(rec, L)},
            replicas=2, max_slots=FLEET_SLOTS, max_len=FLEET_LEN,
            kv_splits=4, n_requests=n_req, warmup_s=warm_s,
            min_gap=min(v[0] - v[1] for _, v, _ in recs.values()),
            near_ties=sum(v[0] - v[1] <= 2 * bf16_ulp(t)
                          for t, v, _ in recs.values()))

        # the replay drift: every request re-prefilled over its prompt and
        # its first j tokens (what a migration or a recovery replays), j
        # its first, middle and last draw, the draw's logits against the
        # same draw decoded; and where the near-tie gate is blind (the
        # reference's draws with a top-2 gap within 2 ulps)
        prompts = {g: router.request(g).prompt for g in ref}
        replay = self._replay_drift(engines[0], cfg, prompts,
                                    {g: len(t) for g, t in ref.items()})
        replay["near_ties_2_ulps"] = sum(
            v[0] - v[1] <= 2 * bf16_ulp(t) for t, v, _ in recs.values())
        replay["reference_draws"] = len(recs)
        lines["replay"] = self.record({
            "phase": "fleet_replay", **replay,
            "ok": all(replay["checks"].values())})

        def chaos(router, engines):
            plan = chaos_plan(FLEET_CHAOS["seed"], steps=FLEET_CHAOS["steps"],
                              replicas=2, n_events=FLEET_CHAOS["n_events"])
            fleet_inj = FleetFaultInjector(router, plan)
            replica, step, slot = FLEET_NAN
            inj = FaultInjector(engines[replica],
                                FaultPlan().nan_logits(step, slot=slot))
            return fleet_inj, inj

        def chaos_checks(rec, summary, fleet_inj, inj, leaks, held):
            return {
                "reconcile": summary["reconcile"]["ok"],
                "all_done": rec["n_done"] == n_req,
                "no_slot_leak": leaks,
                "crash_landed": fleet_inj.injected["replica_crash"] == 1,
                "sick_or_slow_landed":
                    fleet_inj.injected["replica_sick"]
                    + fleet_inj.injected["replica_slow"] >= 1,
                "nan_landed": inj.injected["nan_logits"] == 1,
                "failover": rec["failovers"] >= 1
                and rec["n_migrations"] >= 1,
                "tokens_held": held["diverged"] == 0,
                "launches": self._launches_follow(rec, L)}

        # (b) chaos ----------------------------------------------------------
        zero()
        router = Router(self._fresh(engines))
        fleet_inj, inj = chaos(router, engines)
        got_recs, replays = {}, {}
        with self._record_scores(engines, cfg.vocab, got_recs,
                                 replays=replays):
            summary, wall_b = timed_run(router, trace)
        rec = self._fleet_counts(router, summary, wall_b, kernel_launches(),
                                 engines)
        leaks = leak_free(engines)
        held, firsts, drift = hold_replayed(
            ref, recs, tokens_of(router), got_recs, replays,
            self._twins(engines[0], cfg, prompts, ref))
        emit_line("chaos", rec, chaos_checks(rec, summary, fleet_inj, inj,
                                             leaks, held),
                  chaos=FLEET_CHAOS, nan_logits=FLEET_NAN,
                  injected={**fleet_inj.injected, **inj.injected},
                  tokens_vs_reference=held, first_differences=firsts,
                  top_logit_drift=drift)

        # (c) crash and recover ----------------------------------------------
        fresh = self._fleet_engines(model, cfg)
        path = os.path.join(tmp, "wal.jsonl")
        zero()
        journal = RequestJournal(path, snapshot_every=64)
        crash = crash_after_appends(journal, FLEET_CRASH_AT)
        router = Router(self._fresh(engines), journal=journal)
        got_recs, replays = {}, {}
        with self._record_scores(engines + fresh, cfg.vocab, got_recs,
                                 replays=replays):
            try:
                router.run(trace)
            except SimulatedCrash:
                pass
            done_before = tokens_of(router)     # delivered before the crash
            crash_step, appends = router.step_no, journal.appends
            pre = (sum(e.n_prefills for e in engines),
                   sum(e.n_decode_rounds for e in engines))
            journal.close()
            for e in engines:                   # kill -9: the requests vanish
                for rid, st in list(e.request_states().items()):
                    if st["state"] not in TERMINAL:
                        e.evict_request(rid)
                e.reset()
            journal = RequestJournal(path, snapshot_every=64)
            n_live = journal.state.n_live
            n_submitted = journal.state.next_gid
            router = Router(fresh, journal=journal)
            t0 = time.time()
            info = router.recover()
            rest = sorted(trace, key=lambda r: r.arrival_step)[n_submitted:]
            rest = [dataclasses.replace(
                r, arrival_step=max(0, r.arrival_step - crash_step))
                for r in rest]
            summary = router.run(rest)
            self.sync()
            wall = time.time() - t0
        got = {**done_before, **tokens_of(router)}
        rec = self._fleet_counts(router, summary, wall, kernel_launches(),
                                 fresh)
        leaks = leak_free(fresh) and leak_free(engines)
        held, firsts, drift = hold_replayed(
            ref, recs, got, got_recs, replays,
            self._twins(engines[0], cfg, prompts, ref))
        rounds = (pre[0] + rec["prefills"], pre[1] + rec["decode_rounds"])
        checks = {
            "crashed": crash["fired"] and n_live > 0,
            "recovered": info["n_recovered"] == n_live,
            "reconcile": summary["reconcile"]["ok"]
            and summary["reconcile"]["checks"]["journal_accounted"],
            "all_done": len(got) == n_req,
            "no_slot_leak": leaks,
            "tokens_held": held["diverged"] == 0,
            "launches": self._launches_follow(rec, L, *rounds)}
        emit_line("recover", rec, checks, crash_after_appends=FLEET_CRASH_AT,
                  crash_router_step=crash_step, appends_before_crash=appends,
                  appends_after=journal.appends,
                  snapshots=journal.snapshots, recover=info,
                  done_before_crash=len(done_before),
                  prefills_before_crash=pre[0],
                  decode_rounds_before_crash=pre[1],
                  tokens_vs_reference=held, first_differences=firsts,
                  top_logit_drift=drift)
        journal.close()
        del engines, fleet_inj, inj
        gc.collect()

        # (d) request keys across a migration ----------------------------------
        temperature, top_k = 0.8, 50
        sampled = self._fleet_engines(model, cfg, temperature=temperature,
                                      top_k=top_k)
        sub = sorted(trace, key=lambda r: r.arrival_step)[:FLEET_SLOTS]
        kids = [1000 + i for i in range(len(sub))]

        def submit_all(e):
            return {k: e.submit(r.prompt, r.max_new_tokens, key_id=k)
                    for k, r in zip(kids, sub)}

        s_recs: dict = {}
        a, b = self._fresh(sampled)
        with self._record_scores(sampled, cfg.vocab, s_recs, temperature):
            rids = submit_all(a)
            while a.scheduler.has_work():
                a.step()
        states = a.request_states()
        s_ref = {k: states[rid]["tokens"] for k, rid in rids.items()}
        a, b = self._fresh(sampled)
        got_recs, replays = {}, {}
        zero()
        with self._record_scores(sampled, cfg.vocab, got_recs, temperature,
                                 replays=replays):
            rids = submit_all(a)
            for _ in range(FLEET_EVICT_AFTER):
                a.step()
            states = a.request_states()
            victim = max((rid for rid, st in states.items()
                          if st["slot"] is not None),
                         key=lambda rid: (len(states[rid]["tokens"]), -rid))
            moved = a.evict_request(victim)
            new = b.submit(moved.prompt, moved.max_new_tokens,
                           key_id=moved.key_id, emitted=moved.tokens,
                           front=True)
            while a.scheduler.has_work() or b.scheduler.has_work():
                for e in (a, b):
                    if e.scheduler.has_work():
                        e.step()
            self.sync()
        rec = {**self._rates(
            fleet_summary([a.summary(), b.summary()]),
            MetricsRegistry.merge(a.metrics.registry_snapshot(),
                                  b.metrics.registry_snapshot())["hists"]),
            "failovers": 0, "n_migrations": 1,
            "kernel_launches": kernel_launches(),
            "prefills": sum(e.n_prefills for e in sampled),
            "decode_rounds": sum(e.n_decode_rounds for e in sampled)}
        states = a.request_states()
        s_got = {k: states[rid]["tokens"] for k, rid in rids.items()
                 if rid != victim}
        s_got[moved.key_id] = b.request_states()[new]["tokens"]
        held, firsts, drift = hold_replayed(
            s_ref, s_recs, s_got, got_recs, replays, self._twins(
                sampled[0], cfg, {k: r.prompt for k, r in zip(kids, sub)},
                s_ref, temperature))
        emit_line("request_keys", rec, {
            "victim_held": held["diverged"] == 0,
            "sampled": len({t for v in s_ref.values() for t in v}) > 1,
            "all_done": all(len(s_got[k]) == r_.max_new_tokens
                            for k, r_ in zip(kids, sub)),
            "no_slot_leak": leak_free(sampled),
            "launches": self._launches_follow(rec, L)},
            temperature=temperature, top_k=top_k, n_requests=len(sub),
            evicted_after_steps=FLEET_EVICT_AFTER, victim_key=moved.key_id,
            victim_emitted=len(moved.tokens),
            tokens_vs_unmigrated=held, first_differences=firsts,
            top_logit_drift=drift)
        del sampled, a, b
        gc.collect()
        torch.cuda.empty_cache()

        # (e) subprocess workers -----------------------------------------------
        libs = set(build.BUILD_DIR.glob("*.so"))
        sub = sorted(trace, key=lambda r: r.arrival_step)[:FLEET_SLOTS]
        t0 = time.time()
        # the children import this file for their factory
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        workers = spawn_workers(2, "chip_smoke:fleet_worker", kwargs={
            **worker_kwargs, "max_slots": FLEET_SLOTS, "max_len": FLEET_LEN,
            "prompt_buckets": fresh[0].buckets, "policy_name": "bf16",
            "quantized": True, "kv_splits": 4, "sampler_keys": "request",
            "seed": self.args.seed})
        spawn_s = time.time() - t0
        try:
            ready = [w.kernel_launches() for w in workers]
            failovers = _Replays()
            router = Router(workers, sink=failovers)
            fleet_inj = FleetFaultInjector(
                router, FaultPlan().worker_sigkill(FLEET_SIGKILL_STEP,
                                                   replica=1))
            summary, wall = timed_run(router, sub)
            end = [w.kernel_launches() for w in workers]
            # the RPC's own cost: round trips that do no engine work, a
            # ping (a tiny frame) and a harvest (the per-step snapshot)
            rpc_ms = {}
            for op in ("ping", "harvest"):
                times = []
                for _ in range(21):
                    t1 = time.perf_counter()
                    getattr(workers[0], op)()
                    times.append((time.perf_counter() - t1) * 1e3)
                rpc_ms[op] = statistics.median(times)
            runs = [{k: e_[k] - r_[k] for k in e_} for r_, e_ in
                    zip(ready, end)]
            rec = self._fleet_counts(router, summary, wall, runs[0], [])
            leaks = leak_free(workers)
            held, firsts, _ = hold_replayed(
                {g: ref[g] for g in range(len(sub))}, recs,
                tokens_of(router), None, failovers.replays,
                self._twins(fresh[0], cfg, prompts, ref))
            survivor = runs[0]
            emit_line("workers", rec, {
                "reconcile": summary["reconcile"]["ok"],
                "all_done": rec["n_done"] == len(sub),
                "killed": fleet_inj.injected["worker_sigkill"] == 1
                and not workers[1].alive,
                "breaker": router.health[1] in ("QUARANTINED", "DEAD")
                and rec["failovers"] >= 1,
                "survivor_ran_kernels": survivor["flash_fwd_sm90"] > 0
                and survivor["flash_decode"] > 0,
                "no_slot_leak": leaks,
                "no_nvcc_in_children":
                    set(build.BUILD_DIR.glob("*.so")) == libs,
                "tokens_held": held["diverged"] == 0},
                n_requests=len(sub), sigkill_router_step=FLEET_SIGKILL_STEP,
                spawn_to_ready_s=spawn_s, pids=[w.pid for w in workers],
                survivor_launches=survivor,
                victim_launches_at_ready=ready[1],
                victim_death=workers[1].death_reason, rpc_median_ms=rpc_ms,
                tokens_vs_reference=held, first_differences=firsts)
        finally:
            for w in workers:
                w.shutdown()

        # (f) (b) traced -------------------------------------------------------
        ev = os.path.join(tmp, "events.jsonl")
        sink = EventSink(ev)
        journal = RequestJournal(os.path.join(tmp, "wal_f.jsonl"),
                                 snapshot_every=64)
        zero()
        router = Router(self._fresh(fresh), journal=journal)
        for i, e in enumerate(fresh):
            e.tracer = Tracer(sink, pid=f"r{i}")
        router.tracer = Tracer(sink, pid="router")
        journal.tracer = Tracer(sink, pid="journal")
        fleet_inj, inj = chaos(router, fresh)
        got_recs, replays = {}, {}
        try:
            with self._record_scores(fresh, cfg.vocab, got_recs,
                                     replays=replays):
                summary, wall = timed_run(router, trace)
        finally:
            for e in fresh:
                e.tracer = None
            journal.close()
            sink.close()
        rec = self._fleet_counts(router, summary, wall, kernel_launches(),
                                 fresh)
        leaks = leak_free(fresh)
        held, firsts, drift = hold_replayed(
            ref, recs, tokens_of(router), got_recs, replays,
            self._twins(fresh[0], cfg, prompts, ref))
        ends = {e["sid"]: e["ts"] for e in read_events(ev, "span_end")}
        begins = read_events(ev, "span_begin")
        spans: dict = {}
        for e in begins:
            spans[e["name"]] = spans.get(e["name"], 0) + 1
        step_ms = [(ends[e["sid"]] - e["ts"]) * 1e3 for e in begins
                   if e["name"] == "step" and e["sid"] in ends]
        checks = chaos_checks(rec, summary, fleet_inj, inj, leaks, held)
        checks["spans_closed"] = len(ends) == len(begins)
        emit_line("traced", rec, checks, spans=spans,
                  step_span_median_ms=statistics.median(step_ms),
                  step_span_p90_ms=sorted(step_ms)[int(0.9 * len(step_ms))],
                  step_spans=len(step_ms),
                  profile_decode_round_device_ms=getattr(
                      self, "decode_round_device_ms", None),
                  wall_vs_untraced=wall / wall_b,
                  tokens_vs_reference=held, first_differences=firsts,
                  top_logit_drift=drift)
        shutil.rmtree(tmp, ignore_errors=True)
        self.fleet_launches = {
            "flash_fwd_sm90": sum(lines[n]["kernel_launches"][
                "flash_fwd_sm90"] for n in ("reference", "chaos", "recover",
                                            "request_keys", "traced")),
            "flash_decode": sum(lines[n]["kernel_launches"]["flash_decode"]
                                for n in ("reference", "chaos", "recover",
                                          "request_keys", "traced"))}
        return lines

    def _profile(self, fn, host: bool = True):
        """``torch.profiler`` over ``fn()``: (wall s, device busy s, rows of
        (device us, kernel name, launches)), busiest first.  The SSD op's,
        the MoE FFN's and the encoder-decoder's ranges go to
        ``last_scopes`` instead of the rows.  ``host=False`` records the
        device's activity only: the same rows, no ranges, and a
        ``key_averages()`` several times cheaper where the host dispatches
        many operators."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA] if not host
                     else [ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            out = fn()
            self.sync()
            wall = time.time() - t0
        rows = []
        self.last_scopes = {}
        for ev in prof.key_averages():
            on_host = "CUDA" not in str(getattr(ev, "device_type", ""))
            if ev.key.startswith(("ssd.", "moe.", "encdec.")):
                # the SSD op's and the MoE FFN's profiler ranges
                # (kernels/ssd/ops.py ssd, models/moe.py), apart from the
                # rows (they would count their kernels twice): on the host
                # record, the device time of the kernels launched inside;
                # on the device's copy, the span
                us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0))
                part = self.last_scopes.setdefault(
                    ev.key, {"kernels_ms": 0.0, "span_ms": 0.0, "n": 0})
                part["kernels_ms" if on_host else "span_ms"] = us / 1e3
                if on_host:
                    part["n"] = ev.count
                continue
            if on_host:
                continue                      # host-side op records
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us, ev.key, ev.count))
        rows.sort(reverse=True)
        return out, wall, sum(r[0] for r in rows) / 1e6, rows

    def profile_serve(self, engine, cfg) -> dict:
        """Where a serving step's device time goes: ``torch.profiler`` over
        ``PROFILE_REQUESTS`` requests (prompt 256, ``PROFILE_NEW`` new
        tokens) served after the measured run, device time summed by
        kernel name; then ``PROFILE_WINDOW`` engine steps that
        only decode (8 requests resident, nothing to admit), profiled
        alone: the device time of one decode round."""
        import numpy as np
        from repro_torch.serve.trace import TraceRequest
        rng = np.random.default_rng(1)
        trace = [TraceRequest(0, rng.integers(0, cfg.vocab, 256)
                              .astype(np.int32), PROFILE_NEW)
                 for _ in range(PROFILE_REQUESTS)]
        engine.reset()
        summary, wall, busy_s, rows = self._profile(
            lambda: engine.run(trace), host=False)
        rounds, d_wall, d_busy, d_rows = self._decode_window(
            engine, cfg, PROFILE_WINDOW, host=False)
        self.decode_round_device_ms = d_busy / rounds * 1e3
        return self.record({
            "phase": "profile", "wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1 - busy_s / wall if wall > 0 else None,
            "prefills": summary["diagnostics"]["prefills"],
            "decode_rounds": summary["diagnostics"]["decode_rounds"],
            "top_kernels_ms": [[name[:80], round(us / 1e3, 3), n]
                               for us, name, n in rows[:15]],
            # the decode-only window: 8 rounds of 8 resident requests
            "decode_window_rounds": rounds,
            "decode_round_device_ms": self.decode_round_device_ms,
            "decode_round_wall_ms": d_wall / rounds * 1e3,
            "decode_window_idle_share": 1 - d_busy / d_wall,
            "decode_window_top_kernels_ms": [
                [name[:80], round(us / 1e3, 3), n]
                for us, name, n in d_rows[:8]]})

    def _train_steps(self, cfg, batch: int = 1, seq: int = TRAIN_SEQ,
                     extras=None, mesh=None) -> dict:
        """``cfg`` through ``build_train_step`` as ``launch/train.py``
        drives it, without checkpoint I/O: random f32 master weights,
        policy bf16, remat on every block, the AdamW defaults, batch
        ``batch`` x ``seq`` (1 x TRAIN_SEQ) of the trainer's synthetic
        stream, each batch updated with ``extras(batch)`` (an encoder's
        frames, a VLM's patches and positions); 2 warm-up steps, then 5
        with the attention kernels' launch counters zeroed before and read
        after.  With ``mesh`` the step is ``make_train_step(mesh=mesh)``'s
        (data parallel over the process group that exists).  Returns the
        run's records, launches, peak and ``one_step`` (for a profile)."""
        torch = self.torch
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.launch.train import init_state, synthetic_lm_batches
        from repro_torch.optim import adamw
        from repro_torch.train.train_step import (TrainConfig,
                                                  build_train_step,
                                                  init_loss_scale,
                                                  make_train_step)
        kernels = self._launch_counters()
        gc.collect()                   # an earlier model is gone: free it
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(self.dev)
        tc = TrainConfig(policy="bf16", remat=CheckpointConfig(
            enabled=True, policy="full", segment_size=1),
            opt=adamw.AdamWConfig())
        t0 = time.time()
        model, opt = init_state(cfg, self.args.seed, self.dev)
        ls = init_loss_scale(tc, self.dev)
        if mesh is None:
            step = build_train_step(cfg, tc)
        else:
            step, tc = make_train_step(cfg, tc, {"tokens": torch.empty(
                (batch, seq), dtype=torch.int32, device="meta")}, mesh=mesh)
        stream = synthetic_lm_batches(cfg, batch, seq, seed=self.args.seed,
                                      device=self.dev)
        data = stream if extras is None else (
            (i, {**bt, **extras(bt)}) for i, bt in stream)
        n_params = sum(p.numel() for p in model.parameters())
        self.sync()
        init_s = time.time() - t0
        records = []

        def one_step():
            nonlocal model, opt, ls
            _, batch = next(data)
            t = time.time()
            model, opt, ls, m = step(model, opt, ls, batch)
            vals = {k: float(v) for k, v in m.items()}   # syncs the step
            vals["step_s"] = time.time() - t
            records.append(vals)

        for _ in range(2):                              # warm-up
            one_step()
        for kern in kernels.values():                   # the main path's
            kern.launches = 0                           # counts
        for _ in range(5):
            one_step()
        launches = {n: k.launches for n, k in kernels.items()}
        return {"records": records, "launches": launches,
                "peak": torch.cuda.max_memory_allocated(self.dev),
                "n_params": n_params, "init_s": init_s,
                "one_step": one_step, "model": lambda: model,
                "batch": lambda: next(data)[1]}

    @staticmethod
    def _train_checks(cfg, run: dict) -> dict:
        """The train phases' checks: finite losses and gradients, the
        5 timed steps' launches (remat: every layer's forward twice, the
        bf16 policy on the tensor-core designs only), the peak < 80 GB."""
        records, launches = run["records"], run["launches"]
        L, n = cfg.n_layers, len(records[2:7])
        finite = {
            "losses_finite": all(math.isfinite(r["loss"]) for r in records),
            "grad_norms_finite": all(math.isfinite(r["grad_norm"])
                                     for r in records),
            "grads_finite": all(r["grads_finite"] for r in records),
            "fits": run["peak"] < 80e9}
        if cfg.mla is not None or cfg.mrope_sections is not None:
            # MLA's and M-RoPE's plain attention, as in the reference: no
            # kernel at all
            return {**finite, "no_launches": not any(launches.values())}
        return {
            **finite,
            # remat: every layer's forward runs twice (forward, recompute),
            # policy bf16: on the tensor-core forward only
            "flash_fwd_launches": launches["flash_fwd_sm90"] == 2 * L * n
            and launches["flash_fwd"] == 0,
            # policy bf16: dQ / dKV on the tensor-core kernels only
            "bwd_launches": all(launches[k] == L * n for k in
                                ("flash_bwd_delta", "flash_bwd_dq_sm90",
                                 "flash_bwd_dkv_sm90"))
            and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
        }

    def _decode_window(self, engine, cfg, steps: int, host: bool = True):
        """``torch.profiler`` over ``steps`` engine steps that only decode:
        8 requests of 256 prompt tokens admitted first (one a step), then
        nothing to admit.  Returns (decode rounds, wall s, device busy s,
        rows); the engine is reset after."""
        import numpy as np
        rng = np.random.default_rng(1)
        engine.reset()
        rids = [engine.submit(rng.integers(0, cfg.vocab, 256)
                              .astype(np.int32), 64) for _ in range(8)]
        while engine.scheduler.queue_depth:          # one admission a step
            engine.step()
        rounds = engine.n_decode_rounds
        _, wall, busy, rows = self._profile(
            lambda: [engine.step() for _ in range(steps)], host=host)
        rounds = engine.n_decode_rounds - rounds
        for rid in rids:
            engine.cancel(rid)
        engine.reset()
        return rounds, wall, busy, rows

    def run_train(self) -> dict:
        """llama3-8b at full width and TRAIN_LAYERS layers
        (:meth:`_train_steps`), then ``torch.profiler`` over one more
        step."""
        from repro_torch import configs
        cfg = dataclasses.replace(configs.get_config("llama3-8b"),
                                  n_layers=TRAIN_LAYERS)
        run = self._train_steps(cfg)
        records, launches = run["records"], run["launches"]
        n_params, peak, init_s = run["n_params"], run["peak"], run["init_s"]
        self.train_launches = launches
        self.train_records = list(records[:7])  # warm-up and timed steps
        self.train_bytes_per_param = peak / n_params
        _, wall, busy_s, rows = self._profile(run["one_step"], host=False)
        peak = run["peak"] = self.torch.cuda.max_memory_allocated(self.dev)
        timed = records[2:7]
        step_s = statistics.median(r["step_s"] for r in timed)
        self.train_step_s = step_s
        L = cfg.n_layers
        checks = self._train_checks(cfg, run)
        return self.record({
            "phase": "train", "ok": all(checks.values()), "checks": checks,
            "arch": cfg.arch_id, "n_layers": L, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv": cfg.n_kv, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "params": n_params, "policy": "bf16",
            "remat": "per block, full", "batch": 1, "seq": TRAIN_SEQ,
            "losses": [r["loss"] for r in records],
            "grad_norms": [r["grad_norm"] for r in records],
            "step_s": [r["step_s"] for r in records],
            "median_step_s": step_s, "tokens_per_s": TRAIN_SEQ / step_s,
            "kernel_launches_5_steps": launches,
            "max_memory_allocated_bytes": peak, "init_s": init_s,
            "profile": {"wall_s": wall, "device_busy_s": busy_s,
                        "idle_share": 1 - busy_s / wall if wall > 0
                        else None,
                        "top_kernels_ms": [[name[:80], round(us / 1e3, 3), c]
                                           for us, name, c in rows[:40]]}})

    # -- the dry run's predictions against the card (dryrun) -------------
    def run_dryrun(self) -> list:
        """(a) the ``train`` cell's step and (b) a full-depth decode step,
        each traced by ``launch/dryrun.py`` on fake tensors and then run
        for real here; (c) the dry run's CLI in a subprocess."""
        from repro_torch import configs
        from repro_torch.models import transformer
        torch = self.torch
        meta = functools.partial(torch.empty, dtype=torch.int32,
                                 device="meta")
        cfg = dataclasses.replace(configs.get_config("llama3-8b"),
                                  n_layers=TRAIN_LAYERS)
        train = self._dryrun_part(
            "dryrun_train", cfg, "train_4k",
            {"tokens": meta((1, TRAIN_SEQ)), "labels": meta((1, TRAIN_SEQ))},
            # the AdamW moments: 2 f32 a parameter
            control=lambda args: 8 * sum(
                p.numel() for p in args[0].parameters()),
            control_of="adamw_moments")
        cfg = configs.get_config("llama3-8b")
        decode = self._dryrun_part(
            "dryrun_decode", cfg, "decode_32k",
            {"tokens_t": meta((DRYRUN_SLOTS,)),
             "cache": transformer.init_cache(cfg, DRYRUN_SLOTS, DRYRUN_LEN,
                                             device="meta")},
            kvq_splits=4,
            control=lambda args: sum(
                p.numel() * p.element_size()
                for blk in args[0].blocks for p in blk.parameters()),
            control_of="block_weights")
        return [train, decode, self._dryrun_cli()]

    def _dryrun_part(self, phase: str, cfg, shape: str, specs: dict, *,
                     control, control_of: str, kvq_splits: int = 1) -> dict:
        """One step of ``shape``'s kind at ``specs``: the dry run's trace
        of it on fake tensors, then the same step made from ``--seed`` on
        the card and run once under ``FlopCounterMode``, with the launch
        counters and the peak read around it.  ``control(args)``: bytes
        the prediction less which must miss the peak gate."""
        torch = self.torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch import dryrun
        t0 = time.time()
        with FakeTensorMode():
            step, args = dryrun.build_lowerable(
                cfg, shape, None, accum=1, kvq_splits=kvq_splits,
                specs=specs)
            pred = dryrun.trace_step(step, args)
            control_bytes = control(args)
            del step, args
        trace_s = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(self.dev)
        t0 = time.time()
        step, args = dryrun.build_lowerable(
            cfg, shape, None, accum=1, kvq_splits=kvq_splits, specs=specs,
            device=self.dev, seed=self.args.seed)
        self.sync()
        resident = torch.cuda.memory_allocated(self.dev) - base
        counters = self._all_counters()
        before = {n: k.launches for n, k in counters.items()}
        torch.cuda.reset_peak_memory_stats(self.dev)
        flop = FlopCounterMode(display=False)
        with flop:
            step(*args)
        self.sync()
        peak = torch.cuda.max_memory_allocated(self.dev) - base
        step_s = time.time() - t0
        launches = {n: k.launches - before[n] for n, k in counters.items()
                    if k.launches != before[n]}
        del step, args
        gc.collect()
        torch.cuda.empty_cache()
        flops = float(flop.get_total_flops())
        err = abs(pred["peak"] - peak) / peak
        control_err = abs(pred["peak"] - control_bytes - peak) / peak
        checks = {"launches_exact": launches == pred["kernel_calls"],
                  "flops_exact": flops == pred["flops"],
                  "peak_within_tol": err <= DRYRUN_PEAK_TOL,
                  "control_misses": control_err > DRYRUN_PEAK_TOL}
        return self.record({
            "phase": phase, "ok": all(checks.values()), "checks": checks,
            "arch": cfg.arch_id, "n_layers": cfg.n_layers,
            "kind": dryrun.configs.SHAPES[shape]["kind"],
            "inputs": {k: list(v.shape) for k, v in specs.items()
                       if k != "cache"},
            "cache_len": DRYRUN_LEN if "cache" in specs else None,
            "kv_splits": kvq_splits if "cache" in specs else None,
            "predicted_kernel_calls": pred["kernel_calls"],
            "launches": launches, "predicted_flops": pred["flops"],
            "flops": flops, "predicted_peak_bytes": pred["peak"],
            "max_memory_allocated_bytes": peak, "base_bytes": base,
            "peak_rel_err": err, "predicted_resident_bytes":
            pred["resident"], "resident_bytes": resident,
            "control": control_of, "control_bytes": control_bytes,
            "control_rel_err": control_err, "tol": DRYRUN_PEAK_TOL,
            "predicted_op_bytes": pred["bytes"],
            "trace_s": trace_s, "card_s": step_s})

    def _dryrun_cli(self) -> dict:
        """The dry run's CLI on the production mesh in a subprocess that
        reports whether it touched the card."""
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "cell.json")
            argv = ["dryrun", "--arch", "llama3-8b", "--shape", "decode_32k",
                    "--json", out]
            code = (
                "import runpy, sys, torch\n"
                f"sys.argv = {argv!r}\n"
                "rc = 0\n"
                "try:\n"
                "    runpy.run_module('repro_torch.launch.dryrun', "
                "run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    rc = e.code\n"
                "print('CARD', torch.cuda.is_initialized(), "
                "torch.cuda.memory_allocated())\n"
                "sys.exit(rc)\n")
            proc = subprocess.run(
                [sys.executable, "-c", code], capture_output=True,
                text=True, timeout=600, cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            res = json.loads(pathlib.Path(out).read_text()) \
                if os.path.exists(out) else {"results": [], "failures": []}
        card = proc.stdout.split("CARD")[-1].split() if "CARD" in \
            proc.stdout else ["?", "-1"]
        r = res["results"][0] if res["results"] else {}
        checks = {"exit_0": proc.returncode == 0,
                  "one_cell_ok": "1 cells OK, 0 failed" in proc.stdout
                  and len(res["results"]) == 1,
                  "card_untouched": card == ["False", "0"]}
        return self.record({
            "phase": "dryrun_cli", "ok": all(checks.values()),
            "checks": checks, "mesh": r.get("mesh"),
            "cuda_initialized": card[0], "memory_allocated": int(card[1]),
            "bytes_per_device": r.get("bytes_per_device"),
            "kernel_calls": r.get("kernel_calls"),
            "bottleneck": r.get("bottleneck"),
            "stderr_tail": proc.stderr[-600:] if proc.returncode else "",
            "seconds": time.time() - t0})

    def run_train_dp(self) -> dict:
        """Data-parallel training (``train/train_step.py`` with a mesh):
        (a) the ``train`` cell (full width, 4 layers, 1 x 4096) through
        ``make_train_step(mesh=Mesh(data=1, model=1))`` in a world-1 NCCL
        group, whose gradients, loss and finite flag go through NCCL's
        all-reduce: losses, grad norms and launches against the meshless
        ``train`` phase's; (b) two ranks on this card (processes spawned
        from this script, gloo: NCCL takes one rank a device), smoke-width
        llama3-8b, batch DP_BATCH x DP_SEQ, bf16, DP_STEPS steps, against
        a 1-rank run at the global batch here, and
        ``compressed_psum_grads`` across the two on CUDA gradients."""
        import torch.distributed as dist
        from repro_torch import configs
        from repro_torch.launch.mesh import Mesh
        t0 = time.time()
        cfg = dataclasses.replace(configs.get_config("llama3-8b"),
                                  n_layers=TRAIN_LAYERS)
        rdv = tempfile.mkdtemp(prefix="train_dp_")
        try:
            dist.init_process_group(
                "nccl", init_method=f"file://{rdv}/a", rank=0, world_size=1,
                device_id=self.dev)
            try:
                run = self._train_steps(cfg, mesh=Mesh(data=1, model=1))
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
            n = len(self.train_records)
            got = [(r["loss"], r["grad_norm"]) for r in run["records"][:n]]
            want = [(r["loss"], r["grad_norm"])
                    for r in self.train_records]
            diff = max(max(abs(a - c), abs(b - d))
                       for (a, b), (c, d) in zip(got, want))
            rerun_diff = None
            if diff:
                # not bit-equal: hold it to what two meshless runs differ by
                again = self._train_steps(cfg)
                rerun_diff = max(
                    max(abs(r["loss"] - w["loss"]),
                        abs(r["grad_norm"] - w["grad_norm"]))
                    for r, w in zip(again["records"], self.train_records))
            timed = run["records"][2:7]
            step_s = statistics.median(r["step_s"] for r in timed)
            checks_a = {
                "backend_nccl": backend == "nccl",
                "losses_and_grad_norms": diff == 0 or (
                    rerun_diff is not None and diff <= rerun_diff),
                "launches_equal_train": run["launches"]
                == self.train_launches,
                **self._train_checks(cfg, run)}
            part_a = {
                "agreement": "bit_equal" if diff == 0 else
                "within_meshless_rerun" if checks_a["losses_and_grad_norms"]
                else "differs",
                "max_diff": diff, "meshless_rerun_max_diff": rerun_diff,
                "losses": [g[0] for g in got],
                "grad_norms": [g[1] for g in got],
                "median_step_s": step_s,
                "train_median_step_s": self.train_step_s,
                "step_ratio": step_s / self.train_step_s,
                "kernel_launches_5_steps": run["launches"],
                "max_memory_allocated_bytes": run["peak"]}
            del run
            part_b = self._train_dp_ranks(rdv)
        finally:
            shutil.rmtree(rdv, ignore_errors=True)
        self.train_dp_launches = {
            "a": part_a["kernel_launches_5_steps"],
            **{f"b_rank{r}": rk["launches"]
               for r, rk in enumerate(part_b["ranks"])}}
        checks = {**{f"a_{k}": v for k, v in checks_a.items()},
                  **{f"b_{k}": v for k, v in part_b.pop("checks").items()}}
        return self.record({
            "phase": "train_dp", "ok": all(checks.values()),
            "checks": checks, "a": part_a, "b": part_b,
            "seconds": time.time() - t0})

    def _train_dp_ranks(self, rdv: str) -> dict:
        """``run_train_dp``'s part (b): the 1-rank reference here, then
        the two ranks (``dp_child``), each joined with a timeout and
        killed if it fails."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.launch.train import init_state, synthetic_lm_batches
        from repro_torch.optim import adamw
        from repro_torch.train.train_step import (TrainConfig,
                                                  build_train_step,
                                                  init_loss_scale)
        cfg = configs.smoke_config("llama3-8b")
        tc = TrainConfig(policy="bf16", remat=CheckpointConfig(
            enabled=True, policy="full", segment_size=1))
        model, opt = init_state(cfg, self.args.seed, self.dev)
        ls, step = init_loss_scale(tc, self.dev), build_train_step(cfg, tc)
        data = synthetic_lm_batches(cfg, DP_BATCH, DP_SEQ,
                                    seed=self.args.seed, device=self.dev)
        ref = []
        for _ in range(DP_STEPS):
            model, opt, ls, m = step(model, opt, ls, next(data)[1])
            ref.append(float(m["loss"]))
        del model, opt
        # the route at this width: head_dim 16 takes the FMA designs
        d = cfg.head_dim
        fwd = flash_ops.fwd_route(torch.bfloat16, d)
        want = {k: 0 for k in self._launch_counters()}
        L, n = cfg.n_layers, DP_STEPS
        want["flash_fwd_sm90" if fwd == "sm90" else "flash_fwd"] = 2 * L * n
        bwd = flash_ops.bwd_route(torch.bfloat16, torch.bfloat16,
                                  torch.bfloat16, d)
        sfx = "_sm90" if bwd == "sm90" else ""
        want.update({"flash_bwd_delta": L * n, f"flash_bwd_dq{sfx}": L * n,
                     f"flash_bwd_dkv{sfx}": L * n})
        procs, outs = [], []
        t0 = time.time()
        try:
            for r in range(2):
                procs.append(subprocess.Popen(
                    [sys.executable, str(pathlib.Path(__file__).resolve()),
                     "--dp-child",
                     f"{r},2,{rdv}/b,{rdv}/rank{r}.json,{self.dev}",
                     "--seed", str(self.args.seed)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            for p in procs:
                out, _ = p.communicate(timeout=DP_JOIN_S)
                outs.append(out)
                if p.returncode != 0:
                    raise RuntimeError(f"train_dp rank exited "
                                       f"{p.returncode}:\n{out[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        spawn_s = time.time() - t0
        ranks = [json.loads(pathlib.Path(f"{rdv}/rank{r}.json").read_text())
                 for r in range(2)]
        rel = max(abs(a - b) / abs(b) for rk in ranks
                  for a, b in zip(rk["losses"], ref))
        checks = {
            "losses_within_1e-3": rel <= 1e-3,
            "ranks_agree": ranks[0]["losses"] == ranks[1]["losses"]
            and ranks[0]["grad_norms"] == ranks[1]["grad_norms"],
            "launches_follow_route": all(rk["launches"] == want
                                         for rk in ranks),
            "finite": all(math.isfinite(x) for rk in ranks
                          for x in rk["losses"] + rk["grad_norms"]),
            "compressed_mean_within_int8_step": all(
                rk["psum"]["within_step"] for rk in ranks),
            "compressed_ranks_agree": ranks[0]["psum"]["mean_digest"]
            == ranks[1]["psum"]["mean_digest"],
            "payload_quarter_plus_scales": all(
                rk["psum"]["payload_bytes"] == rk["psum"]["f32_bytes"] // 4
                + 4 * rk["psum"]["leaves"] for rk in ranks)}
        return {"arch": cfg.arch_id, "width": "smoke", "batch": DP_BATCH,
                "seq": DP_SEQ, "steps": DP_STEPS, "ref_losses": ref,
                "max_rel_loss_diff": rel, "routes": {"fwd": fwd, "bwd": bwd},
                "expected_launches": want, "spawn_to_join_s": spawn_s,
                "ranks": ranks, "checks": checks}

    # -- train_tp ------------------------------------------------------------
    def run_train_tp(self) -> dict:
        """Tensor-parallel training (see the module docstring, item 7c):
        for each sub-phase the unsharded run here (in bf16 also its f32
        control), each rank's windows of it saved and every device tensor
        freed, while its ranks (``tp_train_child``) start and wait for it;
        (a)'s and (b)'s ranks started at once, (b)'s unsharded run going
        on here while (a)'s ranks run and published when they have ended,
        then (c)'s.  gloo stages every reduction
        through the host: the ranks' step times are a correctness run's,
        not tensor parallelism's speed."""
        from repro_torch import configs
        t0 = time.time()
        llama = configs.get_config("llama3-8b")
        glm = configs.get_config("glm4-9b")
        bpp = getattr(self, "train_bytes_per_param", None) or \
            TRAIN_PEAK_FALLBACK / self._held_params(dataclasses.replace(
                llama, n_layers=TRAIN_LAYERS))
        subs = [("a", dataclasses.replace(llama, n_layers=TPT_A_LAYERS),
                 "full", TPT_A_SEQ, 2, 0, TPT_A_STEPS),
                ("b", dataclasses.replace(llama, n_layers=TPT_B_LAYERS),
                 "bf16", TPT_BC_SEQ, 2, TPT_WARMUP, TPT_TIMED),
                ("c", dataclasses.replace(glm, n_layers=TPT_C_LAYERS),
                 "bf16", TPT_BC_SEQ, 4, TPT_WARMUP, TPT_TIMED)]
        tmp = tempfile.mkdtemp(prefix="train_tp_")
        parts = {}
        try:
            plans = {sub[0]: self._tpt_prepare(*sub, bpp, tmp)
                     for sub in subs[:2]}

            def a_done():
                # (b)'s ranks allocate once their files appear: only after
                # (a)'s have ended (their results written, their memory
                # back) do both fit the card
                need = 2 * plans["b"]["local"] * bpp
                deadline = time.time() + TPT_JOIN_S
                while not all(os.path.exists(os.path.join(
                        tmp, f"a.out.{r}")) for r in range(2)) or (
                        self.dev.type == "cuda"
                        and self.torch.cuda.mem_get_info(self.dev)[0] < need):
                    if time.time() > deadline:
                        raise TimeoutError("train_tp: (a)'s ranks did not end")
                    time.sleep(0.2)

            def references():
                plans["a"]["reference"]()
                plans["b"]["reference"](before_publish=a_done)

            ts = time.time()
            ranks = self._spawn_tp(
                [(plans[p]["spec"], 2) for p in plans], tmp,
                join_s=TPT_JOIN_S, meanwhile=references)
            for p, rk in zip(plans, ranks):
                parts[p] = self._tpt_finish(plans[p], rk, time.time() - ts)
            parts["c"] = self._tpt_part(*subs[2], bpp, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        checks = {f"{p}_{k}": v for p in parts
                  for k, v in parts[p].pop("checks").items()}
        self.train_tp_launches = {p: parts[p]["launches_rank0"]
                                  for p in parts}
        return self.record({
            "phase": "train_tp", "ok": all(checks.values()),
            "checks": checks, **parts, "bytes_per_param": bpp,
            "gloo_note": "gloo stages every reduction through the host: "
                         "the step times are a correctness run's",
            "seconds": time.time() - t0})

    def _tpt_part(self, part, cfg, policy, seq, world, warmup, timed, bpp,
                  tmp) -> dict:
        """One ``train_tp`` sub-phase: :meth:`_tpt_prepare`, its ranks
        spawned while its unsharded run goes on here, :meth:`_tpt_finish`."""
        plan = self._tpt_prepare(part, cfg, policy, seq, world, warmup,
                                 timed, bpp, tmp)
        ts = time.time()
        ranks, = self._spawn_tp([(plan["spec"], world)], tmp,
                                flag="--tp-train-child", join_s=TPT_JOIN_S,
                                meanwhile=plan["reference"])
        return self._tpt_finish(plan, ranks, time.time() - ts)

    def _tpt_prepare(self, part, cfg, policy, seq, world, warmup, timed,
                     bpp, tmp, *, faults=None, bounds=None,
                     final=None, batch: int = 1) -> dict:
        """A ``train_tp`` (or ``moe_tp`` training) sub-phase before its
        ranks: the depth reckoned to fit, the ranks' spec and
        ``reference(before_publish=None)``, the unsharded run and its
        control here (each rank's file published by a rename, after
        ``before_publish()``), to run while the ranks start.
        ``faults``, ``bounds`` and ``final`` (the parameters after the
        steps read) default to ``train_tp``'s for ``part``; ``batch``
        rows of ``seq`` tokens a step (an encoder arch's with frames)."""
        torch = self.torch
        from repro_torch.launch.mesh import Mesh
        t0 = time.time()
        mesh = Mesh(data=1, model=world)
        layers = cfg.n_layers
        while world * _local_params(cfg, world) * bpp > TPT_FIT_BYTES \
                and cfg.n_layers > 1:
            cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers // 2)
        local = _local_params(cfg, world)
        heads = cfg.n_heads if cfg.mla is not None else cfg.n_kv
        mode = "no attention" if cfg.n_kv == 0 else \
            "heads" if heads % world == 0 else "seq"
        if faults is None:
            faults = [f for f in TPT_FAULTS
                      if (f != "copy_seq_attn" or mode == "seq")
                      and (f != "nu_shifted" or part == "a")]
        if final is None:
            final = part == "a"
        if bounds is None:
            bounds = TPT_A_BOUNDS if part == "a" else TPT_BOUNDS[part]
        ref = {}
        plan = dict(part=part, cfg=cfg, layers=layers, local=local,
                    bpp=bpp, mode=mode, faults=faults, bounds=bounds,
                    policy=policy, batch=batch,
                    seq=seq, warmup=warmup, timed=timed, ref=ref,
                    control=None, t0=t0, spec=dict(
                        part=part, cfg=cfg, policy=policy,
                        ref=os.path.join(tmp, f"{part}.ref"), batch=batch,
                        seq=seq, warmup=warmup, timed=timed, faults=faults,
                        flag="--tp-train-child"))

        def reference(before_publish=None):
            ref.update(self._tpt_reference(cfg, policy, seq, warmup, timed,
                                           mesh, final=final, batch=batch))
            if policy == "bf16":
                f32 = self._tpt_reference(cfg, "full", seq, warmup, timed,
                                          mesh, final=False, batch=batch)
                per_rank = [_tpt_readings(f32["files"][r], ref["losses"],
                                          ref["grad_norms"],
                                          grads=ref["files"][r]["grads1"])
                            for r in range(world)]
                plan["control"] = {k: max(x[k] for x in per_rank)
                                   for k in per_rank[0]}
            if before_publish is not None:
                before_publish()
            for r, f in ref.pop("files").items():
                path = os.path.join(tmp, f"{part}.ref.{r}")
                torch.save(f, path + ".tmp")
                os.replace(path + ".tmp", path)

        plan["reference"] = reference
        return plan

    def _tpt_finish(self, plan: dict, ranks: list, spawn_s: float,
                    margin: float = 0.0) -> dict:
        """A ``train_tp`` / ``moe_tp`` / ``ssm_tp`` training sub-phase's
        ranks against its unsharded run: launches, agreement, the readings
        within its bounds, every planted fault beyond one (with
        ``margin``, beyond it by more than that factor), the routing."""
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.ssd import ops as ssd_ops
        torch = self.torch
        cfg, policy, ref = plan["cfg"], plan["policy"], plan["ref"]
        warmup, timed, faults = plan["warmup"], plan["timed"], plan["faults"]
        bounds, local, layers = plan["bounds"], plan["local"], plan["layers"]
        control, t0 = plan["control"], plan["t0"]
        # the route's design at this dtype and head_dim, and no other's:
        # the decoder's causal attention (the encoder's runs no kernel) and
        # the SSD chunk, twice a layer a step under remat, their backward
        # once
        dt = torch.float32 if policy == "full" else torch.bfloat16
        flash = cfg.n_kv and cfg.mla is None     # MLA runs no kernel
        fwd = flash_ops.fwd_route(dt, cfg.head_dim) if flash else None
        bwd = flash_ops.bwd_route(dt, dt, dt, cfg.head_dim) if flash \
            else None
        L = cfg.n_layers
        want = {k: 0 for k in self._all_counters()}
        if cfg.mixer in ("attn", "hybrid") and flash:
            want["flash_fwd_sm90" if fwd == "sm90" else "flash_fwd"] = \
                2 * L * timed
            sfx = "_sm90" if bwd == "sm90" else ""
            want.update({"flash_bwd_delta": L * timed,
                         f"flash_bwd_dq{sfx}": L * timed,
                         f"flash_bwd_dkv{sfx}": L * timed})
        if cfg.mixer in ("ssm", "hybrid"):
            n, p = cfg.ssm.d_state, cfg.ssm.head_p
            want["ssd_chunk_sm90" if ssd_ops.ssd_route(n, p) == "sm90"
                 else "ssd_chunk"] = 2 * L * timed
            want["ssd_chunk_bwd_sm90" if ssd_ops.ssd_bwd_route(n, p)
                 == "sm90" else "ssd_chunk_bwd"] = L * timed
        sound = {k: max(rk["readings"][k] for rk in ranks)
                 for k in ranks[0]["readings"]}
        peaks = [rk["peak"] for rk in ranks]
        checks = {
            "launches": all(rk["launches"] == want for rk in ranks),
            "unsharded_launches": ref["launches"] == want,
            "finite": all(rk["finite"] and all(
                math.isfinite(x) for x in rk["losses"] + rk["grad_norms"])
                for rk in ranks) and ref["finite"],
            "ranks_agree": all(
                rk["losses"] == ranks[0]["losses"]
                and rk["grad_norms"] == ranks[0]["grad_norms"]
                for rk in ranks),
            "replicated_bit_equal": all(
                rk["digest_grads1"] == ranks[0]["digest_grads1"]
                and rk["digest_params"] == ranks[0]["digest_params"]
                for rk in ranks),
            "local_params": all(rk["local_params"] == local
                                for rk in ranks),
            "fits": max(peaks) < 80e9,
            "bounds_set": bounds is not None}
        if bounds is not None:
            checks["within_bounds"] = all(sound[k] <= bounds[k]
                                          for k in bounds)
            for f in faults:
                # a fault the gates refuse: some reading beyond its bound
                # (or not finite)
                checks[f"fault_{f}_refused"] = all(
                    any(not rk["faults"][f][k] <= bounds[k]
                        for k in rk["faults"][f] if k in bounds)
                    for rk in ranks)
                if margin:
                    checks[f"fault_{f}_beyond_{margin:g}x"] = all(
                        any(not rk["faults"][f][k] <= margin * bounds[k]
                            for k in rk["faults"][f] if k in bounds)
                        for rk in ranks)
        step_s = [statistics.median(rk["step_s"][warmup:]) for rk in ranks]
        routing = None
        if cfg.moe is not None:
            routing = _routing_summary(ranks, ref["routing_kept"],
                                       ep=cfg.moe.expert_mode == "ep")
            checks["routing_calls"] = routing["calls_equal"]
            checks["routing_near_ties_only"] = routing["not_near_tie"] == 0
            checks["routing_drops_equal"] = routing["kept_equal"]
        return {
            "arch": cfg.arch_id, "layers": L, "depth_cut": None
            if L == layers else {"from": layers, "to": L},
            "policy": policy, "batch": plan["batch"], "seq": plan["seq"],
            "mesh": f"(1, {len(ranks)})", "mode": plan["mode"],
            "steps": {"warmup": warmup, "timed": timed},
            "routes": {"fwd": fwd, "bwd": bwd}, "expected_launches": want,
            "launches_rank0": ranks[0]["launches"],
            "local_params": local,
            "replicated_leaves": ranks[0]["replicated_leaves"],
            "predicted_peak_bytes_per_rank": local * plan["bpp"],
            "max_memory_allocated_bytes": peaks,
            "unsharded_peak_bytes": ref["peak"],
            "losses": ranks[0]["losses"], "grad_norms": ranks[0]["grad_norms"],
            "unsharded": {k: ref[k] for k in ("losses", "grad_norms")},
            "median_step_s": step_s, "unsharded_median_step_s": ref["step_s"],
            "step_s": [rk["step_s"] for rk in ranks],
            "init_s": [rk["init_s"] for rk in ranks],
            "readings": sound, "bf16_control": control, "bounds": bounds,
            "faults": {f: {k: max(rk["faults"][f][k] for rk in ranks)
                           for k in ranks[0]["faults"][f]} for f in faults},
            "routing": routing,
            "spawn_to_join_s": spawn_s, "seconds": time.time() - t0,
            "checks": checks}

    def _tpt_reference(self, cfg, policy, seq, warmup, timed, mesh,
                       final: bool, batch: int = 1) -> dict:
        """The unsharded run for ``train_tp`` here: ``build_train_step``
        (``policy``, remat on every block, the AdamW defaults) from
        ``init_state(--seed)``, ``warmup`` + ``timed`` steps of the
        trainer's synthetic stream (batch 1 x ``seq``), the launch
        counters zeroed between; the first step's gradients of the saved
        leaves (``_tpt_leaves``) and, with ``final``, the leaves after the
        steps, cut into each rank's windows; then every device tensor
        freed.  -> {"files": {rank: what it reads}, the losses, grad
        norms, launches, median timed step, peak}."""
        torch = self.torch
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.launch.train import init_state
        from repro_torch.optim import adamw
        from repro_torch.train.train_step import (TrainConfig,
                                                  build_train_step,
                                                  init_loss_scale)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(self.dev)
        tc = TrainConfig(policy=policy, remat=CheckpointConfig(
            enabled=True, policy="full", segment_size=1),
            opt=adamw.AdamWConfig())
        model, opt = init_state(cfg, self.args.seed, self.dev)
        _seed_biases(model, cfg, self.args.seed)
        batches = _tpt_batches(cfg, batch, seq, self.args.seed, self.dev,
                               warmup + timed)
        names = _tpt_leaves(cfg)
        start = None
        if final:
            start = _tpt_blocks({n: p for n, p in model.named_parameters()
                                 if n in names}, cfg, mesh)
        routing = []
        with _routing_spy(routing, 2 * cfg.n_layers):
            model, recs, launches, first = _tpt_steps(
                build_train_step(cfg, tc), model, opt,
                init_loss_scale(tc, self.dev), batches, warmup, names)
        common = {"losses": [r["loss"] for r in recs],
                  "grad_norms": [r["grad_norm"] for r in recs],
                  "grad_max": {n: float(first[n].abs().max())
                               for n in names}}
        blocks = _tpt_blocks(first, cfg, mesh)
        files = {r: {**common, "grads1": blocks[r], "routing": routing}
                 for r in blocks}
        if final:
            params = {n: p.detach() for n, p in model.named_parameters()
                      if n in names}
            after = _tpt_blocks(params, cfg, mesh)
            top = {n: float(p.abs().max()) for n, p in params.items()}
            for r in files:
                files[r].update(final=after[r], param_max=top, update_norm={
                    n: float((after[r][n] - start[r][n]).norm())
                    for n in names})
            del params, start
        out = {"files": files, "losses": common["losses"],
               "grad_norms": common["grad_norms"],
               "routing_kept": [c["kept"] for c in routing],
               "finite": all(r["grads_finite"] for r in recs),
               "launches": launches,
               "step_s": statistics.median(r["step_s"]
                                           for r in recs[warmup:]),
               "peak": torch.cuda.max_memory_allocated(self.dev)}
        del model, opt, first
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def run_moe_tp(self) -> dict:
        """The MoE FFN over a model axis (see the module docstring, item
        7d): (c)'s and (d)'s unsharded serving runs here first, then the
        ranks of all four sub-phases at once -- (a) / (b) as ``train_tp``'s
        (``_tpt_prepare``: they wait for their unsharded run, which goes
        on here meanwhile), (c) / (d) as ``serve_tp``'s -- then the gates
        (``_tpt_finish``, ``_tp_part``).  gloo stages every reduction
        through the host: the times are a correctness run's."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.models import transformer
        t0 = time.time()
        ds = configs.get_config("deepseek-moe-16b")
        gr = configs.get_config("granite-moe-3b-a800m")
        gr = dataclasses.replace(gr, moe=dataclasses.replace(
            gr.moe, expert_mode="ep"))
        llama = configs.get_config("llama3-8b")
        bpp = getattr(self, "train_bytes_per_param", None) or \
            TRAIN_PEAK_FALLBACK / self._held_params(dataclasses.replace(
                llama, n_layers=TRAIN_LAYERS))
        cut = {p: dataclasses.replace(c, n_layers=MOE_TP_LAYERS[p])
               for p, c in (("a", ds), ("b", gr), ("c", ds), ("d", gr))}
        tmp = tempfile.mkdtemp(prefix="moe_tp_")
        parts, secs = {}, {}
        try:
            ts = time.time()
            trace, unsharded_c, ref_c, control_c = self._tp_unsharded(
                cut["c"], "moe_c", tmp)
            m_d = transformer.init_params(cut["d"], self.args.seed,
                                          device=self.dev,
                                          dtype=torch.bfloat16)
            ref_d, control_d = self._tp_reference(m_d, cut["d"], "bf16", tmp,
                                                  "moe_d")
            del m_d
            gc.collect()
            torch.cuda.empty_cache()
            # (c) and (d) again at f32, where routing is exact: the gates
            # a wrong shard cannot hide under
            ref32, cut32 = {}, {
                p: dataclasses.replace(cut[p], n_layers=MOE_TP_F32_LAYERS[p])
                for p in ("c", "d")}
            for p in ("c", "d"):
                m32 = transformer.init_params(cut32[p], self.args.seed,
                                              device=self.dev,
                                              dtype=torch.float32)
                ref32[p], _ = self._tp_reference(m32, cut32[p], "full", tmp,
                                                 f"moe_{p}32")
                del m32
                gc.collect()
                torch.cuda.empty_cache()
            secs["c_d_unsharded"] = time.time() - ts
            plans = {p: self._tpt_prepare(
                f"moe_{p}", cut[p], "full", MOE_TP_SEQ, world, 0,
                MOE_TP_STEPS, bpp, tmp, faults=list(MOE_TP_FAULTS[p]),
                bounds=MOE_TP_BOUNDS, final=True)
                for p, world in (("a", 2), ("b", 4))}

            def references():
                for p in plans:
                    tr = time.time()
                    plans[p]["reference"]()
                    secs[f"{p}_unsharded"] = time.time() - tr

            ts = time.time()
            # the f32 readings' ranks start with the others but build
            # nothing until (a)'s ranks have ended: (a)'s 16 GB ranks and
            # the unsharded runs leave no room for them beside
            after = [os.path.join(tmp, f"moe_a.out.{r}") for r in range(2)]
            ranks_a, ranks_b, ranks_c, ranks_d, ranks_c32, ranks_d32 = \
                self._spawn_tp([
                    (plans["a"]["spec"], 2), (plans["b"]["spec"], 4),
                    (dict(part="moe_c", cfg=cut["c"], policy="bf16",
                          ref=ref_c, engine=True,
                          faults=MOE_TP_FAULTS["c"]), 2),
                    (dict(part="moe_d", cfg=cut["d"], policy="bf16",
                          ref=ref_d, engine=False,
                          faults=MOE_TP_FAULTS["d"]), 4),
                    (dict(part="moe_c32", cfg=cut32["c"], policy="full",
                          ref=ref32["c"], engine=False, after=after,
                          need=12 * _local_params(cut32["c"], 2),
                          faults=MOE_TP_FAULTS["c"]), 2),
                    (dict(part="moe_d32", cfg=cut32["d"], policy="full",
                          ref=ref32["d"], engine=False, after=after,
                          need=12 * _local_params(cut32["d"], 4),
                          faults=MOE_TP_FAULTS["d"]), 4)], tmp,
                    join_s=TPT_JOIN_S, meanwhile=references)
            spawn_s = time.time() - ts
            secs["ranks"] = spawn_s
            parts["a"] = self._tpt_finish(plans["a"], ranks_a, spawn_s)
            parts["b"] = self._tpt_finish(plans["b"], ranks_b, spawn_s)
            parts["c"] = self._tp_part(
                ranks_c, cut["c"], "bf16", engine=unsharded_c,
                n_req=len(trace), bounds=MOE_TP_BOUND_C, control=control_c)
            parts["d"] = self._tp_part(
                ranks_d, cut["d"], "bf16", engine=None,
                bounds=MOE_TP_BOUND_D, control=control_d)
            for p, rk in (("c", ranks_c32), ("d", ranks_d32)):
                parts[f"{p}_f32"] = self._tp_part(
                    rk, cut32[p], "full", engine=None,
                    bounds=MOE_TP_F32_BOUNDS, margin=FAULT_MARGIN,
                    gate_own_cache=False)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for p, world in (("c", 2), ("d", 4), ("c_f32", 2), ("d_f32", 4)):
            parts[p]["mesh"] = f"(1, {world})"
        checks = {f"{p}_{k}": v for p in parts
                  for k, v in parts[p].pop("checks").items()}
        self.moe_tp_launches = {p: parts[p]["launches_rank0"] for p in parts}
        return self.record({
            "phase": "moe_tp", "ok": all(checks.values()), "checks": checks,
            **parts, "expert_modes": {"a": "tp", "b": "ep", "c": "tp",
                                      "d": "ep"},
            "bytes_per_param": bpp,
            "gloo_note": "gloo stages every reduction through the host, "
                         "and the six sub-phases' 18 ranks share the card "
                         "and the host: the times are a correctness run's",
            "phase_seconds": secs, "seconds": time.time() - t0})

    def run_ssm_tp(self) -> dict:
        """The SSM mixers and the encoder over a model axis (see the
        module docstring, item 7e): (d)'s unsharded serving runs here
        first (f32, then bf16 and its control), (e)'s lockstep processes
        started beside; then the ranks of (a)-(d) at once -- (a)-(c) as
        ``moe_tp``'s training (``_tpt_prepare``: they wait for their
        unsharded run, which goes on here meanwhile), (d) as
        ``serve_tp``'s -- then the gates (``_tpt_finish``, ``_tp_part``)
        and (e)'s.  gloo stages every reduction through the host: the
        times are a correctness run's."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.models import transformer
        t0 = time.time()
        hy = configs.get_config("hymba-1.5b")
        m2 = configs.get_config("mamba2-130m")
        wh = configs.get_config(WHISPER)
        llama = configs.get_config("llama3-8b")
        bpp = getattr(self, "train_bytes_per_param", None) or \
            TRAIN_PEAK_FALLBACK / self._held_params(dataclasses.replace(
                llama, n_layers=TRAIN_LAYERS))
        mla = configs.get_config(MLA_ARCH)
        base = {"a": hy, "b": m2, "c": wh, "d_hymba": hy, "d_whisper": wh,
                "f": mla, "g": mla, "h": hy}
        depth = {**SSM_TP_LAYERS, "f": MLA_TP_LAYERS, "g": MLA_TP_LAYERS,
                 "h": TWO_TIER_TP_LAYERS}
        cut = {p: dataclasses.replace(c, n_layers=depth[p])
               for p, c in base.items()}
        for p in ("c", "d_whisper"):
            cut[p] = dataclasses.replace(cut[p], encoder=dataclasses.replace(
                wh.encoder, n_layers=SSM_TP_LAYERS[p]))
        tmp = tempfile.mkdtemp(prefix="ssm_tp_")
        parts, secs, lock = {}, {}, None
        try:
            lock = self._lockstep_start(tmp)
            ts = time.time()
            refs, controls = {}, {}
            for p, prompt in (("d_hymba", SSM_TP_PROMPT),
                              ("d_whisper", WHISPER_TP_PROMPT),
                              ("g", MLA_TP_PROMPT)):
                m = transformer.init_params(cut[p], self.args.seed,
                                            device=self.dev,
                                            dtype=torch.float32)
                _seed_biases(m, cut[p], self.args.seed)
                refs[p], _ = self._tp_reference(m, cut[p], "full", tmp,
                                                f"ssm_{p}", prompt=prompt)
                m = m.to(torch.bfloat16)
                refs[p + "_bf16"], controls[p] = self._tp_reference(
                    m, cut[p], "bf16", tmp, f"ssm_{p}_bf16", prompt=prompt)
                del m
                gc.collect()
                torch.cuda.empty_cache()
            secs["d_g_unsharded"] = time.time() - ts
            ts = time.time()
            refs["h"] = self._two_tier_reference(cut["h"], tmp)
            secs["h_unsharded"] = time.time() - ts
            seqs = {"c": WHISPER_CTX, "f": MLA_TP_SEQ}
            plans = {p: self._tpt_prepare(
                f"ssm_{p}", cut[p], "full", seqs.get(p, SSM_TP_SEQ), world,
                0, SSM_TP_STEPS, bpp, tmp, faults=list(SSM_TP_FAULTS[p]),
                bounds=MOE_TP_BOUNDS, final=True,
                batch=WHISPER_TP_BATCH if p == "c" else 1)
                for p, world in (("a", 2), ("b", 4), ("c", 2), ("f", 2))}

            def references():
                for p in plans:
                    tr = time.time()
                    plans[p]["reference"]()
                    secs[f"{p}_unsharded"] = time.time() - tr

            ts = time.time()
            serve = ("d_hymba", "d_whisper", "g")
            ranks = self._spawn_tp(
                [(plans[p]["spec"], w) for p, w in (("a", 2), ("b", 4),
                                                    ("c", 2), ("f", 2))]
                + [(dict(part=f"ssm_{p}", cfg=cut[p], policy="full",
                         ref=refs[p], bf16_ref=refs[p + "_bf16"],
                         engine=False, faults=SSM_TP_FAULTS[p]), 2)
                   for p in serve]
                + [(dict(part="ssm_h", cfg=cut["h"], policy="full",
                         ref=refs["h"], engine=False, two_tier=True,
                         faults=SSM_TP_FAULTS["h"]), 2)],
                tmp, join_s=TPT_JOIN_S, meanwhile=references)
            spawn_s = time.time() - ts
            secs["ranks"] = spawn_s
            ranks = dict(zip(("a", "b", "c", "f", *serve, "h"), ranks))
            for p in "abcf":
                parts[p] = self._tpt_finish(plans[p], ranks[p], spawn_s,
                                            margin=FAULT_MARGIN)
            for p in serve:
                # the decode path gated from the unsharded run's cache;
                # from the rank's own (hymba's int8 cache, MLA's bf16
                # latents, each a rounding step off where an f32 reorder
                # crossed a boundary) reported
                parts[p] = self._tp_part(
                    ranks[p], cut[p], "full", engine=None,
                    bounds=MOE_TP_F32_BOUNDS, control=controls[p],
                    margin=FAULT_MARGIN, gate_own_cache=False)
                parts[p]["mesh"] = "(1, 2)"
            parts["h"] = self._two_tier_part(ranks["h"], cut["h"])
            te = time.time()
            parts["e"] = self._lockstep_finish(lock)
            secs["e_wait"] = time.time() - te
        finally:
            for proc in (lock or {}).get("procs", ()):
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            shutil.rmtree(tmp, ignore_errors=True)
        checks = {f"{p}_{k}": v for p in parts
                  for k, v in parts[p].pop("checks").items()}
        self.ssm_tp_launches = {p: parts[p]["launches_rank0"] for p in parts}
        return self.record({
            "phase": "ssm_tp", "ok": all(checks.values()), "checks": checks,
            **parts, "bytes_per_param": bpp,
            "gloo_note": "gloo stages every reduction through the host, "
                         "and the sub-phases' 12 ranks share the card and "
                         "the host: the times are a correctness run's",
            "phase_seconds": secs, "seconds": time.time() - t0})

    def _two_tier_reference(self, cfg, tmp: str) -> str:
        """``ssm_tp`` (h)'s unsharded side here, f32: the uniform prefill of
        TP_BATCH x P seeded tokens (P the largest multiple of the SSD chunk
        within TWO_TIER_TP_PROMPT), its K / V copied into a two-tier cache
        of TWO_TIER_TP_PROMPT + TP_STEPS slots (the window tier holds the
        prompt's slots 0..P-1: P <= the window, so no slot has rolled yet),
        the conv tail and SSM state carried over, greedy decode steps of
        ``decode_step_two_tier`` on to position TWO_TIER_TP_PROMPT, then
        TP_STEPS more; the cache before those, their fed tokens and logits
        saved for the ranks, every device tensor freed after.  -> the
        file."""
        torch = self.torch
        from repro_torch.core.mixed_precision import Policy
        from repro_torch.models import transformer as tf
        b = TP_BATCH
        p = TWO_TIER_TP_PROMPT // cfg.ssm.chunk * cfg.ssm.chunk
        if TWO_TIER_TP_PROMPT > cfg.window:
            raise ValueError("ssm_tp (h): the prompt must fit the window")
        model = tf.init_params(cfg, self.args.seed, device=self.dev,
                               dtype=torch.float32)
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed)
        prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen,
                                device=self.dev, dtype=torch.int32)
        with torch.no_grad():
            logits, aux = tf.forward(model, cfg, {"tokens": prompts},
                                     policy=Policy.full(), build_cache=True,
                                     return_hidden=False)
        uni = aux["cache"]
        cache = tf.init_cache_two_tier(cfg, b, TWO_TIER_TP_PROMPT + TP_STEPS,
                                       device=self.dev)
        for i, (tier, k) in enumerate(tf._tier_slots(cfg)):
            for leaf in ("k", "v", "k_scale", "v_scale"):
                cache[f"{tier}{leaf}"][k][:, :, :p] = uni[leaf][i]
        cache.update(conv=uni["conv"], ssm=uni["ssm"], pos=uni["pos"])
        tok = logits[:, -1, :cfg.vocab].argmax(-1)
        del aux, uni, logits
        with torch.no_grad():
            for _ in range(TWO_TIER_TP_PROMPT - p):
                step, cache = tf.decode_step_two_tier(
                    model, cfg, cache, tok.to(torch.int32),
                    policy=Policy.full(), kvq_splits=TP_SPLITS)
                tok = step[:, :cfg.vocab].argmax(-1)
        cache["first"] = tok
        saved = {k: v.to("cpu", copy=True) for k, v in cache.items()}
        out, tokens = two_tier_forced(model, cfg, cache, None)
        path = os.path.join(tmp, "ssm_h.ref.pt")
        torch.save({"cache": saved, "tokens": tokens, "logits": out}, path)
        del model, cache
        gc.collect()
        torch.cuda.empty_cache()
        return path

    def _two_tier_part(self, ranks: list, cfg) -> dict:
        """``ssm_tp`` (h)'s ranks against the unsharded two-tier decode:
        launches (the decode kernel once a layer a step, by length), each
        tier's slots a rank, the logits of every step within (d)'s decode
        bound, the greedy tokens equal, the ranks alike, each planted fault
        beyond the bound by more than FAULT_MARGIN x."""
        tf_ = [r["tf"] for r in ranks]
        bound = MOE_TP_F32_BOUNDS["decode"]
        want = {k: 0 for k in tf_[0]["launches"]}
        want["flash_decode"] = cfg.n_layers * TP_STEPS
        faults = {f: max(r["faults"][f]["max_rel"] for r in ranks)
                  for f in ranks[0]["faults"]}
        checks = {
            "launches": all(t["launches"] == want for t in tf_),
            "decode_within_bound": max(t["max_rel"] for t in tf_) <= bound,
            "greedy_equal": min(t["greedy_equal"] for t in tf_) == TP_STEPS,
            "ranks_agree": all(t["digest"] == tf_[0]["digest"] for t in tf_),
            "tiers_split": all(
                t["slots"] == {"gk": (TWO_TIER_TP_PROMPT + TP_STEPS) // 2,
                               "wk": cfg.window // 2} for t in tf_),
            "fits": max(r["peak"] for r in ranks) < 80e9}
        for f, v in faults.items():
            checks[f"fault_{f}_beyond_{FAULT_MARGIN:g}x"] = \
                v > FAULT_MARGIN * bound
        return {"arch": cfg.arch_id, "layers": cfg.n_layers,
                "policy": "full", "world": len(ranks), "mesh": "(1, 2)",
                "mode": "seq", "prompt": TWO_TIER_TP_PROMPT,
                "steps": TP_STEPS, "window": cfg.window,
                "slots_rank0": tf_[0]["slots"],
                "decode_rel": max(t["max_rel"] for t in tf_),
                "greedy_equal_steps": min(t["greedy_equal"] for t in tf_),
                "bound": bound, "faults": faults,
                "launches_rank0": tf_[0]["launches"],
                "expected_launches": want,
                "max_memory_allocated_bytes": [r["peak"] for r in ranks],
                "checks": checks}

    def _lockstep_start(self, tmp: str) -> dict:
        """``ssm_tp`` (e)'s processes, started at once: ``launch/serve.py``
        lockstep (``SSM_TP_LOCKSTEP``) under ``torch.distributed.run`` with
        2 ranks, and a 1-rank run, each through ``--lockstep-child``
        (every rank writes what it served, its launches and whether it
        touched the card)."""
        me = str(pathlib.Path(__file__).resolve())
        out = os.path.join(tmp, "lockstep")
        two = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", me]
        procs = [subprocess.Popen(
            [*pre, "--lockstep-child", f"{out}.{name}", *SSM_TP_LOCKSTEP],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, pre in (("two", two), ("one", [sys.executable, me]))]
        return {"out": out, "procs": procs, "t0": time.time()}

    def _lockstep_finish(self, lock: dict) -> dict:
        """``ssm_tp`` (e): the lockstep's ranks against the 1-rank run:
        rank 0's tokens equal, rank 1 served nothing and never touched the
        card, rank 0's launches one SSD chunk a layer (the prefill)."""
        for proc in lock["procs"]:
            out, _ = proc.communicate(timeout=TPT_JOIN_S)
            if proc.returncode != 0:
                raise RuntimeError(f"ssm_tp (e): a lockstep run exited "
                                   f"{proc.returncode}:\n{out[-4000:]}")
        wall = time.time() - lock["t0"]
        rd = lambda name: json.loads(pathlib.Path(   # noqa: E731
            f"{lock['out']}.{name}").read_text())
        r0, r1, one = rd("two.0"), rd("two.1"), rd("one.0")
        from repro_torch import configs
        cfg = configs.get_config(SSM_TP_LOCKSTEP[1])
        # one SSD chunk a layer in the prefill; the SSM's decode step (its
        # O(1) state update) runs no kernel
        want = {k: 0 for k in r0["launches"]}
        want["ssd_chunk_sm90"] = cfg.n_layers
        checks = {"rcs": [r0["rc"], r1["rc"], one["rc"]] == [0, 0, 0],
                  "tokens_equal_one_rank": r0["tokens"] == one["tokens"]
                  and r0["tokens"] is not None,
                  "rank1_served_nothing": r1["tokens"] is None,
                  "rank1_no_card": not r1["cuda_initialized"]
                  and r1["peak"] == 0,
                  "launches": r0["launches"] == want
                  and one["launches"] == want}
        return {"arch": cfg.arch_id, "argv": SSM_TP_LOCKSTEP,
                "mesh": "(1, 2)", "tokens_rank0": r0["tokens"],
                "launches_rank0": r0["launches"],
                "expected_launches": want,
                "peak_bytes": {"rank0": r0["peak"], "rank1": r1["peak"],
                               "one_rank": one["peak"]},
                "rank1_cuda_initialized": r1["cuda_initialized"],
                "prefill_s": [r0["prefill_s"], one["prefill_s"]],
                "decode_s": [r0["decode_s"], one["decode_s"]],
                "wall_s": wall, "checks": checks}

    def run_train_plan(self) -> dict:
        """The ``train`` configuration under eight remat settings, from the
        same weights and batch (see the module docstring, item 8)."""
        import contextlib
        import io
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.launch import train as train_cli
        from repro_torch.train.train_step import TrainConfig, plan_profile
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(configs.get_config("llama3-8b"),
                                  n_layers=TRAIN_LAYERS)
        model, opt = train_cli.init_state(cfg, self.args.seed, self.dev)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        _, batch = next(train_cli.synthetic_lm_batches(
            cfg, 1, TRAIN_SEQ, seed=self.args.seed, device=self.dev))
        prof = plan_profile(cfg, TrainConfig(policy="bf16"), batch)
        # (c) as the trainer's --remat auto solves it
        cli = train_cli.build_parser().parse_args(
            ["--remat", "auto", "--policy", "bf16", "--batch", "1",
             "--seq", str(TRAIN_SEQ)])
        banner = io.StringIO()
        with contextlib.redirect_stdout(banner):
            auto, auto_peak = train_cli._auto_remat(cfg, cli, batch)
        # (d): a budget in whole MiB, as TrainConfig.mem_budget_mb takes it
        budget_mb = int((auto_peak + prof.total_bytes()) / 2) // 2**20
        per_block = CheckpointConfig(policy="full", segment_size=1)
        settings = {        # (remat, mem_budget_mb, ce_chunk)
            "a_off": (CheckpointConfig(enabled=False), 0, 0),
            "b_full": (per_block, 0, 0),
            "c_auto": (auto, 0, 0),
            "d_budget": (CheckpointConfig(), budget_mb, 0),
            "e_dots": (CheckpointConfig(policy="dots"), 0, 0),
            "f_dots_nobatch": (CheckpointConfig(policy="dots_nobatch"), 0, 0),
            "g_save_names": (CheckpointConfig(
                save_names=("attn_out", "ffn_out")), 0, 0),
            "h_ce_chunk": (per_block, 0, CE_CHUNK),
        }
        runs = {name: self._train_plan_run(cfg, model, opt, init, batch,
                                           remat, budget, chunk, prof)
                for name, (remat, budget, chunk) in settings.items()}
        L, n = cfg.n_layers, TRAIN_PLAN_STEPS
        a = runs["a_off"]

        def close(x, y):
            return abs(x - y) <= 1e-3 * abs(y)
        carry = TRAIN_SEQ * cfg.d_model * 2           # bf16 (1, S, D)
        saved = {k: r["saved_after_forward_bytes"] for k, r in runs.items()}
        checks = {
            "first_step_matches_off": all(
                close(r["first_loss"], a["first_loss"])
                and close(r["first_grad_norm"], a["first_grad_norm"])
                for r in runs.values()),
            "fwd_launches": all(
                r["launches"]["flash_fwd_sm90"]
                == (1 if k == "a_off" else 2) * L * n
                and r["launches"]["flash_fwd"] == 0
                for k, r in runs.items()),
            "bwd_launches": all(
                r["launches"][part] == L * n for r in runs.values()
                for part in ("flash_bwd_delta", "flash_bwd_dq_sm90",
                             "flash_bwd_dkv_sm90")),
            "off_saves_most": all(saved["a_off"] > v for k, v in saved.items()
                                  if k != "a_off"),
            "selective_save_at_least_full": all(
                saved[k] >= saved["b_full"]
                for k in ("e_dots", "f_dots_nobatch", "g_save_names")),
            "chunked_ce_lowers_peak": runs["h_ce_chunk"]["fwd_bwd_peak_bytes"]
            < runs["b_full"]["fwd_bwd_peak_bytes"],
            "fits": all(r["max_memory_allocated_bytes"] < 80e9
                        for r in runs.values()),
        }
        segs = {k: len(runs[k]["plan"]["segment_sizes"]) for k in
                ("b_full", "c_auto", "d_budget")}
        return self.record({
            "phase": "train_plan", "ok": all(checks.values()),
            "checks": checks, "arch": cfg.arch_id, "n_layers": L,
            "batch": 1, "seq": TRAIN_SEQ, "policy": "bf16",
            "timed_steps": n, "ce_chunk": CE_CHUNK,
            "profile": {"act_bytes": list(prof.act_bytes),
                        "resid_bytes": list(prof.resid_bytes),
                        "no_remat_bytes": prof.total_bytes()},
            "auto_banner": banner.getvalue().strip(),
            "auto_peak_bytes": auto_peak, "budget_mb": budget_mb,
            "budget_bytes": budget_mb * 2**20,
            "carry_bytes": carry,
            # segment inputs stored under ``full``: the difference against
            # (b) the planner predicts, beside the measured one
            "saved_minus_b": {k: saved[k] - saved["b_full"]
                              for k in ("c_auto", "d_budget")},
            "segments_minus_b_x_carry": {
                k: (segs[k] - segs["b_full"]) * carry
                for k in ("c_auto", "d_budget")},
            "runs": runs})

    def _train_plan_run(self, cfg, model, opt, init, batch, remat,
                        budget_mb, ce_chunk, prof) -> dict:
        """One ``train_plan`` setting: weights and AdamW state reset to
        ``init`` and zeros, the step from ``make_train_step`` (which solves
        a plan for ``budget_mb`` > 0), a warm-up and TRAIN_PLAN_STEPS timed
        steps on ``batch``, one forward and backward for memory, one
        profiled step."""
        import contextlib
        from unittest import mock
        torch = self.torch
        from repro_torch import plan
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.models import transformer
        from repro_torch.optim import adamw
        from repro_torch.train.train_step import (TrainConfig,
                                                  init_loss_scale,
                                                  make_train_step)
        kernels = {"flash_fwd": flash_ops.KERNEL,
                   "flash_fwd_sm90": flash_ops.FWD_SM90,
                   "flash_bwd_delta": flash_ops.BWD_DELTA,
                   "flash_bwd_dq_sm90": flash_ops.BWD_DQ_SM90,
                   "flash_bwd_dkv_sm90": flash_ops.BWD_DKV_SM90}
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(init[name])
            for t in (*opt.mu.values(), *opt.nu.values(), opt.count):
                t.zero_()
        tc = TrainConfig(policy="bf16", remat=remat, mem_budget_mb=budget_mb,
                         opt=adamw.AdamWConfig())
        # the chunked CE has no TrainConfig field (nor has the JAX
        # package's): loss_fn(ce_chunk=) is its only entry
        chunked = mock.patch.object(
            transformer, "loss_fn",
            functools.partial(transformer.loss_fn, ce_chunk=ce_chunk)) \
            if ce_chunk else contextlib.nullcontext()
        ls = init_loss_scale(tc, self.dev)
        records = []
        torch.cuda.reset_peak_memory_stats(self.dev)
        with chunked:
            step, tc = make_train_step(cfg, tc, batch)
            remat = tc.remat                    # (d): the solved plan

            def one_step():
                nonlocal opt, ls
                t = time.time()
                _, opt, ls, m = step(model, opt, ls, batch)
                vals = {k: float(v) for k, v in m.items()}   # syncs
                vals["step_s"] = time.time() - t
                records.append(vals)

            one_step()                                    # warm-up
            for kern in kernels.values():
                kern.launches = 0
            for _ in range(TRAIN_PLAN_STEPS):
                one_step()
            launches = {k: kern.launches for k, kern in kernels.items()}
            steps_peak = torch.cuda.max_memory_allocated(self.dev)
            memory = self._saved_and_peak(model, cfg, batch, remat)
            _, wall, busy_s, rows = self._profile(one_step, host=False)
        gemm = [(name, c) for _, name, c in rows if GEMM_NAME.search(name)]
        timed = records[1:1 + TRAIN_PLAN_STEPS]
        step_s = statistics.median(r["step_s"] for r in timed)
        rp = remat.plan if remat.plan is not None else plan.RematPlan(
            cfg.n_layers, tuple(range(1, cfg.n_layers)))
        rep = plan.plan_report(prof, rp) if remat.enabled else \
            plan.plan_report(prof, plan.RematPlan(cfg.n_layers, ()))
        return {
            "remat": {"enabled": remat.enabled, "policy": remat.policy,
                      "save_names": list(remat.save_names),
                      "segment_size": remat.segment_size},
            "plan": {k: rep[k] for k in ("source", "boundaries",
                                         "segment_sizes", "peak_bytes",
                                         "recompute_frac")},
            "first_loss": records[0]["loss"],
            "first_grad_norm": records[0]["grad_norm"],
            "losses": [r["loss"] for r in records],
            "step_s": [r["step_s"] for r in records],
            "median_step_s": step_s, "tokens_per_s": TRAIN_SEQ / step_s,
            **{k: v for k, v in memory.items() if k != "base_bytes"},
            "max_memory_allocated_bytes": max(
                steps_peak, memory["base_bytes"]
                + memory["fwd_bwd_peak_bytes"]),
            "launches": launches,
            "profiled_step": {"wall_s": wall, "device_busy_s": busy_s,
                              "gemm_launches": sum(c for _, c in gemm),
                              "gemm_kernels": sorted({n[:60]
                                                      for n, _ in gemm})}}

    def run_train_cli(self) -> dict:
        """The trainer's CLI on the card at smoke size: 4 steps with a
        checkpoint every 2, then a second run to 6 steps that resumes;
        then 2 steps under the planner with events, spans and memory
        samples (``--remat auto --mem-budget-mb 1 --events F --trace
        --metrics-every 1``)."""
        from repro_torch.events import read_events
        from repro_torch.obs.schema import validate_events
        from repro_torch.plan import RematPlan
        ckpt = tempfile.mkdtemp(prefix="train_cli_")
        plan_dir = os.path.join(ckpt, "planned")
        mamba = os.path.join(ckpt, "mamba2")
        events = os.path.join(ckpt, "events.jsonl")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
               "--ckpt-every", "2", "--log-every", "1"]
        runs_args = [["--steps", "4", "--fresh", "--ckpt-dir", ckpt],
                     ["--steps", "6", "--ckpt-dir", ckpt],
                     ["--steps", "2", "--fresh", "--ckpt-dir", plan_dir,
                      "--remat", "auto", "--mem-budget-mb", "1", "--events",
                      events, "--trace", "--metrics-every", "1"],
                     # the SSM family: the chunk's backward
                     ["--arch", "mamba2-130m", "--steps", "4", "--fresh",
                      "--ckpt-dir", mamba],
                     ["--arch", "mamba2-130m", "--steps", "6",
                      "--ckpt-dir", mamba],
                     # the other remat modes, f32, the guard
                     ["--arch", "mamba2-130m", "--steps", "2", "--fresh",
                      "--ckpt-dir", os.path.join(ckpt, "mamba2_off"),
                      "--no-remat"],
                     ["--arch", "hymba-1.5b", "--steps", "2", "--fresh",
                      "--ckpt-dir", os.path.join(ckpt, "hymba"), "--remat",
                      "auto", "--mem-budget-mb", "1", "--policy", "full",
                      "--guard"]]
        # five independent chains at once (a resume waits for its first
        # run): the runs share nothing but the card
        chains = [(0, 1), (2,), (3, 4), (5,), (6,)]
        runs = [None] * len(runs_args)

        def chain(ids):
            for i in ids:
                runs[i] = subprocess.run(cmd + runs_args[i], cwd=ROOT,
                                         env=env, capture_output=True,
                                         text=True, timeout=300)
        t0 = time.time()
        try:
            with ThreadPoolExecutor(len(chains)) as pool:
                list(pool.map(chain, chains))
            plan_path = os.path.join(plan_dir, "remat_plan.json")
            plan_text = pathlib.Path(plan_path).read_text() \
                if os.path.exists(plan_path) else ""
            loaded = RematPlan.load(plan_path) if plan_text else None
            evs = read_events(events) if os.path.exists(events) else []
            undeclared = validate_events(events) if evs else {"<none>"}
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        samples = [e for e in evs if e["kind"] == "mem_sample"]
        steps = sorted(e.get("step") for e in evs
                       if e["kind"] == "span_begin"
                       and e["name"] == "train_step")
        checks = {
            "first_exit_0": runs[0].returncode == 0,
            "second_exit_0": runs[1].returncode == 0,
            "on_the_card": "device: cuda" in runs[0].stdout,
            "resumed": "resumed from step 4" in runs[1].stdout,
            "trained_on": "step     5 loss" in runs[1].stdout,
            "planned_exit_0": runs[2].returncode == 0,
            "plan_round_trips": loaded is not None
            and json.loads(plan_text) == json.loads(loaded.to_json()),
            "mem_samples": len(samples) == 2 and all(
                e.get("plan_bytes", 0) > 0 and e["live_bytes"] > 0
                and e.get("frac_of_plan") is not None for e in samples),
            "train_step_spans": steps == [0, 1],
            "events_validate": undeclared == set(),
            "mamba2_exit_0": runs[3].returncode == 0
            and runs[4].returncode == 0,
            "mamba2_resumed": "resumed from step 4" in runs[4].stdout
            and "step     5 loss" in runs[4].stdout,
            "mamba2_no_remat": runs[5].returncode == 0
            and "remat off" in runs[5].stdout,
            "hymba_planned": runs[6].returncode == 0
            and "remat plan [budget:" in runs[6].stdout
            and "step     1 loss" in runs[6].stdout,
        }
        return self.record({
            "phase": "train_cli", "ok": all(checks.values()),
            "checks": checks, "runs_seconds": time.time() - t0,
            "remat_plan": plan_text,
            "mem_samples": samples,
            "stdout": [r.stdout[-1500:] for r in runs],
            "stderr": [r.stderr[-1500:] for r in runs if r.returncode]})

    # -- the paper's CIFAR E-D path --------------------------------------
    def check_pack(self, m: int, hw: int, scale: float = 1.0 / 255.0,
                   shift: float = 0.0) -> list[dict]:
        """The decode and encode kernels against their plain versions on
        the card, for equality, at ``m`` containers of hw x hw x 3."""
        torch = self.torch
        from repro_torch.kernels.pack import ops, ref
        shape = (m, hw, hw, 3)
        gen = torch.Generator(device=self.dev).manual_seed(m * hw)
        words = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                              device=self.dev, dtype=torch.int64).to(
                                  torch.int32)
        flat = words.view(-1)       # the top bit alone, every byte 255
        flat[:2] = torch.tensor([-2 ** 31, -1], dtype=torch.int32)
        packed = words.view(torch.uint32)
        imgs = torch.randint(0, 256, (4 * m, hw, hw, 3), generator=gen,
                             device=self.dev, dtype=torch.uint8)
        n = packed.numel()
        out = []
        dec = ops.decode(packed, scale=scale, shift=shift)
        dec_r = ref.decode_ref(packed, scale, shift)
        enc = ops.encode(imgs).view(torch.int32)
        enc_r = ref.encode_ref(imgs).view(torch.int32)
        back = ops.decode(enc.view(torch.uint32), scale=1.0, shift=0.0)
        self.sync()
        checks = {
            "pack_decode": {"equal": bool(torch.equal(dec, dec_r)),
                            "max_abs_err": float((dec - dec_r).abs().max())},
            "pack_encode": {"equal": bool(torch.equal(enc, enc_r)),
                            "round_trip": bool(torch.equal(back,
                                                           imgs.float())),
                            "max_abs_err": float(
                                (enc.view(torch.uint32).to(torch.int64)
                                 - enc_r.view(torch.uint32).to(torch.int64))
                                .abs().max())}}
        work = {   # bytes: each input read once, each output written once
            "pack_decode": (n * (4 + 16), 8 * n,
                            lambda: ops.decode(packed, scale=scale,
                                               shift=shift),
                            lambda: ref.decode_ref(packed, scale, shift)),
            "pack_encode": (n * (4 + 4), 0,
                            lambda: ops.encode(imgs),
                            lambda: ref.encode_ref(imgs))}
        for name, (nbytes, flops, kern, plain) in work.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["float32"] * 1e3
            c = checks[name]
            out.append(self.record({
                "phase": "kernel", "name": name,
                "ok": all(v for k, v in c.items() if k != "max_abs_err"),
                "shape": {"containers": m, "pixels": hw * hw * 3,
                          "images": 4 * m, "uint32": n},
                "scale": scale, "shift": shift, **c, "tol": 0.0,
                "kernel_ms": self.time_ms(kern),
                "plain_ms": self.time_ms(plain, n=20), "library_ms": None,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "bytes": nbytes, "flops": flops}))
        return out

    def check_cifar_model(self) -> dict:
        """Full-width ResNet-18 through ``loss_fn`` on one packed batch of
        32, on the card (decode kernel, cuDNN) and on the CPU (plain
        versions), from one set of weights, f32 with TF32 off."""
        torch = self.torch
        from repro_torch.core import encoding
        from repro_torch.data.synthetic import make_cifar_like
        from repro_torch.models import cnn
        cfg = cnn.resnet18()
        imgs, labels = make_cifar_like(n=32, seed=self.args.seed)
        packed = torch.from_numpy(encoding.pack_u8_to_u32(imgs))
        lab = torch.from_numpy(labels)
        cpu = cnn.init_params(cfg, self.args.seed, device="cpu")
        runs = {}
        for name, dev in (("cpu", torch.device("cpu")), ("card", self.dev)):
            params = {n: p.to(dev).requires_grad_() for n, p in cpu.items()}
            with torch.no_grad():
                logits = cnn.forward(params, cfg, packed.to(dev),
                                     decode=True)
            loss, aux = cnn.loss_fn(params, cfg, packed.to(dev),
                                    lab.to(dev), decode=True)
            grads = torch.autograd.grad(loss, list(params.values()))
            runs[name] = (logits.cpu(), float(loss.detach()),
                          float(aux["acc"]),
                          {n: g.cpu() for n, g in zip(params, grads)})
        self.sync()
        (lw, losw, accw, gw), (lg, losg, accg, gg) = runs["cpu"], \
            runs["card"]

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())
        grad_errs = {n: rel(gg[n], gw[n]) for n in gw}
        worst = max(grad_errs, key=grad_errs.get)
        tol = 1e-3   # cuDNN's algorithms sum in another order than the CPU
        errs = {"logits": rel(lg, lw),
                "loss": abs(losg - losw) / abs(losw),
                "grad_max": grad_errs[worst]}
        return self.record({
            "phase": "cifar_model", "ok": all(e <= tol for e in
                                              errs.values()),
            "arch": cfg.arch_id, "widths": list(cfg.widths),
            "stage_sizes": list(cfg.stage_sizes), "batch": 32,
            "packed_containers": 8, "loss": {"cpu": losw, "card": losg},
            "acc": {"cpu": accw, "card": accg}, "rel_err": errs,
            "worst_grad": worst, "tol_rel": tol,
            "params": sum(p.numel() for p in cpu.values())})

    def _example(self):
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "cifar_optorch_torch", ROOT / "examples" / "cifar_optorch_torch.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod

    def run_cifar_train(self) -> dict:
        """The example's ``train()`` for the four pipelines at full width,
        CIFAR_STEPS steps each, on the card; the decode and encode launch
        counters are zeroed just before each run and read just after."""
        torch = self.torch
        from repro_torch.data.synthetic import make_cifar_like
        from repro_torch.kernels.pack import ops as pack_ops
        from repro_torch.models import cnn
        ex = self._example()
        imgs, labels = make_cifar_like(n=2048, seed=0)
        pipes, launches = {}, {"pack_decode": 0, "pack_encode": 0}
        for pipe in ex.PIPELINES:
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated(self.dev)
            pack_ops.DECODE.launches = 0        # the main path's counts
            pack_ops.ENCODE.launches = 0
            r = ex.train(pipe, imgs, labels, CIFAR_STEPS,
                         seed=self.args.seed, device=self.dev, log_every=0)
            got = {"pack_decode": pack_ops.DECODE.launches,
                   "pack_encode": pack_ops.ENCODE.launches}
            for k in launches:
                launches[k] += got[k]
            step_ms = statistics.median(r.step_s[10:]) * 1e3
            pipes[pipe] = {
                "acc": r.acc, "median_step_ms": step_ms,
                "images_per_s": ex.BATCH / (step_ms / 1e3),
                "seconds": r.seconds,
                "max_memory_allocated_bytes": r.peak_bytes,
                "allocated_before_bytes": before,   # the L2 flush buffer
                "launches": got,
                "plan_boundaries": list(r.plan.boundaries) if r.plan
                else None,
                "losses_first_last": [r.losses[0], r.losses[-1]],
                "losses_finite": all(math.isfinite(v) for v in r.losses)}
        self.cifar_launches = launches
        base = pipes["baseline"]["acc"]
        checks = {
            "parity": all(p["acc"] > base - 0.1 for p in pipes.values()),
            "baseline_vs_jax_cpu": abs(base - JAX_CPU_BASELINE_ACC) <= 0.1,
            "decode_launches": all(
                p["launches"]["pack_decode"]
                == (CIFAR_STEPS if "ED" in name else 0)
                for name, p in pipes.items()),
            "sc_plan": all((p["plan_boundaries"] is not None)
                           == ("SC" in name) for name, p in pipes.items()),
            "losses_finite": all(p["losses_finite"] for p in pipes.values()),
        }
        params = cnn.init_params(cnn.resnet18(), self.args.seed,
                                 device=self.dev)
        prof_steps = CIFAR_PROFILE_STEPS
        r, wall, busy_s, rows = self._profile(lambda: ex.train(
            "ED+SC+MP", imgs, labels, prof_steps, seed=self.args.seed,
            device=self.dev, params=params, log_every=0), host=False)
        return self.record({
            "phase": "cifar_train", "ok": all(checks.values()),
            "checks": checks, "arch": "resnet18", "steps": CIFAR_STEPS,
            "batch": ex.BATCH, "dataset": "make_cifar_like(n=2048, seed=0)",
            "jax_cpu_baseline_acc": JAX_CPU_BASELINE_ACC,
            "pipelines": pipes, "kernel_launches": launches,
            "profile": {"pipeline": "ED+SC+MP", "steps": prof_steps,
                        "wall_s": wall, "device_busy_s": busy_s,
                        "idle_share": 1 - busy_s / wall if wall > 0
                        else None,
                        "median_step_ms": statistics.median(r.step_s[5:])
                        * 1e3,
                        "top_kernels_ms": [[name[:80], round(us / 1e3, 3), c]
                                           for us, name, c in rows[:25]]}})

    def run_cifar_memory(self) -> dict:
        """The paper's memory experiment at the fig8 shape: ResNet-18 with
        stem_stride=2 on 16 x 512x512x3, one forward and backward per
        pipeline, peak device memory above the parameters and gradients
        (the input is made inside the measured region: E-D's u32 batch is
        a quarter of the f32 one)."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import encoding
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.models import cnn
        from repro_torch.plan import RematPlan
        cfg = cnn.resnet18(stem_stride=2)
        shape = (16, 512, 512, 3)
        u8 = np.random.default_rng(self.args.seed).integers(
            0, 256, shape, dtype=np.uint8)
        labels = torch.from_numpy(np.arange(16) % 10).to(self.dev)
        host = {False: torch.from_numpy(u8.astype(np.float32) / 255.0),
                True: torch.from_numpy(encoding.pack_u8_to_u32(u8))}
        gc.collect()
        torch.cuda.empty_cache()
        params = cnn.init_params(cfg, self.args.seed, device=self.dev)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in params.values())
        n_fns = cnn.num_layer_fns(cfg)
        pipes = {"B": (False, False, False), "ED": (True, False, False),
                 "SC": (False, True, False), "ED+SC": (True, True, False),
                 "ED+SC+MP": (True, True, True)}
        out = {}
        for name, (ed, sc, mp) in pipes.items():
            remat = CheckpointConfig(plan=RematPlan.uniform(n_fns, 8)) \
                if sc else None

            def run():
                x = host[ed].to(self.dev)
                ps = {n: p.detach().requires_grad_()
                      for n, p in params.items()}
                use = {n: p.to(torch.bfloat16) for n, p in ps.items()} \
                    if mp else ps
                loss, _ = cnn.loss_fn(use, cfg, x, labels, remat=remat,
                                      decode=ed)
                # what the forward left for the backward: the saved
                # activations (and the input), no cuDNN workspace
                saved = torch.cuda.memory_allocated(self.dev)
                grads = torch.autograd.grad(loss, list(ps.values()))
                return (float(loss.detach()), x.numel() * x.element_size(),
                        all(bool(torch.isfinite(g).all()) for g in grads),
                        saved)
            run()                                 # warm-up: cuDNN algos
            gc.collect()
            torch.cuda.empty_cache()
            self.sync()
            base = torch.cuda.memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
            t = time.time()
            loss, in_bytes, finite, saved = run()
            step_s = time.time() - t
            peak = torch.cuda.max_memory_allocated(self.dev)
            out[name] = {"peak_above_params_and_grads_bytes":
                         peak - base - param_bytes,
                         "saved_after_forward_bytes": saved - base,
                         "input_bytes": in_bytes, "loss": loss,
                         "grads_finite": finite, "step_s": step_s,
                         "plan": list(remat.plan.boundaries) if remat
                         else None}
        base_loss = out["B"]["loss"]
        checks = {
            "grads_finite": all(v["grads_finite"] for v in out.values()),
            "f32_losses_agree": all(
                abs(out[k]["loss"] - base_loss) <= 1e-4 * abs(base_loss)
                for k in ("ED", "SC", "ED+SC")),
            "mp_loss_close": abs(out["ED+SC+MP"]["loss"] - base_loss)
            <= 5e-2 * abs(base_loss),
            "input_is_a_quarter": out["ED"]["input_bytes"] * 4
            == out["B"]["input_bytes"],
        }
        return self.record({
            "phase": "cifar_memory", "ok": all(checks.values()),
            "checks": checks, "arch": cfg.arch_id, "stem_stride": 2,
            "shape": list(shape), "param_bytes": param_bytes,
            "pipelines": out})

    # -- the SSM serving slice -------------------------------------------
    def check_ssd(self, g: int, t: int, q: int, n: int, p: int,
                  heads: int) -> dict:
        """The SSD chunk kernel of ``ops.ssd_route``'s route against its
        plain version on the card, B and C head-shared as the serving path
        passes them (the plain version takes them broadcast over the
        heads).  The sm90 route's line also sweeps the heads a CTA walks
        (``ops.heads_per_cta`` picks ``group``)."""
        torch = self.torch
        from repro_torch.kernels.ssd import ops, ref
        gen = torch.Generator(device=self.dev).manual_seed(g + t + q + n)
        rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                         device=self.dev)
        c, b = rnd(g // heads, t, q, n), rnd(g // heads, t, q, n)
        x = rnd(g, t, q, p)
        acum = torch.cumsum(-0.2 * torch.rand((g, t, q), generator=gen,
                                              device=self.dev), dim=-1)
        route = ops.ssd_route(n, p)
        kernels = {"sm90": ops.KERNEL_SM90, "fma": ops.KERNEL}
        before = {k: v.launches for k, v in kernels.items()}
        y, st = ops.ssd_chunk(c, b, x, acum)
        launched = {k: v.launches - before[k] for k, v in kernels.items()}
        cf, bf = (z.repeat_interleave(heads, 0) for z in (c, b))
        y_r, st_r = ref.ssd_chunk_ref(cf, bf, x, acum)
        self.sync()
        errs = {"y": float((y - y_r).abs().max()),
                "state": float((st - st_r).abs().max())}
        # f32 on both sides: the FMA kernel and cuBLAS without TF32 differ
        # in summation order only; the sm90 kernel's 3xTF32 products carry
        # ~2^-22 of each operand
        tols = {"y": 1e-4 * float(y_r.abs().max()),
                "state": 1e-4 * float(st_r.abs().max())}
        ok = all(errs[k] <= tols[k] for k in errs) and launched == {
            r: int(r == route) for r in kernels}
        ms = self.time_ms(lambda: ops.ssd_chunk(c, b, x, acum))
        plain_ms = self.time_ms(lambda: ref.ssd_chunk_ref(cf, bf, x, acum),
                                n=20)
        pairs = g // heads * t
        group = None
        sweep = {}
        if route == "sm90":
            group = ops.heads_per_cta(pairs, heads, torch.cuda
                                      .get_device_properties(self.dev)
                                      .multi_processor_count)
            # the C entry point's group argument, past heads_per_cta
            outs = torch.empty_like(y), torch.empty_like(st)
            args = [z.data_ptr() for z in (c, b, x, acum, *outs)] + [
                g, t, q, n, p, heads]
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            for grp in sorted({1, 2, 3, 4, 6, 8, 12, heads}):
                sweep[grp] = self.time_ms(
                    lambda: ops.KERNEL_SM90(*args, grp, stream), n=10)
        # what these inputs need: the scores C B^T once per (batch, chunk)
        # (the heads share C and B) on the Q(Q+1)/2 entries that pass the
        # causal mask, 2N flops each; G x_bar 2P a live entry; the state
        # 2QNP a head-chunk
        live = q * (q + 1) // 2
        flops = pairs * live * 2 * n + g * t * (live * 2 * p + 2 * q * n * p)
        nbytes = 4 * (2 * (g // heads) * t * q * n + 2 * g * t * q * p
                      + g * t * q + g * t * n * p)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_fma = flops / PEAK_FLOPS["float32"] * 1e3
        # the sm90 route's products: three TF32 passes on the tensor cores
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3 if route == "sm90" \
            else t_fma
        return self.record({
            "phase": "kernel", "name": "ssd_chunk", "route": route, "ok": ok,
            "shape": {"G": g, "T": t, "Q": q, "N": n, "P": p,
                      "heads_sharing_BC": heads},
            "launched": launched, "group": group,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "tol": tols, "tol_rel": 1e-4, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "group_sweep_ms": sweep,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
            "bound_fma_ms": max(t_fma, t_bytes),
            "flops": flops, "bytes": nbytes})

    def check_decode_band(self, splits: int, *, bias: bool, hkv: int = 5,
                          g: int = 5, d: int = 64,
                          arch: str = "hymba-1.5b") -> dict:
        """The decode kernel at the serve_ssm run's decode shape (B=8, the
        cache of SSM_PROMPT + SSM_GEN slots, its last position), by
        default at hymba's heads (Hkv=5, G=5, D=64): a window layer's dense
        band bias (window 1024), or a global layer's lengths."""
        torch = self.torch
        from repro_torch.kernels import tiling
        from repro_torch.kernels.kvq import ops, ref
        from repro_torch.models import attention
        b = SSM_BATCH
        s, window = SSM_PROMPT + SSM_GEN, 1024
        pos = torch.tensor(s - 2, dtype=torch.int32, device=self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(splits + 50)
        q = torch.randn((b, hkv * g, d), generator=gen, device=self.dev)
        kq, ks = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        vq, vs = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        lengths, mask = attention.decode_mask(pos, b, s,
                                              window if bias else 0)
        kw = dict(lengths=lengths, bias=mask)
        out, cnt = ops.decode_attention(q, kq, ks, vq, vs, splits=splits,
                                        counts=True, **kw)
        qg = q.reshape(b, hkv, g, d)
        sm = d ** -0.5
        if splits == 1:
            plain = lambda: ref.decode_attention_ref(  # noqa: E731
                qg, kq, ks, vq, vs, mask, sm, lengths=lengths)
        else:
            plain = lambda: ref.decode_attention_splitk_ref(  # noqa: E731
                qg, kq, ks, vq, vs, sm, splits=splits, **kw)
        out_r = plain().reshape(b, hkv * g, d)
        self.sync()
        err = float((out - out_r).abs().max())
        lens = None if bias else lengths.tolist()
        twin = tiling.decode_tile_step_counts(s, lens, splits=splits)
        # with a bias every row visits every tile: the twin's one row
        rows = twin["counts"] * b if bias else twin["counts"]
        counts_ok = cnt.cpu().tolist() == [[row] * hkv for row in rows]
        # f32 both; summation order only (the split merge for splits > 1).
        # Each output averages ~1,000 random V rows (|out| ~0.03): a band
        # one slot off moves it by 1e-4 or more
        tol = 1e-5
        ok = err <= tol and counts_ok and bool(torch.isfinite(out).all())
        ms = self.time_ms(lambda: ops.decode_attention(
            q, kq, ks, vq, vs, splits=splits, **kw))
        plain_ms = self.time_ms(plain, n=20)
        # a dense bias reads every slot (and the bias); lengths the live ones
        live = b * s if bias else sum(lens)
        nbytes = hkv * live * (2 * d + 8) + q.numel() * 4 * 2 \
            + (b * s * 4 if bias else b * 4)
        flops = 4 * hkv * g * d * live
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return self.record({
            "phase": "kernel",
            "name": "flash_decode_bias" if bias else "flash_decode",
            "ok": ok, "arch": arch,
            "shape": {"B": b, "Hkv": hkv, "G": g, "D": d, "S": s,
                      "splits": twin["splits"], "pos": s - 2,
                      "window": window if bias else 0},
            **self._rate(nbytes, ms, max(t_ops, t_bytes)),
            "max_abs_err": err, "tol": tol, "counts_ok": counts_ok,
            "tiles_visited": sum(map(sum, rows)) * hkv,
            "tiles_dense": twin["ns"] * b * hkv,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes})

    def check_ssm_model(self) -> dict:
        """2-layer mamba2 and hymba at full width, prefill 256 tokens (two
        chunks) and decode 80 steps (past hymba's reduced window of 64) on
        the card and on the CPU, same weights, f32, the CPU's greedy tokens
        fed to both.  Two comparisons of the decode:

        * stepwise: every step starts the card from a copy of the CPU's
          cache, so each step's error is that step's alone;
        * free-running: the card keeps its own cache for all 80 steps.

        A step whose greedy tokens differ counts as a fault unless the
        CPU's top two logits are within twice that step's logit error of
        each other (a tie)."""
        import numpy as np
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.mixed_precision import Policy
        from repro_torch.models import bridge, transformer as tf
        prompt, steps = 256, 80
        pol = Policy.full()

        def rel(a, b):
            a, b = a.cpu().float(), b.float()
            return float((a - b).abs().max() / b.abs().max())

        def greedy_faults(lg, lw):
            abs_err = float((lg - lw).abs().max())
            want, got = lw.argmax(-1), lg.argmax(-1)
            miss = [r for r in range(want.shape[0]) if want[r] != got[r]]
            return len(miss), sum(float(lw[r, want[r]] - lw[r, got[r]])
                                  > 2 * abs_err for r in miss)

        def cache_errs(cg, cc):
            errs, off = {}, {}
            for name in cc:
                if name == "pos":
                    continue
                a, b = cg[name].cpu(), cc[name]
                if a.dtype == torch.int8:
                    d = (a.int() - b.int()).abs()
                    errs[name], off[name] = int(d.max()), float(
                        d.gt(0).float().mean())
                else:
                    errs[name] = rel(a, b)
            return errs, off

        out = {}
        for arch, extra in (("mamba2-130m", {}),
                            ("hymba-1.5b", {"window": 64,
                                            "global_layers": (0,)})):
            cfg = dataclasses.replace(configs.get_config(arch), n_layers=2,
                                      **extra)
            cpu = tf.init_params(cfg, self.args.seed, device="cpu")
            gpu = bridge.load_jax_params(cfg, bridge.export_params(cpu),
                                         device=self.dev)
            rng = np.random.default_rng(self.args.seed)
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt))
                                      .astype(np.int32))
            live = slice(0, cfg.vocab)
            to_card = lambda c: {n: t.to(self.dev, copy=True)  # noqa: E731
                                 for n, t in c.items()}
            step_err, step_miss, step_faults = 0.0, 0, 0
            free_err, free_miss, free_faults = 0.0, 0, 0
            with torch.no_grad():
                lw, aux_c = tf.forward(cpu, cfg, {"tokens": tokens},
                                       policy=pol, build_cache=True)
                lg, aux_g = tf.forward(gpu, cfg,
                                       {"tokens": tokens.to(self.dev)},
                                       policy=pol, build_cache=True)
                prefill_err = rel(lg[..., live], lw[..., live])
                prefill_cache, prefill_off = cache_errs(aux_g["cache"],
                                                        aux_c["cache"])
                cache_c = tf.grow_cache(aux_c["cache"], prompt + steps)
                free = tf.grow_cache(aux_g["cache"], prompt + steps)
                tok = lw[:, -1, live].argmax(-1).to(torch.int32)
                for _ in range(steps):
                    synced = to_card(cache_c)
                    lw, cache_c = tf.decode_step(cpu, cfg, cache_c, tok,
                                                 policy=pol)
                    ls, _ = tf.decode_step(gpu, cfg, synced,
                                           tok.to(self.dev), policy=pol)
                    lf, free = tf.decode_step(gpu, cfg, free,
                                              tok.to(self.dev), policy=pol)
                    lw, ls, lf = lw[:, live], ls[:, live].cpu(), \
                        lf[:, live].cpu()
                    step_err = max(step_err, rel(ls, lw))
                    free_err = max(free_err, rel(lf, lw))
                    m, f = greedy_faults(ls, lw)
                    step_miss, step_faults = step_miss + m, step_faults + f
                    m, f = greedy_faults(lf, lw)
                    free_miss, free_faults = free_miss + m, free_faults + f
                    tok = lw.argmax(-1).to(torch.int32)
            free_cache, free_off = cache_errs(free, cache_c)
            # prefill: f32 both sides, TF32 off, summation order only.  A
            # decode step also writes the new token's int8 K/V, which may
            # round one step apart (as in the llama model phase).  Free
            # running, the conv tail is stored in bf16 on both sides: where
            # the f32 values straddle a rounding boundary the two caches
            # differ by one bf16 ulp (2^-7 relative), and every later step
            # reads it, so the drift is held at that scale.
            tol = {"prefill_logits": 1e-4, "step_logits": 1e-3,
                   "free_logits": 2 ** -7, "int8": 1, "int8_off_frac": 1e-3,
                   "scales": 1e-3, "conv": 2 ** -7, "ssm": 2 ** -7}
            leaf_tol = {"k": tol["int8"], "v": tol["int8"],
                        "k_scale": tol["scales"], "v_scale": tol["scales"],
                        "conv": tol["conv"], "ssm": tol["ssm"]}
            ok = (prefill_err <= tol["prefill_logits"]
                  and step_err <= tol["step_logits"]
                  and free_err <= tol["free_logits"]
                  and step_faults == 0 and free_faults == 0
                  and all(e[n] <= leaf_tol[n] for e in (prefill_cache,
                                                        free_cache)
                          for n in e)
                  and all(v <= tol["int8_off_frac"]
                          for v in (*prefill_off.values(),
                                    *free_off.values())))
            out[arch] = {
                "ok": ok, "n_layers": 2, "window": cfg.window,
                "global_layers": list(cfg.global_layers),
                "prefill_logits_rel_err": prefill_err,
                "prefill_cache_err": prefill_cache,
                "prefill_int8_off_frac": prefill_off,
                "step_logits_rel_err": step_err,
                "free_logits_rel_err": free_err,
                "free_cache_err": free_cache, "free_int8_off_frac": free_off,
                "greedy_mismatches": {"step": step_miss, "free": free_miss},
                "greedy_faults": {"step": step_faults, "free": free_faults}}
        return self.record({
            "phase": "ssm_model", "ok": all(v["ok"] for v in out.values()),
            "prompt": [2, prompt], "decode_steps": steps, "tol": tol,
            "models": out})

    def _profile_lockstep(self, args, cfg, model, steps: int,
                          frames=None) -> dict:
        """``torch.profiler`` over lockstep's prefill, then over its first
        ``steps`` decode steps, at the measured run's shapes: the same
        prompts (and ``frames``: the encoder runs in the prefill, and the
        decode steps attend over its output), the cache grown to prompt +
        gen slots (so the decode kernel walks the same tiles), the same
        sampler.  A few steps keep the trace small: its processing, not
        the run, is what costs.  Each part reports the decode kernel's and
        the GEMMs' device ms, and its profiler ranges (the SSD op's
        ``ssd.*`` in ``ssd_op_ms``, the encoder-decoder's ``encdec.*`` in
        ``encdec_ms``)."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.mixed_precision import get_policy
        from repro_torch.models import transformer
        from repro_torch.serve import sampling
        policy, quant = get_policy(args.policy), not args.no_quantize
        sampler = sampling.make_sampler(temperature=args.temperature,
                                        top_k=args.top_k)
        gen = torch.Generator(device=self.dev).manual_seed(args.seed)
        rng = np.random.default_rng(args.seed)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
        ).to(self.dev)
        batch = {"tokens": prompts}
        if frames is not None:
            batch["frames"] = frames

        def prefill():
            logits, aux = transformer.forward(
                model, cfg, batch, policy=policy,
                build_cache=True, cache_quantized=quant)
            cache = transformer.grow_cache(aux["cache"],
                                           args.prompt_len + args.gen)
            tok = sampler(logits[:, -1], gen)
            tok.cpu()
            return cache, tok, aux.get("enc_out")

        def decode(cache, tok, enc_out):
            for _ in range(steps):
                logits, cache = transformer.decode_step(
                    model, cfg, cache, tok, policy=policy, quantized=quant,
                    kvq_splits=args.kv_splits, enc_out=enc_out)
                tok = sampler(logits, gen)
                tok.cpu()

        def part(wall, busy_s, rows):
            scopes = sorted(self.last_scopes.items())
            return {"wall_s": wall, "device_busy_s": busy_s,
                    "idle_share": 1 - busy_s / wall if wall > 0 else None,
                    "decode_kernel_ms": sum(
                        us for us, name, _ in rows
                        if "decode_kernel" in name) / 1e3,
                    "gemm_ms": sum(us for us, name, _ in rows
                                   if GEMM_NAME.search(name)) / 1e3,
                    "ssd_op_ms": {k: v for k, v in scopes
                                  if k.startswith("ssd.")},
                    "encdec_ms": {k: v for k, v in scopes
                                  if k.startswith("encdec.")},
                    "top_kernels_ms": [[name[:80], round(us / 1e3, 3), c]
                                       for us, name, c in rows[:12]]}

        (cache, tok, enc_out), *pre = self._profile(prefill)
        out = {"prefill": part(*pre)}
        _, *dec = self._profile(lambda: decode(cache, tok, enc_out))
        out["decode"] = part(*dec)
        out["decode"]["steps"] = steps
        return out

    def run_serve_ssm(self) -> dict:
        """``launch/serve.py``'s lockstep at full width and
        ``SSM_CELL_LAYERS`` for mamba2-130m and hymba-1.5b, as ``python -m
        repro_torch.launch.serve --arch ... --batch 8 --prompt-len 2048
        --gen 32`` runs it: a
        warm-up run of one decode step, then the measured run with every
        launch counter zeroed just before it and read just after, then a
        profile of its prefill and first decode steps."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.kvq import ops as kvq_ops
        from repro_torch.kernels.ssd import ops as ssd_ops
        from repro_torch.launch import serve
        from repro_torch.models import transformer
        kernels = {"ssd_chunk_sm90": ssd_ops.KERNEL_SM90,
                   "ssd_chunk": ssd_ops.KERNEL,
                   "flash_fwd": flash_ops.KERNEL,
                   "flash_fwd_sm90": flash_ops.FWD_SM90,
                   "flash_decode": kvq_ops.KERNEL,
                   "flash_decode_bias": kvq_ops.BIAS_KERNEL}
        runs, total = {}, {k: 0 for k in kernels}
        for arch in ("mamba2-130m", "hymba-1.5b"):
            gc.collect()
            torch.cuda.empty_cache()
            argv = ["--arch", arch, "--batch", str(SSM_BATCH),
                    "--prompt-len", str(SSM_PROMPT), "--gen", str(SSM_GEN),
                    "--policy", "bf16", "--seed", str(self.args.seed)]
            args = serve.build_parser().parse_args(argv)
            cfg = dataclasses.replace(configs.get_config(arch),
                                      n_layers=SSM_CELL_LAYERS[arch])
            t0 = time.time()
            model = serve.build_model(args, cfg, self.dev)
            self.sync()
            init_s = time.time() - t0
            t0 = time.time()
            serve.lockstep(argparse.Namespace(**{**vars(args), "gen": 2}),
                           cfg, model, self.dev)
            warmup_s = time.time() - t0
            torch.cuda.reset_peak_memory_stats(self.dev)
            for k in kernels.values():                  # the main path's
                k.launches = 0                          # counts
            r = serve.lockstep(args, cfg, model, self.dev)
            launches = {n: k.launches for n, k in kernels.items()}
            peak = torch.cuda.max_memory_allocated(self.dev)
            for n in total:
                total[n] += launches[n]
            windows = transformer.layer_windows(cfg)
            n_attn = cfg.n_layers if cfg.mixer != "ssm" else 0
            n_band = sum(w > 0 for w in windows) if n_attn else 0
            steps = SSM_GEN - 1
            want = {"ssd_chunk_sm90": cfg.n_layers, "ssd_chunk": 0,
                    "flash_fwd": 0,
                    "flash_fwd_sm90": n_attn,
                    "flash_decode": (n_attn - n_band) * steps,
                    "flash_decode_bias": n_band * steps}
            toks = r["tokens"]
            checks = {
                "launches": launches == want,
                "tokens_shape": toks.shape == (SSM_BATCH, SSM_GEN),
                "tokens_in_vocab": bool(((toks >= 0)
                                         & (toks < cfg.vocab)).all()),
                "fits": peak < 80e9}
            prof = self._profile_lockstep(args, cfg, model, steps=4)
            # the whole run's idle share: the profiled device time of the
            # prefill and of a decode step, over the measured run's wall
            busy = prof["prefill"]["device_busy_s"] + prof["decode"][
                "device_busy_s"] / prof["decode"]["steps"] * steps
            wall = r["prefill_s"] + r["decode_s"]
            runs[arch] = {
                "ok": all(checks.values()), "checks": checks,
                "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                "params": sum(p.numel() for p in model.parameters()),
                "prefill_ms": r["prefill_s"] * 1e3,
                "decode_ms_per_token": r["decode_s"] / steps * 1e3,
                "decode_tokens_per_s": SSM_BATCH * steps / r["decode_s"],
                "max_memory_allocated_bytes": peak, "init_s": init_s,
                "warmup_s": warmup_s,
                "kernel_launches": launches, "expected_launches": want,
                "sample": toks[0][:8].tolist(),
                "idle_share_run": 1 - busy / wall, "profile": prof}
            del model
        self.ssm_launches = total
        return self.record({
            "phase": "serve_ssm", "ok": all(v["ok"] for v in runs.values()),
            "batch": SSM_BATCH, "prompt": SSM_PROMPT, "gen": SSM_GEN,
            "policy": "bf16", "kv": "int8", "kv_splits": 1, "runs": runs})

    # -- training the SSM family ------------------------------------------
    def check_ssd_bwd(self, g: int, t: int, q: int, n: int, p: int,
                      heads: int) -> dict:
        """The SSD chunk's backward kernel of ``ops.ssd_bwd_route``'s route
        (``ssd_bwd_sm90.cu`` at head_p 64, ``ssd_bwd.cu`` at 16) against
        its plain version (``ref.ssd_chunk_bwd_ref``) on the card, C and B
        head-shared as the training path passes them: dc, db, dxbar and
        dacum within 1e-4 of the largest entry of each, one launch of the
        route's kernel and none of the other's, two calls bit-equal."""
        torch = self.torch
        from repro_torch.kernels.ssd import ops, ref
        gen = torch.Generator(device=self.dev).manual_seed(g + t + q + n + p)
        rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                         device=self.dev)
        gh = g // heads
        c, b, x = rnd(gh, t, q, n), rnd(gh, t, q, n), rnd(g, t, q, p)
        acum = torch.cumsum(-0.2 * torch.rand((g, t, q), generator=gen,
                                              device=self.dev), dim=-1)
        dy, dst = rnd(g, t, q, p), rnd(g, t, n, p)
        args = (c, b, x, acum, dy, dst)
        route = ops.ssd_bwd_route(n, p)
        kernels = {"sm90": ops.KERNEL_BWD_SM90, "fma": ops.KERNEL_BWD}
        before = {k: v.launches for k, v in kernels.items()}
        got = ops.ssd_chunk_bwd(*args)
        launched = {k: v.launches - before[k] for k, v in kernels.items()}
        want = ref.ssd_chunk_bwd_ref(*args)
        self.sync()
        names = ("dc", "db", "dxbar", "dacum")
        errs = {k: float((a - w).abs().max()) for k, a, w in
                zip(names, got, want)}
        # the kernels' sums run in another order than the plain version's
        # f32 einsums; the sm90 route's 3xTF32 products carry ~2^-22 of
        # each operand
        tols = {k: 1e-4 * float(w.abs().max()) for k, w in zip(names, want)}
        again = ops.ssd_chunk_bwd(*args)
        deterministic = all(torch.equal(a, r) for a, r in zip(got, again))
        ok = all(errs[k] <= tols[k] for k in names) and launched == {
            r: int(r == route) for r in kernels} and deterministic
        ms = self.time_ms(lambda: ops.ssd_chunk_bwd(*args))
        plain_ms = self.time_ms(lambda: ref.ssd_chunk_bwd_ref(*args), n=10)
        # what these inputs need, on the Q(Q+1)/2 entries the mask keeps:
        # once per (batch, chunk), as C and B do not depend on the head,
        # the scores C B^T, dc = D B and D^T C with D the head sum of dS
        # (2N flops a live entry each); a head's dM = dy xbar^T and M^T dy
        # (2P each a live entry), U = B dstate and (w o xbar) dstate^T
        # (2QNP each).  The per-head form (dS B and dS^T C every head, as
        # ssd_bwd.cu runs them) beside it
        live = q * (q + 1) // 2
        per_head = g * t * (live * 4 * p + 4 * q * n * p)
        flops = gh * t * live * 6 * n + per_head
        flops_per_head_form = gh * t * live * 2 * n + per_head + \
            g * t * live * 4 * n
        # c, b, xbar, acum, dy, dstate in; dc, db, dxbar, dacum out
        nbytes = 4 * (4 * gh * t * q * n + 3 * g * t * q * p
                      + 2 * g * t * q + g * t * n * p)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_fma = flops / PEAK_FLOPS["float32"] * 1e3
        # the sm90 route's products: three TF32 passes on the tensor cores
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3 if route == "sm90" \
            else t_fma
        return self.record({
            "phase": "kernel",
            "name": "ssd_chunk_bwd_sm90" if route == "sm90"
            else "ssd_chunk_bwd", "route": route,
            "ok": ok, "shape": {"G": g, "T": t, "Q": q, "N": n, "P": p,
                                "heads_sharing_BC": heads},
            "launched": launched, "deterministic": deterministic,
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "tol": tols, "tol_rel": 1e-4, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
            "bound_fma_ms": max(t_fma, t_bytes),
            "flops": flops, "flops_per_head_form": flops_per_head_form,
            "bytes": nbytes})

    def _ssm_kernels(self) -> dict:
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.ssd import ops as ssd_ops
        return {"ssd_chunk_sm90": ssd_ops.KERNEL_SM90,
                "ssd_chunk": ssd_ops.KERNEL,
                "ssd_chunk_bwd_sm90": ssd_ops.KERNEL_BWD_SM90,
                "ssd_chunk_bwd": ssd_ops.KERNEL_BWD,
                "flash_fwd_sm90": flash_ops.FWD_SM90,
                "flash_fwd": flash_ops.KERNEL,
                "flash_bwd_delta": flash_ops.BWD_DELTA,
                "flash_bwd_dq_sm90": flash_ops.BWD_DQ_SM90,
                "flash_bwd_dkv_sm90": flash_ops.BWD_DKV_SM90,
                "flash_bwd_dq": flash_ops.BWD_DQ,
                "flash_bwd_dkv": flash_ops.BWD_DKV}

    def check_ssm_train_model(self) -> dict:
        """2-layer mamba2 and hymba (window 64, global layer 0) at full
        width through ``loss_fn`` and its gradient (the trainer's
        ``scaled_value_and_grad``, remat on every block), policy ``full``,
        on the card (kernels: the SSD chunk forward and backward, the flash
        forward and backward) and on the CPU (plain versions), same weights
        and batch: the loss and every parameter's gradient, with
        ``check_model``'s tolerances."""
        import numpy as np
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.core.mixed_precision import (Policy,
                                                      scaled_value_and_grad)
        from repro_torch.models import bridge, transformer as tf
        kernels = self._ssm_kernels()
        seq, out = 256, {}
        vg = scaled_value_and_grad(lambda m, b, cfg: tf.loss_fn(
            m, cfg, b, policy=Policy.full(), remat=CheckpointConfig()))
        for arch, extra in (("mamba2-130m", {}),
                            ("hymba-1.5b", {"window": 64,
                                            "global_layers": (0,)})):
            cfg = dataclasses.replace(configs.get_config(arch), n_layers=2,
                                      **extra)
            cpu = tf.init_params(cfg, self.args.seed, device="cpu")
            gpu = bridge.load_jax_params(cfg, bridge.export_params(cpu),
                                         device=self.dev)
            rng = np.random.default_rng(self.args.seed)
            toks = rng.integers(0, cfg.vocab, (2, seq + 1)).astype(np.int32)
            batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                     "labels": torch.from_numpy(toks[:, 1:].copy())}
            (loss_c, _), grads_c, _ = vg(cpu.requires_grad_(), batch, cfg)
            before = {k: v.launches for k, v in kernels.items()}
            (loss_g, _), grads_g, finite = vg(
                gpu.requires_grad_(),
                {k: v.to(self.dev) for k, v in batch.items()}, cfg)
            self.sync()
            launched = {k: v.launches - before[k] for k, v in kernels.items()
                        if v.launches - before[k]}
            loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
            grad_err = {n: float((grads_g[n].cpu() - g).abs().max()
                                 / max(1e-30, float(g.abs().max())))
                        for n, g in grads_c.items()}
            n_attn = cfg.n_layers if cfg.mixer != "ssm" else 0
            want = {"ssd_chunk_sm90": 2 * cfg.n_layers,
                    "ssd_chunk_bwd_sm90": cfg.n_layers}
            if n_attn:     # policy full: f32, the FMA flash kernels
                want.update(flash_fwd=2 * n_attn, flash_bwd_delta=n_attn,
                            flash_bwd_dq=n_attn, flash_bwd_dkv=n_attn)
            checks = {"loss": loss_err <= 1e-5,
                      "grads": max(grad_err.values()) <= 1e-3,
                      "grads_finite": bool(finite),
                      "launches": launched == want}
            out[arch] = {"ok": all(checks.values()), "checks": checks,
                         "loss": {"cpu": float(loss_c), "card": float(loss_g)},
                         "loss_rel_err": loss_err,
                         "grad_rel_err_max": max(grad_err.values()),
                         "worst_grad": max(grad_err, key=grad_err.get),
                         "launches": launched, "expected_launches": want}
            del cpu, gpu
        return self.record({
            "phase": "ssm_train_model",
            "ok": all(v["ok"] for v in out.values()), "seq": [2, seq],
            "policy": "full", "remat": "per block, full",
            "tol": {"loss_rel": 1e-5, "grad_rel_of_max": 1e-3},
            "models": out})

    def _saved_and_peak(self, model, cfg, batch, remat) -> dict:
        """One forward and backward of ``loss_fn`` (policy bf16): the bytes
        the forward leaves allocated for the backward, and the peak above
        what was allocated before (``base_bytes``)."""
        torch = self.torch
        from repro_torch.core.mixed_precision import get_policy
        from repro_torch.models import transformer
        params = [p for p in model.parameters() if p.requires_grad]
        gc.collect()
        torch.cuda.empty_cache()
        self.sync()
        base = torch.cuda.memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        loss, _ = transformer.loss_fn(model, cfg, batch,
                                      policy=get_policy("bf16"), remat=remat)
        self.sync()
        saved = torch.cuda.memory_allocated(self.dev) - base
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        self.sync()
        peak = torch.cuda.max_memory_allocated(self.dev) - base
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        del loss, grads
        return {"saved_after_forward_bytes": saved,
                "fwd_bwd_peak_bytes": peak,
                "fwd_bwd_peak_minus_grads_bytes": peak - grad_bytes,
                "base_bytes": base}

    def run_train_ssm(self) -> dict:
        """mamba2-130m (24 layers) and hymba-1.5b (32 layers) at full width
        and depth through ``build_train_step`` as ``launch/train.py``
        drives it, without checkpoint I/O: random f32 master weights,
        policy bf16, remat on every block, AdamW defaults, batch SSM_BATCH
        x SSM_PROMPT (the serve_ssm shape); 2 warm-up steps, 5 timed steps
        with the launch counters zeroed before and read after, one
        profiled step; then saved-after-forward bytes and the fwd+bwd peak
        under remat off and on (hymba at SSM_MEM_LAYERS layers: its
        remat-off activations at full depth are not known to fit)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.launch.train import init_state, synthetic_lm_batches
        from repro_torch.optim import adamw
        from repro_torch.train.train_step import (TrainConfig,
                                                  build_train_step,
                                                  init_loss_scale)
        kernels = self._ssm_kernels()
        tokens = SSM_BATCH * SSM_PROMPT
        runs, total = {}, {k: 0 for k in kernels}
        for arch in ("mamba2-130m", "hymba-1.5b"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
            cfg = dataclasses.replace(configs.get_config(arch),
                                      n_layers=SSM_CELL_LAYERS[arch])
            tc = TrainConfig(policy="bf16", remat=CheckpointConfig(
                enabled=True, policy="full", segment_size=1),
                opt=adamw.AdamWConfig())
            t0 = time.time()
            model, opt = init_state(cfg, self.args.seed, self.dev)
            ls = init_loss_scale(tc, self.dev)
            step = build_train_step(cfg, tc)
            data = synthetic_lm_batches(cfg, SSM_BATCH, SSM_PROMPT,
                                        seed=self.args.seed, device=self.dev)
            n_params = sum(p.numel() for p in model.parameters())
            self.sync()
            init_s = time.time() - t0
            records = []

            def one_step():
                nonlocal model, opt, ls
                _, batch = next(data)
                t = time.time()
                model, opt, ls, m = step(model, opt, ls, batch)
                vals = {k: float(v) for k, v in m.items()}   # syncs
                vals["step_s"] = time.time() - t
                records.append(vals)

            for _ in range(2):                              # warm-up
                one_step()
            for kern in kernels.values():                   # the main
                kern.launches = 0                           # path's counts
            for _ in range(5):
                one_step()
            launches = {n: k.launches for n, k in kernels.items()}
            for n in total:
                total[n] += launches[n]
            _, wall, busy_s, rows = self._profile(one_step)
            ssd_parts = dict(sorted(self.last_scopes.items()))
            steps_peak = torch.cuda.max_memory_allocated(self.dev)
            timed = records[2:7]
            step_s = statistics.median(r["step_s"] for r in timed)
            L, n = cfg.n_layers, len(timed)
            n_attn = L if cfg.mixer != "ssm" else 0
            want = {k: 0 for k in kernels}
            want.update(ssd_chunk_sm90=2 * L * n, ssd_chunk_bwd_sm90=L * n,
                        flash_fwd_sm90=2 * n_attn * n,
                        flash_bwd_delta=n_attn * n,
                        flash_bwd_dq_sm90=n_attn * n,
                        flash_bwd_dkv_sm90=n_attn * n)
            # memory: remat off against on, one forward and backward each
            del opt
            batch = next(data)[1]
            mem_layers = L if cfg.mixer == "ssm" else SSM_MEM_LAYERS
            if mem_layers < L:
                del model
                gc.collect()
                torch.cuda.empty_cache()
                cfg_m = dataclasses.replace(cfg, n_layers=mem_layers)
                model, _ = init_state(cfg_m, self.args.seed, self.dev)
            else:
                cfg_m = cfg
            memory = {name: self._saved_and_peak(
                model, cfg_m, batch, CheckpointConfig(enabled=on))
                for name, on in (("remat_off", False), ("remat_on", True))}
            del model
            checks = {
                "losses_finite": all(math.isfinite(r["loss"])
                                     for r in records),
                "grad_norms_finite": all(math.isfinite(r["grad_norm"])
                                         for r in records),
                "grads_finite": all(r["grads_finite"] for r in records),
                "launches": launches == want,
                "fits": steps_peak < 80e9,
                "remat_saves_memory": memory["remat_on"][
                    "saved_after_forward_bytes"] < memory["remat_off"][
                    "saved_after_forward_bytes"]}
            runs[arch] = {
                "ok": all(checks.values()), "checks": checks,
                "n_layers": L, "d_model": cfg.d_model, "params": n_params,
                "losses": [r["loss"] for r in records],
                "grad_norms": [r["grad_norm"] for r in records],
                "step_s": [r["step_s"] for r in records],
                "median_step_s": step_s, "tokens_per_s": tokens / step_s,
                "kernel_launches_5_steps": launches,
                "expected_launches": want,
                "max_memory_allocated_bytes": steps_peak, "init_s": init_s,
                "memory_layers": mem_layers, "memory": memory,
                "profile": {"wall_s": wall, "device_busy_s": busy_s,
                            "idle_share": 1 - busy_s / wall if wall > 0
                            else None, "ssd_op_ms": ssd_parts,
                            "top_kernels_ms": [
                                [name[:80], round(us / 1e3, 3), c]
                                for us, name, c in rows[:25]]}}
        self.train_ssm_launches = total
        return self.record({
            "phase": "train_ssm", "ok": all(v["ok"] for v in runs.values()),
            "batch": SSM_BATCH, "seq": SSM_PROMPT, "policy": "bf16",
            "remat": "per block, full", "runs": runs})

    def run_two_tier(self) -> dict:
        """The two-tier rolling cache (``transformer.init_cache_two_tier``
        / ``decode_step_two_tier``), decode-only from an empty cache, bf16:
        (a) a 2-layer hymba at full width with its window cut to
        TWO_TIER_WINDOW decodes TWO_TIER_STEPS greedy tokens, two-tier
        against the uniform cache (tokens equal, or first different at a
        near-tie, ``hold_to``; decode launches exact); (b) full-depth
        hymba at batch SSM_BATCH: both caches' bytes at s_max
        TWO_TIER_SMAX against the arithmetic, to the byte, and ms/token
        over TWO_TIER_TIMED steps from an empty cache and from position
        TWO_TIER_SMAX - TWO_TIER_TIMED - 1."""
        import numpy as np
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.mixed_precision import get_policy
        from repro_torch.kernels.kvq import ops as kvq_ops
        from repro_torch.models import transformer as tf
        pol = get_policy("bf16")
        kernels = {"flash_decode": kvq_ops.KERNEL,
                   "flash_decode_bias": kvq_ops.BIAS_KERNEL}
        modes = {"uniform": (tf.init_cache, tf.decode_step),
                 "two_tier": (tf.init_cache_two_tier,
                              tf.decode_step_two_tier)}

        # (a) greedy streams, each draw's best scores recorded
        cfg = dataclasses.replace(configs.get_config("hymba-1.5b"),
                                  n_layers=2, window=TWO_TIER_WINDOW,
                                  global_layers=(0,))
        model = tf.init_params(cfg, self.args.seed, device=self.dev,
                               dtype=pol.compute_dtype)
        first = torch.from_numpy(np.random.default_rng(self.args.seed)
                                 .integers(0, cfg.vocab, (2,))
                                 .astype(np.int32)).to(self.dev)
        streams, recs, launched = {}, {}, {}
        with torch.no_grad():
            for name, (init, step) in modes.items():
                cache = init(cfg, 2, TWO_TIER_STEPS + 1, device=self.dev)
                tok, toks, kept = first, [], []
                for k in kernels.values():
                    k.launches = 0
                for _ in range(TWO_TIER_STEPS):
                    logits, cache = step(model, cfg, cache, tok, policy=pol)
                    lg = logits[:, :cfg.vocab].float()
                    vals, ids = lg.topk(TOP_N, dim=-1)
                    kept.append((lg.amax(-1), vals, ids))
                    tok = lg.argmax(-1).to(torch.int32)
                    toks.append(tok)
                launched[name] = {n: k.launches for n, k in kernels.items()}
                toks = torch.stack(toks, 1).tolist()
                streams[name] = {r: toks[r] for r in range(2)}
                recs[name] = {}
                for i, (top, vals, ids) in enumerate(kept):
                    for r in range(2):
                        recs[name][(r, i)] = (float(top[r]),
                                              vals[r].double().tolist(),
                                              ids[r].tolist())
        counts, firsts, drift = hold_to(streams["uniform"], recs["uniform"],
                                        streams["two_tier"],
                                        recs["two_tier"])
        s = TWO_TIER_STEPS
        want = {"uniform": {"flash_decode": s, "flash_decode_bias": s},
                "two_tier": {"flash_decode": 2 * s, "flash_decode_bias": 0}}
        del model

        # (b) full depth: cache bytes and ms/token
        cfg = configs.get_config("hymba-1.5b")
        gc.collect()
        torch.cuda.empty_cache()
        model = tf.init_params(cfg, self.args.seed, device=self.dev,
                               dtype=pol.compute_dtype)
        b, smax, steps = SSM_BATCH, TWO_TIER_SMAX, TWO_TIER_TIMED
        n_g = len(cfg.global_layers)
        w = min(cfg.window, smax)
        s = cfg.ssm
        kv_row = cfg.n_kv * (cfg.head_dim + 4)     # int8 K (or V) + f32 scale
        ssm_bytes = cfg.n_layers * b * (
            (s.conv_kernel - 1) * (s.d_inner + 2 * s.d_state) * 2
            + s.heads * s.d_state * s.head_p * 4)
        arith = {"uniform": 4 + ssm_bytes + 2 * cfg.n_layers * b * smax
                 * kv_row,
                 "two_tier": 4 + ssm_bytes + 2 * b * kv_row
                 * (n_g * smax + (cfg.n_layers - n_g) * w)}
        full = {}
        tok0 = torch.zeros((b,), dtype=torch.int32, device=self.dev)
        for name, (init, step) in modes.items():
            gc.collect()
            torch.cuda.empty_cache()
            self.sync()
            before = torch.cuda.memory_allocated(self.dev)
            cache = init(cfg, b, smax, device=self.dev)
            self.sync()
            allocated = torch.cuda.memory_allocated(self.dev) - before
            nbytes = sum(t.untyped_storage().nbytes()
                         for t in cache.values())
            timing = {}
            with torch.no_grad():
                for start in (0, smax - steps - 1):
                    cache["pos"].fill_(start)
                    for k in kernels.values():
                        k.launches = 0
                    step(model, cfg, cache, tok0, policy=pol)  # warm-up
                    self.sync()
                    t0 = time.time()
                    tok = tok0
                    for _ in range(steps):
                        logits, cache = step(model, cfg, cache, tok,
                                             policy=pol)
                        tok = logits.argmax(-1).to(torch.int32)
                    self.sync()
                    timing[f"from_pos_{start}"] = {
                        "ms_per_token": (time.time() - t0) / steps * 1e3,
                        "launches": {n: k.launches
                                     for n, k in kernels.items()}}
            full[name] = {"cache_bytes": nbytes, "arithmetic_bytes":
                          arith[name], "allocated_bytes": allocated,
                          **timing}
            del cache
        n_w = cfg.n_layers - n_g
        want_full = {"uniform": {"flash_decode": n_g * (steps + 1),
                                 "flash_decode_bias": n_w * (steps + 1)},
                     "two_tier": {"flash_decode": cfg.n_layers * (steps + 1),
                                  "flash_decode_bias": 0}}
        del model
        checks = {
            "tokens_held": counts["diverged"] == 0,
            "launches_2_layer": launched == want,
            "bytes_equal_arithmetic": all(
                v["cache_bytes"] == v["arithmetic_bytes"]
                for v in full.values()),
            "launches_full": all(
                full[m][k]["launches"] == want_full[m]
                for m in full for k in full[m] if k.startswith("from_pos"))}
        return self.record({
            "phase": "two_tier", "ok": all(checks.values()),
            "checks": checks,
            "small": {"n_layers": 2, "window": TWO_TIER_WINDOW,
                      "steps": TWO_TIER_STEPS, "tokens": counts,
                      "first_differences": firsts, "top_logit_drift": drift,
                      "launches": launched, "expected_launches": want},
            "full": {"n_layers": cfg.n_layers, "batch": b, "s_max": smax,
                     "window": cfg.window,
                     "global_layers": list(cfg.global_layers),
                     "steps": steps, "runs": full,
                     "expected_launches": want_full,
                     "bytes_ratio": full["uniform"]["cache_bytes"]
                     / full["two_tier"]["cache_bytes"]}})

    # -- the MoE family and glm4-9b -----------------------------------------
    def check_moe_model(self) -> list:
        """``moe_model``: deepseek-moe-16b and granite-moe-3b-a800m at
        ``MODEL_CHECK_LAYERS`` and full width, policy full, card against
        CPU from one set of weights (see the module docstring)."""
        from repro_torch import configs
        return [self._moe_model(arch) for arch in VARIANT_TRAIN_LAYERS
                if configs.get_config(arch).moe is not None]

    def _moe_model(self, arch: str) -> dict:
        import numpy as np
        torch = self.torch
        t_phase = time.time()
        from repro_torch import configs
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.core.mixed_precision import Policy
        from repro_torch.models import bridge, moe, transformer as tf
        cfg = dataclasses.replace(configs.get_config(arch),
                                  n_layers=MODEL_CHECK_LAYERS)
        k = cfg.moe.top_k
        cpu = tf.init_params(cfg, self.args.seed, device="cpu")
        gpu = bridge.load_jax_params(cfg, bridge.export_params(cpu),
                                     device=self.dev)
        rng = np.random.default_rng(self.args.seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100))
                                  .astype(np.int32))
        labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100))
                                  .astype(np.int32))
        pol = Policy.full()
        # every routing call on each side (``side`` names the one running):
        # the top-k indices, the router's probabilities, the assignments
        # dropped under capacity
        seen = {"cpu": [], "card": []}
        side = ["cpu"]
        real_topk, real_slots = moe.router_topk, moe.dispatch_slots

        def topk_spy(x, w, kk):
            out = real_topk(x, w, kk)
            probs = torch.softmax(x.float() @ w.float(), dim=-1)
            seen[side[0]].append([out[1].cpu(), probs.detach().cpu(), None])
            return out

        def slots_spy(top_i, e, cap):
            dst, keep = real_slots(top_i, e, cap)
            seen[side[0]][-1][2] = int((~keep).sum())
            return dst, keep

        rel = lambda a, b: float(  # noqa: E731
            (a.detach().cpu() - b.detach()).abs().max()
            / max(float(b.detach().abs().max()), 1e-30))
        live = slice(0, cfg.vocab)
        moe.router_topk, moe.dispatch_slots = topk_spy, slots_spy
        try:
            with torch.no_grad():
                want, aux_c = tf.forward(cpu, cfg, {"tokens": tokens},
                                         policy=pol, build_cache=True)
                side[0] = "card"
                got, aux_g = tf.forward(gpu, cfg,
                                        {"tokens": tokens.to(self.dev)},
                                        policy=pol, build_cache=True)
                prefill_err = rel(got[..., live], want[..., live])
                off = [int((aux_g["cache"][n].cpu().int()
                            - aux_c["cache"][n].int()).abs().gt(0).sum())
                       for n in ("k", "v")]
                off_frac = sum(off) / (2 * aux_c["cache"]["k"].numel())
                cache_c = tf.grow_cache(aux_c["cache"], 1024)
                cache_g = {n: t.to(self.dev) for n, t in cache_c.items()}
                pos = torch.tensor([100, 60], dtype=torch.int32)
                cache_c["pos"], cache_g["pos"] = pos, pos.to(self.dev)
                decode_err = 0.0
                act = torch.tensor([True, True])
                for _ in range(4):
                    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2,))
                                            .astype(np.int32))
                    side[0] = "cpu"
                    lw, cache_c = tf.decode_step(cpu, cfg, cache_c, toks,
                                                 policy=pol, active=act)
                    side[0] = "card"
                    lg, cache_g = tf.decode_step(
                        gpu, cfg, cache_g, toks.to(self.dev), policy=pol,
                        kvq_splits=2, active=act.to(self.dev))
                    decode_err = max(decode_err,
                                     rel(lg[:, live], lw[:, live]))
            # training: the loss with its aux and its backward, remat on
            # every block (the recompute routes again)
            out = {}
            for name, model, dev in (("cpu", cpu, "cpu"),
                                     ("card", gpu, self.dev)):
                side[0] = name
                model.requires_grad_()
                loss, aux = tf.loss_fn(
                    model, cfg, {"tokens": tokens.to(dev),
                                 "labels": labels.to(dev)},
                    policy=pol, remat=CheckpointConfig())
                loss.backward()
                out[name] = (float(loss.detach()),
                             float(aux["moe_aux"].detach()))
        finally:
            moe.router_topk, moe.dispatch_slots = real_topk, real_slots
        self.sync()
        loss_err = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        aux_err = abs(out["card"][1] - out["cpu"][1]) / abs(out["cpu"][1])
        grads_c = dict(cpu.named_parameters())
        grad_err = max(rel(p.grad, grads_c[n].grad)
                       for n, p in gpu.named_parameters())
        # routing: the same experts token for token, the same drops call for
        # call; a differing choice must sit at a near-tie of the CPU's k-th
        # and (k+1)-th probabilities (within 2 f32 ulps of the k-th)
        calls = len(seen["cpu"])
        n_tok = n_diff = n_not_tie = 0
        drops_c, drops_g = [], []
        for (ic, pc, dc), (ig, _, dg) in zip(seen["cpu"], seen["card"]):
            drops_c.append(dc)
            drops_g.append(dg)
            differ = (ic.sort(-1).values != ig.sort(-1).values).any(-1)
            n_tok += ic.shape[0]
            n_diff += int(differ.sum())
            ranked = pc[differ].sort(-1, descending=True).values
            for row in ranked.numpy():
                ulp = np.spacing(np.float32(row[k - 1]))
                n_not_tie += int(row[k - 1] - row[k] > 2 * ulp)
        checks = {
            "prefill": prefill_err <= 1e-4, "decode": decode_err <= 1e-3,
            "int8_cache": off_frac <= 1e-3, "loss": loss_err <= 1e-5,
            "moe_aux": aux_err <= 1e-5, "grads": grad_err <= 1e-3,
            "routing_calls": calls == len(seen["card"]) == 7 * cfg.n_layers,
            "routing": n_not_tie == 0, "drops": drops_c == drops_g,
        }
        del cpu, gpu
        gc.collect()
        torch.cuda.empty_cache()
        return self.record({
            "phase": "moe_model", "arch": arch, "ok": all(checks.values()),
            "checks": checks,
            "cfg": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                    "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
                    "head_dim": cfg.head_dim, "vocab": cfg.vocab,
                    "experts": cfg.moe.num_experts, "top_k": k,
                    "d_expert": cfg.moe.d_expert,
                    "shared": cfg.moe.num_shared, "prompt": [2, 100]},
            "prefill_logits_rel_err": prefill_err, "prefill_tol": 1e-4,
            "int8_cache_off_by_one_frac": off_frac,
            "decode_logits_rel_err": decode_err, "decode_tol": 1e-3,
            "loss": dict(zip(("cpu", "card"), (out["cpu"][0],
                                               out["card"][0]))),
            "loss_rel_err": loss_err, "loss_tol": 1e-5,
            "moe_aux": dict(zip(("cpu", "card"), (out["cpu"][1],
                                                  out["card"][1]))),
            "moe_aux_rel_err": aux_err, "moe_aux_tol": 1e-5,
            "grad_rel_err_max": grad_err, "grad_tol": 1e-3,
            # prefill, 4 decode steps, the loss's forward and its
            # recompute: each layer routes once in each
            "routing_calls": calls, "tokens_routed": n_tok,
            "tokens_routed_differently": n_diff,
            "differences_not_at_a_near_tie": n_not_tie,
            "dropped_assignments": {"cpu": drops_c, "card": drops_g},
            "seconds": time.time() - t_phase})

    def run_serve_variants(self) -> list:
        """``serve_variants``: glm4-9b, deepseek-moe-16b,
        granite-moe-3b-a800m and stablelm-12b at full width and half their
        depth (``SERVE_VARIANT_LAYERS``), one at a time (see the module
        docstring); a profiled window of decode
        rounds for the two MoE archs.  minicpm3-4b, which the engine
        refuses (MLA's latent cache), serves in ``serve_mla``."""
        from repro_torch import configs
        from repro_torch.serve import supports
        return [self._serve_variant(arch) for arch in VARIANT_TRAIN_LAYERS
                if supports(configs.get_config(arch))]

    def _serve_variant(self, arch: str) -> dict:
        torch = self.torch
        from repro_torch import configs
        t_phase = time.time()
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(configs.get_config(arch),
                                  n_layers=SERVE_VARIANT_LAYERS[arch])
        model, engine, _, launches, fields = self._serve_trace(cfg)
        self.variant_launches[arch] = {"serve": launches}
        profile = None
        if cfg.moe is not None:
            # where a decode round's device time goes: the MoE FFN by its
            # profiler ranges, the decode kernel, the GEMMs (the experts'
            # among them), per round
            rounds, p_wall, p_busy, rows = self._decode_window(
                engine, cfg, MOE_PROFILE_ROUNDS)
            per = lambda ms: ms / rounds  # noqa: E731
            profile = {
                "rounds": rounds, "wall_ms_per_round": per(p_wall * 1e3),
                "device_ms_per_round": per(p_busy * 1e3),
                "idle_share": 1 - p_busy / p_wall,
                "moe_ms_per_round": {
                    n: per(v["kernels_ms"])
                    for n, v in sorted(self.last_scopes.items())},
                "decode_kernel_ms_per_round": per(sum(
                    us for us, name, _ in rows if "decode_kernel" in name)
                    / 1e3),
                "gemm_ms_per_round": per(sum(
                    us for us, name, _ in rows if GEMM_NAME.search(name))
                    / 1e3),
                "top_kernels_ms": [[name[:80], round(us / 1e3, 3), n]
                                   for us, name, n in rows[:12]]}
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
        return self.record({
            "phase": "serve_variants", **fields,
            "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
            "head_dim": cfg.head_dim, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "decode_profile": profile, "seconds": time.time() - t_phase})

    def run_train_variants(self) -> list:
        """``train_variants``: the five archs at full width, depth cut by
        VARIANT_TRAIN_LAYERS, through :meth:`_train_steps`."""
        return [self._train_variant(arch, layers)
                for arch, layers in VARIANT_TRAIN_LAYERS.items()]

    @staticmethod
    def _held_params(cfg) -> int:
        """The parameters the port's model holds: ``param_count`` and the
        padded vocab rows (once if tied), the GELU MLPs' biases and the
        patch projection, which the analytic count leaves out."""
        n = cfg.param_count() + (1 if cfg.tie_embeddings else 2) \
            * (cfg.padded_vocab - cfg.vocab) * cfg.d_model
        if cfg.mlp_kind == "gelu":
            n += (cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder
                                  else 0)) * (cfg.d_ff + cfg.d_model)
        if cfg.family == "vlm":
            n += cfg.d_model ** 2
        return n

    def _train_variant(self, arch: str, layers: int, batch: int = 1,
                       seq: int = TRAIN_SEQ, extras=None) -> dict:
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.mixed_precision import Policy
        from repro_torch.models import transformer as tf
        t_phase = time.time()
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
        # the arithmetic behind the depth: the train phase's bytes per
        # parameter (AdamW's peak over llama3-8b's 4 layers) times this
        # cut model's parameters, padded vocab included
        bpp = getattr(self, "train_bytes_per_param", None)
        if bpp is None:
            llama = dataclasses.replace(configs.get_config("llama3-8b"),
                                        n_layers=TRAIN_LAYERS)
            bpp = TRAIN_PEAK_FALLBACK / llama.param_count()
        n_params = self._held_params(cfg)
        predicted = bpp * n_params
        run = self._train_steps(cfg, batch, seq, extras)
        records, launches = run["records"], run["launches"]
        with torch.no_grad():
            _, aux = tf.forward(run["model"](), cfg, run["batch"](),
                                policy=Policy.bf16())
        moe_aux = float(aux["moe_aux"]) if cfg.moe is not None else None
        checks = self._train_checks(cfg, run)
        checks["params_as_counted"] = run["n_params"] == n_params
        if cfg.moe is not None:
            checks["moe_aux_finite"] = math.isfinite(moe_aux)
        self.variant_launches.setdefault(arch, {})["train"] = launches
        timed = records[2:7]
        step_s = statistics.median(r["step_s"] for r in timed)
        peak, init_s = run["peak"], run["init_s"]
        del run
        gc.collect()
        torch.cuda.empty_cache()
        return self.record({
            "phase": "train_variants", "arch": arch,
            "ok": all(checks.values()), "checks": checks,
            "n_layers": layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
            "head_dim": cfg.head_dim, "params": n_params,
            "policy": "bf16", "remat": "per block, full", "batch": batch,
            "seq": seq,
            "arithmetic": {"bytes_per_param": bpp,
                           "from": "train" if getattr(
                               self, "train_bytes_per_param", None)
                           else "TRAIN_PEAK_FALLBACK",
                           "predicted_peak_bytes": predicted},
            "losses": [r["loss"] for r in records],
            "grad_norms": [r["grad_norm"] for r in records],
            "moe_aux": moe_aux, "step_s": [r["step_s"] for r in records],
            "median_step_s": step_s, "tokens_per_s": batch * seq / step_s,
            "kernel_launches_5_steps": launches,
            "max_memory_allocated_bytes": peak, "init_s": init_s,
            "seconds": time.time() - t_phase})


    # -- head_dim 160 and MLA ----------------------------------------------
    @staticmethod
    def _launch_counters() -> dict:
        """Every attention kernel's launch counter, by name."""
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.kvq import ops as kvq_ops
        return {"flash_fwd": flash_ops.KERNEL,
                "flash_fwd_sm90": flash_ops.FWD_SM90,
                "flash_bwd_delta": flash_ops.BWD_DELTA,
                "flash_bwd_dq": flash_ops.BWD_DQ,
                "flash_bwd_dkv": flash_ops.BWD_DKV,
                "flash_bwd_dq_sm90": flash_ops.BWD_DQ_SM90,
                "flash_bwd_dkv_sm90": flash_ops.BWD_DKV_SM90,
                "flash_decode": kvq_ops.KERNEL,
                "flash_decode_bias": kvq_ops.BIAS_KERNEL}

    @staticmethod
    def _all_counters() -> dict:
        """The attention kernels' launch counters and the SSD chunk's,
        forward and backward, each design apart."""
        from repro_torch.kernels.ssd import ops as ssd_ops
        return {**Smoke._launch_counters(),
                "ssd_chunk_sm90": ssd_ops.KERNEL_SM90,
                "ssd_chunk": ssd_ops.KERNEL,
                "ssd_chunk_bwd_sm90": ssd_ops.KERNEL_BWD_SM90,
                "ssd_chunk_bwd": ssd_ops.KERNEL_BWD}

    def check_model_vs_cpu(self, arch: str) -> dict:
        """``head160_model`` (stablelm-12b) / ``mla_model`` (minicpm3-4b) /
        ``whisper_model`` / ``qwen2vl_model``: ``arch`` cut to
        ``MODEL_CHECK_LAYERS`` (whisper's encoder too) at full width, policy full, card
        against CPU from one set of weights (``bridge``): prefill logits
        and caches (int8 K/V, or MLA's bf16 latents), 4 lockstep decode
        steps (whisper's over the prefill's ``enc_out``), the loss and
        every gradient (remat on every block; the encoder's and
        ``patch_proj``'s leaves included), at the ``model`` line's
        tolerances.  Whisper's batch carries 1500 frames of seeded normal
        values a row, qwen2-vl's a 16-patch prefix (a 4 x 4 grid) and
        3-stream positions (:func:`grid_positions`).  Every kernel's
        launches are counted in each of the three parts against what the
        path must run: the flash forward (FMA: policy full) a layer in the
        prefill, the decode kernel a layer a step, the forward twice a
        layer (remat) and delta / dQ / dKV (FMA) once a layer in the
        training step; none for the encoder and the cross-attention; for
        MLA and qwen2-vl's M-RoPE no flash kernel at all, as none lies on
        the reference's path there (qwen2-vl still decodes through the
        decode kernel)."""
        import numpy as np
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.checkpoint import CheckpointConfig
        from repro_torch.core.mixed_precision import Policy
        from repro_torch.models import bridge, transformer as tf
        t_phase = time.time()
        cfg = dataclasses.replace(configs.get_config(arch),
                                  n_layers=MODEL_CHECK_LAYERS)
        if cfg.encoder is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, n_layers=MODEL_CHECK_LAYERS))
        L, mla = cfg.n_layers, cfg.mla is not None
        no_flash = mla or cfg.mrope_sections is not None
        cpu = tf.init_params(cfg, self.args.seed, device="cpu")
        gpu = bridge.load_jax_params(cfg, bridge.export_params(cpu),
                                     device=self.dev)
        rng = np.random.default_rng(self.args.seed)
        tokens, labels = (torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 100)).astype(np.int32)) for _ in range(2))
        extra = {}
        if cfg.encoder is not None:
            extra["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
        if cfg.family == "vlm":
            extra["patches"] = torch.from_numpy(rng.standard_normal(
                (2, 16, cfg.d_model)).astype(np.float32))
            extra["positions"] = grid_positions(2, 100, 4, 4)

        def on(dev):
            return {n: t.to(dev) for n, t in extra.items()}
        pol = Policy.full()
        kernels = self._launch_counters()
        launches = {}

        def zero():
            for k in kernels.values():
                k.launches = 0

        def read(part):
            launches[part] = {n: k.launches for n, k in kernels.items()}

        rel = lambda a, b: float(  # noqa: E731
            (a.detach().float().cpu() - b.detach().float()).abs().max()
            / max(float(b.detach().float().abs().max()), 1e-30))
        live = slice(0, cfg.vocab)
        with torch.no_grad():
            want, aux_c = tf.forward(cpu, cfg, {"tokens": tokens, **extra},
                                     policy=pol, build_cache=True)
            zero()
            got, aux_g = tf.forward(gpu, cfg, {"tokens": tokens.to(self.dev),
                                               **on(self.dev)},
                                    policy=pol, build_cache=True)
            self.sync()
            read("prefill")
            prefill_err = rel(got[..., live], want[..., live])
            cc, cg = aux_c["cache"], aux_g["cache"]
            if mla:
                # bf16 latents rounded from f32 values that differ in the
                # summation order: equal but at a rounding tie
                cache_err = max(rel(cg[n], cc[n])
                                for n in ("mla_lat", "mla_rope"))
                cache_ok = cache_err <= 1e-2 and all(
                    cg[n].dtype == torch.bfloat16
                    for n in ("mla_lat", "mla_rope"))
            else:
                cache_err = sum(int((cg[n].cpu().int() - cc[n].int()).abs()
                                    .gt(0).sum()) for n in ("k", "v")) \
                    / (2 * cc["k"].numel())
                cache_ok = cache_err <= 1e-3
            cache_c = tf.grow_cache(cc, 1024)
            cache_g = {n: t.to(self.dev) for n, t in cache_c.items()}
            decode_err = 0.0
            zero()
            for _ in range(4):          # lockstep: one 0-d position
                toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2,))
                                        .astype(np.int32))
                lw, cache_c = tf.decode_step(cpu, cfg, cache_c, toks,
                                             policy=pol,
                                             enc_out=aux_c.get("enc_out"))
                lg, cache_g = tf.decode_step(gpu, cfg, cache_g,
                                             toks.to(self.dev), policy=pol,
                                             kvq_splits=2,
                                             enc_out=aux_g.get("enc_out"))
                decode_err = max(decode_err, rel(lg[:, live], lw[:, live]))
            self.sync()
            read("decode")
        losses = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, self.dev)):
            model.requires_grad_()
            zero()
            loss, _ = tf.loss_fn(model, cfg, {"tokens": tokens.to(dev),
                                              "labels": labels.to(dev),
                                              **on(dev)},
                                 policy=pol, remat=CheckpointConfig())
            loss.backward()
            losses[name] = float(loss.detach())
        self.sync()
        read("train")
        loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        grads_c = dict(cpu.named_parameters())
        grad_errs = {n: rel(p.grad, grads_c[n].grad)
                     for n, p in gpu.named_parameters()}
        grad_err = max(grad_errs.values())
        # the largest error among the leaves each new part holds
        part_errs = {part: max(e for n, e in grad_errs.items()
                               if n.startswith(part))
                     for part in ("enc_blocks", "enc_norm", "patch_proj",
                                  "embed")
                     if any(n.startswith(part) for n in grad_errs)}
        zeros = {n: 0 for n in kernels}
        want_launches = {
            "prefill": {**zeros, "flash_fwd": 0 if no_flash else L},
            "decode": {**zeros, "flash_decode": 0 if mla else 4 * L},
            "train": zeros if no_flash else {
                **zeros, "flash_fwd": 2 * L, "flash_bwd_delta": L,
                "flash_bwd_dq": L, "flash_bwd_dkv": L}}
        checks = {"prefill": prefill_err <= 1e-4, "cache": cache_ok,
                  "decode": decode_err <= 1e-3, "loss": loss_err <= 1e-5,
                  "grads": grad_err <= 1e-3,
                  "every_leaf_has_a_gradient": all(
                      p.grad is not None for p in gpu.parameters()),
                  "launches": launches == want_launches}
        if arch == HEAD160:         # the FMA routes' main path at D = 160
            self.head160_model_launches = {
                n: sum(part[n] for part in launches.values())
                for n in kernels}
        del cpu, gpu
        gc.collect()
        torch.cuda.empty_cache()
        return self.record({
            "phase": MODEL_PHASE[arch], "arch": arch,
            "ok": all(checks.values()), "checks": checks,
            "cfg": {"n_layers": L, "d_model": cfg.d_model,
                    "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
                    "head_dim": cfg.head_dim, "vocab": cfg.vocab,
                    "mla": dataclasses.asdict(cfg.mla) if mla else None,
                    "encoder": dataclasses.asdict(cfg.encoder)
                    if cfg.encoder is not None else None,
                    "mrope_sections": cfg.mrope_sections,
                    "tied": cfg.tie_embeddings,
                    "inputs": sorted(["tokens", "labels", *extra]),
                    "prompt": [2, 100]},
            "prefill_logits_rel_err": prefill_err, "prefill_tol": 1e-4,
            ("latent_cache_rel_err" if mla
             else "int8_cache_off_by_one_frac"): cache_err,
            "cache_tol": 1e-2 if mla else 1e-3,
            "decode_logits_rel_err": decode_err, "decode_tol": 1e-3,
            "loss": losses, "loss_rel_err": loss_err, "loss_tol": 1e-5,
            "grad_rel_err_max": grad_err, "grad_tol": 1e-3,
            "grad_rel_err_by_part": part_errs,
            "kernel_launches": launches, "expected_launches": want_launches,
            "seconds": time.time() - t_phase})

    def run_serve_mla(self) -> dict:
        """``serve_mla``: ``launch/serve.py``'s lockstep for minicpm3-4b at
        full width and ``MLA_SERVE_LAYERS`` layers, as ``python -m
        repro_torch.launch.serve --arch minicpm3-4b --batch 8
        --prompt-len 1024 --gen 16`` runs it
        (random bf16 weights from ``--seed``, bf16 latent cache): a one-step
        warm-up run, then the measured run with every kernel counter zeroed
        just before it and read just after (all 0: MLA runs the plain
        attention, as the reference does), then a profile of its prefill
        and first 4 decode steps.  The prefill's one-shot attention holds
        f32 scores of B x H x S^2 (1.3 GB at 8 x 40 x 1024^2) a layer while
        it runs, as the reference's does: the peak says so."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.launch import serve
        gc.collect()
        torch.cuda.empty_cache()
        t_phase = time.time()
        argv = ["--arch", MLA_ARCH, "--batch", str(MLA_BATCH),
                "--prompt-len", str(MLA_PROMPT), "--gen", str(MLA_GEN),
                "--policy", "bf16", "--seed", str(self.args.seed)]
        args = serve.build_parser().parse_args(argv)
        cfg = dataclasses.replace(configs.get_config(MLA_ARCH),
                                  n_layers=MLA_SERVE_LAYERS)
        t0 = time.time()
        model = serve.build_model(args, cfg, self.dev)
        self.sync()
        init_s = time.time() - t0
        t0 = time.time()
        serve.lockstep(argparse.Namespace(**{**vars(args), "gen": 2}), cfg,
                       model, self.dev)
        warmup_s = time.time() - t0
        kernels = self._launch_counters()
        torch.cuda.reset_peak_memory_stats(self.dev)
        for k in kernels.values():
            k.launches = 0
        r = serve.lockstep(args, cfg, model, self.dev)
        launches = {n: k.launches for n, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated(self.dev)
        steps, toks = MLA_GEN - 1, r["tokens"]
        checks = {"no_launches": not any(launches.values()),
                  "tokens_shape": toks.shape == (MLA_BATCH, MLA_GEN),
                  "tokens_in_vocab": bool(((toks >= 0)
                                           & (toks < cfg.vocab)).all()),
                  "fits": peak < 80e9}
        prof = self._profile_lockstep(args, cfg, model, steps=4)
        busy = prof["prefill"]["device_busy_s"] + prof["decode"][
            "device_busy_s"] / prof["decode"]["steps"] * steps
        wall = r["prefill_s"] + r["decode_s"]
        n_params = sum(p.numel() for p in model.parameters())
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return self.record({
            "phase": "serve_mla", "arch": MLA_ARCH,
            "ok": all(checks.values()), "checks": checks,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "params": n_params,
            "mla": dataclasses.asdict(cfg.mla),
            "batch": MLA_BATCH, "prompt": MLA_PROMPT, "gen": MLA_GEN,
            "policy": "bf16", "cache": "bf16 latents",
            "prefill_ms": r["prefill_s"] * 1e3,
            "decode_ms_per_token": r["decode_s"] / steps * 1e3,
            "decode_tokens_per_s": MLA_BATCH * steps / r["decode_s"],
            "max_memory_allocated_bytes": peak,
            "one_shot_f32_scores_bytes_per_layer":
                MLA_BATCH * cfg.n_heads * MLA_PROMPT ** 2 * 4,
            "init_s": init_s, "warmup_s": warmup_s,
            "kernel_launches": launches, "sample": toks[0][:8].tolist(),
            "idle_share_run": 1 - busy / wall, "profile": prof,
            "seconds": time.time() - t_phase})

    # -- whisper-base and qwen2-vl-2b ----------------------------------------
    def _train_extras(self, cfg, batch: int, seq: int):
        """What a train batch of ``cfg`` carries beside its tokens: an
        encoder's frames (seeded normal, anew each batch), a VLM's patch
        prefix (a QWEN_GRID x QWEN_GRID grid of seeded normal embeddings)
        and its 3-stream positions; None for a text-only arch."""
        gen = self.torch.Generator(device=self.dev).manual_seed(
            self.args.seed + 1)
        if cfg.encoder is not None:
            shape = (batch, cfg.encoder.n_frames, cfg.d_model)
            return lambda _: {"frames": self.torch.randn(
                shape, generator=gen, device=self.dev)}
        if cfg.family == "vlm":
            assert QWEN_GRID ** 2 == min(1024, seq // 4)
            pos = grid_positions(batch, seq, QWEN_GRID, QWEN_GRID).to(
                self.dev)
            shape = (batch, QWEN_GRID ** 2, cfg.d_model)
            return lambda _: {"patches": self.torch.randn(
                shape, generator=gen, device=self.dev), "positions": pos}
        return None

    def run_serve_encdec(self) -> dict:
        """``serve_encdec``: ``launch/serve.py``'s lockstep for whisper-base
        at full width and depth, as ``python -m repro_torch.launch.serve
        --arch whisper-base --batch 16 --prompt-len 64 --gen 192`` runs it
        but on 1500 frames a row of seeded normal values (``lockstep``'s
        ``frames``; the CLI feeds zeros, as the reference's): random bf16
        weights from ``--seed``, int8 cache.  A one-step warm-up run, then
        the measured run with every kernel counter zeroed just before it
        and read just after: the flash forward once a decoder layer (the
        tensor-core design at G = 1, D = 64), the decode kernel once a
        layer a step, nothing for the encoder or the cross-attention.
        Then a profile of the prefill and the first 4 decode steps: device
        ms of the encoder and the cross-attention (their ``encdec.*``
        ranges), the decode kernel and the GEMMs, and the idle share."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.launch import serve
        gc.collect()
        torch.cuda.empty_cache()
        t_phase = time.time()
        argv = ["--arch", WHISPER, "--batch", str(WHISPER_BATCH),
                "--prompt-len", str(WHISPER_PROMPT), "--gen",
                str(WHISPER_GEN), "--policy", "bf16", "--seed",
                str(self.args.seed)]
        args = serve.build_parser().parse_args(argv)
        cfg = configs.get_config(WHISPER)
        L = cfg.n_layers
        t0 = time.time()
        model = serve.build_model(args, cfg, self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(self.args.seed)
        frames = torch.randn((WHISPER_BATCH, cfg.encoder.n_frames,
                              cfg.d_model), generator=gen, device=self.dev)
        self.sync()
        init_s = time.time() - t0
        t0 = time.time()
        serve.lockstep(argparse.Namespace(**{**vars(args), "gen": 2}), cfg,
                       model, self.dev, frames=frames)
        warmup_s = time.time() - t0
        kernels = self._launch_counters()
        torch.cuda.reset_peak_memory_stats(self.dev)
        for k in kernels.values():
            k.launches = 0
        r = serve.lockstep(args, cfg, model, self.dev, frames=frames)
        launches = {n: k.launches for n, k in kernels.items()}
        self.encdec_launches = launches
        peak = torch.cuda.max_memory_allocated(self.dev)
        steps, toks = WHISPER_GEN - 1, r["tokens"]
        want = {n: 0 for n in kernels}
        want.update(flash_fwd_sm90=L, flash_decode=L * steps)
        checks = {"launches": launches == want,
                  "tokens_shape": toks.shape == (WHISPER_BATCH, WHISPER_GEN),
                  "tokens_in_vocab": bool(((toks >= 0)
                                           & (toks < cfg.vocab)).all()),
                  "fits": peak < 80e9}
        prof = self._profile_lockstep(args, cfg, model, steps=4,
                                      frames=frames)
        pre, dec = prof["prefill"], prof["decode"]
        busy = pre["device_busy_s"] + dec["device_busy_s"] / dec["steps"] \
            * steps
        wall = r["prefill_s"] + r["decode_s"]
        n_params = sum(p.numel() for p in model.parameters())
        checks["params_as_counted"] = n_params == self._held_params(cfg)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return self.record({
            "phase": "serve_encdec", "arch": WHISPER,
            "ok": all(checks.values()), "checks": checks,
            "n_layers": L, "encoder_layers": cfg.encoder.n_layers,
            "frames": cfg.encoder.n_frames, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "params": n_params,
            "batch": WHISPER_BATCH, "prompt": WHISPER_PROMPT,
            "gen": WHISPER_GEN, "policy": "bf16", "cache": "int8",
            "prefill_ms_with_encoder": r["prefill_s"] * 1e3,
            "decode_ms_per_token": r["decode_s"] / steps * 1e3,
            "decode_tokens_per_s": WHISPER_BATCH * steps / r["decode_s"],
            "max_memory_allocated_bytes": peak,
            "encoder_f32_scores_bytes_per_layer":
                WHISPER_BATCH * cfg.n_heads * cfg.encoder.n_frames ** 2 * 4,
            "init_s": init_s, "warmup_s": warmup_s,
            "kernel_launches": launches, "expected_launches": want,
            "sample": toks[0][:8].tolist(),
            "device_ms": {
                "prefill_encoder": pre["encdec_ms"].get(
                    "encdec.encoder", {}).get("kernels_ms"),
                "prefill_cross_attn": pre["encdec_ms"].get(
                    "encdec.cross_attn", {}).get("kernels_ms"),
                "prefill_gemm": pre["gemm_ms"],
                "prefill_busy": pre["device_busy_s"] * 1e3,
                "decode_step_cross_attn": dec["encdec_ms"].get(
                    "encdec.cross_attn", {}).get("kernels_ms", 0)
                / dec["steps"],
                "decode_step_decode_kernel": dec["decode_kernel_ms"]
                / dec["steps"],
                "decode_step_gemm": dec["gemm_ms"] / dec["steps"],
                "decode_step_busy": dec["device_busy_s"] * 1e3
                / dec["steps"]},
            "idle_share_prefill": pre["idle_share"],
            "idle_share_decode": dec["idle_share"],
            "idle_share_run": 1 - busy / wall, "profile": prof,
            "seconds": time.time() - t_phase})


def dp_child(spec: str, seed: int) -> int:
    """One rank of ``train_dp`` (b), run as ``chip_smoke.py --dp-child
    rank,world,rendezvous,out,device``: gloo over the parent's card, the
    kernels loaded
    from the libraries the parent built (never built here: two ranks
    building at once would race on ``build/kernels/``), DP_STEPS steps
    of smoke-width llama3-8b at the global batch DP_BATCH x DP_SEQ
    through ``make_train_step(mesh=Mesh(data=world, model=1))`` with the
    launch counters zeroed before and read after, then
    ``compressed_psum_grads`` on this rank's CUDA gradients."""
    rank, world, rdv, out, device = spec.split(",")
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.checkpoint import CheckpointConfig
    from repro_torch.core.mixed_precision import scaled_value_and_grad
    from repro_torch.distributed import collectives
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import init_state, synthetic_lm_batches
    from repro_torch.models import transformer
    from repro_torch.optim import compression
    from repro_torch.train.train_step import (TrainConfig, init_loss_scale,
                                              local_batch, make_train_step)
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        for lib in ("flash_fwd", "flash_fwd_sm90", "flash_bwd",
                    "flash_bwd_sm90"):
            if not build.library_path(lib).exists():
                raise RuntimeError(f"dp_child: {lib}.cu is not built")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        cfg = configs.smoke_config("llama3-8b")
        mesh = Mesh(data=world, model=1)
        tc = TrainConfig(policy="bf16", remat=CheckpointConfig(
            enabled=True, policy="full", segment_size=1))
        model, opt = init_state(cfg, seed, dev)
        step, tc = make_train_step(cfg, tc, {"tokens": torch.empty(
            (DP_BATCH, DP_SEQ), dtype=torch.int32, device="meta")}, mesh=mesh)
        ls = init_loss_scale(tc, dev)
        data = synthetic_lm_batches(cfg, DP_BATCH, DP_SEQ, seed=seed,
                                    device=dev)
        kernels = Smoke._launch_counters()
        for k in kernels.values():
            k.launches = 0
        losses, norms, times = [], [], []
        for _ in range(DP_STEPS):
            t = time.time()
            model, opt, ls, m = step(model, opt, ls, next(data)[1])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.time() - t)
        launches = {n: k.launches for n, k in kernels.items()}
        # compressed_psum_grads on this rank's gradients of its own rows
        batch = local_batch(cfg, next(data)[1], mesh, rank)
        _, grads, _ = scaled_value_and_grad(
            lambda mdl, b: transformer.loss_fn(mdl, cfg, b))(model, batch)
        mean = collectives.compressed_psum_grads(grads, seed=seed)
        plain = {k: g.clone() for k, g in grads.items()}
        for g in plain.values():
            dist.all_reduce(g)
            g /= world
        payload = collectives.rank_payload(grads, seed, rank)
        scales = torch.zeros(world, len(grads), device=dev)
        scales[rank] = torch.stack([payload[k][1] for k in sorted(grads)])
        dist.all_reduce(scales)
        step_ = dict(zip(sorted(grads), scales.mean(0).tolist()))
        within = all(float((mean[k] - plain[k]).abs().max()) < step_[k]
                     for k in grads)
        digest = float(sum(mean[k].double().sum() for k in sorted(mean)))
        pathlib.Path(out).write_text(json.dumps({
            "rank": rank, "losses": losses, "grad_norms": norms,
            "step_s": times, "launches": launches,
            "psum": {"within_step": within, "mean_digest": digest,
                     "payload_bytes": compression.payload_bytes(payload),
                     "f32_bytes": sum(g.numel() * 4 for g in grads.values()),
                     "leaves": len(grads),
                     "max_err_over_step": max(
                         float((mean[k] - plain[k]).abs().max()) / step_[k]
                         for k in grads)}}))
    finally:
        dist.destroy_process_group()
    return 0


def tp_forced(model, cfg, policy: str, prompts, mesh=None, forced=None,
              cache=None, frames=None):
    """Teacher-forced serve steps (``train/serve_step.py``: the builders
    without ``mesh``, ``make_serve_steps`` with it): the prefill of
    ``prompts`` (B, P) (an encoder arch's with its ``frames``, the
    encoder's output then handed to every decode step) grown to P +
    TP_STEPS slots, then TP_STEPS decode steps (``TP_SPLITS`` splits),
    each fed ``forced[:, t]`` or, without it, the greedy token of the step
    before.  ``cache`` (this rank's layout) replaces the prefill's own
    cache before the decode steps.  Under policy ``full`` MLA's latents
    (bf16 in the prefill's cache, the reference's) go to f32 before the
    decode steps, which then write f32 latents, so an f32 reading of the
    decode path is not hidden by their rounding (from the unsharded
    run's cache no run's rounding differs).  -> (logits (TP_STEPS + 1,
    B, V) f32 on the host, V the live vocab (the padded tail's -1e30 cut
    off), the fed tokens (B, TP_STEPS), the prefill's cache on the
    host)."""
    import torch
    from repro_torch.core.mixed_precision import get_policy
    from repro_torch.models import transformer
    from repro_torch.train import serve_step
    p = prompts.shape[1]
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    f32_latents = policy == "full" and cfg.mla is not None
    if mesh is None:
        prefill = serve_step.build_prefill_step(
            cfg, policy_name=policy, s_max=p + TP_STEPS)
        decode = serve_step.build_decode_step(
            cfg, policy_name=policy, kvq_splits=TP_SPLITS)
    else:
        prefill, _ = serve_step.make_serve_steps(
            cfg, mesh, batch, kind="prefill", policy_name=policy,
            s_max=p + TP_STEPS)
        decode, _ = serve_step.make_serve_steps(
            cfg, mesh, {"tokens_t": prompts[:, 0]}, kind="decode",
            policy_name=policy, kvq_splits=TP_SPLITS)
    with torch.no_grad():
        enc = None if frames is None else transformer.run_encoder(
            model, cfg, frames, get_policy(policy), mesh)
        logits, own = prefill(model, batch)
        kept = {k: v.to("cpu", copy=True) for k, v in own.items()}
        if cache is not None:
            own = {k: v.to(prompts.device) for k, v in cache.items()}
        if f32_latents:
            own = {k: v.float() if k in ("mla_lat", "mla_rope") else v
                   for k, v in own.items()}
        out, fed = [logits[:, :cfg.vocab].float().cpu()], []
        for t in range(TP_STEPS):
            tok = (logits.argmax(-1) if forced is None
                   else forced[:, t].to(prompts.device)).to(torch.int32)
            fed.append(tok.cpu())
            logits, own = decode(model, own, tok, enc)
            out.append(logits[:, :cfg.vocab].float().cpu())
    return torch.stack(out), torch.stack(fed, 1), kept


def _serve_want(cfg, policy: str, counters) -> dict:
    """The launches of one teacher-forced run (:func:`tp_forced`): its
    prefill's flash forward (the route's design) a causal attention layer
    and SSD chunk an SSM layer, and each decode step's decode kernel an
    attention layer (the dense-bias entry for a windowed one); 0 for
    every other counter in ``counters``."""
    import torch
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import transformer
    want = {k: 0 for k in counters}
    dt = torch.bfloat16 if policy == "bf16" else torch.float32
    if cfg.mixer in ("attn", "hybrid") and cfg.mla is None:
        fwd = "flash_fwd_sm90" if flash_ops.fwd_route(dt, cfg.head_dim) \
            == "sm90" else "flash_fwd"
        want[fwd] = cfg.n_layers
        for w in transformer.layer_windows(cfg):
            want["flash_decode_bias" if w > 0 else "flash_decode"] += \
                TP_STEPS
    if cfg.mixer in ("ssm", "hybrid"):
        route = ssd_ops.ssd_route(cfg.ssm.d_state, cfg.ssm.head_p)
        want["ssd_chunk_sm90" if route == "sm90" else "ssd_chunk"] = \
            cfg.n_layers
    return want


def _seed_biases(model, cfg, seed: int, mesh=None) -> None:
    """In place: every GELU MLP's ``b1`` / ``b2`` (which start at zero,
    as the reference's) drawn 0.1 x normal from ``seed``, whole and in
    the meshless order, then cut to this rank's block on ``mesh`` -- so a
    bias added per rank, or not at all, shows in the loss and logits.  A
    model with no GELU MLP is left as it is."""
    import torch
    from repro_torch.models import transformer
    if cfg.mlp_kind != "gelu":
        return
    cut = transformer.shard_fn(cfg, mesh)
    dev = model.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    with torch.no_grad():
        for pre, blocks in (("blocks", model.blocks),
                            ("enc_blocks", model.enc_blocks or [])):
            for i, blk in enumerate(blocks):
                for name, n in (("b1", cfg.d_ff), ("b2", cfg.d_model)):
                    whole = 0.1 * torch.randn(n, generator=gen, device=dev)
                    getattr(blk.ffn, name).copy_(
                        cut(f"{pre}.{i}.ffn.{name}", whole))


def _tpt_batches(cfg, batch: int, seq: int, seed: int, device, n: int):
    """``n`` batches of the trainer's synthetic stream (``batch`` x
    ``seq``), an encoder arch's with seeded normal frames (anew each
    batch, from a generator on ``device``): the same on the parent and on
    every rank."""
    import torch
    from repro_torch.launch.train import synthetic_lm_batches
    stream = synthetic_lm_batches(cfg, batch, seq, seed=seed, device=device)
    out = [next(stream)[1] for _ in range(n)]
    if cfg.encoder is not None:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        for b in out:
            b["frames"] = torch.randn(
                (batch, cfg.encoder.n_frames, cfg.d_model), generator=gen,
                device=device)
    return out


def _tf_compare(got, ref) -> dict:
    """A rank's teacher-forced logits against the unsharded run's: the
    largest difference over the largest |logit|, all steps, the
    prefill's (step 0) and the decode steps' apart; the steps whose
    greedy tokens all agree, and the unsharded top-2 gap at the first
    that does not."""
    diff = (got - ref).abs().amax(dim=(1, 2))
    top = float(ref.abs().max())
    g, r = got.argmax(-1), ref.argmax(-1)
    gap = None
    bad = (g != r).nonzero()
    if len(bad):
        step, row = (int(x) for x in bad[0])
        two = ref[step, row].topk(2).values
        gap = {"step": step, "row": row, "gap": float(two[0] - two[1]),
               "gap_bf16_ulps": float(two[0] - two[1])
               / bf16_ulp(float(two[0]))}
    return {"max_abs": float(diff.max()), "max_rel": float(diff.max()) / top,
            "prefill_rel": float(diff[0]) / top,
            "decode_rel": float(diff[1:].max()) / top,
            "greedy_equal": int((g == r).all(-1).sum()),
            "first_diff_gap": gap, "digest": float(got.double().sum())}


def _cache_diff(own: dict, ref: dict) -> dict:
    """This rank's prefill cache against its block of the unsharded
    run's: int8 entries that differ (and by how many steps), and the
    largest relative difference of the f32 scales; MLA's bf16 latents:
    the largest difference beyond one bf16 rounding step of the larger
    of the two values (the step an f32 reorder at a rounding boundary
    moves a latent), over the block's largest |value|, the latents that
    differ, and the bytes of both."""
    if "mla_lat" in own:
        import torch
        names = ("mla_lat", "mla_rope")
        out = {}
        for n in names:
            a, b = own[n].float(), ref[n].float()
            # |x| = m 2^e, m in [0.5, 1): bf16's 8 significant bits step
            # by 2^(e - 8)
            e = torch.frexp(torch.maximum(a.abs(), b.abs())).exponent
            step = torch.ldexp(torch.ones_like(a), e - 8)
            out[f"{n}_excess_rel"] = float(
                ((a - b).abs() - step).clamp(min=0).max()
                / b.abs().max())
            out[f"{n}_differ"] = int((a != b).sum())
        out["latent_bytes"] = sum(own[n].numel() * own[n].element_size()
                                  for n in names)
        return out
    out = {}
    for name in ("k", "v"):
        d = (own[name].int() - ref[name].int()).abs()
        out[f"{name}_int8_differ"] = int((d > 0).sum())
        out[f"{name}_int8_max_steps"] = int(d.max())
    for name in ("k_scale", "v_scale"):
        filled = ref[name] > 0                 # the prompt's slots
        out[f"{name}_max_rel"] = float(
            ((own[name] - ref[name]).abs()[filled]
             / ref[name][filled]).max())
    return out


@contextlib.contextmanager
def _planted(fault: str, model, mesh, rank: int):
    """A fault planted in one rank's sharded run, undone after:
    ``w_down_mid`` / ``w_down_all``, the last rank of the model axis
    drops its ``w_down`` partial (its block zeroed) in the middle layer /
    in every layer; ``merge_drop0``, every rank merges the sequence
    partials as if shard 0 had no live position (a merge that is wrong
    the same way on every rank); the MoE's (``moe_tp``) as
    ``_moe_fault``."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.kernels import tiling
    from repro_torch.launch.mesh import coords
    r, n = coords(mesh, rank)["model"], mesh.shape["model"]
    saved, merge = [], collectives._group_merge
    if fault in MOE_TP_FAULTS["c"] + MOE_TP_FAULTS["d"]:
        with _moe_fault(fault, model, mesh):
            yield
        return
    if fault in MIXER_FAULTS:
        with _mixer_fault(fault, model, mesh):
            yield
        return
    if fault.startswith("w_down") and r == n - 1:
        blocks = model.blocks if fault == "w_down_all" \
            else [model.blocks[len(model.blocks) // 2]]
        for blk in blocks:
            w = blk.ffn.w_down
            saved.append((w, w.detach().clone()))
            w.data.zero_()
    elif fault == "merge_drop0":
        def dropped(o, m, l, group):
            if r == 0:
                o, l = torch.zeros_like(o), torch.zeros_like(l)
                m = torch.full_like(m, tiling.NEG_INF)
            return merge(o, m, l, group)
        collectives._group_merge = dropped
    elif not fault.startswith("w_down"):
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        collectives._group_merge = merge
        for w, v in saved:
            w.data.copy_(v)


def _cache_block(cache: dict, cfg, mesh, rank: int) -> dict:
    """This rank's block of an unsharded decode cache (uniform, MLA's or
    two-tier), as ``transformer.cache_specs`` places it."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import coords
    from repro_torch.models import transformer
    where = coords(mesh, rank)
    specs = transformer.cache_specs(cfg, cache, mesh)
    return {k: v if k == "pos" else shd.shard_leaf(v, specs[k], mesh, where)
            for k, v in cache.items()}


def two_tier_forced(model, cfg, cache, tokens, mesh=None):
    """``ssm_tp`` (h): TP_STEPS decode steps of ``decode_step_two_tier``
    (policy full, ``TP_SPLITS`` splits) from ``cache`` (moved to the
    model's device), each fed ``tokens[:, t]`` or, with ``tokens`` None,
    the greedy token of the step before (the first fed the cache's
    ``first``).  -> (logits (TP_STEPS, B, V) f32 on the host, the live
    vocab; the fed tokens (B, TP_STEPS))."""
    import torch
    from repro_torch.core.mixed_precision import Policy
    from repro_torch.models import transformer
    dev = model.embed.device
    cache = {k: v.to(dev, copy=True) for k, v in cache.items()}
    tok = cache.pop("first")
    out, fed = [], []
    with torch.no_grad():
        for t in range(TP_STEPS):
            if tokens is not None:
                tok = tokens[:, t].to(dev)
            tok = tok.to(torch.int32)
            fed.append(tok.cpu())
            logits, cache = transformer.decode_step_two_tier(
                model, cfg, cache, tok, policy=Policy.full(),
                kvq_splits=TP_SPLITS, mesh=mesh)
            out.append(logits[:, :cfg.vocab].float().cpu())
            tok = logits.argmax(-1)
    return torch.stack(out), torch.stack(fed, 1)


def _two_tier_rank(spec, model, cfg, mesh, dev, zero, read) -> dict:
    """``ssm_tp`` (h) on one rank: this rank's block of the parent's
    two-tier cache, the decode steps fed the parent's tokens against its
    logits, then again under each planted fault."""
    import torch
    from repro_torch.launch.mesh import coords
    ref = torch.load(spec["ref"])
    rank = coords(mesh)["model"]
    block = _cache_block({k: v for k, v in ref["cache"].items()
                          if k != "first"}, cfg, mesh, rank)
    block["first"] = ref["cache"]["first"]
    zero()
    logits, _ = two_tier_forced(model, cfg, block, ref["tokens"], mesh)
    out = {"tf": {**_tf_compare(logits, ref["logits"]), "launches": read(),
                  "slots": {k: int(block[k].shape[3])
                            for k in ("gk", "wk")}},
           "faults": {}}
    for fault in spec.get("faults", ()):
        with _planted(fault, model, mesh, rank):
            logits, _ = two_tier_forced(model, cfg, block, ref["tokens"],
                                        mesh)
        out["faults"][fault] = {
            k: v for k, v in _tf_compare(logits, ref["logits"]).items()
            if k in ("decode_rel", "max_rel")}
    return out


def fleet_tp_run(model, cfg, mesh, path: str, seed: int, zero, read,
                 sync) -> dict:
    """``serve_tp`` (e) on one side (``mesh`` None: the unsharded fleet
    here; else one rank): 2 warmed engines of the serve cell on ``mesh``
    behind a ``Router`` with the journal at ``path`` (on a mesh rank 0
    writes it and the others mirror it: ``launch/serve.py``
    ``_open_journal``), the serve CLI's chaos plan, the ranks' decisions
    compared before every router step; killed at journal append
    FLEET_CRASH_AT, then the journal reopened and the fleet recovered on
    the same engines, the rest of the trace served.  The launch counters
    are zeroed after the warm-up and read at the end.  -> the streams,
    each draw's scores (``_record_scores``), the digests and counts."""
    from repro_torch.launch import serve
    from repro_torch.serve import (DONE, TERMINAL, FleetFaultInjector,
                                   Router, ServeEngine, SimulatedCrash,
                                   chaos_plan, crash_after_appends,
                                   synthetic_trace)
    trace = synthetic_trace(16, seed=0, vocab=cfg.vocab, mean_prompt=256,
                            max_prompt=1024, mean_gen=32, max_gen=64)
    engines = [ServeEngine(model, cfg, max_slots=FLEET_SLOTS,
                           max_len=FLEET_LEN,
                           prompt_buckets=serve._fleet_buckets(FLEET_LEN),
                           policy_name="bf16", quantized=True, kv_splits=4,
                           sampler_keys="request", seed=seed, mesh=mesh)
               for _ in range(2)]
    for e in engines:
        e.warmup()
    sync()
    zero()

    def tokens_of(router):
        return {g: list(fr.tokens) for g, fr in router._reqs.items()
                if fr.state == DONE}

    recs: dict = {}
    t0 = time.time()
    with Smoke._record_scores(None, engines, cfg.vocab, recs):
        journal = serve._open_journal(path, mesh)
        crash = crash_after_appends(journal, FLEET_CRASH_AT)
        router = Router(engines, journal=journal, digest_decisions=True)
        fleet_inj = FleetFaultInjector(router, chaos_plan(
            FLEET_TP_CHAOS, steps=max(8, len(trace)), replicas=2,
            n_events=3))
        serve._check_every_step(router, mesh)
        try:
            router.run(trace)
        except SimulatedCrash:
            pass
        done = tokens_of(router)
        crash_step, digests = router.step_no, [router.decision_digest()]
        pre = [sum(e.n_prefills for e in engines),
               sum(e.n_decode_rounds for e in engines)]
        journal.close()
        for e in engines:                 # kill -9: the requests vanish
            for rid, st in list(e.request_states().items()):
                if st["state"] not in TERMINAL:
                    e.evict_request(rid)
            e.reset()
        journal = serve._open_journal(path, mesh)
        n_live, n_sub = journal.state.n_live, journal.state.next_gid
        router = Router(engines, journal=journal, digest_decisions=True)
        info = router.recover()
        serve._check_decisions(router, mesh, "in the recovery")
        rest = [dataclasses.replace(r, arrival_step=max(
            0, r.arrival_step - crash_step)) for r in sorted(
            trace, key=lambda r: r.arrival_step)[n_sub:]]
        serve._check_every_step(router, mesh)
        summary = router.run(rest)
        serve._check_decisions(router, mesh, "over the trace")
        journal.close()
    sync()
    wall = time.time() - t0
    digests.append(router.decision_digest())
    return {"streams": {str(g): t for g, t in {
                **done, **tokens_of(router)}.items()},
            "recs": [[k, i, *v] for (k, i), v in recs.items()],
            "n_requests": len(trace), "crashed": crash["fired"],
            "n_live_at_crash": n_live, "recovered": info["n_recovered"],
            "crash_router_step": crash_step,
            "injected": dict(fleet_inj.injected),
            "reconcile": summary["reconcile"]["ok"]
            and summary["reconcile"]["checks"]["journal_accounted"],
            "leak_free": all(e.pool.occupancy == 0
                             and e.pool.allocs == e.pool.frees
                             for e in engines),
            "launches": read(), "prefills": pre[0] + sum(
                e.n_prefills for e in engines),
            "decode_rounds": pre[1] + sum(e.n_decode_rounds
                                          for e in engines),
            "digests": digests, "decisions": router.n_decisions,
            "failovers": summary["fleet"]["failovers"], "wall_s": wall}


def _fleet_rank(spec, model, cfg, mesh, dev, zero, read) -> dict:
    """``serve_tp`` (e) on one rank: :func:`fleet_tp_run` on the mesh,
    the journal beside the spec's files (rank 0 alone writes it)."""
    import torch
    path = os.path.join(os.path.dirname(spec["out"]), "e_wal.jsonl")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return {"fleet": fleet_tp_run(model, cfg, mesh, path, spec["seed"],
                                  zero, read, sync)}


def fleet_worker(n_layers: int, init_seed: int = 0, **engine_kwargs):
    """The fleet's subprocess replica (``serve/worker.py``'s factory,
    ``chip_smoke:fleet_worker``, called in the child): the serve cell's
    llama3-8b at ``n_layers`` from ``init_seed`` on the card, bf16, the
    weights ``run_serve`` gives the in-process replicas."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(configs.get_config("llama3-8b"),
                              n_layers=n_layers)
    model = transformer.init_params(cfg, init_seed,
                                    device=torch.device("cuda", 0),
                                    dtype=torch.bfloat16)
    return ServeEngine(model, cfg, **engine_kwargs)


def _spec_cfg(fields: dict):
    """The parent's config, field for field, from its JSON spec (tuples
    travel as lists, the MoE / MLA / SSM / encoder sub-configs as
    dicts)."""
    from repro_torch.models import config as mc
    sub = {"moe": mc.MoEConfig, "mla": mc.MLAConfig, "ssm": mc.SSMConfig,
           "encoder": mc.EncoderConfig}
    return mc.ModelConfig(**{
        k: sub[k](**v) if k in sub and v is not None
        else tuple(v) if isinstance(v, list) else v
        for k, v in fields.items()})


def tp_child(arg: str) -> int:
    """One rank of ``serve_tp`` (b)-(d), run as ``chip_smoke.py --tp-child
    spec.json,rank``: gloo over the parent's card, the kernels loaded
    from the libraries the parent built; this rank's block of the model
    (``init_params(mesh=)`` from ``--seed``), then the teacher-forced
    serve steps against the parent's saved run, then the serve cell's
    engine over the serve trace with the launch counters zeroed before
    and read after."""
    path, rank = arg.rsplit(",", 1)
    rank = int(rank)
    spec = json.loads(pathlib.Path(path).read_text())
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import Mesh, coords
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine, synthetic_trace
    torch.set_num_threads(1)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        for lib in ("flash_fwd", "flash_fwd_sm90", "flash_decode", "ssd",
                    "ssd_sm90"):
            if not build.library_path(lib).exists():
                raise RuntimeError(f"tp_child: {lib}.cu is not built")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    world = spec["world"]
    dist.init_process_group("gloo", init_method=f"file://{spec['rdv']}",
                            rank=rank, world_size=world)
    try:
        cfg = _spec_cfg(spec["cfg"])
        mesh = Mesh(data=1, model=world)
        dtype = torch.bfloat16 if spec["policy"] == "bf16" \
            else torch.float32
        # build nothing on the card until the ranks named have ended and
        # ``need`` bytes (3x this rank's f32 weights) are free
        deadline = time.time() + TPT_JOIN_S
        while not all(os.path.exists(p) for p in spec.get("after", ())) or (
                dev.type == "cuda"
                and torch.cuda.mem_get_info(dev)[0] < spec.get("need", 0)):
            if time.time() > deadline:
                raise TimeoutError(f"tp_child: waited for {spec['after']}")
            time.sleep(0.2)
        model = transformer.init_params(cfg, spec["seed"], device=dev,
                                        dtype=dtype, mesh=mesh)
        _seed_biases(model, cfg, spec["seed"], mesh)
        kernels = Smoke._all_counters()
        out = {"rank": rank,
               "mode": "seq (latents)" if cfg.mla is not None
               else shd.serve_kv_shard(mesh, cfg.n_kv, 2048)}

        def zero():
            for k in kernels.values():
                k.launches = 0

        def read():
            return {n: k.launches for n, k in kernels.items()}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        frames = None
        if spec.get("two_tier"):
            out.update(_two_tier_rank(spec, model, cfg, mesh, dev, zero,
                                      read))
        elif spec.get("fleet"):
            out.update(_fleet_rank(spec, model, cfg, mesh, dev, zero, read))
        elif spec["ref"]:
            ref = torch.load(spec["ref"])
            zero()
            routing = []
            frames = ref.get("frames")
            frames = None if frames is None else frames.to(dev)
            with _routing_spy(routing, len(ref.get("routing", ()))):
                logits, _, own = tp_forced(model, cfg, spec["policy"],
                                           ref["prompts"].to(dev), mesh=mesh,
                                           forced=ref["tokens"],
                                           frames=frames)
            out["tf"] = {**_tf_compare(logits, ref["logits"]),
                         "launches": read()}
            if cfg.moe is not None:
                out["tf"]["routing"] = _routing_agreement(
                    ref["routing"], routing, cfg.moe.top_k)
            # the decode steps again from this rank's block of the
            # unsharded run's prefill cache: the decode path's own
            # arithmetic, without the caches' rounding of the prefill
            block = _cache_block(ref["cache"], cfg, mesh, rank)
            out["tf"]["cache"] = _cache_diff(own, block)
            if cfg.mla is not None:
                out["tf"]["cache"]["unsharded_latent_bytes"] = sum(
                    ref["cache"][n].numel() * ref["cache"][n].element_size()
                    for n in ("mla_lat", "mla_rope"))
            logits, _, _ = tp_forced(model, cfg, spec["policy"],
                                     ref["prompts"].to(dev), mesh=mesh,
                                     forced=ref["tokens"], cache=block,
                                     frames=frames)
            out["tf"]["from_ref_cache"] = _tf_compare(logits, ref["logits"])
            del ref, logits
        if spec["engine"]:
            trace = synthetic_trace(16, seed=0, vocab=cfg.vocab,
                                    mean_prompt=256, max_prompt=1024,
                                    mean_gen=32, max_gen=64)
            engine = ServeEngine(model, cfg, max_slots=8, max_len=2048,
                                 policy_name="bf16", quantized=True,
                                 kv_splits=TP_SPLITS, mesh=mesh)
            engine.warmup()
            sync()
            zero()
            t0 = time.time()
            summary = engine.run(trace)
            sync()
            wall = time.time() - t0
            diag = summary["diagnostics"]
            audit = engine.pool.audit()
            out["engine"] = {
                "streams": {str(r.rid): list(r.tokens)
                            for r in engine._requests_done},
                "n_done": summary["n_done"], "n_faults": summary["n_faults"],
                "audit_clean": audit["allocs"] == audit["frees"]
                and engine.pool.occupancy == 0,
                "launches": read(), "prefills": diag["prefills"],
                "decode_rounds": diag["decode_rounds"], "wall_s": wall,
                "tokens_per_s": summary["tokens_per_s"],
                "itl_mean_s": summary["itl_mean_s"],
                "round_host_ms": wall / max(1, summary["n_steps"]) * 1e3,
                "bytes_per_slot_per_device":
                    engine.pool.bytes_per_slot_per_device()}
        # the serving peak, before the faults' copies of w_down
        out["peak"] = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        if spec["ref"] and not spec.get("two_tier"):
            # the same teacher-forced run under each planted fault: what
            # the gates must refuse
            ref = torch.load(spec["ref"])
            out["faults"] = {}
            for fault in spec.get("faults", TP_FAULTS):
                if fault == "merge_drop0" and out["mode"] != "seq":
                    continue
                with _planted(fault, model, mesh, rank):
                    logits, _, _ = tp_forced(
                        model, cfg, spec["policy"], ref["prompts"].to(dev),
                        mesh=mesh, forced=ref["tokens"], frames=frames)
                out["faults"][fault] = {
                    k: v for k, v in _tf_compare(logits, ref["logits"])
                    .items() if k in ("prefill_rel", "decode_rel",
                                      "max_rel")}
            del ref
        if spec.get("bf16_ref"):
            # the same weights in bf16 against the unsharded bf16 run:
            # reported beside the f32 gates
            ref = torch.load(spec["bf16_ref"])
            model = model.to(torch.bfloat16)
            logits, _, _ = tp_forced(model, cfg, "bf16",
                                     ref["prompts"].to(dev), mesh=mesh,
                                     forced=ref["tokens"], frames=frames)
            out["tf_bf16"] = {
                k: v for k, v in _tf_compare(logits, ref["logits"]).items()
                if k in ("prefill_rel", "decode_rel", "greedy_equal")}
            del ref
        pathlib.Path(f"{spec['out']}.{rank}").write_text(json.dumps(out))
        dist.barrier()           # no rank tears gloo down under another
    finally:
        dist.destroy_process_group()
    return 0


def _local_params(cfg, world: int) -> int:
    """The parameters one rank of a (1, ``world``) mesh holds of ``cfg``
    (``transformer.param_placement``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    mesh = Mesh(data=1, model=world)
    specs = transformer.param_placement(cfg, mesh)
    return sum(math.prod(shd.local_shape(p.shape, specs[n], mesh))
               for n, p in transformer.init_params(
                   cfg, device="meta").named_parameters())


def _tpt_leaves(cfg) -> list:
    """The leaves ``train_tp`` reads, of the middle layer where per layer:
    a column-parallel (``w_up``; ``wq`` too, whole in sequence mode), a
    row-parallel (``w_down``), the embedding, the head and a norm; for an
    MoE (``moe_tp``) the router, ``w_gate``, ``w_down``, the shared
    experts' ``shared_gate`` / ``shared_down``, the embedding, the head
    and a norm; for ``ssm_tp`` the SSM's leaves (whole on every rank), the
    hybrid's mix norm and FFN, the encoder-decoder's attention,
    cross-attention, GELU MLP (``b2`` too) and an encoder layer's, and
    MLA's down-projections, a latent norm, ``q_b`` / ``kv_b`` / ``wo``
    and ``w_down``."""
    mid = f"blocks.{cfg.n_layers // 2}"
    if cfg.encoder is not None:     # ssm_tp: the encoder-decoder
        enc = f"enc_blocks.{cfg.encoder.n_layers // 2}"
        return [f"{mid}.attn.wq", f"{mid}.xattn.wq", f"{mid}.xattn.wo",
                f"{mid}.ffn.w1", f"{mid}.ffn.w2", f"{mid}.ffn.b2",
                f"{enc}.attn.wq", f"{enc}.ffn.w2", "embed", "lm_head",
                f"{mid}.ln2"]
    if cfg.mixer == "ssm":          # ssm_tp: no MLP, so no ln2 gradient
        # (a_log and dt_bias start at zero: their largest |parameter| is a
        # few lr steps, which the params gates would divide by)
        return [f"{mid}.ssm.{n}" for n in ("in_proj", "conv_w", "d_skip",
                                            "out_proj")] \
            + ["embed", "lm_head", f"{mid}.ln1"]
    if cfg.mixer == "hybrid":
        return [f"{mid}.attn.wq", f"{mid}.ssm.in_proj", f"{mid}.ssm.out_proj",
                f"{mid}.mix_norm_ssm", f"{mid}.ffn.w_up", f"{mid}.ffn.w_down",
                "embed", "lm_head", f"{mid}.ln2"]
    if cfg.mla is not None:         # ssm_tp (f): MLA's split and whole
        return [f"{mid}.attn.{n}" for n in ("q_a", "kv_a", "kv_a_norm",
                                            "q_b", "kv_b", "wo")] \
            + [f"{mid}.ffn.w_down", "embed", "lm_head", f"{mid}.ln2"]
    if cfg.moe is not None:         # moe_tp: the router, experts, a norm
        shared = ["shared_gate", "shared_down"] if cfg.moe.num_shared \
            else []
        return [f"{mid}.ffn.{n}" for n in ["router", "w_gate", "w_down",
                                           *shared]] \
            + ["embed", "lm_head", f"{mid}.ln2"]
    return [f"{mid}.attn.wq", f"{mid}.ffn.w_up", f"{mid}.ffn.w_down",
            "embed", "lm_head", f"{mid}.ln2"]


def _tpt_window(name: str, x):
    """What ``train_tp`` reads of a rank's block: the first TPT_WINDOW
    vocab entries of the embedding's rows and of the head's columns, the
    first TPT_EXPERT_WINDOW of an MoE's experts (``w_gate`` / ``w_down``,
    (E_local, ., .)), the whole block of every other leaf."""
    if name == "embed":
        return x[:TPT_WINDOW]
    if name == "lm_head":
        return x[:, :TPT_WINDOW]
    if x.ndim == 3:
        return x[:TPT_EXPERT_WINDOW]
    return x


def _tpt_blocks(named: dict, cfg, mesh) -> dict:
    """{rank: {name: the window of that rank's block, on the host}} of the
    unsharded ``named`` tensors, cut by ``transformer.param_placement``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import coords
    from repro_torch.models import transformer
    specs = transformer.param_placement(cfg, mesh)
    return {r: {n: _tpt_window(n, shd.shard_leaf(
                x.detach(), specs[n], mesh, coords(mesh, r))).to(
                    "cpu", copy=True)
                for n, x in named.items()}
            for r in range(mesh.size)}


def _tpt_readings(ref: dict, losses, norms, grads=None,
                  params=None) -> dict:
    """A run's readings against the unsharded run ``ref`` (one rank's
    file: its windows of the saved leaves): the losses' and grad norms'
    largest relative difference over the steps read; the step-1
    gradients' (``grads``) largest |diff| over each leaf's largest
    |gradient|; and the parameters' after the steps (``params``) |diff|
    over the norm of the unsharded run's update of the window
    (``params``) and largest |diff| over the leaf's largest |parameter|
    (``params_max``; ``params_floor`` over the entries whose step-1
    gradient is at least TPT_A_GRAD_FLOOR of the leaf's largest;
    ``params_max_grad`` the step-1 |gradient| at the worst entry of
    ``params_max`` over the leaf's largest)."""
    out = {"loss": max(abs(a - b) / abs(b) for a, b in
                       zip(losses, ref["losses"])),
           "grad_norm": max(abs(a - b) / abs(b) for a, b in
                            zip(norms, ref["grad_norms"]))}
    if grads is not None:
        out["grads"] = max(
            float((grads[n].float().cpu() - w).abs().max())
            / ref["grad_max"][n] for n, w in ref["grads1"].items())
    if params is not None:
        diff = {n: params[n].float().cpu() - w
                for n, w in ref["final"].items()}
        out["params"] = max(float(d.norm()) / ref["update_norm"][n]
                            for n, d in diff.items())
        rel = {n: d.abs() / ref["param_max"][n] for n, d in diff.items()}
        g1 = {n: ref["grads1"][n].abs() / ref["grad_max"][n] for n in diff}
        worst = max(rel, key=lambda n: float(rel[n].max()))
        out["params_max"] = float(rel[worst].max())
        out["params_max_grad"] = float(
            g1[worst].reshape(-1)[int(rel[worst].argmax())])
        out["params_floor"] = max(
            float(rel[n][g1[n] >= TPT_A_GRAD_FLOOR].max()) for n in rel)
    return out


def _tpt_digest(tensors) -> list:
    """Two integer checksums of the bits of ``tensors`` (in order): equal
    lists mean bit-equal tensors, save for a collision."""
    import torch
    out = []
    for t in tensors:
        v = t.detach().float().contiguous().view(torch.int32).reshape(-1)
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        out += [int(v.long().sum()), int((v.long() * w).sum())]
    return out


def _tpt_steps(step, model, opt, ls, batches, warmup: int, names,
               keep=lambda name, g: g) -> tuple:
    """``train_tp``'s run of one side (the unsharded run or a rank): each
    batch through ``step``, the launch counters zeroed after ``warmup``
    steps, ``keep(name, gradient)`` copied for ``names`` from the
    gradients the first step hands to AdamW (through a wrapper of
    ``adamw.update``; a rank keeps only its windows, so its peak is the
    training's).  -> (model, each step's metrics and host seconds, the
    launches of the steps after the warm-up, the first step's kept
    gradients)."""
    from repro_torch.optim import adamw
    first, real = {}, adamw.update

    def update(c, grads, *args, **kwargs):
        if not first:
            first.update({n: keep(n, grads[n].detach()).clone()
                          for n in names})
        return real(c, grads, *args, **kwargs)

    kernels = Smoke._all_counters()
    recs = []
    adamw.update = update
    try:
        for i, batch in enumerate(batches):
            if i == warmup:
                for k in kernels.values():
                    k.launches = 0
            t = time.time()
            model, opt, ls, m = step(model, opt, ls, batch)
            vals = {k: float(v) for k, v in m.items()}      # syncs
            vals["step_s"] = time.time() - t
            recs.append(vals)
    finally:
        adamw.update = real
    return model, recs, {n: k.launches for n, k in kernels.items()}, first


@contextlib.contextmanager
def _routing_spy(calls: list, limit: int):
    """Record the MoE FFN's first ``limit`` routing calls into ``calls``:
    each call's top-k indices and router probabilities on the host, and
    the assignments this rank's capacity dispatch kept."""
    import torch
    from repro_torch.models import moe
    topk, slots = moe.router_topk, moe.dispatch_slots

    def topk_spy(x, w, k):
        out = topk(x, w, k)
        if len(calls) < limit:
            probs = torch.softmax(x.detach().float() @ w.detach().float(),
                                  dim=-1)
            calls.append({"top_i": out[1].cpu(), "probs": probs.cpu(),
                          "kept": None})
        return out

    def slots_spy(top_i, e, cap):
        dst, keep = slots(top_i, e, cap)
        if calls and calls[-1]["kept"] is None:
            calls[-1]["kept"] = int(keep.sum())
        return dst, keep

    moe.router_topk, moe.dispatch_slots = topk_spy, slots_spy
    try:
        yield
    finally:
        moe.router_topk, moe.dispatch_slots = topk, slots


def _routing_agreement(ref: list, got: list, k: int) -> dict:
    """A rank's routing calls against the unsharded run's, call for call
    (``moe_model``'s rule): tokens whose k experts differ, and of those
    the ones not at a near-tie (the unsharded run's k-th and (k+1)-th
    probabilities more than 2 f32 ulps apart); the kept assignments of
    each call."""
    import numpy as np
    n_tok = n_diff = n_not_tie = 0
    for r, g in zip(ref, got):
        differ = (r["top_i"].sort(-1).values
                  != g["top_i"].sort(-1).values).any(-1)
        n_tok += r["top_i"].shape[0]
        n_diff += int(differ.sum())
        for row in r["probs"][differ].sort(-1, descending=True).values \
                .numpy():
            ulp = np.spacing(np.float32(row[k - 1]))
            n_not_tie += int(row[k - 1] - row[k] > 2 * ulp)
    return {"calls": len(got), "tokens": n_tok, "differ": n_diff,
            "not_near_tie": n_not_tie, "kept": [c["kept"] for c in got],
            "ref_kept": [c["kept"] for c in ref]}


def _routing_summary(ranks: list, ref_kept: list, ep: bool,
                     key=lambda rk: rk["routing"]) -> dict:
    """Every rank's ``_routing_agreement`` folded: the worst rank's
    counts, and whether the kept assignments equal the unsharded run's
    call for call (TP-experts: each rank's; expert parallelism: the
    ranks' sum, each rank keeping its own experts' assignments)."""
    rs = [key(rk) for rk in ranks]
    kept = [sum(c) for c in zip(*(r["kept"] for r in rs))] if ep \
        else rs[0]["kept"]
    return {"calls": rs[0]["calls"],
            "calls_equal": all(r["calls"] == len(ref_kept) for r in rs),
            "tokens": rs[0]["tokens"],
            "differ": max(r["differ"] for r in rs),
            "not_near_tie": max(r["not_near_tie"] for r in rs),
            "kept_equal": kept == ref_kept and (ep or all(
                r["kept"] == ref_kept for r in rs)),
            "kept": kept, "unsharded_kept": ref_kept}


@contextlib.contextmanager
def _moe_fault(fault: str, model, mesh):
    """An MoE fault planted in every rank's run, undone after (see
    MOE_TP_FAULTS): ``moe_partial_dropped``, the last rank of the model
    axis sends zeros for its partial of the middle layer's MoE;
    ``ep_offset_zero``, every rank takes its experts from offset 0;
    ``combine_weights_unsummed``, the combine weights skip
    ``copy_to_model`` (their gradient stays this rank's partial);
    ``router_input_summed``, the router's input takes ``copy_to_model``
    (its gradient, already whole, summed over the axis)."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import coords
    from repro_torch.models import moe, transformer
    if fault == "moe_partial_dropped":
        last = coords(mesh)["model"] == mesh.shape["model"] - 1
        mid, real = model.blocks[len(model.blocks) // 2].ffn, \
            transformer.ffn_apply

        def patched(ffn, h, cfg, dtype=None, mesh=None):
            if ffn is not mid:
                return real(ffn, h, cfg, dtype, mesh)
            reduce = collectives.reduce_from_model
            collectives.reduce_from_model = \
                lambda x, mesh, axis="model": reduce(x * 0 if last else x,
                                                     mesh, axis)
            try:
                return real(ffn, h, cfg, dtype, mesh)
            finally:
                collectives.reduce_from_model = reduce
        where, name = transformer, "ffn_apply"
    elif fault == "ep_offset_zero":
        real = moe.expert_layout

        def patched(weights, cfg, mesh):
            return real(weights, cfg, mesh)[0], 0
        where, name = moe, "expert_layout"
    elif fault == "combine_weights_unsummed":
        real = moe._route

        def patched(weights, x, cfg, mesh):
            copy, calls = collectives.copy_to_model, []

            def second_whole(t, mesh, axis="model"):
                calls.append(t)        # the experts' input, then w
                return t if len(calls) == 2 else copy(t, mesh, axis)
            collectives.copy_to_model = second_whole
            try:
                return real(weights, x, cfg, mesh)
            finally:
                collectives.copy_to_model = copy
        where, name = moe, "_route"
    elif fault == "router_input_summed":
        real = moe.router_topk

        def patched(x, w, k):
            return real(collectives.copy_to_model(x, mesh), w, k)
        where, name = moe, "router_topk"
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(where, name, patched)
    try:
        yield
    finally:
        setattr(where, name, real)


#: the planted faults of ssm_tp (_mixer_fault)
MIXER_FAULTS = ("ffn_partial_dropped", "b2_per_rank", "ssm_input_copied",
                "xattn_unreduced", "band_local_positions",
                "mla_rope_uncopied", "mla_wo_unreduced",
                "mla_latent_uncopied", "mla_latent_local_positions",
                "window_write_local")


@contextlib.contextmanager
def _mixer_fault(fault: str, model, mesh):
    """An ``ssm_tp`` fault planted in every rank's run, undone after:
    ``ffn_partial_dropped``, the last rank of the model axis sends zeros
    for its partial of the middle layer's FFN (the SwiGLU's or the GELU
    MLP's row-parallel sum); ``b2_per_rank``, the GELU MLP adds its
    whole ``b2`` on every rank before the row-parallel sum (n times in
    all); ``ssm_input_copied``, the SSM mixer takes its input through
    ``copy_to_model`` (its input gradient, whole already, summed over the
    axis: the loss exact, every gradient below it n-fold);
    ``xattn_unreduced``, the cross-attention's ``wo`` partials left
    unsummed; ``band_local_positions``, the sequence-split decode reads a
    windowed layer's band at the local positions of its shard, not the
    global ones; ``mla_rope_uncopied`` / ``mla_latent_uncopied``, MLA's
    rope key / its two latents enter the heads without ``copy_to_model``
    (their gradient this rank's heads' partial: the loss exact);
    ``mla_wo_unreduced``, MLA's ``wo`` partials left unsummed;
    ``mla_latent_local_positions``, every rank writes a decode step's
    latent at the slot's local index in its block, owning it or not;
    ``window_write_local``, the two-tier window's rolling write likewise
    (every rank at ``(pos % W) % W_l``)."""
    from repro_torch.distributed import collectives
    from repro_torch.models import attention, layers, transformer
    from repro_torch.models import ssm as ssm_mod
    if fault == "ffn_partial_dropped":
        with _moe_fault("moe_partial_dropped", model, mesh):
            yield
        return
    if fault == "b2_per_rank":
        real = transformer.ffn_apply

        def patched(ffn, h, cfg, dtype=None, mesh=None):
            if not isinstance(ffn, transformer.GeluMLP) \
                    or ffn.w2.shape[0] == cfg.d_ff:
                return real(ffn, h, cfg, dtype, mesh)
            w1, b1, w2, b2 = (getattr(ffn, n) if dtype is None
                              else getattr(ffn, n).to(dtype)
                              for n in transformer.GeluMLP.NAMES)
            h = collectives.copy_to_model(h, mesh)
            return collectives.reduce_from_model(
                layers.gelu_mlp(h, w1, b1, w2, b2), mesh), 0.0
        where, name = transformer, "ffn_apply"
    elif fault == "ssm_input_copied":
        real = ssm_mod.ssm_block

        def patched(p, x, cfg, **kw):
            return real(p, collectives.copy_to_model(x, mesh), cfg, **kw)
        where, name = ssm_mod, "ssm_block"
    elif fault == "xattn_unreduced":
        real = attention.cross_attn_block

        def patched(p, x, enc_kv, cfg, mesh=None):
            return real(p, x, enc_kv, cfg)
        where, name = attention, "cross_attn_block"
    elif fault == "band_local_positions":
        real = collectives.sp_decode_attention_int8
        n = mesh.shape["model"]

        def patched(q, k_q, *args, bias=None, **kw):
            if bias is not None:          # every shard reads columns 0..S_l
                bias = bias[:, :k_q.shape[2]].repeat(1, n)
            return real(q, k_q, *args, bias=bias, **kw)
        where, name = collectives, "sp_decode_attention_int8"
    elif fault in ("mla_rope_uncopied", "mla_latent_uncopied",
                   "mla_wo_unreduced"):
        real, copy, reduce = attention.mla_block, \
            collectives.copy_to_model, collectives.reduce_from_model
        # the rope key is (B, S, 1, dr), each latent (B, S, r)
        skip = 4 if fault == "mla_rope_uncopied" else 3

        def patched(*args, **kw):
            if fault == "mla_wo_unreduced":
                collectives.reduce_from_model = lambda x, m, axis="model": x
            else:
                collectives.copy_to_model = lambda x, m, axis="model": \
                    x if x.ndim == skip else copy(x, m, axis)
            try:
                return real(*args, **kw)
            finally:
                collectives.copy_to_model = copy
                collectives.reduce_from_model = reduce
        where, name = attention, "mla_block"
    elif fault == "mla_latent_local_positions":
        real = collectives.write_seq_shard
        r = collectives.model_axis(mesh)[2]

        def patched(cache, new, at, mesh, axis="model"):
            s_l = cache.shape[1]          # every rank owns its local slot
            return real(cache, new, r * s_l + at % s_l, mesh, axis)
        where, name = collectives, "write_seq_shard"
    elif fault == "window_write_local":
        real = collectives.sp_decode_attention_int8
        n, r = mesh.shape["model"], collectives.model_axis(mesh)[2]
        window = model.cfg.window

        def patched(q, k_q, k_s, v_q, v_s, write, write_at, mesh, **kw):
            s_l = k_q.shape[2]
            if s_l * n == window:         # the window tier's rolling write
                write_at = r * s_l + write_at % s_l
            return real(q, k_q, k_s, v_q, v_s, write, write_at, mesh, **kw)
        where, name = collectives, "sp_decode_attention_int8"
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(where, name, patched)
    try:
        yield
    finally:
        setattr(where, name, real)


@contextlib.contextmanager
def _train_fault(fault: str, model, mesh):
    """A fault planted in every rank's training, undone after (see
    TPT_FAULTS, and MOE_TP_FAULTS: ``_moe_fault``): ``copy_mid_ffn``, the
    middle layer's FFN takes its input without ``copy_to_model`` (its
    input gradient stays this rank's partial); ``ce_sum_unreduced``, the
    CE's second reduction (the sum of exp) is this rank's own;
    ``copy_seq_attn``, every layer's attention takes its input through
    ``copy_to_model``."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.models import attention, transformer
    if fault in MOE_TP_FAULTS["a"] + MOE_TP_FAULTS["b"]:
        with _moe_fault(fault, model, mesh):
            yield
        return
    if fault in MIXER_FAULTS:
        with _mixer_fault(fault, model, mesh):
            yield
        return
    if fault == "copy_mid_ffn":
        mid, real = model.blocks[len(model.blocks) // 2].ffn, \
            transformer.ffn_apply

        def patched(ffn, h, cfg, dtype=None, mesh=None):
            if ffn is not mid:
                return real(ffn, h, cfg, dtype, mesh)
            copy = collectives.copy_to_model
            collectives.copy_to_model = lambda x, mesh, axis="model": x
            try:
                return real(ffn, h, cfg, dtype, mesh)
            finally:
                collectives.copy_to_model = copy
        where, name = transformer, "ffn_apply"
    elif fault == "ce_sum_unreduced":
        real = transformer.vocab_parallel_ce

        def patched(logits32, labels, mesh):
            reduce, calls = collectives.all_reduce_f32, []

            def own_sum(x, op, group):
                calls.append(op)
                return x.to(torch.float32, copy=True) if len(calls) == 2 \
                    else reduce(x, op, group)
            collectives.all_reduce_f32 = own_sum
            try:
                return real(logits32, labels, mesh)
            finally:
                collectives.all_reduce_f32 = reduce
        where, name = transformer, "vocab_parallel_ce"
    elif fault == "copy_seq_attn":
        real = attention.attn_block

        def patched(p, x, cfg, *, mesh=None, **kw):
            return real(p, collectives.copy_to_model(x, mesh), cfg,
                        mesh=mesh, **kw)
        where, name = attention, "attn_block"
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(where, name, patched)
    try:
        yield
    finally:
        setattr(where, name, real)


@contextlib.contextmanager
def _moment_fault(sharded: dict):
    """``nu_shifted`` (see TPT_FAULTS): before each AdamW update, every
    sharded leaf's second moment rolled by one row along its first
    dimension, so it is read one row off its parameter block."""
    import torch
    from repro_torch.optim import adamw
    real = adamw.update

    def update(c, grads, state, *args, **kwargs):
        for n, on in sharded.items():
            if on:
                state.nu[n] = torch.roll(state.nu[n], 1, 0)
        return real(c, grads, state, *args, **kwargs)

    adamw.update = update
    try:
        yield
    finally:
        adamw.update = real


def tp_train_child(arg: str) -> int:
    """One rank of ``train_tp``, run as ``chip_smoke.py --tp-train-child
    spec.json,rank``: gloo over the parent's card, the kernels loaded from
    the libraries the parent built; this rank's block of the f32 master
    weights and AdamW state (``launch/train.py`` ``init_state(mesh=)``
    from ``--seed``), the step from ``make_train_step(mesh=)``.  First the
    planted faults, each one forward and backward of the first batch from
    the initial weights; then the sound run: ``warmup`` steps and
    ``timed`` steps with the launch counters zeroed between, the first
    step's gradients (what the step hands to AdamW) read against the
    parent's unsharded run, the replicated leaves' checksums, each step's
    loss, grad norm and host time, the peak."""
    path, rank = arg.rsplit(",", 1)
    rank = int(rank)
    spec = json.loads(pathlib.Path(path).read_text())
    import torch
    import torch.distributed as dist
    from repro_torch.core.checkpoint import CheckpointConfig
    from repro_torch.core.mixed_precision import (get_policy,
                                                  scaled_value_and_grad)
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import init_state
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, init_loss_scale,
                                              make_train_step)
    torch.set_num_threads(1)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        for lib in ("flash_fwd", "flash_fwd_sm90", "flash_bwd",
                    "flash_bwd_sm90", "ssd", "ssd_sm90", "ssd_bwd",
                    "ssd_bwd_sm90"):
            if not build.library_path(lib).exists():
                raise RuntimeError(f"tp_train_child: {lib}.cu is not built")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    world = spec["world"]
    dist.init_process_group("gloo", init_method=f"file://{spec['rdv']}",
                            rank=rank, world_size=world)
    try:
        cfg = _spec_cfg(spec["cfg"])
        mesh = Mesh(data=1, model=world)
        tc = TrainConfig(policy=spec["policy"], remat=CheckpointConfig(
            enabled=True, policy="full", segment_size=1),
            opt=adamw.AdamWConfig())
        step, tc = make_train_step(cfg, tc, {"tokens": torch.empty(
            (spec["batch"], spec["seq"]), dtype=torch.int32,
            device="meta")}, mesh=mesh)
        whole = sorted(n for n, s in step.placement.items()
                       if all(e is None for e in s))
        sharded = {n: n not in whole for n in step.placement}
        batches = _tpt_batches(cfg, spec["batch"], spec["seq"], spec["seed"],
                               dev, spec["warmup"] + spec["timed"])

        def fresh():
            model, opt = init_state(cfg, spec["seed"], dev, mesh)
            _seed_biases(model, cfg, spec["seed"], mesh)
            return model, opt
        # the parent's unsharded run is on the card until it publishes
        # this rank's file: allocate nothing before it
        ref_path = f"{spec['ref']}.{rank}"
        deadline = time.time() + TPT_JOIN_S
        while not os.path.exists(ref_path):
            if time.time() > deadline:
                raise TimeoutError(f"tp_train_child: no {ref_path}")
            time.sleep(0.2)
        ref = torch.load(ref_path)
        names = _tpt_leaves(cfg)
        moment = {}
        if "nu_shifted" in spec["faults"]:
            # the steps again from the same weights, the moment off by a
            # row; only the parameters after them are read
            with _moment_fault(sharded):
                model, recs, _, _ = _tpt_steps(
                    step, *fresh(), init_loss_scale(tc, dev), batches,
                    spec["warmup"], [])
            params = dict(model.named_parameters())
            got = _tpt_readings(ref, [r["loss"] for r in recs],
                                [r["grad_norm"] for r in recs], params={
                n: _tpt_window(n, params[n].detach()) for n in names})
            moment = {"nu_shifted": {"params": got["params"],
                                     "params_max": got["params_max"]}}
            del model, params
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t0 = time.time()
        model, opt = fresh()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out = {"rank": rank, "init_s": time.time() - t0, "faults": moment,
               "local_params": sum(p.numel() for p in model.parameters()),
               "replicated_leaves": len(whole)}
        policy = get_policy(spec["policy"])

        def loss_for(m, b):
            return transformer.loss_fn(m, cfg, b, policy=policy,
                                       remat=tc.remat, mesh=mesh)

        for fault in spec["faults"]:
            if fault == "nu_shifted":
                continue
            with _train_fault(fault, model, mesh):
                (loss, _), grads, _ = scaled_value_and_grad(loss_for)(
                    model, batches[0])
                norm = adamw.sharded_global_norm(grads, sharded, mesh)
            out["faults"][fault] = _tpt_readings(
                ref, [float(loss)], [float(norm)],
                grads={n: _tpt_window(n, grads[n]) for n in names})
            del grads
        routing = []
        with _routing_spy(routing, 2 * cfg.n_layers):
            model, recs, launches, first = _tpt_steps(
                step, model, opt, init_loss_scale(tc, dev), batches,
                spec["warmup"], names + whole, keep=_tpt_window)
        params = dict(model.named_parameters())
        if cfg.moe is not None:
            out["routing"] = _routing_agreement(ref["routing"], routing,
                                                cfg.moe.top_k)
        out.update(
            launches=launches, losses=[r["loss"] for r in recs],
            grad_norms=[r["grad_norm"] for r in recs],
            finite=all(r["grads_finite"] for r in recs),
            step_s=[r["step_s"] for r in recs],
            readings=_tpt_readings(
                ref, [r["loss"] for r in recs],
                [r["grad_norm"] for r in recs],
                grads={n: first[n] for n in names},
                params={n: _tpt_window(n, params[n].detach())
                        for n in names} if "final" in ref else None),
            digest_grads1=_tpt_digest(first[n] for n in whole),
            digest_params=_tpt_digest(params[n] for n in whole),
            peak=torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0)
        pathlib.Path(f"{spec['out']}.{rank}").write_text(json.dumps(out))
        dist.barrier()           # no rank tears gloo down under another
    finally:
        dist.destroy_process_group()
    return 0


def lockstep_child(out: str, argv: list) -> int:
    """``launch/serve.py``'s ``main(argv)`` as one rank of ``ssm_tp`` (e)
    (``chip_smoke.py --lockstep-child OUT ARGS...``, under
    ``torch.distributed.run`` or alone), writing ``OUT.<rank>``: the
    tokens its lockstep served (None where it served none), the launches
    and host times of that lockstep, its exit code, whether it touched the
    card and its peak there."""
    import torch
    from repro_torch.launch import serve
    rank = int(os.environ.get("RANK", "0"))
    counters = Smoke._all_counters()
    rec = {"rank": rank, "tokens": None,
           "launches": {k: 0 for k in counters}, "prefill_s": None,
           "decode_s": None}
    real = serve.lockstep

    def recording(*args, **kwargs):
        for k in counters.values():
            k.launches = 0
        r = real(*args, **kwargs)
        rec.update(tokens=r["tokens"].tolist(), prefill_s=r["prefill_s"],
                   decode_s=r["decode_s"],
                   launches={n: k.launches for n, k in counters.items()})
        return r

    serve.lockstep = recording
    rec["rc"] = serve.main(argv)
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    rec["peak"] = torch.cuda.max_memory_allocated() \
        if rec["cuda_initialized"] else 0
    pathlib.Path(f"{out}.{rank}").write_text(json.dumps(rec))
    return rec["rc"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="also write every result line to this JSON file")
    ap.add_argument("--dp-child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--tp-child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--tp-train-child", default="", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--lockstep-child"]:
        return lockstep_child(argv[1], argv[2:])
    args = ap.parse_args(argv)
    if args.dp_child:
        return dp_child(args.dp_child, args.seed)
    if args.tp_child:
        return tp_child(args.tp_child)
    if args.tp_train_child:
        return tp_train_child(args.tp_train_child)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    # f32 means f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.time()
    logs = build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln or "C7514" in ln]
             for k, v in logs.items()}
    # the tensor-core kernels keep their accumulators in registers (a
    # reused library reports the log of its build; None: no log, a
    # failure), and ptxas did not serialize their wgmma (warning C7514)
    sm90 = ("flash_fwd_sm90", "flash_bwd_sm90", "ssd_sm90", "ssd_bwd_sm90")
    spill_free = {
        lib: all(int(n) == 0 for ln in ptxas[lib]
                 for n in re.findall(r"(\d+) bytes spill", ln))
        if ptxas[lib] else None for lib in (*sm90, "flash_decode")}
    serialized = {lib: any("C7514" in ln for ln in ptxas[lib]) for lib in sm90}
    emit({"phase": "build", "kernels": sorted(logs),
          "source_dir": "src/repro_torch/kernels/csrc",
          "seconds": time.time() - t0, "sm90_spill_free": spill_free,
          "sm90_wgmma_serialized": serialized,
          # registers of each decode instantiation (heads a CTA x D)
          "decode_registers": [int(n) for ln in ptxas["flash_decode"]
                               for n in re.findall(r"Used (\d+) registers",
                                                   ln)],
          "ptxas": ptxas})

    smoke = Smoke(args)
    for lib in (*sm90, "flash_decode"):
        if spill_free[lib] is not True:
            smoke.failures.append(f"build: {lib}.cu spills registers"
                                  if spill_free[lib] is False else
                                  f"build: no ptxas log for {lib}.cu")
        if serialized.get(lib):
            smoke.failures.append(f"build: ptxas serialized {lib}.cu's wgmma")
    bf16, f32 = torch.bfloat16, torch.float32
    # the tensor-core forward (bf16), last at the train shape; the FMA
    # forward (f32), last at S=1024
    flash = [smoke.check_flash(s, bf16) for s in (16, 100, 1024, TRAIN_SEQ)]
    flash_fma = [smoke.check_flash(100, f32),
                 smoke.check_flash(300, f32, window=100),
                 smoke.check_flash(1024, f32)]
    decode = [smoke.check_decode(sp) for sp in (1, 4)]
    hymba_heads = dict(b=SSM_BATCH, h=25, hkv=5, d=64)
    bwd = [smoke.check_flash_bwd(TRAIN_SEQ, bf16, bf16),   # the train shape
           smoke.check_flash_bwd(100, bf16, bf16),
           smoke.check_flash_bwd(300, f32, f32, window=100),
           smoke.check_flash_bwd(300, f32, f32, causal=False, kv_len=200),
           smoke.check_flash_bwd(1024, bf16, f32),        # bf16 residuals
           smoke.check_flash_bwd(TRAIN_SEQ, bf16, f32),   # FMA, train shape
           # head_dim 64 at hymba's heads and prompt, global and window
           smoke.check_flash_bwd(SSM_PROMPT, bf16, bf16, **hymba_heads),
           smoke.check_flash_bwd(SSM_PROMPT, bf16, bf16, window=1024,
                                 **hymba_heads),
           smoke.check_flash_bwd(1000, bf16, bf16, kv_len=777)]  # ragged
    smoke.check_model()
    smoke.run_serve()
    smoke.run_train()
    smoke.run_dryrun()
    smoke.run_train_dp()
    smoke.run_train_tp()
    smoke.run_moe_tp()
    smoke.run_ssm_tp()
    smoke.run_train_plan()
    smoke.run_train_cli()
    pack = [smoke.check_pack(8, 32),                     # the CIFAR batch
            smoke.check_pack(8, 32, scale=0.0173, shift=-0.4217),
            smoke.check_pack(4, 512, scale=0.0173, shift=-0.4217),
            smoke.check_pack(4, 512)]                    # the memory shape
    smoke.check_cifar_model()
    smoke.run_cifar_train()
    smoke.run_cifar_memory()
    # hymba's prefill attention (25 / 5 heads of 64): window and global layers
    flash_ssm = [smoke.check_flash(SSM_PROMPT, bf16, window=w, b=SSM_BATCH,
                                   h=25, hkv=5, d=64) for w in (1024, 0)]
    ssd = [smoke.check_ssd(192, 16, 128, 128, 64, 24),    # mamba2 serve
           smoke.check_ssd(200, 16, 128, 16, 64, 25),     # hymba serve
           smoke.check_ssd(192, 1, 64, 128, 64, 24),      # a 64-token prompt
           smoke.check_ssd(192, 1, 128, 128, 64, 24)]     # a single chunk
    # the FMA route (head_p 16, on no main path) at mamba2's serve shape
    ssd_fma = [smoke.check_ssd(192, 16, 128, 128, 16, 24)]
    dbias = [smoke.check_decode_band(sp, bias=True) for sp in (1, 4)]
    decode.append(smoke.check_decode_band(1, bias=False))  # G = 5
    decode.append(smoke.check_decode_group(6, 64, 2))
    smoke.check_ssm_model()
    smoke.run_serve_ssm()
    # training the SSM family: the chunk's backward at mamba2's and hymba's
    # train shapes (batch 8 x 2048, the tensor-core route), then the FMA
    # route (head_p 16, on no main path) at mamba2's train shape and at the
    # smoke configs' widths
    ssd_bwd = [smoke.check_ssd_bwd(192, 16, 128, 128, 64, 24),
               smoke.check_ssd_bwd(200, 16, 128, 16, 64, 25)]
    ssd_bwd_fma = [smoke.check_ssd_bwd(192, 16, 128, 128, 16, 24),
                   smoke.check_ssd_bwd(8, 2, 32, 16, 16, 4)]
    smoke.check_ssm_train_model()
    smoke.run_train_ssm()
    smoke.run_two_tier()
    # the MoE family and glm4-9b: the kernels at each arch's heads (GQA
    # groups 16, 1 and 3) at the train shape and the decode shape, then the
    # models
    from repro_torch import configs
    t0 = time.time()
    flash_var = []
    for arch in VARIANT_TRAIN_LAYERS:
        if arch in (HEAD160, MLA_ARCH):       # head160_kernels; no kernel
            continue
        cfg = configs.get_config(arch)
        heads = dict(h=cfg.n_heads, hkv=cfg.n_kv, d=cfg.head_dim, arch=arch)
        flash_var.append(smoke.check_flash(TRAIN_SEQ, bf16, **heads))
        bwd.append(smoke.check_flash_bwd(TRAIN_SEQ, bf16, bf16, **heads))
        decode.append(smoke.check_decode(
            4, hkv=cfg.n_kv, g=cfg.n_heads // cfg.n_kv, d=cfg.head_dim,
            arch=arch))
    smoke.record({"phase": "variant_kernels", "seconds": time.time() - t0})
    smoke.check_moe_model()
    smoke.run_serve_variants()
    smoke.run_train_variants()
    # head_dim 160 at stablelm-12b's heads (32 / 8, G = 4): the forward and
    # the backward (bf16, the tensor-core designs) at the train shape and
    # ragged, the FMA designs (f32, and bf16 residuals) at S = 1024, the
    # decode kernel's two entry points; then the two new archs
    t0 = time.time()
    h160 = dict(h=32, hkv=8, d=160, arch=HEAD160)
    flash160 = [smoke.check_flash(TRAIN_SEQ, bf16, **h160),
                smoke.check_flash(100, bf16, **h160)]
    flash160_fma = [smoke.check_flash(1024, f32, **h160),
                    smoke.check_flash(300, f32, window=100, **h160)]
    bwd160 = [smoke.check_flash_bwd(TRAIN_SEQ, bf16, bf16, **h160),
              smoke.check_flash_bwd(1000, bf16, bf16, kv_len=777, **h160),
              smoke.check_flash_bwd(1024, f32, f32, **h160),
              smoke.check_flash_bwd(1024, bf16, f32, **h160)]
    decode160 = [smoke.check_decode(sp, hkv=8, g=4, d=160, arch=HEAD160)
                 for sp in (4, 1)]
    dbias160 = [smoke.check_decode_band(sp, bias=True, hkv=8, g=4, d=160,
                                        arch=HEAD160) for sp in (4, 1)]
    smoke.record({"phase": "head160_kernels", "seconds": time.time() - t0})
    smoke.check_model_vs_cpu(HEAD160)
    smoke.check_model_vs_cpu(MLA_ARCH)
    smoke.run_serve_mla()
    # whisper-base (8 / 8 heads of 64: G = 1) and qwen2-vl-2b (12 / 2 of
    # 128: G = 6): the kernels at their shapes, the two models card
    # against CPU, whisper's lockstep, qwen2-vl in the engine, both trained
    # at full depth
    t0 = time.time()
    wh = dict(b=WHISPER_BATCH, h=8, hkv=8, d=64, arch=WHISPER)
    flash_ed = [smoke.check_flash(WHISPER_CTX, bf16, **wh)]
    bwd.append(smoke.check_flash_bwd(WHISPER_CTX, bf16, bf16, **wh))
    lengths = [1, 512, 300, 64, 257, 448, 2, 511, 100, 33, 65, 128, 255,
               384, 7, 480]
    decode += [smoke.check_decode(sp, b=WHISPER_BATCH, s=512,
                                  lengths_list=lengths, hkv=8, g=1, d=64,
                                  arch=WHISPER) for sp in (1, 4)]
    decode += [smoke.check_decode(sp, hkv=2, g=6, d=128, arch=QWEN)
               for sp in (4, 1)]
    smoke.record({"phase": "encdec_vlm_kernels", "seconds": time.time() - t0})
    smoke.check_model_vs_cpu(WHISPER)
    smoke.check_model_vs_cpu(QWEN)
    smoke.run_serve_encdec()
    smoke._serve_variant(QWEN)
    for arch, layers, batch, seq in (
            (QWEN, QWEN_TRAIN_LAYERS, 1, TRAIN_SEQ),
            (WHISPER, configs.get_config(WHISPER).n_layers, WHISPER_BATCH,
             WHISPER_CTX)):
        cfg = configs.get_config(arch)
        smoke._train_variant(arch, layers, batch, seq,
                             smoke._train_extras(cfg, batch, seq))
    smoke.sync()

    def summary_row(name, rows, main, route_src, tpu, launches=None):
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": tpu,
                "launches": (launches or smoke.serve_launches)[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"]}

    def bwd_row(part, grads, design="fma"):
        """delta (every line) and the dQ / dKV of one design (the lines
        routed to it); times from the train shape's line of that design:
        bf16 for sm90, bf16 residuals under f32 compute for fma."""
        rows = [r for r in bwd if part == "delta" or r["route"] == design]
        main = next(r for r in rows if r["shape"]["S"] == TRAIN_SEQ)
        name = f"flash_bwd_{part}" + ("_sm90" if design == "sm90" else "")
        return {"name": name, "route": "cuda",
                "source": BWD_SM90_SRC if design == "sm90" else BWD_SRC,
                "replaces": BWD_TPU[part],
                "launches": smoke.train_launches[name],
                "max_abs_err": max(r["max_abs_err"][g] for r in rows
                                   for g in grads),
                "ms": main["kernel_ms"][part],
                "plain_ms": main["plain_ms"][part],
                "bound_ms": main["bound_ms"][part],
                "bound_by": main["bound_by"][part],
                # the whole backward (dq, dk, dv) in one library call, at
                # the train shape in bf16 (SDPA takes one dtype)
                "library_ms": None if part == "delta"
                else bwd[0]["library_ms"]}

    def pack_row(part):
        i = 0 if part == "decode" else 1
        rows = [lines[i] for lines in pack]
        main = pack[-1][i]                  # the memory shape, default
        return {"name": f"pack_{part}", "route": "cuda", "source": PACK_SRC,
                "replaces": PACK_TPU[part],
                "launches": smoke.cifar_launches[f"pack_{part}"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None}

    def row160(name, rows, src, tpu, part=None):
        """A kernel at head_dim 160: its time at the first line's shape,
        its launches on stablelm-12b's main path (the FMA designs': in
        head160_model, policy full; the others': in train_variants'
        5 timed steps, the decode's in serve_variants)."""
        main = rows[0]
        pick = (lambda r, k: r[k]) if part is None else \
            (lambda r, k: r[k][part])
        fma = name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        runs = smoke.variant_launches.get(HEAD160, {})
        launches = (smoke.head160_model_launches if fma else
                    runs.get("serve" if "decode" in name else "train", {})
                    ).get(name, 0)
        errs = [r["max_abs_err"] if part is None else
                max(r["max_abs_err"][g] for g in
                    (("dk", "dv") if part == "dkv" else (part,)))
                for r in rows]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "head_dim": 160, "arch": HEAD160,
                "launches": launches, "max_abs_err": max(errs),
                "ms": pick(main, "kernel_ms"),
                "plain_ms": pick(main, "plain_ms"),
                "bound_ms": pick(main, "bound_ms"),
                "bound_by": pick(main, "bound_by"),
                "library_ms": None if part == "delta"
                else main["library_ms"]}

    def ssm_row(name, rows, route_src, tpu, launches=None):
        main = rows[0]                      # the serve / train shape
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": tpu,
                "launches": (launches or smoke.ssm_launches)[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None}

    kernels = {"kernels": [
        # launches in the 5 timed train steps, time at the train shape; the
        # fleet phase's launches beside (its sub-phases (a)-(d) and (f))
        dict(summary_row("flash_fwd_sm90",
                         flash + flash_ssm + flash_var + flash_ed,
                         flash[-1], FLASH_SM90_SRC, FLASH_TPU,
                         smoke.train_launches),
             fleet_launches=smoke.fleet_launches["flash_fwd_sm90"]),
        # no main path of this run takes the f32 forward: 0 launches
        summary_row("flash_fwd", flash_fma, flash_fma[-1], FLASH_SRC,
                    FLASH_TPU),
        dict(summary_row("flash_decode", decode, decode[1], DECODE_SRC,
                         DECODE_TPU),
             fleet_launches=smoke.fleet_launches["flash_decode"]),
        bwd_row("delta", ("delta",)), bwd_row("dq", ("dq",)),
        bwd_row("dkv", ("dk", "dv")),
        bwd_row("dq", ("dq",), "sm90"), bwd_row("dkv", ("dk", "dv"), "sm90"),
        pack_row("decode"), pack_row("encode"),
        ssm_row("ssd_chunk_sm90", ssd, SSD_SM90_SRC, SSD_TPU),
        # no main path of this run takes head_p 16: 0 launches
        ssm_row("ssd_chunk", ssd_fma, SSD_SRC, SSD_TPU),
        ssm_row("flash_decode_bias", dbias, DECODE_SRC, DECODE_TPU),
        # no TPU kernel: the JAX package differentiates ssd_chunk_ref;
        # launches in train_ssm's 5 timed steps of both archs, time at
        # mamba2's train shape (the FMA route's at head_p 16: 0 launches)
        ssm_row("ssd_chunk_bwd_sm90", ssd_bwd, SSD_BWD_SM90_SRC, SSD_REF_JAX,
                smoke.train_ssm_launches),
        ssm_row("ssd_chunk_bwd", ssd_bwd_fma, SSD_BWD_SRC, SSD_REF_JAX,
                smoke.train_ssm_launches),
        # head_dim 160 (stablelm-12b), each design at its own instantiation
        row160("flash_fwd_sm90", flash160, FLASH_SM90_SRC, FLASH_TPU),
        row160("flash_fwd", flash160_fma, FLASH_SRC, FLASH_TPU),
        row160("flash_bwd_delta", bwd160, BWD_SRC, BWD_TPU["delta"],
               "delta"),
        row160("flash_bwd_dq_sm90", bwd160[:2], BWD_SM90_SRC, BWD_TPU["dq"],
               "dq"),
        row160("flash_bwd_dkv_sm90", bwd160[:2], BWD_SM90_SRC,
               BWD_TPU["dkv"], "dkv"),
        row160("flash_bwd_dq", bwd160[2:], BWD_SRC, BWD_TPU["dq"], "dq"),
        row160("flash_bwd_dkv", bwd160[2:], BWD_SRC, BWD_TPU["dkv"], "dkv"),
        row160("flash_decode", decode160, DECODE_SRC, DECODE_TPU),
        row160("flash_decode_bias", dbias160, DECODE_SRC, DECODE_TPU)]}
    # the launches of train_ssm's 5 timed steps (both archs) beside, and
    # those of serve_variants and train_variants' 5 timed steps, by arch
    for row in kernels["kernels"]:
        row.setdefault("train_ssm_launches",
                       smoke.train_ssm_launches.get(row["name"], 0))
        row["serve_encdec_launches"] = smoke.encdec_launches.get(
            row["name"], 0)
        # train_dp: (a) the train cell on a (1, 1) mesh, NCCL; (b) each of
        # the two smoke-width ranks
        row["train_dp_launches"] = {
            part: counts.get(row["name"], 0)
            for part, counts in smoke.train_dp_launches.items()}
        # train_tp: rank 0's launches in the timed steps of (a)-(c) (every
        # rank's are in its line)
        row["train_tp_launches"] = {
            part: counts.get(row["name"], 0)
            for part, counts in smoke.train_tp_launches.items()}
        # moe_tp: rank 0's launches in (a)'s and (b)'s steps, (c)'s engine
        # run and (d)'s teacher-forced steps
        row["moe_tp_launches"] = {
            part: counts.get(row["name"], 0)
            for part, counts in smoke.moe_tp_launches.items()}
        # ssm_tp: rank 0's launches in (a)-(c)'s steps, (d)'s
        # teacher-forced runs and (e)'s lockstep
        row["ssm_tp_launches"] = {
            part: counts.get(row["name"], 0)
            for part, counts in smoke.ssm_tp_launches.items()}
        for part in ("serve", "train"):
            row[f"{part}_variants_launches"] = {
                arch: runs[part].get(row["name"], 0)
                for arch, runs in smoke.variant_launches.items()
                if part in runs}
        # serve_tp: rank 0's launches in (b)'s teacher-forced steps and in
        # (c)'s and (d)'s engine runs (every rank's are in its line)
        row["serve_tp_launches"] = {
            part: counts.get(row["name"], 0)
            for part, counts in smoke.tp_launches.items()}
    # the decode kernel's partials form (serve_tp (a)): shard 0's call at
    # llama3-8b's and glm4-9b's decode shapes, the bias entry at hymba's
    for row in kernels["kernels"]:
        if row.get("head_dim") is None and row["name"] in (
                "flash_decode", "flash_decode_bias"):
            row["partials"] = [
                {k: r[k] for k in ("arch", "shape", "kernel_ms", "plain_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "err_vs_unsharded")}
                for r in smoke.tp_partials
                if (r["name"] == "flash_decode_bias_partials")
                == (row["name"] == "flash_decode_bias")]
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": {"name": name, "smi": smi},
                                   "records": smoke.records, **kernels},
                                  indent=1))
    if smoke.failures:
        raise SystemExit("chip_smoke: failed checks:\n"
                         + "\n".join(smoke.failures))
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
