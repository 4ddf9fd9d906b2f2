#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the six CUDA kernels from ``src/repro_torch/kernels/csrc``, and
   the event scatter with each of its regimes forced, in parallel;
3. full width, the main path: the paper's per-area size and in-degree
   (``mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000,
   k_inter=3000)``, build seed 12; 4 areas instead of 32 so the tables fit
   one card), built on the device with its incoming tables (28 GB) and the
   outgoing tables the event backend reads (``add_outgoing_tables``, the
   inversion of ``build_network(outgoing=True)``, timed on its own line; ~31
   GB), every outgoing row checked to ascend with its -1 padding at the end
   (the event kernel's precondition; in row chunks). Then
   ``make_simulation`` on the ``pallas`` backend, 1 + 5 windows each:
   ignore-and-fire (2.5 Hz) under the conventional schedule, the
   structure-aware one and the structure-aware one with the fused superstep
   kernel (``superstep_kernel=True``), bitwise equal to each other window by
   window; LIF under the structure-aware schedule, unfused and fused,
   bitwise equal window by window, from the state after 18 untimed
   windows, when the areas have begun to spike (``LIF_RAMP_WINDOWS``).
   Launches per window are asserted exactly; the kernels' launch counts are
   reset just before and read just after, and every kernel of the path must
   have launched. Each run's window is then profiled (torch.profiler): the
   six longest kernels and every port kernel that ran, with device time and
   count;
4. ``[event]`` the same configurations on the ``event`` backend (the
   ``event_deliver`` kernel), on the same network, 1 + 5 windows each, every
   one bitwise the matching ``pallas`` run's spike blocks and rings window by
   window with ``overflow == 0``: ignore-and-fire conventional,
   structure-aware, legacy (``superstep=False``), fused, adaptive, and
   adaptive + overlap through ``run_windows`` (one drain); LIF unfused with
   ``fused_update=True`` and fused. Launches per window asserted exactly
   (counts reset just before the event runs, read just after), ms/window
   beside the ``pallas`` run's, the peak memory, and the profile of one
   window of the unfused and the fused iaf event runs;
   ``[steady]`` LIF at its steady state (~70 Hz, from window 40): the
   fused pallas run and the adaptive event runs, unfused and fused, bitwise
   the unfused pallas run window by window with ``overflow == 0``, launches
   per window asserted, ms/window; one window of each adaptive event run
   profiled, with ``event_deliver``'s share of the device's busy time; and
   the spikes the static event packets drop in one window at this rate;
5. ``[kernel]`` event_deliver against its plain version, bitwise, on the
   packets the engine makes from the iaf runs' last window (2.5 Hz, static
   packets) and from the steady LIF runs' last window (~70 Hz, the adaptive
   ladders' rungs), inter and the busiest cycle's intra, and on both
   windows' inter packets with every padding case; timed beside its bound
   (the tables' bytes and 64 B per distinct ring sector touched), the
   ceiling of one reduction a synapse at the L2's RED rate (measured here
   by ``red_probe``), the earlier bound (32 B of ring a synapse), the plain
   version (3 windows at the steady size) and the gather + ``index_add_``
   of the same adds; then both of the kernel's regimes (builds that force
   each) beside its own choice, bitwise and timed, on packets thinned to
   0.5-15 adds per ring sector;
6. ``[resilience]`` the resilient run loop on the same network: LIF at its
   steady state (window 40, ~70 Hz) on ``event`` with adaptive packets and
   the ``lif_update`` kernel, and ignore-and-fire on ``pallas``, fused and
   overlapped, each 6 windows through ``run_windows`` uninterrupted, then
   again with a checkpoint every 2 windows, one transient write failure and
   a preemption after 4 windows, resumed by ``restore_sim`` for the last 2:
   spike blocks, rings, neuron leaves and ``spike_count`` bitwise the
   uninterrupted run's with ``overflow == 0``; launches counted (reset just
   before, read just after), drains and retries asserted; the checkpoint's
   bytes, the save split into the device-to-host copy and the write, and
   the restore time, beside the card's name and power limit (in a temporary
   directory, removed after); and the uninterrupted run's per-window times
   (``run_windows``: a device synchronize every window, the first window a
   fresh engine's) beside ``Engine.run``'s ms/window over the same 6
   windows, alternated twice; then the outgoing tables are freed;
7. each pallas-path kernel against its plain PyTorch version on the card,
   bitwise, at the main path's shapes (superstep_iaf also at the main path's
   2.5 Hz), and timed beside its memory bound: median of 100 windows for
   lif_update, 20 for spike_deliver and event_deliver (10 for the library
   call at the steady size), 10 for the superstep kernels, each window an
   L2 flush, a start event, the call and an end
   event. The windows are enqueued in batches behind a device spin that
   outlasts the host's enqueue of the batch, so the device never waits for
   the host inside a window; an event after the spin checks that, and the
   timer raises if it cannot hold (``time_ms``). Plain versions whose
   enqueue blocks on the launch queue are timed host-paced, with a
   ``[timer]`` line. lif_update is also timed host-paced, the timer of
   earlier runs, and its per-launch device time in the profiled LIF window
   is printed;
8. ``[cli]`` with the network freed, ``python -m
   repro_torch.launch.simulate`` as subprocesses at the paper's per-area size
   and in-degree (``--model mam_benchmark --areas 4 --n-per-area 130000 --k
   6000 --seed 12``), each line of their reports echoed: (a) ``--backend
   pallas --neuron lif --compare --profile --t-ms 25`` (conventional ==
   structure-aware, and the phase table at full width), (b) ``--backend
   event --neuron lif --compare --compare-adaptive --compare-overlap --t-ms
   25 --spikes-out A.npz``, (c) ``--backend event --neuron lif --adaptive
   --overlap --t-ms 25 --checkpoint-dir D --inject-fault preempt:window=15``
   (exit 0 and the PREEMPTED line) and (d) the same without the fault,
   ``--resume --spikes-out C.npz``: every exit 0, ``C.npz`` bitwise
   ``A.npz`` (whose last leg is structure-aware, adaptive and overlapped),
   LIF spiking on both sides of the preemption (it first spikes in window
   11 at this size; the checkpoint's spike count lies strictly between 0
   and the final one), so a ring lost or changed at the checkpoint shows;
   each run's kernel launches (the subprocess prints its counts after the
   CLI returns) nonzero for the kernels of its path, and the resilient
   legs' per-window times from ``run_windows`` (the first window a cold
   process's); then (e) the launcher on a process group, ``python -m
   torch.distributed.run --standalone --nproc-per-node 4`` (four gloo ranks
   on the card, mesh (4, 1)), routed ``event`` at 4 x 130,000, K 600,
   ``--t-ms 10 --profile`` (its wire-volume table echoed, its wire as
   ``comm`` counts it == the static accounting), and (f) the same command
   on one process: both exit 0, their ``--spikes-out`` files bitwise
   equal;
8a. ``[dist]`` the distributed engine (``make_simulation(..., mesh=...)``)
   as four ranks of one gloo world sharing the card (``ProcessMesh((2, 2),
   ("data", "model"))``: 2 area groups x 2 lanes), spawned as processes of
   this script (``--dist-rank``), every rank held to the single host
   window by window (whole blocks gathered, bitwise) with ``overflow ==
   0``: (a) the main path's spec (4 x 130,000, K 3000/3000), the
   host-free sharded build (rank 0 plans and broadcasts, every rank draws
   its own tables), ``event``, structure-aware: iaf over the main path's
   6 windows and LIF over its 24 (adaptive, overlapped, ``fused_update``);
   (b) K 300/300, every rank building the global network and cutting it:
   iaf on ``pallas`` and ``event`` under both schedules, against a
   single-host pallas run made here first. Per rank, beside the card's
   name and power limit: build seconds, GB allocated and peak, ms/window,
   kernel launches per window (asserted), the bytes the exchange's
   collectives took in per window, summed over the ranks (``comm.received``;
   == ``dense_wire_bytes`` and the engine's ``shipped_bytes`` on static
   packets), collective calls per window,
   and one profiled window: the time inside the gloo collectives and the
   part of it spent waiting for the other ranks. Kernels 1, 2 and 6 are
   held to their plain versions at a rank's shard shapes. (c) The routed
   exchange at (a)'s width (host-free build, ``event``): iaf through
   ``run_windows`` with a ``SimCheckpointer``, preempted after window 3,
   ``restore_sim`` on the same mesh and 3 more windows (the bytes on the
   wire == ``routed_wire_bytes`` x 6; the checkpoint's bytes, save and restore
   seconds), LIF adaptive and overlapped over (a)'s 24 windows. (d) A ring
   of areas at K 300 on a second mesh, ``(4, 1)``: iaf on ``pallas`` and
   ``event``, dense and routed (1 routed wire round against 3 dense), and
   a routed ``event`` run checkpointed on ``(2, 2)`` at window 3 and
   resumed on ``(4, 1)`` (an elastic reshard from 2 groups to 4), against
   a single-host run made here first. Kernel 6 is held to its plain version
   on a routed window's concatenated round packets at (c)'s shape, kernel 2
   on (d)'s pallas local pathway, and the routed runs' launches join the
   ``kernels`` line (``routed_launches``). Four ranks on one card are no
   scaling measurement: they share its SMs, and gloo's wire goes through
   host memory;
8b. ``[serve]`` the folded trial server (``repro_torch.launch.serve``) at
   the 32-area MAM (``mam_spec(scale=0.1)``: 418,340 neurons, ``n_pad``
   19,890, K 420/180) in the serve CLI's ``--selftest`` regime (``v_th`` 2.0
   mV, packet floor ``n_pad``), 8 trials of 1-8 windows drawn from
   ``default_rng(0)``: (a) the event fold's B, the largest of 8, 6, 4 whose
   reckoned peak (B + 1 copies of one copy's tables, two folded rings) is
   at most 70 GB, beside ``max_memory_allocated``; (b) the event server,
   every trial bitwise its sequential reference run alone through
   ``make_simulation`` on the card, overflow 0, spikes in every trial,
   ``event_deliver`` launched (counts reset just before serving, read just
   after), trials/s, p50 / p99, the folded window's ms against the single
   trial's, ``on_block``'s host time a window; (d) the same trials at
   ``max_batch=1``, bitwise the fold's; (c) the ``pallas`` server at B = 8,
   every trial bitwise the event server's, ``lif_update`` and
   ``spike_deliver`` launched, and one ``spike_deliver`` inter launch at
   the fold's shape (~5.1M sources: its bitmask lies past shared memory)
   bitwise its plain version and timed beside its bound; (e) 4-copy servers
   at ``tests/test_serve.py``'s size on the card == on the CPU, both routes;
   (f) ``python -m repro_torch.launch.serve --selftest --scale 0.1 --batch
   B`` as a subprocess, exit 0 and its ``selftest OK`` line;
8c. ``[mam]`` the paper's workload driver (``repro_torch.mam_simulation``):
   (a) ``python -m repro_torch.mam_simulation --scale 0.002 --t-ms 300``
   as a subprocess on the card, exit 0, its report lines echoed and its
   per-area spike counts bitwise those of the same function run on the CPU
   here meanwhile; (b) the 32-area MAM at ``mam_spec(scale=0.2)`` (836,680
   neurons, K 840/360, 1.53 G incoming synapse slots), built once on the
   card with its outgoing tables (build seconds, incoming and outgoing GB,
   peak), then 50 ms of model time (1 untimed + 49 timed
   windows; 10 ms on ``scatter``, held bitwise against ``pallas`` run as
   far), LIF structure-aware, on five routes: ``scatter`` (the
   driver's own), ``pallas`` unfused with ``fused_update`` (kernels
   ``lif_update`` and ``spike_deliver``), ``pallas`` with
   ``superstep_kernel=True`` (``superstep_lif``, ``spike_deliver``),
   ``event`` with adaptive packets (``event_deliver``) and ``pallas`` under
   the conventional schedule: every route's per-area spike counts, final
   ring and neuron state bitwise the others' with ``overflow == 0``, every
   kernel of a route launched (counts reset just before each run, read just
   after; the ``kernels`` line's ``mam_launches``), ms/window and RTF per
   route, the network mean rate and the top 8 areas as the driver prints
   them, and one profiled window of ``pallas`` and of ``event``;
8d. ``[dryrun]`` the dry-run tooling: (a) ``python -m
   repro_torch.launch.dryrun --arch mam-snn --snn-schedule
   conventional,structure_aware --mesh both --build-rss --hbm-gib 0`` on
   the card (the production MAM priced on 16 x 16 and 2 x 16 x 16 ranks
   from meta-device shapes: a rank's tables and state, and one window run
   on meta tensors for its transient; the default onehot cells recorded,
   the build peaks measured with ``torch.cuda.max_memory_allocated``),
   and meanwhile the structure-aware ``event`` cells priced in the script's
   own process with the HBM gate at the card's memory on the peak: exit 0
   and every row OK; (b) the
   width bounds of ``network_sds`` held against the tables instantiated on
   the card at [dist] (a)'s spec and cut (4 x 130,000, K 3000/3000, 2 groups
   x 2 lanes: ``shard_inter_tables(mode='group', subgroup=2)`` and
   ``slice_intra_tables``): equal lead axes and delay dtypes, bound widths
   at least the instantiated ones, and the slack; (c)
   ``construction_cost_model``'s bytes for that cut beside the peak of one
   rank's sharded build on the card (a reading, not a gate); (d) ``python
   -m repro_torch.launch.dryrun --arch qwen2-0.5b,grok-1-314b --shape all
   --mesh both --hierarchical`` (the LM cells, meta tensors on the host's
   CPU), started here in the background and read at the end of the run:
   exit 0, every row OK or SKIP, per row the bytes a rank holds and
   gathers, the roofline terms and, hierarchical, the sync step's bytes
   against the sync trainer's per step; a ``[time]`` line of the wait;
   (e) a priced call held to the card, folded into legs that run anyway:
   one window of each [dist] (a) run on each rank, each step of the
   [train] (j) legs and the [lm-mesh] prefill and first decode on each
   rank, ``torch.cuda.max_memory_allocated()`` during the call less the
   bytes allocated before it beside the dry run's transient of the same
   rank's call on a ``MeshLayout`` of the same extents; the price may be
   under the measurement by at most the larger of 10% and 128 MiB; the
   last step of a (j) leg of more than one step runs under the live-bytes
   tracker on cuda, whose count is logged beside its rise;
9. the port on the card against the port on the CPU at the quickstart size
   (4 x 256 neurons, K 32/32), bitwise over 10 windows (40 for LIF, which
   first spikes in window 18 at this size), ``overflow`` included:
   ignore-and-fire (30 Hz) and LIF on ``pallas`` (both schedules and
   fused) and on ``event`` (both schedules, legacy, fused, adaptive,
   adaptive + overlap), and ignore-and-fire at 2000 Hz with forced overflow
   (``s_max_headroom=0, s_max_floor=1``);

then, with the simulator's tables freed, the LM path (weights drawn on the
card from seed 0, f32 products in f32):

10. ``[lm]`` qwen2-0.5b at its published width and dtypes (bf16), B 2 x S
   4096 with ``use_pallas_attention=True``: 1 warm-up + 3 timed forwards,
   exactly 24 ``flash_attention`` launches each (counts reset just before,
   read just after), finite logits, and the profile of one forward;
11. ``[lm]`` the same model in f32: the kernel against the streaming path
   (<= 1e-4 of the largest logit), and prefill of 4096 tokens + decode of
   token 4096 against the forward of the 5120-token sequence (<= 5e-4);
12. ``[lm]`` serving at the published dtypes through
   ``repro_torch.serve_lm.serve``: batch 4, 4096-token prompts, 32 tokens
   (prefill attends with a cache, so no kernel launch);
13. ``[lm]`` h2o-danube-1.8b, bf16, B 1 x S 8192 (its 4096 window cuts in):
   24 launches per forward; in f32, kernel against streaming (<= 1e-4);
14. ``[kernel]`` flash_attention against its plain version at qwen2's and
    danube's shapes and with k_len < S (f32: max abs <= 2e-5; bf16: one bf16
    ulp of the plain output's largest magnitude, and per element one bf16 ulp
    of the larger of the two values + 2e-5, the card tests' bar, which
    ``scaled_dot_product_attention`` must fail at qwen2's shape: it rounds P
    to bf16), timed (as in 7, median of 20) beside its bound, the plain
    version and SDPA (the library time, and its own error);
    the bf16 route runs on the tensor cores, the f32 route (timed at qwen2's
    shape beside its bound at the f32 CUDA-core peak and SDPA on the same
    f32 inputs, TF32 off) on the CUDA cores; the tensor-core kernel's wgmma and TMA
    instructions counted in its SASS (none fails the run), its registers,
    spills and shared memory from the build report;
15. ``[cpu]`` reduced qwen2-0.5b in f32 on the card against the CPU, with
    ``FLASH_THRESHOLD`` lowered so the forward runs the kernel: the forward
    (<= 1e-4) and prefill + 4 decode steps (<= 5e-4);
16. ``[train]`` LM training, no kernel launch on its path (the streaming
    attention under autograd; ``flash_attention`` refuses grad): (a) the
    sync trainer (``make_train_artifacts``) on qwen2-0.5b as published
    (bf16 parameters, f32 moments, remat "dots"), B 8 x S 4096 in 4
    microbatches, the same batch: 1 warm-up + 2 timed steps, finite losses
    and grad norms, the loss falling, ms/step, tokens/s, the peak memory and
    the profile of a one-microbatch step; (b) the hierarchical trainer, 2 pods, int8
    every 2 steps, 2 x 4096 a pod, 2 steps: replicas differ before the
    sync and are equal after it, residuals nonzero; ms per local step and
    sync, the int8 payload's bytes; (c) ``python -m
    repro_torch.launch.train`` at that config but S 2048 (B 2, 3 steps,
    checkpoints at 2 and 3), then its step-2 checkpoint ``--resume``d to 3
    by a second run: the resumed loss prints as the uninterrupted run's and
    its step-3 checkpoint is bitwise the uninterrupted one (the CLI runs
    deterministic algorithms); the step-2 state restored on the card is
    bitwise the saved one; bytes, restore and save seconds; (d) reduced
    qwen2-0.5b and olmo-1b in f32, the sync and the hierarchical trainer,
    card == CPU (losses and grad norms <= 1e-4 relative, parameters
    within 2 x lr x steps and 99% within 1e-5 of the largest, plus an int8
    grid step after the sync); (e) olmo-1b (16 layers) and gemma3-27b (6 of its 62
    layers, one 5:1 period) at full width: bf16 with the kernel, B 1 x S
    4096, ``n_layers`` launches a forward and ms/forward; in f32 the kernel
    against the streaming path (<= 1e-4); (f) mamba2-2.7b (64 layers),
    zamba2-1.2b (38), whisper-medium (24 + 24; decoder 448 tokens on 1500
    frames) as published, internvl2-76b at 4 of its 80 backbone layers and
    grok-1 at 1 of its 64 (the card's memory: 8 B a parameter with bf16
    moments), bf16, remat and moment dtype as published, B 1 x S 4096: 1 +
    2 AdamW steps on one repeated batch, the second loss below the first,
    finite losses and grad norms, no kernel launch, ms/step, tokens/s and
    peak GB; a line on why llama4-maverick's full-width step does not fit
    the card; (g) the six reduced configs in f32, card == CPU (the loss
    within 1e-5 relative, every gradient within 1e-4 of its leaf's largest,
    floor 1e-8), no MoE routing flip, and on the card ``remat`` as
    published against ``"none"`` bitwise (deterministic algorithms); (h)
    the CLI's crash-resume on reduced mamba2 (4 steps checkpointed every 2,
    the step-2 checkpoint resumed to 4): the same losses, the step-4
    checkpoint bitwise, its layer leaves stacked as in the JAX CLI; (i)
    ``train.pipeline.pipeline_apply`` on four gloo ranks sharing the card
    (``--pipe-rank``): qwen2-0.5b as published, 4 stages of 6 layers, each
    rank holding its stage alone, 4 microbatches of B 1 x S 4096, under
    grad with each layer a checkpoint as ``remat`` asks, and the GPipe
    backward of one f32 loss (the outputs' inner product with a seeded
    tensor): every rank's outputs bitwise the 24 layers run in sequence
    here, its stage's gradients and the microbatches' (on every rank)
    within 1e-4 of each leaf's largest of the one-device gradient; (j) the
    trainers on a process mesh, four gloo ranks of this script sharing the
    card (``--mesh-rank``), one world and a process mesh for each shape,
    the state held as each rank's shards: the hierarchical int8 trainer on
    (pod, data, model) = (2, 2, 1), qwen2-0.5b at its published width cut
    to 4 of 24 layers, B 1 x S 2048 a rank (2 local steps, a sync, 1
    more), every rank's losses and gathered parameters, moments, counts,
    anchor and residuals bitwise the one-device trainer's at ``n_micro``
    2, run here first, the int8 bytes over ``pod`` equal to the
    accounting; then the sync trainer's compute split over ``model``
    (``MESH_SPLIT``: Megatron products, head- or context-parallel
    attention, the vocab-parallel cross entropy, experts where they are
    stored): the same qwen2-0.5b on (data, model) = (2, 2), head-parallel,
    and on (1, 4), context-parallel, in f32 over its bf16 weights, 2 steps;
    reduced llama4-maverick in f32 on (2, 2), its experts over ``model``;
    zamba2-1.2b at its published widths, 7 of 38 layers (one application of
    the shared block over 6 mamba layers and a tail layer), in f32 over f32
    weights on (2, 2), one step (its first-step gradients held too, each
    leaf within 1e-4 of its largest), its mamba layers' in_proj and conv
    computed on the stored column blocks and gathered, each rank stepping
    its own SSM heads; grok-1 at its
    published widths (1 of 64 layers, bf16), B 1 x S 4096 on (1, 4), each
    expert's d_ff over ``model``, one step. Each against its one-device
    trainer run here first (llama4's on the host): losses and grad norms
    within 1e-4 relative, the parameters within ``tests/test_torch_train.py``'s
    bars, the moments too (grok, in bf16, at 4096 sampled elements a leaf:
    its scalars within one bf16 rounding, every parameter within 2 lr and
    one bf16 rounding, the 99% share and the moments read),
    the leaves replicated over ``model`` bitwise alike on the model ranks,
    every step's bytes in per collective and call equal to the dry run's
    price, and so are every step's gathered peak (FSDP one unit at a time:
    ``comm.gathered``) and the gradient accumulator's bytes (the rank's
    shards); no kernel launch; per rank the state bytes against one
    replica's, what a step computes on and holds gathered at most, the
    accumulator, peak GB beside PR 31's (and the steps' own, and the
    weights' draw), ms per step and sync, bytes in per collective;
    then ``[lm-mesh]``: the same ranks serve (``make_serve_artifacts`` on
    a mesh) in f32 over bf16 weights with a bf16 cache (mamba2's f32),
    every family computing only its share over ``model`` (no parameter
    gathered over it): qwen2-0.5b at 4 of 24 layers, a cache of 32768, on
    (data, model) = (2, 2) (B 4, a 4096-token prompt, the KV heads over
    ``model``) and (1, 4) (B 1, a 12288-token prompt across the
    8192-position shards, the sequence over ``model``), and grok-1 at its
    published widths, 1 of 64 layers, on (1, 4) (B 2, a 4096-token prompt,
    a cache of 8192, its 8 KV heads and its experts' d_ff over ``model``);
    whisper-medium at 2 + 4 of 24 + 24 layers on (2, 2) (B 4, a 256-token
    prompt, a cache of 448, its 16 heads over ``model`` in every attention);
    and mamba2-2.7b at 4 of 64 layers on (1, 4) (B 2, a 4096-token prompt,
    its 80 SSM heads over ``model``, in_proj and the conv computed on each
    rank's stored column block and gathered); 8 decode steps each, against the
    one-device serving of each rank's batch slice run here first: the
    prefill within 1e-4 and every decode step within 5e-4 of the largest
    logit, on the rows whose expert choices agree (a routing flip printed,
    failing above a 1e-5 gate margin, and a call with no row left
    failing); per rank the bytes
    held against one replica's, the parameter bytes a call computes on,
    gathers and holds gathered at most, peak GB beside PR 31's, ms a
    prefill and a decode step, and the bytes in per collective and call,
    the bytes in and the gathered peak each equal to the dry run's price
    (``price_lm`` on a ``MeshLayout``, run here while the ranks serve); no
    kernel launch;
17. ``[families]`` the six other LM families at their published widths and
   dtypes (bf16), weights drawn on the card from seed 0, each freed before
   the next: llama4-maverick at 2 of its 48 layers (a dense and a
   128-expert MoE sub-layer), grok-1 at 4 of 64, internvl2-76b at 8 of its
   80 backbone layers (256 patches of 1024), mamba2-2.7b (64 layers),
   zamba2-1.2b (38) and whisper-medium (24 + 24, 1500 frames) at their
   published depths: (a) a forward at B 1 x S 4096, with
   ``use_pallas_attention=True`` for the three transformer families, 1
   warm-up + 2 timed, exactly 2 / 4 / 8 ``flash_attention`` launches a
   forward (0 for the others; counts reset just before each architecture,
   read just after its (b)), finite logits, ms, tok/s and peak GB, and the
   MoE configs' dispatch / expert-product / combine times over one forward
   (CUDA events around each stage of ``models.moe``; llama4's forward also
   profiled); (b) ``serve_lm.serve`` at B 2, a 4096-token prompt (whisper
   448; zamba2 4088, so its cache is 4096 positions), 8 tokens: prefill ms
   and ms a decode step, after a warm-up; (c) internvl in f32 at 2
   backbone layers: the kernel against the streaming path (<= 1e-4); (d)
   the six reduced configs in f32, card == CPU with ``FLASH_THRESHOLD``
   lowered to 16 (the transformer families launch the kernel): the forward
   (<= 1e-4) and prefill + 4 decode steps (<= 5e-4), the MoE outputs held
   on the sequences whose expert choices agree, every flip logged with its
   gate margin and failing above 1e-5.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2
SIM_KERNELS = ("lif_update", "spike_deliver", "superstep_lif", "superstep_iaf",
               "event_deliver")
PALLAS_PATH_KERNELS = SIM_KERNELS[:4]
EVENT_PATH_KERNELS = ("lif_update", "superstep_lif", "superstep_iaf", "event_deliver")
# LIF at full width (seed 12) first spikes in window 11, ramps up and
# outgrows the static event packets (276 ids an area, 1,104 a cycle) in
# window 25, and fires ~36,000 spikes a window (~70 Hz) from window ~30 on
# (the untimed windows' lines of this script show it). Its main-path runs
# start after LIF_RAMP_WINDOWS windows, so that their 1 + 5 windows carry
# spikes within the packets; the steady-state runs after LIF_STEADY_WINDOWS.
LIF_RAMP_WINDOWS = 18
LIF_STEADY_WINDOWS = 40
INCOMING = ("src_intra", "w_intra", "delay_intra", "src_inter", "w_inter", "delay_inter")
OUTGOING = ("tgt_intra", "wout_intra", "dout_intra", "tgt_inter", "wout_inter", "dout_inter")
# The port's kernel functions (csrc/*.cu), as the profiler names them: every
# one that ran in a profiled window gets a [profile] line.
PORT_KERNEL_SYMBOLS = ("lif_update_kernel", "pack_spikes", "spike_deliver_kernel",
                       "superstep_lif_kernel", "iaf_spikes", "iaf_deposit",
                       "flash_attention_kernel", "flash_attention_tc",
                       "event_deliver_kernel")


def log(*args) -> None:
    print(*args, flush=True)


def bitwise_equal(a, b) -> bool:
    """Same dtype, shape and bytes (so -0.0 != +0.0 and NaNs compare), on
    ``a``'s device."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_bytes = lambda x: x.contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
    return bool(torch.equal(as_bytes(a), as_bytes(b.to(a.device))))


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


SPIN_CYCLES_PER_S = 2.0e9   # above the H100's clocks, so a spin lasts at least as asked
MAX_SPIN_S = 4.0
TIMER_BATCH = 25            # windows behind one spin: bounds the launch queue's depth


def _enqueue_windows(fn, reps: int, flush) -> list:
    """Enqueue ``reps`` x (L2 flush, start event, ``fn()``, end event)."""
    import torch

    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    return pairs


def time_ms_host_paced(fn, *, reps: int = 20, flush=None, warm: int = 3) -> float:
    """The earlier timer of this script: each window enqueued and
    synchronized in turn, so the device waits inside a window for whatever
    host work ``fn`` does before its launch. Kept to show that effect, and
    for functions :func:`time_ms` cannot hold behind a spin (which has
    warmed ``fn`` up already: ``warm`` 0)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        ((start, end),) = _enqueue_windows(fn, 1, flush)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gated_batch(fn, reps: int, flush, spin_s: float) -> list[float] | None:
    """``reps`` windows enqueued behind a device spin of ``spin_s``; their
    times, or None if the device got past the spin before the host had
    enqueued the last window."""
    import torch

    torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    gate = torch.cuda.Event()
    gate.record()
    pairs = _enqueue_windows(fn, reps, flush)
    early = gate.query()
    torch.cuda.synchronize()
    return None if early else [s.elapsed_time(e) for s, e in pairs]


def time_ms(fn, *, reps: int = 20, flush=None, host_paced_ok: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` windows (CUDA events), with
    no host time inside a window.

    Three warm-up windows give the host's time to enqueue one window. The
    windows are then enqueued in batches of at most ``TIMER_BATCH``, each
    behind a device spin (``torch.cuda._sleep``) of 1.5x the batch's enqueue
    time plus 1 ms, and the host synchronizes after each batch. An event
    recorded right after the spin tells whether the device got past it
    before the host had enqueued the batch's last window: then the device
    may have waited for the host inside a window, so the spin is made 4x
    longer and the batch repeated once; if the device is still too early,
    this raises. A function whose enqueue blocks on the launch queue
    (hundreds of launches per call, as some plain versions) cannot be held
    behind a spin: with ``host_paced_ok`` its time is taken by
    :func:`time_ms_host_paced` instead, and a ``[timer]`` line says so.
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _enqueue_windows(fn, 3, flush)
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        batch = min(TIMER_BATCH, reps - len(times))
        spin_s = 1.5 * batch * host_s + 1e-3
        got, what = None, f"{batch} windows take {batch * host_s:.3f} s to enqueue"
        for _ in range(2):
            if spin_s > MAX_SPIN_S:
                break
            got = _gated_batch(fn, batch, flush, spin_s)
            if got is not None:
                break
            what = (f"the device got past a {spin_s * 1e3:.1f} ms spin before the host "
                    f"had enqueued {batch} windows")
            spin_s *= 4
        if got is None:
            if not host_paced_ok:
                raise RuntimeError(f"time_ms: {what}; host time would land in the windows")
            log(f"[timer] {what}: host-paced timer for this function")
            return time_ms_host_paced(fn, reps=reps, flush=flush, warm=0)
        times += got
    return statistics.median(times)


def state_equal(a, b) -> bool:
    import dataclasses

    leaves = [(a.ring, b.ring), (a.spike_count, b.spike_count)] + [
        (getattr(a.neuron, f.name), getattr(b.neuron, f.name))
        for f in dataclasses.fields(a.neuron)]
    return a.t == b.t and all(bitwise_equal(x, y) for x, y in leaves)


def card_name_power() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}: {name}")
    log(card_name_power())
    return dict(platform="gpu", kind=name, count=torch.cuda.device_count())


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import cuda
    from repro_torch.kernels.event_deliver import REGIMES

    t0 = time.perf_counter()
    # The event scatter's two forced-regime builds (for [kernel]'s regime
    # lines) start with the others.
    with ThreadPoolExecutor(1 + len(REGIMES)) as pool:
        variants = [pool.submit(cuda.build_all, ("event_deliver",), d) for d in REGIMES.values()]
        seconds = cuda.build_all()
        variant_s = [v.result() for v in variants]
    log(f"[build] {len(seconds)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())}); event_deliver "
        f"with its regime forced: "
        f"{', '.join(f'{r} {sum(v.values()):.1f} s' for r, v in zip(REGIMES, variant_s))}")
    for name, out in cuda.build_logs.items():
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:40]  # the mangled name names the instantiation
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {entry}: {line.strip()}")


def _tables_gb(net, fields=INCOMING + OUTGOING + ("alive", "rate_hz")) -> float:
    return sum(getattr(net, f).numel() * getattr(net, f).element_size()
               for f in fields if getattr(net, f) is not None) / 1e9


def phase_build_network(spec):
    """The full-width network with its incoming and outgoing tables, built on
    the card: ``build_network(spec, seed=12)``, then the inversion that
    ``build_network(..., outgoing=True)`` runs (``add_outgoing_tables``),
    timed on its own line."""
    import torch

    from repro_torch.core import build_network
    from repro_torch.core.connectivity import (
        _outgoing_k_bound, add_outgoing_tables, check_outgoing_order,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_network(spec, seed=12)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[full] network {spec.n_areas} x {net.n_pad}, K {net.k_intra}/{net.k_inter}, "
        f"D {net.delay_ratio}, ring {net.ring_len}, intra window "
        f"[{net.steps_lo_intra}, +{net.r_span_intra}), inter window "
        f"[{net.steps_lo_inter}, +{net.r_span_inter}); incoming tables built on "
        f"{net.device} in {build_s:.2f} s, {_tables_gb(net, INCOMING):.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    net = add_outgoing_tables(net)
    torch.cuda.synchronize()
    invert_s = time.perf_counter() - t0
    k_out = (net.tgt_intra.shape[-1], net.tgt_inter.shape[-1])
    bound = (_outgoing_k_bound(net.k_intra), _outgoing_k_bound(net.k_inter))
    log(f"[full] outgoing tables (the inversion): {invert_s:.2f} s, K_out {k_out[0]}/"
        f"{k_out[1]} (bound {bound[0]}/{bound[1]}), {_tables_gb(net, OUTGOING):.2f} GB; build "
        f"{build_s + invert_s:.2f} s in all, tables {_tables_gb(net, INCOMING + OUTGOING):.2f} GB, "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if k_out[0] > bound[0] or k_out[1] > bound[1]:
        raise AssertionError(f"K_out {k_out} above the bound {bound}")
    t0 = time.perf_counter()
    check_outgoing_order(net)  # raises on a row the event kernel cannot take
    log(f"[full] every outgoing row ascends with its -1 padding at the end (checked in "
        f"row chunks in {time.perf_counter() - t0:.2f} s)")
    return net


def _timed_windows(eng, st, n, check=None):
    """1 warm-up + n timed windows (host clock around each window, which ends
    in a synchronize); ``check`` runs outside the timing. Returns the state,
    ms/window (mean), kernel launches per window, and a note of the slowest
    and fastest window and of the caching allocator's retries (a cudaMalloc
    that failed, emptied the cache and synchronized) during the windows."""
    import torch

    from repro_torch.kernels import cuda

    times = []
    for w in range(n + 1):
        if w == 1:
            before = dict(cuda.launches)
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, blk = eng.window(st)
        torch.cuda.synchronize()
        if w:
            times.append(time.perf_counter() - t0)
        if check:
            check(w, st, blk)
    per = {k: (cuda.launches[k] - before[k]) / n for k in before}
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    note = (f"windows {1e3 * min(times):.2f}-{1e3 * max(times):.2f} ms, "
            f"{retries} allocator retries")
    return st, 1e3 * sum(times) / n, per, note


def _advance(eng, st, n, what, keep=None):
    """``st`` after ``n`` untimed windows of ``eng``; logs each window's
    spikes and those of its busiest (cycle, area). ``keep`` (a list) gets
    each window's block, bit-packed on the host."""
    first = st.t // eng.delay_ratio
    blocks = []
    for _ in range(n):
        st, blk = eng.window(st)
        blocks.append(blk)
        if keep is not None:
            keep.append(_packed(blk))
    log(f"[full] {what}, windows {first}-{first + n - 1}: {_fired(blocks)}")
    return st


def _packed(blk):
    """A spike block bit-packed into a host array (the [dist] references)."""
    import numpy as np

    return np.packbits(blk.cpu().numpy().astype(bool))


def _fired(blocks) -> str:
    """Spikes a window, and those of each window's busiest (cycle, area)."""
    import torch

    per = [blk.sum(-1, dtype=torch.int32) for blk in blocks]  # [D, A] each
    return (f"spikes {[int(x.sum()) for x in per]}, busiest (cycle, area) "
            f"{[int(x.max()) for x in per]}")


def _keep(store):
    return lambda w, st, blk: store.append((blk.clone(), st.ring.clone()))


def _same_as(store, what):
    def check(w, st, blk):
        blk_0, ring_0 = store[w]
        if not (bitwise_equal(blk, blk_0) and bitwise_equal(st.ring, ring_0)):
            raise AssertionError(f"{what} differ at window {w}")
    return check


def _expect(per, name, **nonzero):
    from repro_torch.kernels import cuda

    want = {k: float(nonzero.get(k, 0)) for k in cuda.KERNELS}
    if per != want:
        raise AssertionError(f"{name}: launches per window {per}, expected {want}")


def _report(name, ms, per, note, st, model_ms):
    log(f"[full] {name}: {ms:.2f} ms/window ({note}), real-time factor "
        f"{ms / model_ms:.1f}, launches/window {per}, {int(st.spike_count.sum())} spikes")


def phase_main_path(spec, net) -> dict:
    """The ``pallas`` runs at full width. Returns their stores (each window's
    block and ring, for the event runs to match), ms/window per run, the
    path's launch counts and lif_update's profiled us per launch."""
    import torch

    from repro_torch.core import EngineConfig, make_simulation
    from repro_torch.kernels import cuda

    model_ms = net.delay_ratio * net.dt_ms

    def engine(model, sched="structure_aware", **kw):
        return make_simulation(spec, EngineConfig(
            neuron_model=model, schedule=sched, delivery_backend="pallas", **kw), net=net)

    cuda.reset_launches()
    # The conventional run keeps each window's block and ring; the
    # structure-aware runs, unfused and fused, must reproduce them bitwise.
    iaf = {"conventional": engine("ignore_and_fire", "conventional"),
           "structure_aware": engine("ignore_and_fire"),
           "structure_aware fused": engine("ignore_and_fire", superstep_kernel=True)}
    iaf_store = []
    runs = {"conventional": _timed_windows(
        iaf["conventional"], iaf["conventional"].init(), 5, check=_keep(iaf_store))}
    for name in ("structure_aware", "structure_aware fused"):
        runs[name] = _timed_windows(iaf[name], iaf[name].init(), 5,
                                    check=_same_as(iaf_store, f"iaf conventional and {name}"))
    st_c = runs["conventional"][0]
    for name, (st, ms, per, note) in runs.items():
        if int(st.spike_count.sum()) <= 0 or not state_equal(st_c, st):
            raise AssertionError(f"full width iaf {name}: no spikes, or final state differs")
        _report(f"ignore_and_fire {name}", ms, per, note, st, model_ms)
    _expect(runs["conventional"][2], "iaf conventional", spike_deliver=20)
    _expect(runs["structure_aware"][2], "iaf structure_aware", spike_deliver=20)
    _expect(runs["structure_aware fused"][2], "iaf fused", spike_deliver=10, superstep_iaf=1)
    log("[full] ignore_and_fire conventional == structure_aware == fused bitwise over "
        "6 windows (spike blocks, rings, states)")
    ms = {f"iaf {name}": run[1] for name, run in runs.items()}
    del runs, st_c

    # LIF: both runs start from the state after LIF_RAMP_WINDOWS windows of
    # the fused engine; the unfused structure-aware run keeps its blocks and
    # rings, the fused run must reproduce them and the final state bitwise.
    lif = {"structure_aware": engine("lif"),
           "structure_aware fused": engine("lif", superstep_kernel=True)}
    lif_ramp = []
    lif_start = _advance(lif["structure_aware fused"], lif["structure_aware fused"].init(),
                         LIF_RAMP_WINDOWS, "lif untimed, fused pallas", keep=lif_ramp)
    lif_store = []
    st_u, ms_u, per_u, note_u = _timed_windows(lif["structure_aware"], lif_start,
                                       5, check=_keep(lif_store))
    st_f, ms_f, per_f, note_f = _timed_windows(lif["structure_aware fused"], lif_start, 5,
                                       check=_same_as(lif_store, "lif unfused and fused"))
    if not bool(torch.isfinite(st_f.neuron.v).all()) or not bool(torch.isfinite(st_f.ring).all()):
        raise AssertionError("LIF state is not finite")
    if not state_equal(st_u, st_f):
        raise AssertionError("full width LIF: fused final state != unfused")
    if not all(bool(blk.any()) for blk, _ in lif_store):
        raise AssertionError("full width LIF: a window without spikes")
    log(f"[full] lif runs, windows {LIF_RAMP_WINDOWS}-{LIF_RAMP_WINDOWS + 5}: "
        f"{_fired([blk for blk, _ in lif_store])}")
    _report("lif structure_aware", ms_u, per_u, note_u, st_u, model_ms)
    _report("lif structure_aware fused", ms_f, per_f, note_f, st_f, model_ms)
    _expect(per_u, "lif structure_aware", lif_update=10, spike_deliver=20)
    _expect(per_f, "lif fused", spike_deliver=10, superstep_lif=1)
    log("[full] lif unfused == fused bitwise over 6 windows (spike blocks, rings, states)")
    ms.update({"lif structure_aware": ms_u, "lif structure_aware fused": ms_f})
    launches = dict(cuda.launches)
    log(f"[full] main-path launches (pallas runs) {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if min(launches[k] for k in PALLAS_PATH_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the pallas runs never launched: {launches}")
    profiled = {}
    for name, eng in lif.items():
        kernels = profile_window(f"lif {name}", lambda: eng.window(st_f))
        if name == "structure_aware":
            us, count = _port_kernel_time(kernels, "lif_update_kernel")
            if count != per_u["lif_update"]:
                raise AssertionError(f"profiled LIF window: {count} lif_update launches, "
                                     f"expected {per_u['lif_update']}")
            profiled["lif_update"] = us / count
    for name, eng in iaf.items():
        st = eng.window(eng.init())[0]
        profile_window(f"ignore_and_fire {name}", lambda: eng.window(st))
    return dict(iaf_store=iaf_store, lif_store=lif_store, lif_start=lif_start, ms=ms,
                launches=launches, profiled=profiled, lif_ramp=lif_ramp)


def phase_event_runs(spec, net, pallas: dict) -> dict:
    """The ``event`` runs at full width on the same network, 1 + 5 windows
    each, every one bitwise the matching ``pallas`` run window by window
    (spike blocks and rings) with ``overflow == 0``. Returns the event path's
    launch counts."""
    import torch

    from repro_torch.core import EngineConfig, make_simulation, run_windows
    from repro_torch.kernels import cuda

    model_ms = net.delay_ratio * net.dt_ms

    def engine(model, sched="structure_aware", **kw):
        return make_simulation(spec, EngineConfig(
            neuron_model=model, schedule=sched, delivery_backend="event", **kw), net=net)

    def check_final(name, st, store):
        if int(st.overflow) != 0:
            raise AssertionError(f"event {name}: overflow {int(st.overflow)}")
        if not bitwise_equal(st.ring, store[-1][1]):
            raise AssertionError(f"event {name}: final ring differs from the pallas run's")

    # (name, model, schedule, config, the pallas run it must equal and is
    # timed beside, expected launches per window)
    iaf_runs = [
        ("conventional", "conventional", {}, "iaf conventional", dict(event_deliver=20)),
        ("structure_aware", "structure_aware", {}, "iaf structure_aware",
         dict(event_deliver=11)),
        ("structure_aware legacy", "structure_aware", dict(superstep=False),
         "iaf structure_aware", dict(event_deliver=20)),
        ("structure_aware fused", "structure_aware", dict(superstep_kernel=True),
         "iaf structure_aware fused", dict(event_deliver=1, superstep_iaf=1)),
        ("structure_aware adaptive", "structure_aware", dict(adaptive_exchange=True),
         "iaf structure_aware", dict(event_deliver=11)),
    ]
    lif_runs = [
        ("structure_aware", "structure_aware", dict(fused_update=True),
         "lif structure_aware", dict(event_deliver=11, lif_update=10)),
        ("structure_aware fused", "structure_aware", dict(superstep_kernel=True),
         "lif structure_aware fused", dict(event_deliver=1, superstep_lif=1)),
    ]
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    engines = {}
    for model, runs, store, start in (
            ("ignore_and_fire", iaf_runs, pallas["iaf_store"], None),
            ("lif", lif_runs, pallas["lif_store"], pallas["lif_start"])):
        for name, sched, kw, twin, per_window in runs:
            eng = engines[f"{model} {name}"] = engine(model, sched, **kw)
            st, ms, per, note = _timed_windows(eng, eng.init() if start is None else start, 5,
                                         check=_same_as(store, f"event {model} {name} and {twin}"))
            check_final(f"{model} {name}", st, store)
            _expect(per, f"event {model} {name}", **per_window)
            log(f"[event] {model} {name}: {ms:.2f} ms/window ({note}; pallas "
                f"{pallas['ms'][twin]:.2f}), "
                f"real-time factor {ms / model_ms:.1f} (pallas "
                f"{pallas['ms'][twin] / model_ms:.1f}), launches/window {per}, "
                f"{int(st.spike_count.sum())} spikes, overflow 0; bitwise the pallas run "
                f"window by window")

    # Adaptive + overlap through run_windows: blocks window by window, and
    # the drained state at the end, against the pallas run.
    name = "structure_aware adaptive overlap"
    eng = engines[f"ignore_and_fire {name}"] = engine(
        "ignore_and_fire", adaptive_exchange=True, overlap_exchange=True)
    store = pallas["iaf_store"]
    before = dict(cuda.launches)
    checked = []

    def on_block(w, blk):
        if not bitwise_equal(blk, store[w - 1][0]):
            raise AssertionError(f"event iaf {name}: block differs at window {w - 1}")
        checked.append(w)

    res = run_windows(eng, eng.init(), 6, on_block=on_block)
    check_final(f"ignore_and_fire {name}", res.state, store)
    total = {k: cuda.launches[k] - before[k] for k in before}
    want = {k: 66 if k == "event_deliver" else 0 for k in cuda.KERNELS}
    if total != want or not res.overlapped or res.drains != 1 or len(checked) != 6:
        raise AssertionError(f"event iaf {name}: launches {total} (expected {want}), "
                             f"overlapped {res.overlapped}, drains {res.drains}")
    ms = 1e3 * float(res.window_times_s[1:].mean())
    twin = pallas["ms"]["iaf structure_aware"]
    log(f"[event] ignore_and_fire {name} (run_windows): {ms:.2f} ms/window over windows "
        f"2-6 (pallas {twin:.2f}), real-time factor {ms / model_ms:.1f}, launches {total} "
        f"over 6 windows and the drain, drains {res.drains}, overflow 0; blocks bitwise "
        f"the pallas run's window by window, the drained state's ring bitwise its last")
    launches = dict(cuda.launches)
    log(f"[event] event-path launches {launches}, peak while the event engines ran "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if min(launches[k] for k in EVENT_PATH_KERNELS) <= 0 or launches["spike_deliver"]:
        raise AssertionError(f"event path launches {launches}")
    for name in ("ignore_and_fire structure_aware", "ignore_and_fire structure_aware fused"):
        eng = engines[name]
        st = eng.window(eng.init())[0]
        kernels = profile_window(f"event {name}", lambda: eng.window(st))
        log(f"[profile]   {sum(k[1] for k in kernels)} kernel launches in the window")
    return launches


def phase_lif_steady(spec, net, start) -> tuple:
    """LIF at its steady state (~70 Hz), 1 + 5 windows from window
    ``LIF_STEADY_WINDOWS`` (``start`` advanced on the fused pallas engine):
    the fused pallas run bitwise the unfused one, and the adaptive event
    runs, unfused (``fused_update=True``) and fused, bitwise the unfused
    pallas run window by window with ``overflow == 0``; one window of each
    adaptive event run profiled, with ``event_deliver``'s share of the
    device's busy time. Then one window of the static event packets, which
    drop spikes at this rate: the count. Returns the last window's block,
    ring and first step, for ``[kernel]``, and the state at window
    ``LIF_STEADY_WINDOWS``, for ``[resilience]``."""
    from repro_torch.core import EngineConfig, make_simulation

    model_ms = net.delay_ratio * net.dt_ms

    def engine(backend, **kw):
        return make_simulation(spec, EngineConfig(
            neuron_model="lif", delivery_backend=backend, **kw), net=net)

    fused = engine("pallas", superstep_kernel=True)
    start = _advance(fused, start, LIF_STEADY_WINDOWS - LIF_RAMP_WINDOWS,
                     "lif untimed, fused pallas")
    store = []
    runs = [("pallas", engine("pallas"), _keep(store), dict(spike_deliver=20, lif_update=10)),
            ("pallas fused", fused, None, dict(spike_deliver=10, superstep_lif=1)),
            ("event adaptive", engine("event", adaptive_exchange=True, fused_update=True),
             None, dict(event_deliver=11, lif_update=10)),
            ("event adaptive fused",
             engine("event", adaptive_exchange=True, superstep_kernel=True), None,
             dict(event_deliver=1, superstep_lif=1))]
    for name, eng, check, per_window in runs:
        st, ms, per, note = _timed_windows(
            eng, start, 5, check=check or _same_as(store, f"steady lif {name} and pallas"))
        _expect(per, f"steady lif {name}", **per_window)
        if int(st.overflow) != 0 or not bitwise_equal(st.ring, store[-1][1]):
            raise AssertionError(f"steady lif {name}: overflow {int(st.overflow)} or final "
                                 "ring differs")
        log(f"[steady] lif {name}: {ms:.2f} ms/window ({note}), real-time factor "
            f"{ms / model_ms:.1f}, launches/window {per}, overflow 0"
            + ("" if check else "; bitwise the unfused pallas run window by window"))
    log(f"[steady] lif runs, windows {LIF_STEADY_WINDOWS}-{LIF_STEADY_WINDOWS + 5}: "
        f"{_fired([blk for blk, _ in store])}")
    for name, eng, _, _ in runs[2:]:
        kernels = profile_window(f"steady lif {name}, window {LIF_STEADY_WINDOWS}",
                                 lambda: eng.window(start))
        us, count = _port_kernel_time(kernels, "event_deliver_kernel")
        busy = sum(k[0] for k in kernels)
        log(f"[profile]   event_deliver_kernel {us / 1e3:.3f} ms in {count} launches, "
            f"{100 * us / busy:.1f}% of the busy time; {sum(k[1] for k in kernels)} "
            f"kernel launches in the window")
    st = engine("event", superstep_kernel=True).window(start)[0]
    log(f"[steady] lif event fused with static packets: {int(st.overflow)} spikes dropped "
        f"in one window")
    block, ring = store[-1]
    return (block, ring, (LIF_STEADY_WINDOWS + 5) * net.delay_ratio), start


def phase_resilience(spec, net, lif_start) -> None:
    """``[resilience]``: preempt and resume through ``run_windows`` at full
    width, bitwise the uninterrupted run (see the module docstring, item 6)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.core import EngineConfig, make_simulation, run_windows
    from repro_torch.core import faults as faults_lib
    from repro_torch.core import schedule as schedule_lib
    from repro_torch.kernels import cuda

    D = net.delay_ratio
    # (name, config, start state, launches per window, drains when preempted)
    runs = [("lif event adaptive", dict(neuron_model="lif", delivery_backend="event",
                                        adaptive_exchange=True, fused_update=True),
             lif_start, dict(event_deliver=11, lif_update=10), 0),
            ("iaf pallas fused overlapped",
             dict(neuron_model="ignore_and_fire", delivery_backend="pallas",
                  superstep_kernel=True, overlap_exchange=True),
             None, dict(spike_deliver=10, superstep_iaf=1), 2)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for name, kw, start, per_window, drains in runs:
            eng = make_simulation(spec, EngineConfig(**kw), net=net)
            st0 = eng.init() if start is None else start
            w0 = st0.t // D
            cuda.reset_launches()
            blocks = []
            ref = run_windows(eng, st0, 6, on_block=lambda w, b: blocks.append(b.clone()))
            directory = os.path.join(tmp, name.replace(" ", "_"))
            inj = faults_lib.FaultInjector(faults_lib.FaultConfig(
                preempt_after_window=w0 + 4, ckpt_write_failures=1), n_devices=1,
                delay_ratio=D)
            ckpt = schedule_lib.SimCheckpointer(directory, eng, net, every=2, injector=inj,
                                                backoff_s=0.01)
            try:
                run_windows(eng, st0, 6, checkpointer=ckpt, faults=inj)
                raise AssertionError(f"resilience {name}: no preemption")
            except faults_lib.Preempted as exc:
                leg = exc.result
                if exc.window != w0 + 4 or leg.drains != drains or ckpt.retry_count != 1:
                    raise AssertionError(
                        f"resilience {name}: preempted at {exc.window}, drains {leg.drains}, "
                        f"retries {ckpt.retry_count}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, info = schedule_lib.restore_sim(directory, eng, net)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            got = []
            res = run_windows(eng, st, 2, on_block=lambda w, b: got.append((w, b)))
            launches = dict(cuda.launches)
            want = {k: 12 * per_window.get(k, 0) for k in cuda.KERNELS}
            if launches != want:
                raise AssertionError(f"resilience {name}: launches {launches}, expected {want}")
            # The loop's cost per window beside the engine's own run of the
            # same 6 windows, alternated: loop (the run above), run, loop,
            # run (after the launch count, which they would change).
            loops, runs_ms = [ref.window_times_s * 1e3], []
            for rep in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(st0, 6)
                torch.cuda.synchronize()
                runs_ms.append((time.perf_counter() - t0) / 6 * 1e3)
                if rep == 0:
                    loops.append(run_windows(eng, st0, 6).window_times_s * 1e3)
            log(f"[resilience] {name}: run_windows ms a window, uninterrupted "
                f"{np.round(loops[0], 3).tolist()} (the first a fresh engine's) and again "
                f"{np.round(loops[1], 3).tolist()}: windows 2-6 {loops[0][1:].mean():.3f} / "
                f"{loops[1][1:].mean():.3f} mean; Engine.run over the same 6 windows after "
                f"each, {runs_ms[0]:.3f} / {runs_ms[1]:.3f} ms/window ({card_name_power()})")
            if [w for w, _ in got] != [w0 + 5, w0 + 6] or not all(
                    bitwise_equal(b, blocks[w - w0 - 1]) for w, b in got):
                raise AssertionError(f"resilience {name}: resumed blocks differ")
            a, b = res.state, ref.state
            leaves = [(a.ring, b.ring), (a.spike_count, b.spike_count)] + [
                (getattr(a.neuron, f.name), getattr(b.neuron, f.name))
                for f in dataclasses.fields(a.neuron)]
            if a.t != b.t or not all(bitwise_equal(x, y) for x, y in leaves) or int(
                    a.overflow) or int(b.overflow) or int(ref.spikes_per_window.sum()) <= 0:
                raise AssertionError(f"resilience {name}: resumed state differs")
            log(f"[resilience] {name}, windows {w0}-{w0 + 6}: preempted after window "
                f"{w0 + 4} (checkpoints {ckpt.saved_windows}, {ckpt.retry_count} write "
                f"retried, {drains} drains), restored in {restore_s:.3f} s and resumed for 2 "
                f"windows: blocks, ring, neuron leaves and spike_count bitwise the "
                f"uninterrupted run's, overflow 0, spikes {ref.spikes_per_window.tolist()}; "
                f"launches {launches} over the 12 windows")

            # One save timed in its two halves, and the restore above.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = schedule_lib.host_state(res.state)
            copy_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            path = ckpt_manager.save(os.path.join(directory, "timed"), w0 + 6, host)
            write_s = time.perf_counter() - t0
            nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
            log(f"[resilience] {name} checkpoint: {nbytes} bytes; save {copy_s + write_s:.3f} "
                f"s = device-to-host copy {copy_s:.3f} s + write {write_s:.3f} s; restore "
                f"{restore_s:.3f} s (read, to the card, synchronize) ({card_name_power()})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Each [cli] run executes ``python -m repro_torch.launch.simulate`` through
# runpy (what ``-m`` does), prints the per-window times of every
# ``run_windows`` call (a preempted one's too), then the process's kernel
# launch counts.
CLI_WRAPPER = (
    "import json, runpy, sys\n"
    "from repro_torch.core import faults, schedule\n"
    "from repro_torch.kernels import cuda\n"
    "run_windows = schedule.run_windows\n"
    "def show(res):\n"
    "    print('run_windows ms ' + json.dumps([round(t * 1e3, 3) for t in "
    "res.window_times_s]), flush=True)\n"
    "def timed(*args, **kwargs):\n"
    "    try:\n"
    "        res = run_windows(*args, **kwargs)\n"
    "    except faults.Preempted as exc:\n"
    "        show(exc.result)\n"
    "        raise\n"
    "    show(res)\n"
    "    return res\n"
    "schedule.run_windows = timed\n"
    "sys.argv[0] = 'repro_torch.launch.simulate'\n"
    "try:\n"
    "    runpy.run_module('repro_torch.launch.simulate', run_name='__main__', "
    "alter_sys=True)\n"
    "finally:\n"
    "    print('launches ' + json.dumps(cuda.launches), flush=True)\n")
PREEMPT_AT = 15  # LIF first spikes in window 11 at the [cli] size


def phase_cli() -> None:
    """``[cli]``: the launcher at full width in subprocesses (see the module
    docstring, item 8)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    a_npz, c_npz = os.path.join(tmp, "A.npz"), os.path.join(tmp, "C.npz")
    ckpt_dir = os.path.join(tmp, "D")
    base = ["--model", "mam_benchmark", "--areas", "4", "--n-per-area", "130000",
            "--k", "6000", "--seed", "12"]
    resilient = ["--backend", "event", "--neuron", "lif", "--adaptive", "--overlap",
                 "--t-ms", "25", "--checkpoint-dir", ckpt_dir]
    # (leg, flags, lines its stdout must hold, kernels that must have launched)
    legs = [
        ("a", ["--backend", "pallas", "--neuron", "lif", "--compare", "--profile",
               "--t-ms", "25"],
         ["schedules produce identical spike counts (static): True"],
         ("lif_update", "spike_deliver")),
        ("b", ["--backend", "event", "--neuron", "lif", "--compare", "--compare-adaptive",
               "--compare-overlap", "--t-ms", "25", "--spikes-out", a_npz],
         ["schedules produce identical spike counts (static): True",
          "schedules produce identical spike counts (adaptive+overlap): True",
          "adaptive == static spike counts (structure_aware/overlap): True",
          "overlapped == sequential spike counts (structure_aware/adaptive): True"],
         ("event_deliver",)),
        ("c", resilient + ["--inject-fault", f"preempt:window={PREEMPT_AT}"],
         [f"PREEMPTED (simulated preemption) after window {PREEMPT_AT}"], ("event_deliver",)),
        ("d", resilient + ["--resume", "--spikes-out", c_npz],
         [f"resumed window {PREEMPT_AT}", "in-flight drain(s)"], ("event_deliver",)),
    ]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    try:
        for leg, flags, expect, kernels in legs:
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-c", CLI_WRAPPER, *base, *flags],
                                 capture_output=True, text=True, timeout=600, env=env)
            lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
            for ln in lines:
                log(f"[cli] ({leg}) {ln}")
            if run.returncode != 0:
                log(run.stderr[-4000:])
                raise AssertionError(f"cli ({leg}) exited {run.returncode}")
            launches = json.loads(lines[-1].split(" ", 1)[1])
            missing = [s for s in expect if not any(s in ln for ln in lines)]
            if missing or min(launches[k] for k in kernels) <= 0:
                raise AssertionError(f"cli ({leg}): missing {missing}, launches {launches}")
            log(f"[cli] ({leg}) exit 0 in {time.perf_counter() - t0:.1f} s (process start, "
                f"network build and runs)")
            if leg == "c":
                saved = np.load(os.path.join(ckpt_dir, f"step_{PREEMPT_AT:08d}", "arrays.npz"))
                before = int(saved[".spike_count"].sum())
        _cli_group(tmp, env)
        a, c = np.load(a_npz), np.load(c_npz)
        total = int(a["spike_count"].sum())
        if int(a["t"]) != int(c["t"]) or not np.array_equal(a["spike_count"], c["spike_count"]):
            raise AssertionError("cli: the resumed run's spike counts differ from A.npz")
        if not 0 < before < total:
            raise AssertionError(f"cli: LIF must spike on both sides of the preemption "
                                 f"({before} spikes by window {PREEMPT_AT}, {total} in all)")
        log(f"[cli] C.npz == A.npz bitwise: {total} spikes over {int(c['t'])} steps, "
            f"{before} of them by window {PREEMPT_AT}, where the run was preempted and "
            f"resumed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cli_group(tmp: str, env: dict) -> None:
    """``[cli]`` on a process group: the launcher under ``torch.distributed.run``
    on four ranks (gloo, all on this card: mesh (4, 1)) and the same command
    on one process, routed ``event`` at 4 x 130,000, K 600: both exit 0 and
    their ``--spikes-out`` files are bitwise equal; the four ranks' wire as
    ``comm`` counts it equals the static accounting; the wire-volume table is
    echoed."""
    import os

    import numpy as np

    wrapper = os.path.join(tmp, "cli_wrapper.py")
    Path(wrapper).write_text(CLI_WRAPPER)
    flags = ["--model", "mam_benchmark", "--areas", "4", "--n-per-area", "130000", "--k", "600",
             "--backend", "event", "--exchange", "routed", "--t-ms", "10", "--profile"]
    outs = {leg: os.path.join(tmp, f"R{leg}.npz") for leg in ("e", "f")}
    legs = {"e": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                  "--nproc-per-node", "4", wrapper],
            "f": [sys.executable, wrapper]}
    for leg, cmd in legs.items():
        t0 = time.perf_counter()
        run = subprocess.run([*cmd, *flags, "--spikes-out", outs[leg]], capture_output=True,
                             text=True, timeout=600, env=env)
        lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
        for ln in lines:
            log(f"[cli] ({leg}) {ln}")
        if run.returncode != 0:
            log(run.stderr[-4000:])
            raise AssertionError(f"cli ({leg}) exited {run.returncode}")
        # Ranks print their counts concurrently: lines may run together.
        counts = [json.loads(x) for x in re.findall(r"launches (\{[^}]*\})", run.stdout)]
        expect = ["-- wire volume", "spike counts ->"] + (
            ["mesh: 4 area groups x 1 subgroup devices"] if leg == "e" else [])
        missing = [x for x in expect if not any(x in ln for ln in lines)]
        if missing or len(counts) != (4 if leg == "e" else 1) or min(
                c["event_deliver"] for c in counts) <= 0:
            raise AssertionError(f"cli ({leg}): missing {missing}, launches {counts}")
        if leg == "e":
            # The static run's wire as comm counts it, against the accounting.
            static = re.findall(r"([\d,]+) wire B/window", run.stdout)
            measured = re.findall(r"([\d,]+) measured B/window", run.stdout)
            if len(static) != 1 or static != measured:
                raise AssertionError(f"cli (e): wire {static} B/window, measured {measured}")
            log(f"[cli] (e) measured {measured[0]} B/window on the wire (comm's count, all "
                f"ranks) == routed_wire_bytes")
        log(f"[cli] ({leg}) exit 0 in {time.perf_counter() - t0:.1f} s "
            f"({'four ranks' if leg == 'e' else 'one process'}; event_deliver launches "
            f"{[c['event_deliver'] for c in counts]})")
    e, f = np.load(outs["e"]), np.load(outs["f"])
    if int(e["t"]) != int(f["t"]) or not np.array_equal(e["spike_count"], f["spike_count"]):
        raise AssertionError("cli: the four ranks' spike counts differ from one process's")
    log(f"[cli] Re.npz (four ranks, routed) == Rf.npz (one process) bitwise: "
        f"{int(e['spike_count'].sum())} spikes over {int(e['t'])} steps")


# ---------------------------------------------------------------------------
# [serve]: the folded trial server at the 32-area MAM (mam_spec(scale=0.1)).

SERVE_BATCHES = (8, 6, 4)   # the event fold: the largest whose reckoned peak fits
SERVE_PEAK_GB = 70.0
SERVE_PALLAS_BATCH = 8      # incoming tables only
SERVE_TRIALS, SERVE_WINDOWS = 8, 8  # 8 trials: the time limit's share
# [cli]'s wrapper around ``python -m repro_torch.launch.serve``.
SERVE_CLI_WRAPPER = CLI_WRAPPER.replace("repro_torch.launch.simulate",
                                        "repro_torch.launch.serve")


def serve_requests(trials: int, windows: int) -> list:
    """The serve CLI's ``--selftest`` requests: seeds, stim U(0.8, 1.2) and
    durations of 1-``windows`` windows drawn from ``default_rng(0)``."""
    import numpy as np

    from repro_torch.launch.serve import TrialRequest

    rng = np.random.default_rng(0)
    return [TrialRequest(seed=int(rng.integers(1, 2**31)),
                         stim=float(rng.uniform(0.8, 1.2)),
                         windows=int(rng.integers(1, windows + 1)))
            for _ in range(trials)]


def _serve_all(server, requests) -> list:
    handles = [server.submit(r) for r in requests]
    return [h.result(timeout=600) for h in handles]


def _window_times_ms(eng, st, n: int) -> list[float]:
    """Host clock around each of ``n`` windows from ``st``, each ending in a
    synchronize."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = eng.window(st)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _same_trials(got, want, what: str) -> None:
    import numpy as np

    for g, w in zip(got, want, strict=True):
        if g.request != w.request or g.overflow != w.overflow or not np.array_equal(
                g.spikes, w.spikes):
            raise AssertionError(f"{what}: trial seed={g.request.seed} differs "
                                 f"(overflow {g.overflow} / {w.overflow})")


def _stats_line(name, stats, card) -> str:
    return (f"[serve] {name}: {stats['trials']} trials in {stats['elapsed_s']:.3f} s, "
            f"{stats['trials_per_s']:.3f} trials/s, p50 {stats['p50_ms']:.1f} ms, "
            f"p99 {stats['p99_ms']:.1f} ms, busy {stats['busy_s']:.3f} s over "
            f"{stats['windows']} folded windows ({card})")


def phase_serve() -> None:
    """``[serve]``: the folded trial server at ``mam_spec(scale=0.1)``, the
    serve CLI's ``--selftest`` regime (``v_th`` 2.0 mV, packet floor at the
    area's padded size), 8 trials of 1-8 windows: (a) the event fold's B
    from a reckoning of its peak; (b) the event server, every trial bitwise
    its sequential reference on the card, overflow 0, spikes in every trial;
    (c) the pallas server at B = 8, bitwise the event trials, and one
    ``spike_deliver`` inter launch at the fold's shape against its plain
    version; (d) the sequential baseline (``max_batch=1``); (e) card == CPU
    at ``tests/test_serve.py``'s size; (f) the serve CLI's selftest."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import EngineConfig, build_network, make_simulation
    from repro_torch.core import mam_benchmark_spec, mam_spec
    from repro_torch.core.neuron import LIFParams
    from repro_torch.kernels import cuda
    from repro_torch.kernels import spike_deliver as dlv
    from repro_torch.launch.serve import SimServer, TrialRequest, sequential_reference

    card = card_name_power()
    spec = mam_spec(scale=0.1)
    lif = LIFParams(v_th_mv=2.0)
    cfg = EngineConfig(delivery_backend="event", lif=lif,
                       s_max_floor=max(16, spec.padded_area_size(1)))
    requests = serve_requests(SERVE_TRIALS, SERVE_WINDOWS)

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # (a) The reckoning: one copy's tables (K_out is known only once built).
    t0 = time.perf_counter()
    net = build_network(spec, seed=12, outgoing=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    a, n_pad = net.alive.shape
    copy_gb, incoming_gb = _tables_gb(net), _tables_gb(net, INCOMING)
    ring_gb = a * n_pad * net.ring_len * 4 / 1e9
    k_out = (net.tgt_intra.shape[-1], net.tgt_inter.shape[-1])
    # B + 1 copies (the single copy beside the fold while it is built) and two
    # folded rings (the state's and the window's copy).
    reckon = {b: (b + 1) * copy_gb + 2 * b * ring_gb for b in SERVE_BATCHES}
    fits = [b for b in SERVE_BATCHES if reckon[b] <= SERVE_PEAK_GB]
    if not fits:
        raise AssertionError(f"serve: no fold fits {SERVE_PEAK_GB} GB: {reckon}")
    B = fits[0]
    log(f"[serve] mam_spec(scale=0.1): {spec.n_areas} areas, {spec.n_total} neurons, "
        f"n_pad {n_pad}, K {net.k_intra}/{net.k_inter}, K_out {k_out[0]}/{k_out[1]}, "
        f"ring {net.ring_len}; one copy built in {build_s:.2f} s: {copy_gb:.3f} GB of "
        f"tables ({incoming_gb:.3f} incoming), folded ring {ring_gb:.3f} GB a copy; "
        f"reckoned peak {', '.join(f'B={b} {g:.2f} GB' for b, g in reckon.items())}: "
        f"event fold B = {B} (<= {SERVE_PEAK_GB:g} GB) ({card})")
    del net
    free()

    # (b) The event server.
    t0 = time.perf_counter()
    server = SimServer(spec, cfg, max_batch=B, max_windows=SERVE_WINDOWS, device="cuda")
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.start()
    start_s = time.perf_counter() - t0
    fold_gb = _tables_gb(server.net)
    cuda.reset_launches()
    event = _serve_all(server, requests)
    launches = dict(cuda.launches)
    stats = server.stats()
    server.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["event_deliver"] <= 0:
        raise AssertionError(f"serve event: event_deliver never launched: {launches}")
    fold_ms = _window_times_ms(server.engine, server._init_state(requests[:B]),
                               SERVE_WINDOWS)
    log(f"[serve] (b) event server, B = {B}: built and folded in {fold_s:.2f} s "
        f"({fold_gb:.2f} GB of tables), warm-up dispatch {start_s:.2f} s; peak "
        f"{peak_gb:.2f} GB (max_memory_allocated) against {reckon[B]:.2f} GB reckoned; "
        f"launches while serving {launches} ({card})")
    log(_stats_line("(b) event server", stats, card))
    log(f"[serve] (b) on_block: {1e3 * stats['block_host_s'] / stats['windows']:.2f} ms of "
        f"host time a folded window to copy the [{server.delay_ratio}, {B * a}, {n_pad}] "
        f"block ({server.delay_ratio * B * a * n_pad / 1e6:.1f} MB) and slice its trials "
        f"({card})")
    del server
    free()

    ref = make_simulation(spec, cfg, device="cuda")
    for r in event:
        want = sequential_reference(spec, cfg, r.request, engine=ref)
        if r.spikes.shape != want.shape or not np.array_equal(r.spikes, want):
            raise AssertionError(f"serve event: trial seed={r.request.seed} != its "
                                 f"sequential reference")
        if r.overflow != 0 or not r.spikes.any():
            raise AssertionError(f"serve event: trial seed={r.request.seed}: overflow "
                                 f"{r.overflow}, {int(r.spikes.sum())} spikes")
    single_ms = _window_times_ms(ref, ref.init(seed=requests[0].seed, stim=requests[0].stim),
                                 SERVE_WINDOWS)
    spikes = [int(r.spikes.sum()) for r in event]
    cycles = sum(r.spikes.shape[0] for r in event)
    rate_hz = sum(spikes) / (spec.n_total * cycles * spec.dt_ms * 1e-3)
    log(f"[serve] (b) every trial bitwise its sequential reference (run alone through "
        f"make_simulation on the card), overflow 0; spikes per trial {spikes}, mean rate "
        f"{rate_hz:.1f} Hz")
    log(f"[serve] (b) folded window (B = {B}) {statistics.mean(fold_ms):.2f} ms "
        f"({', '.join(f'{t:.2f}' for t in fold_ms)}) against the single trial's "
        f"{statistics.mean(single_ms):.2f} ms ({', '.join(f'{t:.2f}' for t in single_ms)}): "
        f"{statistics.mean(fold_ms) / (B * statistics.mean(single_ms)):.3f} of B single "
        f"windows ({card})")

    # (d) The sequential baseline: the same machinery, no fold.
    del ref
    free()
    with SimServer(spec, cfg, max_batch=1, max_windows=SERVE_WINDOWS,
                   device="cuda") as server:
        seq = _serve_all(server, requests)
    _same_trials(seq, event, "serve max_batch=1 vs event fold")
    log(_stats_line("(d) sequential baseline, max_batch=1", server.stats(), card)
        + f"; its trials == the fold's, bitwise; the fold (B = {B}) above: "
          f"{stats['trials_per_s']:.3f} trials/s")
    del server
    free()

    # (c) The pallas server at B = 8.
    pcfg = dataclasses.replace(cfg, delivery_backend="pallas")
    server = SimServer(spec, pcfg, max_batch=SERVE_PALLAS_BATCH,
                       max_windows=SERVE_WINDOWS, device="cuda").start()
    cuda.reset_launches()
    pallas = _serve_all(server, requests)
    launches = dict(cuda.launches)
    pstats = server.stats()
    server.shutdown()
    if min(launches["lif_update"], launches["spike_deliver"]) <= 0:
        raise AssertionError(f"serve pallas: a kernel never launched: {launches}")
    _same_trials(pallas, event, "serve pallas vs event")
    log(f"[serve] (c) pallas server, B = {SERVE_PALLAS_BATCH}: "
        f"{_tables_gb(server.net):.2f} GB of tables, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; every trial bitwise the event "
        f"server's; launches while serving {launches} ({card})")
    log(_stats_line("(c) pallas server", pstats, card))
    # One inter launch at the fold's shape, on a served cycle's spikes: the
    # bitmask of ~5.1M sources lies past shared memory (the global-mask branch).
    net = server.net
    st = server._init_state(requests[:SERVE_PALLAS_BATCH])
    for _ in range(2):
        st, blk = server.engine.window(st)
    counts = blk.reshape(blk.shape[0], -1).sum(-1)
    spikes_f = blk[int(counts.argmax())].reshape(-1).float().contiguous()
    n_src = spikes_f.numel()
    rows, k = a * SERVE_PALLAS_BATCH * n_pad, net.k_inter
    src, w, delay = (getattr(net, f).view(rows, k)
                     for f in ("src_inter", "w_inter", "delay_inter"))
    kw = dict(steps_lo=net.steps_lo_inter, r_span=net.r_span_inter)
    before = dict(cuda.launches)
    got = dlv.spike_deliver_cuda(spikes_f, src, w, delay, **kw)
    want = dlv.spike_deliver_plain(spikes_f, src, w, delay, **kw)
    if not bitwise_equal(got, want):
        raise AssertionError("spike_deliver at the fold's shape != plain version")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: dlv.spike_deliver_cuda(spikes_f, src, w, delay, **kw), flush=flush)
    plain_ms = time_ms(lambda: dlv.spike_deliver_plain(spikes_f, src, w, delay, **kw),
                       reps=10, flush=flush, host_paced_ok=True)
    cuda.launches.update(before)  # comparison launches are not the path's
    active = _active_synapses(spikes_f, src, None)
    nbytes = (src.numel() * 4 + active * (4 + delay.element_size()) + n_src * 4
              + got.numel() * 4)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * active / F32_OPS_PER_S) * 1e3
    log(f"[serve] (c) spike_deliver inter at the fold's shape [{rows}, {k}], {n_src} "
        f"sources (a {-(-n_src // 128) * 16 / 1e3:.0f} KB bitmask, in global memory), "
        f"{int(spikes_f.sum())} spiking, r_span {kw['r_span']}: bitwise == plain; "
        f"{active} active synapses; {ms:.3f} ms (bound {bound_ms:.3f} ms by bytes, "
        f"{100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.3f} ms ({card})")
    del server, net, st, blk, src, w, delay, got, want, flush, spikes_f
    free()

    # (e) Card == CPU at tests/test_serve.py's size, 4 copies, both routes.
    tiny = mam_benchmark_spec(n_areas=4, n_per_area=48, k_intra=8, k_inter=8)
    tiny_reqs = [TrialRequest(seed=101, stim=1.0, windows=3),
                 TrialRequest(seed=202, stim=0.9, windows=3),
                 TrialRequest(seed=303, stim=1.1, windows=2),
                 TrialRequest(seed=404, stim=1.0, windows=4),
                 TrialRequest(seed=505, stim=1.2, windows=1)]
    for backend in ("event", "pallas"):
        tcfg = EngineConfig(delivery_backend=backend, lif=lif)
        served = {}
        for dev in ("cuda", "cpu"):
            with SimServer(tiny, tcfg, max_batch=4, max_windows=8, device=dev) as srv:
                served[dev] = _serve_all(srv, tiny_reqs)
        _same_trials(served["cuda"], served["cpu"], f"serve card vs cpu ({backend})")
        log(f"[serve] (e) {backend}: {len(tiny_reqs)} trials of the 4 x 48 spec served "
            f"4 at a time on the card == on the CPU, bitwise, overflow "
            f"{[r.overflow for r in served['cpu']]}; spikes "
            f"{[int(r.spikes.sum()) for r in served['cpu']]}")

    # (f) The serve CLI's selftest, as a subprocess.
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    run = subprocess.run(
        [sys.executable, "-c", SERVE_CLI_WRAPPER, "--selftest", "--scale", "0.1",
         "--batch", str(B), "--trials", str(SERVE_TRIALS), "--windows", str(SERVE_WINDOWS)],
        capture_output=True, text=True, timeout=600, env=env)
    lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
    for ln in lines:
        log(f"[serve] (f) {ln}")
    if run.returncode != 0:
        log(run.stderr[-4000:])
        raise AssertionError(f"serve cli exited {run.returncode}")
    launches = json.loads(lines[-1].split(" ", 1)[1])
    if not any(ln.startswith("selftest OK") for ln in lines) or launches["event_deliver"] <= 0:
        raise AssertionError(f"serve cli: no selftest OK line or no launches: {launches}")
    log(f"[serve] (f) the serve CLI's selftest exit 0 in {time.perf_counter() - t0:.1f} s "
        f"(process start, build, serving, {SERVE_TRIALS} references) ({card})")


# [mam]: the paper's MAM driver (repro_torch.mam_simulation).
MAM_SCALE = 0.2      # 1.53 G incoming synapse slots: the main path's 1.56 G
# 1 untimed + 49 timed windows (50 ms): mam_simulation's own 1 s is 1,000
# windows, and on scatter (plain PyTorch over every slot) they take ~12 min.
# scatter runs 1 + 9 windows (~0.72 s each), held bitwise against pallas run
# as far; the CLI leg (a) runs 300 ms of the small model. (Cut from 100, 100
# and 1000 ms to keep the script within 70% of its time limit.)
MAM_T_MS = 50.0
MAM_SCATTER_T_MS = 10.0
MAM_CLI_T_MS = 300.0
# The driver's CLI, run as ``-m`` runs it (its main on the command line's
# flags); after it returns, the run's per-area spike counts and the
# process's kernel launch counts.
MAM_CLI_WRAPPER = (
    "import json, sys\n"
    "from repro_torch import mam_simulation\n"
    "from repro_torch.kernels import cuda\n"
    "res = mam_simulation.main(sys.argv[1:])\n"
    "print('counts ' + json.dumps(res.counts.tolist()), flush=True)\n"
    "print('launches ' + json.dumps(cuda.launches), flush=True)\n")


def phase_mam() -> dict:
    """``[mam]``: the paper's driver on the card. (a) ``python -m
    repro_torch.mam_simulation --scale 0.002 --t-ms 300`` as a subprocess,
    its per-area spike counts bitwise those of the same function run on the
    CPU here meanwhile; (b) ``mam_spec(scale=0.2)`` built once with its
    outgoing tables, 50 ms of model time on four routes, bitwise equal, with
    ``overflow == 0``, and 10 ms on ``scatter``, bitwise ``pallas`` run as
    far; one window of ``pallas`` and of ``event`` profiled.
    Returns each route's kernel launches (counts reset just before each
    run, read just after)."""
    import os

    import numpy as np
    import torch

    from repro_torch import mam_simulation
    from repro_torch.core import EngineConfig, make_simulation, mam_spec
    from repro_torch.core.connectivity import add_outgoing_tables
    from repro_torch.kernels import cuda

    card = card_name_power()
    lif = dict(neuron_model="lif")
    # (a) The CLI on the card; the same run on the CPU while it runs.
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", MAM_CLI_WRAPPER, "--scale", "0.002", "--t-ms",
         str(MAM_CLI_T_MS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))  # the rest for the CLI's process
    try:
        host = mam_simulation.simulate(
            mam_spec(scale=0.002), EngineConfig(delivery_backend="scatter", **lif),
            device="cpu", t_ms=MAM_CLI_T_MS)
        out, err = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    cli_s = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.strip()]
    for ln in lines[:-2]:
        log(f"[mam] (a) {ln}")
    if proc.returncode != 0:
        log(err[-4000:])
        raise AssertionError(f"[mam] the driver's CLI exited {proc.returncode}")
    counts = np.asarray(json.loads(lines[-2].split(" ", 1)[1]))
    if host.counts.sum() <= 0 or not np.array_equal(counts, host.counts):
        raise AssertionError(f"[mam] the CLI's per-area spike counts on the card {counts} "
                             f"!= the CPU's {host.counts}")
    log(f"[mam] (a) the CLI on the card exit 0 in {cli_s:.1f} s (process start, build, run); "
        f"its per-area spike counts == the driver's on the CPU, bitwise ({int(counts.sum())} "
        f"spikes; the CPU run {host.wall_s:.1f} s wall) ({card})")

    # (b) The 32-area MAM at scale 0.2, built once, on five routes.
    spec = mam_spec(scale=MAM_SCALE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = mam_simulation.build_mam_network(spec, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    incoming_gb = _tables_gb(net, INCOMING)
    t0 = time.perf_counter()
    net = add_outgoing_tables(net)
    torch.cuda.synchronize()
    invert_s = time.perf_counter() - t0
    log(f"[mam] (b) mam_spec(scale={MAM_SCALE}): {spec.n_total} neurons in {spec.n_areas} "
        f"areas, n_pad {net.n_pad}, K {net.k_intra}/{net.k_inter}, K_out "
        f"{net.tgt_intra.shape[-1]}/{net.tgt_inter.shape[-1]}, ring {net.ring_len}; built on "
        f"the card in {build_s:.2f} s (incoming) + {invert_s:.2f} s (outgoing): "
        f"{incoming_gb:.2f} GB incoming, {_tables_gb(net, OUTGOING):.2f} GB outgoing tables, "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
    routes = {
        "scatter": (EngineConfig(delivery_backend="scatter", **lif), ()),
        "pallas": (EngineConfig(delivery_backend="pallas", fused_update=True, **lif),
                   ("lif_update", "spike_deliver")),
        "pallas superstep": (EngineConfig(delivery_backend="pallas", superstep_kernel=True,
                                          **lif), ("superstep_lif", "spike_deliver")),
        "event adaptive": (EngineConfig(delivery_backend="event", adaptive_exchange=True,
                                        **lif), ("event_deliver",)),
        "pallas conventional": (EngineConfig(delivery_backend="pallas",
                                             schedule="conventional", **lif),
                                ("lif_update", "spike_deliver")),
    }
    def same(res, ref) -> bool:
        st, st0 = res.state, ref.state
        return (np.array_equal(res.counts, ref.counts) and st.t == st0.t
                and bitwise_equal(st.ring, st0.ring) and all(
                    bitwise_equal(getattr(st.neuron, f), getattr(st0.neuron, f))
                    for f in ("v", "i_syn", "refrac")))

    launches, first = {}, None
    for name, (cfg, kernels) in routes.items():
        t_ms = MAM_SCATTER_T_MS if name == "scatter" else MAM_T_MS
        n_windows = spec.steps_for(t_ms) // spec.delay_ratio
        cuda.reset_launches()
        res = mam_simulation.simulate(spec, cfg, device="cuda", net=net, t_ms=t_ms)
        launches[name] = dict(cuda.launches)
        ran = {k: v for k, v in launches[name].items() if v}
        if res.overflow != 0:
            raise AssertionError(f"[mam] {name}: overflow {res.overflow}")
        if any(launches[name][k] <= 0 for k in kernels):
            raise AssertionError(f"[mam] {name}: a kernel of the route did not launch: {ran}")
        log(f"[mam] (b) {name}: {1e3 * res.wall_s / (n_windows - 1):.2f} ms/window, RTF "
            f"{res.wall_s / res.t_s:.2f} ({n_windows - 1} timed windows), "
            f"{int(res.counts.sum())} spikes, overflow 0, launches {ran}")
        if name == "scatter":
            as_far = mam_simulation.simulate(spec, routes["pallas"][0], device="cuda", net=net,
                                             t_ms=t_ms)
            if not same(res, as_far):
                raise AssertionError("[mam] scatter differs from pallas at its last window")
            log(f"[mam] (b) scatter == pallas run as far, bitwise: per-area spike counts, t "
                f"{res.state.t}, the ring and v / i_syn / refrac")
            continue
        if first is None:
            first, first_name = res, name
            continue
        if not same(res, first):
            raise AssertionError(f"[mam] {name} differs from {first_name} (counts, ring or state)")
    log(f"[mam] (b) the {len(routes) - 1} routes of {MAM_T_MS:g} ms bitwise equal: per-area "
        f"spike counts, t {first.state.t}, the final ring and v / i_syn / refrac, overflow 0")
    for ln in mam_simulation.report(spec, first):
        if ln.strip():
            log(f"[mam] (b) {first_name} | {ln.strip()}")
    for name in ("pallas", "event adaptive"):
        eng = make_simulation(spec, routes[name][0], net=net, device="cuda")
        eng.window(first.state)  # warm
        profile_window(f"mam x{MAM_SCALE} {name}", lambda: eng.window(first.state),
                       what=f"window {first.state.t // spec.delay_ratio}")
    del net, first, res, eng, as_far
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# [dryrun] (e): a priced call held to the card. The dry run's transient of
# a call (LiveBytes over the same rank's call on meta tensors) against
# torch.cuda.max_memory_allocated() during the call on the card, less the
# bytes allocated before it. The price may fall short of the measurement by
# at most the larger of 10% of it and 128 MiB: what the tracker cannot see
# (the caching allocator's rounding of each block to 512 B, cuBLAS's
# workspace on a handle's first use, a library's internal buffers).
PRICE_BAR_FRAC = 0.10
PRICE_BAR_BYTES = 128 * 2**20


def price_check(label: str, measured: int, priced: int) -> str:
    """[dryrun] (e)'s line for one call: ``measured`` bytes (the card's
    rise) beside the ``priced`` transient; raises where the price is under
    the measurement by more than the bar."""
    bar = max(PRICE_BAR_FRAC * measured, PRICE_BAR_BYTES)
    line = (f"[dryrun] (e) {label}: on the card {measured:,} B (max_memory_allocated during "
            f"the call less the bytes allocated before it), priced {priced:,} B (the dry "
            f"run's transient of the same rank's call on a MeshLayout), price - measured "
            f"{priced - measured:+,} B (bar: under by at most {bar:,.0f} B)")
    if measured - priced > bar:
        raise AssertionError(line + ": the price is under the card's measurement by more than "
                             "the bar")
    return line


# [dryrun] (d): the LM cells, priced on the host's CPU in a process of their
# own while the LM phases use the card; read at the end of the run.
DRYRUN_LM_ARGS = ["--arch", "qwen2-0.5b,grok-1-314b", "--shape", "all", "--mesh", "both",
                  "--hierarchical"]
DRYRUN_LM_TIMEOUT_S = 600
_dryrun_lm: dict = {}


def start_dryrun_lm() -> None:
    """Start (d), ``python -m repro_torch.launch.dryrun`` on qwen2-0.5b and
    grok-1 (every shape, both meshes, ``--hierarchical``), in the
    background; :func:`phase_dryrun_lm` reads it. The process is killed at
    exit if it still runs."""
    import atexit
    import os
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_lm_")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               OMP_NUM_THREADS="1")
    out = open(f"{tmp}/out.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_LM_ARGS, "--out",
         f"{tmp}/rows.json"], stdout=out, stderr=subprocess.STDOUT, env=env)
    out.close()
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    _dryrun_lm.update(proc=proc, tmp=tmp, t0=time.perf_counter() - _T0)


def phase_dryrun_lm() -> None:
    """``[dryrun]`` (d), started by :func:`start_dryrun_lm`: every row OK or
    SKIP, exit 0; per row the bytes a rank holds and gathers, the roofline
    terms and, hierarchical, the sync step's bytes against the sync
    trainer's per-step bytes."""
    import shutil

    proc, tmp = _dryrun_lm["proc"], _dryrun_lm["tmp"]
    t_wait = time.perf_counter()
    try:
        proc.wait(timeout=max(1.0, DRYRUN_LM_TIMEOUT_S - (time.perf_counter() - _T0
                                                          - _dryrun_lm["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"[dryrun] (d) did not end in {DRYRUN_LM_TIMEOUT_S} s")
    waited = time.perf_counter() - t_wait
    try:
        text = Path(f"{tmp}/out.log").read_text()
        for ln in text.splitlines():
            if ln.strip() and not ln.startswith("wrote"):
                log(f"[dryrun] (d) {ln.strip()}")
        if proc.returncode != 0:
            raise AssertionError(f"[dryrun] (d) exited {proc.returncode}")
        rows = json.loads(Path(f"{tmp}/rows.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [r["status"] for r in rows if r["status"] != "OK" and not r["status"].startswith("SKIP")]
    if bad or len(rows) != 16:
        raise AssertionError(f"[dryrun] (d) {len(rows)} rows, not all OK or SKIP: {bad}")
    card = card_name_power()
    for r in rows:
        if r["status"] != "OK":
            continue
        rb, terms = r["rank_bytes"], r["roofline"]
        parts = ", ".join(f"{k} {v:,}" for k, v in rb.items() if k not in ("held", "gathered"))
        line = (f"[dryrun] (d) [{r['mesh']}] {r['arch']} {r['shape']} {r['mode']}: a rank holds "
                f"{rb['held']:,} B ({parts}) and gathers {rb['gathered']:,} B a call; wire "
                f"{sum(e['bytes'] for e in r['collectives'].values()):,} B a call into a rank; "
                f"roofline on the H100 (989 TFLOP/s, 3.35 TB/s, NVLink 450 / network 50 GB/s): "
                f"compute {terms['compute_s']:.4g} s, memory {terms['memory_s']:.4g} s, "
                f"collective {terms['collective_s']:.4g} s, {r['dominant']}; useful FLOPs "
                f"{r['useful_flops_ratio']:.4f}")
        if "sync_step" in r:
            line += (f"; the sync step {r['sync_step']['bytes']:,} B every {r['sync_every']} "
                     f"steps ({r['sync_step']['bytes'] / r['sync_every']:,.0f} B a step) "
                     f"against the sync trainer's {r['sync_trainer_step']['bytes']:,} B "
                     f"every step")
        log(line)
    ok = sum(r["status"] == "OK" for r in rows)
    log(f"[dryrun] (d) exit 0: {ok} OK, {len(rows) - ok} SKIP (priced on the host's CPU, meta "
        f"tensors; the budget recorded, not gated: {rows[0].get('hbm_gib_budget')} GiB; {card})")
    log(f"[time] [dryrun] (d) ran in the background from {_dryrun_lm['t0']:.1f} s; the run "
        f"waited {waited:.1f} s for it here")


def phase_dryrun() -> None:
    """``[dryrun]``: (a) ``python -m repro_torch.launch.dryrun`` on both
    meshes on the card, the default onehot cells of both schedules with
    ``--build-rss``, recorded (``--hbm-gib 0``), and meanwhile in this
    process the structure-aware ``event`` cells (``dryrun_snn_cell``)
    gated at the card's memory: every row OK, each cell's held, transient
    and peak bytes logged; (b)
    the width bounds held against tables instantiated at [dist] (a)'s spec
    and cut (4 x 130,000, K 3000/3000, 2 groups x 2 lanes); (c)
    ``construction_cost_model``'s bytes for that cut beside the peak of one
    rank's sharded build on the card. (d), the LM cells, starts here in the
    background (:func:`start_dryrun_lm`)."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.core import connectivity as conn
    from repro_torch.core import mam_benchmark_spec
    from repro_torch.launch import dryrun

    start_dryrun_lm()
    card = card_name_power()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    # The default onehot cells on both schedules recorded (--hbm-gib 0: the
    # one-hot deposit's working set does not fit a card), through the CLI
    # with --build-rss; meanwhile, here, the structure-aware event cells (the
    # production delivery) gated at the card's memory. A conventional event
    # rank holds every area's outgoing intra tables (468 GiB): it fits no
    # card, transient or not.
    t0 = time.perf_counter()
    try:
        out = os.path.join(tmp, "rows.json")
        run = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mam-snn",
             "--snn-schedule", "conventional,structure_aware", "--mesh", "both", "--hbm-gib",
             "0", "--build-rss", "--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        try:
            budget = torch.cuda.mem_get_info()[1] / 2**30
            event = [dryrun.enforce_hbm_budget(
                dryrun.dryrun_snn_cell("structure_aware", multi_pod, backend="event"), budget)
                for multi_pod in (False, True)]
            stdout, stderr = run.communicate(timeout=600)
        finally:
            if run.poll() is None:
                run.kill()
                run.wait()
        for ln in stdout.splitlines():
            if ln.strip():
                log(f"[dryrun] (a) onehot {ln.strip()}")
        if run.returncode != 0:
            log(stderr[-4000:])
            raise AssertionError(f"[dryrun] (a) the onehot dry run exited {run.returncode}")
        rows = {"onehot": json.loads(Path(out).read_text()), "event": event}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, n_rows in (("onehot", 7), ("event", 2)):
        if len(rows[name]) != n_rows or any(r["status"] != "OK" for r in rows[name]):
            raise AssertionError(f"[dryrun] (a) {name} rows not all OK: "
                                 f"{[r['status'] for r in rows[name]]}")
    for name, cells in rows.items():
        for r in cells:
            if "wire_bytes_window" in r:
                rb = r["rank_bytes"]
                log(f"[dryrun] (a) {name} [{r['mesh']}] {r['shape']}: a rank holds "
                    f"{rb['total']:,} B (tables {rb['tables']:,}, state {rb['state']:,}), a "
                    f"window's transient {rb['transient']:,} B (output {rb['output']:,}), peak "
                    f"{rb['peak']:,} B = {rb['peak'] / 2**30:.2f} GiB "
                    f"({'gated' if name == 'event' else 'recorded, not gated'})")
    log(f"[dryrun] (a) exit 0 in {time.perf_counter() - t0:.1f} s, {len(rows['onehot'])} onehot "
        f"rows OK (recorded), {len(rows['event'])} event rows OK within the card's memory, "
        f"{budget:.2f} GiB a rank ({card})")

    # (b) The width bounds against tables instantiated on the card.
    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000, k_inter=3000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    row = dryrun.verify_inter_table_bounds(2, 2, 12, spec=spec, device="cuda")
    torch.cuda.synchronize()
    cut_peak = torch.cuda.max_memory_allocated()
    log(f"[dryrun] (b) width bounds at 4 x 130000, K 3000/3000, 2 groups x 2 lanes: lead "
        f"axes and delay dtypes equal, bounds >= the instantiated widths; one rank's inbound "
        f"slice {row['bytes_per_device_modelled']} B at the bound against "
        f"{row['bytes_per_device_instantiated']} B instantiated (slack {row['bound_slack']}x), "
        f"lane intra width slack {row['intra_bound_slack']}x; built and cut in "
        f"{time.perf_counter() - t0:.1f} s, peak {cut_peak / 1e9:.2f} GB ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The construction model beside one rank's sharded build.
    cm = conn.construction_cost_model(spec, n_shards=2, subgroup=2, size_multiple=8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = conn.sharded_build_plan(spec, 12, 2, mode="group", subgroup=2, size_multiple=8,
                                   device="cuda")
    tables = (conn.build_shard_tables(spec, 12, 0, plan=plan, lane=0, device="cuda")
              + conn.build_lane_intra_tables(spec, 12, [0, 1], 0, plan=plan, device="cuda"))
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in tables)
    log(f"[dryrun] (c) construction at that cut, modelled (construction_cost_model, the "
        f"reference's host build): {cm['build_bytes_host_modelled'] / 1e9:.2f} GB for the "
        f"host build, {cm['build_bytes_shard_modelled'] / 1e9:.2f} GB for a shard's; "
        f"measured on the card: one rank's sharded build (plan, its inbound slice and lane "
        f"intra tables) holds {held / 1e9:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} "
        f"s; the cuts of (b), one after the other, peak {cut_peak / 1e9:.2f} GB")
    del tables, plan
    gc.collect()
    torch.cuda.empty_cache()


def profile_window(name, fn, what="window") -> list[tuple[float, int, str]]:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the share of its wall time the device was busy; returns the kernels as
    (device us, count, name), longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    log(f"[profile] {name}: {what} {wall_us / 1e3:.2f} ms wall, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), {len(kernels)} kernel kinds")
    for i, (us, count, key) in enumerate(kernels):
        if i < 6 or any(sym in key for sym in PORT_KERNEL_SYMBOLS):
            log(f"[profile]   {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    return kernels


def _port_kernel_time(kernels, symbol) -> tuple[float, int]:
    """Device us and launches of the profiled kernels whose name holds ``symbol``."""
    hits = [(us, count) for us, count, key in kernels if symbol in key]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def event_packets(net, block, t0: int, *, adaptive: bool) -> dict:
    """The packets the event engine makes from a fired window ``block``
    ``[D, A, n]`` emitted from step ``t0``: the window-end inter packets
    ``[D, S_all]`` and the busiest cycle's intra packets ``[A, S_area]``,
    sized by the static bounds of ``EngineConfig``'s defaults, or (with
    ``adaptive``) by the rungs of the adaptive ladders that the counts
    select, as ``LocalExchange`` sizes them. Returns ``{name: (ids,
    pathway, rows_per_area, t)}``."""
    import torch

    from repro_torch.core import EngineConfig
    from repro_torch.core.exchange import LocalExchange
    from repro_torch.kernels import ops

    dev = net.device
    a, n = net.alive.shape
    ex = LocalExchange(net, EngineConfig(delivery_backend="event", adaptive_exchange=adaptive))
    flat = block.reshape(block.shape[0], -1)
    counts = flat.sum(-1, dtype=torch.int32)
    busiest = int(counts.argmax())
    s_all, s_area = ex.s_max_all, ex.s_max_area
    if adaptive:
        s_all = ops.ladder_rung(ex.ladder_all, counts.max())
        per_area = block[busiest].sum(-1, dtype=torch.int32)
        s_area = ops.ladder_rung(ex.ladder_area, per_area.max())
    inter, _ = ops.compact_ids_block(flat, torch.arange(a * n, device=dev), size=s_all,
                                     fill_id=a * n)
    intra, _ = ops.compact_ids_block(block[busiest], torch.arange(n, device=dev),
                                     size=s_area, fill_id=n)
    return {"inter": (inter, "inter", None, t0), "intra": (intra, "intra", n, t0 + busiest)}


def event_adds(ring, ids, tables, per_area, t):
    """What a scatter of the packets ``ids`` adds into ``ring [N, R]``: the
    fired entries' table rows (found here, outside any timing), and a
    function that gathers the flat ring indices and weights of all their
    K_out columns with static shapes and no host sync. A padding column
    adds +0.0 at a ring position of its own, a no-op, since rings never hold
    -0.0, and one that does not queue on a single address. Returns
    ``(src_rows, gather)``; ``gather()`` returns ``(flat_idx, vals, hit)``."""
    import torch

    tgt, w, d = tables
    dev, (n_rows, r), k = ring.device, ring.shape, tgt.shape[1]
    n_src = per_area or tgt.shape[0]
    n_tgt = per_area or n_rows
    row = torch.arange(ids.shape[0], device=dev)[:, None].expand(ids.shape)
    real = (ids >= 0) & (ids < n_src)
    row = row[real]
    src_rows = ids[real].long() + (row * per_area if per_area else 0)
    off = (row * per_area)[:, None] if per_area else 0
    step = 0 if per_area else row[:, None]
    spread = torch.arange(src_rows.numel() * k, device=dev).view(-1, k) % ring.numel()

    def gather():
        tg = tgt[src_rows].long()
        hit = (tg >= 0) & (tg < n_tgt)
        idx = (tg + off) * r + torch.remainder(t + step + d[src_rows].long(), r)
        return (torch.where(hit, idx, spread).view(-1),
                torch.where(hit, w[src_rows], 0.0).view(-1), hit)

    return src_rows, gather


def event_bound(ring, ids, tables, per_area, t, red_rate) -> dict:
    """The least time a scatter of the packets ``ids`` could take: the
    packets, the fired rows' ``tgt``, ``w``/``d`` of the delivered synapses,
    and 64 bytes (read and written once) per distinct 32-byte ring sector
    the adds touch, over the memory rate. ``reds_ms``, the delivered
    reductions over ``red_rate`` (the L2's, measured), is the ceiling of a
    kernel that reduces each synapse on its own into the L2, as this one
    does, not a bound of the function: adds to one sector could be combined
    before they reach the L2. ``old_bound_ms`` is the earlier bound, 32
    bytes of ring per delivered synapse. Also the counts, and ``gather``
    (``event_adds``)."""
    import torch

    tgt, _, d = tables
    src_rows, gather = event_adds(ring, ids, tables, per_area, t)
    idx, _, hit = gather()
    synapses = int(hit.sum())
    sectors = int(torch.unique(idx.view(hit.shape)[hit] // 8).numel())
    del idx, hit
    table_bytes = (ids.numel() * 4 + src_rows.numel() * tgt.shape[1] * 4
                   + synapses * (4 + d.element_size()))
    bytes_ms = (table_bytes + 64 * sectors) / HBM_BYTES_PER_S * 1e3
    reds_ms = synapses / red_rate * 1e3
    return dict(bound_ms=bytes_ms, bound_by="bytes", reds_ms=reds_ms,
                old_bound_ms=(table_bytes + 32 * synapses) / HBM_BYTES_PER_S * 1e3,
                fired=src_rows.numel(), synapses=synapses, sectors=sectors, gather=gather)


def bound_note(b, ms) -> str:
    return (f"bound {b['bound_ms']:.4f} ms by bytes, {100 * b['bound_ms'] / ms:.1f}% of it; "
            f"one L2 RED a synapse {b['reds_ms']:.4f} ms, {100 * b['reds_ms'] / ms:.1f}% of it; "
            f"the earlier bound, 32 B of ring a synapse, {b['old_bound_ms']:.4f} ms, "
            f"{100 * b['old_bound_ms'] / ms:.1f}% of it")


def red_rates(net, flush) -> dict:
    """Reductions per second: the ``red_probe`` of csrc/event_deliver.cu,
    2,048 threads per SM x 64 f32 REDs each at pseudo-random positions,
    into a buffer of one slice of the event kernel (a quarter of the L2,
    left in the L2 between windows) and into one of the ring's size (the L2
    flushed before each window)."""
    import torch

    from repro_torch.kernels import event_deliver as evt

    dev = net.device
    r = net.ring_len
    threads = torch.cuda.get_device_properties(dev).multi_processor_count * 2048
    adds = 64
    slice_rows = evt.slice_rows(r, dev)
    out = dict(slice_rows=slice_rows, slice_mb=slice_rows * r * 4 / 1e6, reds=threads * adds)
    sizes = (("l2", slice_rows * r, None), ("dram", net.alive.numel() * r, flush))
    for name, numel, fl in sizes:
        buf = torch.zeros(numel, dtype=torch.float32, device=dev)
        ms = time_ms(lambda: evt.red_probe(buf, adds, threads), flush=fl)
        out[name] = threads * adds / (ms * 1e-3)
        out[f"{name}_ms"] = ms
        del buf
    log(f"[kernel] event_deliver yardstick, RED rate (red_probe, {threads * adds} f32 "
        f"reductions at random positions): into one slice ({out['slice_mb']:.1f} MB, "
        f"{slice_rows} ring rows, in the L2) {out['l2'] / 1e9:.1f} G/s "
        f"({out['l2_ms']:.4f} ms); "
        f"into a ring-sized buffer ({numel * 4 / 1e6:.0f} MB, from DRAM) "
        f"{out['dram'] / 1e9:.1f} G/s ({out['dram_ms']:.4f} ms)")
    return out


# Where the kernel switches regime: the steady inter packets keep 1 in
# `keep` of their fired entries (15.3 adds per ring sector at keep 1, so
# ~0.5-7.6 below), the steady intra ones (1.6 at keep 1, ~0.2-0.8 below);
# the iaf packets as they are.
REGIME_KEEPS = {("steady", "inter"): (32, 16, 12, 8, 4, 2, 1),
                ("steady", "intra"): (8, 4, 3, 2, 1), ("iaf", "inter"): (1,),
                ("iaf", "intra"): (1,)}


def regime_lines(net, windows: dict, tables: dict, flush) -> list[dict]:
    """The scatter's two regimes, forced by a build of each
    (``event_deliver_forced``), beside the kernel's own choice, on packets
    thinned to fewer fired entries (``REGIME_KEEPS``), packed to the front
    of each row as the engine packs them: each bitwise the
    plain version, each timed (median of 20). Adds per sector count the
    delivered synapses over all of the ring's 32-byte sectors, as the
    kernel's choice does."""
    import torch

    from repro_torch.kernels import event_deliver as evt

    a, n = net.alive.shape
    r = net.ring_len
    out = []
    for run, (block, ring, t0, adaptive) in windows.items():
        cases = event_packets(net, block, t0, adaptive=adaptive)
        ring = ring.view(a * n, r)
        scratch = ring.clone()
        for pathway, (ids, _, per_area, t) in cases.items():
            tgt, w, d = tables[pathway]
            kw = dict(rows_per_area=per_area)
            pad = per_area or a * n
            real = (ids >= 0) & (ids < pad)
            rank = real.cumsum(1)
            for keep in REGIME_KEEPS[run, pathway]:
                # 1 in `keep` of each row's fired entries, first in the row,
                # as the engine packs a packet of fewer spikes.
                kept = real & (rank % keep == 0)
                order = torch.sort((~kept).to(torch.int8), dim=1, stable=True).indices
                pk = torch.where(kept.gather(1, order), ids.gather(1, order),
                                 torch.full_like(ids, pad))
                src_rows, _ = event_adds(ring, pk, tables[pathway], per_area, t)
                synapses = int((tgt[src_rows] >= 0).sum())
                want = evt.event_deliver_plain(ring.clone(), pk, tgt, w, d, t, **kw)
                ms = {}
                for regime in ("auto", *evt.REGIMES):
                    fn = (evt.event_deliver_cuda if regime == "auto" else
                          lambda *x, regime=regime, **y: evt.event_deliver_forced(regime, *x, **y))
                    if not bitwise_equal(fn(ring.clone(), pk, tgt, w, d, t, **kw), want):
                        raise AssertionError(f"event_deliver {regime} ({run} {pathway}, 1 in "
                                             f"{keep} entries) != plain version")
                    ms[regime] = time_ms(lambda: fn(scratch, pk, tgt, w, d, t, **kw),
                                         flush=flush)
                del want
                per_sector = synapses / (ring.numel() / 8)
                best = min(ms["sliced"], ms["unsliced"])
                log(f"[kernel] event_deliver regimes, {run} {pathway} 1 in {keep} fired entries "
                    f"({src_rows.numel()} sources, {synapses} synapses, {per_sector:.2f} adds a "
                    f"ring sector): sliced {ms['sliced']:.4f} ms, unsliced "
                    f"{ms['unsliced']:.4f} ms, the kernel's choice {ms['auto']:.4f} ms "
                    f"({100 * (ms['auto'] / best - 1):+.1f}% on the faster); bitwise == plain")
                out.append(dict(packets=f"{run} {pathway}", keep=keep, adds_per_sector=per_sector,
                                **{f"{k}_ms": v for k, v in ms.items()}))
        del scratch
    return out


def phase_kernel_event(net, windows: dict, launches: dict) -> dict:
    """event_deliver against its plain version at full width, bitwise, on
    the packets the engine makes (``event_packets``) from fired windows:
    ``windows`` maps a name to ``(block, ring, t0, adaptive)``, the iaf
    run's last window (2.5 Hz, static packets) and LIF's steady state (~70
    Hz, adaptive packets); then the iaf inter packets with every kind of
    padding. Timed beside its bound, the plain version and the library's
    scatter of the same adds (the gather of flat indices and weights from
    the packets' table rows and ``index_add_``, timed together).

    The bound: the packets, the fired rows' ``tgt``, ``w``/``d`` of the
    delivered synapses, and 64 bytes (read and written once) per distinct
    32-byte ring sector the adds touch, over the memory rate. Beside it the
    ceiling of one reduction a synapse, the delivered synapses over the L2's
    measured RED rate (``red_rates``), and the earlier bound (32 bytes of
    ring per delivered synapse).

    Then the kernel's two regimes on thinned packets (``regime_lines``)."""
    import torch

    from repro_torch.kernels import event_deliver as evt

    dev = net.device
    a, n = net.alive.shape
    r = net.ring_len
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rates = red_rates(net, flush)
    flat = lambda x: x.view(a * n, -1)  # noqa: E731
    tables = {p: (flat(getattr(net, f"tgt_{p}")), flat(getattr(net, f"wout_{p}")),
                  flat(getattr(net, f"dout_{p}"))) for p in ("intra", "inter")}
    timings = {}
    for run, (block, ring, t0, adaptive) in windows.items():
        cases = event_packets(net, block, t0, adaptive=adaptive)
        ring = ring.view(a * n, r)
        scratch = ring.clone()  # timing runs scatter into it, in place
        for pathway, (ids, _, per_area, t) in cases.items():
            name = f"{run} {pathway}"
            tgt, w, d = tables[pathway]
            kw = dict(rows_per_area=per_area)
            got = evt.event_deliver_cuda(ring.clone(), ids, tgt, w, d, t, **kw)
            want = evt.event_deliver_plain(ring.clone(), ids, tgt, w, d, t, **kw)
            if not bitwise_equal(got, want):
                raise AssertionError(f"event_deliver ({name}) kernel != plain version: "
                                     f"{int((got != want).sum())} ring entries differ")
            err = max_abs_err(got, want)
            del got, want
            b = event_bound(ring, ids, tables[pathway], per_area, t, rates["l2"])
            ms = time_ms(lambda: evt.event_deliver_cuda(scratch, ids, tgt, w, d, t, **kw),
                         flush=flush)
            plain_ms = time_ms(
                lambda: evt.event_deliver_plain(scratch, ids, tgt, w, d, t, **kw),
                reps=3 if adaptive else 20, flush=flush, host_paced_ok=True)

            def library():
                idx, vals, _ = b["gather"]()
                scratch.view(-1).index_add_(0, idx, vals)

            library_ms = time_ms(library, reps=10 if adaptive else 20, flush=flush,
                                 host_paced_ok=True)
            log(f"[kernel] event_deliver {name} packets {list(ids.shape)}, K_out "
                f"{tgt.shape[1]}: bitwise == plain; {b['fired']} fired sources, "
                f"{b['synapses']} synapses into {b['sectors']} ring sectors "
                f"({b['synapses'] / max(b['sectors'], 1):.2f} adds a sector); {ms:.4f} ms, "
                f"{b['synapses'] / ms / 1e6:.2f} G synapses/s ({bound_note(b, ms)}), "
                f"plain {plain_ms:.3f} ms, gather + index_add_ of the same adds "
                f"{library_ms:.4f} ms")
            timings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, err=err,
                                 **{k: v for k, v in b.items() if k != "gather"})
            del b
        del scratch

    # Every kind of padding, on the inter packets of each window (the
    # kernel streams whole rows at 2.5 Hz and slices the ring at ~70 Hz).
    for run, (block, ring, t0, adaptive) in windows.items():
        ids = event_packets(net, block, t0, adaptive=adaptive)["inter"][0].clone()
        ids[0, :4] = torch.tensor([-1, a * n, a * n + 7, 2**31 - 1], dtype=torch.int32)
        ids[1, :] = a * n                      # a row of padding only
        ids[2, :3] = ids[3, 0]                 # one source three times
        tgt, w, d = tables["inter"]
        ring = ring.view(a * n, r)
        got = evt.event_deliver_cuda(ring.clone(), ids, tgt, w, d, t0)
        if not bitwise_equal(got, evt.event_deliver_plain(ring.clone(), ids, tgt, w, d, t0)):
            raise AssertionError(f"event_deliver ({run}, every padding) kernel != plain version")
        real = int(((ids >= 0) & (ids < a * n)).sum())
        log(f"[kernel] event_deliver {run} inter, every padding: bitwise == plain ({real} "
            f"real ids of {ids.numel()})")
        del got
    regimes = regime_lines(net, windows, tables, flush)
    t = timings["iaf inter"]
    extra = {name.replace(" ", "_"): {k: v for k, v in x.items() if k != "err"}
             for name, x in timings.items() if name != "iaf inter"}
    return dict(
        name="event_deliver", route="cuda", source="src/repro_torch/kernels/csrc/event_deliver.cu",
        replaces="src/repro/kernels/ops.py:244 (jnp scatter; no Pallas counterpart)",
        launches=launches["event_deliver"], max_abs_err=max(x["err"] for x in timings.values()),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], checked=True, red_rates=rates, regimes=regimes, **extra)


def phase_kernels(net, launches: dict, lif_profile_us: dict) -> list[dict]:
    """Each kernel against its plain version on the card, and timed;
    ``lif_profile_us`` holds lif_update's profiled us per launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import lif_update as lif
    from repro_torch.kernels import spike_deliver as dlv
    from repro_torch.core.neuron import LIFParams

    dev = net.device
    rng = np.random.default_rng(0)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []

    # lif_update at the main path's N, state around threshold with refractory lanes.
    n = net.alive.numel()
    p = LIFParams()
    kw = dict(p11=p.p11, p21=p.p21, p22=p.p22, v_th=p.v_th_mv,
              v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps)
    args = tuple(torch.from_numpy(x).to(dev) for x in (
        rng.normal(14.0, 2.0, n).astype(np.float32),
        rng.normal(0.0, 300.0, n).astype(np.float32),
        rng.integers(0, 4, n).astype(np.int32),
        rng.normal(0.0, 200.0, n).astype(np.float32),
        rng.random(n) < 0.95))
    got = lif.lif_update_cuda(*args, **kw)
    want = lif.lif_update_plain(*args, **kw)
    if not all(bitwise_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("lif_update kernel != plain version")
    err = max(max_abs_err(g.float(), w.float()) for g, w in zip(got, want))
    ms = time_ms(lambda: lif.lif_update_cuda(*args, **kw), reps=100, flush=flush)
    paced_ms = time_ms_host_paced(lambda: lif.lif_update_cuda(*args, **kw), reps=100,
                                  flush=flush)
    # The floor of one timed launch: the same timer around a 4-neuron launch.
    tiny = tuple(x[:4] for x in args)
    floor_ms = time_ms(lambda: lif.lif_update_cuda(*tiny, **kw), reps=100, flush=flush)
    plain_ms = time_ms(lambda: lif.lif_update_plain(*args, **kw), reps=100, flush=flush,
                       host_paced_ok=True)
    nbytes = 30 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 6 * n / F32_OPS_PER_S) * 1e3
    log(f"[kernel] lif_update N={n}: bitwise == plain; {ms:.4f} ms "
        f"(bound {bound_ms:.4f} ms by bytes, {100 * bound_ms / ms:.1f}% of it, "
        f"{nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms; the host-paced timer "
        f"reads {paced_ms:.4f} ms in this call; a 4-neuron launch reads "
        f"{floor_ms:.4f} ms (the floor of one timed launch)")
    log(f"[kernel] lif_update in the profiled unfused LIF window (CUPTI): "
        f"{lif_profile_us['lif_update']:.2f} us per launch")
    rows.append(dict(
        name="lif_update", route="cuda", source="src/repro_torch/kernels/csrc/lif_update.cu",
        replaces="src/repro/kernels/lif_update.py:77", launches=launches["lif_update"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None, checked=True, host_paced_ms=paced_ms,
        launch_floor_ms=floor_ms))

    # spike_deliver on the full tables, spike vector at ~1% density.
    a, n_pad = net.alive.shape
    spikes = torch.from_numpy((rng.random(a * n_pad) < 0.01).astype(np.float32)).to(dev)
    timings = {}
    for pathway in ("intra", "inter"):
        k = getattr(net, f"k_{pathway}")
        src = getattr(net, f"src_{pathway}").view(a * n_pad, k)
        w = getattr(net, f"w_{pathway}").view(a * n_pad, k)
        delay = getattr(net, f"delay_{pathway}").view(a * n_pad, k)
        kw = dict(steps_lo=getattr(net, f"steps_lo_{pathway}"),
                  r_span=getattr(net, f"r_span_{pathway}"))
        if pathway == "intra":
            kw.update(rows_per_area=n_pad, src_stride=n_pad)
        got = dlv.spike_deliver_cuda(spikes, src, w, delay, **kw)
        want = dlv.spike_deliver_plain(spikes, src, w, delay, **kw)
        if not bitwise_equal(got, want):
            raise AssertionError(f"spike_deliver ({pathway}) kernel != plain version")
        err = max_abs_err(got, want)
        ms = time_ms(lambda: dlv.spike_deliver_cuda(spikes, src, w, delay, **kw))
        plain_ms = time_ms(lambda: dlv.spike_deliver_plain(spikes, src, w, delay, **kw),
                           host_paced_ok=True)
        # Bytes this data needs: all of src, w and delay of the synapses whose
        # source spiked, the spike vector and the output.
        active = _active_synapses(spikes, src, n_pad if pathway == "intra" else None)
        nbytes = (src.numel() * 4 + active * (4 + delay.element_size())
                  + spikes.numel() * 4 + got.numel() * 4)
        dense_bytes = src.numel() * (8 + delay.element_size()) + got.numel() * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * active / F32_OPS_PER_S) * 1e3
        log(f"[kernel] spike_deliver {pathway} [{a * n_pad}, {k}] r_span {kw['r_span']}: "
            f"bitwise == plain; {active} active synapses; {ms:.3f} ms (bound "
            f"{bound_ms:.3f} ms by bytes, {nbytes / ms / 1e6:.0f} GB/s of needed bytes; "
            f"all-table bound {dense_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms), "
            f"plain {plain_ms:.3f} ms")
        timings[pathway] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, err=err)
    # One row for the kernel, at the inter call (the larger delay window);
    # the intra call's numbers are on the line above.
    t = timings["inter"]
    rows.append(dict(
        name="spike_deliver", route="cuda",
        source="src/repro_torch/kernels/csrc/spike_deliver.cu",
        replaces="src/repro/kernels/spike_deliver.py:63",
        launches=launches["spike_deliver"], max_abs_err=max(
            timings["intra"]["err"], t["err"]),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by="bytes", library_ms=None, checked=True,
        intra=dict(ms=timings["intra"]["ms"], plain_ms=timings["intra"]["plain_ms"],
                   bound_ms=timings["intra"]["bound_ms"])))
    rows += _superstep_rows(net, launches, rng, flush)
    return rows


def _superstep_rows(net, launches: dict, rng, flush) -> list[dict]:
    """The fused superstep kernels against their plain versions on the
    full-width intra tables, with states drawn so that many lanes spike."""
    import numpy as np
    import torch

    from repro_torch.core.neuron import LIFParams
    from repro_torch.kernels import cuda
    from repro_torch.kernels import cycle as cyc

    dev = net.device
    a, n, k = net.src_intra.shape
    d_win, lo, span = net.delay_ratio, net.steps_lo_intra, net.r_span_intra
    tables = (net.src_intra, net.w_intra, net.delay_intra)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    # On the 1/256 grid, without -0.0: the engine's rings never hold one
    # (csrc/deposit.cuh), and a row that receives nothing keeps its zeros.
    fut0 = t((np.round(rng.normal(0, 300, (a, n, net.live_window)) * 4) / 1024 + 0.0)
             .astype(np.float32))
    scratch = fut0.clone()  # timing runs deposit into it, in place
    delay_b = net.delay_intra.element_size()
    src_bytes = n * k * 4  # one area's rows of src
    fut_bytes = 2 * 4 * a * n * net.live_window  # fut read and written once
    rows = []

    def check_and_time(name, kernel, plain, args, kw):
        got = kernel(*args(fut0.clone()), **kw)
        want = plain(*args(fut0.clone()), **kw)
        if not all(bitwise_equal(g, w) for g, w in zip(got, want)):
            again = kernel(*args(fut0.clone()), **kw)
            raise AssertionError(
                f"{name} kernel != plain version: elements that differ "
                f"{[int((g != w).sum()) for g, w in zip(got, want)]}; a second launch "
                f"{'agrees' if all(map(bitwise_equal, got, again)) else 'differs'}")
        err = max(max_abs_err(g.float(), w.float()) for g, w in zip(got, want))
        ms = time_ms(lambda: kernel(*args(scratch), **kw), reps=10, flush=flush)
        # ~0.85 s a call whose enqueue blocks on the launch queue: host-paced
        # (time_ms fell back to it in every earlier call), 1 + 3 calls
        plain_ms = time_ms_host_paced(lambda: plain(*args(scratch), **kw), reps=3,
                                      flush=flush, warm=1)
        return want, err, ms, plain_ms

    # LIF: membrane potentials spread below threshold and strong synaptic
    # currents, so neurons cross threshold in every cycle of the window.
    p = LIFParams()
    state = (t(rng.uniform(0, 15, (a, n)).astype(np.float32)),
             t(rng.normal(6000, 2000, (a, n)).astype(np.float32)),
             t(rng.integers(0, 25, (a, n)).astype(np.int32)))
    drive_p = t(rng.uniform(0, 0.5, (a, n)).astype(np.float32))
    gids = torch.arange(a * n, dtype=torch.int32, device=dev).view(a, n)
    kw = dict(d_win=d_win, steps_lo=lo, r_span=span, p11=p.p11, p21=p.p21, p22=p.p22,
              v_th=p.v_th_mv, v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps,
              seed=42, w_ext=87.75)
    want, err, ms, plain_ms = check_and_time(
        "superstep_lif", cyc.superstep_lif_cuda, cyc.superstep_lif_plain,
        lambda fut: (*state, fut, drive_p, gids, net.alive, *tables, 1230), kw)
    spikes = want[4]
    per_cycle = [int(x) for x in spikes.sum(dim=(1, 2))]
    if min(per_cycle) <= 0:
        raise AssertionError(f"superstep_lif check: a cycle without spikes {per_cycle}")
    # Bytes this data needs: per cycle, src of every area that spiked, w and
    # delay of the synapses whose source spiked; the state (21 B in, 12 B out
    # per neuron), the spikes and fut once.
    areas = int(spikes.any(dim=2).sum())
    active = sum(_active_synapses(spikes[s].reshape(-1).float(), net.src_intra.view(a * n, k),
                                  n) for s in range(d_win))
    nbytes = areas * src_bytes + active * (4 + delay_b) + a * n * (33 + d_win) + fut_bytes
    bound_ms = max(nbytes / HBM_BYTES_PER_S, active / F32_OPS_PER_S) * 1e3
    log(f"[kernel] superstep_lif [{a}, {n}, {k}] D {d_win} W {net.live_window}: bitwise == "
        f"plain; spikes per cycle {per_cycle}, {active} active synapse-cycles; {ms:.3f} ms "
        f"(bound {bound_ms:.3f} ms by bytes, {nbytes / ms / 1e6:.0f} GB/s of needed bytes), "
        f"plain {plain_ms:.3f} ms (host-paced, median of 3)")
    rows.append(dict(
        name="superstep_lif", route="cuda", source="src/repro_torch/kernels/csrc/superstep_lif.cu",
        replaces="src/repro/kernels/cycle.py:131", launches=launches["superstep_lif"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None, checked=True))

    # Ignore-and-fire at two densities: phases spread over 200 cycles and
    # intervals of 1-12, so ~5% of the neurons fire in the window, some of
    # them several times; and the main path's 2.5 Hz (interval 4000 steps,
    # phases over the whole interval), so ~0.25% fire once.
    timed = {}
    for regime, phases, intervals in (("5%", (0, 200), (1, 13)),
                                      ("main path 2.5 Hz", (0, 4000), (4000, 4001))):
        countdown = t(rng.integers(*phases, (a, n)).astype(np.int32))
        interval = t(rng.integers(*intervals, (a, n)).astype(np.int32))
        kw = dict(d_win=d_win, steps_lo=lo, r_span=span)
        want, err, ms, plain_ms = check_and_time(
            "superstep_iaf", cyc.superstep_iaf_cuda, cyc.superstep_iaf_plain,
            lambda fut: (countdown, fut, interval, net.alive, *tables), kw)
        spikes = want[2]
        per_cycle = [int(x) for x in spikes.sum(dim=(1, 2))]
        if min(per_cycle) <= 0:
            raise AssertionError(f"superstep_iaf check ({regime}): a cycle without spikes "
                                 f"{per_cycle}")
        # Bytes: all of src once; w, delay and the source's pattern of every
        # synapse whose source spiked in the window; the state (13 B per
        # neuron), the spikes and fut once.
        fired = spikes.any(dim=0).reshape(-1).float()
        active = _active_synapses(fired, net.src_intra.view(a * n, k), n)
        nbytes = a * src_bytes + active * (8 + delay_b) + a * n * (13 + d_win) + fut_bytes
        bound_ms = max(nbytes / HBM_BYTES_PER_S, active / F32_OPS_PER_S) * 1e3
        log(f"[kernel] superstep_iaf [{a}, {n}, {k}] D {d_win}, {regime}: bitwise == plain; "
            f"{100 * float(fired.mean()):.2f}% of sources fire, spikes per cycle {per_cycle}, "
            f"{active} active synapses; {ms:.3f} ms (bound {bound_ms:.3f} ms by bytes, "
            f"{100 * bound_ms / ms:.1f}% of it, {nbytes / ms / 1e6:.0f} GB/s of needed "
            f"bytes), plain {plain_ms:.3f} ms (host-paced, median of 3)")
        timed[regime] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, err=err)
    # A yardstick for the stream: one library reduction that reads all of
    # src once, in its own int32 (a widening sum is much slower).
    stream_ms = time_ms(lambda: net.src_intra.amax(), reps=10, flush=flush)
    log(f"[kernel] superstep_iaf yardstick: torch.amax over src ({a * src_bytes / 1e9:.2f} GB) "
        f"{stream_ms:.3f} ms, {a * src_bytes / stream_ms / 1e6:.0f} GB/s")
    lib = cuda.library("superstep_iaf")
    log(f"[kernel] superstep_iaf deposit at N={a * n}: "
        f"{lib.superstep_iaf_smem_bytes(a * n, d_win, span)} bytes of dynamic shared memory, "
        f"bitmask {'in shared memory' if lib.superstep_iaf_mask_in_smem(a * n, d_win, span) else 'read through L2'}"
        f" (registers and spills: [build] lines)")
    # The row is the 5% shape; the main path's density is beside it.
    five, main = timed["5%"], timed["main path 2.5 Hz"]
    rows.append(dict(
        name="superstep_iaf", route="cuda", source="src/repro_torch/kernels/csrc/superstep_iaf.cu",
        replaces="src/repro/kernels/cycle.py:183", launches=launches["superstep_iaf"],
        max_abs_err=max(five["err"], main["err"]), ms=five["ms"], plain_ms=five["plain_ms"],
        bound_ms=five["bound_ms"], bound_by="bytes", library_ms=None, checked=True,
        main_path_density={k: main[k] for k in ("ms", "plain_ms", "bound_ms")}))
    return rows


def _active_synapses(spikes, src, rows_per_area) -> int:
    """Synapses whose source spike is nonzero (row chunks)."""
    import torch

    total, n = 0, src.shape[0]
    for r0 in range(0, n, 65536):
        r1 = min(n, r0 + 65536)
        idx = src[r0:r1].long()
        if rows_per_area is not None:
            area = torch.arange(r0, r1, device=src.device) // rows_per_area
            idx = idx + (area * rows_per_area)[:, None]
        total += int((spikes[idx] != 0).sum())
    return total


def phase_device_vs_cpu() -> dict:
    """The port on the card against the port on the CPU, bitwise: the
    ``pallas`` configs, and the ``event`` configs (static, adaptive,
    adaptive + overlap through run_windows, and forced overflow, whose
    ``overflow`` count must agree too)."""
    import torch

    from repro_torch.core import EngineConfig, build_network, make_simulation, run_windows
    from repro_torch.core import mam_benchmark_spec
    from repro_torch.kernels import cuda

    configs = [("pallas " + name, dict(delivery_backend="pallas", **kw)) for name, kw in (
        ("conventional", dict(schedule="conventional")), ("structure_aware", {}),
        ("structure_aware fused", dict(superstep_kernel=True)))]
    configs += [("event " + name, dict(delivery_backend="event", **kw)) for name, kw in (
        ("conventional", dict(schedule="conventional")), ("structure_aware", {}),
        ("structure_aware legacy", dict(superstep=False)),
        ("structure_aware fused", dict(superstep_kernel=True)),
        ("structure_aware adaptive", dict(adaptive_exchange=True)),
        ("structure_aware adaptive overlap", dict(adaptive_exchange=True,
                                                  overlap_exchange=True)))]
    # Massed firing (interval 5 steps) past packets of 1 per area and 4 per
    # network: the static bounds drop spikes, and both devices count them.
    forced = [("event " + name + " forced overflow", dict(
        delivery_backend="event", s_max_headroom=0.0, s_max_floor=1, **kw)) for name, kw in (
        ("conventional", dict(schedule="conventional")), ("structure_aware", {}))]
    cuda.reset_launches()
    # LIF at this size first spikes in window 18: its runs take 40 windows.
    for model, rate, configs, n_win in (("ignore_and_fire", 30.0, configs, 10),
                                        ("lif", 2.5, configs, 40),
                                        ("ignore_and_fire", 2000.0, forced, 10)):
        spec = mam_benchmark_spec(n_areas=4, n_per_area=256, k_intra=32, k_inter=32,
                                  rate_hz=rate)
        nets = {d: build_network(spec, seed=12, outgoing=True, device=d)
                for d in ("cuda", "cpu")}
        for f in ("alive", "rate_hz") + INCOMING + OUTGOING:
            if not bitwise_equal(getattr(nets["cuda"], f), getattr(nets["cpu"], f)):
                raise AssertionError(f"device-built {f} != CPU-built {f}")
        for name, kw in configs:
            cfg = EngineConfig(neuron_model=model, **kw)
            engs = {d: make_simulation(spec, cfg, net=nets[d], device=d) for d in nets}
            if cfg.overlap_exchange:
                blocks = {d: [] for d in engs}
                st = {d: run_windows(e, e.init(), n_win,
                                     on_block=lambda w, b, d=d: blocks[d].append(b)).state
                      for d, e in engs.items()}
                if not all(map(bitwise_equal, blocks["cuda"], blocks["cpu"])):
                    raise AssertionError(f"{model} {name}: cuda != cpu blocks")
            else:
                st = {d: e.init() for d, e in engs.items()}
                for w in range(n_win):
                    blk = {}
                    for d, e in engs.items():
                        st[d], blk[d] = e.window(st[d])
                    if not (bitwise_equal(blk["cuda"], blk["cpu"])
                            and state_equal(st["cuda"], st["cpu"])):
                        raise AssertionError(f"{model} {name}: cuda != cpu at window {w}")
            over = {d: int(x.overflow) for d, x in st.items()}
            if not state_equal(st["cuda"], st["cpu"]) or over["cuda"] != over["cpu"]:
                raise AssertionError(f"{model} {name}: cuda != cpu (overflow {over})")
            if ("forced" in name) != (over["cpu"] > 0):
                raise AssertionError(f"{model} {name}: overflow {over['cpu']}")
            if int(st["cpu"].spike_count.sum()) <= 0:
                raise AssertionError(f"{model} {name}: no spikes in {n_win} windows")
            log(f"[cpu] {model} {rate:g} Hz {name}: cuda == cpu bitwise over {n_win} windows "
                f"(blocks, ring, neuron state, spike_count), overflow {over['cpu']}; "
                f"{int(st['cpu'].spike_count.sum())} spikes")
    counts = dict(cuda.launches)
    if min(counts[k] for k in SIM_KERNELS) <= 0:
        raise AssertionError(f"a kernel never launched in the cuda runs: {counts}")
    log(f"[cpu] kernel launches in the cuda runs {counts}")
    return counts


# ---------------------------------------------------------------------------
# The LM path: dense transformers at full width, the flash_attention kernel.

BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, the JAX package's model tests' measure
    (on ``got``'s device)."""
    want = want.to(got.device)
    return max_abs_err(got, want) / max(float(want.double().abs().max()), 1e-6)


def _bundle(arch, **overrides):
    """The bundle of ``arch`` at its published width, config fields replaced
    (``make_bundle`` refuses to override a field it sets, such as a dtype)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import Transformer

    bundle = get_arch(arch)
    cfg = dataclasses.replace(bundle.cfg, **overrides)
    return dataclasses.replace(bundle, cfg=cfg, model=Transformer(cfg))


def _lm(arch, seed=0, **overrides):
    """``_bundle(arch, **overrides)`` and its weights, drawn on the card
    from ``seed``."""
    import torch

    bundle = _bundle(arch, **overrides)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return bundle, bundle.model.init_params(gen)


def _tokens(vocab, b, s, seed=1):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=gen, device="cuda")


def _expect_launches(before, per_call, calls, what):
    from repro_torch.kernels import cuda

    want = {k: before[k] + (per_call * calls if k == "flash_attention" else 0)
            for k in cuda.KERNELS}
    if dict(cuda.launches) != want:
        raise AssertionError(f"{what}: launches {dict(cuda.launches)}, expected {want}")


def phase_lm_main() -> dict:
    """qwen2-0.5b at its published width and dtypes, B 2 x S 4096 with the
    flash kernel: 1 warm-up + 3 timed forwards, 24 launches each; then the
    profile of one forward. Returns the main path's launch counts."""
    import torch

    from repro_torch.configs.common import SHAPES
    from repro_torch.kernels import cuda

    bundle, params = _lm("qwen2-0.5b", use_pallas_attention=True)
    cfg = bundle.cfg
    b, s = 2, SHAPES["train_4k"].seq_len
    toks = _tokens(cfg.vocab, b, s)
    cuda.reset_launches()
    times = []
    with torch.inference_mode():
        for i in range(4):
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bundle.model.forward(params, toks)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            _expect_launches(before, cfg.n_layers, 1, "qwen2-0.5b forward")
            if logits.shape != (b, s, cfg.vocab) or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"qwen2-0.5b logits {tuple(logits.shape)} not finite")
        launches = dict(cuda.launches)
        if launches["flash_attention"] <= 0:
            raise AssertionError(f"the LM main path never launched flash_attention: {launches}")
        ms = 1e3 * statistics.mean(times)
        log(f"[lm] qwen2-0.5b bf16 forward B {b} x S {s}, use_pallas_attention: "
            f"{ms:.2f} ms/forward (mean of 3 after 1 warm-up; {[round(1e3 * t, 2) for t in times]}), "
            f"{b * s / ms * 1e3:,.0f} tok/s, {2 * cfg.param_count() * b * s / ms / 1e9:.1f} "
            f"TFLOP/s of weight products, {cfg.n_layers} flash_attention launches "
            f"per forward, logits finite; main-path launches {launches}")
        kernels = profile_window("qwen2-0.5b forward", lambda: bundle.model.forward(params, toks),
                                 what="forward")
    busy = sum(k[0] for k in kernels)
    flash = sum(k[0] for k in kernels if "flash_attention" in k[2])
    gemm = sum(k[0] for k in kernels
               if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    log(f"[lm] qwen2-0.5b forward device time: flash_attention {flash / 1e3:.2f} ms "
        f"({100 * flash / busy:.1f}%), cuBLAS products {gemm / 1e3:.2f} ms "
        f"({100 * gemm / busy:.1f}%), other {(busy - flash - gemm) / 1e3:.2f} ms")
    del logits, params
    torch.cuda.empty_cache()
    return launches


def phase_lm_f32() -> None:
    """qwen2-0.5b with f32 parameters and compute: the kernel against the
    streaming path, and serving (prefill + decode) against the forward."""
    import torch

    from repro_torch.configs.common import ShapeSpec
    from repro_torch.train.steps import make_serve_artifacts

    kernel, params = _lm("qwen2-0.5b", param_dtype="float32", compute_dtype="float32",
                         use_pallas_attention=True)
    plain = _bundle("qwen2-0.5b", param_dtype="float32", compute_dtype="float32")
    vocab = kernel.cfg.vocab
    with torch.inference_mode():
        toks = _tokens(vocab, 2, 4096)
        got, _ = kernel.model.forward(params, toks)
        want, _ = plain.model.forward(params, toks)
        err = rel_err(got, want)
        log(f"[lm] qwen2-0.5b f32 B 2 x S 4096: kernel vs streaming path rel {err:.3g} "
            f"(bar 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"qwen2-0.5b f32: kernel vs streaming {err} > 1e-4")
        del got, want
        # One 5120-token sequence: prefill 4096, decode token 4096. Causality
        # makes position 4096 of the longer forward the same quantity, and
        # 5120 keeps the kernel's and the streaming path's block contracts.
        toks = _tokens(vocab, 1, 5120, seed=2)
        full, _ = kernel.model.forward(params, toks)
        art = make_serve_artifacts(kernel, ShapeSpec("check", "prefill", 4097, 1),
                                   cache_dtype=torch.float32)
        lp, state = art.prefill_fn(params, {"tokens": toks[:, :4096]})
        ld, state = art.decode_fn(params, state, toks[:, 4096:4097], 4096)
        scale = float(full.double().abs().max())
        errs = [max_abs_err(lp[:, 0], full[:, 4095]) / scale,
                max_abs_err(ld[:, 0], full[:, 4096]) / scale]
        log(f"[lm] qwen2-0.5b f32 serving: prefill (4096) last logits rel {errs[0]:.3g}, "
            f"decode of token 4096 rel {errs[1]:.3g} against the 5120-token forward (bar 5e-4)")
        if not max(errs) <= 5e-4:
            raise AssertionError(f"qwen2-0.5b f32 serving vs forward {errs} > 5e-4")
    del params, full, state
    torch.cuda.empty_cache()


def phase_lm_serve() -> None:
    """qwen2-0.5b serving at its published dtypes through the entry point:
    batch 4, a 4096-token prompt, 32 tokens (the first from the prefill).
    Serving never reaches the kernel: prefill attends with a cache."""
    import torch

    from repro_torch import serve_lm
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import cuda
    from repro_torch.train.steps import make_serve_artifacts

    bundle, params = _lm("qwen2-0.5b", use_pallas_attention=True)
    before = dict(cuda.launches)
    for run in ("warm-up", "timed"):
        r = serve_lm.serve(bundle, params, batch=4, prompt_len=4096, tokens=32, seed=3)
        steps = r["decode_steps"]
        log(f"[lm] qwen2-0.5b bf16 serving ({run}): prefill 4 x 4096 in "
            f"{r['prefill_s'] * 1e3:.2f} ms ({4 * 4096 / r['prefill_s']:,.0f} tok/s), "
            f"decode {steps} steps x 4 in {r['decode_s'] * 1e3:.2f} ms "
            f"({r['decode_s'] / steps * 1e3:.3f} ms/step, {4 * steps / r['decode_s']:,.0f} tok/s)")
    if r["tokens"].shape != (4, 32) or not bool(torch.isfinite(r["logits"]).all()):
        raise AssertionError("qwen2-0.5b serving: wrong shape or non-finite logits")
    _expect_launches(before, 0, 0, "qwen2-0.5b serving")
    # Where a decode step's time goes: one step after a prefill.
    art = make_serve_artifacts(bundle, ShapeSpec("serve", "prefill", 4128, 4))
    with torch.inference_mode():
        _, state = art.prefill_fn(params, {"tokens": r["tokens"].new_zeros(4, 4096)})
        profile_window("qwen2-0.5b decode step (batch 4, cache 4096)",
                       lambda: art.decode_fn(params, state, r["tokens"][:, :1], 4096),
                       what="step")
    del params, state
    torch.cuda.empty_cache()


def phase_lm_danube() -> None:
    """h2o-danube-1.8b, B 1 x S 8192, so its 4096 window cuts in: bf16 with
    the kernel (24 launches), and f32 kernel against the streaming path."""
    import torch

    from repro_torch.kernels import cuda

    bundle, params = _lm("h2o-danube-1.8b", use_pallas_attention=True)
    toks = _tokens(bundle.cfg.vocab, 1, 8192)
    with torch.inference_mode():
        for i in range(2):
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bundle.model.forward(params, toks)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            _expect_launches(before, bundle.cfg.n_layers, 1, "h2o-danube-1.8b forward")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("h2o-danube-1.8b logits not finite")
        log(f"[lm] h2o-danube-1.8b bf16 forward B 1 x S 8192 (window 4096): {ms:.2f} ms "
            f"(second call), {8192 / ms * 1e3:,.0f} tok/s, {bundle.cfg.n_layers} "
            f"flash_attention launches, "
            f"logits finite")
        del logits, params
        torch.cuda.empty_cache()
        kernel, params = _lm("h2o-danube-1.8b", param_dtype="float32",
                             compute_dtype="float32", use_pallas_attention=True)
        plain = _bundle("h2o-danube-1.8b", param_dtype="float32", compute_dtype="float32")
        got, _ = kernel.model.forward(params, toks)
        want, _ = plain.model.forward(params, toks)
        err = rel_err(got, want)
    log(f"[lm] h2o-danube-1.8b f32 S 8192: kernel vs streaming path rel {err:.3g} (bar 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"h2o-danube-1.8b f32: kernel vs streaming {err} > 1e-4")
    del got, want, params
    torch.cuda.empty_cache()


def _valid_pairs(sq, sk, window, k_len) -> int:
    """(query, key) pairs the mask lets through: the work the data needs."""
    import numpy as np

    pos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, min(k_len, sk) - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bf16_bar_ratio(got, want) -> float:
    """Largest |got - want| over its bar, one bf16 ulp of the larger of the
    two values + 2e-5 (per element, as ``tests/test_torch_cuda.py``)."""
    import torch

    got, want = got.float(), want.float()
    top = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    bar = torch.exp2(torch.floor(torch.log2(top)) - 7) + 2e-5
    return float(((got - want).abs() / bar).max())


def log_flash_build() -> None:
    """The tensor-core kernel's instructions (wgmma and TMA must be there),
    and its instantiations' registers, spills and shared memory from this
    process's ``-Xptxas -v`` report."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import cuda

    lib = cuda.library("flash_attention")
    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
                           str(cuda._target("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {op: len(re.findall(rf"\b{op}[.\w]*", sass)) for op in ("HGMMA", "UTMALDG")}
    log(f"[kernel] flash_attention SASS: {counts['HGMMA']} HGMMA (wgmma), "
        f"{counts['UTMALDG']} UTMALDG (TMA loads)")
    if not all(counts.values()):
        raise AssertionError(f"flash_attention: no wgmma or TMA in the SASS: {counts}")
    report = cuda.build_logs.get("flash_attention")
    if report is None:
        log("[kernel] flash_attention_tc: no build report (library built by another process)")
        return
    dh, seen = None, {}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*flash_attention_tcILi(\d+)E", line)
        if m or "Compiling entry function" in line:
            dh = int(m.group(1)) if m else None
        elif dh is not None and ("spill" in line or "registers" in line):
            seen.setdefault(dh, []).append(line.split(":", 1)[-1].strip())
    for dh, lines in sorted(seen.items()):
        log(f"[kernel] flash_attention_tc<{dh}>: {'; '.join(lines)}; dynamic shared memory "
            f"{lib.flash_attention_smem_bytes(1, dh)} bytes; setmaxnreg 232 (compute) / "
            f"40 (load)")


def phase_kernel_flash(launches: dict) -> dict:
    """flash_attention against its plain version at the main paths' shapes
    and with k_len < S; timed beside its bound, the plain version and SDPA,
    and the f32 route at qwen2-0.5b's shape beside its own bound (the f32
    CUDA-core peak) and SDPA on the f32 inputs."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    log_flash_build()

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(5)
    shapes = [("qwen2-0.5b", (2, 4096, 14, 2, 64), 0, 4096),
              ("h2o-danube-1.8b", (1, 8192, 32, 8, 80), 4096, 8192),
              ("k_len < S, windowed", (2, 4096, 14, 2, 64), 1024, 3000),
              # [families] (a): d_head 128 at 5, 6 and 8 query heads a KV head
              ("llama4-maverick-400b-a17b", (1, 4096, 40, 8, 128), 0, 4096),
              ("grok-1-314b", (1, 4096, 48, 8, 128), 0, 4096),
              ("internvl2-76b", (1, 4096, 64, 8, 128), 0, 4096)]
    row = None
    for name, (b, s, h, hkv, dh), window, k_len in shapes:
        f32 = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
               for shape in ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
        # f32: the JAX kernel test's bar. bf16: both round an f32 result
        # once, so one bf16 ulp of the plain output's largest magnitude.
        got = fa.flash_attention_cuda(*f32, window, k_len)
        want = fa.flash_attention_plain(*f32, window, k_len)
        err32 = max_abs_err(got, want)
        bf = [x.bfloat16() for x in f32]
        got = fa.flash_attention_cuda(*bf, window, k_len)
        want = fa.flash_attention_plain(*bf, window, k_len)
        err16 = max_abs_err(got, want)
        ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
        ratio = bf16_bar_ratio(got, want)
        if not (err32 <= 2e-5 and err16 <= ulp and ratio <= 1.0
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_attention {name}: kernel vs plain max abs "
                                 f"{err32} (f32, bar 2e-5), {err16} (bf16, bar {ulp}), "
                                 f"bf16 per element {ratio} of the bar")
        ms = time_ms(lambda: fa.flash_attention_cuda(*bf, window, k_len), flush=flush)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(*bf, window, k_len), flush=flush,
                           host_paced_ok=True)
        pairs = _valid_pairs(s, s, window, k_len)
        flops = 4 * b * h * dh * pairs
        nbytes = sum(x.numel() * 2 for x in bf) + got.numel() * 2
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S) * 1e3
        f32_row = None
        if row is None:
            # The f32 route (CUDA cores) at the main path's shape, beside
            # its bound at the f32 CUDA-core peak and SDPA on the same f32
            # inputs (TF32 is off: f32 products in f32).
            f32_ms = time_ms(lambda: fa.flash_attention_cuda(*f32, window, k_len), flush=flush)
            f32_bound = max(2 * nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S) * 1e3
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in f32)
            f32_sdpa_err = max_abs_err(
                sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2),
                fa.flash_attention_plain(*f32, window, k_len))
            f32_sdpa_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                                  flush=flush)
            f32_row = dict(ms=f32_ms, bound_ms=f32_bound, bound_by="operations",
                           library_ms=f32_sdpa_ms, max_abs_err=err32)
            del qt, kt, vt
        library_ms = None
        if window == 0 and k_len == s:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in bf)
            ref = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
            library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                                 flush=flush)
            sdpa_ratio = bf16_bar_ratio(ref, want)
            log(f"[kernel] flash_attention {name}: bf16 vs plain, max abs / largest "
                f"per-element |diff| over the bar: kernel {err16:.3g} / {ratio:.3f}, SDPA "
                f"(P rounded to bf16) {max_abs_err(ref, want):.3g} / {sdpa_ratio:.3f} "
                f"(1 ulp {ulp:.3g})")
            # The control: a kernel that rounds P to bf16 must miss the bar,
            # or the bar could not tell the split P from a single rounding.
            if sdpa_ratio <= 1.0:
                raise AssertionError(f"flash_attention {name}: SDPA meets the per-element "
                                     f"bf16 bar ({sdpa_ratio}), so it separates nothing")
        log(f"[kernel] flash_attention {name} q [{b}, {s}, {h}, {dh}] kv [{b}, {s}, {hkv}, "
            f"{dh}] window {window} k_len {k_len}: max abs vs plain {err32:.3g} f32, "
            f"{err16:.3g} bf16 (1 ulp {ulp:.3g}; per element {ratio:.3f} of the bar); "
            f"bf16 (tensor cores) {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound "
            f"{bound_ms:.4f} ms by operations, {flops / 1e9:.1f} GFLOP), plain "
            f"{plain_ms:.3f} ms, SDPA {library_ms if library_ms is None else round(library_ms, 4)} ms"
            + ("" if f32_row is None else
               f"; f32 (CUDA cores) {f32_row['ms']:.3f} ms ({flops / f32_row['ms'] / 1e9:.1f} "
               f"TFLOP/s; {100 * f32_row['bound_ms'] / f32_row['ms']:.1f}% of the bound "
               f"{f32_row['bound_ms']:.3f} ms by operations at the f32 CUDA-core peak), SDPA "
               f"on the f32 inputs (TF32 off) {f32_row['library_ms']:.4f} ms (max abs vs "
               f"plain {f32_sdpa_err:.3g})"))
        if row is None:  # the row is the qwen2-0.5b main path's shape
            row = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:79",
                launches=launches["flash_attention"], max_abs_err=err16, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations",
                library_ms=library_ms, checked=True, f32=f32_row)
        del f32, bf, got, want
    del flush
    torch.cuda.empty_cache()
    return row


def phase_lm_device_vs_cpu() -> None:
    """Reduced qwen2-0.5b in f32 on the card against the CPU, with
    FLASH_THRESHOLD lowered to 16 so the 32-token forward runs the kernel:
    the forward, then prefill + 4 decode steps."""
    import torch

    from repro_torch.configs.common import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import cuda
    from repro_torch.models import layers
    from repro_torch.train.steps import make_serve_artifacts

    bundle = get_arch("qwen2-0.5b", reduced=True, use_pallas_attention=True)
    params = {"cpu": bundle.model.init_params(torch.Generator().manual_seed(0))}
    params["cuda"] = copy.deepcopy(params["cpu"]).to("cuda")
    toks = torch.randint(0, bundle.cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    threshold = layers.FLASH_THRESHOLD
    layers.FLASH_THRESHOLD = 16
    try:
        before = dict(cuda.launches)
        with torch.inference_mode():
            out = {d: bundle.model.forward(params[d], toks.to(d))[0] for d in params}
            _expect_launches(before, bundle.cfg.n_layers, 1, "reduced qwen2 forward on the card")
            err = rel_err(out["cuda"], out["cpu"])
            art = make_serve_artifacts(bundle, ShapeSpec("check", "prefill", 32, 2),
                                       cache_dtype=torch.float32)
            errs = []
            lp = {d: art.prefill_fn(params[d], {"tokens": toks[:, :28].to(d)}) for d in params}
            errs.append(rel_err(lp["cuda"][0], lp["cpu"][0]))
            for i in range(28, 32):
                lp = {d: art.decode_fn(params[d], lp[d][1], toks[:, i:i + 1].to(d), i)
                      for d in params}
                errs.append(rel_err(lp["cuda"][0], lp["cpu"][0]))
    finally:
        layers.FLASH_THRESHOLD = threshold
    log(f"[cpu] reduced qwen2-0.5b f32: forward (kernel on the card) cuda vs cpu rel "
        f"{err:.3g} (bar 1e-4); prefill + 4 decode steps rel {max(errs):.3g} (bar 5e-4)")
    if not (err <= 1e-4 and max(errs) <= 5e-4):
        raise AssertionError(f"reduced qwen2 cuda vs cpu: forward {err}, serving {errs}")


# ---------------------------------------------------------------------------
# [train]: LM training (loss, autograd, AdamW, the hierarchical trainer, the
# CLI) at qwen2-0.5b's published width, depth and dtypes; gemma3 and olmo
# forwards at full width.

TRAIN_SEQ = 4096  # SHAPES["train_4k"]'s length
# Depth cut to keep the script within 70% of its time limit: (a) 1 + 2
# steps, (b) 2 local steps and one sync, (c)'s CLI runs at S 2048 (the
# checkpoint's size is the model's, whatever the sequence).
TRAIN_SYNC_STEPS = 3
TRAIN_HIER_STEPS = 2
TRAIN_CLI_SEQ = 2048


def _trainer(bundle, opt_cfg, **kw):
    """Training artifacts, weights drawn on the card from seed 0 (trainable)
    and their AdamW state."""
    import torch

    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.steps import make_train_artifacts

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = bundle.model.init_params(gen).requires_grad_()
    return make_train_artifacts(bundle, opt_cfg, **kw), params, adamw_init(params, opt_cfg)


def _no_flash(before, what):
    from repro_torch.kernels import cuda

    if dict(cuda.launches) != before:
        raise AssertionError(f"{what} launched a kernel: {dict(cuda.launches)}, before {before}")


def phase_train_sync() -> None:
    """(a) The sync trainer on qwen2-0.5b as published (bf16 parameters, f32
    moments, remat "dots"), S 4096, global batch 8 in 4 microbatches, the
    same batch every step: 1 warm-up + 2 timed steps, finite losses and
    grad norms, the loss falling (and under the reference test's bar, loss
    + 0.5), no kernel launch; then the profile of a one-microbatch step."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM, host_batch
    from repro_torch.kernels import cuda
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_artifacts

    bundle = get_arch("qwen2-0.5b")
    cfg = bundle.cfg
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, moment_dtype=bundle.moment_dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    art, params, opt = _trainer(bundle, opt_cfg, n_micro=4)
    b = 8
    batch = host_batch(SyntheticLM(cfg.vocab, TRAIN_SEQ, b, seed=0).batch(0), "cuda")
    before = dict(cuda.launches)
    losses, gnorms, times = [], [], []
    for i in range(TRAIN_SYNC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = art.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    _no_flash(before, "the training step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * statistics.mean(times[1:])
    log(f"[train] (a) qwen2-0.5b sync trainer, {cfg.param_dtype} params, "
        f"{opt_cfg.moment_dtype} moments, remat {cfg.remat!r}, B {b} x S {TRAIN_SEQ} in 4 "
        f"microbatches, the same batch: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in gnorms]}; {ms:.1f} ms/step (mean of "
        f"{TRAIN_SYNC_STEPS - 1} after 1; {[round(1e3 * t, 1) for t in times]}), "
        f"{b * TRAIN_SEQ / ms * 1e3:,.0f} tokens/s, "
        f"{6 * cfg.param_count() * b * TRAIN_SEQ / ms / 1e9:.1f} TFLOP/s of 6ND, peak "
        f"{peak:.2f} GB (max_memory_allocated), flash_attention launches 0; {card_name_power()}")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"(a): non-finite losses {losses} or grad norms {gnorms}")
    if not (losses[-1] < losses[0] and losses[1] < losses[0] + 0.5):
        raise AssertionError(f"(a): the loss does not fall on the repeated batch: {losses}")
    # The profile of a step of one microbatch (2 x 4096 and the AdamW
    # update): the trace of all four takes about a minute to process.
    one = make_train_artifacts(bundle, opt_cfg)
    micro = {k: v[:2] for k, v in batch.items()}
    kernels = profile_window("qwen2-0.5b train step, one microbatch (2 x 4096)",
                             lambda: one.step_fn(params, opt, micro), what="step")
    busy = sum(k[0] for k in kernels)
    gemm = sum(k[0] for k in kernels
               if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    log(f"[train] (a) step device time: matrix products {gemm / 1e3:.1f} ms "
        f"({100 * gemm / busy:.1f}%), other {(busy - gemm) / 1e3:.1f} ms")
    del art, one, params, opt, batch, micro, m
    torch.cuda.empty_cache()


def phase_train_hier() -> None:
    """(b) The hierarchical trainer on qwen2-0.5b as published: 2 pods,
    int8 slow tier every 2 steps, global batch 4 (2 a pod), S 4096, 2
    steps (``TRAIN_HIER_STEPS``). Before the sync the replicas differ;
    after it they are equal, with a nonzero error residual (the reference's invariants,
    tests/test_distributed.py:132-171, on one device)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM, host_batch
    from repro_torch.kernels import cuda
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.hierarchical import HierarchicalConfig

    bundle = get_arch("qwen2-0.5b")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, moment_dtype=bundle.moment_dtype)
    torch.cuda.reset_peak_memory_stats()
    art, params, opt = _trainer(bundle, opt_cfg, n_pods=2,
                                hier_cfg=HierarchicalConfig(sync_every=2, compression="int8"))
    hier = art.hier
    sync = hier.init_sync_state(params)
    pparams, popt = hier.replicate(params), hier.replicate(opt)
    del params, opt
    torch.cuda.empty_cache()
    ds = SyntheticLM(bundle.cfg.vocab, TRAIN_SEQ, 4, seed=1)
    before = dict(cuda.launches)
    local_ms, sync_ms, losses = [], [], []
    for step in range(TRAIN_HIER_STEPS):
        batch = host_batch(ds.batch(step), "cuda", n_pods=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pparams, popt, m = art.step_fn(pparams, popt, batch)
        torch.cuda.synchronize()
        local_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append([round(float(x), 4) for x in m["loss"]])
        if (step + 1) % 2:
            continue
        differ = sum(not torch.equal(x[0], x[1]) for x in pparams.parameters())
        t0 = time.perf_counter()
        pparams, sync = art.sync_fn(pparams, sync)
        torch.cuda.synchronize()
        sync_ms.append(1e3 * (time.perf_counter() - t0))
        unequal = sum(not torch.equal(x[0], x[1]) for x in pparams.parameters())
        ef = sum(bool(e.any()) for e in sync["ef"].values())
        n = len(list(pparams.parameters()))
        if not (differ > 0 and unequal == 0 and ef > 0):
            raise AssertionError(f"(b) sync after step {step + 1}: {differ} of {n} leaves "
                                 f"differed before, {unequal} after, {ef} residuals nonzero")
    _no_flash(before, "the hierarchical trainer")
    log(f"[train] (b) qwen2-0.5b hierarchical trainer, 2 pods, int8 every 2 steps, B 2 x S "
        f"{TRAIN_SEQ} a pod: per-pod losses {losses}; local step (both pods) "
        f"{[round(x, 1) for x in local_ms]} ms, sync {[round(x, 2) for x in sync_ms]} ms; "
        f"int8 payload {hier.wire_bytes / 2:,.0f} B a pod ({hier.wire_bytes:,} B both); "
        f"replicas differed before each sync and were equal after it, residuals nonzero; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card_name_power()}")
    del pparams, popt, sync, art, m
    torch.cuda.empty_cache()


def _same_as_saved(tree, path: str) -> bool:
    """Every tensor leaf of ``tree`` (keyed as the checkpoint keys it)
    bitwise the array saved under its key in ``path``, bf16 as its bits."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import _leaves

    with np.load(path) as saved:
        for key, leaf in _leaves(tree):
            x = leaf.detach().cpu()
            if x.dtype == torch.bfloat16:
                x = x.view(torch.int16)
            if not np.array_equal(x.numpy().view(saved[key].dtype), saved[key]):
                return False
        return sorted(saved.files) == sorted(k for k, _ in _leaves(tree))


def _npz_equal(a: str, b: str) -> bool:
    import numpy as np

    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files)


def phase_train_cli() -> None:
    """(c) ``python -m repro_torch.launch.train`` at qwen2-0.5b's published
    config but S 2048: 3 steps of B 2 checkpointed every 2 (and at the end);
    that run's step-2 checkpoint, alone in a directory, resumed to step 3
    by a second run. The step is deterministic (the CLI sets
    torch.use_deterministic_algorithms), so the resumed run's step-3 loss
    prints as the uninterrupted run's and its step-3 checkpoint is bitwise
    the uninterrupted one; the restored state is bitwise the saved one
    (restored on the card and saved again while the resumed run runs), with
    the checkpoint's bytes and the save and restore seconds."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train_state_tree
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    log(f"[train] (c) checkpoints under {tmp}: {shutil.disk_usage(tmp).free / 1e9:.1f} GB free")
    argv = ["--arch", "qwen2-0.5b", "--steps", "3", "--global-batch", "2", "--seq-len",
            str(TRAIN_CLI_SEQ), "--ckpt-every", "2", "--log-every", "1"]

    def npz(d, step):
        return os.path.join(d, f"step_{step:08d}", "arrays.npz")

    try:
        full_dir, cut_dir = os.path.join(tmp, "full"), os.path.join(tmp, "cut")
        full = _train_cli("(c)", "uninterrupted", [*argv, "--ckpt-dir", full_dir], env)
        if sorted(full) != ["1", "2", "3"]:
            raise AssertionError(f"(c) the uninterrupted run's steps: {full}")
        # hard links: the resumed run reads the step-2 files and writes new
        # ones; the restore here reads its own links, so it cannot take the
        # resumed run's step 3 for the latest
        for d in (cut_dir, os.path.join(tmp, "restore")):
            os.makedirs(d)
            shutil.copytree(os.path.join(full_dir, f"step_{2:08d}"),
                            os.path.join(d, f"step_{2:08d}"), copy_function=os.link)
        resumed_run = _train_cli_start([*argv, "--ckpt-dir", cut_dir, "--resume"], env)
        try:
            # Meanwhile, the restore on the card, timed, held to the saved
            # arrays; then the restored state saved again, timed.
            bundle = get_arch("qwen2-0.5b")
            meta = bundle.model.init_params(None, device="meta")
            like = train_state_tree(bundle.model, meta, adamw_init(meta, AdamWConfig(
                moment_dtype=bundle.moment_dtype)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored, step = ckpt.restore(os.path.join(tmp, "restore"), like, device="cuda")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            nbytes = os.path.getsize(npz(cut_dir, 2))
            if step != 2 or not _same_as_saved(restored, npz(cut_dir, 2)):
                raise AssertionError("(c) the state restored on the card differs from the saved "
                                     "one")
            t0 = time.perf_counter()
            ckpt.save(os.path.join(tmp, "again"), step, restored)
            save_s = time.perf_counter() - t0
            del restored
            shutil.rmtree(os.path.join(tmp, "again"))
        finally:
            resumed = _train_cli_finish("(c)", "resumed", resumed_run)
        log(f"[train] (c) checkpoint of step 2: {nbytes:,} B; restored onto the card in "
            f"{restore_s:.2f} s, saved again (device to host + write) in {save_s:.2f} s, "
            f"bitwise the saved state (while the resumed run ran); {card_name_power()}")
        want = {k: v for k, v in full.items() if int(k) > 2}
        if resumed != want:
            raise AssertionError(f"(c) resumed losses {resumed} against {want}")
        if not _npz_equal(npz(cut_dir, 3), npz(full_dir, 3)):
            raise AssertionError("(c) the resumed run's step-3 checkpoint differs")
        log(f"[train] (c) the resumed run's step 3 {resumed} prints as the uninterrupted "
            f"run's, and its step-3 checkpoint is bitwise the uninterrupted one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _train_small(arch, mode, device):
    """Reduced ``arch`` in f32 from weights drawn on the CPU (seed 0): 3
    sync steps, or 3 hierarchical steps (2 pods, int8) and a sync. Returns
    the losses, grad norms and final parameters on the host."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import SyntheticLM, host_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.hierarchical import HierarchicalConfig
    from repro_torch.train.steps import make_train_artifacts

    bundle = get_arch(arch, reduced=True)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    hier = HierarchicalConfig(sync_every=3, compression="int8") if mode == "hier" else None
    art = make_train_artifacts(bundle, opt_cfg, hier_cfg=hier, n_pods=2)
    params = bundle.model.init_params(torch.Generator().manual_seed(0))
    params = params.to(device).requires_grad_()
    opt = adamw_init(params, opt_cfg)
    if hier is not None:
        sync = art.hier.init_sync_state(params)
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
    ds = SyntheticLM(bundle.cfg.vocab, 32, 4, seed=2)
    metrics = []
    for step in range(3):
        batch = host_batch(ds.batch(step), device, n_pods=None if hier is None else 2)
        params, opt, m = art.step_fn(params, opt, batch)
        metrics.append(torch.stack([m["loss"].reshape(-1), m["grad_norm"].reshape(-1)]).cpu())
    if hier is not None:
        params, sync = art.sync_fn(params, sync)
    return metrics, {n: p.detach().cpu() for n, p in params.named_parameters()}


def phase_train_device_vs_cpu() -> None:
    """(d) Reduced qwen2-0.5b and olmo-1b in f32, the sync trainer and the
    hierarchical one, on the card against the CPU: losses and grad norms
    within 1e-4 relative at every step; the parameters under the CPU
    tests' bar: every element within 2 * lr * steps (AdamW's normalised
    step can flip with a gradient's sign within rounding of zero), and 99%
    within 1e-5 of the largest parameter, plus one step of an int8 grid
    spanning 2 * lr * steps after the int8 sync."""
    from repro_torch.kernels import cuda

    lr, steps = 1e-3, 3
    worst = {}
    for arch in ("qwen2-0.5b", "olmo-1b"):
        for mode in ("sync", "hier"):
            before = dict(cuda.launches)
            card, p_card = _train_small(arch, mode, "cuda")
            _no_flash(before, f"reduced {arch} {mode}")
            host, p_host = _train_small(arch, mode, "cpu")
            err = max(float((c - h).abs().max() / h.abs().max()) for c, h in zip(card, host))
            diffs = [(p_card[n] - x).abs() for n, x in p_host.items()]
            top = max(float(x.abs().max()) for x in p_host.values())
            bar = 1e-5 * top + (2 * lr * steps / 127 if mode == "hier" else 0.0)
            perr = max(float(d.max()) for d in diffs)
            close = sum(int((d <= bar).sum()) for d in diffs) / sum(d.numel() for d in diffs)
            worst[f"{arch} {mode}"] = (err, perr, close, bar)
            if not (err < 1e-4 and perr <= 2 * lr * steps and close >= 0.99):
                raise AssertionError(f"(d) {arch} {mode}: metrics rel {err}, params max "
                                     f"{perr}, {close:.4%} within {bar:.3g}")
    log("[train] (d) reduced f32, card vs cpu (losses and grad norms rel, bar 1e-4; params "
        f"max abs, bar {2 * lr * steps:g}; share within 1e-5 of the largest (+ an int8 grid "
        "step after a sync), bar 99%): " + ", ".join(
            f"{k} {e:.3g} / {p:.3g} / {c:.4%} within {b:.3g}"
            for k, (e, p, c, b) in worst.items()))


def phase_train_forwards() -> None:
    """(e) olmo-1b (16 layers) and gemma3-27b (6 of its 62 layers, one 5:1
    period) at full width: bf16 with the kernel, B 1 x S 4096, exactly
    ``n_layers`` flash_attention launches a forward and ms/forward; in f32
    the kernel against the streaming path (<= 1e-4 of the largest logit).
    gemma3's 1024-token windows run the kernel's window path at d_head 128."""
    import torch

    from repro_torch.kernels import cuda

    for arch, layers_kw in (("olmo-1b", {}), ("gemma3-27b", {"n_layers": 6})):
        bundle, params = _lm(arch, use_pallas_attention=True, **layers_kw)
        cfg = bundle.cfg
        toks = _tokens(cfg.vocab, 1, TRAIN_SEQ)
        times = []
        with torch.inference_mode():
            for i in range(3):
                before = dict(cuda.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = bundle.model.forward(params, toks)
                torch.cuda.synchronize()
                if i:
                    times.append(1e3 * (time.perf_counter() - t0))
                _expect_launches(before, cfg.n_layers, 1, f"{arch} forward")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} logits not finite")
        ms = statistics.mean(times)
        del logits, params
        torch.cuda.empty_cache()
        kernel, params = _lm(arch, param_dtype="float32", compute_dtype="float32",
                             use_pallas_attention=True, **layers_kw)
        plain = _bundle(arch, param_dtype="float32", compute_dtype="float32", **layers_kw)
        with torch.inference_mode():
            got, _ = kernel.model.forward(params, toks)
            want, _ = plain.model.forward(params, toks)
            err = rel_err(got, want)
        log(f"[train] (e) {arch} ({cfg.n_layers} of {_bundle(arch).cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, windows {sorted(set(cfg.window_pattern))}) bf16 forward "
            f"B 1 x S {TRAIN_SEQ}: {ms:.2f} ms (mean of 2 after 1; {[round(t, 2) for t in times]}),"
            f" {TRAIN_SEQ / ms * 1e3:,.0f} tok/s, {cfg.n_layers} flash_attention launches a "
            f"forward, logits finite; f32 kernel vs streaming path rel {err:.3g} (bar 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"{arch} f32: kernel vs streaming {err} > 1e-4")
        del got, want, params
        torch.cuda.empty_cache()


# [train] (f)-(i): the six other families (MoE, SSM, hybrid, audio, VLM)
# trained, and the GPipe wrapper.

# arch: config overrides (depth cut only where the card forces it) for (f).
# Reckoned at 8 B a parameter (bf16 weights, grads and moments; 20 B with
# f32 moments): grok-1 keeps 1 of its 64 layers (~6.5 G parameters, the
# 131,072-vocab embedding and head included), internvl2 4 of its 80
# backbone layers (~5.5 G with its 128,256-vocab embedding and head).
TRAIN_FAMILIES = {
    "mamba2-2.7b": {},
    "zamba2-1.2b": {},
    "whisper-medium": {},
    "internvl2-76b": {"n_layers": 4},
    "grok-1-314b": {"n_layers": 1},
}
TRAIN_FAMILY_STEPS = 3    # 1 + 2 on one repeated batch
WHISPER_DECODER_SEQ = 448  # whisper-medium's decoder length
PIPE_STAGES = 4           # (i): qwen2-0.5b's 24 layers in 4 stages of 6
PIPE_MICRO = 4            # microbatches of B 1 x S 4096
PIPE_TIMEOUT_S = 300
PIPE_PROBE_SEED = 7       # the loss's fixed tensor
PIPE_GRAD_BAR = 1e-4      # of a leaf's largest |g| (tests/test_torch_train.py's bar)


def _published_remat(arch) -> str:
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(arch).cfg
    return getattr(cfg, "backbone", cfg).remat


def _family_train(arch) -> None:
    """(f) ``arch`` at its published width and dtypes (depth as
    ``TRAIN_FAMILIES`` cuts it), remat and moment dtype as published, B 1
    x S 4096 (whisper: decoder 448 tokens on 1500 frames): 1 + 2 AdamW
    steps on one repeated batch, no kernel launch; ms/step, tokens/s, peak
    GB; the second loss below the first, finite losses and grad norms."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM, host_batch
    from repro_torch.kernels import cuda
    from repro_torch.optim.adamw import AdamWConfig

    overrides = TRAIN_FAMILIES[arch]
    bundle = _family_bundle(arch, **overrides)
    cfg = bundle.cfg
    s = WHISPER_DECODER_SEQ if bundle.family == "audio" else TRAIN_SEQ
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, moment_dtype=bundle.moment_dtype)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    art, params, opt = _trainer(bundle, opt_cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    n_params = sum(p.numel() for p in params.parameters())
    batch = host_batch(SyntheticLM(cfg.vocab, s, 1, seed=0).batch(0), "cuda")
    batch.update(_family_inputs(bundle, 1, s, "cuda")[1])
    before = dict(cuda.launches)
    losses, gnorms, times = [], [], []
    for _ in range(TRAIN_FAMILY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = art.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    _no_flash(before, f"the {arch} training step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * statistics.mean(times[1:])
    depth = overrides.get("n_layers")
    cut = ("published depth" if depth is None
           else f"{depth} of {_family_bundle(arch).cfg.n_layers} layers")
    frames = f" (decoder; {cfg.n_frames} frames)" if bundle.family == "audio" else ""
    log(f"[train] (f) {arch} ({cut}, {n_params / 1e9:.3f} G parameters drawn in "
        f"{t_init:.1f} s), {getattr(cfg, 'backbone', cfg).param_dtype} params, "
        f"{opt_cfg.moment_dtype} moments, remat {_published_remat(arch)!r}, B 1 x S {s}"
        f"{frames}, the same batch: losses "
        f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in gnorms]}; "
        f"{ms:.1f} ms/step (mean of {TRAIN_FAMILY_STEPS - 1} after 1; "
        f"{[round(1e3 * t, 1) for t in times]}), {s / ms * 1e3:,.0f} tokens/s, "
        f"peak {peak:.2f} GB (max_memory_allocated), "
        f"flash_attention launches 0; {card_name_power()}")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"(f) {arch}: non-finite losses {losses} or grad norms {gnorms}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"(f) {arch}: the second loss does not fall: {losses}")
    del art, params, opt, batch, m
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_families() -> None:
    """(f) Each family trained at its published width; llama4-maverick's
    full-width step does not fit the card (a line says why)."""
    import torch

    from repro_torch.configs.registry import get_arch

    for arch in TRAIN_FAMILIES:
        _family_train(arch)
    cfg = get_arch("llama4-maverick-400b-a17b").cfg
    experts = cfg.moe.n_experts * 3 * cfg.d_model * cfg.moe.d_ff
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"[train] (f) llama4-maverick-400b-a17b: one MoE sub-layer's {cfg.moe.n_experts} "
        f"experts are {experts / 1e9:.1f} G parameters, {8 * experts / 1e9:.0f} GB at 8 B a "
        f"parameter (bf16 weights, grads and moments) against the card's {card / 1e9:.1f} GB: "
        f"trained on the card only at its reduced config ((g)); its full-width step waits "
        f"for expert parallelism over 4 cards")


def _family_grads(bundle, params, batch, tap):
    """(loss, gradients by parameter name, this call's MoE routing)."""
    import torch

    named = dict(params.named_parameters())
    loss = bundle.loss(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads)), tap.take()


def phase_train_families_device_vs_cpu() -> None:
    """(g) The six reduced configs in f32, the same weights and batch
    (B 2 x S 32, the stub inputs normal) on the card and the CPU: the loss
    within 1e-5 relative and every gradient within 1e-4 of its leaf's
    largest magnitude (floor 1e-8), no MoE routing flip; on the card,
    ``remat`` as published against ``"none"``, the loss and every gradient
    bitwise (deterministic algorithms on)."""
    import copy

    import torch

    from repro_torch.data.pipeline import SyntheticLM, host_batch

    worst = {}
    for arch in FAMILIES:
        bundle = _family_bundle(arch, reduced=True)
        params = {"cpu": bundle.model.init_params(torch.Generator().manual_seed(0))}
        params["cuda"] = copy.deepcopy(params["cpu"]).to("cuda")
        host = host_batch(SyntheticLM(bundle.cfg.vocab, 32, 2, seed=4).batch(0), "cpu")
        host.update(_family_inputs(bundle, 2, 32, "cpu", seed=5)[1])
        batch = {d: {k: v.to(d) for k, v in host.items()} for d in ("cuda", "cpu")}
        out = {}
        with _RoutingTap() as tap:
            for d in ("cuda", "cpu"):
                params[d].requires_grad_()
                out[d] = _family_grads(bundle, params[d], batch[d], tap)
            rows = agreeing_rows(out["cuda"][2], out["cpu"][2], f"reduced {arch} training",
                                 tag="[train] (g)")
            if rows is not None and not bool(rows.all()):
                raise AssertionError(f"(g) {arch}: a routing flip between the card and the CPU")
            want = float(out["cpu"][0])
            loss_err = abs(float(out["cuda"][0]) - want) / abs(want)
            # per leaf: max abs over max(its largest |g|, 1e-4), so that the
            # 1e-4 bar floors at 1e-8 on leaves whose exact gradient is 0
            grad_err = max(max_abs_err(out["cuda"][1][n].cpu(), g)
                           / max(float(g.abs().max()), 1e-4)
                           for n, g in out["cpu"][1].items())
            mode = _published_remat(arch)
            remat = _family_bundle(arch, reduced=True, remat=mode)
            deterministic = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                runs = [_family_grads(b, params["cuda"], batch["cuda"], tap)
                        for b in (bundle, remat)]
            finally:
                torch.use_deterministic_algorithms(deterministic)
        same = bitwise_equal(runs[0][0], runs[1][0]) and all(
            bitwise_equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])
        worst[arch] = (loss_err, grad_err, mode, same)
        if not (loss_err <= 1e-5 and grad_err <= 1e-4 and same):
            raise AssertionError(f"(g) {arch}: loss rel {loss_err}, gradients {grad_err}, "
                                 f"remat {mode!r} bitwise 'none': {same}")
    log("[train] (g) reduced f32 training, card vs cpu (loss rel, bar 1e-5; gradients max abs "
        "over the leaf's largest, bar 1e-4), and remat as published against 'none' on the "
        "card: " + ", ".join(f"{a} {le:.3g} / {ge:.3g}, {m!r} {'bitwise' if s else 'DIFFERS'}"
                             for a, (le, ge, m, s) in worst.items()) + "; no routing flip")


def _train_cli(tag: str, what: str, argv: list, env: dict) -> dict:
    """``python -m repro_torch.launch.train`` with ``argv`` on the card, its
    lines echoed; fails unless it exits 0. Returns its printed losses by
    step."""
    return _train_cli_finish(tag, what, _train_cli_start(argv, env))


def _train_cli_start(argv: list, env: dict):
    """:func:`_train_cli`'s process, started."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _train_cli_finish(tag: str, what: str, started) -> dict:
    """:func:`_train_cli`'s checks on a process of :func:`_train_cli_start`."""
    t0, proc = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in stdout.splitlines():
        if line.strip():
            log(f"[train] {tag} {what}: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{tag} {what}: exit {proc.returncode}\n{stderr[-3000:]}")
    log(f"[train] {tag} {what}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return dict(re.findall(r"^step\s+(\d+) loss\s+(\S+)", stdout, re.M))


def phase_train_cli_family() -> None:
    """(h) The CLI's crash-resume on reduced mamba2 (its own stacks in the
    checkpoint): 4 steps of B 2 x S 64 checkpointed every 2, then the
    step-2 checkpoint alone in a directory resumed to 4 by a second run:
    its losses print as the uninterrupted run's and its step-4 checkpoint
    is bitwise the uninterrupted one (the CLI runs deterministic
    algorithms)."""
    import os
    import shutil
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    argv = ["--arch", "mamba2-2.7b", "--reduced", "--steps", "4", "--global-batch", "2",
            "--seq-len", "64", "--ckpt-every", "2", "--log-every", "1"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_family_")
    try:
        full_dir, cut_dir = os.path.join(tmp, "full"), os.path.join(tmp, "cut")
        full = _train_cli("(h)", "mamba2 uninterrupted", [*argv, "--ckpt-dir", full_dir], env)
        os.makedirs(cut_dir)
        shutil.copytree(os.path.join(full_dir, f"step_{2:08d}"),
                        os.path.join(cut_dir, f"step_{2:08d}"))
        resumed = _train_cli("(h)", "mamba2 resumed",
                             [*argv, "--ckpt-dir", cut_dir, "--resume"], env)
        want = {k: v for k, v in full.items() if int(k) > 2}
        if sorted(full) != ["1", "2", "3", "4"] or resumed != want:
            raise AssertionError(f"(h) resumed losses {resumed} against {full}")
        step4 = [os.path.join(d, f"step_{4:08d}", "arrays.npz") for d in (cut_dir, full_dir)]
        if not _npz_equal(*step4):
            raise AssertionError("(h) the resumed run's step-4 checkpoint differs")
        import numpy as np

        with np.load(step4[1]) as z:
            stacked = "['params']/['layers']/['A_log']" in z.files
        if not stacked:
            raise AssertionError("(h) the checkpoint lacks mamba2's stacked layer leaves")
        log(f"[train] (h) reduced mamba2: the resumed run's steps 3-4 {resumed} print as the "
            f"uninterrupted run's, its step-4 checkpoint is bitwise the uninterrupted one, "
            f"with mamba2's layer leaves stacked under ['layers'] as in the JAX CLI")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _pipe_stage_fn(model, cfg, first: int, positions):
    """Stage function of (i): layers ``first``... of qwen2-0.5b on ``h``,
    each under grad a checkpoint as ``cfg.remat`` asks, as
    ``Transformer._layers`` runs them."""
    import torch

    from repro_torch.models.transformer import _REMAT

    thetas, windows = cfg.theta_array(), cfg.window_array()
    g = cfg.group_size

    def stage(layers_, h):
        for j, sub in enumerate(layers_):
            i = first + j

            def layer(x, sub=sub, theta=thetas[i // g, i % g], window=int(windows[i // g, i % g])):
                return model._layer(sub, x, positions, theta, window)[0]

            if cfg.remat != "none" and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(layer, h, use_reentrant=False,
                                                      **_REMAT[cfg.remat])
            else:
                h = layer(h)
        return h

    return stage


def _pipe_loss(out, probe):
    """(i)'s loss, the same on every rank: the outputs' inner product with
    ``probe``, in f32."""
    return (out.float() * probe).sum()


def _pipe_reference(model, cfg, params, x, probe, positions):
    """The one-device gradient of (i)'s loss: the 24 layers in sequence, one
    microbatch at a time, the last first (the order in which the
    pipeline's backward, as the reference's scan, sums a stage's
    gradients). Returns the outputs, the microbatches' gradient, every
    layer leaf's gradient in ``params.layers.parameters()`` order (on the
    host) and the forward and backward ms."""
    import torch

    stage = _pipe_stage_fn(model, cfg, 0, positions)
    params.layers.requires_grad_()
    leaves = list(params.layers.parameters())
    outs, g_x, g_w = [None] * len(x), [None] * len(x), None
    fwd_ms = bwd_ms = 0.0
    for m in reversed(range(len(x))):
        xm = x[m].detach().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = stage(params.layers, xm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(_pipe_loss(y, probe[m]), [xm, *leaves])
        torch.cuda.synchronize()
        fwd_ms += 1e3 * (t1 - t0)
        bwd_ms += 1e3 * (time.perf_counter() - t1)
        outs[m], g_x[m] = y.detach(), grads[0]
        g_w = list(grads[1:]) if g_w is None else [a + b for a, b in zip(g_w, grads[1:])]
    params.layers.requires_grad_(False)
    return (torch.stack(outs), torch.stack(g_x), [g.cpu() for g in g_w], fwd_ms, bwd_ms)


def phase_train_pipeline() -> None:
    """(i) ``train.pipeline.pipeline_apply`` run by four gloo ranks on the
    card (processes of this script, ``--pipe-rank``): qwen2-0.5b as
    published (bf16) cut into 4 stages of 6 layers, each rank holding only
    its stage, on 4 microbatches of B 1 x S 4096 (the token embeddings),
    under grad, each layer a checkpoint as ``remat`` asks; every rank
    takes the same f32 loss's backward. Every rank's outputs against the
    24 layers run in sequence here, its stage's gradients and the
    microbatches' against the one-device gradient of the same loss
    (:func:`_pipe_reference`), computed here first."""
    import socket
    import tempfile

    import torch

    t_phase = time.perf_counter()
    bundle, params = _lm("qwen2-0.5b")
    cfg, model = bundle.cfg, bundle.model
    per = cfg.n_layers // PIPE_STAGES
    positions = torch.arange(TRAIN_SEQ, dtype=torch.int32, device="cuda").expand(1, TRAIN_SEQ)
    with torch.no_grad():
        x = model._embed(params, _tokens(cfg.vocab, PIPE_MICRO, TRAIN_SEQ))[:, None]
    gen = torch.Generator(device="cuda").manual_seed(PIPE_PROBE_SEED)
    probe = torch.randn(x.shape, generator=gen, device="cuda", dtype=torch.float32)
    ref, ref_gx, ref_gw, ref_fwd_ms, ref_bwd_ms = _pipe_reference(
        model, cfg, params, x, probe, positions)
    n_leaves = len(ref_gw) // cfg.n_layers  # the layers are alike
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(x.cpu(), f"{tmp}/x.pt")
        torch.save(probe.cpu(), f"{tmp}/probe.pt")
        for s in range(PIPE_STAGES):
            torch.save(params.layers[s * per:(s + 1) * per].cpu(), f"{tmp}/stage{s}.pt")
        del params, x, probe
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = []
        for rank in range(PIPE_STAGES):
            with open(f"{tmp}/rank{rank}.log", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--pipe-rank", str(rank),
                     tmp, str(port)], stdout=out, stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(1.0, PIPE_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        for rank in range(PIPE_STAGES):
            for line in Path(f"{tmp}/rank{rank}.log").read_text().splitlines():
                log(line if line.startswith("[train]") else f"[train] (i) rank {rank}| {line}")
        rcs = [p.returncode for p in procs]
        if any(rcs):
            raise AssertionError(f"(i) a pipeline rank failed: exit codes {rcs}")
        got = [torch.load(f"{tmp}/grad{r}.pt") for r in range(PIPE_STAGES)]
        peaks = [json.loads(Path(f"{tmp}/stats{r}.json").read_text())["peak"]
                 for r in range(PIPE_STAGES)]
    out_same = [bitwise_equal(g["out"].cuda(), ref) for g in got]
    out_diff = max(max_abs_err(g["out"].cuda(), ref) for g in got)
    gx_scale = float(ref_gx.double().abs().max())
    gx_err = [max_abs_err(g["gx"].cuda(), ref_gx) / gx_scale for g in got]
    gx_same = [bitwise_equal(g["gx"].cuda(), ref_gx) for g in got]
    gx_alike = all(bitwise_equal(g["gx"], got[0]["gx"]) for g in got)
    gw_err, gw_same, worst = [], [], None
    for r, g in enumerate(got):
        want = ref_gw[r * per * n_leaves:(r + 1) * per * n_leaves]
        if len(g["gw"]) != len(want):
            raise AssertionError(f"(i) rank {r}: {len(g['gw'])} stage gradients, "
                                 f"{len(want)} leaves")
        errs = []
        for j, (a, b) in enumerate(zip(g["gw"], want)):
            b = b.cuda()
            errs.append(max_abs_err(a.cuda(), b) / max(float(b.double().abs().max()), 1e-30))
            if worst is None or errs[-1] > worst[0]:
                worst = (errs[-1], r, j)
        gw_err.append(max(errs))
        gw_same.append(all(bitwise_equal(a.cuda(), b.cuda()) for a, b in zip(g["gw"], want)))
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"[train] (i) pipeline_apply, qwen2-0.5b {cfg.param_dtype} in {PIPE_STAGES} stages of "
        f"{per} layers on {PIPE_STAGES} gloo ranks sharing the card, {PIPE_MICRO} microbatches "
        f"of B 1 x S {TRAIN_SEQ}, under grad (remat {cfg.remat!r}): every rank's outputs "
        f"{'bitwise' if all(out_same) else 'NOT bitwise'} the {cfg.n_layers} layers in sequence "
        f"(largest difference {out_diff:.3g}); ranks exited {rcs} after {ranks_s:.1f} s; the "
        f"sequence here (one device, a microbatch at a time) forward {ref_fwd_ms:.1f} ms, "
        f"backward {ref_bwd_ms:.1f} ms; {card_name_power()}")
    log(f"[train] (i) gradients against the one-device gradient, of each leaf's largest |g| "
        f"(bar {PIPE_GRAD_BAR:g}): stage leaves by rank {[f'{e:.3g}' for e in gw_err]}, "
        f"bitwise {gw_same} (worst: rank {worst[1]} leaf {worst[2]}); the microbatches' by rank "
        f"{[f'{e:.3g}' for e in gx_err]}, bitwise {gx_same}, alike on every rank: {gx_alike}")
    log(f"[train] (i) peak GB by rank {[round(p / 1e9, 2) for p in peaks]}, "
        f"{sum(peaks) / 1e9:.2f} together against the card's {card / 1e9:.2f}; "
        f"(i) in {time.perf_counter() - t_phase:.1f} s; "
        f"{card_name_power()}")
    if not all(out_same):
        raise AssertionError(f"(i) pipeline outputs differ from the sequence: {out_diff}")
    if max(gw_err) > PIPE_GRAD_BAR or max(gx_err) > PIPE_GRAD_BAR or not gx_alike:
        raise AssertionError(f"(i) pipeline gradients off the one-device gradient: stage "
                             f"{gw_err}, microbatches {gx_err}, alike {gx_alike}")


def pipe_rank_main(rank: int, tmp: str, port: int) -> int:
    """One rank of (i) (run as ``chip_smoke.py --pipe-rank R DIR PORT``)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=PIPE_STAGES, rank=rank,
                            timeout=datetime.timedelta(seconds=PIPE_TIMEOUT_S))
    try:
        from repro_torch.core import ProcessMesh, comm
        from repro_torch.train.pipeline import pipeline_apply

        mesh = ProcessMesh((PIPE_STAGES,), ("pipe",))
        bundle = _bundle("qwen2-0.5b")
        per = bundle.cfg.n_layers // PIPE_STAGES
        stage = torch.load(f"{tmp}/stage{rank}.pt", weights_only=False).to(mesh.device)
        stage.requires_grad_()
        x = torch.load(f"{tmp}/x.pt").to(mesh.device).requires_grad_()
        probe = torch.load(f"{tmp}/probe.pt").to(mesh.device)
        positions = torch.arange(TRAIN_SEQ, dtype=torch.int32,
                                 device=mesh.device).expand(1, TRAIN_SEQ)
        fn = _pipe_stage_fn(bundle.model, bundle.cfg, rank * per, positions)
        # One microbatch through the stage and back first, on every rank at
        # once: the first checkpointed layer's one-time costs (imports,
        # cuBLAS's handle) would otherwise fall on the pipeline's steps, one
        # stage after another.
        t0 = time.perf_counter()
        xw = x[0].detach().requires_grad_()
        torch.autograd.grad(fn(stage, xw).float().sum(), [xw, *stage.parameters()])
        del xw
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0)
        comm.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_apply(fn, stage, x, mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = (dict(comm.calls), dict(comm.received))
        _pipe_loss(out, probe).backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        torch.save({"out": out.detach().cpu(), "gx": x.grad.cpu(),
                    "gw": [p.grad.cpu() for p in stage.parameters()]}, f"{tmp}/grad{rank}.pt")
        Path(f"{tmp}/stats{rank}.json").write_text(json.dumps({"peak": peak}))
        n = sum(p.numel() for p in stage.parameters())
        steps = PIPE_MICRO + PIPE_STAGES - 1
        log(f"[train] (i) rank {rank}: stage {rank} (layers {rank * per}-"
            f"{rank * per + per - 1}, {n / 1e6:.1f} M parameters), a microbatch through the "
            f"stage and back first in {warm_ms:.1f} ms, forward {steps} steps in "
            f"{1e3 * (t1 - t0):.1f} ms, collectives {fwd[0]}, bytes in {fwd[1]}; backward "
            f"{steps} steps in {1e3 * (t2 - t1):.1f} ms, collectives "
            f"{ {k: v for k, v in comm.calls.items() if k not in fwd[0]} }, bytes in "
            f"{ {k: v for k, v in comm.received.items() if k not in fwd[1]} }; held "
            f"{held / 1e9:.2f} GB at entry, peak {peak / 1e9:.2f} GB; {card_name_power()}")
    finally:
        dist.destroy_process_group()
    return 0


# [train] (j): the trainers on a process mesh, four gloo ranks of this script
# sharing the card (``--mesh-rank``), against the one-device trainers run
# here. qwen2-0.5b at its published width, cut to 4 of its 24 layers.
MESH_RANKS = 4
MESH_LAYERS = 4
MESH_SEQ = 2048                                      # B 1 x S 2048 a rank
MESH_HIER = ((2, 2, 1), ("pod", "data", "model"))    # int8, sync_every 2
MESH_SYNC = ((2, 2), ("data", "model"))              # FSDP over data, the compute over model
MESH_CP = ((1, 4), ("data", "model"))                # the compute over 4 model ranks
MESH_HIER_STEPS = 3                                  # 2 local steps, a sync, 1 more
MESH_SYNC_EVERY = 2
MESH_SYNC_STEPS = 2
MESH_TIMEOUT_S = 300
MESH_LR = 1e-3
# The legs whose compute splits over model (make_train_artifacts' TPSplit):
# mode -> (mesh, arch, config overrides (None: the reduced config, f32),
# steps, S, where the one-device reference runs). qwen2-0.5b computes in
# f32 over its bf16 weights, as [lm-mesh] does: in bf16 a row-split product
# rounds each rank's partial product before the sum, where one device
# rounds the whole product once, and the moments follow the gradients'
# last bits past the 1e-5 bar. grok-1 (1 of 64 layers) computes in bf16 as
# published (in f32 its one-device reference does not fit the card): one
# step, whose AdamW update is the gradients' signs. In bf16 the split's
# partial products flip the sign of the gradients that lie within their
# rounding, and a flip moves its element by 2 lr: on the card 1.3-1.9% of
# grok's sampled elements lay past the 99% bar's 1e-5 (PERF.md). So its loss
# and grad norm are held to one bf16 rounding (2^-8 relative,
# MESH_BAR_BF16) and every parameter to 2 lr per step plus one bf16
# rounding of its value (the flips' bar); the shares within 1e-5 of the
# largest and the moments are read, not gated. Its 6.5 G parameters are
# compared at MESH_SAMPLE elements a leaf, drawn from a seed. zamba2-1.2b at
# its published widths, 7 of 38 layers (one application of the shared block
# over 6 mamba layers, then a tail layer), on (2, 2): its mamba layers'
# in_proj and conv on the stored column blocks, gathered, each rank
# stepping its own 32 of the 64 SSM heads; the shared block's attention by
# heads, its MLP Megatron's. It takes one step in f32 over f32 weights, so
# that its gradients are held too: the first step's m is (1 - b1) times
# the clipped gradient, and each leaf's is held within 1e-4 of the leaf's
# largest (1e-8 floor: tests/test_torch_train_families.py's gradient bar).
# A second step is not held to the moments' bar: AdamW's first update moves
# every element by about lr times the sign of its gradient, so an element
# whose gradient lies within the reordered sums' noise of 0 moves 2 lr the
# other way, and the second gradient is taken at another point. At S 2048
# the SSM's gradients carry that noise in many elements: on the CPU, at a
# reduced width (d_model 256, S 2048), 54% of the second step's m lay
# within 1e-5 of the largest (93% in f32 weights), and the one-device f32
# trainer's own second-step m against an f64 run's only 80%.
MESH_SPLIT = {
    "sync": (MESH_SYNC, "qwen2-0.5b", {"n_layers": MESH_LAYERS, "compute_dtype": "float32"},
             MESH_SYNC_STEPS, MESH_SEQ, "cuda"),
    "seq": (MESH_CP, "qwen2-0.5b", {"n_layers": MESH_LAYERS, "compute_dtype": "float32"},
            MESH_SYNC_STEPS, MESH_SEQ, "cuda"),
    "llama4": (MESH_SYNC, "llama4-maverick-400b-a17b", None, MESH_SYNC_STEPS, 64, "cpu"),
    "grok": (MESH_CP, "grok-1-314b", {"n_layers": 1}, 1, 4096, "cuda"),
    "zamba2": (MESH_SYNC, "zamba2-1.2b",
               {"n_layers": 7, "compute_dtype": "float32", "param_dtype": "float32"}, 1,
               MESH_SEQ, "cuda"),
}
MESH_FIRST = ("sync", "seq", "llama4", "zamba2")  # trained before the checks; grok after
MESH_SAMPLE = 4096
MESH_BAR = 1e-4  # losses and grad norms, relative; a leaf's gradient, of its largest
MESH_BAR_BF16 = 2.0 ** -8  # the same in bf16 compute: one bf16 rounding
# Each leg's peak GB a rank (torch.cuda.max_memory_allocated, weights drawn
# and steps) in PR 31's run of this script, before the FSDP gather point
# (NVIDIA H100 80GB HBM3, 700 W); each rank's line prints its own beside it.
PR31_PEAK_GB = {"hier": 7.86, "sync": 3.96, "seq": 3.90, "llama4": 2.62, "zamba2": 6.45,
                "grok": 17.96}
PR31_SERVE_PEAK_GB = {"heads": 1.45, "seq": 1.11, "grok": 8.13, "whisper": 0.58, "mamba2": 1.96}


# [lm-mesh]: the (j) ranks serve after they train: make_serve_artifacts on a
# process mesh, each rank holding its parameter shards, its batch slice and
# its cache shards, against the one-device serving of its batch slice run
# here first. Compute in f32 over the bf16 weights (bf16 rounding of the
# logits alone is above the 5e-4 bar), a bf16 cache unless the leg says
# otherwise (ServeLeg.cache_dtype), FSDP off (the dry run's policy below
# 1e9 parameters; the data extent is 1 for grok).
# Published widths, cut in depth only (ServeLeg.overrides).
#
# The transformer-backbone legs compute only their share over model (the
# compute split: no parameter gathered over model). qwen2-0.5b, 4 of 24
# layers: its 2 KV heads split over 2 ("heads") but not over 4 ("seq":
# shards of 8192 positions, the prompt crossing one). grok-1, 1 of 64
# layers: its 8 KV heads over 4 ("heads"), its experts' d_ff over 4 ("tp",
# MESH_SPLIT["grok"]); a rank holds and computes on a quarter of its 6.5 G
# parameters. Expert choices can flip under a reordered sum (PR 24's rule,
# agreeing_rows): a call's logits are held on the rows whose choices agreed
# at every call so far, a flip is printed and fails above a 1e-5 gate
# margin, and a call with no row held fails; grok serves B 2, so that one
# flipped row leaves a row to hold.
#
# whisper-medium, 2 of 24 encoder and 4 of 24 decoder layers, on (2, 2):
# its 16 heads split over model in the encoder, the decoder's cached
# self-attention (its 16 KV heads) and the cross-attention, its GELU MLPs
# Megatron's, its tied embedding vocab-parallel both ways. Its cache is the
# decoder's physical 448 positions. mamba2-2.7b, 4 of 64 layers, on (1, 4):
# in_proj's 10,576 columns and the conv's 5,376 channels are computed on
# each rank's stored block (2,644 and 1,344 a rank) and gathered, each rank
# steps its own 20 of the 80 SSM heads, the gated norm sums its squares
# over model and out_proj is row-parallel; its cache is O(1) in the
# sequence (the conv state whole on every rank, the SSM state by heads). Its
# cache is f32: the conv state is its only leaf in the cache's dtype, and
# in bf16 the split's reordered sums flip roundings of it, which carry into
# every decode step (4.56e-04 of the largest logit at step 8 against the
# 5e-4 bar, PERF.md); f32 holds the split's own error.
#
# Every call is held to the reference's bars, prefill 1e-4 and decode 5e-4
# of the largest logit: row-split products reorder sums, so no call is
# bitwise by design (the bitwise calls are printed).
class ServeLeg(NamedTuple):
    extents: tuple
    names: tuple
    arch: str
    overrides: dict  # the config's depth, cut
    b: int
    prompt: int
    cache: int
    seed: int        # tokens and frontend inputs
    cache_dtype: str = "bfloat16"


SERVE_MESHES = {
    "heads": ServeLeg((2, 2), ("data", "model"), "qwen2-0.5b", {"n_layers": MESH_LAYERS},
                      4, 4096, 32768, 2),
    "seq": ServeLeg((1, 4), ("data", "model"), "qwen2-0.5b", {"n_layers": MESH_LAYERS},
                    1, 12288, 32768, 3),
    "grok": ServeLeg((1, 4), ("data", "model"), "grok-1-314b", {"n_layers": 1},
                     2, 4096, 8192, 4),
    "whisper": ServeLeg((2, 2), ("data", "model"), "whisper-medium",
                        {"n_enc_layers": 2, "n_dec_layers": 4}, 4, 256, 448, 5),
    "mamba2": ServeLeg((1, 4), ("data", "model"), "mamba2-2.7b", {"n_layers": 4},
                       2, 4096, 4096, 6, "float32"),
}
SERVE_STEPS = 8
SERVE_BAR = 5e-4          # decode logits, of the largest (the reference's serving bar)
SERVE_PREFILL_BAR = 1e-4  # prefill logits, of the largest (its forward bar)


def _serve_bundle(mode: str):
    leg = SERVE_MESHES[mode]
    return _family_bundle(leg.arch, **leg.overrides, compute_dtype="float32")


def _serve_shapes(mode: str):
    """``mode``'s decode shape (the whole batch) and its prefill shape."""
    from repro_torch.configs.common import ShapeSpec

    leg = SERVE_MESHES[mode]
    return (ShapeSpec("serve", "decode", leg.cache, leg.b),
            ShapeSpec("serve", "prefill", leg.cache, leg.b))


def _serve_params(bundle, art, device, mesh):
    """The weights from seed 0, drawn on the card, cut to this rank's
    shards; a giant's ranks draw it whole in turn, so that one whole copy
    is on the card at a time."""
    import torch
    import torch.distributed as dist

    turns = MESH_RANKS if mesh is not None and bundle.arch_id == "grok-1-314b" else 1
    params = None
    for turn in range(turns):
        if turns == 1 or turn == mesh.rank:
            whole = bundle.model.init_params(torch.Generator(device=device).manual_seed(0))
            params = art.shard(whole)
            del whole
            torch.cuda.empty_cache()
        if turns > 1:
            dist.barrier()
    return params


def _serve_run(mode: str, mesh=None, rows=None) -> dict:
    """[lm-mesh]'s prefill and ``SERVE_STEPS`` decode steps of ``mode`` on
    ``mesh`` (this rank's shards and batch slice) or on one device over the
    batch ``rows`` (the reference). Weights drawn on the card from seed 0,
    tokens and the stub frontends' inputs from ``mode``'s seed. Returns the
    logits (CPU), ms and comm's table of each call, each call's MoE routing
    (CPU), the bytes held and the parameter bytes a call computes on, the
    split, and the peak GB while the weights were drawn and while the calls
    ran."""
    import torch

    from repro_torch.core import comm
    from repro_torch.launch import dryrun
    from repro_torch.optim.tree import named_leaves
    from repro_torch.train.steps import make_serve_artifacts

    leg = SERVE_MESHES[mode]
    bundle = _serve_bundle(mode)
    shape, _ = _serve_shapes(mode)
    toks = _tokens(bundle.cfg.vocab, leg.b, leg.prompt + SERVE_STEPS, seed=leg.seed)
    gen = torch.Generator(device="cuda").manual_seed(leg.seed)
    extra = {}
    for name, make in bundle.extra_inputs.items():
        spec = make(leg.b, leg.prompt)
        extra[name] = torch.randn(spec.shape, generator=gen, device="cuda", dtype=spec.dtype)
    if mesh is None:
        toks, extra = toks[rows], {k: v[rows] for k, v in extra.items()}
        shape = dataclasses.replace(shape, global_batch=toks.shape[0])
    art = make_serve_artifacts(bundle, shape, mesh, fsdp_axis=None,
                               cache_dtype=getattr(torch, leg.cache_dtype))
    if mesh is not None:
        toks = mesh.shard(toks, art.token_spec, "tokens").contiguous()
        extra = {k: mesh.shard(v, (art.batch_axes,) + (None,) * (v.dim() - 1), k).contiguous()
                 for k, v in extra.items()}
    params = _serve_params(bundle, art, toks.device, mesh)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()  # from here: serving, the weights in place
    logits, ms, tables, routes, gathered = [], [], [], [], []
    # [dryrun] (e): the prefill's and the first decode's rise on the card
    # (the call's peak less what was allocated before it), and the serving
    # peak across the per-call resets
    call_mem, hwm = [], 0
    state = None
    with _RoutingTap() as tap:
        for call in range(1 + SERVE_STEPS):
            comm.reset_stats()
            measure = mesh is not None and call < 2
            if measure:
                torch.cuda.synchronize()
                hwm = max(hwm, torch.cuda.max_memory_allocated())
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if call == 0:
                out, state = art.prefill_fn(params, {"tokens": toks[:, :leg.prompt], **extra})
            else:
                i = leg.prompt + call - 1
                out, state = art.decode_fn(params, state, toks[:, i:i + 1], i)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if measure:
                call_mem.append(torch.cuda.max_memory_allocated() - base)
            tables.append(dryrun._table())
            gathered.append(comm.gathered["peak"])
            logits.append(out.float().cpu())
            routes.append(tap.take())

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in named_leaves(tree).values())

    held = nbytes(params) + nbytes(state) + nbytes(extra) + toks.numel() * toks.element_size()
    whole_in = leg.b * (leg.prompt + SERVE_STEPS) * toks.element_size() + nbytes(
        {k: make(leg.b, leg.prompt) for k, make in bundle.extra_inputs.items()})
    replica = nbytes(art.params_sds) + nbytes(art.state_sds) + whole_in
    split = art.split
    return dict(logits=logits, ms=ms, tables=tables, routes=routes, held=held, replica=replica,
                gathered=gathered,
                computed=art.computed_bytes(art.params_sds), draw_peak=draw_peak,
                peak=max(hwm, torch.cuda.max_memory_allocated()) / 1e9, call_mem=call_mem,
                kv=None if split is None else split.kv)


def _serve_priced(mode: str) -> dict:
    """The dry run's price of [lm-mesh]'s prefill and decode calls of
    ``mode`` on each rank of its mesh (``price_lm`` on a ``MeshLayout``,
    meta tensors, no FLOP count, the leg's cache dtype)."""
    import torch

    from repro_torch.core.mesh import MeshLayout
    from repro_torch.launch import dryrun

    leg = SERVE_MESHES[mode]
    bundle = _serve_bundle(mode)
    decode, prefill = _serve_shapes(mode)
    out = {}
    for r in range(MESH_RANKS):
        layout = MeshLayout(leg.extents, leg.names, r)
        kw = dict(fsdp_axis=None, cache_dtype=getattr(torch, leg.cache_dtype), count_flops=False)
        out[r] = (dryrun.price_lm(bundle, prefill, layout, prompt_len=leg.prompt, **kw),
                  dryrun.price_lm(bundle, decode, layout, cache_index=leg.prompt, **kw))
    return out


def _serve_rank(rank: int, meshes: dict, ref) -> dict:
    """[lm-mesh] on this rank: each mode served on its mesh, held to the
    references (``ref(key)``: a reference's bytes on the card, its dtype
    and shape). No kernel launch; no parameter gathered over model."""
    import torch

    from repro_torch.kernels import cuda

    def ref_t(key):
        raw, dtype, shape = ref(key)
        return raw.view(dtype).reshape(shape).cpu()

    before = dict(cuda.launches)
    out = {}
    for mode, mesh in meshes.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = _serve_run(mode, mesh)
        wall = time.perf_counter() - t0
        d = mesh.axis_index("data")
        agree, errs, bitwise, rows = None, [], [], []
        for call, got in enumerate(run["logits"]):
            key = f"serve/{mode}/{d}"
            want_routes = [(ref_t(f"{key}/route/{call}/{layer}/idx"),
                            ref_t(f"{key}/route/{call}/{layer}/gates"))
                           for layer in range(len(run["routes"][call]))]
            agree = agreeing_rows(run["routes"][call], want_routes,
                                  f"rank {rank} {mode} call {call}", "[lm-mesh]", agree,
                                  ("mesh", "one device"))
            want = ref_t(f"{key}/{call}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"[lm-mesh] rank {rank} {mode}: non-finite logits")
            keep = list(range(got.shape[0])) if agree is None else agree.nonzero().flatten().tolist()
            errs.append(float((got[keep] - want[keep]).abs().max() / want[keep].abs().max()))
            bitwise.append(torch.equal(got, want))
            rows.append(len(keep))
        bars = [SERVE_PREFILL_BAR] + [SERVE_BAR] * SERVE_STEPS
        over = [(c, e) for c, (e, bar) in enumerate(zip(errs, bars)) if e > bar]
        if over:
            raise AssertionError(f"[lm-mesh] rank {rank} {mode}: logits of calls {over} above "
                                 f"the bars {SERVE_PREFILL_BAR} (prefill) / {SERVE_BAR} (decode) "
                                 f"of the largest logit")
        over_model = [k for t in run["tables"] for k in t
                      if k.split()[0] == "all_gather" and "model" in k.split()[1]]
        if over_model:
            raise AssertionError(f"[lm-mesh] rank {rank} {mode}: parameters gathered over "
                                 f"model under the compute split: {over_model}")
        out[mode] = dict(errs=errs, bitwise=bitwise, rows=rows, n_rows=got.shape[0], ms=run["ms"],
                         tables=run["tables"], held=run["held"], replica=run["replica"],
                         gathered=run["gathered"],
                         computed=run["computed"], kv=run["kv"], wall_s=wall,
                         peak=run["peak"], draw_peak=run["draw_peak"], coords=mesh.coords,
                         call_mem=run["call_mem"])
        del run
    if dict(cuda.launches) != before:
        raise AssertionError(f"[lm-mesh] rank {rank} launched a kernel: {dict(cuda.launches)}")
    return out


def _serve_refs(mode: str) -> dict:
    """[lm-mesh]'s one-device references of ``mode``, one for each data
    slice of the batch: the logits and the MoE routing of every call."""
    leg = SERVE_MESHES[mode]
    refs = {}
    d = leg.extents[0]
    for i in range(d):
        run = _serve_run(mode, rows=slice(i * leg.b // d, (i + 1) * leg.b // d))
        for call, (x, layers_) in enumerate(zip(run["logits"], run["routes"])):
            refs[f"serve/{mode}/{i}/{call}"] = x
            for layer, (idx, gates) in enumerate(layers_):
                refs[f"serve/{mode}/{i}/route/{call}/{layer}/idx"] = idx
                refs[f"serve/{mode}/{i}/route/{call}/{layer}/gates"] = gates
        del run
    return refs


def _serve_report(res: list, priced: dict, ref_s: float) -> None:
    """[lm-mesh]'s lines: per mesh and rank, the bytes held against one
    replica's, the parameter bytes a call computes on and gathers, peak GB,
    ms, the logits against the bars, the rows held, and the bytes in per
    collective as comm counts them, each call held equal to the dry run's
    price."""
    card = card_name_power()
    for mode, leg in SERVE_MESHES.items():
        for rank, r in enumerate(res):
            got = r["serve"][mode]
            pre, dec = priced[mode][rank]
            bad = [c for c, t in enumerate(got["tables"])
                   if t != (pre if c == 0 else dec)["collectives"]]
            if bad:
                raise AssertionError(f"[lm-mesh] {mode} rank {rank}: counted bytes of calls "
                                     f"{bad} differ from the dry run's price: "
                                     f"{got['tables'][bad[0]]} != "
                                     f"{(pre if bad[0] == 0 else dec)['collectives']}")
            for call, (row, measured) in enumerate(zip((pre, dec), got["call_mem"])):
                log(price_check(f"[lm-mesh] {mode} rank {rank} "
                                f"{'prefill' if call == 0 else 'decode'}", measured,
                                row["rank_bytes"]["transient"]) + f"; {card}")
            priced_g = [(pre if c == 0 else dec)["rank_bytes"]["gathered"]
                        for c in range(len(got["gathered"]))]
            if got["gathered"] != priced_g:
                raise AssertionError(f"[lm-mesh] {mode} rank {rank}: gathered peaks "
                                     f"{got['gathered']} B against the dry run's {priced_g} B")
            gathered = [sum(e["bytes"] for k, e in t.items() if k.split()[0] == "all_gather")
                        for t in got["tables"]]
            over_model = [sum(e["bytes"] for k, e in t.items()
                              if k.split()[0] == "all_gather" and "model" in k.split()[1])
                          for t in got["tables"]]
            decode_ms = statistics.median(got["ms"][1:])
            into = [sum(e["bytes"] for e in t.values()) for t in got["tables"]]
            log(f"[lm-mesh] {mode} {dict(zip(leg.names, leg.extents))} rank {rank} at "
                f"{got['coords']}: {leg.arch} cut to {leg.overrides}, f32 compute over bf16 "
                f"weights, B {leg.b}, cache {leg.cache}, prompt {leg.prompt}, {SERVE_STEPS} "
                f"decode steps, KV cache split {got['kv']!r}, the compute split over model; held "
                f"{got['held']:,} B against one replica's {got['replica']:,} B; computes on "
                f"{got['computed']:,} B of parameters, gathers {gathered[0]:,} B of them a "
                f"prefill and {max(gathered[1:]):,} B a decode step ({over_model[0]:,} / "
                f"{max(over_model[1:]):,} B over model), holds at most {got['gathered'][0]:,} B "
                f"of them gathered a prefill and {max(got['gathered'][1:]):,} B a decode step "
                f"(one unit; == the dry run's price); peak {got['peak']:.2f} GB serving (PR 31: "
                f"{PR31_SERVE_PEAK_GB[mode]} GB; {got['draw_peak']:.2f} GB drawing the weights"
                f"{' whole, the ranks in turn' if leg.arch == 'grok-1-314b' else ''}); prefill "
                f"{got['ms'][0]:.1f} ms, decode median "
                f"{decode_ms:.1f} ms a step ({[round(x, 1) for x in got['ms'][1:]]}); logits "
                f"against the one-device serving of its batch slice: prefill max rel err "
                f"{got['errs'][0]:.3g} (bar {SERVE_PREFILL_BAR}), decode "
                f"{max(got['errs'][1:]):.3g} (bar {SERVE_BAR}), bitwise "
                f"{sum(got['bitwise'])}/{1 + SERVE_STEPS} calls, rows held (routing agreed) "
                f"{got['rows']} of {got['n_rows']}; "
                f"bytes into the rank a prefill {into[0]:,}, a decode step "
                f"{into[1]:,}; per collective a prefill {got['tables'][0]}, a decode step "
                f"{got['tables'][1]}: each call == the [dryrun] price (price_lm on a "
                f"MeshLayout); {card}")
    wall = max(r["serve"][m]["wall_s"] for r in res for m in SERVE_MESHES)
    log(f"[time] [lm-mesh] references here {ref_s:.1f} s; the ranks served the "
        f"{len(SERVE_MESHES)} legs in "
        f"{sum(max(r['serve'][m]['wall_s'] for r in res) for m in SERVE_MESHES):.1f} s "
        f"(the longest leg {wall:.1f} s)")


def _split_bundle(mode: str):
    """The bundle of a split leg (``MESH_SPLIT``)."""
    from repro_torch.configs.registry import get_arch

    _, arch, overrides, *_ = MESH_SPLIT[mode]
    return get_arch(arch, reduced=True) if overrides is None else _family_bundle(arch, **overrides)


def _mesh_setup(mesh, mode: str):
    """(j)'s bundle, optimizer and training artifacts for ``mode``
    (``"hier"`` or a ``MESH_SPLIT`` leg) on ``mesh`` (None: one device, a
    microbatch for each data rank's slice)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.hierarchical import HierarchicalConfig
    from repro_torch.train.steps import make_train_artifacts

    if mode == "hier":
        bundle = _bundle("qwen2-0.5b", n_layers=MESH_LAYERS)
        hier_cfg = HierarchicalConfig(sync_every=MESH_SYNC_EVERY, compression="int8")
        kw = dict(hier_cfg=hier_cfg, n_micro=1 if mesh else 2, n_pods=2)
    else:
        bundle = _split_bundle(mode)
        (extents, names), *_ = MESH_SPLIT[mode]
        kw = dict(n_micro=1 if mesh else extents[names.index("data")])
    opt_cfg = AdamWConfig(lr=MESH_LR, warmup_steps=1, moment_dtype=bundle.moment_dtype)
    return bundle, opt_cfg, make_train_artifacts(bundle, opt_cfg, mesh, batch_axes=("data",),
                                                 **kw)


def _mesh_params(bundle, art, mode: str, device, mesh):
    """The weights from seed 0, trainable, cut to this rank's shards: drawn
    on the card (or on the host where the reference runs there, then
    moved). grok's ranks draw the whole model in turn, so that one whole
    copy is on the card at a time."""
    import torch
    import torch.distributed as dist

    from repro_torch.optim.tree import map_tree

    on_host = mode in MESH_SPLIT and MESH_SPLIT[mode][5] == "cpu"
    turns = MESH_RANKS if mode == "grok" and mesh is not None else 1
    params = None
    for turn in range(turns):
        if turns == 1 or turn == mesh.rank:
            gen = torch.Generator(device="cpu" if on_host else device).manual_seed(0)
            whole = bundle.model.init_params(gen)
            if on_host:
                whole = map_tree(lambda x: x.to(device), whole)
            whole.requires_grad_()
            params = whole if mode == "hier" else art.shard(whole, "params")
            del whole
            torch.cuda.empty_cache()
        if turns > 1:
            dist.barrier()
    return params


def _step_table(before_calls: dict, before_bytes: dict) -> dict:
    """What comm counted since the two snapshots, as the dry run tabulates
    it (``"op axes"`` -> calls and bytes)."""
    from repro_torch.core import comm

    return {f"{op} {','.join(axes)}": {"calls": comm.calls[(op, axes)] - before_calls.get(
                (op, axes), 0), "bytes": n - before_bytes.get((op, axes), 0)}
            for (op, axes), n in sorted(comm.received.items())
            if comm.calls[(op, axes)] - before_calls.get((op, axes), 0)}


def _mesh_train(mode: str, mesh=None) -> dict:
    """(j)'s run of ``mode`` on ``mesh`` (this rank's shards) or on one
    device (the reference, on the card or the host as ``MESH_SPLIT``
    says): weights from seed 0, batches from ``SyntheticLM`` (seed 1);
    returns the state, losses, grad norms, timings and each step's
    collectives."""
    import contextlib

    import torch

    from repro_torch.core import comm
    from repro_torch.data.pipeline import SyntheticLM, host_batch
    from repro_torch.launch.memory import LiveBytes
    from repro_torch.optim.adamw import adamw_init

    t_setup = time.perf_counter()
    bundle, opt_cfg, art = _mesh_setup(mesh, mode)
    on_host = mode in MESH_SPLIT and MESH_SPLIT[mode][5] == "cpu"
    device = mesh.device if mesh else torch.device("cpu" if on_host else "cuda")
    params = _mesh_params(bundle, art, mode, device, mesh)
    sync = None
    if mode == "hier":
        opt = adamw_init(params, opt_cfg)
        sync = art.hier.init_sync_state(params)
        params, opt = art.hier.replicate(params), art.hier.replicate(opt)
        sync = art.shard(sync, "sync")
        params, opt = art.shard(params, "params"), art.shard(opt, "opt")
        n_batch, seq, steps = 4, MESH_SEQ, MESH_HIER_STEPS
    else:
        opt = adamw_init(params, opt_cfg)  # zeros: the shards of the whole state's
        (extents, names), _, _, steps, seq, _ = MESH_SPLIT[mode]
        n_batch = extents[names.index("data")]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    setup_peak = None
    if mesh is not None:  # from here the steps' own peak (the caller reads it)
        setup_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
    ds = SyntheticLM(bundle.cfg.vocab, seq, n_batch, seed=1)

    def batch(step):
        pod = "pod" if mode == "hier" else None
        if mesh is None:
            return host_batch(ds.batch(step), device, n_pods=2 if pod else None)
        return host_batch(ds.batch(step), mesh, ("data",), pod)

    losses, norms, step_ms, sync_ms, tiers, comm_ms, tables = [], [], [], [], [], [], []
    gathered = []  # each step's peak of the parameter bytes held gathered
    # [dryrun] (e): each step's rise on the card (its peak less what was
    # allocated before it), and the steps' peak across the per-step resets;
    # a leg of more than one step takes its last under the live-bytes
    # tracker (on cuda), to read what the trace itself holds
    step_mem, hwm, traced = [], 0, None
    for step in range(steps):
        if mode == "hier" and step == MESH_SYNC_EVERY:
            before = dict(comm.received)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, sync = art.sync_fn(params, sync)
            torch.cuda.synchronize()
            sync_ms.append(1e3 * (time.perf_counter() - t0))
            tiers.append(("sync", {k: v - before.get(k, 0) for k, v in comm.received.items()
                                   if v - before.get(k, 0)}))
        b = batch(step)
        before, before_calls = dict(comm.received), dict(comm.calls)
        n_timed = len(comm.times or ())
        comm.gathered["peak"] = comm.gathered["live"]
        torch.cuda.synchronize()
        if mesh is not None:
            hwm = max(hwm, torch.cuda.max_memory_allocated())
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        trace = mesh is not None and steps > 1 and step == steps - 1
        t0 = time.perf_counter()
        with LiveBytes("cuda") if trace else contextlib.nullcontext() as live:
            params, opt, m = art.step_fn(params, opt, b)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if mesh is not None:
            step_mem.append(torch.cuda.max_memory_allocated() - base)
        if trace:
            traced = live.transient
        gathered.append(comm.gathered["peak"])
        comm_ms.append(1e3 * sum(t for *_, t in (comm.times or ())[n_timed:]))
        tiers.append(("step", {k: v - before.get(k, 0) for k, v in comm.received.items()
                               if v - before.get(k, 0)}))
        tables.append(_step_table(before_calls, before))
        losses.append(m["loss"].detach().float().cpu().reshape(-1))
        norms.append(m["grad_norm"].detach().float().cpu().reshape(-1))
    return dict(art=art, params=params, opt=opt, sync=sync, losses=losses, norms=norms,
                step_ms=step_ms, sync_ms=sync_ms, tiers=tiers, comm_ms=comm_ms, tables=tables,
                setup_s=setup_s, setup_peak=setup_peak, gathered=gathered,
                accum=art.accumulator_bytes(params) if mesh is not None else None,
                step_mem=step_mem, traced=traced,
                steps_peak=max(hwm, torch.cuda.max_memory_allocated()))


def _within_bars(got: dict, want: dict, steps: int, top: float | None = None,
                 bf16: bool = False):
    """``tests/test_torch_train.py``'s bars on parameters, on the device of
    ``got``: the largest difference (at most ``2 * lr * steps``) and the
    share of elements within 1e-5 of the largest parameter (``top``, by
    default the largest of ``want``; at least 0.99). With ``bf16`` each
    element's difference is first reduced by one bf16 rounding step of its
    reference value, as that test adds a grid step after an int8 sync."""
    import torch

    if top is None:
        top = max(float(w.double().abs().max()) for w in want.values())
    worst, close, total = 0.0, 0, 0
    for n, w in want.items():
        w = w.to(got[n].device).double()
        d = (got[n].double() - w).abs()
        if bf16:
            d = d - torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
        worst = max(worst, float(d.max()))
        close += int((d <= 1e-5 * top).sum())
        total += d.numel()
    return worst, close / total


def _sample_idx(shape, n: int, seed: int):
    """``n`` coordinates of a leaf of ``shape`` drawn from ``seed`` (all
    of them for a smaller leaf): ``[n, ndim]`` int64."""
    import numpy as np
    import torch

    numel = math.prod(shape)
    rng = np.random.default_rng(seed)
    flat = np.arange(numel) if numel <= n else np.sort(rng.choice(numel, n, replace=False))
    return torch.from_numpy(np.stack(np.unravel_index(flat, shape), axis=-1).astype(np.int64))


def _named(tree) -> dict:
    from repro_torch.optim.tree import named_leaves

    return {n: x.detach() for n, x in named_leaves(tree).items()}


def _as_bytes(x):
    """``x``'s bytes, flat (-0.0 is not +0.0)."""
    import torch

    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _save_raw(refs: dict, path: str) -> None:
    """``refs`` (``{key: CPU tensor}``) as one flat file of their bytes
    and, last, ``path + ".json"``, the index the ranks wait for."""
    index, off = {}, 0
    with open(path, "wb") as f:
        for key, x in refs.items():
            raw = _as_bytes(x).numpy()
            f.write(raw)
            index[key] = [off, raw.size, str(x.dtype).removeprefix("torch."), list(x.shape)]
            off += raw.size
    Path(path + ".tmp").write_text(json.dumps(index))
    Path(path + ".tmp").rename(path + ".json")


def _split_refs(mode: str, run: dict) -> dict:
    """A split leg's one-device reference for the ranks: its losses and
    grad norms, and its parameters and moments, whole, or for grok at
    ``MESH_SAMPLE`` coordinates a leaf (drawn from the leaf's name) with
    the largest magnitude of each part."""
    import zlib

    import torch

    refs = {}
    for i, (loss, norm) in enumerate(zip(run["losses"], run["norms"])):
        refs[f"{mode}/loss/{i}"], refs[f"{mode}/norm/{i}"] = loss, norm
    for part in ("params", "opt"):
        named = _named(run[part])
        for n, x in named.items():
            if mode != "grok" or x.dim() == 0:
                refs[f"{mode}/{part}/{n}"] = x.cpu()
                continue
            idx = _sample_idx(tuple(x.shape), MESH_SAMPLE, zlib.crc32(n.encode()))
            refs[f"{mode}/idx/{part}/{n}"] = idx
            refs[f"{mode}/{part}/{n}"] = x[tuple(idx.to(x.device).T)].cpu()
        for group in ("m", "v") if part == "opt" else ("params",):
            top = max(float(x.double().abs().max()) for n, x in named.items()
                      if part == "params" or n.startswith(group + "."))
            refs[f"{mode}/top/{group}"] = torch.tensor([top], dtype=torch.float64)
    return refs


def _train_priced(mode: str) -> dict:
    """The dry run's price of a leg's training step on each rank of its
    mesh (``price_lm`` on a ``MeshLayout``, meta tensors): the split legs'
    and the hierarchical leg's (on rank 0: every rank's units and shards
    are alike)."""
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.core.mesh import MeshLayout
    from repro_torch.launch import dryrun
    from repro_torch.optim.hierarchical import HierarchicalConfig

    if mode == "hier":
        (extents, names), seq = MESH_HIER, MESH_SEQ
        bundle = _bundle("qwen2-0.5b", n_layers=MESH_LAYERS)
        hier_cfg = HierarchicalConfig(sync_every=MESH_SYNC_EVERY, compression="int8")
        row = dryrun.price_lm(bundle, ShapeSpec("mesh", "train", seq, 4),
                              MeshLayout(extents, names, 0), hier_cfg=hier_cfg,
                              count_flops=False)
        return {r: row for r in range(MESH_RANKS)}
    (extents, names), _, _, _, seq, _ = MESH_SPLIT[mode]
    bundle = _split_bundle(mode)
    shape = ShapeSpec("mesh", "train", seq, extents[names.index("data")])
    return {r: dryrun.price_lm(bundle, shape, MeshLayout(extents, names, r), count_flops=False)
            for r in range(MESH_RANKS)}


def _check_gathered(rank: int, mode: str, got: dict, row: dict) -> None:
    """A leg's gathered peak in every step and its accumulator's bytes on
    this rank against the dry run's price (``row``: ``price_lm``'s), and
    ([dryrun] (e)) each step's rise on the card against its priced
    transient."""
    want = row["rank_bytes"]
    if set(got["gathered"]) != {want["gathered"]} or got["accum"] != want["grad_accum"]:
        raise AssertionError(f"(j) {mode} rank {rank}: gathered peaks {got['gathered']} B and "
                             f"accumulator {got['accum']} B against the dry run's "
                             f"{want['gathered']} B and {want['grad_accum']} B")
    card = card_name_power()
    last = len(got["step_mem"]) - 1
    for step, measured in enumerate(got["step_mem"]):
        traced = ""
        if step == last and got["traced"] is not None:
            traced = (f"; this step ran under the live-bytes tracker on cuda, which counted "
                      f"{got['traced']:,} B")
        log(price_check(f"[train] (j) {mode} rank {rank} step {step}", measured,
                        want["transient"]) + f"{traced}; {card}")


def _split_report(res: list, priced: dict) -> None:
    """The split legs' checks across ranks: every step's bytes in per
    collective and call == the dry run's price, and the leaves replicated
    over ``model`` bitwise alike on the ranks that differ only along it."""
    for mode, ((extents, names), arch, *_) in MESH_SPLIT.items():
        for rank, r in enumerate(res):
            got = r["split"][mode]
            want = priced[mode][rank]["collectives"]
            bad = [i for i, t in enumerate(got["tables"]) if t != want]
            if bad:
                raise AssertionError(f"(j) {mode} rank {rank}: the collectives of steps {bad} "
                                     f"differ from the dry run's price: {got['tables'][bad[0]]} "
                                     f"!= {want}")
            _check_gathered(rank, mode, got, priced[mode][rank])
        peers = {}
        for rank, r in enumerate(res):
            off_model = tuple(v for k, v in sorted(r["split"][mode]["coords"].items())
                              if k != "model")
            peers.setdefault(off_model, []).append(r["split"][mode]["replicated"])
        leaves = 0
        for group in peers.values():
            for other in group[1:]:
                if other != group[0]:
                    diff = [n for n in group[0] if group[0][n] != other.get(n)]
                    raise AssertionError(f"(j) {mode}: replicated leaves differ across the "
                                         f"model ranks: {diff[:6]}")
            leaves = len(group[0])
        rb = priced[mode][0]["rank_bytes"]
        log(f"[train] (j) {mode} ({arch} on {dict(zip(names, extents))}): every rank's bytes "
            f"in, each step, collective by collective, == the dry run's price (price_lm on a "
            f"MeshLayout), and so are its gathered peak ({rb['gathered']:,} B) and its gradient "
            f"accumulator ({rb['grad_accum']:,} B: f32 where the step sums over data, else "
            f"the gradients' dtype); its {leaves} leaves replicated over model "
            f"(the norm scales, a MoE layer's router) bitwise alike on the model ranks; "
            f"{card_name_power()}")


def phase_train_mesh() -> None:
    """(j) the sharded trainers on four gloo ranks of this script sharing
    the card (``--mesh-rank``), one world, a process mesh for each shape.
    qwen2-0.5b at its published width cut to 4 of 24 layers, B 1 x S 2048
    a rank: the hierarchical int8 trainer on (pod, data, model) = (2, 2,
    1), sync every 2 steps, 2 local steps, a sync, 1 more: every rank's
    gathered parameters, moments, counts, anchor and residuals, and its
    losses, bitwise the one-device trainer's at ``n_micro`` 2, the int8
    bytes over ``pod`` equal to the accounting. Then the sync trainer's
    compute split over ``model`` (``MESH_SPLIT``): qwen2-0.5b on (data,
    model) = (2, 2), head-parallel, and on (1, 4), context-parallel (its 2
    KV heads do not divide 4), 2 steps; reduced llama4-maverick in f32 on
    (2, 2), its experts over ``model`` (``"ep"``); grok-1 at its published
    widths, 1 of 64 layers, B 1 x S 4096 on (1, 4), each expert's d_ff over
    ``model`` (``"tp"``), one step. Each against its one-device trainer
    run here first (llama4's on the host): losses and grad norms within
    1e-4 relative, the parameters within ``tests/test_torch_train.py``'s
    bars (per element ``2 * lr * steps``, 99% within 1e-5 of the largest),
    the moments too (each rank its own shards against the same blocks of
    the reference); grok computes in bf16 (``MESH_SPLIT`` says why and how
    it is held); the leaves replicated over ``model``
    bitwise alike on the model ranks; every step's collectives == the dry
    run's price. No kernel launches. A correctness leg of gloo ranks on one
    card, not a scaling result."""
    import socket
    import tempfile

    import torch

    from repro_torch.kernels import cuda

    t_leg = time.perf_counter()
    before = dict(cuda.launches)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = []
        Path(f"{tmp}/spawned").write_text(repr(time.time()))
        for rank in range(MESH_RANKS):
            with open(f"{tmp}/rank{rank}.log", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(rank),
                     tmp, str(port)], stdout=out, stderr=subprocess.STDOUT))
        try:
            # The references while the ranks start; the ranks train once
            # they are computed (the card to themselves), and compare once
            # they are written.
            t0 = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            held_before = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            refs, ref_ms, peaks = {}, {}, {}
            for mode in ("hier", *MESH_SPLIT):
                torch.cuda.reset_peak_memory_stats()
                run = _mesh_train(mode)
                peaks[mode] = torch.cuda.max_memory_allocated() / 1e9
                if mode == "hier":
                    for part in ("params", "opt", "sync"):
                        refs.update({f"{mode}/{part}/{n}": x.cpu()
                                     for n, x in _named(run[part]).items()})
                    refs.update({f"{mode}/loss/{i}": x for i, x in enumerate(run["losses"])})
                else:
                    refs.update(_split_refs(mode, run))
                ref_ms[mode] = (run["step_ms"], run["sync_ms"])
                del run
                gc.collect()
                torch.cuda.empty_cache()
            # [lm-mesh]'s references: the one-device serving of each data
            # slice of the batch
            torch.cuda.reset_peak_memory_stats()
            t_serve = time.perf_counter()
            for mode in SERVE_MESHES:
                refs.update(_serve_refs(mode))
                gc.collect()
                torch.cuda.empty_cache()
            serve_ref_s = time.perf_counter() - t_serve
            peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.empty_cache()
            compute_s = time.perf_counter() - t0
            left = torch.cuda.memory_allocated() / 1e9
            Path(f"{tmp}/go").touch()
            _save_raw(refs, f"{tmp}/refs.bin")
            log(f"[train] (j) one-device references here in {compute_s:.1f} s (this process "
                f"held {held_before:.2f} GB before them, {left:.2f} GB after), written for "
                f"the ranks ({sum(x.numel() * x.element_size() for x in refs.values()):,} B) "
                f"in {time.perf_counter() - t0 - compute_s:.1f} s more while they trained: "
                f"hierarchical at n_micro 2, ms/step {[round(x, 1) for x in ref_ms['hier'][0]]}, "
                f"sync {[round(x, 1) for x in ref_ms['hier'][1]]} ms; "
                + "; ".join(f"{m} ({MESH_SPLIT[m][1]}{', on the host' if MESH_SPLIT[m][5] == 'cpu' else ''}) "
                            f"ms/step {[round(x, 1) for x in ref_ms[m][0]]}, peak {peaks[m]:.2f} GB"
                            for m in MESH_SPLIT)
                + f"; serving references peak {peak:.2f} GB")
            del refs
            # the dry run's prices of the split steps and of [lm-mesh]'s
            # calls, while the ranks run
            t0 = time.perf_counter()
            train_priced = {mode: _train_priced(mode) for mode in ("hier", *MESH_SPLIT)}
            priced = {mode: _serve_priced(mode) for mode in SERVE_MESHES}
            log(f"[lm-mesh] the dry run priced the split steps and the serving legs' calls for the "
                f"4 ranks here in {time.perf_counter() - t0:.1f} s while the ranks ran")
            for p in procs:
                p.wait(timeout=max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t_leg)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank in range(MESH_RANKS):
            for line in Path(f"{tmp}/rank{rank}.log").read_text().splitlines():
                log(line if line.startswith("[train]") else f"[train] (j) rank {rank}| {line}")
        rcs = [p.returncode for p in procs]
        if any(rcs):
            raise AssertionError(f"(j) a mesh rank failed: exit codes {rcs}")
        res = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(MESH_RANKS)]
    _no_flash(before, "(j)'s references")
    slow = sum(r["slow_bytes"] for r in res)
    want = sum(r["slow_accounting"] for r in res)
    log(f"[train] (j) the hierarchical trainer's two tiers, summed over the 4 ranks, bytes in "
        f"as comm counts them: fast tier (each local step: bf16 gradients summed over data, "
        f"parameters gathered over data) {sum(r['hier_fast_per_step'] for r in res):,} B a "
        f"step, slow tier (int8 shards + f32 scales over pod, once per {MESH_SYNC_EVERY} "
        f"steps) {slow:,} B a sync == the accounting {want:,} B "
        f"(sum over ranks of (pods - 1) x (int8 shard elements + 4 B x leaves)); "
        f"every rank bitwise the one-device reference; ranks ran "
        f"{max(r['wall_s'] for r in res):.1f} s; a correctness leg on gloo, four ranks on "
        f"one card, not a scaling result; {card_name_power()}")
    if slow != want:
        raise AssertionError(f"(j) slow-tier bytes {slow} != the accounting {want}")
    for rank, r in enumerate(res):
        _check_gathered(rank, "hier", r, train_priced["hier"][rank])
    rb = train_priced["hier"][0]["rank_bytes"]
    log(f"[train] (j) hier: every rank's gathered peak ({rb['gathered']:,} B, one unit) and f32 "
        f"accumulator ({rb['grad_accum']:,} B, its shards) == the dry run's price (price_lm on "
        f"a MeshLayout); {card_name_power()}")
    _split_report(res, train_priced)
    _serve_report(res, priced, serve_ref_s)
    log(f"[time] (j) with [lm-mesh] took {time.perf_counter() - t_leg:.1f} s")


def _wait_for(path: Path, what: str) -> None:
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    while not path.exists():
        if time.perf_counter() > deadline:
            raise TimeoutError(f"(j) {what} never came")
        time.sleep(0.05)


def _check_hier(rank, mesh, run, peak, ref, card) -> dict:
    """(j)'s hierarchical leg on this rank against its reference, bitwise:
    its line and its tiers' bytes."""
    import torch

    mode, art = "hier", run["art"]
    t_check = time.perf_counter()
    pod = mesh.axis_index("pod")
    held = {part: _named(run[part]) for part in ("params", "opt", "sync")}
    held_b = sum(x.numel() * x.element_size() for t in held.values() for x in t.values())
    # one replica unsharded: a pod's, with the anchor and its residuals
    replica_b = sum(ref(f"{mode}/{part}/{n}", None, True) // (
        1 if n.startswith("anchor.") else mesh.shape["pod"])
        for part, t in held.items() for n in t)
    # bitwise: the losses, then every leaf gathered over the pod's own axes
    diff = [f"loss {i}" for i, x in enumerate(run["losses"])
            if not torch.equal(_as_bytes(x.to(mesh.device)), ref(f"{mode}/loss/{i}", pod))]
    inner = tuple(a for a in mesh.axis_names if a != "pod")
    for part in held:
        whole = _named(art.gather(run[part], part, inner))
        for n, x in whole.items():
            has_pod = art.named_specs[part][n][:1] == ("pod",)
            if not torch.equal(_as_bytes(x), ref(f"{mode}/{part}/{n}", pod if has_pod else None)):
                diff.append(f"{part} {n}")
        del whole
    if diff:
        raise AssertionError(f"(j) rank {rank} {mode}: not bitwise the one-device "
                             f"run: {diff[:8]} ({len(diff)} in all)")
    check_s = time.perf_counter() - t_check
    fast = [t for kind, t in run["tiers"] if kind == "step"]
    syncs = [t for kind, t in run["tiers"] if kind == "sync"]
    slow = sum(t.get(("all_gather", ("pod",)), 0) for t in syncs)
    shard_elems = sum(x.numel() for x in held["params"].values())
    accounting = (mesh.shape["pod"] - 1) * (shard_elems + 4 * len(held["params"]))
    pod_in_step = [k for t in fast for k in t if "pod" in k[1]]
    if pod_in_step:
        raise AssertionError(f"(j) a local step sent over pod: {pod_in_step}")
    log(f"[train] (j) rank {rank} {mode} on {mesh.shape} at {mesh.coords}: losses "
        f"{[x.tolist() for x in run['losses']]} bitwise the one-device run's, and so are the "
        f"gathered parameters, moments, counts, anchor and residuals; state held {held_b:,} B "
        f"against one replica's {replica_b:,} B; peak {max(run['setup_peak'], peak):.2f} GB "
        f"(PR 31: {PR31_PEAK_GB[mode]} GB), the steps alone {peak:.2f} GB, the weights drawn "
        f"{run['setup_peak']:.2f} GB; parameters held gathered at most "
        f"{max(run['gathered']):,} B a step (one unit), f32 gradient accumulator "
        f"{run['accum']:,} B (its shards); set up in "
        f"{run['setup_s']:.1f} s, gathered and held to the references in {check_s:.1f} s; "
        f"ms/step {[round(x, 1) for x in run['step_ms']]} (in collectives "
        f"{[round(x, 1) for x in run['comm_ms']]}), sync "
        f"{[round(x, 1) for x in run['sync_ms']]} ms; bytes in: a local step {fast[0]}, the "
        f"sync {syncs[0]} (slow tier {slow:,} B, the accounting (2 - 1) x ({shard_elems:,} "
        f"int8 + 4 x {len(held['params'])} scales) = {accounting:,} B); {card}")
    return dict(slow_bytes=slow, slow_accounting=accounting,
                hier_fast_per_step=sum(sum(t.values()) for t in fast) // len(fast),
                gathered=run["gathered"], accum=run["accum"], step_mem=run["step_mem"],
                traced=run["traced"])


def _check_split(rank, mode, mesh, run, peak, ref_t, index, card) -> dict:
    """A split leg on this rank against its one-device reference (the bars
    of ``phase_train_mesh``); its line, its steps' collectives and the
    digests of its leaves replicated over ``model``."""
    import hashlib

    import torch

    art = run["art"]
    (extents, names), arch, _, steps, seq, _ = MESH_SPLIT[mode]
    t_check = time.perf_counter()
    rel = [float((got - ref_t(f"{mode}/{kind}/{i}").cpu()).abs().max()
                 / ref_t(f"{mode}/{kind}/{i}").cpu().abs().max())
           for kind in ("loss", "norm") for i, got in enumerate(run["losses" if kind == "loss"
                                                                    else "norms"])]
    bar = MESH_BAR_BF16 if mode == "grok" else MESH_BAR
    if max(rel) > bar:
        raise AssertionError(f"(j) rank {rank} {mode}: losses and grad norms {rel} above "
                             f"{bar} relative of the one-device run's")
    shares, worst_g = {}, None
    for part in ("params", "opt"):
        if mode == "grok":  # its shard at the sampled coordinates it holds
            got, want = {}, {}
            specs = art.named_specs[part]
            for n, x in _named(run[part]).items():
                if f"{mode}/idx/{part}/{n}" not in index:  # a scalar, whole
                    got[n], want[n] = x, ref_t(f"{mode}/{part}/{n}")
                    continue
                idx = ref_t(f"{mode}/idx/{part}/{n}")
                offs = torch.tensor([mesh.block(specs[n][d] if d < len(specs[n]) else None)[0]
                                     * x.shape[d] for d in range(x.dim())],
                                    dtype=torch.int64, device=idx.device)
                local = idx - offs
                inside = ((local >= 0) & (local < torch.tensor(x.shape, device=idx.device))
                          ).all(-1)
                got[n] = x[tuple(local[inside].T)]
                want[n] = ref_t(f"{mode}/{part}/{n}")[inside]
        else:
            # its own shards against the same blocks of the reference (the
            # ranks' blocks cover every element; nothing is gathered)
            got = _named(run[part])
            want = {n: mesh.shard(ref_t(f"{mode}/{part}/{n}"), art.named_specs[part][n], n)
                    for n in got}
        for group in ("params",) if part == "params" else ("m", "v"):
            keys = [n for n in want if part == "params" or n.startswith(group + ".")]
            top = float(ref_t(f"{mode}/top/{group}")[0])
            shares[group] = _within_bars({n: got[n] for n in keys},
                                         {n: want[n] for n in keys}, steps, top)
            if mode == "grok" and group == "params":
                shares["bf16"] = _within_bars({n: got[n] for n in keys},
                                              {n: want[n] for n in keys}, steps, top, True)
        if part == "opt" and not torch.equal(got["count"].cpu(), want["count"].cpu()):
            raise AssertionError(f"(j) rank {rank} {mode}: AdamW counts differ")
        if part == "opt" and mode == "zamba2":  # one step: m is (1 - b1) x the gradient
            from repro_torch.optim.adamw import AdamWConfig

            floor = (1 - AdamWConfig.b1) * 1e-8 / MESH_BAR
            worst_g = max(float((got[n].double() - want[n].double()).abs().max())
                          / max(float(ref_t(f"{mode}/opt/{n}").double().abs().max()), floor)
                          for n in got if n.startswith("m."))
            if worst_g > MESH_BAR:
                raise AssertionError(f"(j) rank {rank} {mode}: a leaf's first-step gradient "
                                     f"differs by {worst_g:.3g} of the leaf's largest (bar "
                                     f"{MESH_BAR})")
        del got, want
    worst, share = shares["bf16" if mode == "grok" else "params"]
    gated = ("params", "m", "v") if mode != "grok" else ()
    low = {g: shares[g][1] for g in gated if shares[g][1] < 0.99}
    if worst > 2 * MESH_LR * steps or low:
        raise AssertionError(f"(j) rank {rank} {mode}: outside the bars: largest parameter "
                             f"difference {worst:.3g} (bar {2 * MESH_LR * steps}), shares "
                             f"within 1e-5 of the largest {low} (bar 0.99)")
    params = _named(run["params"])
    replicated = {n: hashlib.sha1(_as_bytes(x).cpu().numpy().tobytes()).hexdigest()
                  for n, x in params.items() if all(e is None for e in art.model_specs[n])}
    held_b = sum(x.numel() * x.element_size() for part in ("params", "opt")
                 for x in _named(run[part]).values())
    replica_b = sum(x.numel() * x.element_size() for x in _named(art.params_sds).values())
    gathered_b = art.computed_bytes(art.params_sds)
    over_data = [t.get("all_gather data", {}).get("bytes", 0) for t in run["tables"]]
    check_s = time.perf_counter() - t_check
    kinds = {m: f"{s[0]:.3g} max, {s[1]:.5f} within 1e-5 of the largest" for m, s in
             shares.items()}
    if mode == "grok":
        kinds["params"] += (f"; less one bf16 rounding of each element {kinds['bf16']} (the "
                            f"largest gated, the shares read)")
    if worst_g is not None:
        kinds["m"] += (f"; each leaf's first-step gradient within {worst_g:.3g} of the leaf's "
                       f"largest (bar {MESH_BAR})")
    log(f"[train] (j) rank {rank} {mode} {arch} on {mesh.shape} at {mesh.coords}: attention "
        f"{art.split.attn!r}, B 1 x S {seq}, {steps} step(s); losses "
        f"{[x.tolist() for x in run['losses']]}, losses and grad norms within "
        f"{[float(f'{x:.3g}') for x in rel]} relative of the one-device run's (bar {bar:.3g}); "
        f"parameters "
        f"{kinds['params']} (bars {2 * MESH_LR * steps}{'' if mode == 'grok' else ' and 0.99'}), "
        f"moments m {kinds['m']}, "
        f"v {kinds['v']}{' (read, not gated)' if mode == 'grok' else ' (bar 0.99)'}"
        f"{f' at {MESH_SAMPLE} sampled elements a leaf' if mode == 'grok' else ''}; "
        f"{len(replicated)} replicated leaves' digests sent for the model peers; parameters "
        f"and moments held {held_b:,} B; a step computes on its model shards, "
        f"{gathered_b:,} B of parameters against a replica's {replica_b:,} B, gathered "
        f"over data {over_data} B a step, held gathered at most {max(run['gathered']):,} B a "
        f"step (one unit); gradient accumulator {run['accum']:,} B (its shards); bytes in "
        f"a step {run['tables'][-1]}; peak {max(run['setup_peak'], peak):.2f} GB (PR 31: "
        f"{PR31_PEAK_GB[mode]} GB), the steps alone {peak:.2f} GB, the weights drawn "
        f"{run['setup_peak']:.2f} GB; set up in {run['setup_s']:.1f} s, held to the "
        f"references in {check_s:.1f} s; ms/step {[round(x, 1) for x in run['step_ms']]} (in "
        f"collectives {[round(x, 1) for x in run['comm_ms']]}); {card}")
    return dict(tables=run["tables"], replicated=replicated, coords=mesh.coords,
                gathered=run["gathered"], accum=run["accum"], step_mem=run["step_mem"],
                traced=run["traced"])


def mesh_rank_main(rank: int, tmp: str, port: int) -> int:
    """One rank of (j) (run as ``chip_smoke.py --mesh-rank R DIR PORT``)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    t_start = time.perf_counter()
    since_spawn = time.time() - float(Path(f"{tmp}/spawned").read_text())
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=MESH_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        from repro_torch.core import ProcessMesh, comm
        from repro_torch.kernels import cuda

        card = card_name_power()
        before = dict(cuda.launches)
        _wait_for(Path(f"{tmp}/go"), "the references")  # they hold the card until then
        dist.barrier()
        t_go = time.perf_counter()
        meshes = {}  # one process mesh for each shape, over the one world

        def mesh_of(shape):
            if shape not in meshes:
                meshes[shape] = ProcessMesh(*shape)
            return meshes[shape]

        def train(mode, shape):
            comm.reset_stats(timed=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = _mesh_train(mode, mesh_of(shape))
            return run, max(run["steps_peak"], torch.cuda.max_memory_allocated()) / 1e9

        runs = {"hier": train("hier", MESH_HIER)}
        for mode in MESH_FIRST:
            runs[mode] = train(mode, MESH_SPLIT[mode][0])
        t_trained = time.perf_counter()
        _wait_for(Path(f"{tmp}/refs.bin.json"), "the references' file")
        index = json.loads(Path(f"{tmp}/refs.bin.json").read_text())
        raw = np.memmap(f"{tmp}/refs.bin", dtype=np.uint8, mode="r+")  # frombuffer: writable
        device = mesh_of(MESH_HIER).device

        def ref(key, pod=None, nbytes=False):
            """The reference's bytes of ``key`` on the card (pod ``pod``'s
            block of a leaf with the pod axis in front), or their count."""
            off, n, dtype, shape = index[key]
            if nbytes:
                return n
            if pod is not None:
                n //= shape[0]
                off += pod * n
            return torch.frombuffer(raw, dtype=torch.uint8, count=n, offset=off).to(device)

        def ref_t(key):
            """The reference ``key`` as a tensor on the card."""
            _, _, dtype, shape = index[key]
            return ref(key).view(getattr(torch, dtype)).reshape(shape)

        t_check = time.perf_counter()
        out = _check_hier(rank, mesh_of(MESH_HIER), *runs.pop("hier"), ref, card)
        out["split"] = {}
        for mode in MESH_FIRST:
            run, peak = runs.pop(mode)
            out["split"][mode] = _check_split(rank, mode, mesh_of(MESH_SPLIT[mode][0]), run,
                                              peak, ref_t, index, card)
            del run
        check_s = time.perf_counter() - t_check
        t_grok = time.perf_counter()
        run, peak = train("grok", MESH_SPLIT["grok"][0])
        out["split"]["grok"] = _check_split(rank, "grok", mesh_of(MESH_SPLIT["grok"][0]), run,
                                            peak, ref_t, index, card)
        del run
        torch.cuda.empty_cache()
        grok_s = time.perf_counter() - t_grok
        if dict(cuda.launches) != before:
            raise AssertionError(f"(j) rank {rank} launched a kernel: {dict(cuda.launches)}")

        def serve_ref(key):
            """A [lm-mesh] reference: its bytes on the card, dtype and shape."""
            _, _, dtype, shape = index[key]
            return ref(key), getattr(torch, dtype), shape

        t_serve = time.perf_counter()
        serve_meshes = {mode: mesh_of((leg.extents, leg.names))
                        for mode, leg in SERVE_MESHES.items()}
        out["serve"] = _serve_rank(rank, serve_meshes, serve_ref)
        serve_s = time.perf_counter() - t_serve
        out["wall_s"] = time.perf_counter() - t_start
        log(f"[train] (j) rank {rank}: started {since_spawn:.1f} s after its spawn (imports), "
            f"{t_go - t_start:.1f} s from its start to the references, "
            f"{t_trained - t_go:.1f} s training the hierarchical, {', '.join(MESH_FIRST)} legs, "
            f"{check_s:.1f} s holding them to the references, {grok_s:.1f} s on grok, "
            f"{serve_s:.1f} s serving ([lm-mesh])")
        Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def phase_train() -> dict:
    """(a)-(i); returns each kernel's launches in this process over the
    training legs (a), (b), (d), (f), (g) (none: they launch no kernel) and
    over the forwards (e). (c)'s and (h)'s CLI runs and (i)'s ranks run in
    subprocesses."""
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    before = dict(cuda.launches)
    for leg in (phase_train_sync, phase_train_hier, phase_train_cli,
                phase_train_device_vs_cpu, phase_train_families,
                phase_train_families_device_vs_cpu, phase_train_cli_family,
                phase_train_pipeline, phase_train_mesh):
        leg()
        log(f"[time] [train] {leg.__name__} done at {time.perf_counter() - t0:.1f} s")
    mid = dict(cuda.launches)
    phase_train_forwards()
    after = dict(cuda.launches)
    log(f"[train] all phases in {time.perf_counter() - t0:.1f} s")
    return {k: {"training": mid[k] - before[k], "forwards": after[k] - mid[k]}
            for k in cuda.KERNELS}


# ---------------------------------------------------------------------------
# [families]: the six other LM families at their published widths, depth
# cut to fit the card and the phase's time; weights drawn on the card from
# seed 0, each architecture's memory freed before the next.

# arch: (depth overrides, flash_attention launches a forward, prompt for
# serving). llama4 keeps one group (a dense and a 128-expert MoE sub-layer),
# grok 4 of its 64 MoE layers, internvl 8 of its 80 backbone layers: their
# published depths are 0.8 TB, 0.63 TB and 0.15 TB of bf16 weights. zamba2
# serves a 4088-token prompt so its cache is 4096 positions: its shared
# block attends over the whole cache through the streaming path, whose key
# blocks of 1024 must tile it (as in the reference).
FAMILIES = {
    "llama4-maverick-400b-a17b": ({"n_layers": 2}, 2, 4096),
    "grok-1-314b": ({"n_layers": 4}, 4, 4096),
    "internvl2-76b": ({"n_layers": 8}, 8, 4096),
    "mamba2-2.7b": ({}, 0, 4096),
    "zamba2-1.2b": ({}, 0, 4088),
    "whisper-medium": ({}, 0, 448),
}
FAMILY_SEQ = 4096
FAMILY_DECODE_TOKENS = 8
MOE_STAGES = ("route", "dispatch_slots", "dispatch", "expert_ffn", "combine")


def _family_bundle(arch, reduced=False, **overrides):
    """``arch``'s bundle with config fields replaced (on the backbone for
    internvl), the model rebuilt on the new config."""
    from repro_torch.configs.registry import get_arch

    bundle = get_arch(arch, reduced=reduced)
    cfg = bundle.cfg
    if hasattr(cfg, "backbone"):
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **overrides))
    else:
        cfg = dataclasses.replace(cfg, **overrides)
    return dataclasses.replace(bundle, cfg=cfg, model=type(bundle.model)(cfg))


def _uses_flash(arch) -> bool:
    return FAMILIES[arch][1] > 0


def _family_inputs(bundle, b, s, device, seed=1):
    """Tokens and the stub frontends' outputs (standard normal), drawn on
    ``device`` from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, bundle.cfg.vocab, (b, s), generator=gen, device=device)
    extra = {n: torch.randn(make(b, s).shape, generator=gen, device=device).to(make(b, s).dtype)
             for n, make in bundle.extra_inputs.items()}
    return toks, extra


class _MoEStageTimer:
    """CUDA events around each stage of ``models.moe`` (route, dispatch,
    expert products, combine) while installed: device time per stage, summed
    over the calls, read after a synchronize."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.events, self.saved = moe, {k: [] for k in MOE_STAGES}, {}

    def __enter__(self):
        import torch

        def timed(name, fn):
            def wrapper(*args, **kwargs):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                self.events[name].append((start, end))
                return out
            return wrapper

        for name in MOE_STAGES:
            self.saved[name] = getattr(self.moe, name)
            setattr(self.moe, name, timed(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.moe, name, fn)

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.events.items()}


class _RoutingTap:
    """Records each MoE layer's ``(expert_idx, gates)`` on the host, in call
    order, from ``models.moe.route`` inside ``moe_apply``, while installed."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls, self.route = moe, [], moe.route

    def __enter__(self):
        def tapped(p, x, cfg):
            gates, gate_vals, idx = self.route(p, x, cfg)
            self.calls.append((idx.cpu(), gates.cpu()))
            return gates, gate_vals, idx

        self.moe.route = tapped
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def agreeing_rows(card: list, host: list, what: str, tag: str = "[families] (d)",
                  agree=None, sides: tuple = ("card", "cpu")):
    """The rows (sequences) whose expert choices agree in every MoE layer,
    ``card`` against ``host`` (named ``sides`` in the log), among the rows
    ``agree`` kept so far where it is given (a call after earlier calls);
    each row's first flip is logged with its gate margin and must be a
    rounding's (< 1e-5), and a row must remain. None where there is no MoE
    layer."""
    import torch

    if len(card) != len(host):
        raise AssertionError(f"{what}: {len(card)} MoE calls on the {sides[0]}, {len(host)} on "
                             f"the {sides[1]}")
    if not host:
        return agree
    agree = (torch.ones(host[0][0].shape[0], dtype=torch.bool) if agree is None
             else agree.clone())
    for layer, ((ci, _), (hi, hg)) in enumerate(zip(card, host)):
        for b, s in torch.nonzero((ci != hi).any(-1)).tolist():
            if not agree[b]:
                continue
            k = hi.shape[-1]
            top = torch.sort(hg[b, s], descending=True).values[:k + 1]
            margin = float((top[:-1] - top[1:]).min())
            log(f"{tag} {what}: routing flip in MoE layer {layer}, row {b}, token "
                f"{s}: {sides[0]} {ci[b, s].tolist()}, {sides[1]} {hi[b, s].tolist()}, gate "
                f"margin {margin:.3g}")
            if margin >= 1e-5:
                raise AssertionError(f"{what}: a routing flip at gate margin {margin}")
            agree[b] = False
    if not bool(agree.any()):
        raise AssertionError(f"{what}: every row's routing flipped")
    return agree


def _family_forward_bf16(arch) -> dict:
    """(a) and (b) at full width, bf16: 1 warm-up + 2 timed forwards at
    B 1 x S 4096 (the kernel where the config has attention through the
    transformer), the exact launch count, finite logits, ms, tok/s, peak GB;
    MoE stage times over one forward; then serving at B 2. Returns the
    kernels' launches over (a) and (b), counted from 0."""
    import torch

    from repro_torch import serve_lm
    from repro_torch.kernels import cuda

    overrides, flash, prompt = FAMILIES[arch]
    pallas = {"use_pallas_attention": True} if _uses_flash(arch) else {}
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    bundle = _family_bundle(arch, **overrides, **pallas)
    params = bundle.model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_init
    weights_gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    toks, extra = _family_inputs(bundle, 1, FAMILY_SEQ, "cuda")
    cuda.reset_launches()
    times = []
    with torch.inference_mode():
        for i in range(3):
            before = dict(cuda.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, aux = bundle.model.forward(params, toks, **extra)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
            _expect_launches(before, flash, 1, f"{arch} forward")
        vocab = logits.shape[-1]
        if logits.shape[:2] != (1, FAMILY_SEQ) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)} not finite")
        peak = torch.cuda.max_memory_allocated() / 1e9
        del logits
        stages = ""
        if getattr(bundle.cfg, "moe", None) is not None:
            with _MoEStageTimer() as timer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bundle.model.forward(params, toks)
                torch.cuda.synchronize()
                fwd = 1e3 * (time.perf_counter() - t0)
            st = timer.ms()
            stages = ("; one forward's MoE stages (CUDA events, summed over its MoE layers): "
                      + ", ".join(f"{k} {v:.3f} ms ({100 * v / fwd:.1f}%)" for k, v in st.items())
                      + f" of {fwd:.2f} ms")
            if arch.startswith("llama4"):
                profile_window(f"{arch} forward (B 1 x S {FAMILY_SEQ})",
                               lambda: bundle.model.forward(params, toks), what="forward")
    ms = statistics.mean(times)
    depth = overrides.get("n_layers")
    log(f"[families] (a) {arch} ({'published depth' if depth is None else f'{depth} layers'}, "
        f"{weights_gb:.2f} GB of weights drawn in {t_init:.1f} s) bf16 forward B 1 x S "
        f"{FAMILY_SEQ}: {ms:.2f} ms (mean of 2 after 1; {[round(t, 2) for t in times]}), "
        f"{FAMILY_SEQ / ms * 1e3:,.0f} tok/s, {flash} flash_attention launches a forward, "
        f"logits [1, {FAMILY_SEQ}, {vocab}] finite, aux {float(aux):.4g}, peak "
        f"{peak:.2f} GB" + stages)
    for run in ("warm-up", "timed"):
        r = serve_lm.serve(bundle, params, batch=2, prompt_len=prompt,
                           tokens=FAMILY_DECODE_TOKENS, seed=3)
    steps = r["decode_steps"]
    if r["tokens"].shape != (2, FAMILY_DECODE_TOKENS) or not bool(
            torch.isfinite(r["logits"]).all()):
        raise AssertionError(f"{arch} serving: wrong shape or non-finite logits")
    log(f"[families] (b) {arch} serve_lm.serve B 2, prompt {prompt}, "
        f"{FAMILY_DECODE_TOKENS} tokens (timed after a warm-up): prefill "
        f"{r['prefill_s'] * 1e3:.2f} ms ({2 * prompt / r['prefill_s']:,.0f} tok/s), decode "
        f"{r['decode_s'] / steps * 1e3:.3f} ms/step ({2 * steps / r['decode_s']:,.0f} tok/s), "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    launches = dict(cuda.launches)
    # serving attends with a cache: no launch beyond (a)'s forwards (3, one
    # more timing the MoE stages, one more profiled for llama4)
    moe = getattr(bundle.cfg, "moe", None) is not None
    runs = 3 + moe + arch.startswith("llama4")
    want = {k: (flash * runs if k == "flash_attention" else 0) for k in cuda.KERNELS}
    if launches != want:
        raise AssertionError(f"{arch}: launches over (a) and (b) {launches}, expected {want}")
    del params, r
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _family_internvl_f32() -> None:
    """(c) internvl2-76b in f32 at 2 backbone layers, B 1 x S 4096 with its
    256 patches: the kernel against the streaming path, <= 1e-4 of the
    largest logit."""
    import torch

    arch = "internvl2-76b"
    f32 = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
    kernel = _family_bundle(arch, use_pallas_attention=True, **f32)
    plain = _family_bundle(arch, **f32)
    params = kernel.model.init_params(torch.Generator(device="cuda").manual_seed(0))
    toks, extra = _family_inputs(kernel, 1, FAMILY_SEQ, "cuda")
    extra = {k: v.float() for k, v in extra.items()}
    with torch.inference_mode():
        got, _ = kernel.model.forward(params, toks, **extra)
        want, _ = plain.model.forward(params, toks, **extra)
        err = rel_err(got, want)
    log(f"[families] (c) {arch} f32 (2 backbone layers) B 1 x S {FAMILY_SEQ}: kernel vs "
        f"streaming path rel {err:.3g} (bar 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"{arch} f32: kernel vs streaming {err} > 1e-4")
    del params, got, want
    torch.cuda.empty_cache()


def _family_device_vs_cpu(arch) -> None:
    """(d) reduced ``arch`` in f32, the same weights on the card and the
    CPU, ``FLASH_THRESHOLD`` lowered to 16 so the transformer families'
    32-token forward launches the kernel: the forward (<= 1e-4) and prefill
    + 4 decode steps (<= 5e-4), MoE outputs held where the choices agree."""
    import torch

    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import cuda
    from repro_torch.train.steps import make_serve_artifacts

    bundle = _family_bundle(arch, reduced=True,
                            **({"use_pallas_attention": True} if _uses_flash(arch) else {}))
    params = {"cpu": bundle.model.init_params(torch.Generator().manual_seed(0))}
    params["cuda"] = copy.deepcopy(params["cpu"]).to("cuda")
    toks, extra = _family_inputs(bundle, 2, 32, "cpu")
    n_flash = bundle.cfg.n_layers if _uses_flash(arch) else 0
    art = make_serve_artifacts(bundle, ShapeSpec("check", "prefill", 32, 2),
                               cache_dtype=torch.float32)
    out, routing = {}, {}
    with _RoutingTap() as tap, torch.inference_mode():
        for d in ("cuda", "cpu"):
            before = dict(cuda.launches)
            moved = {k: v.to(d) for k, v in extra.items()}
            t = toks.to(d)
            res = [bundle.model.forward(params[d], t, **moved)[0]]
            if d == "cuda":
                _expect_launches(before, n_flash, 1, f"reduced {arch} forward on the card")
            steps = [tap.take()]
            lp, state = art.prefill_fn(params[d], {"tokens": t[:, :28], **moved})
            res.append(lp)
            steps.append(tap.take())
            for i in range(28, 32):
                lp, state = art.decode_fn(params[d], state, t[:, i:i + 1], i)
                res.append(lp)
                steps.append(tap.take())
            out[d], routing[d] = [x.cpu() for x in res], steps
    errs = []
    for i, (g, w) in enumerate(zip(out["cuda"], out["cpu"])):
        rows = agreeing_rows(routing["cuda"][i], routing["cpu"][i], f"reduced {arch} step {i}")
        rows = slice(None) if rows is None else rows
        errs.append(rel_err(g[rows], w[rows]))
    log(f"[families] (d) reduced {arch} f32 card vs cpu: forward rel {errs[0]:.3g} (bar 1e-4, "
        f"{n_flash} kernel launches on the card); prefill + 4 decode steps rel "
        f"{max(errs[1:]):.3g} (bar 5e-4)")
    if not (errs[0] <= 1e-4 and max(errs[1:]) <= 5e-4):
        raise AssertionError(f"reduced {arch} cuda vs cpu: forward {errs[0]}, serving {errs[1:]}")


def phase_families() -> dict:
    """(a)-(d) for each of the six families; returns each kernel's launches
    per architecture over (a) and (b), each counted from 0."""
    from repro_torch.models import layers

    t0 = time.perf_counter()
    launches = {}
    for arch in FAMILIES:
        launches[arch] = _family_forward_bf16(arch)
        log(f"[time] [families] {arch} done at {time.perf_counter() - t0:.1f} s")
    _family_internvl_f32()
    threshold = layers.FLASH_THRESHOLD
    layers.FLASH_THRESHOLD = 16
    try:
        for arch in FAMILIES:
            _family_device_vs_cpu(arch)
    finally:
        layers.FLASH_THRESHOLD = threshold
    log(f"[families] all phases in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# [dist]: the distributed engine, four gloo ranks sharing the card
# ---------------------------------------------------------------------------

DIST_MESH = ((2, 2), ("data", "model"))   # 2 area groups x 2 lanes
DIST_RANKS = 4
DIST_K_REDUCED = 300
DIST_IAF_WINDOWS = 6                      # 1 + 5, as the main path's runs
DIST_LIF_WINDOWS = LIF_RAMP_WINDOWS + 6   # windows 0-23: the ramp, then 18-23
DIST_PREEMPT_AT = 3                       # (c)/(d): preempted after window 3, resumed
DIST_TIMEOUT_S = 480


def dist_references(pallas: dict) -> dict:
    """[dist] (a)'s references, bit-packed on the host: the single-host iaf
    runs' 6 windows and LIF's 24 (the untimed ramp, then the stored
    windows), every one bitwise the event runs' (which ``[event]``
    checks), and each run's final ring."""
    return dict(iaf=[_packed(blk) for blk, _ in pallas["iaf_store"]],
                lif=pallas["lif_ramp"] + [_packed(blk) for blk, _ in pallas["lif_store"]],
                iaf_ring=pallas["iaf_store"][-1][1].cpu().numpy(),
                lif_ring=pallas["lif_store"][-1][1].cpu().numpy())


def phase_dist(refs: dict) -> dict:
    """[dist]: the distributed engine (``make_simulation(..., mesh=...)``)
    as four ranks of one gloo world, all on this card, spawned here as
    processes of this script (``--dist-rank``) and echoed after they end.
    The single-host references: (a)/(c) the main path's runs, (b) and (d)
    iaf pallas runs at K 300 (all-to-all areas, a ring of areas), run here
    first. Every rank must exit 0. Returns rank 0's kernel launches on the
    routed paths, by kernel and run."""
    import socket
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import EngineConfig, build_network, make_simulation, mam_benchmark_spec
    from repro_torch.core import ring_area_adjacency

    ref_blocks, rings = {}, {"iaf": refs["iaf_ring"], "lif": refs["lif_ring"]}
    for key, adjacency in (("b", None), ("d", ring_area_adjacency(4, width=1))):
        spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=DIST_K_REDUCED,
                                  k_inter=DIST_K_REDUCED, area_adjacency=adjacency)
        net = build_network(spec, seed=12)
        eng = make_simulation(spec, EngineConfig(neuron_model="ignore_and_fire",
                                                 delivery_backend="pallas"), net=net)
        st, ref_blocks[key] = eng.init(), []
        for _ in range(DIST_IAF_WINDOWS):
            st, blk = eng.window(st)
            ref_blocks[key].append(_packed(blk))
        shape = tuple(blk.shape)
        fired = int(st.spike_count.sum())
        rings[key] = st.ring.cpu().numpy()
        del eng, net, st, blk
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[dist] ({key}) single-host reference: iaf pallas at 4 x 130000, K "
            f"{DIST_K_REDUCED}/{DIST_K_REDUCED}"
            f"{', a ring of areas' if adjacency else ''}, {DIST_IAF_WINDOWS} windows, "
            f"{fired} spikes; {torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated "
            f"in this process")
    with tempfile.TemporaryDirectory() as tmp:
        arrays = {f"{k}_{w}": b for k, blocks in (("iaf", refs["iaf"]), ("lif", refs["lif"]),
                                                  *ref_blocks.items())
                  for w, b in enumerate(blocks)}
        arrays.update({f"{k}_ring": ring for k, ring in rings.items()})
        np.savez(f"{tmp}/refs.npz", shape=np.asarray(shape), **arrays)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = []
        for rank in range(DIST_RANKS):
            with open(f"{tmp}/rank{rank}.log", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--dist-rank", str(rank),
                     tmp, str(port)], stdout=out, stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(1.0, DIST_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank in range(DIST_RANKS):
            for line in Path(f"{tmp}/rank{rank}.log").read_text().splitlines():
                log(line if line.startswith("[dist]") else f"[dist] rank {rank}| {line}")
        rcs = [p.returncode for p in procs]
        log(f"[dist] {DIST_RANKS} ranks exited {rcs} after {time.perf_counter() - t0:.1f} s")
        if any(rcs):
            raise AssertionError(f"[dist] a rank failed: exit codes {rcs}")
        return json.loads(Path(f"{tmp}/routed_launches.json").read_text())


class _DistRank:
    """One rank of [dist]: its mesh, the references, the card."""

    def __init__(self, mesh, refs, card):
        self.mesh, self.refs, self.card = mesh, refs, card
        self.shape = tuple(int(x) for x in refs["shape"])

    def log(self, msg: str) -> None:
        log(f"[dist] rank {self.mesh.rank}: {msg} ({self.card})")

    def ref(self, key: str, w: int):
        import numpy as np
        import torch

        bits = np.unpackbits(self.refs[f"{key}_{w}"], count=int(np.prod(self.shape)))
        return torch.from_numpy(bits.astype(bool).reshape(self.shape)).to(self.mesh.device)

    def check_ring(self, name, eng, st, key: str) -> None:
        """The whole ring of ``st`` (gathered: a collective) bitwise the
        single host's after the same windows."""
        import torch

        want = torch.from_numpy(self.refs[f"{key}_ring"]).to(self.mesh.device)
        if not bitwise_equal(eng.gather_state(st).ring, want):
            raise AssertionError(f"[dist] {name}: the ring differs from the single host's")

    def run(self, name, eng, key, windows, *, expect, static):
        """``windows`` windows of ``eng`` (through its pipeline when it has
        one, drained at the end), each whole block bitwise the reference's,
        overflow 0; each window timed (a synchronize at both ends), its
        collectives counted, and the bytes they took in summed over the
        ranks (``comm.received``: the exchange's gathers and rotations; on
        a static run they must equal the wire accounting and the engine's
        ``shipped_bytes``). Returns the final state."""
        import collections

        import torch
        import torch.distributed as dist

        from repro_torch.core import comm
        from repro_torch.kernels import cuda

        st = eng.init()
        inflight = eng.init_inflight() if eng.window_overlap is not None else None
        cuda.reset_launches()
        calls, times, shipped, received = collections.Counter(), [], [], []
        for w in range(windows):
            dist.barrier()
            torch.cuda.synchronize()
            before, ship0 = collections.Counter(comm.calls), st.shipped_bytes
            rec0 = comm.wire_received()
            t0 = time.perf_counter()
            if inflight is not None:
                st, inflight, blk = eng.window_overlap(st, inflight)
            else:
                st, blk = eng.window(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            calls.update(collections.Counter(comm.calls) - before)
            shipped.append(float(st.shipped_bytes - ship0))
            received.append(float(comm.wire_received() - rec0))
            if not bitwise_equal(eng.gather_block(blk), self.ref(key, w)):
                raise AssertionError(f"[dist] {name}: window {w} differs from the single host")
        if inflight is not None:
            st = eng.drain(st, inflight)
        per = {k: v / windows for k, v in cuda.launches.items() if v}
        received = self.mesh_total(received)
        if int(st.overflow) != 0:
            raise AssertionError(f"[dist] {name}: overflow {int(st.overflow)}")
        self.check_ring(name, eng, st, key)
        if per != {k: float(v) for k, v in expect.items()}:
            raise AssertionError(f"[dist] {name}: launches per window {per}, expected {expect}")
        wb = eng.wire_bytes["total_bytes"]
        account = f"{eng.wire_bytes['exchange']}_wire_bytes"
        if static and any(x != wb for x in shipped + received):
            raise AssertionError(f"[dist] {name}: received {received}, shipped {shipped}, "
                                 f"{account} {wb}")
        ms = [1e3 * t for t in times]
        if static:
            wire = (f"measured {received[-1]:.0f} B/window on the wire (comm's count, all "
                    f"ranks) == {account} {wb} == the engine's shipped_bytes")
        else:
            wire = (f"measured {min(received):.0f}-{max(received):.0f} B/window on the wire "
                    f"(comm's count, all ranks; adaptive), the engine's model "
                    f"{min(shipped):.0f}-{max(shipped):.0f}, the static accounting {wb}")
        per_call = {f"{op} over {'+'.join(ax)}": n / windows for (op, ax), n in sorted(calls.items())}
        self.log(f"{name}: {windows} windows and the final ring bitwise the single host, "
                 f"overflow 0; "
                 f"{statistics.mean(ms[1:]):.2f} ms/window over windows 1-{windows - 1} "
                 f"({min(ms[1:]):.2f}-{max(ms[1:]):.2f}; window 0 {ms[0]:.2f}); launches/window "
                 f"{per}; {wire}; collective calls/window {per_call}")
        return st

    def mesh_total(self, values) -> list:
        """Per-rank numbers summed over the ranks (a collective)."""
        import torch

        from repro_torch.core import comm

        mine = torch.tensor(values, dtype=torch.float64)
        return comm.all_reduce(mine, self.mesh, self.mesh.axis_names).tolist()

    def profile(self, name, fn):
        """One window under torch.profiler: the host time inside the process
        group's collectives (the profiler's gloo ops) and, from this module's
        own per-call timers, the part of it spent waiting for the other
        ranks (each call's time less the fastest rank's)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.core import comm

        torch.cuda.synchronize()
        comm.reset_stats(timed=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        own = torch.tensor([t for _, _, t in comm.times], dtype=torch.float64)
        comm.reset_stats()
        every = comm.all_gather(own[None], self.mesh, self.mesh.axis_names, dim=0)
        wait = float((own - every.min(dim=0).values).sum())
        gloo = [e for e in prof.key_averages() if e.key.startswith("gloo:")]
        inside = sum(e.cpu_time_total for e in gloo) / 1e6
        busy = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 1e6
        self.log(f"[profile] {name}: window {1e3 * wall:.2f} ms wall; {len(own)} collectives, "
                 f"{1e3 * inside:.2f} ms inside them by the profiler "
                 f"({', '.join(sorted({f'{e.key} x{e.count}' for e in gloo})) or 'no gloo ops'}), "
                 f"{1e3 * float(own.sum()):.2f} ms by comm's timers, of which {1e3 * wait:.2f} ms "
                 f"waiting for the other ranks; device busy {1e3 * busy:.2f} ms")


def _dist_a(r) -> None:
    """(a) the paper's per-area size, host-free sharded build, event path."""
    import torch

    from repro_torch.core import EngineConfig, make_simulation, mam_benchmark_spec
    from repro_torch.core import neuron as neuron_lib
    from repro_torch.kernels import ops
    from repro_torch.kernels.lif_update import lif_update_plain

    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000, k_inter=3000)
    runs = (("iaf", "ignore_and_fire", {}, DIST_IAF_WINDOWS, dict(event_deliver=11)),
            ("lif", "lif", dict(adaptive_exchange=True, overlap_exchange=True, fused_update=True),
             DIST_LIF_WINDOWS, dict(event_deliver=11, lif_update=10)))
    for key, model, kw, windows, expect in runs:
        cfg = EngineConfig(neuron_model=model, delivery_backend="event", sharded_build=True, **kw)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = make_simulation(spec, cfg, mesh=r.mesh, build_seed=12)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        r.log(f"(a) {key} sharded build (rank 0's plan, broadcast, then this rank's "
              f"tables): {build_s:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"allocated, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        name = f"(a) {key} event structure_aware" + "".join(f" {k}" for k in kw)
        st = r.run(name, eng, key, windows, expect=expect, static=not kw)
        r.log(f"(a) {key}: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB over build "
              f"and run; {int(eng.gather_state(st).spike_count.sum())} spikes")
        r.log(_window_price(r.mesh, spec, cfg, f"[dist] (a) {key}", lambda: eng.window(st)))
        r.profile(f"(a) {key}", lambda: eng.window(st))
        if model == "lif":
            # Kernel 1 at this rank's shard shape: [A_loc, n_loc] state.
            p = dataclasses.replace(neuron_lib.LIFParams(), dt_ms=spec.dt_ms)
            kw1 = dict(p11=p.p11, p21=p.p21, p22=p.p22, v_th=p.v_th_mv,
                       v_reset=p.v_reset_mv, t_ref_steps=p.t_ref_steps)
            n = st.neuron
            args = (n.v, n.i_syn, n.refrac, st.ring[..., 0].contiguous(),
                    torch.ones_like(n.refrac, dtype=torch.bool))
            got = ops.lif_update(*args, **kw1)
            want = lif_update_plain(*args, **kw1)
            if not all(bitwise_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("[dist] lif_update differs from its plain version")
            r.log(f"[kernel] lif_update at the shard shape {tuple(n.v.shape)}: bitwise == plain")
        del eng, st
        gc.collect()
        torch.cuda.empty_cache()


def _window_price(mesh, spec, cfg, label: str, window) -> str:
    """[dryrun] (e) on this [dist] rank: one ``window()`` of its engine,
    its rise on the card, against ``price_window`` of the same rank over a
    ``MeshLayout`` of the mesh's extents, on the meta network the sharded
    build cuts (``network_sds`` at the same cut, no incoming inter table)."""
    import torch

    from repro_torch.core import connectivity
    from repro_torch.core.mesh import MeshLayout
    from repro_torch.launch import dryrun

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = window()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    del out
    gsz = mesh.shape[mesh.axis_names[-1]]
    sub = gsz if cfg.subgroup_inter_tables and gsz > 1 else 1
    net = connectivity.network_sds(spec, size_multiple=1, outgoing=True,
                                   inter_shards=mesh.size // gsz, inter_shard_mode="group",
                                   subgroup=sub)
    net = dataclasses.replace(net, **{f: getattr(net, f).new_empty((0, 0, net.k_inter))
                                      for f in ("src_inter", "w_inter", "delay_inter")})
    priced = dryrun.price_window(net, spec, MeshLayout(mesh.extents, mesh.axis_names, mesh.rank),
                                 dataclasses.replace(cfg, sharded_build=False))
    return price_check(f"{label} one window", measured, priced["transient"])


def _dist_b(r) -> None:
    """(b) K 300: every rank builds the global network, shard_network cuts
    it; pallas and event under both schedules; kernels 2 and 6 held to
    their plain versions at the shard shapes."""
    import torch

    from repro_torch.core import EngineConfig, build_network, comm, make_simulation
    from repro_torch.core import delivery, dist_engine, mam_benchmark_spec
    from repro_torch.kernels import ops
    from repro_torch.kernels.event_deliver import event_deliver_plain
    from repro_torch.kernels.spike_deliver import spike_deliver_plain

    mesh = r.mesh
    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=DIST_K_REDUCED,
                              k_inter=DIST_K_REDUCED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_network(spec, seed=12, outgoing="intra", device=mesh.device)
    torch.cuda.synchronize()
    r.log(f"(b) global network K {DIST_K_REDUCED}/{DIST_K_REDUCED} built on this rank in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    expect = {("pallas", "conventional"): dict(spike_deliver=20),
              ("pallas", "structure_aware"): dict(spike_deliver=20),
              ("event", "conventional"): dict(event_deliver=20),
              ("event", "structure_aware"): dict(event_deliver=11)}
    for (backend, sched), want in expect.items():
        cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend=backend,
                           schedule=sched)
        eng = make_simulation(spec, cfg, net=net, mesh=mesh)
        st = r.run(f"(b) iaf {backend} {sched}", eng, "b", DIST_IAF_WINDOWS, expect=want,
                   static=True)
        r.profile(f"(b) {backend} {sched}", lambda: eng.window(st))
        del eng, st
    r.log(f"(b) peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # Kernels 2 and 6 at this rank's shard shapes, on the last window's
    # spikes (the reference block), against their plain versions.
    blk = r.ref("b", DIST_IAF_WINDOWS - 1)                     # [D, A, n_pad]
    view = dist_engine.shard_network(net, mesh, "structure_aware")
    c = dist_engine._cut(mesh, "structure_aware", net.n_areas, net.n_pad)
    s = int(blk.reshape(blk.shape[0], -1).sum(1).argmax())     # the busiest cycle
    cases = {
        "intra": (blk[s, c.aoff:c.aoff + c.a_loc].float().reshape(-1),
                  [view.src_intra, view.w_intra, view.delay_intra],
                  dict(steps_lo=net.steps_lo_intra, r_span=net.r_span_intra,
                       rows_per_area=c.n_loc, src_stride=net.n_pad)),
        "inter": (blk[s].float().reshape(-1),
                  [view.src_inter, view.w_inter, view.delay_inter],
                  dict(steps_lo=net.steps_lo_inter, r_span=net.r_span_inter)),
    }
    for name, (spikes, tables, kw) in cases.items():
        tables = [x.reshape(-1, x.shape[-1]) for x in tables]
        got = ops.spike_deliver(spikes, *tables, **kw)
        want = spike_deliver_plain(spikes, *tables, **kw)
        if not bitwise_equal(got, want):
            raise AssertionError(f"[dist] spike_deliver {name} differs from its plain version")
        r.log(f"[kernel] spike_deliver {name} at the shard shape: {tables[0].shape[0]} rows x "
              f"{tables[0].shape[1]} against {spikes.numel()} sources ({int(spikes.sum())} spiking): bitwise == plain")
    cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend="event")
    recv_intra, recv_inter = dist_engine._event_tables(net, view, mesh, cfg, c)
    local = blk[:, c.aoff:c.aoff + c.a_loc, c.noff:c.noff + c.n_loc]
    gids = (torch.arange(net.n_areas * net.n_pad, dtype=torch.int32, device=mesh.device)
            .view(net.n_areas, net.n_pad)[c.aoff:c.aoff + c.a_loc, c.noff:c.noff + c.n_loc])
    need = comm.count_max(local.reshape(local.shape[0], -1).sum(1).max(), mesh,
                          mesh.axis_names)  # one packet size on every rank
    packets, _ = delivery.compact_fired_block(local, gids, s_max=need,
                                              invalid=net.n_areas * net.n_pad)
    wire = comm.all_gather(packets, mesh, mesh.axis_names, dim=1)
    ring = torch.zeros((c.a_loc * c.n_loc, net.ring_len), dtype=torch.float32,
                       device=mesh.device)
    got = ops.event_deliver_block(ring.clone(), wire, *recv_inter, 5 * net.delay_ratio)
    want = event_deliver_plain(ring.clone(), wire, *recv_inter, 5 * net.delay_ratio)
    if not bitwise_equal(got, want):
        raise AssertionError("[dist] event_deliver inter differs from its plain version")
    r.log(f"[kernel] event_deliver inter at the shard shape: packets {tuple(wire.shape)} through "
          f"receive tables {tuple(recv_inter.tgt.shape)} into {tuple(ring.shape)}: bitwise == plain")
    ids = torch.arange(c.n_loc, dtype=torch.int32, device=mesh.device) + c.noff
    pk, _ = ops.compact_ids_block(local[s], ids, size=c.n_loc, fill_id=net.n_pad)
    area_wire = comm.all_gather(pk, mesh, mesh.axis_names[-1], dim=1)
    base = torch.arange(c.a_loc, dtype=torch.int32, device=mesh.device)[:, None] * net.n_pad
    flat = torch.where(area_wire < net.n_pad, area_wire + base, c.a_loc * net.n_pad).view(1, -1)
    got = ops.event_deliver_block(ring.clone(), flat, *recv_intra, s)
    want = event_deliver_plain(ring.clone(), flat, *recv_intra, s)
    if not bitwise_equal(got, want):
        raise AssertionError("[dist] event_deliver intra differs from its plain version")
    r.log(f"[kernel] event_deliver intra at the shard shape: packet {tuple(flat.shape)} through "
          f"receive tables {tuple(recv_intra.tgt.shape)}: bitwise == plain")


class _Calls:
    """Records every call of ``module.name`` whose arguments ``keep`` accepts
    (the call still runs as it was), with a copy of the tensor it updates in
    place (positional argument ``inplace``) taken before the call; restores
    the function on exit. ``calls`` holds ``(args, kwargs)`` pairs."""

    def __init__(self, module, name: str, keep, inplace: int | None = None):
        self.module, self.name, self.keep, self.inplace = module, name, keep, inplace
        self.calls = []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def call(*args, **kwargs):
            if self.keep(*args, **kwargs):
                kept = list(args)
                if self.inplace is not None:
                    kept[self.inplace] = args[self.inplace].clone()
                self.calls.append((kept, dict(kwargs)))
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _per_window(counter, windows: int) -> dict:
    return {f"{op} over {'+'.join(ax)}": n / windows for (op, ax), n in sorted(counter.items())}


def _dist_c(r, tmp: str) -> dict:
    """(c) the routed exchange at (a)'s width: the host-free build, ``event``,
    structure-aware, mesh (2, 2). iaf through ``run_windows`` with a
    checkpointer, preempted after window 3, restored on the same mesh and
    run 3 more windows; LIF adaptive and overlapped over (a)'s 24 windows.
    Every window bitwise the single host, overflow 0; the static run ships
    ``routed_wire_bytes`` a window. Kernel 6 held to its plain version on
    the last routed window's concatenated round packets. Returns this
    rank's launches by run."""
    import collections

    import torch

    from repro_torch.core import EngineConfig, comm, dist_engine, make_simulation
    from repro_torch.core import faults as faults_lib
    from repro_torch.core import mam_benchmark_spec
    from repro_torch.core import schedule as schedule_lib
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.event_deliver import event_deliver_plain

    mesh = r.mesh
    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000, k_inter=3000)
    whole = dist_engine.shape_network(spec, device=mesh.device)
    launches = {}
    cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend="event",
                       sharded_build=True, exchange="routed")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = make_simulation(spec, cfg, mesh=mesh, build_seed=12)
    torch.cuda.synchronize()
    r.log(f"(c) iaf routed sharded build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    wb = eng.wire_bytes
    if (wb["exchange"], wb["rounds"], wb["dense_rounds"]) != ("routed", 1, 1):
        raise AssertionError(f"[dist] (c): routing {wb}")

    def check(w, blk):  # w: windows completed, so the block is window w - 1
        if not bitwise_equal(blk, r.ref("iaf", w - 1)):
            raise AssertionError(f"[dist] (c) iaf: window {w - 1} differs from the single host")

    ckdir = f"{tmp}/ckpt_c"
    ckpt = schedule_lib.SimCheckpointer(ckdir, eng, whole, every=0)
    timing = collections.Counter()
    for step in ("save", "close"):
        def timed(*a, _fn=getattr(ckpt, step), _step=step, **k):
            t = time.perf_counter()
            out = _fn(*a, **k)
            timing[_step] += time.perf_counter() - t
            return out
        setattr(ckpt, step, timed)
    window_scatter = _Calls(ops, "event_deliver_block",
                            lambda ring, ids, *a, **k: ids.shape[0] > 1, inplace=0)
    cuda.reset_launches()
    comm.reset_stats()
    with window_scatter:
        try:
            schedule_lib.run_windows(
                eng, eng.init(), DIST_IAF_WINDOWS, checkpointer=ckpt, on_block=check,
                faults=faults_lib.FaultConfig(preempt_after_window=DIST_PREEMPT_AT))
            raise AssertionError("[dist] (c): the injected preemption did not stop the loop")
        except faults_lib.Preempted as exc:
            first = exc.result
        calls, received = collections.Counter(comm.calls), comm.wire_received()
        t0 = time.perf_counter()
        st, info = schedule_lib.restore_sim(ckdir, eng, whole)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        comm.reset_stats()
        second = schedule_lib.run_windows(eng, st, DIST_IAF_WINDOWS - info["step"],
                                          on_block=check)
        calls += collections.Counter(comm.calls)
        received += comm.wire_received()
    (received,) = r.mesh_total([received])
    per = {k: v / DIST_IAF_WINDOWS for k, v in cuda.launches.items() if v}
    launches["(c) iaf routed"] = {k: v for k, v in cuda.launches.items() if v}
    nbytes = sum(f.stat().st_size for f in Path(ckdir, f"step_{DIST_PREEMPT_AT:08d}").iterdir())
    shipped = float(second.state.shipped_bytes)
    if int(second.state.overflow) != 0:
        raise AssertionError(f"[dist] (c) iaf: overflow {int(second.state.overflow)}")
    if not received == shipped == DIST_IAF_WINDOWS * wb["total_bytes"]:
        raise AssertionError(f"[dist] (c) iaf: received {received}, shipped {shipped}, "
                             f"{DIST_IAF_WINDOWS} x routed_wire_bytes {wb['total_bytes']}")
    if per != {"event_deliver": 11.0}:
        raise AssertionError(f"[dist] (c) iaf: launches per window {per}")
    r.check_ring("(c) iaf", eng, second.state, "iaf")
    ms = [1e3 * t for t in list(first.window_times_s) + list(second.window_times_s)]
    spikes = first.spikes_per_window.tolist() + second.spikes_per_window.tolist()
    r.log(f"(c) iaf event routed through run_windows: {DIST_IAF_WINDOWS} windows and the "
          f"final ring bitwise the single host (preempted after window {DIST_PREEMPT_AT}, restored on this mesh, "
          f"resumed), overflow 0; ms/window {', '.join(f'{x:.2f}' for x in ms)} (window 0 "
          f"and the first resumed window cold); launches/window {per}; measured "
          f"{received:.0f} B on the wire (comm's count of the exchange's gathers and "
          f"rotations, all ranks; the state gathers apart) == {DIST_IAF_WINDOWS} x "
          f"routed_wire_bytes {wb['total_bytes']} == the engine's shipped_bytes "
          f"(dense_rounds {wb['dense_rounds']}, rounds {wb['rounds']}, edges {wb['edges']}); "
          f"the loop's collective calls/window {_per_window(calls, DIST_IAF_WINDOWS)}; "
          f"spikes a window {spikes}")
    r.log(f"(c) checkpoint at window {DIST_PREEMPT_AT}: {nbytes} bytes on disk (rank 0 "
          f"writes); save (gather the whole state over gloo, copy to the host) "
          f"{timing['save']:.3f} s, close (the write, then a barrier) {timing['close']:.3f} s; "
          f"restore (every rank reads the whole state, cuts its block) {restore_s:.3f} s; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    ring, ids, tgt, w, d, t_0 = window_scatter.calls[-1][0]
    got = ops.event_deliver_block(ring.clone(), ids, tgt, w, d, t_0)
    want = event_deliver_plain(ring.clone(), ids, tgt, w, d, t_0)
    if not bitwise_equal(got, want):
        raise AssertionError("[dist] event_deliver on the routed window packets differs from "
                             "its plain version")
    r.log(f"[kernel] event_deliver on the routed window's concatenated round packets "
          f"{tuple(ids.shape)} ({int((ids < tgt.shape[0]).sum())} ids) through receive tables "
          f"{tuple(tgt.shape)} into {tuple(ring.shape)}: bitwise == plain, max abs err "
          f"{max_abs_err(got, want)}")
    del eng, st, first, second, window_scatter, ring, ids, tgt, w, d, got, want
    gc.collect()
    torch.cuda.empty_cache()

    cfg = EngineConfig(neuron_model="lif", delivery_backend="event", sharded_build=True,
                       exchange="routed", adaptive_exchange=True, overlap_exchange=True,
                       fused_update=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = make_simulation(spec, cfg, mesh=mesh, build_seed=12)
    torch.cuda.synchronize()
    r.log(f"(c) lif routed sharded build: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    st = r.run("(c) lif event routed adaptive overlap", eng, "lif", DIST_LIF_WINDOWS,
               expect=dict(event_deliver=11, lif_update=10), static=False)
    launches["(c) lif routed adaptive overlap"] = {k: v for k, v in cuda.launches.items() if v}
    r.log(f"(c) lif: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB over build and "
          f"run; {int(eng.gather_state(st).spike_count.sum())} spikes")
    r.profile("(c) lif routed", lambda: eng.window(st))
    del eng, st
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _dist_d(r, tmp: str) -> dict:
    """(d) a sparse area graph (a ring, width 1) at K 300: every rank builds
    the global network and cuts it; iaf on ``pallas`` and ``event``, dense
    and routed, on mesh (4, 1), where the routed exchange has 1 wire round
    against the dense exchange's 3; then a routed ``event`` run on (2, 2)
    preempted after window 3 and resumed on (4, 1) (an elastic reshard
    from 2 groups to 4). Kernel 2 held to its plain version on the pallas
    local pathway. Returns this rank's launches by run."""
    import torch

    from repro_torch.core import EngineConfig, ProcessMesh, build_network, make_simulation
    from repro_torch.core import faults as faults_lib
    from repro_torch.core import mam_benchmark_spec, ring_area_adjacency
    from repro_torch.core import schedule as schedule_lib
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.spike_deliver import spike_deliver_plain

    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=DIST_K_REDUCED,
                              k_inter=DIST_K_REDUCED,
                              area_adjacency=ring_area_adjacency(4, width=1))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_network(spec, seed=12, outgoing="intra", device=r.mesh.device)
    torch.cuda.synchronize()
    r.log(f"(d) global network K {DIST_K_REDUCED}/{DIST_K_REDUCED}, a ring of areas, built "
          f"on this rank in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    r41 = _DistRank(ProcessMesh((4, 1), ("data", "model")), r.refs, r.card)
    launches = {}
    runs = {("pallas", "dense"): dict(spike_deliver=20),
            ("pallas", "routed"): dict(spike_deliver=10, event_deliver=1),
            ("event", "dense"): dict(event_deliver=11),
            ("event", "routed"): dict(event_deliver=11)}
    for (backend, exchange), want in runs.items():
        cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend=backend,
                           exchange=exchange)
        eng = make_simulation(spec, cfg, net=net, mesh=r41.mesh)
        wb = eng.wire_bytes
        if exchange == "routed" and (wb["rounds"], wb["dense_rounds"]) != (1, 3):
            raise AssertionError(f"[dist] (d): routing {wb}")
        local = _Calls(ops, "spike_deliver", lambda *a, **k: "rows_per_area" in k)
        with local:
            st = r41.run(f"(d) iaf {backend} {exchange} on (4, 1)", eng, "d", DIST_IAF_WINDOWS,
                         expect=want, static=True)
        if exchange == "routed":
            launches[f"(d) iaf {backend} routed"] = {k: v for k, v in cuda.launches.items() if v}
        rounds = wb["rounds"] if exchange == "routed" else r41.mesh.shape["data"] - 1
        r41.log(f"(d) {backend} {exchange}: global pathway {wb['global_bytes']} B/window in "
                f"{rounds} wire round(s)")
        r41.profile(f"(d) {backend} {exchange}", lambda: eng.window(st))
        if (backend, exchange) == ("pallas", "routed"):
            # The cycle with the most spikes of the run's local pathway.
            args, kw = max(local.calls, key=lambda c: int(c[0][0].sum()))
            got = ops.spike_deliver(*args, **kw)
            plain = spike_deliver_plain(*args, **kw)
            if not bitwise_equal(got, plain):
                raise AssertionError("[dist] spike_deliver on the routed pallas local pathway "
                                     "differs from its plain version")
            spikes, src = args[0], args[1]
            r41.log(f"[kernel] spike_deliver on the routed pallas local pathway: "
                    f"{src.shape[0]} rows x {src.shape[1]} against {spikes.numel()} sources "
                    f"({int(spikes.sum())} spiking): bitwise == plain, max abs err "
                    f"{max_abs_err(got, plain)}")
        del eng, st, local
    # Elastic resume: 2 groups (the (2, 2) mesh) -> 4 groups (the (4, 1) mesh).
    cfg = EngineConfig(neuron_model="ignore_and_fire", delivery_backend="event",
                       exchange="routed")

    def check(w, blk):
        if not bitwise_equal(blk, r.ref("d", w - 1)):
            raise AssertionError(f"[dist] (d) elastic: window {w - 1} differs from the single "
                                 f"host")

    ckdir = f"{tmp}/ckpt_d"
    eng = make_simulation(spec, cfg, net=net, mesh=r.mesh)
    ckpt = schedule_lib.SimCheckpointer(ckdir, eng, net, every=0)
    try:
        schedule_lib.run_windows(
            eng, eng.init(), DIST_IAF_WINDOWS, checkpointer=ckpt, on_block=check,
            faults=faults_lib.FaultConfig(preempt_after_window=DIST_PREEMPT_AT))
        raise AssertionError("[dist] (d): the injected preemption did not stop the loop")
    except faults_lib.Preempted:
        pass
    del eng
    eng = make_simulation(spec, cfg, net=net, mesh=r41.mesh)
    st, info = schedule_lib.restore_sim(ckdir, eng, net)
    want = {"old_n_groups": 2, "new_n_groups": 4}
    if {k: info["reshard"][k] for k in want} != want:
        raise AssertionError(f"[dist] (d) elastic: reshard {info['reshard']}")
    res = schedule_lib.run_windows(eng, st, DIST_IAF_WINDOWS - info["step"], on_block=check)
    if int(res.state.overflow) != 0:
        raise AssertionError(f"[dist] (d) elastic: overflow {int(res.state.overflow)}")
    r41.check_ring("(d) elastic", eng, res.state, "d")
    r41.log(f"(d) elastic resume: routed event on (2, 2) preempted after window "
            f"{DIST_PREEMPT_AT}, restored on (4, 1) ({info['reshard']}), windows "
            f"{DIST_PREEMPT_AT}-{DIST_IAF_WINDOWS - 1} and the final ring bitwise the single "
            f"host, overflow 0; "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng, st, res, net
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dist_rank_main(rank: int, tmp: str, port: int) -> int:
    """One rank of [dist] (run as ``chip_smoke.py --dist-rank R DIR PORT``)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DIST_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        from repro_torch.core import ProcessMesh
        from repro_torch.kernels import cuda

        if rank == 0:
            cuda.build_all()  # built already by the parent: loads, or builds once
        dist.barrier()
        mesh = ProcessMesh(*DIST_MESH)
        r = _DistRank(mesh, np.load(f"{tmp}/refs.npz"), card_name_power())
        r.log(f"{mesh}, torch {torch.__version__}, backend {dist.get_backend()}")
        _dist_a(r)
        _dist_b(r)
        routed = {**_dist_c(r, tmp), **_dist_d(r, tmp)}
        if rank == 0:
            by_kernel = {}
            for run, counts in routed.items():
                for kernel, n in counts.items():
                    by_kernel.setdefault(kernel, {})[run] = n
            Path(f"{tmp}/routed_launches.json").write_text(json.dumps(by_kernel))
    finally:
        dist.destroy_process_group()
    return 0


_T0 = time.perf_counter()


def lap(phase: str) -> None:
    """The script's elapsed time at the end of ``phase``."""
    log(f"[time] {phase} done at {time.perf_counter() - _T0:.1f} s")


def main() -> int:
    import torch

    if len(sys.argv) == 5 and sys.argv[1] == "--dist-rank":
        return dist_rank_main(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--pipe-rank":
        return pipe_rank_main(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--mesh-rank":
        return mesh_rank_main(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # Every Python subprocess of this script (the CLIs, the ranks) would
    # compile torch's modules from source again where the environment sets
    # PYTHONDONTWRITEBYTECODE and site-packages holds no bytecode (the card's
    # machine: ~10 s an import of torch, ~10 s more for torch._dynamo, which
    # the first meta-device op imports). The first subprocess writes the
    # bytecode into a directory of the script's own, the rest read it;
    # nothing is written beside the sources.
    import os
    import shutil
    import tempfile

    pyc = tempfile.mkdtemp(prefix="chip_smoke_pyc_")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    try:
        return run_phases()
    finally:
        shutil.rmtree(pyc, ignore_errors=True)


def run_phases() -> int:
    """The phases in order; the kernels line and the last line."""
    import torch

    from repro_torch.core import mam_benchmark_spec

    device = phase_device()
    lap('phase_device')
    phase_build()
    lap('phase_build')
    spec = mam_benchmark_spec(n_areas=4, n_per_area=130_000, k_intra=3000, k_inter=3000)
    net = phase_build_network(spec)
    lap('phase_build_network')
    pallas = phase_main_path(spec, net)
    lap('phase_main_path')
    dist_refs = dist_references(pallas)
    event_launches = phase_event_runs(spec, net, pallas)
    lap('phase_event_runs')
    steady, lif_steady_start = phase_lif_steady(spec, net, pallas["lif_start"])
    block, ring = pallas["iaf_store"][-1]  # the iaf runs' last window, from t0 = 5 D
    event_row = phase_kernel_event(
        net, {"iaf": (block, ring, 5 * net.delay_ratio, False), "steady": (*steady, True)},
        event_launches)
    phase_resilience(spec, net, lif_steady_start)
    lap('phase_resilience')
    del lif_steady_start
    # The outgoing tables and the runs' stores go before the kernel phases'
    # large temporaries.
    net = dataclasses.replace(net, **{f: None for f in OUTGOING})
    launches, profiled = pallas["launches"], pallas["profiled"]
    del pallas, block, ring, steady
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[full] outgoing tables freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rows = phase_kernels(net, launches, profiled) + [event_row]
    lap('phase_kernels')
    log(f"[kernel] peak in the kernel phases after the outgoing tables were freed: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del net
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[cli] the network freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    routed_launches = phase_dist(dist_refs)
    lap('phase_dist')
    del dist_refs
    # Kernels 1, 2 and 6 on the routed paths ([dist] (c)/(d), rank 0's
    # launches in each run), beside their main-path counts.
    for row in rows:
        if row["name"] in routed_launches:
            row["routed_launches"] = routed_launches[row["name"]]
    phase_cli()
    lap('phase_cli')
    phase_serve()
    lap('phase_serve')
    mam_launches = phase_mam()
    lap('phase_mam')
    phase_dryrun()
    lap('phase_dryrun')
    phase_device_vs_cpu()
    lap('phase_device_vs_cpu')
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32 (the default,
    torch.backends.cudnn.allow_tf32 = False        # stated): the f32 bars assume it
    lm_launches = phase_lm_main()
    lap('phase_lm_main')
    phase_lm_f32()
    lap('phase_lm_f32')
    phase_lm_serve()
    lap('phase_lm_serve')
    phase_lm_danube()
    lap('phase_lm_danube')
    rows.append(phase_kernel_flash(lm_launches))
    phase_lm_device_vs_cpu()
    lap('phase_lm_device_vs_cpu')
    train_launches = phase_train()
    lap('phase_train')
    families_launches = phase_families()
    lap('phase_families')
    phase_dryrun_lm()
    lap('phase_dryrun_lm')
    # Each kernel's launches on the MAM driver's routes ([mam] (b)).
    for row in rows:
        row["mam_launches"] = {route: n[row["name"]] for route, n in mam_launches.items()}
        row["train_launches"] = train_launches[row["name"]]
        row["families_launches"] = {arch: n[row["name"]]
                                    for arch, n in families_launches.items()}
    log(f"[time] total {time.perf_counter() - _T0:.1f} s (the limit 1200 s; the aim 800 s)")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
