#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on the GPU.

    python3 chip_smoke.py            # from the repo root, on a machine with one CUDA GPU

Phases, each failing hard (an exception means a non-zero exit and no final
line):

1. the card's name and power limit (``nvidia-smi``);
2. the CUDA kernels built from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel), with the build time and ptxas's lines
   for each kernel instantiation (its entry function, then its registers,
   shared memory and spills);
3. each kernel against its plain PyTorch version on the card, at the shapes
   ResNet18-GN gives the mix (J=4 rows of the largest leaf and of the whole
   flattened tree, fp32 and bf16; the packed fold at density 0.5), with its
   time, the plain version's time and its HBM-bytes bound; the masked
   matmul over the reference's kernel-test sweep (its U=1 form timed at
   (128, 256, 128), density 0.2, against ``torch.mm``), at the serving
   shapes (U = cache size, M = rows, the MLP's three layers) and on a mask
   with whole empty 128x128 tiles (timed beside the same operands with
   every tile live), each within 1e-5 of its plain version,
   and a user's rows in a mixed batch bit-equal to the same user served
   alone; the stacked fold and the prune/regrow apply at K=4 rows of the
   largest leaf and of the whole flattened tree, bit-equal to their plain
   versions, with the ``torch.sort`` time of the prune/regrow thresholds;
   for the gossip (J=4 rows of the smallest leaf), the folds and the
   masked matmul also the wrapper's host microseconds per call
   (``time.perf_counter`` over many calls with no synchronise; the flat
   fold's per fold through the tree-level path, ``packed_accum_all`` over
   a ResNet18-GN payload with one read-back, beside one call a fold), and
   for the
   masked matmul its library call's
   (``torch.bmm``, ``torch.mm``) device time beside that call's time and
   its own bound (no mask read), and a device time with a cold L2; then
   phase 16's bf16 masked matmul, timed here where the profiler keeps
   every launch: its U=1 form at (128, 256, 128) first, the reference's
   sweep with fp32 and bf16 masks, each within one bf16 ulp of plain and
   bit-equal over two launches, the batched form at the serving MLP's
   middle layer with either mask against ``torch.bmm`` on pre-masked bf16
   weights, a mixed batch bit-equal to alone at 4 and at 20 rows;
4. the training path through its CLI entry functions: ``simulate
   --model resnet18 --hw 32 --clients 4 --rounds 2`` on the default device
   (cuda), with launch counters zeroed just before and read just after —
   both kernels must have run, every mask must hold its ERK budget after
   each evolve, accuracy must be finite — then a shorter ``packed=False``
   round (the gossip kernel on the dense mix);
5. the stacked path through the CLI's entry functions: ``simulate --scale
   --model resnet18 --hw 32 --clients 4 --rounds 2``, once per
   ``--scale-reduction``, counters zeroed just before and read just after —
   ``ordered`` must launch the gossip kernel and ``einsum`` must not, every
   mask must hold its ERK budget after each evolve, the comm rows must equal
   the loop engine's run, accuracy must be finite; then, on the engine's own
   state, ``fold_stacked(0, 0, pack_stacked(params, masks))`` must give
   ``(w⊙m, m)`` exactly with one stacked-fold launch per leaf, and
   ``stacked_prune_regrow_threshold`` (a vmapped dense gradient of the
   round's evolve batch, the round's prune rate) must launch the
   prune/regrow kernel once per sparsifiable leaf and equal the same call on
   the CPU; a profiled stacked round;
6. a small smallcnn round on the card against the same round on the CPU
   (the plain versions), from one state, comm and FLOP rows equal;
7. the serving path through its CLI entry functions (``launch/serve.py``:
   1024 users of the 64-128-128-32 MLP, a 256-slot pool, 4096 requests),
   counters zeroed just before and read just after: ``--backend kernel``
   must launch the masked matmul 3 x (batches + 2) times (the warmup's
   capturing call runs the forward eagerly and replays it; then one
   replay a batch), match
   ``--backend vmap`` per request within 1e-5 with identical cache
   counters, and hold ``bytes_at_rest == sum of encoded_nbytes``, all
   untraced and in the order kernel, vmap, vmap, kernel; then a traced
   kernel run for the split of service time by span, and one under
   torch.profiler for the device's busy share;
8. the vmap local phase: one local phase of ``simulate --model resnet18
   --hw 32 --clients 4`` from one state with ``--exec vmap`` and with
   ``--exec loop`` (each run twice, the second timed), their largest
   parameter difference held to ``VMAP_PARAM_ATOL``, and what the CLI's
   ``--exec auto`` resolves to;
9. the synchronous simulator through the CLI's entry functions:
   ``simulate --sim --exec loop`` at the same configuration (2 rounds),
   counters zeroed just before and read just after — the gossip and fold
   kernels must launch, masks, parameters, comm rows and accuracy history
   must be bit-equal to a ``RoundEngine`` run of the same arguments, and
   every transfer must carry the codec frame (``encoded_nbytes``) of what
   its sender held when the round started, ``up_wire`` their sum;
10. the asynchronous simulator through the CLI's entry functions:
    ``simulate --sim --async --staleness 2 --compute-hetero
    --bandwidth-skew 10 --loss-prob 0.1 --uplink-mode fifo --topology random
    --degree 2 --round-s 30``, counters zeroed just before and read just after — the fold
    kernel must launch exactly once per payload leaf folded
    (``sparse.ops.COUNTERS["accum_calls"]``, > 0), every mask must hold its
    ERK budget after each evolve, accuracy must be finite, the observed
    spread and mix lag must stay within the staleness bound and some
    messages must be mixed; its report row, the host wall per emitted round
    and, from a profiled one-round run, the device's busy share;
11. async checkpoint on the card: the same run saved after round 0 by
    ``--sim-checkpoint``, resumed by ``--resume`` in a fresh engine, must
    give the uninterrupted run's transfers, ``LinkStats``, clock and state
    bit for bit;
12. the strategies the port added in slice 6, through the CLI's entry
    functions at the same ResNet18-GN configuration, counters zeroed just
    before each run and read just after: ``simulate --strategy NAME`` for
    dpsgd, dpsgd_ft, local, fedavg, fedavg_ft, ditto, fomo, subfedavg,
    dfedalt and dfedsam (accuracy finite, comm and FLOP rows positive —
    Local's comm zero —, subfedavg launching the gossip kernel rounds x
    selected x 62 times and no other run any kernel, the stacked fold
    included; the warm round's wall
    and phases, and a profiled round's device busy share for dpsgd, fedavg
    and subfedavg); subfedavg's mix from its final state bit-equal to the
    CPU; dpsgd under the async arguments of phase 10 (fold launches =
    mixed messages x 62 > 0, no gossip; one ``mix_one`` bit-equal to the
    CPU); ``--scale --strategy dpsgd`` per reduction (no kernel; rows equal
    to the loop engine's; the ``ordered`` mix of the vmap ``RoundEngine``'s
    state bit-equal to that engine's mix of it; ``einsum`` within
    ``SCALE_EINSUM_ATOL`` of ``ordered``, whose local phase is the same;
    each run against the vmap
    ``RoundEngine`` run and an ``--exec loop`` run, whose convolutions are
    other cuDNN calls than the engine's one client a call, within
    ``LOOP_GAP_FACTOR`` times that loop run's card-vs-CPU gap);
    the vmap local phase against the loop for dpsgd, local and fedavg; and
    phase 6's smallcnn cross-check, rows included, for every one of the
    ten;
13. ``serve_models``, the serving CLI's other families: (a) through the
    CLI's entry functions, ``--model smallcnn`` and each of the ten smoke
    archs (``SERVE_MODEL_ARGS``: 4 users at density 0.5, a 2-slot pool, max
    batch 4, 16 requests, 1 row; the LMs prefill 8 tokens), counters zeroed
    just before and read just after (every kernel 0: these families serve
    through ``torch.func.vmap`` only, as in the reference) — each request
    bit-equal to the same request served alone through a launch of the
    same width on the card, from a second store of the same users on the
    same model (its own capture: two in all), and within ``SERVE_CPU_TOL``
    (max abs) of the
    same store served on the CPU; its service time, p50/p99 latency and
    ``bytes_at_rest``; (b) full published width: ``ArchModel(ARCHS[...],
    prompt_len=2048)`` for gemma3-1b and then mamba2-1.3b through
    ``ServeEngine`` (2 users drawn on a CUDA generator at density 0.5, 2
    slots, max batch 2, 8 requests, each model freed before the next),
    graphed (phase 18's full-width cells: the forward captured by
    ``warmup()``, one capture) and again, from a fresh store of the same
    base and frames, under ``graph.disabled()`` — outputs
    and cache counters bit-equal, the mixed batch bit-equal to each
    request served alone and finite; its parameter count, graphed and
    eager prefill ms per request and prompt tokens/s (CUDA events over the
    pool-wide forward); for ``TWO_STORE_ARCHS`` (gemma3-1b) a second store
    of the same shapes (A's frames over the same base) on the same model,
    served A, B, A, graphed and eager,
    bit-equal mode against mode and B to A's first pass, with the
    graph-pool bytes each store's capture reserved (the captures share one
    pool); peak memory, ``bytes_at_rest`` (equal to the
    frames' analytic size), a profiled serving run's device busy share,
    the memory the forward's capture holds until ``release()`` (device
    memory reserved and allocated before and after it); each graph
    released and each store freed before the next run;
14. ``lm``, LM training: (a) through the CLI's entry functions (``train
    lm``'s ``lm_loop`` from ``init_lm_clients``' state), every decoder
    smoke arch at ``LM_ARGS`` (2 clients, 2 rounds, 4 steps, 64-token
    sequences: gemma3's 16-token window runs the banded attention),
    counters zeroed just before and read just after (every kernel 0, as in
    the reference) — losses finite and within ``LM_CPU_RTOL`` of the same
    loop on the CPU from the same state, every mask leaf's held count equal
    to the CPU's, the share of mask coordinates that differ reported;
    (b) full published width, ``ARCHS["gemma3-1b"]`` at K=2 clients, one
    row of 1024 tokens each (params and int8 masks at density 0.5 drawn on
    a CUDA generator), counters zeroed just before and read just after:
    one ``make_train_step`` (einsum gossip; loss finite, every parameter 0
    outside its mask), one ``make_mask_update_step`` at prune rate 0.25
    (one prune/regrow launch per sparsifiable leaf, each bit-equal to
    ``prune_regrow_rows_plain`` on the same leaf and thresholds; each row's
    held count against its ``n_active``), a ``make_prefill_step`` of a
    1024-token prompt into a 1040-slot cache and 16 greedy
    ``make_decode_step`` steps, whose logits must match a ``forward_train``
    teacher-forcing pass within ``LM_DECODE_TOL`` x the logits' scale; then
    the train step's time and tokens/s, the mask update's time and its
    sorts' share, prefill and per-token decode times, peak memory (and
    what each stage leaves allocated), and profiled train and decode
    steps' busy shares and top three kernels (the models bound with
    ``remat=False`` in (a) and (b), and in phases 16-18 and 21 unless
    stated); (c) the same plan and dtype from one state, the models
    bound under each of ``REMAT_POLICIES`` (``models.remat``; "none" is
    ``remat=False``): a train step (its peak above what was held before
    it), ``REMAT_TIMED_STEPS`` timed ones and a counted mask update (one
    prune/regrow launch per sparsifiable leaf), params, losses and masks
    bit-equal to "none"'s; the "full" train step graphed (a capture and
    ``REMAT_TIMED_STEPS`` replays) bit-equal to eager; "full"'s peak
    below "none"'s;
15. the observability plane (run right after phase 3, while no engine of
    the other phases is alive: a run archive's counters are the
    process-wide snapshot, as in the reference CLI's one-run process):
    ``make obs-smoke``'s arguments (``simulate --sim --strategy
    dispfl_anneal --rounds 2 --clients 4 --local-epochs 1
    --samples-per-class 20 --eval-every 2 --loss-prob 0.1 --uplink-mode
    fair``) through the CLI's ``main`` on the card, at smallcnn untraced
    then with ``--run-dir --trace-mode full``, and at ``--model resnet18
    --hw 32`` untraced, ``ring``, ``full`` and untraced again, launch
    counters zeroed just before each run and read just after — every
    traced run must launch each kernel as often as the untraced one, and
    ``repro_torch.launch.dash.main(["render", "--run-dir", D, "--check"])``
    must return 0 on each archive; per phase the ``round.*`` span totals
    against ``phase_s`` (ResNet18-GN's ``full`` run: local and evolve
    within ``OBS_SPAN_RTOL``; the time of mix and eval outside their spans
    printed), the warm round's wall per tracing mode, spans
    per round and the archive's bytes; then ``serve --backend kernel``
    (phase 7's arguments) untraced and with ``--run-dir --trace-mode
    full``: masked-matmul launches equal, the archive checked, its store
    rollup equal to its store counters;
16. reduced precision, (b) right after phase 15 and the rest after phase
    14: (a) phase 14 (b) again at bf16
    (``ScalePlan.dtype``: params, caches and activations bf16, int8 masks),
    counters zeroed just before and read just after: the train step, the
    mask update (57 (bf16, int8) prune/regrow launches, each bit-equal to
    plain), prefill and 16 decode steps within ``LM_DECODE_TOL_BF16`` of
    teacher forcing, every figure printed beside phase 14's fp32 one; (b)
    the prune/regrow kernel's other dtype pairs at K=4 rows of the largest
    ResNet18-GN leaf, bit-equal and timed (the bf16 masked matmul is
    checked and timed in phase 3); (c)
    ``pack_stacked(dtype=float16)`` of a ResNet18-GN K=4 state and
    ``fold_stacked`` into zeros: one fp16 row-fold launch per leaf (62),
    bit-equal to plain and to ``(fp16(w), m)`` (the fp16 row and flat
    folds are timed in (b)); (d) phase 7's serving MLP (kernel backend)
    from ``ModelStore(payload_dtype=np.float16)`` holding the CLI's users
    and from the CLI's own fp32 store: ``bytes_at_rest`` the analytic
    figure at 2 and 4 bytes a value, launches as predicted (3 x (batches
    + 2) masked matmuls for the first store, as in phase 7, 3 x (batches +
    1) for the second, whose capture needs no eager warm-up; 3 fp16 flat
    folds per miss of the fp16 store; one model serves both stores, a
    capture each), outputs
    within
    ``SERVE_FP16_TOL`` of the fp32 store's, the fp16 pool equal to the fp32
    pool rounded to fp16;
17. the single-card dry run (``repro_torch.launch.dryrun``), after phase
    16 (a): gemma3-1b at phase 14's plan (K=2 x one 1024-token row), fp32
    and bf16, traced on ``cuda`` fake tensors and the same step run for
    real on the card under the same counters (``utils.trace_cost``):
    FLOPs and bytes accessed must be equal; the predicted peak against
    the peak above what earlier phases held, measured in phase 14 / 16 (a)
    and in this phase's own run, each ratio within ``DRYRUN_PEAK_BAND``;
    the ``RooflineReport`` row of each step and the achieved ``mfu``
    (``model_flops`` over phase 14's / 16 (a)'s warm train-step time x the
    dtype's peak); at bf16 also under ``DRYRUN_REMAT``'s policies, each
    traced and run for real (FLOPs and bytes equal, the predicted peak
    within ``DRYRUN_PEAK_BAND`` of this phase's measured one; "dots"'
    FLOPs equal to "none"'s, "full"'s above them and its predicted peak
    below "none"'s); then the sweep, ``python -m repro_torch.launch.dryrun``
    over every arch at ``DRYRUN_SWEEP_SHAPE`` (train_4k) at published
    width (bf16, K=2 x 1, the default ``--remat full``) into a temporary
    directory (started after phase 3 in ``DRYRUN_SWEEP_PROCS`` background
    processes, as host-only tracing beside phases 15 and 4-12, and
    awaited before phase 13's full-width stores), every artifact
    ``ok`` or ``skipped``, which of them fit the card, and ``python -m
    repro_torch.launch.report`` over them;
18. compiled steps (``repro_torch.utils.graph.graphed``, CUDA graphs), run
    after phase 16 (a) and before phase 17, so that phase 17's counts are
    of eager steps: gemma3-1b at phase 14's plan, fp32 then bf16, each
    step builder graphed against the same builder run eagerly
    (``graph.disabled()``) from the same state — 3 train steps, each with
    its own lr tensor, adjacency and batch, then a profiled fourth
    (losses each step, params after each step and whole at the end, all
    bit-equal), one ``gossip="ppermute"`` train step, the mask update at
    prune rates ``COMPILED_RATES`` (masks and params bit-equal;
    prune/regrow launches per replay equal eager's), a prefill and 16
    decode steps (tokens, logits and caches bit-equal); the graphed and
    eager step, mask-update and decode times beside phase 14's / 16 (a)'s,
    tokens/s, the device's busy share and the runtime's launch calls of
    a profiled step, the peak memory with the graph pool and the capture
    time; then ``ScaleEngine`` at phase 5's ResNet18-GN cell for
    ``COMPILED_ROUNDS`` rounds per reduction, eager and graphed from one
    state: state bit-equal, comm and FLOP rows equal, ``step_compiles``
    1, each C entry's launches per replayed round equal eager's (the
    first graphed round warms up eagerly, then replays), the round walls
    and a profiled round's busy share; then the loop engine
    (``LOOP_COMPILED_CASES``: phase 4's cell on the per-client loop, with
    ``--exec vmap``, ``--sim`` and ``--sim --async ... --round-s 30`` on
    the loop and at the default ``--exec auto``, which runs the vmap
    step one client a phase), ``LOOP_COMPILED_ROUNDS`` rounds and a
    profiled further round, graphed (``Task``'s value_and_grad, accuracy
    and local step, per client or stacked) against eager from one state:
    state, comm and FLOP rows and accuracies bit-equal (the simulators'
    transfers too), captures made only in rounds in which a client
    computed for the first time, the stacked step's one per batch size
    whatever the phases' step counts, each C entry's launches per round
    equal eager's; the host wall per round, busy share, launch calls,
    capture seconds and the graph pools' memory; then the serving path
    (``serve/model.py``'s pool-wide forwards through ``graphed``; a miss
    decodes straight into its slot, so no slot write is compiled): the
    MLP at ``COMPILED_SERVE_ARGS`` (``SERVE_ARGS`` with 2048 requests) on
    the ``kernel`` and ``vmap`` backends (the ``ref`` backend's graph is
    held to eager by the card tests), smallcnn
    and each smoke arch at ``SERVE_MODEL_ARGS``, each served through
    ``ServeEngine`` as
    the CLI serves, graphed and under ``graph.disabled()`` from stores
    built from one seed: outputs and cache counters bit-equal, one
    capture of the forward, in ``warmup()``, none while serving, masked-matmul launches 3 x (batches + 2)
    graphed and 3 x (batches + 1) eager on the kernel backend; each
    cell's service_s, p50/p99, a profiled pass's busy share and launch
    calls, replays, capture seconds, the peak of both engines and the
    memory the graphed forward's capture holds until ``release()``,
    graphed beside eager (the full-width cells are phase 13 (b)'s);
19. the port's seven examples (``examples/torch_*.py``), each one's
    ``main`` in this process at the reference example's printed sizes
    (``EXAMPLE_ARGS``), counters zeroed just before each: its wall
    seconds, the rows it prints and each C entry's launches; an example
    that raises, or an accuracy not finite in [0, 1], fails;
20. the client-sharded scale round (``simulate --scale --mesh-shape``
    through the CLI's entry functions, ``ordered`` and ``einsum``, each
    from an archive the unsharded engine wrote): (a) phase 5's cell on a
    world of one NCCL rank (mesh 1x1, started in this process; the round
    one graph with its gather inside), bit-equal (``ordered``) and within
    ``SCALE_EINSUM_ATOL`` (``einsum``) of the unsharded run, round walls
    side by side; (b) ``MESH_B_ARGS`` (K=8) on four gloo ranks sharing
    the card (NCCL refuses two ranks on one device; each rank a process
    of its own, ``chip_smoke.py --mesh-child``; the round two graphed
    segments around the eager gather), meshes 4x1 and 2x2, each bit-equal
    to the unsharded K=8 run (the engine vmaps one client a call on every
    mesh, so cuDNN, which picks a grouped convolution's algorithm by its
    group count, sees the same calls); per
    rank its clients, round walls, gather seconds and bytes a round and
    ``gossip_avg_f32`` launches, (rounds + 1) x K_local x leaves (the
    first round's eager warm-up counts); a rank that fails fails the
    phase with its exit code and stderr tail;
21. the LM steps over a ``DeviceMesh`` (``launch.steps.plan_for`` and
    ``lower_train``/``lower_serve``, ``DTensor`` placements; each client
    split over 'model' by ``sharding.tp``): (a) gemma3-1b at its
    published width, fp32, one 1024-token row a client, on a world of one
    NCCL rank (mesh 1x1): the placed train, prefill and decode steps
    bit-equal to the unsharded steps of the same plan, each timed beside
    it, and the train step under remat "full" bit-equal to it; (b) four
    gloo ranks sharing the card (``chip_smoke.py
    --steps-child``): the qwen3-8b smoke arch on meshes 2x2 (K=2 of 2
    rows) and 1x4 (K=1 of 4 rows), the deepseek-moe-16b and mamba2-1.3b
    smoke archs and jamba's FSDP2D plan (one client of 4 rows, weights
    2-D sharded) on 2x2: the train step (``einsum``, ``ppermute``: the
    sharded ring), prefill and decode within ``STEPS_REL_TOL`` of the
    unsharded steps, per rank its clients, the collective kinds and bytes
    ``utils.collectives`` counts, the all-reduces over 'model', the inputs
    gathered whole where the reference splits them, and no all-gather
    sending a 'model'-sharded weight's shard (the fingerprints of
    ``tests/_torch_mesh_steps_world.py``'s ``SentSums``), and the 2x2
    qwen3-8b train step (``STEPS_B_REMAT``) again under remat "full",
    bit-equal to it with every collective kind and axis issued at least
    as often (the recompute's 'model' all-reduces more often); (c) the
    dry run's ``--multi-pod`` records of gemma3-1b train_4k (``einsum``,
    ``ppermute``) and qwen3-8b train_4k, each under ``--remat full`` and
    ``none``, and jamba decode_32k, traced by phase 17's background
    process: ok, ``"tp": true``, collective bytes, the ring's
    collective-permutes; a "none" record's rank-0 FLOPs beside the parent
    tree's whole-client records (qwen3-8b's at most 1.25/16 of it), a
    "full" one's FLOPs and collective bytes above its "none" twin's;
22. a ``{"kernels": [...]}`` line, one row per C entry (``entry``, its
    dtypes in ``shape``).  Each row's launches are that entry's own, as
    its wrapper counted them where it launched (``LAUNCHES_BY_ENTRY``; the
    U=1 rows ``LAUNCHES_U1_BY_ENTRY``): ``launches`` on the row's main
    path and ``launches_<path>`` on each other counted path —
    ``training`` (phase 4), ``scale_ordered`` and ``scale_state`` (phase
    5), ``serve`` (7), ``sim_sync`` and ``sim_async`` (10, 11),
    ``strategies`` (12: its ten runs, its async run and its two stacked
    runs), ``serve_models`` (13), ``lm`` (14 (a) and (b)), ``obs`` (15's
    traced runs), ``precision`` (16 (a), (c) and (d)), ``compiled``
    (18's graphed runs, warm-up runs included), ``examples`` (19),
    ``mesh`` (20: (a)'s runs and every (b) rank's), ``mesh_steps``
    (21: (a)'s and every (b) rank's; no kernel is on this path) and
    ``remat`` (14 (c)'s three mask updates);
    then the last
    line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
    "count": ...}}``.

Exits non-zero, printing no result, without a CUDA GPU or without the
repo's ``src/`` beside this file.
"""
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16, dense tensor cores
BF16_REL_TOL = 2.0 ** -8        # one bf16 ulp, relative (expected: exact)
MM_TOL = dict(atol=1e-5, rtol=1e-5)   # masked matmul vs torch.matmul (fp32 order)
L2_FLUSH_BYTES = 128 << 20      # read between calls timed with a cold L2
PTXAS_LINES = ("entry function", "registers", "spill")  # logged at build
# vmap vs loop local phase on the card at ResNet18-GN width, where the loop
# on the card and on the CPU already differ by ~4.2e-4 (the CPU tests
# measure no gap at their width and hold vmap to the loop's bits)
VMAP_PARAM_ATOL = 1e-3
# Stacked dpsgd at ResNet18-GN, 2 rounds (H100 80GB HBM3, 700 W): the einsum
# mix against the ordered one measured 1.96e-4 (1.12e-4 against the vmap
# RoundEngine when it vmapped all K clients a call too); the stacked run,
# one client a call, against the vmap run 5.35e-3 and against the card's
# loop 4.47e-3, below 2 x the 3.11e-3 between the same loop run on the
# card and on the CPU.
SCALE_EINSUM_ATOL = 3e-4
LOOP_GAP_FACTOR = 2.0
SERVE_ARGS = ["--users", "1024", "--cache-size", "256", "--max-batch", "256",
              "--requests", "4096", "--rows", "4", "--density", "0.5"]
# phase 18's MLP cells: the same store and model, half the request stream
# (four passes of it a cell, graphed and eager)
COMPILED_SERVE_ARGS = ["--users", "1024", "--cache-size", "256",
                       "--max-batch", "256", "--requests", "2048", "--rows",
                       "4", "--density", "0.5"]
SERVE_MODEL_ARGS = ["--users", "4", "--density", "0.5", "--cache-size", "2",
                    "--max-batch", "4", "--requests", "16", "--rows", "1"]
# served outputs on the card against the same store served on the CPU, max
# abs difference (the tied-embedding logits reach ~190 at smoke width;
# H100 80GB HBM3, 700 W: 4.58e-5 at most)
SERVE_CPU_TOL = 1e-4
# the MLP served from an fp16 store against the same users from an fp32
# store, max abs difference relative to the outputs' scale: each weight
# rounded to fp16 (2^-11 relative) through three layers
SERVE_FP16_TOL = 2.0 ** -8
FULL_WIDTH_ARCHS = ("gemma3-1b", "mamba2-1.3b")
# the full-width archs whose cell adds a second store on the same model:
# mamba2-1.3b's second pool (21.5 GB) beside its first, its capture's 12.94
# GiB and the ~8 GiB earlier phases hold leave no room for a miss's decode
# on an NVIDIA H100 80GB HBM3 (out of memory there); gemma3-1b's fits
TWO_STORE_ARCHS = ("gemma3-1b",)
FULL_WIDTH_PROMPT = 2048
LM_ARGS = ["lm", "--clients", "2", "--rounds", "2", "--steps", "4", "--seq",
           "64", "--batch-size", "2", "--tokens-per-client", "4096"]
# the lm loop on the card against the same loop on the CPU from one state:
# relative loss difference (cuBLAS and MKL round each product differently)
LM_CPU_RTOL = 1e-4
LM_FULL_ARCH = "gemma3-1b"
LM_FULL_CLIENTS, LM_FULL_SEQ, LM_FULL_DECODE = 2, 1024, 16
# decoded logits against a teacher-forcing forward, relative to their scale;
# at bf16 the two forwards round to bf16 after every op, in GEMMs of other
# shapes: on an H100 the bf16 gemma3-1b reading is 4.0e-3, so 1e-2
LM_DECODE_TOL = 1e-4
LM_DECODE_TOL_BF16 = 1e-2
# phase 14 (c): the models' rematerialisation ("none": remat=False), and the
# warm train steps timed a policy
REMAT_POLICIES = ("none", "full", "dots")
REMAT_TIMED_STEPS = 3
# make obs-smoke's simulate arguments (Makefile), and the local and evolve
# spans' totals against phase_s: each span opens and closes within
# microseconds of its phase's clock (after the synchronise), on phases of
# 10-1000 ms.  The mix's phase_s also holds the round's set-up before its
# span opens (the topology draw; in the simulator each client's message
# nnz, read back per leaf) and eval's the comm/FLOP accounting: printed,
# not held
OBS_ARGS = ["simulate", "--sim", "--strategy", "dispfl_anneal", "--rounds",
            "2", "--clients", "4", "--local-epochs", "1",
            "--samples-per-class", "20", "--eval-every", "2", "--loss-prob",
            "0.1", "--uplink-mode", "fair"]
OBS_SPAN_RTOL = 0.02
# the dry run's predicted peak over a measured train-step peak: a sanity
# band (the counter sees every storage the step allocates; the card's
# allocator rounds each block and keeps cuBLAS workspaces)
DRYRUN_PEAK_BAND = (0.5, 2.0)
# the sweep: every arch at train_4k (its largest trace).  Every arch and
# shape took 278.3 s on the H100's host (40 combinations); train_4k's ten
# traces 132.5-177.6 s, so they run in a process of their own beside the
# small-card phases
DRYRUN_SWEEP_SHAPE = "train_4k"
# phase 17's rematerialisation policies, traced and run beside remat=False
DRYRUN_REMAT = ("full", "dots")
DRYRUN_SWEEP_TIMEOUT_S = 600
# its processes: under --remat full one took 298.5 s, 120.3 s past phases
# 15 and 4-12 (NVIDIA H100 80GB HBM3, 700.00 W); the host has 8 cores
DRYRUN_SWEEP_PROCS = 3


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, cold_kernel=None):
    """Device time per call (the sum of every kernel the call launched),
    from a torch.profiler trace; None, with the reason printed, where the
    profiler records no device time or records a call's kernels fewer than
    ``iters`` times (late in a long run it has been seen to keep only a
    tenth of them).  ``cuda_ms`` above is the time per call as the caller
    sees it, host launch overhead included.  Back-to-back calls find their
    operands in the 50 MB L2 cache where they fit; with ``cold_kernel`` the
    buffer of ``_l2_flush`` is read before each call, evicting them (read,
    not written: dirty lines would charge their write-back to the call),
    and only the kernels whose name holds ``cold_kernel`` are summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = _l2_flush() if cold_kernel else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if rows is None:
        return None
    if cold_kernel:
        rows = [r for r in rows if cold_kernel in r[2]]
    total_us = sum(r[0] for r in rows)
    if total_us <= 0:
        log("  device time not measured: the profiler recorded no kernels")
        return None
    if max(r[1] for r in rows) < iters:
        log(f"  device time not measured: the profiler recorded "
            f"{max(r[1] for r in rows)} launches of {iters} calls")
        return None
    return total_us / 1e3 / iters


@functools.cache
def _l2_flush():
    """``L2_FLUSH_BYTES`` on the card, allocated once a run."""
    import torch
    return torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")


def host_us(fn, n=1000):
    """Host microseconds per call: ``time.perf_counter`` over ``n`` calls
    with no synchronise between them (a wrapper that reads back, as the
    folds do, waits for the card inside each call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def device_rows(prof):
    """(self device microseconds, count, name) per event of a finished
    torch.profiler run; None, with the reason printed, where this torch
    build's profiler gives no device times.  Only the read-out is guarded:
    the profiled work itself runs outside, so its failures propagate."""
    try:
        return [(getattr(e, "self_device_time_total", 0) or
                 getattr(e, "self_cuda_time_total", 0), e.count, e.key)
                for e in prof.key_averages()]
    except (RuntimeError, AttributeError) as e:
        log(f"  device time not measured: {e!r}")
        return None


def bound(nbytes, nflops, flops_per_s=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nflops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gossip(torch, ga, dev, j, n, dtype, gen):
    """Kernel vs plain on J masked rows, with the first mask row as ``own``
    as the main path passes it; returns the result row."""
    m = (torch.rand((j, n), generator=gen, device=dev) < 0.5).to(dtype)
    w = (torch.randn((j, n), generator=gen, device=dev) * m.float()).to(dtype)
    ws, ms = list(w), list(m)
    own = ms[0]
    got = ga.gossip_avg(ws, ms, own)
    torch.cuda.synchronize()
    want = ga.gossip_avg_plain(ws, ms, own)
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        ok = torch.equal(got, want)
    else:
        ok = torch.allclose(got.float(), want.float(), rtol=BF16_REL_TOL, atol=0)
    if not ok:
        raise AssertionError(f"gossip_avg J={j} N={n} {dtype}: kernel != plain "
                             f"(max abs err {err})")
    ms_k = cuda_ms(lambda: ga.gossip_avg(ws, ms, own))
    dev_k = device_ms(lambda: ga.gossip_avg(ws, ms, own))
    ms_p = cuda_ms(lambda: ga.gossip_avg_plain(ws, ms, own))
    # the J weight and J mask rows read once, out written once; own is one
    # more row to read only where it is not the first mask row
    rows = 2 * j + 1 if own.data_ptr() == ms[0].data_ptr() else 2 * j + 2
    b_ms, b_by = bound(rows * n * w.element_size(), (2 * j + 1) * n)
    return {"J": j, "N": n, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "ms": ms_k, "device_ms": dev_k,
            "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by}


def gossip_host(torch, ga, dev, j, n, gen, dtype=None):
    """Host microseconds per gossip call on J rows of a small leaf (where
    the device's share of a call is negligible, as on most of the main
    path's 62 leaves), fp32 unless ``dtype``: the best of two timings."""
    dtype = dtype or torch.float32
    m = (torch.rand((j, n), generator=gen, device=dev) < 0.5).to(dtype)
    ws = list((torch.randn((j, n), generator=gen, device=dev)
               * m.float()).to(dtype))
    ms = list(m)
    runs = [host_us(lambda: ga.gossip_avg(ws, ms, ms[0])) for _ in range(2)]
    return {"J": j, "N": n, "host_us": min(runs), "runs": runs}


def prune_regrow_host(torch, pr, dev, k, n, gen, pair=None):
    """Host microseconds per prune/regrow call on K rows of a small leaf
    (the device's share negligible, as on most of the LM mask update's
    leaves), weights and masks of the dtypes ``pair`` (fp32 by default):
    the best of two timings."""
    wdt, mdt = pair or (torch.float32, torch.float32)
    m = (torch.rand((k, n), generator=gen, device=dev) < 0.5).float()
    w = torch.randn((k, n), generator=gen, device=dev) * m
    g = torch.randn((k, n), generator=gen, device=dev)
    w, g, m = w.to(wdt), g.to(wdt), m.to(mdt)
    th = pr.sort_thresholds(w, g, m, n // 4, n // 8)
    runs = [host_us(lambda: pr.prune_regrow_rows(w, g, m, th))
            for _ in range(2)]
    return {"K": k, "N": n, "host_us": min(runs), "runs": runs}


def check_fold(torch, pa, pack_bits, dev, n, alpha, gen, dtype=None):
    """One payload folded into non-zero accumulators, values of ``dtype``
    (fp32 by default, or fp16): kernel vs plain bit for bit, timed."""
    flags = torch.rand(n, generator=gen, device=dev) < 0.5
    words = pack_bits(flags)
    nnz = int(flags.sum())
    values = torch.randn(nnz, generator=gen, device=dev).to(
        dtype or torch.float32)
    num0 = torch.randn(n, generator=gen, device=dev)
    den0 = torch.rand(n, generator=gen, device=dev)
    got = pa.packed_accum(num0.clone(), den0.clone(), words, values, alpha)
    torch.cuda.synchronize()
    want = pa.packed_accum_plain(num0.clone(), den0.clone(), words, values, alpha)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"packed_accum N={n} alpha={alpha}: kernel != "
                             f"plain (max abs err {err})")
    num, den = num0.clone(), den0.clone()
    ms_k = cuda_ms(lambda: pa.packed_accum(num, den, words, values, alpha))
    dev_k = device_ms(lambda: pa.packed_accum(num, den, words, values, alpha))
    ms_p = cuda_ms(lambda: pa.packed_accum_plain(num, den, words, values, alpha))
    host = host_us(lambda: pa.packed_accum(num, den, words, values, alpha), 300)
    # num, den read and written once, the bitmap and the nnz values read once
    b_ms, b_by = bound(16 * n + 4 * words.numel()
                       + values.element_size() * nnz, 3 * n)
    return {"N": n, "nnz": nnz, "alpha": alpha, "max_abs_err": err,
            "dtype": str(values.dtype).replace("torch.", ""),
            "ms": ms_k, "device_ms": dev_k, "plain_ms": ms_p, "host_us": host,
            "bound_ms": b_ms, "bound_by": b_by}


def fold_tree_host(torch, pa, dev, gen):
    """The flat fold's host microseconds per fold through the tree-level
    path: ``packed_accum_all`` over one ResNet18-GN payload tree (every
    leaf at density 0.5: 62 scans, one read-back, 62 folds) into
    preallocated accumulators, per leaf; beside it the same leaves folded
    one ``packed_accum`` call each (a read-back a call), and the tree's
    time per fold as the caller sees it (CUDA events).  The best of two
    timings each."""
    from repro_torch.models.cnn import init_resnet18
    from repro_torch.sparse.packed import is_packed, pack_tree
    from repro_torch.utils.tree import tree_leaves, tree_map
    params = init_resnet18(torch.Generator().manual_seed(0), 10, device=dev)
    masks = tree_map(lambda w: (torch.rand(w.shape, generator=gen, device=dev)
                                < 0.5).float(), params)
    leaves = tree_leaves(pack_tree(params, masks), is_leaf=is_packed)
    folds = [(torch.zeros(p.n_coords, device=dev),
              torch.zeros(p.n_coords, device=dev), p.bitmap, p.values, 1.0)
             for p in leaves]
    n = len(folds)

    def singles():
        for f in folds:
            pa.packed_accum(*f)

    tree = [host_us(lambda: pa.packed_accum_all(folds), 30) for _ in range(2)]
    single = [host_us(singles, 30) for _ in range(2)]
    ms = cuda_ms(lambda: pa.packed_accum_all(folds))
    return {"leaves": n, "host_us": min(tree) / n, "tree_host_us": min(tree),
            "single_host_us": min(single) / n, "ms_per_fold": ms / n,
            "runs": tree}


def check_fold_rows(torch, pa, dev, k, n, alpha, gen, dtype=None):
    """The stacked fold of K payloads packed as the scale path packs them
    (``pack_stacked`` of masked rows at density 0.5, values of ``dtype``:
    the state's fp32, or fp16), kernel vs plain, into non-zero
    accumulators."""
    from repro_torch.scale.stacked import pack_stacked
    m = (torch.rand((k, n), generator=gen, device=dev) < 0.5).float()
    w = torch.randn((k, n), generator=gen, device=dev) * m
    sp = pack_stacked({"w": w}, {"w": m}, dtype=dtype)["w"]
    num0 = torch.randn((k, n), generator=gen, device=dev)
    den0 = torch.rand((k, n), generator=gen, device=dev)
    args = (sp.bitmap, sp.values, sp.nnz, alpha)
    got = pa.packed_accum_rows(num0.clone(), den0.clone(), *args)
    torch.cuda.synchronize()
    want = pa.packed_accum_rows_plain(num0.clone(), den0.clone(), *args)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"packed_accum_rows K={k} N={n} alpha={alpha}: "
                             f"kernel != plain (max abs err {err})")
    num, den = num0.clone(), den0.clone()
    nnz = int(sp.nnz.sum())
    ms_k = cuda_ms(lambda: pa.packed_accum_rows(num, den, *args))
    dev_k = device_ms(lambda: pa.packed_accum_rows(num, den, *args))
    ms_p = cuda_ms(lambda: pa.packed_accum_rows_plain(num, den, *args))
    host = host_us(lambda: pa.packed_accum_rows(num, den, *args), 300)
    # num, den read and written once; the bitmaps and the held values read
    # once (padding excluded); nnz and the per-group offsets are negligible
    b_ms, b_by = bound(16 * k * n + 4 * sp.bitmap.numel()
                       + sp.values.element_size() * nnz, 3 * k * n)
    return {"K": k, "N": n, "nnz": nnz, "alpha": alpha, "max_abs_err": err,
            "dtype": str(sp.values.dtype).replace("torch.", ""),
            "ms": ms_k, "device_ms": dev_k, "plain_ms": ms_p, "host_us": host,
            "bound_ms": b_ms, "bound_by": b_by}


def check_prune_regrow(torch, pr, dev, k, n, gen, pair=None):
    """The prune/regrow apply on K rows at a round's counts (held density
    0.5, prune rate 0.25), weights and masks of the dtypes ``pair`` (fp32
    and fp32 by default), thresholds by ``sort_thresholds``: kernel vs
    plain bit for bit, and the time of the two sorts beside it."""
    wdt, mdt = pair or (torch.float32, torch.float32)
    m = (torch.rand((k, n), generator=gen, device=dev) < 0.5).float()
    w = torch.randn((k, n), generator=gen, device=dev) * m
    g = torch.randn((k, n), generator=gen, device=dev)
    w, g, m = w.to(wdt), g.to(wdt), m.to(mdt)
    n_active = n // 2
    n_prune = math.ceil(0.25 * n_active)
    th = pr.sort_thresholds(w, g, m, n_active - n_prune, n_prune)
    got = pr.prune_regrow_rows(w, g, m, th)
    torch.cuda.synchronize()
    want = pr.prune_regrow_rows_plain(w, g, m, th)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    if not (torch.equal(_bits(torch, got[0]), _bits(torch, want[0]))
            and torch.equal(_bits(torch, got[1]), _bits(torch, want[1]))):
        raise AssertionError(f"prune_regrow K={k} N={n} {wdt}/{mdt}: kernel "
                             f"!= plain (max abs err {err})")
    ms_k = cuda_ms(lambda: pr.prune_regrow_rows(w, g, m, th))
    dev_k = device_ms(lambda: pr.prune_regrow_rows(w, g, m, th))
    ms_p = cuda_ms(lambda: pr.prune_regrow_rows_plain(w, g, m, th))
    ms_sort = cuda_ms(lambda: pr.sort_thresholds(w, g, m, n_active - n_prune,
                                                 n_prune), iters=5)
    # w, g, m read once, new_m and new_w written once (the (K, 2)
    # thresholds are negligible); about eight comparisons a coordinate
    b_ms, b_by = bound((3 * w.element_size() + 2 * m.element_size()) * k * n,
                       8 * k * n)
    return {"K": k, "N": n, "max_abs_err": err, "ms": ms_k,
            "dtype": "/".join(str(d).replace("torch.", "")
                              for d in (wdt, mdt)),
            "device_ms": dev_k, "plain_ms": ms_p, "sort_ms": ms_sort,
            "bound_ms": b_ms, "bound_by": b_by}


def check_mm_single(torch, mmk, dev, gen):
    """The U=1 masked matmul (the reference's ``masked_matmul``) at the
    sweep's (128, 256, 128) shape, density 0.2: kernel within 1e-5 of its
    plain version, its times, ``torch.mm`` on the pre-masked weights, and
    the bound over every weight tile it reads."""
    x, w, mask = (t[0] for t in mm_inputs(torch, dev, 1, 128, 256, 128, 0.2,
                                          gen))
    got = mmk.masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    want = mmk.masked_matmul_plain(x, w, mask)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **MM_TOL):
        raise AssertionError(f"masked_matmul U=1: kernel != plain ({err})")
    wm = w * mask
    occ = mmk.block_occupancy(mask[None], mmk.TILE_K, mmk.TILE_N)
    m_, k_ = x.shape
    n_ = w.shape[1]
    b_ms, b_by = bound(4 * (m_ * k_ + (1 + occ) * k_ * n_ + m_ * n_),
                       2 * m_ * k_ * n_ * occ)
    return {"M": m_, "K": k_, "N": n_, "occupancy": occ, "max_abs_err": err,
            "ms": cuda_ms(lambda: mmk.masked_matmul(x, w, mask)),
            "device_ms": device_ms(lambda: mmk.masked_matmul(x, w, mask)),
            "device_cold_ms": device_ms(lambda: mmk.masked_matmul(x, w, mask),
                                        cold_kernel="masked_matmul"),
            "plain_ms": cuda_ms(lambda: mmk.masked_matmul_plain(x, w, mask)),
            "host_us": host_us(lambda: mmk.masked_matmul(x, w, mask)),
            "library_ms": cuda_ms(lambda: torch.mm(x, wm)),
            "library_device_ms": device_ms(lambda: torch.mm(x, wm)),
            **_library_bound(4, 1, m_, k_, n_),
            "bound_ms": b_ms, "bound_by": b_by}


def mm_inputs(torch, dev, u, m, k, n, density, gen):
    """x ~ N(0, 1) and w ~ N(0, 1/K), scaled as the served MLP's weights,
    and a Bernoulli(density) mask."""
    x = torch.randn((u, m, k), generator=gen, device=dev)
    w = torch.randn((u, k, n), generator=gen, device=dev) / math.sqrt(k)
    mask = (torch.rand((u, k, n), generator=gen, device=dev) < density).float()
    return x, w, mask


def check_masked_matmul(torch, mmk, x, w, mask, timed=False):
    """Kernel vs plain (1e-5); with ``timed``, its times, the plain
    version's, one ``torch.bmm`` over the pre-masked weights (the store's
    pool already holds w*m) and the bound.  The bound counts what these
    inputs need, with ``occ`` the live share of the kernel's (TILE_K,
    TILE_N) mask tiles: x and m read once, w read once where its tile is
    live, y written once, over HBM; or 2*U*M*K*N*occ flops over the fp32
    peak; whichever is larger.  At occ = 1 (every serving shape) that is
    x, w, m read once and y written once."""
    u, m, k = x.shape
    n = w.shape[2]
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    want = mmk.batched_masked_matmul_plain(x, w, mask)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **MM_TOL):
        raise AssertionError(f"masked_matmul U={u} M={m} K={k} N={n}: kernel "
                             f"!= plain (max abs err {err})")
    row = {"U": u, "M": m, "K": k, "N": n, "max_abs_err": err}
    if timed:
        occ = mmk.block_occupancy(mask, mmk.TILE_K, mmk.TILE_N)
        wm = w * mask
        row["occupancy"] = occ
        row["ms"] = cuda_ms(lambda: mmk.batched_masked_matmul(x, w, mask))
        row["device_ms"] = device_ms(
            lambda: mmk.batched_masked_matmul(x, w, mask))
        row["device_cold_ms"] = device_ms(
            lambda: mmk.batched_masked_matmul(x, w, mask),
            cold_kernel="masked_matmul")
        row["plain_ms"] = cuda_ms(
            lambda: mmk.batched_masked_matmul_plain(x, w, mask))
        row["host_us"] = host_us(lambda: mmk.batched_masked_matmul(x, w, mask))
        row["library_ms"] = cuda_ms(lambda: torch.bmm(x, wm))
        row["library_device_ms"] = device_ms(lambda: torch.bmm(x, wm))
        row.update(_library_bound(4, u, m, k, n))
        row["bound_ms"], row["bound_by"] = bound(
            4 * (u * m * k + (1 + occ) * u * k * n + u * m * n),
            2 * u * m * k * n * occ)
    return row


def check_mixed_vs_alone(torch, mmk, x, w, mask, users):
    """A user's rows in a mixed batch are bit-equal to the same user served
    alone (every other slot zero) at the same launch width."""
    mixed = mmk.batched_masked_matmul(x, w, mask)
    for i in users:
        xs, ws, ms = (torch.zeros_like(t) for t in (x, w, mask))
        xs[i], ws[i], ms[i] = x[i], w[i], mask[i]
        alone = mmk.batched_masked_matmul(xs, ws, ms)
        if not torch.equal(alone[i], mixed[i]):
            raise AssertionError(f"masked_matmul: user {i} alone != mixed")
    torch.cuda.synchronize()
    return len(users)


def check_masked_matmul_bf16(torch, mmk, x, w, mask, timed=False):
    """The bf16 entries: bf16 ``x`` and ``w``, ``mask`` fp32 or bf16,
    against the plain version within one bf16 ulp (``within_bf16_ulp``),
    a second launch bit-equal to the first; with ``timed``, the times of
    ``check_masked_matmul`` with ``torch.bmm`` on the pre-masked bf16
    weights as the library call. The bound counts x, m and the live tiles'
    w read once and y written once, or 2*U*M*K*N*occ operations over the
    bf16 tensor-core peak."""
    u, m, k = x.shape
    n = w.shape[2]
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    want = mmk.batched_masked_matmul_plain(x, w, mask)
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    if got.dtype != torch.bfloat16 or not mmk.within_bf16_ulp(got, want):
        raise AssertionError(f"bf16 masked_matmul U={u} M={m} K={k} N={n} "
                             f"mask {mask.dtype}: kernel not within one bf16 "
                             f"ulp of plain (max abs err {err})")
    if not torch.equal(mmk.batched_masked_matmul(x, w, mask), got):
        raise AssertionError(f"bf16 masked_matmul U={u} M={m} K={k} N={n} "
                             f"mask {mask.dtype}: two launches differ")
    row = {"U": u, "M": m, "K": k, "N": n, "max_abs_err": err,
           "dtype": f"bfloat16/{str(mask.dtype).replace('torch.', '')}"}
    if timed:
        occ = mmk.block_occupancy(mask, mmk.TILE_K, mmk.TILE_N)
        wm = w * mask.to(w.dtype)
        call = lambda: mmk.batched_masked_matmul(x, w, mask)  # noqa: E731
        row.update(
            occupancy=occ, ms=cuda_ms(call), device_ms=device_ms(call),
            device_cold_ms=device_ms(call, cold_kernel="masked_matmul"),
            plain_ms=cuda_ms(
                lambda: mmk.batched_masked_matmul_plain(x, w, mask)),
            host_us=host_us(call), library_ms=cuda_ms(lambda: torch.bmm(x, wm)),
            library_device_ms=device_ms(lambda: torch.bmm(x, wm)),
            **_library_bound(2, u, m, k, n))
        row["bound_ms"], row["bound_by"] = bound(
            2 * u * m * k + (mask.element_size() + 2 * occ) * u * k * n
            + 2 * u * m * n, 2 * u * m * k * n * occ, BF16_FLOPS_PER_S)
    return row


def _ms(v):
    return "not measured" if v is None else f"{v} ms"


def _times(r):
    host = f", host {r['host_us']} us per call" if "host_us" in r else ""
    cold = (f" (cold L2 {_ms(r['device_cold_ms'])})" if "device_cold_ms" in r
            else "")
    return (f"per call {r['ms']} ms, device {_ms(r['device_ms'])}{cold}, "
            f"plain {r['plain_ms']} ms, bound {r['bound_ms']} ms "
            f"({r['bound_by']}){host}, max abs err {r['max_abs_err']}")


def _library_bound(itemsize, u, m, k, n):
    """The bound of ``torch.bmm``/``torch.mm`` on pre-masked weights: x and
    w*m read once, y written once (no mask, so below the kernel's bound),
    or its dense operations over the fp32 or bf16 peak."""
    ms_, by = bound(itemsize * (u * m * k + u * k * n + u * m * n),
                    2 * u * m * k * n,
                    FP32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S)
    return {"library_bound_ms": ms_, "library_bound_by": by}


def _library(r, call):
    return (f", {call} per call {r['library_ms']} ms, device "
            f"{_ms(r['library_device_ms'])}, its bound "
            f"{r['library_bound_ms']} ms ({r['library_bound_by']}, reads no "
            f"mask)")


class BudgetCheck:
    """Engine callback: after each round's evolve, every client's mask holds
    exactly its ERK budget on every sparsifiable leaf."""

    def __init__(self):
        self.rounds_checked = 0

    def on_round_end(self, engine, metrics):
        from repro_torch.utils.tree import tree_index, tree_leaves_with_path
        strat = engine.strategy
        masks = engine.state["masks"]
        if isinstance(masks, dict):                 # ScaleEngine: stacked
            masks = [tree_index(masks, k) for k in range(len(engine.clients))]
        for k, mask in enumerate(masks):
            budgets = strat.budgets_at(metrics.round, k)
            nnz = {p: int((x != 0).sum()) for p, x in
                   tree_leaves_with_path(mask) if p in budgets}
            if nnz != budgets:
                bad = {p: (nnz.get(p), b) for p, b in budgets.items()
                       if nnz.get(p) != b}
                raise AssertionError(f"round {metrics.round} client {k}: "
                                     f"mask nnz != ERK budget: {bad}")
        self.rounds_checked += 1

    def on_run_end(self, engine):
        pass


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA GPU", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.device import setup_device
    from repro_torch.kernels import build
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.kernels import masked_matmul as mmk
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.kernels import prune_regrow as pr
    from repro_torch.launch import train
    from repro_torch.sparse.packed import pack_bits
    counters = (ga, pa, mmk, pr)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = setup_device("cuda")      # TF32 off: fp32 plain and library calls

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(build.sources())} sources, {len(logs)} compiled in "
        f"{time.perf_counter() - t0:.2f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in PTXAS_LINES):
                log(f"  {name}: {line.strip()}")
    log("kernels: " + ", ".join(
        f"{src.stem} (src/repro_torch/kernels/csrc/{src.name})"
        for src in build.sources()))

    # 3. kernels against their plain versions at main-path shapes
    from repro_torch.models.cnn import init_resnet18
    from repro_torch.utils.tree import tree_leaves
    sizes = [x.numel() for x in tree_leaves(
        init_resnet18(torch.Generator().manual_seed(0), 10))]
    n_leaf, n_tree = max(sizes), sum(sizes)
    log(f"resnet18-gn: {len(sizes)} leaves, largest {n_leaf}, total {n_tree}")
    gen = torch.Generator(device=dev).manual_seed(0)
    gossip_rows = [check_gossip(torch, ga, dev, 4, n, dt, gen)
                   for n in (n_leaf, n_tree)
                   for dt in (torch.float32, torch.bfloat16)]
    fold_rows = [check_fold(torch, pa, pack_bits, dev, n, alpha, gen)
                 for n in (n_leaf, n_tree) for alpha in (1.0, 0.75)]
    for r in gossip_rows:
        log(f"gossip_avg J={r['J']} N={r['N']} {r['dtype']}: " + _times(r))
    g_host = gossip_host(torch, ga, dev, 4, min(sizes), gen)
    log(f"gossip_avg host per call, J=4 N={g_host['N']} fp32: "
        f"{g_host['host_us']} us (runs {g_host['runs']})")
    g_host_bf16 = gossip_host(torch, ga, dev, 4, min(sizes), gen,
                              torch.bfloat16)
    log(f"gossip_avg host per call, J=4 N={g_host_bf16['N']} bf16: "
        f"{g_host_bf16['host_us']} us (runs {g_host_bf16['runs']})")
    for r in fold_rows:
        log(f"packed_accum N={r['N']} nnz={r['nnz']} alpha={r['alpha']}: "
            + _times(r))
    f_host = fold_tree_host(torch, pa, dev, gen)
    log(f"packed_accum host per fold through the tree path "
        f"(packed_accum_all over a ResNet18-GN payload, {f_host['leaves']} "
        f"leaves, one read-back): {f_host['host_us']} us a fold, "
        f"{f_host['tree_host_us']} us a tree (runs {f_host['runs']}); one "
        f"call a fold: {f_host['single_host_us']} us a fold; the tree's "
        f"time as the caller sees it {f_host['ms_per_fold']} ms a fold")
    rows_rows = [check_fold_rows(torch, pa, dev, 4, n, alpha, gen)
                 for n in (n_leaf, n_tree) for alpha in (1.0, 0.75)]
    pr_rows = [check_prune_regrow(torch, pr, dev, 4, n, gen)
               for n in (n_leaf, n_tree)]
    for r in rows_rows:
        log(f"packed_accum_rows K={r['K']} N={r['N']} nnz={r['nnz']} "
            f"alpha={r['alpha']}: " + _times(r))
    for r in pr_rows:
        log(f"prune_regrow K={r['K']} N={r['N']}: " + _times(r)
            + f", torch.sort of the two thresholds {r['sort_ms']} ms")
    pr_host = prune_regrow_host(torch, pr, dev, 4, 4096, gen)
    log(f"prune_regrow host per call, K=4 N={pr_host['N']}: "
        f"{pr_host['host_us']} us (runs {pr_host['runs']})")
    mm_rows = mm_checks(torch, mmk, dev, gen)
    mm1 = check_mm_single(torch, mmk, dev, gen)
    log(f"masked_matmul U=1 M={mm1['M']} K={mm1['K']} N={mm1['N']} density "
        f"0.2 occupancy {mm1['occupancy']:.4f}: " + _times(mm1)
        + _library(mm1, "torch.mm"))
    mm_bf16 = bf16_matmul_checks(torch, mmk, dev)

    # 17's sweep: host-only tracing in processes of its own from here on
    sweep = DryrunSweep()

    # 15. the observability plane, while no other engine is alive
    t_obs = time.perf_counter()
    obs_launches = obs_path(torch, train, counters)
    log(f"obs phase: {time.perf_counter() - t_obs:.1f} s; traced launches "
        f"{obs_launches}")

    # 16 (b). the kernels' other bf16 and fp16 entries against their plain
    # versions, timed while the profiler still records every launch (the
    # bf16 masked matmul's rows are phase 3's)
    prec = {**precision_kernels(torch, n_leaf), **mm_bf16}

    # 4. the training path through the CLI's entry functions
    args = train.build_parser().parse_args([
        "simulate", "--model", "resnet18", "--hw", "32", "--clients", "4",
        "--rounds", "2", "--local-epochs", "1", "--samples-per-class", "20",
        "--exec", "loop"])
    engine = train.build_engine(args)
    budget_check = BudgetCheck()
    engine.callbacks.append(budget_check)
    _zero(counters)
    out = train.run_engine(args, engine)
    launches = _launches(counters)
    log(f"training path launches: {launches}")
    if min(launches["gossip_avg"], launches["packed_accum"]) < 1:
        raise AssertionError(f"a kernel of the training path never ran: "
                             f"{launches}")
    if budget_check.rounds_checked != args.rounds:
        raise AssertionError("the ERK budget check did not run every round")
    accs = out["acc_history"] + [out["final_acc"]]
    if not all(a == a and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"accuracy not finite in [0, 1]: {accs}")
    if out["device"] != "cuda" or out["comm"]["busiest_MB"] <= 0:
        raise AssertionError(f"unexpected run summary: {out['device']} "
                             f"{out['comm']}")
    for t, (wall, ph) in enumerate(zip(out["round_wall_s"], out["phase_s"])):
        log(f"round {t}: wall {wall:.4f} s; " + ", ".join(
            f"{k} {v:.4f} s" for k, v in ph.items()))

    from repro_torch.fl.base import FLConfig
    from repro_torch.fl.engine import RoundEngine, make_strategy
    dense = RoundEngine(
        make_strategy("dispfl", packed=False), engine.task, engine.clients,
        FLConfig(**{**engine.cfg.__dict__, "rounds": 1}), local_exec="loop")
    ga.LAUNCHES = 0
    pa.LAUNCHES = 0
    dense_res = dense.run()
    log(f"packed=False round: launches gossip_avg={ga.LAUNCHES} "
        f"packed_accum={pa.LAUNCHES}, acc {dense_res.final_acc:.4f}, "
        f"phases {dense.phase_s[0]}")
    if ga.LAUNCHES < 1 or pa.LAUNCHES != 0:
        raise AssertionError("the dense mix must run the gossip kernel only")
    _free_graphs(engine, dense)

    profile_round(torch, train, args)

    # 5. the stacked path through the CLI's entry functions, then both
    # stacked kernels on the engine's own state
    scale_runs = scale_path(torch, train, counters, out)
    scale_launches = scale_state_kernels(torch, scale_runs["ordered"][0],
                                         counters)
    profile_round(torch, train, train.build_parser().parse_args(
        SCALE_ARGS + ["--scale-reduction", "ordered"]))
    for scale_engine, *_ in scale_runs.values():
        _free_graphs(scale_engine)
        _release(scale_engine._round_step)

    # 6. a small round on the card against the same round on the CPU, on
    # the loop engine and on the stacked engine's ordered mix
    for engine_args in (["--exec", "loop"],
                        ["--scale", "--scale-reduction", "ordered"]):
        cross = cross_check(torch, train, engine_args)
        log(f"cuda vs cpu smallcnn round {' '.join(engine_args)}: {cross}")

    # 7. the serving path through the CLI's entry functions
    serve_launches = serve_path(torch, counters)
    mm = mm_rows["serve"][1]          # the (128, 128) layer at serve shapes

    # 8.-11. the vmap local phase and the simulator, sync and async
    vmap_vs_loop(torch, train)
    sync_launches = sim_sync_path(torch, train, counters)
    async_launches, async_engine = sim_async_path(torch, train, counters)
    profile_async_round(torch, train)
    sim_checkpoint_path(torch, train, async_engine)
    _free_graphs(async_engine)

    # 12. the strategies this slice added: each at ResNet18-GN, dpsgd async
    # and stacked, vmap against loop, and a small round cuda against cpu
    t_strat = time.perf_counter()
    strat_runs = strategy_path(torch, train, counters, len(sizes))
    strat_async = strategy_async_dpsgd(torch, train, counters, len(sizes))
    strat_scale = strategy_scale_dpsgd(torch, train, counters,
                                       strat_runs["dpsgd"])
    for name in ("dpsgd", "local", "fedavg"):
        vmap_vs_loop(torch, train, name, cpu_gap=False)
    for name in NEW_STRATEGIES:
        cross = cross_check(torch, train, ["--exec", "loop", "--strategy",
                                           name])
        log(f"cuda vs cpu smallcnn round {name}: {cross}")
    strat_launches = {k: sum(r[2][k] for r in strat_runs.values())
                      + strat_async[k]
                      + sum(r[k] for r in strat_scale.values())
                      for k in strat_async}
    log(f"strategy phase: {time.perf_counter() - t_strat:.1f} s; launches "
        f"{strat_launches}")

    # (phase 13 (b)'s stores need the card's memory: the sweep's
    # processes, which hold CUDA contexts, end first)
    sweep.wait()

    # 13. the serving CLI's other families: smallcnn and the smoke archs,
    # then two archs at their published widths
    t_models = time.perf_counter()
    models_launches = serve_models_path(torch, counters)
    log(f"serve_models phase: {time.perf_counter() - t_models:.1f} s; "
        f"launches {models_launches}")

    # 14. LM training: the lm CLI on every decoder smoke arch, then the
    # step builders at gemma3-1b's published width
    t_lm = time.perf_counter()
    lm_launches, lm_fp32 = lm_path(torch, counters)
    log(f"lm phase: {time.perf_counter() - t_lm:.1f} s; launches "
        f"{lm_launches}")
    # 14 (c). the same step under the models' rematerialisation
    remat_launches, _ = lm_remat(torch, counters)

    # 16 (a), (c), (d). reduced precision: gemma3-1b at bf16 beside phase
    # 14's fp32, fp16 stacked payloads, an fp16 store
    t_prec = time.perf_counter()
    prec.update(precision_path(torch, counters, lm_fp32))
    log(f"precision phase: {time.perf_counter() - t_prec:.1f} s")

    # 18. compiled steps: gemma3-1b's step builders and ResNet18-GN's
    # stacked round as CUDA graphs against the same steps run eagerly
    compiled_launches, _ = compiled_path(torch, train, counters, lm_fp32,
                                         prec["lm_bf16"])

    # 17. the single-card dry run against phase 14's and 16 (a)'s steps,
    # then its sweep (every arch at train_4k) and report
    t_dry = time.perf_counter()
    dryrun_path(torch, {"fp32": lm_fp32, "bf16": prec["lm_bf16"]}, sweep)
    log(f"dry-run phase: {time.perf_counter() - t_dry:.1f} s")

    # 19. the port's seven examples at the reference's sizes
    examples_launches = examples_path(torch, counters)

    # 20. the client-sharded scale round: a world of one NCCL rank, then
    # four gloo ranks sharing the card
    mesh_launches = mesh_path(torch, train, counters, card)

    # 21. the LM steps over a DeviceMesh: gemma3-1b on a world of one NCCL
    # rank, four smoke archs on four gloo ranks, the multi-pod dry run's
    # records
    steps_launches = steps_mesh_path(torch, counters, card, sweep)

    # every row's launches are its own C entry's (the U=1 rows the U=1
    # wrapper's), as the wrappers counted them on each path: ``launches`` on
    # the row's main path, ``launches_<path>`` on every other counted path
    paths = {"training": launches, "scale_ordered": scale_runs["ordered"][2],
             "scale_state": scale_launches, "serve": serve_launches,
             "sim_sync": sync_launches, "sim_async": async_launches,
             "strategies": strat_launches, "serve_models": models_launches,
             "lm": lm_launches, "obs": obs_launches,
             "precision": prec["launches"], "compiled": compiled_launches,
             "examples": examples_launches, "mesh": mesh_launches,
             "mesh_steps": steps_launches, "remat": remat_launches}

    def row(name, source, replaces, entry, main, shape, r):
        timed = {key: r[key] for key in (
            "ms", "device_ms", "device_cold_ms", "plain_ms", "host_us",
            "bound_ms", "bound_by", "library_ms", "library_device_ms",
            "sort_ms") if key in r}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "entry": entry,
                "launches": paths[main][entry],
                **{f"launches_{p}": la[entry] for p, la in paths.items()
                   if p != main},
                "shape": shape, "max_abs_err": r["max_abs_err"],
                "library_ms": None, **timed}

    kernels = [
        row("gossip_avg", "gossip_avg.cu", "src/repro/kernels/gossip_avg.py:37",
            "gossip_avg_f32", "training", f"J=4 N={n_leaf} float32",
            {**gossip_rows[0], "host_us": g_host["host_us"], "max_abs_err": max(
                r["max_abs_err"] for r in gossip_rows if r["dtype"] == "float32")}),
        row("gossip_avg_bf16", "gossip_avg.cu",
            "src/repro/kernels/gossip_avg.py:37", "gossip_avg_bf16",
            "precision", f"J=4 N={n_leaf} bfloat16",
            {**gossip_rows[1], "host_us": g_host_bf16["host_us"],
             "max_abs_err": max(r["max_abs_err"] for r in gossip_rows
                                if r["dtype"] == "bfloat16")}),
        row("packed_accum", "packed_accum.cu",
            "src/repro/kernels/packed_accum.py:63", "packed_accum_f32",
            "training", f"N={n_leaf} density 0.5 alpha 1 float32",
            {**fold_rows[0], "library_device_ms": None,
             "host_us": f_host["host_us"], "max_abs_err": max(
                 r["max_abs_err"] for r in fold_rows)}),
        row("packed_accum_f16", "packed_accum.cu",
            "src/repro/kernels/packed_accum.py:63", "packed_accum_f16",
            "precision", f"N={n_leaf} density 0.5 alpha 1 float16",
            {**prec["fold_f16"], "library_device_ms": None}),
        row("packed_accum_rows", "packed_accum.cu",
            "src/repro/kernels/packed_accum.py:105", "packed_accum_rows_f32",
            "scale_state", f"K=4 N={n_leaf} density 0.5 alpha 1 float32",
            {**rows_rows[0], "library_device_ms": None, "max_abs_err": max(
                r["max_abs_err"] for r in rows_rows)}),
        row("packed_accum_rows_f16", "packed_accum.cu",
            "src/repro/kernels/packed_accum.py:105", "packed_accum_rows_f16",
            "precision", f"K=4 N={n_leaf} density 0.5 alpha 1 float16",
            {**prec["rows_f16"], "library_device_ms": None}),
        row("prune_regrow", "prune_regrow.cu",
            "src/repro/kernels/prune_regrow.py:44", "prune_regrow_rows_f32",
            "scale_state", f"K=4 N={n_leaf} float32/float32",
            {**pr_rows[0], "host_us": pr_host["host_us"], "max_abs_err": max(
                r["max_abs_err"] for r in pr_rows)}),
    ]
    for name, pair, entry, main in (
            ("prune_regrow_f32_i8", (torch.float32, torch.int8),
             "prune_regrow_rows_f32_i8", "lm"),
            ("prune_regrow_bf16_i8", (torch.bfloat16, torch.int8),
             "prune_regrow_rows_bf16_i8", "precision"),
            ("prune_regrow_bf16", (torch.bfloat16, torch.bfloat16),
             "prune_regrow_rows_bf16", "precision")):
        r = prec["pr"][pair]
        kernels.append(row(name, "prune_regrow.cu",
                           "src/repro/kernels/prune_regrow.py:44", entry, main,
                           f"K=4 N={n_leaf} {r['dtype']}", r))
    kernels += [
        row("masked_matmul", "masked_matmul.cu",
            "src/repro/kernels/masked_matmul.py:131",
            "batched_masked_matmul_f32", "serve",
            f"U={mm['U']} M={mm['M']} K={mm['K']} N={mm['N']} density 0.5 "
            f"float32", {**mm, "max_abs_err": max(
                r["max_abs_err"] for rows in mm_rows.values() for r in rows)}),
        row("masked_matmul_u1", "masked_matmul.cu",
            "src/repro/kernels/masked_matmul.py:64",
            "batched_masked_matmul_f32_u1", "serve",
            f"M={mm1['M']} K={mm1['K']} N={mm1['N']} density 0.2 float32",
            mm1),
    ]
    for name, r, entry, replaces in (
            ("masked_matmul_bf16", prec["mm"], "batched_masked_matmul_bf16",
             "src/repro/kernels/masked_matmul.py:131"),
            ("masked_matmul_bf16_mbf16", prec["mm_mbf16"],
             "batched_masked_matmul_bf16_mbf16",
             "src/repro/kernels/masked_matmul.py:131"),
            ("masked_matmul_u1_bf16", prec["mm_u1"],
             "batched_masked_matmul_bf16_u1",
             "src/repro/kernels/masked_matmul.py:64")):
        kernels.append(row(
            name, "masked_matmul.cu", replaces, entry, "precision",
            f"U={r['U']} M={r['M']} K={r['K']} N={r['N']} {r['dtype']}",
            {**r, "max_abs_err": prec["mm_err"]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


SCALE_ARGS = ["simulate", "--scale", "--model", "resnet18", "--hw", "32",
              "--clients", "4", "--rounds", "2", "--local-epochs", "1",
              "--samples-per-class", "20"]


EXAMPLES = ("quickstart", "custom_strategy", "heterogeneous_clients",
            "async_gossip", "scale_mesh", "serve_personalized", "train_e2e")
# each example's arguments here (none: the reference example's sizes)
EXAMPLE_ARGS = {}


def _example_accuracies(name, out):
    """The accuracies an example reports, from what its ``main`` returns."""
    if name == "quickstart":
        return [a for r in out.values() for a in r.acc_history + r.final_accs]
    if name == "custom_strategy":
        return out.acc_history + out.final_accs
    if name == "heterogeneous_clients":
        return [a for r in out.values() for a in r.acc_history + r.final_accs]
    if name == "async_gossip":
        return [a for e in out["engines"].values() for _, a in e.acc_trace]
    if name == "scale_mesh":
        return out["accs"]
    return []


def examples_path(torch, counters):
    """Phase 19: each port example's ``main`` in this process at the
    reference example's printed sizes, on the card: its wall seconds, its
    rows (it prints them) and each C entry's launches, counters zeroed
    just before each.  An example that raises, or an accuracy that is not
    finite in [0, 1], fails the phase.  Returns the launches summed."""
    import importlib.util

    runs, t_phase = [], time.perf_counter()
    for name in EXAMPLES:
        path = os.path.join(ROOT, "examples", f"torch_{name}.py")
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = EXAMPLE_ARGS.get(name, [])
        log(f"example {name} {' '.join(argv)}:")
        _zero(counters)
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        la = _launches(counters)
        accs = _example_accuracies(name, out)
        if not all(a == a and 0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"example {name}: accuracy not finite in "
                                 f"[0, 1]: {accs}")
        if name == "serve_personalized" and not all(
                r["requests"] > 0 for r in out.values()):
            raise AssertionError(f"example {name}: served nothing: {out}")
        if name == "train_e2e" and not isinstance(out.get("improved"), bool):
            raise AssertionError(f"example {name}: summary {out}")
        ran = {k: v for k, v in la.items() if v and k not in KERNEL_TOTALS}
        log(f"example {name}: {wall:.1f} s wall, {len(accs)} accuracies in "
            f"[0, 1]; launches by C entry {ran}")
        runs.append(la)
        del out, mod
        _release()           # what the finished example left, graphs too
    log(f"examples phase: {time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(runs)


def scale_path(torch, train, counters, loop_out):
    """Phase 5: ``simulate --scale`` through the CLI's entry functions, once
    per reduction, launch counters zeroed just before each run and read
    just after; then both stacked kernels on the ordered run's own state.
    Returns the runs' summaries and launches and the kernels' rows."""
    runs = {}
    for reduction in ("ordered", "einsum"):
        args = train.build_parser().parse_args(
            SCALE_ARGS + ["--scale-reduction", reduction])
        engine = train.build_engine(args)
        budget_check = BudgetCheck()
        engine.callbacks.append(budget_check)
        _zero(counters)
        out = train.run_engine(args, engine)
        launches = _launches(counters)
        log(f"scale --scale-reduction {reduction} launches: {launches}")
        gossips = launches["gossip_avg"]
        if not (gossips >= 1 if reduction == "ordered" else gossips == 0):
            raise AssertionError(f"{reduction}: gossip kernel launches "
                                 f"{gossips}")
        if budget_check.rounds_checked != args.rounds:
            raise AssertionError("the ERK budget check did not run every round")
        accs = out["acc_history"] + [out["final_acc"]]
        if not all(a == a and 0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"{reduction}: accuracy not finite: {accs}")
        if out["comm"] != loop_out["comm"] or out["device"] != "cuda":
            raise AssertionError(f"{reduction}: comm rows {out['comm']} != "
                                 f"the loop engine's {loop_out['comm']}")
        for t, (wall, ph) in enumerate(zip(out["round_wall_s"],
                                           out["phase_s"])):
            log(f"scale {reduction} round {t}: wall {wall:.4f} s; " + ", ".join(
                f"{k} {v:.4f} s" for k, v in ph.items()))
        log(f"scale {reduction}: step_calls {engine.scale_obs.snapshot()}, "
            f"accs {accs}")
        engine._round_step.release()      # its graph's pool, until needed
        runs[reduction] = (engine, out, launches)
    return runs


def scale_state_kernels(torch, engine, counters):
    """Phase 5 (c): the stacked fold and the threshold prune/regrow on the
    engine's own state after its rounds, counters zeroed just before and
    read just after each; returns their launches, summed."""
    from repro_torch.scale.stacked import (
        default_threshold_sparsifiable,
        fold_stacked,
        pack_stacked,
        stacked_grads,
        stacked_prune_regrow_threshold,
    )
    from repro_torch.utils.tree import tree_leaves, tree_map
    params, masks = engine.state["params"], engine.state["masks"]
    leaves = tree_leaves(params)
    packed = pack_stacked(params, masks)
    zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
    _zero(counters)
    num, den = fold_stacked(zeros(), zeros(), packed)
    torch.cuda.synchronize()
    fold = _launches(counters)
    fold_launches = fold["packed_accum_rows"]
    for a, b, w, m in zip(tree_leaves(num), tree_leaves(den), leaves,
                          tree_leaves(masks)):
        if not (torch.equal(a, w * m) and torch.equal(b, m)):
            raise AssertionError("fold_stacked(0, 0, pack_stacked(w, m)) != "
                                 "(w*m, m)")
    if fold_launches != len(leaves):
        raise AssertionError(f"fold_stacked launched {fold_launches} times "
                             f"for {len(leaves)} leaves")
    # the last round's evolve batch: its draws follow the batch schedule's
    ctx = engine._make_ctx(engine.cfg.rounds - 1)
    engine._stacked_batches(ctx, range(len(engine.clients)),
                            engine.cfg.local_epochs)
    grads = stacked_grads(engine.task.apply_fn, params,
                          *engine._evolve_batches(ctx))
    density = engine.cfg.density
    _zero(counters)
    new_m, new_w = stacked_prune_regrow_threshold(
        params, masks, grads, ctx.prune_rate, density)
    torch.cuda.synchronize()
    prune = _launches(counters)
    pr_launches = prune["prune_regrow"]
    n_sparse = sum(default_threshold_sparsifiable(w) for w in leaves)
    if pr_launches != n_sparse:
        raise AssertionError(f"prune_regrow launched {pr_launches} times for "
                             f"{n_sparse} sparsifiable leaves")
    cpu = lambda t: tree_map(lambda x: x.cpu(), t)  # noqa: E731
    want_m, want_w = stacked_prune_regrow_threshold(
        cpu(params), cpu(masks), cpu(grads), ctx.prune_rate, density)
    for a, b in zip(tree_leaves(new_m) + tree_leaves(new_w),
                    tree_leaves(want_m) + tree_leaves(want_w)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("stacked_prune_regrow_threshold on the card "
                                 "!= the same call on the CPU")
    drift = []
    for w, m in zip(leaves, tree_leaves(new_m)):
        if default_threshold_sparsifiable(w):
            n_active = max(1, int(round(density * w[0].numel())))
            drift += [int(x) - n_active for x in
                      (m != 0).reshape(m.shape[0], -1).sum(dim=1).tolist()]
    log(f"scale state kernels: fold_stacked {fold_launches} launches "
        f"(= leaves), exact; stacked_prune_regrow_threshold {pr_launches} "
        f"launches (= sparsifiable leaves), equal to the CPU call; nnz drift "
        f"against the static budget per (leaf, client): sum {sum(drift)}, "
        f"max |drift| {max((abs(d) for d in drift), default=0)} over "
        f"{len(drift)}, prune "
        f"rate {ctx.prune_rate}")
    return _sum_launches([fold, prune])


RESNET_ARGS = ["simulate", "--model", "resnet18", "--hw", "32", "--clients",
               "4", "--rounds", "2", "--local-epochs", "1",
               "--samples-per-class", "20"]
# a full-speed client's round takes 30 virtual seconds: a ResNet18-GN
# payload (~24 MB) needs ~2 s on a 100 Mb/s link and ~19 s on a 10 Mb/s one,
# so at the default 1 s nothing arrives in time to be mixed within 2 rounds
ASYNC_ARGS = ["--sim", "--async", "--staleness", "2", "--compute-hetero",
              "--bandwidth-skew", "10", "--loss-prob", "0.1", "--uplink-mode",
              "fifo", "--topology", "random", "--degree", "2", "--round-s",
              "30"]


def _zero(counters):
    """Every launch count to 0: each kernel's, the stacked fold's
    ``LAUNCHES_ROWS``, the U=1 masked matmul's ``LAUNCHES_U1`` and each C
    entry's (``LAUNCHES_BY_ENTRY``, ``LAUNCHES_U1_BY_ENTRY``)."""
    for c in counters:
        c.LAUNCHES = 0
        for extra in ("LAUNCHES_ROWS", "LAUNCHES_U1"):
            if hasattr(c, extra):
                setattr(c, extra, 0)
        for table in ("LAUNCHES_BY_ENTRY", "LAUNCHES_U1_BY_ENTRY"):
            counts = getattr(c, table, {})
            for entry in counts:
                counts[entry] = 0


# the per-kernel keys of ``_launches``; the others are its C entries'
KERNEL_TOTALS = ("gossip_avg", "packed_accum", "masked_matmul",
                 "prune_regrow", "packed_accum_rows", "masked_matmul_u1")


def _launches(counters):
    """Launches since ``_zero``: each kernel's (``KERNEL_TOTALS``: the
    stacked fold's ``packed_accum_rows`` apart from the flat fold's, the
    U=1 matmul's ``masked_matmul_u1`` among the masked matmul's), then
    each C entry's under its name (the U=1 wrapper's as ``<entry>_u1``),
    as each wrapper counted them where it launched."""
    out = {c.__name__.rsplit(".", 1)[-1]: c.LAUNCHES for c in counters}
    out.update({c.__name__.rsplit(".", 1)[-1] + "_rows": c.LAUNCHES_ROWS
                for c in counters if hasattr(c, "LAUNCHES_ROWS")})
    out.update({c.__name__.rsplit(".", 1)[-1] + "_u1": c.LAUNCHES_U1
                for c in counters if hasattr(c, "LAUNCHES_U1")})
    for c in counters:
        out.update(c.LAUNCHES_BY_ENTRY)
        out.update({f"{entry}_u1": n for entry, n in
                    getattr(c, "LAUNCHES_U1_BY_ENTRY", {}).items()})
    return out


def _totals(launches):
    """The per-kernel counts of a ``_launches`` dict."""
    return {k: launches[k] for k in KERNEL_TOTALS}


def _sum_launches(runs):
    """``_launches`` dicts summed key by key."""
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def _tensors(torch, tree):
    """The tensor leaves of a state (a round's selection lists hold ints)."""
    from repro_torch.utils.tree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _to(torch, tree, device):
    """A copy of a state on ``device``; non-tensor leaves pass through."""
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda x: x.to(device, copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)


def _max_state_diff(torch, a_state, b_state):
    la, lb = _tensors(torch, a_state), _tensors(torch, b_state)
    if len(la) != len(lb):
        raise AssertionError(f"states differ in structure: {len(la)} vs "
                             f"{len(lb)} tensors")
    return max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(la, lb))


def _bit_equal(torch, a, b):
    la, lb = _tensors(torch, a), _tensors(torch, b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def vmap_vs_loop(torch, train, name="dispfl", cpu_gap=True):
    """Phase 8 (and, in phase 12, for dpsgd, local and fedavg): one local
    phase through ``run_local_phase`` from one state with ``--exec vmap``
    and ``--exec loop``; each mode runs twice from the state (the first
    call warms), the second is timed and compared.  With ``cpu_gap`` the
    same loop phase on the CPU gives the scale of fp32 rounding between two
    right answers at this size."""
    from repro_torch.utils.tree import tree_map
    base = RESNET_ARGS + ["--strategy", name]
    auto = train.build_engine(train.parse_args(base))
    n = len(auto.clients)
    resolved = ("vmap" if auto._use_vmap(auto._make_ctx(0), list(range(n)))
                else "loop")
    start = tree_map(torch.clone, auto.state)
    got, secs = {}, {}
    modes = [("vmap", "cuda", 2), ("loop", "cuda", 2)]
    for mode, device, reps in modes + ([("loop", "cpu", 1)] if cpu_gap
                                       else []):
        eng = train.build_engine(train.parse_args(
            base + ["--exec", mode, "--device", device]))
        for _ in range(reps):
            eng.state = _to(torch, start, eng.device)
            ctx = eng._make_ctx(0)          # fresh generators: same draws
            if "params" not in eng.state:
                # FedAvg: its mix draws the round's selection (and moves no
                # parameter); the local phase trains the selected clients
                eng.strategy.mix(eng.state, ctx)
            active = list(eng.strategy.active_clients(eng.state, ctx))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run_local_phase(ctx, active)
            torch.cuda.synchronize()
            secs.setdefault(f"{mode} {device}", []).append(
                time.perf_counter() - t0)
        got[(mode, device)] = _to(torch, eng.state, "cpu")
    diff = _max_state_diff(torch, got[("vmap", "cuda")], got[("loop", "cuda")])
    gap = (f"; the loop on the CPU vs the loop on the card: "
           f"{_max_state_diff(torch, got[('loop', 'cpu')], got[('loop', 'cuda')])}"
           if cpu_gap else "")
    log(f"{name} vmap vs loop local phase (resnet18, K={n}): max abs diff "
        f"{diff} (tolerance {VMAP_PARAM_ATOL}){gap}; seconds {secs} (first, "
        f"warm); --exec auto resolves to {resolved}")
    if not diff <= VMAP_PARAM_ATOL:
        raise AssertionError(f"{name}: vmap and loop local phases differ by "
                             f"{diff}")
    if resolved != "vmap":
        raise AssertionError(f"--exec auto did not resolve to vmap for {name}")
    return diff


def sim_sync_path(torch, train, counters):
    """Phase 9: ``simulate --sim --exec loop`` against ``RoundEngine`` on
    the same arguments, both through the CLI's entry functions; returns the
    sim run's launches."""
    from repro_torch.sparse.codec import encoded_nbytes
    args = train.parse_args(RESNET_ARGS + ["--sim", "--exec", "loop"])
    sim = train.build_engine(args)
    sent = []           # per round: the adjacency and what each client held
    pre_round = sim._pre_round

    def record(ctx):
        # references only (the round replaces these tensors, never writes
        # them), so the check costs the timed round nothing
        sent.append((ctx.adjacency.copy(), {k: list(v) for k, v in
                                            sim.state.items()}))
        pre_round(ctx)

    sim._pre_round = record
    _zero(counters)
    out = train.run_engine(args, sim)
    launches = _launches(counters)
    log(f"sim sync launches: {launches}")
    if min(launches["gossip_avg"], launches["packed_accum"]) < 1:
        raise AssertionError(f"a kernel of the sync sim never ran: {launches}")
    loop_args = train.parse_args(RESNET_ARGS + ["--exec", "loop"])
    loop = train.build_engine(loop_args)
    loop_out = train.run_engine(loop_args, loop)
    for key in ("comm", "flops", "acc_history", "final_acc"):
        if out[key] != loop_out[key]:
            raise AssertionError(f"sync sim {key} {out[key]} != RoundEngine "
                                 f"{loop_out[key]}")
    if not _bit_equal(torch, sim.state, loop.state):
        raise AssertionError("sync sim state != RoundEngine state on the card")
    n = len(sim.clients)
    want = []
    for a, held in sent:
        frames = [encoded_nbytes(sim.strategy.snapshot_message(held, k)
                                 ["packed"]) for k in range(n)]
        want += [(src, dst, float(frames[src])) for src in range(n)
                 for dst in range(n) if a[dst, src] > 0 and dst != src]
    got = [(t.src, t.dst, t.bytes_wire) for t in sim.stats.transfers]
    if got != want or float(sim.stats.up_wire.sum()) != sum(w for *_, w in want):
        raise AssertionError("sync transfers do not carry the senders' codec "
                             "frames")
    log(f"sim sync: state, masks, comm rows, acc history bit-equal to "
        f"RoundEngine; {len(got)} transfers each = encoded_nbytes of the "
        f"sender's payload, up_wire {sim.stats.up_wire.sum()}; report "
        f"{out['sim']}; round walls sim {out['round_wall_s']} loop "
        f"{loop_out['round_wall_s']}")
    return launches


class EvolveBudgetCheck:
    """Wraps a strategy's ``evolve``: after each call the evolved client's
    mask holds exactly its ERK budget (one read-back per evolve)."""

    def __init__(self, strategy):
        self.strategy, self.calls = strategy, 0
        self._evolve = strategy.evolve
        strategy.evolve = self

    def __call__(self, state, k, ctx):
        import torch
        from repro_torch.utils.tree import tree_leaves_with_path
        self._evolve(state, k, ctx)
        budgets = self.strategy.budgets_at(ctx.t, k)
        leaves = [(p, x) for p, x in tree_leaves_with_path(state["masks"][k])
                  if p in budgets]
        nnz = torch.stack([(x != 0).sum() for _, x in leaves]).tolist()
        bad = {p: (n, budgets[p]) for (p, _), n in zip(leaves, nnz)
               if n != budgets[p]}
        if bad or len(leaves) != len(budgets):
            raise AssertionError(f"round {ctx.t} client {k}: mask nnz != ERK "
                                 f"budget: {bad}")
        self.calls += 1


class EmitClock:
    """Engine callback: host seconds at each emitted round."""

    def __init__(self):
        self.t = []

    def on_round_end(self, engine, metrics):
        self.t.append(time.perf_counter())

    def on_run_end(self, engine):
        pass


def sim_async_path(torch, train, counters):
    """Phase 10: ``simulate --sim --async ...`` through the CLI's entry
    functions; returns its launches and the engine (the uninterrupted run
    phase 11 compares with)."""
    from repro_torch.sparse import ops as sparse_ops
    args = train.parse_args(RESNET_ARGS + ASYNC_ARGS)
    engine = train.build_engine(args)
    check = EvolveBudgetCheck(engine.strategy)
    clock = EmitClock()
    engine.callbacks.append(clock)
    _zero(counters)
    sparse_ops.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train.run_engine(args, engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    folds = sparse_ops.COUNTERS["accum_calls"]
    log(f"sim async launches: {launches}; sparse.ops folds {folds}")
    if not launches["packed_accum"] == folds > 0:
        raise AssertionError(f"fold launches {launches['packed_accum']} != "
                             f"folds {folds} (or none)")
    accs = out["acc_history"] + [out["final_acc"]]
    if not all(a == a and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"async accuracy not finite: {accs}")
    if not (engine.observed_spread <= args.staleness
            and engine.observed_mix_lag <= args.staleness
            and engine.mixed_messages > 0 and check.calls > 0):
        raise AssertionError(
            f"async invariants: spread {engine.observed_spread}, mix lag "
            f"{engine.observed_mix_lag}, mixed {engine.mixed_messages}, "
            f"evolves checked {check.calls}")
    rep = engine.report()
    gaps = [b - a for a, b in zip([t0] + clock.t, clock.t)]
    log(f"sim async: {check.calls} evolves within budget; spread "
        f"{engine.observed_spread}, mix lag {engine.observed_mix_lag}, "
        f"mixed {engine.mixed_messages}; virtual time {rep.sim_wall_s} s, "
        f"busiest node {rep.busiest_node_mb} MB, retransmit overhead "
        f"{rep.retrans_mb} MB in {rep.n_retransmits} retransmits, lost "
        f"{rep.lost_messages}; host wall {wall:.4f} s for "
        f"{len(clock.t)} emitted rounds ({wall / max(1, len(clock.t)):.4f} s "
        f"per round; gaps {gaps}); accs {accs}; report {out['sim']}")
    return launches, engine


def profile_async_round(torch, train):
    """The second round of an async run under torch.profiler: the device's
    busy share of its wall time and the kernels that took the most device
    time (the path packs one payload per push, one read-back a payload)."""
    from torch.profiler import ProfilerActivity, profile
    args = train.parse_args(RESNET_ARGS + ASYNC_ARGS)
    args.rounds = 2
    engine = train.build_engine(args)
    # the first round captures the engine's graphs: profile the second
    rounds = engine.rounds()
    next(rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        next(rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for _ in rounds:
        pass
    rows = device_rows(prof)
    if rows is None:
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"profiled async round: wall {wall:.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / wall:.1f}%), {len(engine.stats.transfers)} "
        f"transfers")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3:.3f} ms in {count} launches: {key[:90]}")


def sim_checkpoint_path(torch, train, full):
    """Phase 11: the async run saved after round 0 by ``--sim-checkpoint``,
    abandoned, resumed by ``--resume`` in a fresh engine; the result must
    equal ``full`` (the uninterrupted run of phase 10) bit for bit."""
    import tempfile

    import numpy as np
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sim.npz")
        first = train.build_engine(train.parse_args(
            RESNET_ARGS + ASYNC_ARGS + ["--sim-checkpoint", path]))
        for m in first.rounds():
            if m.round == 0:
                break
        args = train.parse_args(RESNET_ARGS + ASYNC_ARGS + ["--resume", path])
        resumed = train.build_engine(args)
        n_before = len(resumed.stats.transfers)
        out = train.run_engine(args, resumed)
    a, b = resumed.stats, full.stats
    same = (a.transfers == b.transfers and a.n_retransmits == b.n_retransmits
            and a.n_lost == b.n_lost and all(
                np.array_equal(getattr(a, k), getattr(b, k)) for k in
                ("up", "down", "up_wire", "down_wire", "retrans_up",
                 "edge_bytes", "edge_busy_s")))
    if not same or resumed.clock.now != full.clock.now:
        raise AssertionError("resumed async run: transfers, LinkStats or "
                             "clock differ from the uninterrupted run")
    if not _bit_equal(torch, resumed.state, full.state):
        raise AssertionError("resumed async state != uninterrupted state")
    if resumed._acc_history != full._acc_history:
        raise AssertionError("resumed async accuracy history differs")
    log(f"sim async checkpoint: resumed after round 0 ({n_before} transfers "
        f"in the archive, {len(a.transfers) - n_before} after), transfers, "
        f"LinkStats, clock {resumed.clock.now} and state bit-equal to the "
        f"uninterrupted run; acc {out['acc_history']}")


NEW_STRATEGIES = ("dpsgd", "dpsgd_ft", "local", "fedavg", "fedavg_ft", "ditto",
                  "fomo", "subfedavg", "dfedalt", "dfedsam")


def strategy_path(torch, train, counters, n_leaves):
    """Phase 12 (a): ``simulate --strategy NAME`` at ``RESNET_ARGS`` through
    the CLI's entry functions for each strategy this slice added, counters
    zeroed just before each run and read just after.  SubFedAvg's server
    mix must launch the gossip kernel once per leaf and selected client
    each round, and no other run may launch a kernel; then its mix from
    the run's final state on the card must equal the same mix on the CPU
    bit for bit.  Returns each run's launches and summary."""
    runs = {}
    for name in NEW_STRATEGIES:
        args = train.parse_args(RESNET_ARGS + ["--strategy", name])
        engine = train.build_engine(args)
        _zero(counters)
        out = train.run_engine(args, engine)
        launches = _launches(counters)
        sel = getattr(engine.strategy, "n_sel", 0)
        want = {k: 0 for k in KERNEL_TOTALS}
        if name == "subfedavg":
            want["gossip_avg"] = args.rounds * sel * n_leaves
        if _totals(launches) != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        accs = out["acc_history"] + [out["final_acc"]]
        if not all(a == a and 0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"{name}: accuracy not finite: {accs}")
        # per round, unrounded; Local never communicates: zero by definition
        comm = engine._comm["busiest_mb"]
        flops = engine._flops["per_round_flops"]
        if not (min(flops) > 0 and all(c == 0 if name == "local" else c > 0
                                       for c in comm)):
            raise AssertionError(f"{name}: busiest MB {comm}, FLOPs {flops}")
        log(f"strategy {name} ({engine.local_exec}): launches {launches}; "
            f"warm round wall {out['round_wall_s'][-1]:.4f} s, phases "
            + ", ".join(f"{k} {v:.4f} s" for k, v in out["phase_s"][-1].items())
            + f"; accs {accs}; comm {out['comm']}; flops {out['flops']}")
        runs[name] = (engine, out, launches)
        if name in ("dpsgd", "fedavg", "subfedavg"):
            profile_round(torch, train, args)
        _free_graphs(engine)

    engine = runs["subfedavg"][0]
    cpu_state = _to(torch, engine.state, "cpu")
    ctxs = [engine._make_ctx(engine.cfg.rounds) for _ in range(2)]
    engine.strategy.mix(engine.state, ctxs[0])
    engine.strategy.mix(cpu_state, ctxs[1])
    if engine.state["_sel"] != cpu_state["_sel"] or not _bit_equal(
            torch, _to(torch, engine.state, "cpu"), cpu_state):
        raise AssertionError("subfedavg's mix on the card != on the CPU")
    log(f"subfedavg mix from the run's final state: bit-equal to the CPU "
        f"(selected {cpu_state['_sel']})")
    return runs


def strategy_async_dpsgd(torch, train, counters, n_leaves):
    """Phase 12 (b): ``simulate --strategy dpsgd`` under ``ASYNC_ARGS``:
    the fold kernel must launch once per leaf of every mixed message (each
    at its Metropolis weight), the gossip kernel never; then one
    ``mix_one`` from the run's final state on the card must equal the same
    call on the CPU bit for bit.  Returns the run's launches."""
    from repro_torch.sparse import ops as sparse_ops
    args = train.parse_args(RESNET_ARGS + ASYNC_ARGS + ["--strategy", "dpsgd"])
    engine = train.build_engine(args)
    _zero(counters)
    sparse_ops.reset_counters()
    out = train.run_engine(args, engine)
    launches = _launches(counters)
    folds = sparse_ops.COUNTERS["accum_calls"]
    mixed = engine.mixed_messages
    want = {**{k: 0 for k in KERNEL_TOTALS}, "packed_accum": mixed * n_leaves}
    if not (_totals(launches) == want and folds == mixed * n_leaves > 0):
        raise AssertionError(f"async dpsgd: launches {launches}, folds "
                             f"{folds}, mixed messages {mixed}")
    accs = out["acc_history"] + [out["final_acc"]]
    if not all(a == a and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"async dpsgd: accuracy not finite: {accs}")
    strat, ctx = engine.strategy, engine._make_ctx(0)
    states = [engine.state, {"params": _to(torch, engine.state["params"],
                                            "cpu")}]
    for st in states:
        senders = {j: strat.snapshot_message(st, j) for j in (1, 2)}
        strat.mix_one(st, 0, senders, ctx)
    if not _bit_equal(torch, _to(torch, states[0]["params"][0], "cpu"),
                      states[1]["params"][0]):
        raise AssertionError("dpsgd mix_one on the card != on the CPU")
    log(f"strategy dpsgd async: launches {launches} = {mixed} mixed messages "
        f"x {n_leaves} leaves; mix_one from the final state bit-equal to the "
        f"CPU; accs {accs}; report {out['sim']}")
    return launches


def strategy_scale_dpsgd(torch, train, counters, vmap_run):
    """Phase 12 (c): ``simulate --scale --strategy dpsgd`` once per
    reduction: no kernel may launch (the Metropolis mix is a matmul or an
    ordered sum), the comm and FLOP rows must equal the loop engine's.
    ``ordered`` adds the loop's terms in the loop's order: its mix, fed
    the vmap ``RoundEngine``'s final state, must be bit-equal to that
    engine's mix of it (``_ordered_mix_bit_equal``).  ``einsum`` sums the
    mix in another order than ``ordered``, whose local phase is the same,
    a gap the two local phases amplify: within ``SCALE_EINSUM_ATOL`` of
    the ``ordered`` run.  The ``RoundEngine``
    runs make other cuDNN calls than the engine's one client a call (the
    vmap run, ``vmap_run``, vmaps all K; an ``--exec loop`` run calls each
    client unvmapped), and cuDNN picks a grouped convolution's algorithm
    by its group count: against each the gap is that choice compounded
    over two local phases, held within ``LOOP_GAP_FACTOR`` times what the
    same loop run differs by between the card and the CPU from one
    initial state.  Returns each reduction's launches."""
    loop_args = train.parse_args(RESNET_ARGS + ["--strategy", "dpsgd",
                                                "--exec", "loop"])
    loop = train.build_engine(loop_args)
    cpu_args = train.parse_args(RESNET_ARGS + ["--strategy", "dpsgd",
                                               "--exec", "loop", "--device",
                                               "cpu"])
    cpu = train.build_engine(cpu_args)
    cpu.state = _to(torch, loop.state, "cpu")
    loop_out = train.run_engine(loop_args, loop)
    train.run_engine(cpu_args, cpu)
    d_dev = _max_state_diff(torch, cpu.state, loop.state)
    vmap_engine, vmap_out, _ = vmap_run
    runs, states = {}, {}
    for reduction in ("ordered", "einsum"):
        args = train.parse_args(SCALE_ARGS + ["--strategy", "dpsgd",
                                              "--scale-reduction", reduction])
        engine = train.build_engine(args)
        _zero(counters)
        out = train.run_engine(args, engine)
        launches = _launches(counters)
        params = engine.adapter.unstack_state(engine.state)
        states[reduction] = params
        d_vmap = _max_state_diff(torch, params, vmap_engine.state)
        d_loop = _max_state_diff(torch, params, loop.state)
        d_ordered = _max_state_diff(torch, params, states["ordered"])
        log(f"scale dpsgd {reduction}: launches {launches}; params vs the "
            f"ordered run {d_ordered}, vs the vmap RoundEngine {d_vmap}, vs "
            f"the loop {d_loop} (the loop on the CPU vs on the card "
            f"{d_dev}); accs "
            f"{out['acc_history']} (vmap {vmap_out['acc_history']}, loop "
            f"{loop_out['acc_history']}); warm round wall "
            f"{out['round_wall_s'][-1]:.4f} s")
        if any(launches.values()):
            raise AssertionError(f"scale dpsgd launched kernels: {launches}")
        if (out["comm"], out["flops"]) != (loop_out["comm"],
                                           loop_out["flops"]):
            raise AssertionError("scale dpsgd rows != the loop engine's")
        if reduction == "ordered" and not _ordered_mix_bit_equal(
                torch, engine, vmap_engine):
            raise AssertionError("scale dpsgd ordered: its mix of the vmap "
                                 "RoundEngine's state != that engine's mix")
        if not d_ordered <= SCALE_EINSUM_ATOL:
            raise AssertionError(f"scale dpsgd {reduction}: params differ "
                                 f"from the ordered run's by {d_ordered}")
        for partner, d in (("vmap RoundEngine", d_vmap), ("loop", d_loop)):
            if not d <= LOOP_GAP_FACTOR * d_dev:
                raise AssertionError(
                    f"scale dpsgd {reduction}: params differ from the "
                    f"{partner}'s by {d}, over {LOOP_GAP_FACTOR} x the "
                    f"card-vs-CPU gap {d_dev}")
        runs[reduction] = launches
    return runs


def _ordered_mix_bit_equal(torch, engine, round_engine):
    """The ``ScaleEngine``'s ``ordered`` mix and the ``RoundEngine``'s
    dpsgd mix on one state (``round_engine``'s, round 0's adjacency):
    bit-equal, whatever either engine's local phase did."""
    from repro_torch.utils.tree import tree_map
    ctx = round_engine._make_ctx(0)
    src = {"params": [tree_map(torch.clone, p)
                      for p in round_engine.state["params"]]}
    first = next(iter(_tensors(torch, src)))
    mixed = engine.adapter.unstack_state(engine.adapter.stacked_mix(
        engine.adapter.stack_state(src),
        engine.adapter.mix_input(ctx, first.device)))
    round_engine.strategy.mix(src, ctx)
    same = _bit_equal(torch, mixed["params"], src["params"])
    log(f"scale dpsgd ordered: mix of the vmap RoundEngine's state bit-equal "
        f"to its own mix: {same}")
    return same


def _serve_arg(flag):
    return int(SERVE_ARGS[SERVE_ARGS.index(flag) + 1])


def mm_checks(torch, mmk, dev, gen):
    """Phase 3 for the masked matmul: the reference's kernel-test sweep,
    the serving shapes (timed), a block-structured mask (timed) and mixed
    batch against alone.  Returns the rows by group."""
    rows = {"sweep": [], "serve": [], "blocks": []}
    for m, k, n in ((64, 128, 128), (128, 256, 128), (70, 200, 90),
                    (13, 50, 17)):
        for density in (0.0, 0.2, 1.0):
            x, w, mask = mm_inputs(torch, dev, 1, m, k, n, density, gen)
            rows["sweep"].append(check_masked_matmul(torch, mmk, x, w, mask))
    u, m = _serve_arg("--cache-size"), _serve_arg("--rows")
    for k, n in ((64, 128), (128, 128), (128, 32)):       # the MLP's layers
        x, w, mask = mm_inputs(torch, dev, u, m, k, n, 0.5, gen)
        rows["serve"].append(
            check_masked_matmul(torch, mmk, x, w, mask, timed=True))
    # whole 128x128 tiles empty for about three users in four, then the
    # same operands with every tile live: the skip shows as the difference
    x, w, dense = mm_inputs(torch, dev, 64, 4, 512, 512, 0.5, gen)
    live = (torch.rand((64, 4, 4), generator=gen, device=dev) < 0.25).float()
    mask = dense * live.repeat_interleave(128, 1).repeat_interleave(128, 2)
    for m_ in (mask, dense):
        rows["blocks"].append(check_masked_matmul(torch, mmk, x, w, m_,
                                                  timed=True))
    x, w, mask = mm_inputs(torch, dev, u, m, 128, 128, 0.5, gen)
    n_alone = check_mixed_vs_alone(torch, mmk, x, w, mask, (0, 1, u // 2, u - 1))
    log(f"masked_matmul sweep: {len(rows['sweep'])} shapes within 1e-5 of "
        f"plain (max abs err {max(r['max_abs_err'] for r in rows['sweep'])}); "
        f"{n_alone} users alone bit-equal to the mixed batch")
    for r in rows["serve"] + rows["blocks"]:
        log(f"masked_matmul U={r['U']} M={r['M']} K={r['K']} N={r['N']} "
            f"occupancy {r['occupancy']:.4f}: " + _times(r)
            + _library(r, "torch.bmm"))
    return rows


def serve_run(torch, counters, backend, trace=False):
    """One serving run through the CLI's entry functions on a store built
    from the same seed, launch counters zeroed just before and read just
    after; with ``trace`` the tracer records spans for the whole run."""
    from repro_torch.device import setup_device
    from repro_torch.launch import serve as cli
    from repro_torch.obs import get_tracer

    args = cli.build_parser().parse_args(SERVE_ARGS + ["--backend", backend])
    model = cli.build_model(args.model, args.rows)
    t0 = time.perf_counter()
    store = cli.build_store(args, model, setup_device(args.device))
    build_s = time.perf_counter() - t0
    tracer = get_tracer()
    if trace:
        tracer.clear()
        tracer.enable(mode="full")
    _zero(counters)
    res = cli.run_serve(args, model, store)
    launches = _launches(counters)
    if trace:
        tracer.disable()
    s = res.summary
    log(f"serve --backend {backend}{' (tracer on)' if trace else ''}: store "
        f"built in {build_s:.3f} s; p50 {s['p50_ms']} ms, p99 {s['p99_ms']} "
        f"ms, {s['requests_per_s']} requests/s, service_s {s['service_s']}, "
        f"{s['requests']} requests in {s['batches']} batches (mean "
        f"{s['mean_batch']}), hit rate {s['cache_hit_rate']}, "
        f"launches {launches}")
    log("  summary " + json.dumps(s))
    return res, store, launches


def serve_path(torch, counters):
    """Phase 7: the serving CLI's entry functions, untraced, in the order
    kernel, vmap, vmap, kernel (so a drift of the shared host's speed
    during the phase falls on both backends alike; their summaries are the
    serving numbers), then a fifth, traced kernel run for the split of
    service time by span; returns the kernel's launch count from the first
    untraced kernel run."""
    from repro_torch.obs import get_tracer
    from repro_torch.sparse.codec import decode, encoded_nbytes

    order = ("kernel", "vmap", "vmap", "kernel")
    runs = [serve_run(torch, counters, b) for b in order]
    (res, store, launches), (vres, vstore, vlaunches) = runs[0], runs[1]
    # the capturing call (warmup) runs the forward eagerly and replays it
    want = 3 * (res.summary["batches"] + 2)
    for b, (r, st, la) in zip(order, runs):
        if la["masked_matmul"] != (want if b == "kernel" else 0):
            raise AssertionError(f"{b}: masked_matmul launches {la}, "
                                 f"expected {want if b == 'kernel' else 0}")
        if st.stats() != store.stats() or sorted(r.outputs) != sorted(res.outputs):
            raise AssertionError(f"{b} run disagrees on the cache: "
                                 f"{st.stats()} vs {store.stats()}")
    err = 0.0
    for rid, y in res.outputs.items():
        v = vres.outputs[rid]
        if y.shape != (_serve_arg("--rows"), 32) or not torch.isfinite(
                torch.from_numpy(y)).all():
            raise AssertionError(f"request {rid}: output {y.shape} not finite")
        if not torch.allclose(torch.from_numpy(y), torch.from_numpy(v), **MM_TOL):
            raise AssertionError(f"request {rid}: kernel != vmap")
        if not (runs[3][0].outputs[rid] == y).all():
            raise AssertionError(f"request {rid}: two kernel runs differ")
        err = max(err, float(abs(y - v).max()))
    at_rest = sum(encoded_nbytes(decode(store.frame(u), store.spec))
                  for u in store.users())
    if at_rest != store.total_bytes_at_rest():
        raise AssertionError(f"bytes_at_rest {store.total_bytes_at_rest()} "
                             f"!= sum of encoded_nbytes {at_rest}")
    log(f"serve: {len(res.outputs)} outputs kernel vs vmap max abs err {err}; "
        f"two kernel runs bit-equal; cache counters equal {store.stats()}; "
        f"bytes_at_rest {at_rest} == sum of encoded_nbytes")
    svc = {b: [r.summary["service_s"] for bb, (r, _, _) in zip(order, runs)
               if bb == b] for b in ("kernel", "vmap")}
    mean = {b: sum(v) / len(v) for b, v in svc.items()}
    log(f"serve service_s untraced, order {' '.join(order)}: "
        + "; ".join(f"{b} {v} (mean {mean[b]})" for b, v in svc.items()))

    tres, tstore, _ = serve_run(torch, counters, "kernel", trace=True)
    if tstore.stats() != store.stats():
        raise AssertionError("the traced run's cache counters differ")
    split = {}
    for sp in get_tracer().spans(track="serve"):
        split[sp.name] = split.get(sp.name, 0.0) + sp.dur
    t_svc = tres.summary["service_s"]
    log("  service split of the traced run (s): " + ", ".join(
        f"{k} {v:.4f} ({100 * v / t_svc:.1f}%)" for k, v in sorted(split.items()))
        + f"; its service_s {t_svc} against the untraced kernel mean "
        f"{mean['kernel']}")
    return launches


def serve_smoke_model(torch, counters, name):
    """Phase 13 (a) for one family: the CLI's entry functions on the card,
    every request against the same request served alone (same width) and
    against the same store served on the CPU.  Returns the launches."""
    from repro_torch.device import setup_device
    from repro_torch.launch import serve as cli
    from repro_torch.serve import RequestStream, ServeEngine

    args = cli.build_parser().parse_args(SERVE_MODEL_ARGS + ["--model", name])
    model = cli.build_model(args.model, args.rows)
    dev = setup_device(args.device)
    store = cli.build_store(args, model, dev)
    _zero(counters)
    res = cli.run_serve(args, model, store)
    launches = _launches(counters)
    if any(launches.values()):
        raise AssertionError(f"{name}: a kernel launched while serving "
                             f"through vmap: {launches}")
    # a second store of the same users on the same model, as the
    # reference serves two (``tests/test_serve.py``): its warmup takes a
    # capture for its own pool
    alone = ServeEngine(cli.build_store(args, model, dev), model,
                        backend="vmap", max_batch=args.max_batch)
    alone.warmup()
    caps = [g.captures for g in model.graphs()]
    if caps != [2]:
        raise AssertionError(f"{name}: captures {caps} for two stores")
    reqs = RequestStream(n_users=args.users, n_requests=args.requests,
                         seed=args.seed, rate=args.rate).requests()
    # in the order the batched run served them, so the LRU gives each
    # request's user the same pool slot: a vmapped convolution's rounding
    # depends on the slot (1 ulp on the CPU), not on the other slots
    by_rid = {r.rid: r for r in reqs}
    for r in (by_rid[rid] for rid in res.outputs):
        y = res.outputs[r.rid]
        if not bool(torch.isfinite(torch.from_numpy(y)).all()):
            raise AssertionError(f"{name}: request {r.rid} not finite")
        if not (alone.serve([r], warmup=False).outputs[r.rid] == y).all():
            raise AssertionError(f"{name}: request {r.rid} served in a mixed "
                                 "batch differs from the same request alone")
    cpu = cli.run_serve(args, model, cli.build_store(
        args, model, setup_device("cpu")))
    err = max(float(abs(res.outputs[rid] - y).max())
              for rid, y in cpu.outputs.items())
    scale = max(float(abs(y).max()) for y in cpu.outputs.values())
    if err > SERVE_CPU_TOL:
        raise AssertionError(f"{name}: cuda vs cpu max abs err {err} over "
                             f"{SERVE_CPU_TOL}")
    s = res.summary
    log(f"serve --model {name}: service_s {s['service_s']}, p50 "
        f"{s['p50_ms']} ms, p99 {s['p99_ms']} ms, {s['requests']} requests "
        f"in {s['batches']} batches (mean {s['mean_batch']}), bytes_at_rest "
        f"{s['store_bytes_at_rest']}; {len(reqs)} bit-equal alone; cuda vs "
        f"cpu max abs err {err} (largest |output| {scale})")
    return launches


def serve_full_width(torch, counters, cfg):
    """Phase 13 (b) for one full config, and phase 18's full-width serving
    cell: build the store on the card and serve, graphed (the forward
    captured by ``warmup()``), then, from a fresh store of the same base
    and frames, the same requests under ``graph.disabled()``: outputs and
    cache counters bit-equal, one capture of the forward, taken in
    ``warmup()``; each request bit-equal to it served alone (graphed);
    the pool-wide prefill timed with CUDA events, a profiled serving run,
    the peak memory above what was held before and the memory the
    capture holds until ``release()`` (``_graph_hold``).  Each graph is
    released and the store freed before the next.  Returns the launches
    of the graphed serving run."""
    import contextlib
    import gc

    import numpy as np

    from repro_torch.core.accounting import HEADER_NBYTES, bitmap_nbytes
    from repro_torch.core.masks import apply_mask, init_mask
    from repro_torch.serve import ArchModel, ModelStore, RequestStream
    from repro_torch.serve import ServeEngine
    from repro_torch.utils import graph
    from repro_torch.utils.tree import tree_leaves

    # seed 2: three of the five batches hold both users
    reqs = RequestStream(n_users=2, n_requests=8, seed=2).requests()
    runs, users = {}, None
    for mode in ("graphed", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()       # by earlier phases
        t0 = time.perf_counter()
        model = ArchModel(cfg, prompt_len=FULL_WIDTH_PROMPT)
        if users is None:
            gen = torch.Generator(device="cuda").manual_seed(0)
            store = ModelStore(model.init(gen), cache_size=2)
            for u in range(2):
                p = model.init(gen)
                m = init_mask(gen, p, 0.5)
                store.put(u, apply_mask(p, m), m)
                del p, m
        else:
            # the same users' frames over the same base in a fresh store:
            # an empty pool, so the LRU serves the requests as it did
            store = ModelStore(users[0], cache_size=2)
            store._frames, store._nnz = users[1:]
        n_params = sum(x.numel() for x in tree_leaves(store.base))
        build_s = time.perf_counter() - t0
        at_rest = sum(HEADER_NBYTES + bitmap_nbytes(n_params)
                      + 4 * store.nnz(u) for u in store.users())
        if at_rest != store.total_bytes_at_rest():
            raise AssertionError(f"{cfg.name}: bytes_at_rest "
                                 f"{store.total_bytes_at_rest()} != {at_rest}")
        engine = ServeEngine(store, model, backend="vmap", max_batch=2)
        box = {}
        with (graph.disabled() if mode == "eager"
              else contextlib.nullcontext()):
            _zero(counters)
            warm_s = engine.warmup()
            graphs = model.graphs()
            warm_caps = [g.captures for g in graphs]
            res = engine.serve(reqs, warmup=False)
            launches = _launches(counters)
            stats = store.stats()
            if any(launches.values()):
                raise AssertionError(f"{cfg.name}: a kernel launched: "
                                     f"{launches}")
            if [g.captures for g in graphs] != warm_caps or warm_caps != (
                    [1] if mode == "graphed" else [0]):
                raise AssertionError(
                    f"{cfg.name} {mode}: captures {warm_caps} in warmup, "
                    f"{[g.captures for g in graphs]} after serving")
            # a second store of the same shapes (the same base and
            # frames, a pool of its own) on the same model, served after
            # the first and before it again: A, B, A
            two, eng_b, other, res_b, res_a2 = None, None, None, None, None
            if cfg.name in TWO_STORE_ARCHS:
                other = ModelStore(store.base, cache_size=2)
                other._frames = dict(store._frames)
                other._nnz = dict(store._nnz)
                eng_b = ServeEngine(other, model, backend="vmap",
                                    max_batch=2)
                eng_b.warmup()
                res_b = eng_b.serve(reqs, warmup=False)
                res_a2 = engine.serve(reqs, warmup=False)
                two = dict(caps=[g.captures for g in graphs],
                           pool_bytes=[g.pool_bytes() for g in graphs]
                           if mode == "graphed" else [],
                           outs=(res_b.outputs, res_a2.outputs),
                           stats=(other.stats(), store.stats()))
                if mode == "graphed" and two["caps"] != [2]:
                    raise AssertionError(f"{cfg.name}: captures "
                                         f"{two['caps']} for two stores")
                if any(not np.array_equal(y.view(np.int32),
                                          res.outputs[rid].view(np.int32))
                       for rid, y in res_b.outputs.items()):
                    raise AssertionError(f"{cfg.name} {mode}: store B (the "
                                         "same frames) serves other bits "
                                         "than A")
            if mode == "graphed":
                alone = ServeEngine(store, model, backend="vmap",
                                    max_batch=2)
                for r in reqs:
                    y = res.outputs[r.rid]
                    if y.shape != (1, cfg.vocab) or not bool(
                            torch.isfinite(torch.from_numpy(y)).all()):
                        raise AssertionError(f"{cfg.name}: request {r.rid} "
                                             f"output {y.shape} not finite")
                    if not (alone.serve([r], warmup=False).outputs[r.rid]
                            == y).all():
                        raise AssertionError(
                            f"{cfg.name}: request {r.rid} served in a mixed "
                            "batch differs from it alone")
                del alone
            xs = torch.from_numpy(np.stack([model.make_input(i)
                                            for i in range(2)])).cuda()
            ms = cuda_ms(lambda: model.batched_forward(
                store.pool_params, store.pool_masks, xs), iters=3, warmup=1)
            prof = _profiled(torch, lambda: box.setdefault(
                "res", engine.serve(reqs, warmup=False)))
        peak = torch.cuda.max_memory_allocated()
        miss = store.series.histogram("miss_decode_s")
        runs[mode] = dict(
            res=res, stats=stats, ms=ms, prof=prof,
            psvc=box["res"].summary["service_s"], peak=peak, held=held,
            warm_s=warm_s, build_s=build_s, miss=(miss.count, miss.mean),
            caps=[(g.captures, g.replays) for g in graphs],
            capture_s=sum(g.capture_s for g in graphs),
            at_rest=store.total_bytes_at_rest(), n_params=n_params,
            two=two, hold=_graph_hold(torch, graphs))
        users = (store.base, store._frames, store._nnz)
        del engine, store, model, xs, res, box, graphs, eng_b, other, res_b
        del res_a2
        gc.collect()
        torch.cuda.empty_cache()
    g, e = runs["graphed"], runs["eager"]
    for rid, y in g["res"].outputs.items():
        if not np.array_equal(y.view(np.int32),
                              e["res"].outputs[rid].view(np.int32)):
            raise AssertionError(f"{cfg.name}: request {rid} graphed differs "
                                 "from eager")
    if g["stats"] != e["stats"]:
        raise AssertionError(f"{cfg.name}: cache counters graphed "
                             f"{g['stats']} against eager {e['stats']}")
    for outs_g, outs_e in zip(*(r["two"]["outs"] if r["two"] else ()
                                for r in (g, e))):
        for rid, y in outs_g.items():
            if not np.array_equal(y.view(np.int32),
                                  outs_e[rid].view(np.int32)):
                raise AssertionError(f"{cfg.name}: stores B, A graphed "
                                     f"differ from eager at request {rid}")
    if g["two"] and g["two"]["stats"] != e["two"]["stats"]:
        raise AssertionError(f"{cfg.name}: two stores' counters graphed "
                             f"{g['two']['stats']} against eager "
                             f"{e['two']['stats']}")
    s = g["res"].summary
    log(f"full width {cfg.name}: {g['n_params']} parameters, store built in "
        f"{g['build_s']:.2f} s (from its frames {e['build_s']:.2f} s), "
        f"bytes_at_rest {g['at_rest']}; graphed: "
        f"outputs and cache counters bit-equal to eager; service_s "
        f"{s['service_s']} (eager {e['res'].summary['service_s']}), p50 "
        f"{s['p50_ms']} ms (eager {e['res'].summary['p50_ms']}), p99 "
        f"{s['p99_ms']} ms (eager {e['res'].summary['p99_ms']}), "
        f"{s['requests']} requests in {s['batches']} batches, hit rate "
        f"{s['cache_hit_rate']} ({g['miss'][0]} misses, decode and slot "
        f"write {g['miss'][1]:.3f} s each; eager {e['miss'][1]:.3f} s); "
        f"{len(reqs)} bit-equal alone; warmup {g['warm_s']:.3f} s (eager "
        f"{e['warm_s']:.3f}), captures and replays of the forward "
        f"{g['caps']}, capture {g['capture_s']:.3f} s")
    for mode, r in runs.items():
        log(f"  {mode}: pool-wide prefill of 2 x {FULL_WIDTH_PROMPT} tokens "
            f"{r['ms']:.3f} ms: {r['ms'] / 2:.3f} ms per request, "
            f"{2 * FULL_WIDTH_PROMPT / (r['ms'] / 1e3):.1f} prompt tokens/s; "
            f"peak memory {r['peak']} bytes ({r['peak'] / 2 ** 30:.2f} GiB; "
            f"{(r['peak'] - r['held']) / 2 ** 30:.2f} GiB above the "
            f"{r['held']} bytes held before the model); profiled serving "
            f"run: service_s {r['psvc']} (profiler on), device busy "
            f"{_share(r['prof'][1], r['psvc'])} of it, {r['prof'][2]} host "
            f"launches")
    if g["two"]:
        (per_store,) = g["two"]["pool_bytes"]
        log(f"  two stores on one model (A, B, A; B holds A's frames over "
            f"the same base): bit-equal to eager A, B, A, B to A's first "
            f"pass; captures {g['two']['caps']}, graph-pool bytes each "
            f"capture reserved: store A {per_store[0]} "
            f"({per_store[0] / 2 ** 30:.3f} GiB), store B {per_store[1]} "
            f"({per_store[1] / 2 ** 30:.3f} GiB; the captures share one "
            f"pool)")
    log(f"  graphed: the forward's captures held {_hold_figs(g['hold'])}")
    return launches


def _graph_hold(torch, graphs):
    """Release ``graphs`` and return the device memory they held: bytes
    reserved (the capture's memory pool: its activations and outputs)
    and allocated, each before less after, with the cache emptied before
    both reads, so no other free block counts."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    for g in graphs:
        g.release()
    after = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    return before[0] - after[0], before[1] - after[1]


def _hold_figs(hold):
    return (f"{hold[0]} bytes reserved ({hold[0] / 2 ** 30:.3f} GiB), "
            f"{hold[1]} allocated ({hold[1] / 2 ** 30:.3f} GiB) until "
            "release()")


def serve_models_path(torch, counters):
    """Phase 13: smallcnn and the ten smoke archs through the serving CLI,
    then two archs at full published width.  Returns every kernel's
    launches summed over the phase's counted runs (all must be 0)."""
    from repro_torch.configs import ARCHS, SMOKE_ARCHS

    runs = [serve_smoke_model(torch, counters, name)
            for name in ["smallcnn"] + sorted(SMOKE_ARCHS)]
    runs += [serve_full_width(torch, counters, ARCHS[name])
             for name in FULL_WIDTH_ARCHS]
    return _sum_launches(runs)


def profile_round(torch, train, args):
    """One more main-path round (same configuration, warm process) under
    torch.profiler: the device's busy share of the round's wall time and
    the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    engine = train.build_engine(args)
    # a fresh engine captures its graphs in its first round: profile the
    # second, which replays them
    warm = 1
    engine.cfg.rounds = warm + 1
    rounds = engine.rounds()
    for _ in range(warm):
        next(rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        next(rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    if rows is None:
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    what = (f"scale {args.scale_reduction} round" if args.scale
            else f"{args.strategy} round ({engine.local_exec})")
    log(f"profiled {what}: wall {wall:.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / wall:.1f}%), phases {engine.phase_s[-1]}")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3:.3f} ms in {count} launches: {key[:90]}")


def cross_check(torch, train, engine_args):
    """One smallcnn round from one state on cuda (kernels) and on cpu
    (plain versions), on the engine and strategy ``engine_args`` select
    (the data gives every client one batch size, as ScaleEngine needs):
    the mix is exact on both; convolutions differ by fp32 rounding, so
    masks must agree on all but a 1e-3 share of coordinates and every other
    state leaf to 1e-3 where the masks agree; the comm and FLOP rows, which
    no device may change, must be equal."""
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map
    argv = ["simulate", "--rounds", "1", "--clients", "4", "--hw", "8",
            "--width", "4", "--samples-per-class", "12", "--degree", "2",
            "--partition", "pathological", "--batch-size", "8",
            *engine_args]
    gpu = train.build_engine(train.build_parser().parse_args(argv))
    cpu = train.build_engine(train.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    cpu.state = tree_map(lambda x: x.detach().cpu().clone(), gpu.state)
    gpu.run(), cpu.run()
    n = mismatched = 0
    max_err = 0.0
    leaves = zip(tree_leaves_with_path(gpu.state),
                 tree_leaves_with_path(cpu.state), strict=True)
    for (path, a), (_, b) in leaves:
        a = a.cpu()
        if path.startswith("masks"):
            n += a.numel()
            mismatched += int((a != b).sum())
        else:
            same = (a != 0) == (b != 0)
            max_err = max(max_err, float((a - b)[same].abs().max()))
    share = mismatched / n if n else 0.0
    if share > 1e-3 or max_err > 1e-3:
        raise AssertionError(f"cuda and cpu rounds disagree: mask share "
                             f"{share}, param err {max_err}")
    if gpu._comm != cpu._comm or gpu._flops != cpu._flops:
        raise AssertionError(f"comm or FLOP rows differ: {gpu._comm} "
                             f"{gpu._flops} vs {cpu._comm} {cpu._flops}")
    return {"mask_mismatch_share": share, "param_max_abs_err": max_err,
            "acc_cuda": gpu._acc_history, "acc_cpu": cpu._acc_history}


def lm_smoke_run(torch, counters, name):
    """Phase 14 (a) for one arch: ``train lm`` through its entry functions
    on the card (``lm_loop`` from ``init_lm_clients``' state, drawn on the
    card), then the same loop on the CPU from a copy of that state.
    Returns the card run's launches."""
    import contextlib
    import io

    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    args = train.parse_args(LM_ARGS + ["--arch", name])
    cfg = train.lm_config(args)
    dev = torch.device(args.device)
    params, masks = train.init_lm_clients(args, cfg, dev)
    to_cpu = lambda t: t.to("cpu", copy=True)  # noqa: E731
    cpu_state = ([tree_map(to_cpu, p) for p in params],
                 [tree_map(to_cpu, m) for m in masks])
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out, state = train.lm_loop(args, cfg, params, masks, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(counters)
    if any(launches.values()):
        raise AssertionError(f"lm {name}: a kernel launched: {launches}")
    hist = out["loss_history"]
    if len(hist) != 2 or not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"lm {name}: loss history {hist}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_out, cpu = train.lm_loop(args, cfg, *cpu_state,
                                     torch.device("cpu"))
    cpu_wall = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(hist, cpu_out["loss_history"]))
    if rel > LM_CPU_RTOL:
        raise AssertionError(f"lm {name}: card {hist} vs cpu "
                             f"{cpu_out['loss_history']}: {rel} relative")
    n = differ = 0
    for (path, a), (_, b) in zip(tree_leaves_with_path(state["masks"]),
                                 tree_leaves_with_path(cpu["masks"]),
                                 strict=True):
        a = a.cpu()
        held = (a != 0).reshape(a.shape[0], -1).sum(1)
        if not torch.equal(held, (b != 0).reshape(b.shape[0], -1).sum(1)):
            raise AssertionError(f"lm {name}: {path} holds {held.tolist()} "
                                 "on the card, otherwise on the CPU")
        n += a.numel()
        differ += int((a != b).sum())
    log(f"lm --arch {name}: loss {hist} (cpu {cpu_out['loss_history']}, "
        f"max rel diff {rel:.3e}), improved {out['improved']}; mask "
        f"coordinates differing from the cpu run {differ} of {n} "
        f"({differ / n:.3e}), held counts equal; wall {wall:.2f} s (cpu "
        f"{cpu_wall:.2f} s)")
    return launches


def _lm_full_state(torch, api, plan, gen):
    """K clients' params of ``plan.dtype`` drawn on the card, stacked, and
    int8 masks: each coordinate of a sparsifiable leaf held with
    probability 0.5 (the reference's step tests), the other leaves dense;
    params masked."""
    from repro_torch.scale.stacked import default_threshold_sparsifiable
    from repro_torch.utils.tree import tree_map

    clients = [api.init(gen, plan.dtype) for _ in range(plan.n_clients)]
    params = tree_map(lambda *xs: torch.stack(xs), *clients)
    del clients

    def mask(w):
        if not default_threshold_sparsifiable(w):
            return torch.ones(w.shape, dtype=torch.int8, device=w.device)
        m = (torch.rand(w.shape, generator=gen, device=w.device) < 0.5)
        w.mul_(m)
        return m.to(torch.int8)

    return params, tree_map(mask, params)


def _events_ms(pairs):
    return sum(a.elapsed_time(b) for a, b in pairs)


def _bits(torch, t):
    """``t``'s bit patterns as integers of its width (so -0.0 != +0.0)."""
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.int8}[t.element_size()])


def lm_full_width(torch, counters, pr, dtype=None):
    """Phase 14 (b), and at ``dtype=torch.bfloat16`` phase 16 (a): the
    step builders at gemma3-1b's published width, K=2 clients of one
    1024-token row, params, caches and activations of ``dtype`` (fp32 by
    default), int8 masks.  Returns the launches of the counted run (train
    step, mask update, prefill, 16 decode steps) and the stage figures."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.scale.stacked as stacked
    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.models import lm as lm_mod
    from repro_torch.utils.tree import tree_leaves, tree_map

    dtype = dtype or torch.float32
    dname = str(dtype).replace("torch.", "")
    cfg = ARCHS[LM_FULL_ARCH]
    k, s, n_dec = LM_FULL_CLIENTS, LM_FULL_SEQ, LM_FULL_DECODE
    api = bind(cfg, remat=False)
    plan = steps.ScalePlan(cfg, InputShape("lm_full", s, k, "train"), k, 1,
                           dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()       # by earlier phases
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params, masks = _lm_full_state(torch, api, plan, gen)
    n_params = sum(x[0].numel() for x in tree_leaves(params))
    toks = torch.randint(0, cfg.vocab, (k, 1, s + n_dec + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[..., :s].contiguous(),
             "labels": toks[..., 1:s + 1].contiguous()}
    adj = torch.ones((k, k), device="cuda")
    sparse = sum(1 for x in tree_leaves(params)
                 if stacked.default_threshold_sparsifiable(x))
    torch.cuda.synchronize()
    log(f"lm full width {cfg.name} {dname}: {n_params} parameters a client, "
        f"K={k}, {sparse} sparsifiable leaves, state built in "
        f"{time.perf_counter() - t0:.2f} s")
    train_step = steps.make_train_step(api, plan, "einsum")
    mask_update = steps.make_mask_update_step(api, plan, density=0.5)
    prefill = steps.make_prefill_step(api, plan)
    decode = steps.make_decode_step(api, plan)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    # the counted run: train step, mask update, prefill, decode; the peak
    # memory of each stage
    peaks = {}

    def stage_peak(name):
        """The stage's peak, and what it leaves allocated after it."""
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated(),
                       torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    stage_peak("state")
    _zero(counters)
    a, b = ev(), ev()
    a.record()
    params, losses = train_step(params, masks, batch, adj, 0.01)
    b.record()
    torch.cuda.synchronize()
    train_ms_cold = a.elapsed_time(b)
    stage_peak("train step")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"lm full width: losses {losses.tolist()}")
    for w, m in zip(tree_leaves(params), tree_leaves(masks)):
        if bool(((w != 0) & (m == 0)).any()):
            raise AssertionError("lm full width: a parameter is non-zero "
                                 "outside its mask after the train step")

    checks = []
    orig = stacked.prune_regrow_rows

    def checked(w, g, m, th):
        new_m, new_w = orig(w, g, m, th)
        torch.cuda.synchronize()
        want_m, want_w = pr.prune_regrow_rows_plain(w, g, m, th)
        n_active = max(1, int(round(0.5 * w.shape[1])))
        checks.append((tuple(w.shape), torch.equal(new_m, want_m)
                       and torch.equal(_bits(torch, new_w),
                                       _bits(torch, want_w)),
                       int((new_m.sum(1) - n_active).abs().max()),
                       (w.dtype, m.dtype)))
        del want_m, want_w
        return new_m, new_w

    stacked.prune_regrow_rows = checked
    try:
        params, masks = mask_update(params, masks, batch, 0.25)
    finally:
        stacked.prune_regrow_rows = orig
    bad = [c for c in checks if not c[1]]
    pairs = {c[3] for c in checks}
    if bad or len(checks) != sparse or pairs != {(dtype, torch.int8)}:
        raise AssertionError(f"lm full width: prune_regrow {len(checks)} "
                             f"launches for {sparse} sparsifiable leaves, "
                             f"dtype pairs {pairs}; not bit-equal to plain: "
                             f"{bad}")
    excess = max(c[2] for c in checks)
    stage_peak("mask update (with the plain checks)")

    fresh_cache = lambda: tree_map(  # noqa: E731
        lambda t: torch.stack([t] * k),
        api.init_cache(1, s + n_dec, dtype, device="cuda"))
    cache = fresh_cache()
    a, b = ev(), ev()
    a.record()
    logits, cache = prefill(params, {"tokens": batch["tokens"]}, cache)
    b.record()
    tok = torch.argmax(logits[:, :, -1], -1)[..., None].to(torch.int32)
    gen_toks, times = [tok], []
    for i in range(n_dec):
        a2, b2 = ev(), ev()
        pos = torch.full((k,), s + i, dtype=torch.int32, device="cuda")
        a2.record()
        nxt, cache = decode(params, {"tokens": tok, "pos": pos}, cache)
        b2.record()
        tok = nxt[..., None]
        times.append((a2, b2))
        gen_toks.append(tok)
    torch.cuda.synchronize()
    prefill_ms = a.elapsed_time(b)
    decode_ms = _events_ms(times) / n_dec
    stage_peak("prefill and decode")
    launches = _launches(counters)
    if launches["prune_regrow"] != sparse or any(
            v for key, v in _totals(launches).items() if key != "prune_regrow"):
        raise AssertionError(f"lm full width launches {launches}, "
                             f"{sparse} sparsifiable leaves")

    # the decode's logits (what make_decode_step takes the argmax of), from
    # the same prefill: the same tokens, and each position's logits against
    # a teacher-forcing forward over the prompt and the generated tokens
    del cache
    logits, cache = prefill(params, {"tokens": batch["tokens"]},
                            fresh_cache())
    dec_logits = [logits[:, :, -1]]
    for i in range(n_dec):
        pos = torch.full((k,), s + i, dtype=torch.int32, device="cuda")
        logits, cache = torch.func.vmap(api.decode)(params, gen_toks[i], pos,
                                                    cache)
        if not torch.equal(torch.argmax(logits[..., -1, :], -1).to(
                torch.int32)[..., None], gen_toks[i + 1]):
            raise AssertionError(f"lm full width: decode token {i} differs "
                                 "from make_decode_step's")
        dec_logits.append(logits[:, :, -1])
    del cache, logits
    # teacher forcing: prompt + the generated tokens in one forward
    seq = torch.cat([batch["tokens"], torch.cat(gen_toks[:-1], -1)], -1)
    with torch.no_grad():
        full = torch.func.vmap(
            lambda p, t: lm_mod.forward_train(p, t, cfg, remat=False)[0])(
                params, seq)
    want = full[:, :, s - 1:]
    got = torch.stack(dec_logits, 2)
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    del full, want, got
    tol = LM_DECODE_TOL if dtype == torch.float32 else LM_DECODE_TOL_BF16
    if err > tol * scale:
        raise AssertionError(f"lm full width {dname}: decoded logits differ "
                             f"from teacher forcing by {err} (scale {scale}, "
                             f"tolerance {tol} of it)")
    stage_peak("teacher forcing")

    # measurements (not counted): a warm train step, a timed mask update
    # with its sorts, a profiled train step
    a, b = ev(), ev()
    a.record()
    params, losses = train_step(params, masks, batch, adj, 0.01)
    b.record()
    torch.cuda.synchronize()
    train_ms = a.elapsed_time(b)
    stage_peak("warm train step")
    sorts = []
    orig_sort = stacked.sort_thresholds

    def timed_sort(*args):
        a3, b3 = ev(), ev()
        a3.record()
        out = orig_sort(*args)
        b3.record()
        sorts.append((a3, b3))
        return out

    stacked.sort_thresholds = timed_sort
    try:
        a, b = ev(), ev()
        a.record()
        params, masks = mask_update(params, masks, batch, 0.25)
        b.record()
        torch.cuda.synchronize()
    finally:
        stacked.sort_thresholds = orig_sort
    update_ms, sort_ms = a.elapsed_time(b), _events_ms(sorts)
    stage_peak("timed mask update")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new_params, losses = train_step(params, masks, batch, adj, 0.01)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del new_params
    stage_peak("profiled train step")
    peak = max(v[0] for v in peaks.values())
    # one decode step under the profiler
    cache = fresh_cache()
    _, cache = prefill(params, {"tokens": batch["tokens"]}, cache)
    pos = torch.full((k,), s, dtype=torch.int32, device="cuda")
    decode(params, {"tokens": gen_toks[0], "pos": pos}, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as dprof:
        t0 = time.perf_counter()
        decode(params, {"tokens": gen_toks[0], "pos": pos}, cache)
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
    del cache
    tokens = k * s
    log(f"lm full width {cfg.name} {dname}: train step {train_ms:.3f} ms warm "
        f"({train_ms_cold:.3f} ms first), {tokens / (train_ms / 1e3):.1f} "
        f"tokens/s, losses {losses.tolist()}; mask update {update_ms:.3f} "
        f"ms, of which the torch.sort thresholds {sort_ms:.3f} ms "
        f"({100 * sort_ms / update_ms:.1f}%); {len(checks)} prune_regrow "
        f"launches bit-equal to plain, largest |held - n_active| of a row "
        f"{excess}; prefill of {k} x {s} tokens {prefill_ms:.3f} ms, decode "
        f"{decode_ms:.3f} ms per token (K={k} rows), {n_dec} decoded "
        f"positions within {err:.3e} of teacher forcing (scale {scale:.2f}); "
        f"peak memory {peak} bytes ({peak / 2 ** 30:.2f} GiB; "
        f"{(peak - held) / 2 ** 30:.2f} GiB above the {held} bytes held "
        f"before); by stage, peak (held after): " + ", ".join(
            f"{name} {v[0] / 2 ** 30:.2f} ({v[1] / 2 ** 30:.2f}) GiB"
            for name, v in peaks.items()))
    busy = {}
    for what, p, w in (("train step", prof, wall),
                       ("decode step", dprof, dwall)):
        rows = device_rows(p)
        if rows is None:
            continue
        busy_s = sum(r[0] for r in rows) / 1e6
        busy[what] = busy_s / w
        log(f"  profiled {what}: wall {w:.4f} s (profiler on), device busy "
            f"{busy_s:.4f} s ({100 * busy_s / w:.1f}%), "
            f"{sum(r[1] for r in rows)} device events")
        for us, count, key in sorted(rows, reverse=True)[:3]:
            log(f"  {us / 1e3:.3f} ms in {count} launches: {key[:90]}")
    del params, masks, batch, prof, dprof, losses
    gc.collect()
    torch.cuda.empty_cache()
    figures = {"train step ms": train_ms, "tokens/s": tokens / (train_ms / 1e3),
               "train busy": busy.get("train step"),
               "mask update ms": update_ms, "sorts' share": sort_ms / update_ms,
               "prefill ms": prefill_ms, "decode ms/token": decode_ms,
               "decode busy": busy.get("decode step"),
               "decode err/scale": err / scale,
               "peak GiB": peak / 2 ** 30}
    figures.update({f"peak {name} GiB": v[0] / 2 ** 30
                    for name, v in peaks.items()})
    figures["train step peak above held GiB"] = (
        peaks["train step"][0] - held) / 2 ** 30
    return launches, figures


def lm_remat(torch, counters):
    """Phase 14 (c): gemma3-1b at phase 14's plan, fp32, its models bound
    under each of ``REMAT_POLICIES`` ("none": ``remat=False``) from one
    state: a warm train step (its peak above what was held before it),
    ``REMAT_TIMED_STEPS`` timed ones (CUDA events) on the same inputs and
    a mask update; params, losses and masks bit-equal to "none"'s, or the
    phase fails.  Then the "full" train step through ``utils.graph.
    graphed`` (a capture, ``REMAT_TIMED_STEPS`` replays from the same
    state) bit-equal to eager.  Returns the launches of the mask updates
    (one prune/regrow launch per sparsifiable leaf each) and the
    figures."""
    import gc

    import numpy as np

    import repro_torch.scale.stacked as stacked
    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import bind
    from repro_torch.utils import graph
    from repro_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = ARCHS[LM_FULL_ARCH]
    k, s = LM_FULL_CLIENTS, LM_FULL_SEQ
    plan = steps.ScalePlan(cfg, InputShape("lm_full", s, k, "train"), k, 1,
                           torch.float32)
    apis = {p: bind(cfg, **dryrun.remat_options(p)) for p in REMAT_POLICIES}
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(14)
    params, masks = _lm_full_state(torch, apis["none"], plan, gen)
    sparse = sum(1 for x in tree_leaves(params)
                 if stacked.default_threshold_sparsifiable(x))
    toks = torch.randint(0, cfg.vocab, (k, 1, s + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[..., :s].contiguous(),
             "labels": toks[..., 1:].contiguous()}
    adj = torch.ones((k, k), device="cuda")
    lr = torch.tensor(0.01, dtype=torch.float32, device="cuda")
    rate = torch.tensor(0.25, dtype=torch.float32, device="cuda")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    figs, launches, ref = {}, [], {}

    def same(what, policy, got, want):
        if not _trees_bit_equal(torch, got, want):
            raise AssertionError(f"remat {policy}: {what} not bit-equal to "
                                 f"remat=False's")

    # the train step: its first call's peak, then the timed calls
    for policy in REMAT_POLICIES:
        step = steps.make_train_step(apis[policy], plan, "einsum")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        new_params, losses = step(params, masks, batch, adj, lr)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        ms = []
        for _ in range(REMAT_TIMED_STEPS):
            a, b = ev(), ev()
            a.record()
            out = step(params, masks, batch, adj, lr)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            del out
        if policy == "none":
            ref["losses"] = losses.cpu()
            ref["params"] = _to(torch, new_params, "cpu")
        else:
            same("train-step losses", policy, losses, ref["losses"])
            same("train-step params", policy, new_params, ref["params"])
        del new_params
        figs[f"{policy} train step ms"] = float(np.median(ms))
        figs[f"{policy} train step peak above held GiB"] = peak
        log(f"lm remat {policy} {cfg.name} fp32 K={k} x {s}: train step "
            f"{np.median(ms):.3f} ms (median of {REMAT_TIMED_STEPS} warm "
            f"calls: "
            + ", ".join(f"{m:.3f}" for m in ms) + f"), peak {peak:.3f} GiB "
            f"above the {held / 2 ** 30:.3f} GiB held, losses "
            f"{losses.tolist()}" + ("" if policy == "none" else
                                   ", params and losses bit-equal to none"))

    # the "full" train step graphed: a capture and its replays, each from
    # the same state into the donated params
    builder = steps.make_train_step(apis["full"], plan, "einsum")
    g = graph.graphed(builder, donate=(0, 1))
    into = _to(torch, params, "cuda")
    for i in range(REMAT_TIMED_STEPS):
        out, g_losses = g(into if i == 0 else params, masks, batch, adj, lr)
        same(f"graphed train step {i} losses", "full", g_losses,
             ref["losses"])
        same(f"graphed train step {i} params", "full", out, ref["params"])
    if g.captures != 1 or g.replays != REMAT_TIMED_STEPS:
        raise AssertionError(f"remat full graphed: {g.captures} captures, "
                             f"{g.replays} replays")
    figs["full graphed capture s"] = g.capture_s
    del out, into
    _release(g)
    del ref["params"]
    log(f"lm remat full graphed: 1 capture ({figs['full graphed capture s']:.2f}"
        f" s), {REMAT_TIMED_STEPS} replays bit-equal to eager")

    # the mask update, counted
    for policy in REMAT_POLICIES:
        update = steps.make_mask_update_step(apis[policy], plan, density=0.5)
        gc.collect()
        torch.cuda.empty_cache()
        _zero(counters)
        a, b = ev(), ev()
        a.record()
        new_params, new_masks = update(params, masks, batch, rate)
        b.record()
        torch.cuda.synchronize()
        la = _launches(counters)
        launches.append(la)
        if la["prune_regrow_rows_f32_i8"] != sparse or any(
                v for key, v in _totals(la).items() if key != "prune_regrow"):
            raise AssertionError(f"remat {policy} mask update launches {la}, "
                                 f"{sparse} sparsifiable leaves")
        if policy == "none":
            ref["update"] = _to(torch, (new_params, new_masks), "cpu")
        else:
            same("mask update", policy, (new_params, new_masks),
                 ref["update"])
        del new_params, new_masks
        figs[f"{policy} mask update ms"] = a.elapsed_time(b)
        log(f"lm remat {policy}: mask update {a.elapsed_time(b):.3f} ms, "
            f"{la['prune_regrow_rows_f32_i8']} prune_regrow launches"
            + ("" if policy == "none" else
               ", params and masks bit-equal to none"))
    del params, masks, batch, ref
    gc.collect()
    torch.cuda.empty_cache()
    none_ms = figs["none train step ms"]
    none_peak = figs["none train step peak above held GiB"]
    for policy in REMAT_POLICIES[1:]:
        log(f"lm remat {policy} against none: train step "
            f"{figs[f'{policy} train step ms'] / none_ms:.4f}x, peak "
            f"{figs[f'{policy} train step peak above held GiB'] / none_peak:.4f}x")
    if not figs["full train step peak above held GiB"] < none_peak:
        raise AssertionError(f"remat full: train-step peak not below none's: "
                             f"{figs}")
    log(f"lm remat phase (14 (c)): {time.perf_counter() - t0:.1f} s")
    return _sum_launches(launches), figs


def lm_path(torch, counters):
    """Phase 14: ``train lm`` on every decoder smoke arch, then the step
    builders at full width.  Returns every kernel's launches summed over
    the counted runs, and the full-width run's figures."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.kernels import prune_regrow as pr

    runs = [lm_smoke_run(torch, counters, name)
            for name in sorted(SMOKE_ARCHS)
            if SMOKE_ARCHS[name].enc_layers == 0]
    full, figures = lm_full_width(torch, counters, pr)
    runs.append(full)
    return _sum_launches(runs), figures


def _compare_lm(fp32, bf16):
    """Phase 16 (a)'s figures beside phase 14's, one line a figure."""
    for key, v in fp32.items():
        w = bf16.get(key)
        if v is None or w is None:
            log(f"  {key}: fp32 {v}, bf16 {w}")
            continue
        log(f"  {key}: fp32 {v:.6g}, bf16 {w:.6g} (bf16/fp32 {w / v:.4f})"
            if v else f"  {key}: fp32 {v}, bf16 {w}")


def precision_kernels(torch, n_leaf):
    """Phase 16 (b), run right after phase 15 (while the profiler still
    records every launch): the prune/regrow kernel's other dtype pairs at
    K=4 rows of the largest ResNet18-GN leaf, bit-equal to plain and timed;
    the fp16 row fold and flat fold timed (the bf16 masked matmul's rows
    come from ``bf16_matmul_checks`` in phase 3).  Returns the rows."""
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.kernels import prune_regrow as pr
    from repro_torch.sparse.packed import pack_bits

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {"pr": {pair: check_prune_regrow(torch, pr, dev, 4, n_leaf, gen,
                                           pair)
                  for pair in pr.PAIRS if pair != (torch.float32,) * 2}}
    for pair, r in out["pr"].items():
        r["host_us"] = prune_regrow_host(torch, pr, dev, 4, 4096, gen,
                                         pair)["host_us"]
        log(f"prune_regrow K={r['K']} N={r['N']} {r['dtype']}: " + _times(r)
            + f", torch.sort of the two thresholds {r['sort_ms']} ms (host "
            f"per call at K=4 N=4096)")

    out["rows_f16"] = check_fold_rows(torch, pa, dev, 4, n_leaf, 1.0, gen,
                                      torch.float16)
    r = out["rows_f16"]
    log(f"packed_accum_rows K={r['K']} N={r['N']} nnz={r['nnz']} float16: "
        + _times(r))
    out["fold_f16"] = check_fold(torch, pa, pack_bits, dev, n_leaf, 1.0, gen,
                                 torch.float16)
    r = out["fold_f16"]
    log(f"packed_accum N={r['N']} nnz={r['nnz']} float16: " + _times(r))
    return out


def bf16_matmul_checks(torch, mmk, dev):
    """Phase 3 for the masked matmul's bf16 entries (phase 16's kernels,
    timed here: after phase 15 the profiler has dropped launches of their
    cold-L2 runs): first the U=1 form at (128, 256, 128), timed against ``torch.mm``; the
    reference's sweep with fp32 and bf16 masks, each within one bf16 ulp
    of plain and bit-equal over two launches; the batched form at the
    serving MLP's middle layer timed against ``torch.bmm`` on pre-masked
    bf16 weights, with either mask; a mixed batch bit-equal to alone at the
    serving rows and at 20 rows, with either mask.  Returns the rows."""
    gen = torch.Generator(device=dev).manual_seed(16)
    bf16 = torch.bfloat16
    x, w, mask = mm_inputs(torch, dev, 1, 128, 256, 128, 0.2, gen)
    out = {"mm_u1": check_masked_matmul_bf16(torch, mmk, x.to(bf16),
                                             w.to(bf16), mask, timed=True)}
    sweep = []
    for m, k, n in ((64, 128, 128), (128, 256, 128), (70, 200, 90),
                    (13, 50, 17)):
        for density in (0.0, 0.2, 1.0):
            x, w, mask = mm_inputs(torch, dev, 1, m, k, n, density, gen)
            for mdt in (torch.float32, bf16):
                sweep.append(check_masked_matmul_bf16(
                    torch, mmk, x.to(bf16), w.to(bf16), mask.to(mdt)))
    u, rows = _serve_arg("--cache-size"), _serve_arg("--rows")
    x, w, mask = mm_inputs(torch, dev, u, rows, 128, 128, 0.5, gen)
    xb, wb = x.to(bf16), w.to(bf16)
    out["mm"] = check_masked_matmul_bf16(torch, mmk, xb, wb, mask, timed=True)
    out["mm_mbf16"] = check_masked_matmul_bf16(torch, mmk, xb, wb,
                                               mask.to(bf16), timed=True)
    n_alone = 0
    for mdt in (torch.float32, bf16):
        n_alone += check_mixed_vs_alone(torch, mmk, xb, wb, mask.to(mdt),
                                        (0, u - 1))
        x, w, m_ = mm_inputs(torch, dev, 8, 20, 300, 64, 0.5, gen)
        n_alone += check_mixed_vs_alone(torch, mmk, x.to(bf16), w.to(bf16),
                                        m_.to(mdt), (0, 7))
    out["mm_err"] = max(r["max_abs_err"] for r in sweep + [
        out["mm_u1"], out["mm"], out["mm_mbf16"]])
    log(f"bf16 masked_matmul: {len(sweep)} sweep cases (fp32 "
        f"and bf16 masks) within one bf16 ulp of plain (max abs err "
        f"{max(r['max_abs_err'] for r in sweep)}), each over two launches "
        f"bit-equal; {n_alone} users alone bit-equal to the mixed batch")
    for r in (out["mm_u1"], out["mm"], out["mm_mbf16"]):
        log(f"masked_matmul bf16 U={r['U']} M={r['M']} K={r['K']} N={r['N']} "
            f"{r['dtype']} occupancy {r['occupancy']:.4f}: " + _times(r)
            + _library(r, "torch.bmm"))
    return out


def precision_path(torch, counters, lm_fp32):
    """Phase 16 (a), (c) and (d), after phase 14: full-width gemma3-1b at
    bf16 beside phase 14's fp32 figures; fp16 stacked payloads of
    ResNet18-GN through the row fold; the serving MLP from an fp16 store.
    Returns each part's launches and figures, and the launches summed
    over the phase's counted runs."""
    from repro_torch.kernels import prune_regrow as pr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {}

    # (a) gemma3-1b at bf16, every stage beside the fp32 run's
    t0 = time.perf_counter()
    out["lm_launches"], figures = lm_full_width(torch, counters, pr,
                                                torch.bfloat16)
    log(f"precision (a) gemma3-1b bf16 beside fp32 (phase 14), "
        f"{time.perf_counter() - t0:.1f} s:")
    _compare_lm(lm_fp32, figures)
    out["lm_bf16"] = figures

    # (c) fp16 stacked payloads of ResNet18-GN, K=4, through the row fold
    out.update(precision_fold(torch, counters, dev, gen))

    # (d) the serving MLP from an fp16 store, beside the same fp32 store
    out.update(precision_store(torch, counters, SERVE_ARGS))
    out["launches"] = _sum_launches([out["lm_launches"], out["fold_launches"],
                                     *out["store_launches"].values()])
    return out


class DryrunSweep:
    """Phase 17's sweep, ``repro_torch.launch.dryrun``'s ``main`` for each
    arch at ``DRYRUN_SWEEP_SHAPE``, then phase 21 (c)'s multi-pod records
    (``STEPS_DRYRUN``, fake tensors on the CPU of a fake world), dealt in
    turn to ``DRYRUN_SWEEP_PROCS`` processes of their own started at
    construction (each one's single-card runs before its multi-pod ones;
    their output in a temporary directory); ``wait`` ends them,
    ``report`` checks the sweep and keeps the multi-pod records in
    ``mesh_records``.  The processes are killed and the directory removed
    at exit."""

    def __init__(self):
        import atexit
        import tempfile

        from repro_torch.configs import ARCHS
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.out = os.path.join(self.dir, "artifacts")
        self.mesh_out = os.path.join(self.dir, "mesh")
        self.mesh_records = []
        self.t0 = time.perf_counter()
        self.seconds = None
        runs = [["--arch", a, "--shape", DRYRUN_SWEEP_SHAPE, "--out",
                 self.out] for a in ARCHS] + [
            ["--multi-pod", "--arch", a, "--shape", s, "--gossip", g,
             "--remat", r, "--device", "cpu", "--out", self.mesh_out]
            for a, s, g, r in STEPS_DRYRUN]
        self.procs = []
        for i in range(DRYRUN_SWEEP_PROCS):
            outs = tuple(open(os.path.join(self.dir, f"{name}{i}"), "w+")
                         for name in ("stdout", "stderr"))
            self.procs.append((subprocess.Popen(
                [sys.executable, "-c", "import json, sys\n"
                 "from repro_torch.launch import dryrun\n"
                 "for argv in json.loads(sys.argv[1]):\n"
                 "    dryrun.main(argv)\n",
                 json.dumps(runs[i::DRYRUN_SWEEP_PROCS])],
                env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                     "OMP_NUM_THREADS": "1"},
                stdout=outs[0], stderr=outs[1], cwd=ROOT),) + outs)
        atexit.register(self.close)

    def wait(self):
        if self.seconds is not None:
            return
        t_wait = time.perf_counter()
        deadline = self.t0 + DRYRUN_SWEEP_TIMEOUT_S
        try:
            codes = [proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
                     for proc, _, _ in self.procs]
        except subprocess.TimeoutExpired:
            self.close()
            raise AssertionError(f"dry-run sweep: over "
                                 f"{DRYRUN_SWEEP_TIMEOUT_S} s")
        self.seconds = time.perf_counter() - self.t0
        log(f"dry-run sweep (phase 17) ended after {self.seconds:.1f} s "
            f"({DRYRUN_SWEEP_PROCS} processes), "
            f"{time.perf_counter() - t_wait:.1f} s of them waited for")
        for code, (_, _, err) in zip(codes, self.procs):
            if code != 0:
                err.seek(0)
                raise AssertionError(f"dry-run sweep exited {code}: "
                                     f"{err.read()[-3000:]}")

    def close(self):
        import shutil
        for proc, out, err in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    def report(self, n_archs):
        """Logs the sweep's output, checks its artifacts (``n_archs``, each
        ``ok`` or ``skipped``) and logs their report."""
        self.wait()
        for _, out, _ in self.procs:
            out.seek(0)
            for line in out.read().splitlines():
                log(f"  {line}")
        recs = []
        for name in sorted(os.listdir(self.out)):
            with open(os.path.join(self.out, name)) as f:
                recs.append(json.load(f))
        bad = [r["tag"] for r in recs if r["status"] not in ("ok", "skipped")]
        if bad or len(recs) != n_archs:
            raise AssertionError(f"dry-run sweep: {len(recs)} artifacts, "
                                 f"not ok or skipped: {bad}")
        ok = [r for r in recs if r["status"] == "ok"]
        log(f"dry-run sweep at {DRYRUN_SWEEP_SHAPE}: {len(recs)} "
            f"combinations in {self.seconds:.1f} s, beside phases 15 and "
            f"4-12 ({len(ok)} traced, {len(recs) - len(ok)} skipped); fit "
            f"{ok[0]['device_memory_bytes']} bytes "
            f"({ok[0]['device_memory_source']}): "
            + ", ".join(f"{r['arch']}/{r['shape']}" for r in ok if r["fits"])
            + "; do not fit: "
            + ", ".join(f"{r['arch']}/{r['shape']} "
                        f"{r['peak_live_bytes'] / 2 ** 30:.1f} GiB"
                        for r in ok if not r["fits"]))
        tables = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.report", "--dir",
             self.out], env={**os.environ,
                             "PYTHONPATH": os.path.join(ROOT, "src")},
            capture_output=True, text=True, timeout=300, check=True)
        for line in tables.stdout.splitlines():
            log(line)
        for name in sorted(os.listdir(self.mesh_out)):
            with open(os.path.join(self.mesh_out, name)) as f:
                self.mesh_records.append(json.load(f))
        if len(self.mesh_records) != len(STEPS_DRYRUN):
            raise AssertionError(f"dry-run mesh records: "
                                 f"{len(self.mesh_records)}")
        self.close()


def dryrun_path(torch, measured, sweep):
    """Phase 17: ``measured`` holds phase 14's (``fp32``) and 16 (a)'s
    (``bf16``) full-width figures, whose steps keep every activation
    (``remat=False``).  For each dtype, gemma3-1b at their plan traced on
    ``cuda`` fake tensors without rematerialisation, then the same step
    run for real under the same counters: FLOPs and bytes accessed equal;
    the predicted peak against the measured ones; the roofline row and the
    achieved ``mfu``.  Then at bf16 the same for ``DRYRUN_REMAT``'s
    policies, the predicted peak against this phase's counted step under
    the policy.  Then ``sweep`` (a ``DryrunSweep``) and its report."""
    import gc

    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import bind
    from repro_torch.utils.trace_cost import step_cost

    cfg = ARCHS[LM_FULL_ARCH]
    shape = InputShape("lm_full", LM_FULL_SEQ, LM_FULL_CLIENTS, "train")
    cases = [(dname, "none") for dname in measured] + [
        ("bf16", remat) for remat in DRYRUN_REMAT]
    peaks = {}
    for dname, remat in cases:
        figs = measured[dname] if remat == "none" else None
        api = bind(cfg, **dryrun.remat_options(remat))
        plan = dryrun.make_plan(cfg, shape, LM_FULL_CLIENTS, 1, dname)
        fake, trace_s = dryrun.trace_plan(plan, device="cuda", remat=remat)
        step, specs = dryrun.step_and_specs(api, plan)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()       # by earlier phases
        args = dryrun.materialize(specs, cfg.vocab, "cuda",
                                  torch.Generator(device="cuda").manual_seed(17))
        torch.cuda.synchronize()
        out, real = step_cost(step, *args)
        torch.cuda.synchronize()
        own_peak = torch.cuda.max_memory_allocated() - held
        peaks[(dname, remat)] = (fake.flops, fake.peak_live_bytes, own_peak)
        del out, args
        gc.collect()
        torch.cuda.empty_cache()
        log(f"dry run {cfg.name} {dname} remat {remat} K={LM_FULL_CLIENTS} x "
            f"{LM_FULL_SEQ}: traced on cuda fake tensors in {trace_s:.2f} s; "
            f"flops fake {fake.flops} real {real.flops}; bytes accessed fake "
            f"{fake.bytes_accessed} real {real.bytes_accessed}; peak live "
            f"bytes fake {fake.peak_live_bytes} real {real.peak_live_bytes}; "
            f"arguments {fake.argument_bytes} bytes; top ops {fake.aten_ops}")
        if (fake.flops, fake.bytes_accessed) != (real.flops,
                                                 real.bytes_accessed):
            raise AssertionError(f"dry run {dname} remat {remat}: the fake "
                                 f"trace counts {fake} and the real step "
                                 f"{real}")
        measured_peaks = [("this phase's counted step", own_peak)]
        if figs is not None:
            measured_peaks.insert(0, ("phase 14 / 16 (a)'s train step",
                                      figs["train step peak above held GiB"]
                                      * 2 ** 30))
        for what, peak in measured_peaks:
            ratio = fake.peak_live_bytes / peak
            log(f"  predicted peak {fake.peak_live_bytes} bytes "
                f"({fake.peak_live_bytes / 2 ** 30:.3f} GiB) against "
                f"{what} {peak:.0f} bytes ({peak / 2 ** 30:.3f} GiB above "
                f"held): predicted/measured {ratio:.4f}")
            if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
                raise AssertionError(f"dry run {dname} remat {remat}: "
                                     f"predicted/measured peak {ratio} "
                                     f"outside {DRYRUN_PEAK_BAND}")
        if figs is None:
            continue
        rep = roofline.build_report(
            cfg, plan.shape, dryrun.MESH, 1,
            {"flops": fake.flops, "bytes accessed": fake.bytes_accessed},
            0.0, dtype=dname)
        step_s = figs["train step ms"] / 1e3
        mfu = rep.model_flops_global / (
            step_s * roofline.PEAK_FLOPS_BY_DTYPE[dname])
        log(f"  roofline {rep.row()}; model_flops "
            f"{rep.model_flops_global:.6g}; measured warm train step "
            f"{figs['train step ms']:.3f} ms: achieved "
            f"{rep.model_flops_global / step_s / 1e12:.3f} TFLOP/s of "
            f"model FLOPs, mfu {mfu:.6f} (roofline step / measured "
            f"{rep.step_s / step_s:.6f})")
    none = peaks[("bf16", "none")]
    for remat in DRYRUN_REMAT:
        flops, fake_peak, own_peak = peaks[("bf16", remat)]
        log(f"dry run bf16 remat {remat} against none: flops "
            f"{flops / none[0]:.6f}x, predicted peak "
            f"{fake_peak / none[1]:.4f}x, measured peak "
            f"{own_peak / none[2]:.4f}x")
    if not (peaks[("bf16", "dots")][0] == none[0] < peaks[("bf16", "full")][0]
            and peaks[("bf16", "full")][1] < none[1]):
        raise AssertionError(f"dry run bf16: dots' FLOPs not none's, full's "
                             f"not above them or full's predicted peak not "
                             f"below none's: {peaks}")

    # the sweep at published width, every arch at DRYRUN_SWEEP_SHAPE, then
    # its report
    sweep.report(len(ARCHS))


def precision_fold(torch, counters, dev, gen):
    """Phase 16 (c): ``pack_stacked(dtype=float16)`` of a ResNet18-GN K=4
    state (masks at density 0.5) folded into zeros, one row-fold launch a
    leaf, bit-equal to the plain version and to ``(fp16(w), m)``."""
    from repro_torch.models.cnn import init_resnet18
    from repro_torch.scale.stacked import fold_stacked, pack_stacked
    from repro_torch.utils.tree import tree_leaves, tree_map

    out = {}
    cpu_gen = torch.Generator().manual_seed(16)
    params = tree_map(lambda *xs: torch.stack(xs).to(dev),
                      *[init_resnet18(cpu_gen, 10) for _ in range(4)])
    masks = tree_map(lambda t: (torch.rand(t.shape, generator=gen, device=dev)
                                < 0.5).float(), params)
    params = tree_map(lambda t, m: t * m, params, masks)
    zeros = lambda tree: tree_map(torch.zeros_like, tree)  # noqa: E731
    packed = pack_stacked(params, masks, dtype=torch.float16)
    _zero(counters)
    num, den = fold_stacked(zeros(params), zeros(params), packed)
    torch.cuda.synchronize()
    out["fold_launches"] = _launches(counters)
    n_leaves = len(tree_leaves(params))
    if out["fold_launches"]["packed_accum_rows"] != n_leaves or any(
            v for key, v in _totals(out["fold_launches"]).items()
            if key != "packed_accum_rows"):
        raise AssertionError(f"fp16 fold_stacked launches "
                             f"{out['fold_launches']}, {n_leaves} leaves")
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    num_p, den_p = fold_stacked(
        zeros(cpu(params)), zeros(cpu(params)),
        pack_stacked(cpu(params), cpu(masks), dtype=torch.float16))
    for a, b in zip(tree_leaves(num) + tree_leaves(den),
                    tree_leaves(num_p) + tree_leaves(den_p)):
        if not torch.equal(_bits(torch, a.cpu()), _bits(torch, b)):
            raise AssertionError("fp16 fold_stacked on the card != plain")
    for a, b, w, m in zip(tree_leaves(num), tree_leaves(den),
                          tree_leaves(params), tree_leaves(masks)):
        if not (torch.equal(a, w.half().float()) and torch.equal(b, m)):
            raise AssertionError("fold_stacked(0, 0, pack_stacked(w, m, "
                                 "fp16)) != (fp16(w), m)")
    log(f"precision (c) fp16 stacked payloads, ResNet18-GN K=4: "
        f"{out['fold_launches']['packed_accum_rows']} row-fold launches for "
        f"{n_leaves} leaves, bit-equal to plain and to (fp16(w), m)")
    return out


def precision_store(torch, counters, serve_args):
    """Phase 16 (d): ``serve --backend kernel`` with ``serve_args`` from an
    fp16 store and from the fp32 store of the same users: bytes at rest
    the analytic figure at 2 and 4 bytes a value, launches as predicted
    (the masked matmul 3 x (batches + 2), the second store 3 x (batches +
    1): its capture needs no eager warm-up; the flat fold's fp16 entry
    once per leaf per miss of the fp16 store, none for the fp32 one), the
    outputs within ``SERVE_FP16_TOL`` of each other, and the fp16 pool
    equal to the fp32 pool rounded to fp16."""
    import numpy as np

    from repro_torch.core.accounting import HEADER_NBYTES, bitmap_nbytes
    from repro_torch.core.masks import apply_mask, init_mask
    from repro_torch.device import setup_device
    from repro_torch.launch import serve as cli
    from repro_torch.serve.store import ModelStore
    from repro_torch.utils.tree import tree_leaves

    out = {}
    args = cli.build_parser().parse_args(serve_args + ["--backend", "kernel"])
    device = setup_device(args.device)

    def fp16_store(model):
        """The CLI's users (``build_store``'s draws) in an fp16 store."""
        base = model.init(torch.Generator().manual_seed(args.seed))
        store = ModelStore(base, cache_size=args.cache_size, device=device,
                           payload_dtype=np.float16)
        gen = torch.Generator().manual_seed(args.seed + 1)
        for u in range(args.users):
            p = model.init(gen)
            m = init_mask(gen, p, args.density)
            store.put(u, apply_mask(p, m), m)
        return store

    runs = {}
    # one model serves both stores, each from a capture of its own pool
    model = cli.build_model(args.model, args.rows)
    for name, make in (("fp16", fp16_store),
                       ("fp32", lambda m: cli.build_store(args, m, device))):
        store = make(model)
        _zero(counters)
        res = cli.run_serve(args, model, store)
        runs[name] = (res, store, _launches(counters))
    (r16, s16, l16), (r32, s32, _) = runs["fp16"], runs["fp32"]
    n_coords, w_leaves = s16.spec.n_coords, len(tree_leaves(s16.base))
    for name, (res, st, la) in runs.items():
        size = {"fp16": 2, "fp32": 4}[name]
        want = sum(HEADER_NBYTES + bitmap_nbytes(n_coords) + size * st.nnz(u)
                   for u in st.users())
        if st.total_bytes_at_rest() != want:
            raise AssertionError(f"{name} store: bytes_at_rest "
                                 f"{st.total_bytes_at_rest()} != {want}")
        folds = w_leaves * st.misses if name == "fp16" else 0
        # the first store's capturing call runs the forward eagerly and
        # replays it; the second store's capture, of the same signature,
        # only replays
        mm = 3 * (res.summary["batches"] + (2 if name == "fp16" else 1))
        if (la["masked_matmul"], la["packed_accum"]) != (mm, folds):
            raise AssertionError(f"{name} store launches {la}: expected "
                                 f"{mm} masked matmuls, {folds} folds")
    if s16.stats()["hits"] != s32.stats()["hits"] or sorted(
            r16.outputs) != sorted(r32.outputs):
        raise AssertionError("the fp16 and fp32 stores served differently")
    scale = max(float(abs(y).max()) for y in r32.outputs.values())
    err = max(float(abs(r16.outputs[i] - y).max())
              for i, y in r32.outputs.items())
    if err > SERVE_FP16_TOL * max(1.0, scale):
        raise AssertionError(f"fp16 store outputs {err} from the fp32 "
                             f"store's (scale {scale})")
    for user in (0, 1, args.users - 1):
        p16, m16 = s16.get(user)
        p32, m32 = s32.get(user)
        for a, b in zip(tree_leaves(p16), tree_leaves(p32)):
            if a.dtype != torch.float32 or not torch.equal(a, b.half().float()):
                raise AssertionError(f"fp16 store: user {user}'s pool != "
                                     "fp16(w) widened")
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(m16), tree_leaves(m32))):
            raise AssertionError(f"fp16 store: user {user}'s mask differs")
    caps = [(g.captures, len(g.pool_bytes())) for g in model.graphs()]
    if caps != [(2, 2)]:
        raise AssertionError(f"fp16 and fp32 stores on one model: captures "
                             f"{caps}")
    out["store_launches"] = {name: la for name, (_, _, la) in runs.items()}
    out["store"] = {name: (res.summary, st.total_bytes_at_rest())
                    for name, (res, st, _) in runs.items()}
    log(f"precision (d) fp16 store: bytes_at_rest {s16.total_bytes_at_rest()} "
        f"(fp32 {s32.total_bytes_at_rest()}, ratio "
        f"{s16.total_bytes_at_rest() / s32.total_bytes_at_rest():.4f}), each "
        f"the analytic figure; launches {l16} "
        f"({r16.summary['store_misses']} misses x {w_leaves} leaves "
        f"folds); outputs within {err:.3e} of the fp32 "
        f"store's (scale {scale:.3f}); pools equal fp16(w) widened; "
        f"service_s fp16 {r16.summary['service_s']} fp32 "
        f"{r32.summary['service_s']}")
    return out


def _fresh_process_state():
    """What a fresh CLI process starts from: no engine or store of an
    earlier run alive (cycles collected) and the cumulative module counters
    at 0, so a run archive's process-wide counters are its run's own."""
    import gc

    from repro_torch.obs import snapshot_counters
    from repro_torch.sparse import codec, ops, packed
    gc.collect()
    live = [k for k in snapshot_counters()
            if k.split("/")[0] in ("fl.engine", "sim.links", "serve.store")]
    if live:
        raise AssertionError(f"an earlier run is still alive: {live}")
    ops.reset_counters()
    codec.OBS.reset()
    packed.OBS.reset()


def _check_archive(run_dir):
    """``dash render --run-dir D --check`` through the port's entry function;
    returns the archive and its size in bytes."""
    from repro_torch.launch import dash
    from repro_torch.obs import RunArchive
    nbytes = sum(os.path.getsize(os.path.join(run_dir, f))
                 for f in os.listdir(run_dir))
    rc = dash.main(["render", "--run-dir", run_dir, "-o",
                    os.path.join(run_dir, "dash.html"), "--check"])
    if rc != 0:
        raise AssertionError(f"dash render --check failed on {run_dir}")
    return RunArchive(run_dir), nbytes


def obs_sim_runs(torch, train, counters, base, name, extra, modes):
    """Phase 15 for one model: ``OBS_ARGS`` through ``train.main`` once per
    tracing mode (None: untraced), launch counters zeroed just before each
    run and read just after.  Each traced run writes a run archive, checked
    by the dashboard, and must launch every kernel as often as the first
    untraced run.  Returns the launches summed over the traced runs."""
    from repro_torch.obs import get_tracer, phase_summary
    runs = []
    for mode in modes:
        argv = OBS_ARGS + extra
        run_dir = None
        if mode is not None:
            run_dir = os.path.join(base, f"{name}-{mode}-{len(runs)}")
            argv = argv + ["--run-dir", run_dir, "--trace-mode", mode]
        _fresh_process_state()
        _zero(counters)
        out = train.main(argv)
        launches = _launches(counters)
        get_tracer().disable()
        runs.append((mode, out, launches, run_dir))
    want = runs[0][2]
    if min(want["gossip_avg"], want["packed_accum"]) < 1:
        raise AssertionError(f"obs {name}: a kernel of the sim path never "
                             f"ran: {want}")
    traced = {k: 0 for k in want}
    for mode, out, launches, run_dir in runs:
        log(f"obs {name} tracing {mode or 'off'}: launches {launches}; warm "
            f"round wall {out['round_wall_s'][-1]:.4f} s (rounds "
            f"{out['round_wall_s']})")
        if launches != want:
            raise AssertionError(f"obs {name} {mode}: launches {launches} != "
                                 f"untraced {want}")
        if run_dir is None:
            continue
        for k, v in launches.items():
            traced[k] += v
        ar, nbytes = _check_archive(run_dir)
        doc = ar.trace()
        n_spans, dropped = (doc["otherData"]["spans"],
                            doc["otherData"]["droppedSpans"])
        ph = phase_summary(ar.spans(), clock="wall")
        rows = []
        for phase in ("mix", "local", "evolve", "eval"):
            want_s = sum(p[phase] for p in out["phase_s"])
            got = ph.get(f"round.{phase}", {}).get("total_s", 0.0)
            rel = (got - want_s) / want_s if want_s > 0 else 0.0
            rows.append(f"{phase} span {got:.6f} s / phase_s {want_s:.6f} s "
                        f"({100 * rel:+.3f}%, {1e3 * (want_s - got):.3f} ms "
                        f"outside)")
            if (name == "resnet18" and mode == "full"
                    and phase in ("local", "evolve")
                    and abs(rel) > OBS_SPAN_RTOL):
                raise AssertionError(f"obs {name}: round.{phase} spans "
                                     f"{got} s against phase_s {want_s} s")
        log(f"  archive {run_dir}: {nbytes} bytes, {n_spans} spans "
            f"({n_spans / len(out['round_wall_s']):.1f} a round), dropped "
            f"{dropped}, dashboard check ok; " + "; ".join(rows))
        log(f"  counters {json.dumps(ar.counters())}")
    return traced


def obs_path(torch, train, counters):
    """Phase 15: the sim runs of ``make obs-smoke`` at smallcnn and at
    ResNet18-GN, then the serving CLI with a run archive.  Returns every
    kernel's launches summed over the traced runs."""
    import shutil

    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs import get_tracer, store_rollup
    base = os.path.join(ROOT, "runs", "chip_smoke_obs")
    shutil.rmtree(base, ignore_errors=True)
    totals = [obs_sim_runs(torch, train, counters, base, "smallcnn", [],
                           (None, "full")),
              obs_sim_runs(torch, train, counters, base, "resnet18",
                           ["--model", "resnet18", "--hw", "32"],
                           (None, "ring", "full", None))]
    sargs = SERVE_ARGS + ["--backend", "kernel", "--metrics-jsonl",
                          os.devnull]
    run_dir = os.path.join(base, "serve-full")
    serve = []
    for extra in ([], ["--run-dir", run_dir, "--trace-mode", "full"]):
        _fresh_process_state()
        _zero(counters)
        summary = serve_cli.main(sargs + extra)
        serve.append((summary, _launches(counters)))
        get_tracer().disable()
    (s0, l0), (s1, l1) = serve
    want = 3 * (s0["batches"] + 2)
    if not l0 == l1 or l1["masked_matmul"] != want:
        raise AssertionError(f"obs serve: launches traced {l1}, untraced "
                             f"{l0}, expected {want} masked matmuls")
    ar, nbytes = _check_archive(run_dir)
    c, store = ar.counters(), store_rollup(ar.counters())
    if (store["hits"], store["misses"], store["evictions"]) != (
            c["serve.store/hits"], c["serve.store/misses"],
            c["serve.store/evictions"]) or store["misses"] != s1[
                "store_misses"]:
        raise AssertionError(f"obs serve: store rollup {store} against "
                             f"counters {c} and summary {s1}")
    log(f"obs serve: launches {l1} traced == untraced; service_s untraced "
        f"{s0['service_s']}, traced (full) {s1['service_s']}; archive "
        f"{nbytes} bytes, {ar.trace()['otherData']['spans']} spans, "
        f"dashboard check ok; store rollup hit ratio {store['hit_ratio']}")
    totals.append(l1)
    return _sum_launches(totals)


# ---------------------------------------------------------------------------
# 18. compiled steps
# ---------------------------------------------------------------------------

# the graphed train steps' learning rates, one a step (a fourth, profiled
# step repeats the first's inputs); the mask update's prune rates
COMPILED_LRS = (0.01, 0.02, 0.005)
COMPILED_RATES = (0.25, 0.1)
COMPILED_ROUNDS = 3
# the runtime calls that launch device work, as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _trees_bit_equal(torch, a, b):
    """Every leaf's bits equal (-0.0 != +0.0); a leaf on the card is
    compared on the CPU where its partner lies there."""
    from repro_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(torch, x),
                                           _bits(torch, y.to(x.device)))
        for x, y in zip(la, lb))



def _digest(torch, tree):
    """Per leaf, the sum of its bit patterns: a fingerprint of a state for
    the steps between two whole-state comparisons."""
    from repro_torch.utils.tree import tree_leaves
    return torch.stack([_bits(torch, x).to(torch.int64).sum()
                        for x in tree_leaves(tree)]).cpu()


def _busy_union(prof):
    """Seconds in which at least one device event of a finished profiler
    run was running (overlapping kernels counted once); None where the
    profiler gives no device events."""
    try:
        from torch.autograd import DeviceType
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
    except (RuntimeError, AttributeError) as e:
        log(f"  device intervals not measured: {e!r}")
        return None
    if not spans:
        return None
    total, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def _profiled(torch, fn):
    """``fn()`` once under torch.profiler: its wall seconds, the device's
    busy seconds (the union of its events' intervals; None where the
    profiler gives no device time), the runtime's launch calls
    (``HOST_LAUNCH_CALLS``; None where it records none) and the sum of
    the device events' own times (above the union where events
    overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    summed = None if rows is None else sum(r[0] for r in rows) / 1e6
    calls = [r[1] for r in (rows or []) if r[2] in HOST_LAUNCH_CALLS]
    return wall, _busy_union(prof), (sum(calls) if calls else None), summed


def _share(busy, wall):
    return "not measured" if busy is None else f"{100 * busy / wall:.1f}%"


def _expandable_segments(torch, on):
    """The caching allocator's ``expandable_segments`` setting, for the
    segments it makes from now on."""
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setting or torch.cuda.memory._set_allocator_settings)(
        f"expandable_segments:{on}")


def _free_graphs(*engines):
    """Drop the compiled graphs of loop engines that later phases keep
    only for their state: each capture holds a memory pool (a vmap phase
    at ResNet18-GN K=4 held 3.16 GiB on an NVIDIA H100 80GB HBM3 at
    700 W), and phase 13 (b) needs the card."""
    for engine in engines:
        for g in _loop_graphs(engine):
            g.release()


def _release(*graphs):
    import gc
    for g in graphs:
        g.release()
    gc.collect()
    import torch
    torch.cuda.empty_cache()


def lm_compiled(torch, counters, dtype, eager):
    """Phase 18 for one dtype: gemma3-1b at phase 14's plan, each step
    builder through ``utils.graph.graphed`` against the same builder run
    eagerly (``graph.disabled()``) from the same state: 3 train steps with
    their own lr, adjacency and batch (then a profiled fourth), one
    ppermute train step, the mask update at two prune rates, a prefill and
    16 decode steps; bit-equal, or the phase fails.  ``eager`` holds phase
    14's / 16 (a)'s figures, printed beside this phase's.  Returns the
    launches of the graphed runs and the figures."""
    import gc

    import numpy as np

    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.utils import graph
    from repro_torch.utils.tree import tree_map

    dname = str(dtype).replace("torch.", "")
    cfg = ARCHS[LM_FULL_ARCH]
    k, s, n_dec = LM_FULL_CLIENTS, LM_FULL_SEQ, LM_FULL_DECODE
    api = bind(cfg, remat=False)
    plan = steps.ScalePlan(cfg, InputShape("lm_full", s, k, "train"), k, 1,
                           dtype)
    dev = torch.device("cuda")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def state():
        gc.collect()
        torch.cuda.empty_cache()
        return _lm_full_state(torch, api, plan,
                              torch.Generator(device="cuda").manual_seed(0))

    gen = torch.Generator(device="cuda").manual_seed(18)
    toks = torch.randint(0, cfg.vocab, (len(COMPILED_LRS), k, 1, s + 1),
                         generator=gen, device="cuda")
    batches = [{"tokens": t[..., :s].contiguous(),
                "labels": t[..., 1:].contiguous()} for t in toks]
    batches.append(batches[0])
    # every unit-diagonal (K, K) adjacency, in a random order: a different
    # topology each step (K=2 has four)
    offdiag = ~np.eye(k, dtype=bool)
    adjs = []
    for code in np.random.default_rng(18).permutation(2 ** (k * k - k)):
        a = np.eye(k, dtype=np.float32)
        a[offdiag] = [(code >> i) & 1 for i in range(k * k - k)]
        adjs.append(torch.as_tensor(a, device=dev))
    lrs = [torch.tensor(x, dtype=torch.float32, device=dev)
           for x in COMPILED_LRS + COMPILED_LRS[:1]]
    n_steps = len(lrs)
    figs, launches = {}, []

    # (a) the train step: 3 steps timed, a 4th profiled; graphed, then eager
    def train_run(step, params, masks):
        losses_all, digests, ms = [], [], []
        for i in range(n_steps):
            if i == n_steps - 1:
                holder = {}

                def last():
                    holder["out"] = step(params, masks, batches[i], adjs[i],
                                         lrs[i])

                prof = _profiled(torch, last)
                params, losses = holder.pop("out")
            else:
                a, b = ev(), ev()
                a.record()
                params, losses = step(params, masks, batches[i], adjs[i],
                                      lrs[i])
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            losses_all.append(losses.cpu())
            digests.append(_digest(torch, params))
        return params, losses_all, digests, ms, prof

    builder = steps.make_train_step(api, plan, "einsum")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params, masks = state()
    # donated masks have no output to take: the capture reads them in place
    step = graph.graphed(builder, donate=(0, 1))
    _zero(counters)
    g_params, g_losses, g_dig, g_ms, g_prof = train_run(step, params, masks)
    launches.append(_launches(counters))
    g_params = _to(torch, g_params, "cpu")
    figs["train peak GiB"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    figs["train reserved GiB"] = torch.cuda.memory_reserved() / 2 ** 30
    figs["train capture s"] = step.capture_s
    if step.captures != 1 or step.replays != n_steps:
        raise AssertionError(f"train step: {step.captures} captures, "
                             f"{step.replays} replays for {n_steps} calls")
    _release(step)
    del params, masks
    params, masks = state()
    with graph.disabled():
        e_params, e_losses, e_dig, e_ms, e_prof = train_run(builder, params,
                                                            masks)
    del params
    for i in range(n_steps):
        if not (torch.equal(_bits(torch, g_losses[i]),
                            _bits(torch, e_losses[i]))
                and torch.equal(g_dig[i], e_dig[i])):
            raise AssertionError(f"compiled {dname} train step {i}: losses "
                                 f"{g_losses[i].tolist()} vs eager "
                                 f"{e_losses[i].tolist()}, or params differ")
    if not _trees_bit_equal(torch, g_params, e_params):
        raise AssertionError(f"compiled {dname}: train-step params differ "
                             "from eager's")
    del g_params, e_params
    figs["train step ms"] = float(np.mean(g_ms[1:]))
    figs["eager train step ms"] = float(np.mean(e_ms[1:]))
    for name, prof in (("train", g_prof), ("eager train", e_prof)):
        figs[f"{name} busy"] = None if prof[1] is None else prof[1] / prof[0]
        figs[f"{name} host launches"] = prof[2]
    figs["tokens/s"] = k * s / (figs["train step ms"] / 1e3)

    # (b) the ring gossip: one train step, graphed then eager
    pp = steps.make_train_step(api, plan, "ppermute")
    params, masks = state()
    step = graph.graphed(pp, donate=(0, 1))
    g_params, g_losses = step(params, masks, batches[0], adjs[0], lrs[0])
    g_losses, g_params = g_losses.cpu(), _to(torch, g_params, "cpu")
    _release(step)
    del params
    params, _ = state()
    with graph.disabled():
        e_params, e_losses = pp(params, masks, batches[0], adjs[0], lrs[0])
    if not (torch.equal(_bits(torch, g_losses), _bits(torch, e_losses.cpu()))
            and _trees_bit_equal(torch, g_params, e_params)):
        raise AssertionError(f"compiled {dname}: the ppermute train step "
                             "differs from eager's")
    del params, g_params, e_params

    # (c) the mask update at two prune rates, graphed then eager; launches
    # per replay against eager's per call
    mu = steps.make_mask_update_step(api, plan, density=0.5)
    rates = [torch.tensor(r, dtype=torch.float32, device=dev)
             for r in COMPILED_RATES]

    def update_run(fn, params, masks):
        per_call, ms = [], []
        for rate in rates:
            _zero(counters)
            a, b = ev(), ev()
            a.record()
            params, masks = fn(params, masks, batches[0], rate)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            per_call.append(_launches(counters))
        return params, masks, per_call, ms

    params, masks = state()
    # the graphed mask update's capture needs expandable segments at full
    # width: a capture cannot free cached segments and retry, as an eager
    # allocation that runs out does, so the default allocator fragments
    # its pool past the card (fp32, 5 GiB held: 76.7 GiB reserved, 19.3
    # GiB of it split blocks).  Only the graphed run uses them: eager runs
    # are timed with the default allocator.
    _expandable_segments(torch, True)
    try:
        step = graph.graphed(mu, donate=(0, 1))
        g_params, g_masks, g_calls, g_ums = update_run(step, params, masks)
        figs["mask update capture s"] = step.capture_s
        g_params, g_masks = (_to(torch, t, "cpu")
                             for t in (g_params, g_masks))
        del params, masks
        _release(step)
    finally:
        _expandable_segments(torch, False)
    params, masks = state()
    with graph.disabled():
        e_params, e_masks, e_calls, e_ums = update_run(mu, params, masks)
    if not (_trees_bit_equal(torch, g_params, e_params)
            and _trees_bit_equal(torch, g_masks, e_masks)):
        raise AssertionError(f"compiled {dname}: the mask update differs "
                             "from eager's")
    first = {key: 2 * v for key, v in e_calls[0].items()}
    if g_calls[0] != first or g_calls[1] != e_calls[1]:
        raise AssertionError(f"compiled {dname} mask update launches "
                             f"{g_calls} against eager's {e_calls} (the "
                             "first graphed call warms up, then replays)")
    launches += g_calls
    figs["mask update ms"] = g_ums[1]
    figs["eager mask update ms"] = e_ums[1]
    del params, masks, g_params, g_masks, e_masks

    # (d) prefill and 16 decode steps, graphed then eager (the 16th
    # profiled); tokens, logits and caches bit-equal
    prefill = steps.make_prefill_step(api, plan)
    decode = steps.make_decode_step(api, plan)
    params = e_params
    prompt = {"tokens": batches[0]["tokens"]}

    def fresh_cache():
        return tree_map(lambda t: torch.stack([t] * k),
                        api.init_cache(1, s + n_dec, dtype, device="cuda"))

    def serve_run(pre, dec):
        logits, cache = pre(params, prompt, fresh_cache())
        tok = torch.argmax(logits[:, :, -1], -1)[..., None].to(torch.int32)
        out, ms = [tok], []
        for i in range(n_dec):
            pos = torch.full((k,), s + i, dtype=torch.int32, device="cuda")

            def one():
                return dec(params, {"tokens": out[-1], "pos": pos}, cache)

            if i == n_dec - 1:
                holder = {}
                prof = _profiled(torch, lambda: holder.update(r=one()))
                nxt, cache = holder["r"]
            else:
                a, b = ev(), ev()
                a.record()
                nxt, cache = one()
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            out.append(nxt[..., None])
        return logits, cache, torch.cat(out, -1), ms, prof

    # the params have no output to take: read in place, never copied
    g_pre = graph.graphed(prefill, donate=(0, 2))
    g_dec = graph.graphed(decode, donate=(0, 2))
    g_logits, g_cache, g_toks, g_dms, g_dprof = serve_run(g_pre, g_dec)
    figs["decode capture s"] = g_dec.capture_s
    if g_dec.captures != 1 or g_pre.captures != 1:
        raise AssertionError(f"decode {g_dec.captures} captures, prefill "
                             f"{g_pre.captures}")
    _release(g_pre, g_dec)
    with graph.disabled():
        e_logits, e_cache, e_toks, e_dms, e_dprof = serve_run(prefill,
                                                              decode)
    if not (torch.equal(g_toks, e_toks)
            and _trees_bit_equal(torch, g_logits, e_logits)
            and _trees_bit_equal(torch, g_cache, e_cache)):
        raise AssertionError(f"compiled {dname}: prefill or decode differs "
                             "from eager's (tokens, logits or caches)")
    figs["decode ms/token"] = float(np.mean(g_dms[1:]))
    figs["eager decode ms/token"] = float(np.mean(e_dms[1:]))
    for name, prof in (("decode", g_dprof), ("eager decode", e_dprof)):
        figs[f"{name} busy"] = None if prof[1] is None else prof[1] / prof[0]
        figs[f"{name} host launches"] = prof[2]
    del params, e_params, g_logits, e_logits, g_cache, e_cache
    gc.collect()
    torch.cuda.empty_cache()

    log(f"compiled {cfg.name} {dname} K={k} x {s} (graphed against eager "
        f"in this phase, phase 14 / 16 (a) beside): train step "
        f"{figs['train step ms']:.3f} ms graphed (replays of steps 2-3; "
        f"eager here {figs['eager train step ms']:.3f} ms, phase 14 / 16 "
        f"(a) {eager['train step ms']:.3f} ms), {figs['tokens/s']:.1f} "
        f"tokens/s; busy {_share(g_prof[1], g_prof[0])} graphed (summed "
        f"{_share(g_prof[3], g_prof[0])}), {_share(e_prof[1], e_prof[0])} "
        f"eager (summed {_share(e_prof[3], e_prof[0])}); host launches "
        f"{g_prof[2]} graphed, {e_prof[2]} eager; peak "
        f"{figs['train peak GiB']:.2f} GiB above held with the graph pool "
        f"(reserved {figs['train reserved GiB']:.2f} GiB); capture "
        f"{figs['train capture s']:.2f} s; 4 steps bit-equal (losses and "
        f"params), ppermute step bit-equal")
    log(f"  mask update {figs['mask update ms']:.3f} ms graphed (replay at "
        f"rate {COMPILED_RATES[1]}), {figs['eager mask update ms']:.3f} ms "
        f"eager (phase 14 / 16 (a) {eager['mask update ms']:.3f} ms); capture "
        f"{figs['mask update capture s']:.2f} s; masks and params bit-equal "
        f"at rates {COMPILED_RATES}; prune_regrow launches per call graphed "
        f"{[c['prune_regrow'] for c in g_calls]}, eager "
        f"{[c['prune_regrow'] for c in e_calls]}")
    log(f"  decode {figs['decode ms/token']:.3f} ms a token step graphed, "
        f"{figs['eager decode ms/token']:.3f} ms eager (phase 14 / 16 (a) "
        f"{eager['decode ms/token']:.3f} ms); busy "
        f"{_share(g_dprof[1], g_dprof[0])} graphed (summed "
        f"{_share(g_dprof[3], g_dprof[0])}), "
        f"{_share(e_dprof[1], e_dprof[0])} eager (summed "
        f"{_share(e_dprof[3], e_dprof[0])}); host launches "
        f"{g_dprof[2]} graphed, {e_dprof[2]} eager; capture "
        f"{figs['decode capture s']:.2f} s; prefill and {n_dec} decoded "
        f"tokens, logits and caches bit-equal")
    return _sum_launches(launches), figs


class RoundLaunches:
    """Engine callback: each round's launches (``_launches``), the
    counters zeroed after each read."""

    def __init__(self, counters):
        self.counters = counters
        self.rounds = []

    def on_round_end(self, engine, metrics):
        self.rounds.append(_launches(self.counters))
        _zero(self.counters)

    def on_run_end(self, engine):
        pass


# phase 18's ScaleEngine cells: phase 5's (K=4; the default degree 10
# makes the graph fully connected) per reduction, then a random topology
# whose in-degrees change from round to round (a batch of 8, which every
# client of the 8-way split holds)
SCALE_COMPILED_CASES = (
    ("ordered", "K=4", []), ("einsum", "K=4", []),
    ("ordered", "K=8 random degree 3",
     ["--clients", "8", "--topology", "random", "--degree", "3",
      "--batch-size", "8"]))


def ordered_pads_exact(torch, engine, rounds):
    """On the card, the ``ordered`` mix through the padded (K, J) index
    against the gossip kernel over each receiver's real rows alone (views,
    no pads), on the engine's state with a block of -0.0 weights under
    set masks planted in each leaf: bit-equal for each of ``rounds``'
    topologies, the planted block -0.0 in the result.  Returns the
    topologies' distinct in-degree vectors."""
    from repro_torch.core.topology import make_adjacency, max_in_degree
    from repro_torch.kernels.gossip_avg import gossip_avg
    from repro_torch.scale.stacked import (
        in_neighbour_index,
        masked_gossip_stacked,
    )
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = engine.cfg
    k = cfg.n_clients
    width = 1 + max_in_degree(cfg.topology, k, cfg.degree)

    def plant(t, value):
        t = t.clone()
        t.reshape(k, -1)[:, :64] = value
        return t

    w = tree_map(lambda t: plant(t, -0.0), engine.state["params"])
    m = tree_map(lambda t: plant(t, 1.0), engine.state["masks"])
    degrees = set()
    for t in range(rounds):
        adj = make_adjacency(cfg.topology, k, t, cfg.degree, cfg.seed,
                             cfg.drop_prob)
        index = in_neighbour_index(adj, width, engine.device)
        degrees.add(tuple(int(x) for x in (index < k).sum(1).tolist()))
        got = masked_gossip_stacked(w, m, index, reduction="ordered")
        for a, b, mm in zip(tree_leaves(got), tree_leaves(w),
                            tree_leaves(m)):
            mw = mm.to(b.dtype)
            for r in range(k):
                rows = [r] + [j for j in range(k) if adj[r, j] > 0 and j != r]
                want = gossip_avg([b[j] for j in rows], [mw[j] for j in rows],
                                  mw[r])
                if not torch.equal(_bits(torch, a[r]), _bits(torch, want)):
                    raise AssertionError(f"ordered mix, round {t} receiver "
                                         f"{r}: the padded index differs "
                                         "from the real rows alone")
            if not torch.equal(_bits(torch, a.reshape(k, -1)[:, :64]),
                               _bits(torch, torch.full_like(
                                   a.reshape(k, -1)[:, :64], -0.0))):
                raise AssertionError("ordered mix: the planted -0.0 block "
                                     "did not stay -0.0")
    # one mix timed each way on the last topology, each captured in a
    # CUDA graph so that only device time counts: the padded gather
    # against the kernel over views of the real rows
    def padded():
        return masked_gossip_stacked(w, m, index, reduction="ordered")

    def views():
        out = []
        for b, mm in zip(tree_leaves(w), tree_leaves(m)):
            mw = mm.to(b.dtype)
            for r in range(k):
                rows = [r] + [j for j in range(k) if adj[r, j] > 0 and j != r]
                out.append(gossip_avg([b[j] for j in rows],
                                      [mw[j] for j in rows], mw[r]))
        return out

    times = {}
    for name, fn in (("padded", padded), ("views", views)):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        times[name] = cuda_ms(g.replay, iters=5, warmup=1)
        del g
    torch.cuda.empty_cache()
    log(f"ordered mix K={k} {cfg.topology} degree {cfg.degree}, graphed: "
        f"padded index {times['padded']:.3f} ms, views of the real rows "
        f"{times['views']:.3f} ms (CUDA events, mean of 5 replays)")
    return degrees


def scale_compiled(torch, train, counters):
    """Phase 18 for ``ScaleEngine``: ResNet18-GN in each cell of
    ``SCALE_COMPILED_CASES`` for ``COMPILED_ROUNDS`` rounds, eagerly
    (``graph.disabled()``)
    and graphed from the same state: masks and params bit-equal, comm rows
    and FLOPs equal, one capture (``step_compiles == 1``), each C entry's
    launches per replayed round equal to eager's per round (the first
    graphed round warms up eagerly, then replays: twice eager's); then a
    profiled further round of each.  At random topology the in-degrees
    change between rounds and one capture serves them all; there the
    padded index is also held to the real rows alone
    (``ordered_pads_exact``).  Returns the graphed runs' launches."""
    from repro_torch.utils import graph
    argv = list(SCALE_ARGS)
    argv[argv.index("--rounds") + 1] = str(COMPILED_ROUNDS)
    launches = []
    for reduction, cell, extra in SCALE_COMPILED_CASES:
        args = train.build_parser().parse_args(
            argv + extra + ["--scale-reduction", reduction])
        runs = {}
        start = None
        for mode in ("eager", "graphed"):
            engine = train.build_engine(args)
            if start is None:
                start = _to(torch, engine.state, "cuda")
            else:
                engine.state = _to(torch, start, "cuda")
            per_round = RoundLaunches(counters)
            engine.callbacks.append(per_round)
            _zero(counters)
            if mode == "eager":
                with graph.disabled():
                    out = train.run_engine(args, engine)
            else:
                out = train.run_engine(args, engine)
            engine.callbacks.remove(per_round)
            engine.cfg.rounds += 1
            if mode == "eager":
                with graph.disabled():
                    prof = _profiled(torch, lambda: list(engine.rounds()))
            else:
                prof = _profiled(torch, lambda: list(engine.rounds()))
            runs[mode] = (engine, out, per_round.rounds, prof)
        (eng_e, out_e, la_e, prof_e), (eng_g, out_g, la_g, prof_g) = (
            runs["eager"], runs["graphed"])
        if not _trees_bit_equal(torch, eng_g.state, eng_e.state):
            raise AssertionError(f"compiled scale {reduction} {cell}: state "
                                 "differs from eager's")
        if eng_g._comm != eng_e._comm or eng_g._flops != eng_e._flops:
            raise AssertionError(f"compiled scale {reduction} {cell}: comm "
                                 "or FLOP rows differ from eager's")
        if eng_g.step_compiles != 1 or eng_e.step_compiles != 0:
            raise AssertionError(f"compiled scale {reduction} {cell}: "
                                 f"step_compiles {eng_g.step_compiles} "
                                 "graphed, "
                                 f"{eng_e.step_compiles} eager")
        want = [{key: 2 * v for key, v in la_e[0].items()}] + la_e[1:]
        if la_g != want:
            raise AssertionError(f"compiled scale {reduction} {cell}: "
                                 f"launches per round {la_g} against "
                                 f"eager's {la_e}")
        launches += la_g
        if extra:
            degrees = ordered_pads_exact(torch, eng_g, COMPILED_ROUNDS + 1)
            if len(degrees) < 2:
                raise AssertionError(f"compiled scale {cell}: the in-degrees "
                                     f"never changed: {degrees}")
            log(f"compiled scale {cell}: in-degree vectors over the rounds "
                f"{sorted(degrees)}; the padded ordered mix bit-equal to the "
                "real rows alone, a planted -0.0 block kept -0.0")
        log(f"compiled scale {reduction} (resnet18 {cell}, "
            f"{COMPILED_ROUNDS} rounds): state bit-equal to eager, comm and FLOP rows equal, "
            f"step_compiles 1, capture {eng_g._round_step.capture_s:.2f} s; "
            f"gossip_avg launches per round {[r['gossip_avg'] for r in la_g]}"
            f" (eager {[r['gossip_avg'] for r in la_e]}); round wall graphed "
            f"{[round(w, 4) for w in out_g['round_wall_s']]} s, eager "
            f"{[round(w, 4) for w in out_e['round_wall_s']]} s; a profiled "
            f"replayed round {prof_g[0]:.4f} s busy "
            f"{_share(prof_g[1], prof_g[0])} (kernel times summed "
            f"{_share(prof_g[3], prof_g[0])}; {prof_g[2]} host launches), "
            f"eager {prof_e[0]:.4f} s busy {_share(prof_e[1], prof_e[0])} "
            f"(summed {_share(prof_e[3], prof_e[0])}; {prof_e[2]} host "
            f"launches); phases graphed "
            f"{eng_g.phase_s[-1]}, eager {eng_e.phase_s[-1]}")
        _release(eng_g._round_step)
        del runs, eng_e, eng_g
    return _sum_launches(launches)


# phase 18's loop-engine cells: phase 4's ResNet18-GN cell (K=4) on the
# per-client loop and with the vmap local phase, and the synchronous and
# asynchronous simulators (phases 9 and 10's arguments); the asynchronous
# one also at the default --exec auto, the vmap step one client a phase
# on dirichlet shards of ragged sizes
LOOP_COMPILED_CASES = (
    ("loop", ["--exec", "loop"]), ("vmap", ["--exec", "vmap"]),
    ("sim sync", ["--sim", "--exec", "loop"]),
    ("sim async", ["--exec", "loop"] + ASYNC_ARGS),
    ("sim async auto", ASYNC_ARGS))
LOOP_COMPILED_ROUNDS = 2


def _loop_graphs(engine):
    """The graphed functions of a loop engine (its task's)."""
    return engine.task.graphs()


class RoundStamps:
    """Engine callback: per round, the host clock, the launches (the
    counters zeroed after each read), the captures so far and how many
    clients have run a local phase so far (``track`` wraps the engine's
    ``run_local_phase``)."""

    def __init__(self, counters):
        self.counters = counters
        self.t, self.launches, self.captures, self.computed = [], [], [], []
        self.seen = set()

    def track(self, engine):
        run = engine.run_local_phase

        def tracked(ctx, active):
            self.seen.update(active)
            return run(ctx, active)

        engine.run_local_phase = tracked

    def on_round_end(self, engine, metrics):
        self.t.append(time.perf_counter())
        self.launches.append(_launches(self.counters))
        _zero(self.counters)
        self.captures.append(sum(g.captures for g in _loop_graphs(engine)))
        self.computed.append(len(self.seen))

    def on_run_end(self, engine):
        pass


def loop_compiled(torch, train, counters):
    """Phase 18 for the loop engine: each cell of ``LOOP_COMPILED_CASES``
    for ``LOOP_COMPILED_ROUNDS`` rounds and a profiled further round,
    eagerly (``graph.disabled()``) and graphed from one state: state
    bit-equal, comm and FLOP rows and accuracies equal (the simulators'
    transfers too), captures made in round 0 and afterwards only in a
    round in which a client ran its first local phase, the vmap step's
    one per distinct (active clients, batch size), each C entry's
    launches per round equal to eager's (the mix, the only kernels'
    caller, runs eagerly in both); the host wall per round, the profiled
    round's busy share and launch calls, the capture seconds and the
    memory the graph pools hold.  Returns the graphed runs' launches."""
    import contextlib
    import gc

    from repro_torch.utils import graph
    argv = list(RESNET_ARGS)
    argv[argv.index("--rounds") + 1] = str(LOOP_COMPILED_ROUNDS + 1)
    rounds_n = LOOP_COMPILED_ROUNDS
    launches = []
    for cell, extra in LOOP_COMPILED_CASES:
        args = train.parse_args(argv + extra)
        runs, start = {}, None
        for mode in ("eager", "graphed"):
            engine = train.build_engine(args)
            if start is None:
                start = _to(torch, engine.state, "cuda")
            else:
                engine.state = _to(torch, start, "cuda")
            stamps = RoundStamps(counters)
            engine.callbacks.append(stamps)
            stamps.track(engine)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            _zero(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (graph.disabled() if mode == "eager"
                  else contextlib.nullcontext()):
                rounds = engine.rounds()
                for _ in range(rounds_n):
                    next(rounds)
                prof = _profiled(torch, lambda: next(rounds))
                for _ in rounds:
                    pass
            walls = [b - a for a, b in zip([t0] + stamps.t, stamps.t)]
            runs[mode] = dict(
                engine=engine, stamps=stamps, walls=walls, prof=prof,
                peak=(torch.cuda.max_memory_allocated() - held) / 2 ** 30,
                reserved=torch.cuda.memory_reserved() / 2 ** 30)
        e, g = runs["eager"], runs["graphed"]
        eng_e, eng_g = e["engine"], g["engine"]
        what = f"compiled loop engine {cell}"
        if not _trees_bit_equal(torch, eng_g.state, eng_e.state):
            raise AssertionError(f"{what}: state differs from eager's")
        if (eng_g._comm != eng_e._comm or eng_g._flops != eng_e._flops
                or eng_g._acc_history != eng_e._acc_history):
            raise AssertionError(f"{what}: comm or FLOP rows or accuracies "
                                 "differ from eager's")
        if getattr(eng_g, "stats", None) is not None and (
                eng_g.stats.transfers != eng_e.stats.transfers):
            raise AssertionError(f"{what}: transfers differ from eager's")
        caps, seen = g["stamps"].captures, g["stamps"].computed
        grew = [r for r in range(1, len(caps)) if caps[r] > caps[r - 1]]
        if caps[0] < 1 or any(seen[r] == seen[r - 1] for r in grew) or any(
                e["stamps"].captures):
            raise AssertionError(
                f"{what}: captures per round {caps} with {seen} clients "
                f"computed so far (eager {e['stamps'].captures})")
        stacked = [f for (_, is_stacked), f in eng_g.task._steps.items()
                   if is_stacked]
        if stacked:
            # one phase of K=4 (one batch size), or one client a phase
            bss = ({min(args.batch_size, eng_g.clients[k].n_train)
                    for k in g["stamps"].seen} if "async" in cell
                   else {min(args.batch_size, min(
                       c.n_train for c in eng_g.clients))})
            if len(stacked) != 1 or stacked[0].captures != len(bss):
                raise AssertionError(
                    f"{what}: {[f.captures for f in stacked]} captures of "
                    f"the vmap step for batch sizes {sorted(bss)}")
        if g["stamps"].launches != e["stamps"].launches:
            raise AssertionError(f"{what}: launches per round "
                                 f"{g['stamps'].launches} against eager's "
                                 f"{e['stamps'].launches}")
        launches += g["stamps"].launches
        graphs = _loop_graphs(eng_g)
        cap_s = sum(x.capture_s for x in graphs)
        pg, pe = g["prof"], e["prof"]
        log(f"{what} (resnet18 K=4, {rounds_n} rounds + a profiled "
            f"one): state, rows and accuracies bit-equal to eager; "
            f"captures per round {caps}, clients computed so far {seen}"
            + (f", the vmap step's for batch sizes {sorted(bss)} "
               f"({stacked[0].captures}, {stacked[0].replays} replays)"
               if stacked else "") + " "
            f"({[(x.captures, x.replays) for x in graphs]} captures and "
            f"replays a function), capture {cap_s:.2f} s; gossip_avg / "
            f"packed_accum launches per round "
            f"{[(r['gossip_avg'], r['packed_accum']) for r in g['stamps'].launches]}"
            f" (equal to eager's); host wall per round graphed "
            f"{[round(w, 4) for w in g['walls'][:rounds_n]]} s, eager "
            f"{[round(w, 4) for w in e['walls'][:rounds_n]]} s; the "
            f"profiled round {pg[0]:.4f} s busy {_share(pg[1], pg[0])} "
            f"(summed {_share(pg[3], pg[0])}; {pg[2]} host launches), eager "
            f"{pe[0]:.4f} s busy {_share(pe[1], pe[0])} (summed "
            f"{_share(pe[3], pe[0])}; {pe[2]} host launches); peak "
            f"{g['peak']:.3f} GiB above held with the {caps[-1]} graph pools "
            f"(eager {e['peak']:.3f} GiB; reserved {g['reserved']:.3f} / "
            f"{e['reserved']:.3f} GiB); phases of round "
            f"{rounds_n - 1} graphed "
            f"{eng_g.phase_s[rounds_n - 1:rounds_n]}, eager "
            f"{eng_e.phase_s[rounds_n - 1:rounds_n]}")
        _release(*graphs)
        del runs, eng_e, eng_g, e, g
    return _sum_launches(launches)


def serve_cell(torch, counters, name, backend, cli_args):
    """Phase 18 for one serving cell: the serving CLI's model and store
    (``cli_args``) served through ``ServeEngine`` as ``run_serve`` serves,
    graphed and under ``graph.disabled()``, each engine on a fresh model
    and a store built from the same seed: each ``warmup()`` (graphed: one
    capture of the forward) and first pass over the request stream with
    the launch counters zeroed just before and read just after, then a
    second, profiled pass each, in the order eager, graphed, graphed,
    eager (a drift of the shared host's speed falls on both alike).
    Outputs of both passes and cache counters bit-equal; no capture while
    serving; the masked matmul 3 x (batches + 2) graphed and 3 x (batches
    + 1) eager on the kernel backend, none on the others.  Prints
    service_s and p50/p99 of each pass, the profiled pass's busy share
    and the runtime's launch calls, captures, replays, capture seconds,
    the peak above what was held and the memory the graphed forward's
    capture holds until ``release()``, graphed beside eager.  Returns the
    graphed first pass's launches."""
    import contextlib
    import gc

    import numpy as np

    from repro_torch.device import setup_device
    from repro_torch.launch import serve as cli
    from repro_torch.serve import RequestStream, ServeEngine
    from repro_torch.utils import graph

    args = cli.build_parser().parse_args(cli_args + ["--model", name,
                                                     "--backend", backend])
    runs = {}

    def mode_of(mode):
        return (graph.disabled() if mode == "eager"
                else contextlib.nullcontext())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for mode in ("eager", "graphed"):
        model = cli.build_model(args.model, args.rows)
        store = cli.build_store(args, model, setup_device(args.device))
        engine = ServeEngine(store, model, backend=args.backend,
                             max_batch=args.max_batch, max_wait=args.max_wait)
        reqs = RequestStream(n_users=len(store.users()),
                             n_requests=args.requests, seed=args.seed,
                             rate=args.rate).requests()
        with mode_of(mode):
            _zero(counters)
            warm_s = engine.warmup()
            graphs = model.graphs()
            warm_caps = [g.captures for g in graphs]
            res = engine.serve(reqs, warmup=False)
            launches = _launches(counters)
        runs[mode] = dict(engine=engine, reqs=reqs, store=store,
                          graphs=graphs, warm_s=warm_s, warm_caps=warm_caps,
                          passes=[res], launches=launches)
    for mode in ("graphed", "eager"):
        r = runs[mode]
        box = {}
        with mode_of(mode):
            r["prof"] = _profiled(torch, lambda: box.setdefault(
                "res", r["engine"].serve(r["reqs"], warmup=False)))
        r["passes"].append(box["res"])
        r["psvc"] = box["res"].summary["service_s"]
        r["caps"] = [g.captures for g in r["graphs"]]
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    g, e = runs["graphed"], runs["eager"]
    what = f"compiled serving {name} --backend {backend}"
    if g["warm_caps"] != [1] or g["caps"] != [1] or any(e["caps"]):
        raise AssertionError(f"{what}: captures graphed {g['warm_caps']} "
                             f"in warmup, {g['caps']} after serving; eager "
                             f"{e['caps']}")
    for gp, ep in zip(g["passes"], e["passes"]):
        if sorted(gp.outputs) != sorted(ep.outputs) or any(
                not np.array_equal(y.view(np.int32),
                                   ep.outputs[rid].view(np.int32))
                for rid, y in gp.outputs.items()):
            raise AssertionError(f"{what}: outputs differ from eager")
    if g["store"].stats() != e["store"].stats():
        raise AssertionError(f"{what}: cache counters graphed "
                             f"{g['store'].stats()} against eager "
                             f"{e['store'].stats()}")
    batches = g["passes"][0].summary["batches"]
    want = ((3 * (batches + 2), 3 * (batches + 1)) if backend == "kernel"
            else (0, 0))
    got = (g["launches"]["masked_matmul"], e["launches"]["masked_matmul"])
    if got != want or any(v for k, v in g["launches"].items()
                          if "masked_matmul" not in k):
        raise AssertionError(f"{what}: masked_matmul launches graphed, eager "
                             f"{got}, expected {want}; {g['launches']}")

    def figs(r):
        sm = [p.summary for p in r["passes"]]
        return (f"service_s {[x['service_s'] for x in sm]}, p50 "
                f"{[x['p50_ms'] for x in sm]} ms, p99 "
                f"{[x['p99_ms'] for x in sm]} ms (the second pass "
                f"profiled), warmup {r['warm_s']:.3f} s, profiled pass busy "
                f"{_share(r['prof'][1], r['psvc'])} of its service_s "
                f"({r['prof'][2]} host launches)")

    s0 = g["passes"][0].summary
    log(f"{what}: outputs and cache counters bit-equal to eager, "
        f"{s0['requests']} requests in {batches} batches a pass, hit rate "
        f"{s0['cache_hit_rate']}; masked_matmul launches {got[0]} (eager "
        f"{got[1]}); captures of the forward {g['caps']}, in warmup, "
        f"replays {[x.replays for x in g['graphs']]}, capture "
        f"{sum(x.capture_s for x in g['graphs']):.3f} s; graphed "
        f"{figs(g)}; eager {figs(e)}; peak of both {peak:.3f} GiB above held; "
        f"the graphed forward's capture held "
        f"{_hold_figs(_graph_hold(torch, g['graphs']))}")
    return g["launches"]


def serve_compiled(torch, counters):
    """Phase 18's serving cells: the MLP at ``COMPILED_SERVE_ARGS`` on the
    kernel and vmap backends (the ``ref`` backend's graph is held to eager
    by the card tests), smallcnn and each smoke arch at
    ``SERVE_MODEL_ARGS``.
    The full-width cells are phase 13 (b)'s.  Returns the graphed runs'
    launches summed."""
    from repro_torch.configs import SMOKE_ARCHS

    runs = [serve_cell(torch, counters, "mlp", backend, COMPILED_SERVE_ARGS)
            for backend in ("kernel", "vmap")]
    for name in ["smallcnn"] + sorted(SMOKE_ARCHS):
        runs.append(serve_cell(torch, counters, name, "vmap",
                               SERVE_MODEL_ARGS))
    return _sum_launches(runs)


def compiled_path(torch, train, counters, lm_fp32, lm_bf16):
    """Phase 18: the compiled steps.  Returns the graphed runs' launches
    summed and the gemma3-1b figures per dtype."""
    t0 = time.perf_counter()
    runs, figs = [], {}
    for dtype, eager in ((torch.float32, lm_fp32), (torch.bfloat16, lm_bf16)):
        la, figs[str(dtype).replace("torch.", "")] = lm_compiled(
            torch, counters, dtype, eager)
        runs.append(la)
    runs.append(scale_compiled(torch, train, counters))
    t_loop = time.perf_counter()
    runs.append(loop_compiled(torch, train, counters))
    log(f"compiled loop-engine cells: {time.perf_counter() - t_loop:.1f} s")
    t_serve = time.perf_counter()
    runs.append(serve_compiled(torch, counters))
    log(f"compiled serving cells: {time.perf_counter() - t_serve:.1f} s")
    log(f"compiled phase: {time.perf_counter() - t0:.1f} s")
    return _sum_launches(runs), figs


# phase 20: the client-sharded scale round.  (a) phase 5's cell on a world
# of one NCCL rank (mesh 1x1); (b) K=8 (a batch of 8, which every client of
# the 8-way split holds) on four gloo ranks sharing the card, meshes 4x1
# and 2x2, ``ordered``.  Each (b) mesh is held bit for bit to the unsharded
# K=8 run
MESH_A_SHAPE = "1x1"
MESH_B_ARGS = SCALE_ARGS + ["--clients", "8", "--batch-size", "8",
                            "--scale-reduction", "ordered"]
MESH_B_SHAPES = ("4x1", "2x2")
MESH_B_WORLD = 4
MESH_CHILD_TIMEOUT_S = 400
MESH_DIR = os.path.join(ROOT, "runs", "chip_smoke_mesh")


def _mesh_dims(shape):
    return [int(x) for x in shape.split("x")]


def _cpu_state(torch, engine):
    """The engine's whole stacked state as CPU tensors (meshed: gathered)."""
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda x: x.detach().cpu(), engine._full_state())


def _state_cmp(torch, a, b):
    """(bit-equal, max abs parameter difference, mask entries that differ)
    of two stacked states; bits compare each float32 leaf as int32, so
    -0.0 is not 0.0."""
    from repro_torch.utils.tree import tree_leaves_with_path
    la, lb = dict(tree_leaves_with_path(a)), dict(tree_leaves_with_path(b))
    if la.keys() != lb.keys():
        raise AssertionError("states differ in structure")
    same, diff, flips = True, 0.0, 0
    for p, x in la.items():
        y = lb[p]
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{p}: {x.shape} {x.dtype} vs {y.shape} "
                                 f"{y.dtype}")
        same &= torch.equal(x.view(torch.int32), y.view(torch.int32))
        if p.startswith("masks"):
            flips += int((x != y).sum())
        else:
            diff = max(diff, float((x - y).abs().max()))
    return same, diff, flips


def _mesh_run(torch, train, counters, argv, card, label):
    """``simulate`` ``argv`` through the CLI's entry functions (a meshed
    run's world already up).
    Returns the summary, the launches, the engine's figures and its final
    state on the CPU; the engine's graphs are released."""
    import gc
    args = train.parse_args(argv)
    engine = train.build_engine(args)
    _zero(counters)
    out = train.run_engine(args, engine)
    launches = _launches(counters)
    figs = {"round_wall_s": out["round_wall_s"], "phase_s": out["phase_s"],
            "step_compiles": engine.step_compiles, "capture": engine.capture,
            "gather_bytes": engine.gather_bytes,
            "gossip_avg_f32": launches["gossip_avg_f32"]}
    log(f"mesh {label}: capture {engine.capture}, step_compiles "
        f"{engine.step_compiles}, round walls {out['round_wall_s']} s, "
        f"gossip_avg_f32 launches {launches['gossip_avg_f32']} ({card})")
    state = _cpu_state(torch, engine)
    steps = engine._round_step
    for g in steps if isinstance(steps, tuple) else (steps,):
        g.release()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches, figs, state


def mesh_path(torch, train, counters, card):
    """Phase 20 (a), then (b).  Returns the launches of the meshed runs:
    (a)'s and every (b) rank's, summed."""
    import shutil

    import torch.distributed as dist
    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    runs = []
    # (a) a world of one NCCL rank: ``--mesh-shape 1x1`` starts it here;
    # both reductions from one archive
    start = os.path.join(MESH_DIR, "a-start.npz")
    train.build_engine(train.parse_args(SCALE_ARGS)).save(start)
    for reduction in ("ordered", "einsum"):
        base = SCALE_ARGS + ["--scale-reduction", reduction]
        plain, _, _, plain_state = _mesh_run(
            torch, train, counters, base + ["--resume", start], card,
            f"(a) {reduction} unsharded")
        meshed, la, figs, state = _mesh_run(
            torch, train, counters,
            base + ["--mesh-shape", MESH_A_SHAPE, "--resume", start], card,
            f"(a) {reduction} {MESH_A_SHAPE}")
        runs.append(la)
        if (figs["capture"] != "whole" or figs["step_compiles"] != 1
                or meshed["mesh"]["backend"] != "nccl"):
            raise AssertionError(f"(a) {reduction}: {figs} {meshed['mesh']}")
        same, diff, flips = _state_cmp(torch, plain_state, state)
        log(f"mesh (a) {reduction}: {MESH_A_SHAPE} NCCL world of one vs "
            f"unsharded: bit-equal {same}, max abs param diff {diff}, mask "
            f"entries differing {flips}; round walls "
            f"{meshed['round_wall_s']} s vs {plain['round_wall_s']} s "
            f"({card})")
        if reduction == "ordered" and not same:
            raise AssertionError("(a) ordered: not bit-equal to unsharded")
        if diff > SCALE_EINSUM_ATOL or flips:
            raise AssertionError(f"(a) {reduction}: {diff} > "
                                 f"{SCALE_EINSUM_ATOL}")
        if (meshed["comm"], meshed["acc_history"]) != (
                plain["comm"], plain["acc_history"]) and same:
            raise AssertionError(f"(a) {reduction}: rows differ")
    dist.destroy_process_group()
    log(f"mesh (a): {time.perf_counter() - t0:.1f} s ({card})")

    # (b) the unsharded K=8 run here, then the four gloo ranks
    t_b = time.perf_counter()
    start = os.path.join(MESH_DIR, "b-start.npz")
    b_args = train.parse_args(MESH_B_ARGS)
    train.build_engine(b_args).save(start)
    k = b_args.clients
    plain = _mesh_run(torch, train, counters, MESH_B_ARGS + [
        "--resume", start], card, f"(b) unsharded K={k}")
    procs = []
    store = os.path.join(MESH_DIR, "store")
    for rank in range(MESH_B_WORLD):
        err = open(os.path.join(MESH_DIR, f"rank{rank}.err"), "w")
        outf = open(os.path.join(MESH_DIR, f"rank{rank}.out"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-child",
             str(rank), str(MESH_B_WORLD), store, start, MESH_DIR],
            stdout=outf, stderr=err, cwd=ROOT), err, outf))
    failed = _wait_children(procs, MESH_CHILD_TIMEOUT_S)
    if failed:
        for rank, code in failed:
            with open(os.path.join(MESH_DIR, f"rank{rank}.err")) as f:
                tail = f.read()[-3000:]
            log(f"mesh (b) rank {rank} exited {code}; stderr tail:\n{tail}")
        raise AssertionError(f"mesh (b): ranks failed: {failed}")
    log(f"mesh (b): four gloo ranks sharing the card, "
        f"{time.perf_counter() - t_b:.1f} s with the unsharded run ({card})")
    for shape in MESH_B_SHAPES:
        k_local = k // _mesh_dims(shape)[0]
        for rank in range(MESH_B_WORLD):
            with open(os.path.join(MESH_DIR, f"rank{rank}-{shape}.json")) as f:
                r = json.load(f)
            runs.append(r["launches"])
            # a graphed run counts its first round's eager warm-up too
            per_round = r["gossip_avg_f32"] / (len(r["round_wall_s"]) + 1)
            log(f"mesh (b) {shape} rank {rank}: clients {r['k0']}:{r['k1']}, "
                f"capture {r['capture']}, step_compiles {r['step_compiles']}, "
                f"round walls {r['round_wall_s']} s, gather "
                f"{[p['gather'] for p in r['phase_s']]} s and "
                f"{r['gather_bytes']} bytes a round, gossip_avg_f32 launches "
                f"{r['gossip_avg_f32']} ({per_round:g} a round) ({card})")
            if (r["capture"] != "segments" or r["step_compiles"] != 1
                    or per_round != k_local * r["n_leaves"]):
                raise AssertionError(f"mesh (b) {shape} rank {rank}: {r}")
            if rank == 0:
                rows = (r["acc_history"], r["comm"])
        check = train.build_engine(b_args).restore(
            os.path.join(MESH_DIR, f"b-{shape}.npz"))
        got = _cpu_state(torch, check)
        del check
        same = _state_cmp(torch, plain[3], got)[0]
        log(f"mesh (b) {shape}: bit-equal to unsharded K={k}: {same}")
        if not same or rows != (plain[0]["acc_history"], plain[0]["comm"]):
            raise AssertionError(f"mesh (b) {shape}: not bit-equal to the "
                                 f"unsharded K={k} run")
    shutil.rmtree(MESH_DIR, ignore_errors=True)     # ~3 GB of archives
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s ({card})")
    return _sum_launches(runs)


# phase 21: the LM steps over a DeviceMesh, split over 'model' by
# tensor parallelism (sharding.tp).  (a) gemma3-1b at its published width,
# fp32, on a world of one NCCL rank (mesh 1x1: every collective of size 1),
# one 1024-token row a client as phase 14's plan: the placed train, prefill
# and decode steps held bit for bit to the unsharded steps; (b) four gloo
# ranks sharing the card: the qwen3-8b smoke arch on meshes 2x2 (K=2 of 2
# rows by plan_for; its 4 q and 2 kv heads split whole over 'model' of 2)
# and 1x4 (K=1 of 4 rows; one q head a rank, the k/v columns cut a kv head
# and are gathered), the deepseek-moe-16b (experts split) and mamba2-1.3b
# (SSM projections, conv channels and scan heads split) smoke archs and
# jamba's FSDP2D plan (weights' 'data' shards gathered before use, the
# rows split over 'data', gradients reduce-scattered there) on 2x2: the
# train step (einsum, ppermute), prefill and decode (on a random cache at
# its placements) within fp32 rounding of the unsharded steps; then the
# long-context decode of one row (seq_data: the cache's 64 positions in
# two chunks of 32 over 'data') of the gemma3-1b and jamba smoke archs at
# 2x2, a position in each chunk, gemma3's 16-wide window crossing the
# chunk edge at one; each rank's collectives by kind, none sending a
# 'model'-sharded weight's shard to gather it whole, nor a cache leaf's
# shard nor an FSDP2D batch's rows, and no step naming an input gathered
# whole; (c) the dry run's multi-pod records (gemma3-1b train_4k,
# einsum and ppermute; qwen3-8b train_4k; jamba decode_32k, its cache and
# batch rows split), traced by phase 17's background process after its
# sweep, rank 0's FLOPs beside the parent tree's ("tp": false: a rank
# computed whole clients; for jamba, the parent tree's record, which
# gathered its cache and batch whole)
STEPS_A_ARCH = "gemma3-1b"
STEPS_SEQ = 1024
# (b): each mesh (data, model) and the smoke archs run on it
STEPS_B_CASES = (((2, 2), ("qwen3-8b", "deepseek-moe-16b", "mamba2-1.3b",
                           "jamba-1.5-large-398b")),
                 ((1, 4), ("qwen3-8b",)))
# planned as plan_for plans the published arch: one client, weights 2-D
# sharded (FSDP over 'data' + 'model')
STEPS_B_FSDP2D = ("jamba-1.5-large-398b",)
STEPS_B_SEQ, STEPS_B_BATCH = 64, 4
STEPS_B_WORLD = 4
# (b): the rank-case run again with its models under remat "full", against
# its remat=False twin: (data, model), arch, gossip
STEPS_B_REMAT = ((2, 2), "qwen3-8b", "einsum")
# (b): the seq_data decode cases (one client of one row) at 2x2, and
# their decode positions: one in each of the cache's two chunks
STEPS_B_SEQ_DATA = ("gemma3-1b", "jamba-1.5-large-398b")
STEPS_B_SEQ_DATA_POS = (20, 40)
# the names an earlier tree's steps recorded for the inputs they gathered
# whole
STEPS_B_WHOLE = ("serve cache", "fsdp2d batch")
# (b): max|meshed - plain| <= STEPS_REL_TOL * max(1, max|plain|), the
# port's LM tests' criterion (a rank's matmuls take its K_local clients)
STEPS_REL_TOL = 1e-5
STEPS_CHILD_TIMEOUT_S = 300
# timed calls of each step and its unsharded twin, interleaved: median and
# range ((a); (b) one, it times smoke shapes within the script's budget)
STEPS_TIMED_CALLS = 3
STEPS_B_TIMED_CALLS = 1
STEPS_DIR = os.path.join(ROOT, "runs", "chip_smoke_steps")
# (c): the multi-pod records (arch, shape, gossip, --remat): each train
# record at the reference's default "full" and at "none", the program the
# parent trees' figures below were taken of
STEPS_DRYRUN = ([("gemma3-1b", "train_4k", g, r) for g in ("einsum", "ppermute")
                 for r in ("full", "none")]
                + [("qwen3-8b", "train_4k", "einsum", r)
                   for r in ("full", "none")]
                + [("jamba-1.5-large-398b", "decode_32k", "einsum", "full")])
# rank 0's FLOPs of the parent tree's multi-pod records ("tp": false), by
# (arch, shape, gossip): tools/mesh_dryrun_flops.py --src <parent's src>,
# as PERF.md records them
PARENT_TP_FALSE_FLOPS = {
    ("gemma3-1b", "train_4k", "einsum"): 221426165956608.0,
    ("gemma3-1b", "train_4k", "ppermute"): 221298189926400.0,
    ("qwen3-8b", "train_4k", "einsum"): 1726491395751936.0,
}
# qwen3-8b's 32 q heads split over 'model' of 16: rank 0's FLOPs at most
# 1.25/16 of the parent's
TP_FLOPS_SHARE = {"qwen3-8b": 1.25 / 16}
# rank 0's FLOPs and collective bytes of the parent tree's multi-pod jamba
# decode_32k record, whose ranks gathered the cache and the batch whole
# (tools/mesh_dryrun_flops.py --src <the parent's src>, as PERF.md records
# them): its rows now split over 'data' (FLOPs at most 1.25/16 of it) and
# its cache read where it lies (fewer collective bytes)
PARENT_WHOLE_INPUTS = {
    ("jamba-1.5-large-398b", "decode_32k", "einsum"): (1129769328640.0,
                                                       196260578048.0),
}


def _steps_inputs(torch, step, gen, init=None, pos=None):
    """A meshed step's arguments, the same global tensors on every rank
    (drawn from ``gen``): ``init`` params (else N(0, 0.05^2)) masked by 0/1
    int8 masks, tokens in the vocabulary, an all-ones adjacency, lr 0.1, a
    cache ~ N(0, 1) (zero with ``init``: (a)'s prefill), decode positions
    ``pos`` or near the cache's end."""
    from repro_torch.launch.dryrun import materialize
    from repro_torch.utils.tree import tree_map
    dev = gen.device
    args = list(materialize(step.args, step.plan.arch.vocab, dev, gen))
    if init is not None:
        args[0] = init
    elif step.mode != "train":
        args[0] = tree_map(lambda w: w * 0.05, args[0])
    if step.mode == "train":
        scale = 1.0 if init is not None else 0.05
        args[0] = tree_map(lambda w, m: w * scale * m.to(w.dtype), args[0],
                           args[1])
        args[3] = torch.ones_like(args[3])
        args[4] = 0.1
    else:
        if init is not None:
            args[2] = tree_map(torch.zeros_like, args[2])
        if step.mode == "decode":
            k = step.plan.n_clients
            args[1]["pos"] = (torch.tensor(pos, dtype=torch.int32,
                                           device=dev) if pos is not None
                              else torch.arange(
                step.plan.max_cache_len - k, step.plan.max_cache_len,
                dtype=torch.int32, device=dev))
    return args


def _steps_plain(steps, api, plan, gossip):
    import dataclasses
    single = dataclasses.replace(plan, mesh=None)
    if plan.shape.mode == "train":
        return steps.make_train_step(api, single, gossip)
    return (steps.make_prefill_step if plan.shape.mode == "prefill"
            else steps.make_decode_step)(api, single)


def _steps_cmp(torch, got, want):
    """(bit-equal, max abs difference, max |want|, every value finite)
    between a meshed step's outputs (``DTensor``s, gathered whole) and the
    plain step's."""
    from repro_torch.launch.steps import gather_shards
    from repro_torch.utils.tree import tree_leaves
    same, diff, scale, finite = True, 0.0, 0.0, True
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a = gather_shards(a)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{a.shape} {a.dtype} vs {b.shape} "
                                 f"{b.dtype}")
        if a.is_floating_point():
            same &= torch.equal(a.view(torch.int32) if a.element_size() == 4
                                else a, b.view(torch.int32)
                                if b.element_size() == 4 else b)
            diff = max(diff, float((a.double() - b.double()).abs().max()))
            scale = max(scale, float(b.double().abs().max()))
            finite &= bool(torch.isfinite(a).all())
        else:
            same &= torch.equal(a, b)
    return same, diff, scale, finite


def _steps_case(torch, steps, api, plan, gossip, args, calls):
    """The meshed step and the plain one on ``args``: the plain step once
    to warm, the meshed step's first call counted (its collectives and
    notes) as its warm-up, then ``calls`` timed calls of each,
    interleaved (synchronised); returns the meshed outputs of the counted
    call, the plain ones, each one's sorted seconds, that call's
    collectives, this rank's clients ``(k0,
    k1)``, the all-gathers over 'model' that sent a 'model'-sharded weight
    leaf's shard (``weight_shard_gathers`` of
    ``tests/_torch_mesh_steps_world.py``: none, where no weight is gathered
    whole), the all-gathers that sent a shard of a cache or batch leaf
    (``input_shard_gathers``: none, where no input is gathered whole) and
    the ops it noted as replicated."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_mesh_steps_world import (
        SentSums,
        input_shard_gathers,
        weight_shard_gathers,
    )

    from repro_torch.sharding.tp import record_replicated
    from repro_torch.utils.tree import tree_leaves, tree_map
    step = (steps.lower_train(api, plan, gossip) if plan.shape.mode == "train"
            else steps.lower_serve(api, plan))
    plain = _steps_plain(steps, api, plan, gossip)
    placed = step.place(*args)
    clone = [tree_map(torch.clone, a) if not isinstance(a, float) else a
             for a in args]
    fns = (("plain", plain, clone), ("meshed", step, placed))
    times = {name: [] for name, _, _ in fns}
    plain(*clone)
    counter = SentSums()
    with counter, record_replicated() as rep:
        got = step(*placed)
    for _ in range(calls):
        for name, fn, a in fns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            if name == "plain":
                want = out
            del out
    times = {name: sorted(t) for name, t in times.items()}
    gathers = []
    if counter.sent:
        gathers = weight_shard_gathers(counter.sent, placed[0], args[0],
                                       *_steps_mixed(plan, gossip, args))
    train = plan.shape.mode == "train"
    inputs = input_shard_gathers(counter.sent_all,
                                 *(placed[2:3] if train else placed[1:3]))
    return (got, want, times, counter.stats,
            steps.client_range(tree_leaves(placed[0])[0]), gathers, inputs,
            sorted(rep))


def _steps_mixed(plan, gossip, args):
    """A train step's params after its gossip on the whole stack (what its
    models read), for ``weight_shard_gathers``; none for serve steps."""
    from repro_torch.launch.gossip_opt import ppermute_gossip
    from repro_torch.scale.stacked import masked_gossip_stacked
    if plan.shape.mode != "train":
        return []
    if gossip == "ppermute":
        return [ppermute_gossip(args[0], args[1])]
    return [masked_gossip_stacked(args[0], args[1], args[3],
                                  reduction="einsum")]


def _median(xs):
    return xs[len(xs) // 2]


def _median_range(xs):
    """``xs`` (sorted seconds) as its median and range."""
    return f"median {_median(xs):.4f} s [{xs[0]:.4f}, {xs[-1]:.4f}]"


def steps_mesh_path(torch, counters, card, sweep):
    """Phase 21 (a), (b), then (c)'s records from ``sweep``.  Returns the
    launches of (a) and every (b) rank, summed."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import bind
    from repro_torch.utils.tree import tree_leaves, tree_map
    t0 = time.perf_counter()
    runs = []
    # (a) a world of one NCCL rank
    mesh = make_test_mesh(1, 1, device_type="cuda")
    cfg = ARCHS[STEPS_A_ARCH]
    api = bind(cfg, remat=False)
    gen = torch.Generator(device="cuda").manual_seed(21)
    init = api.init(gen, torch.float32)
    n_params = sum(x.numel() for x in tree_leaves(init))
    _zero(counters)
    cache = None
    for mode in ("train", "prefill", "decode"):
        plan = steps.plan_for(cfg, InputShape(f"mesh_{mode}", STEPS_SEQ, 1,
                                              mode), mesh, torch.float32)
        stacked = tree_map(lambda x: x.unsqueeze(0), init)
        step = (steps.lower_train(api, plan, "einsum") if mode == "train"
                else steps.lower_serve(api, plan))
        args = _steps_inputs(torch, step, gen, init=stacked)
        if mode == "decode" and cache is not None:
            args[2] = cache
        got, want, times, stats, _, _, _, _ = _steps_case(
            torch, steps, api, plan, "einsum", args, STEPS_TIMED_CALLS)
        same, diff, scale, finite = _steps_cmp(torch, got, want)
        remat_note = ""
        if mode == "train":
            # the same meshed step, its models under remat "full"
            full = steps.lower_train(bind(cfg), plan, "einsum")
            same_full = _steps_cmp(torch, full(*full.place(*args)),
                                   tree_map(steps.gather_shards, got))[0]
            remat_note = f"; under remat full bit-equal {same_full}"
            if not same_full:
                raise AssertionError("mesh steps (a) train: remat full not "
                                     "bit-equal to remat=False")
        if mode == "prefill":
            cache = tree_map(steps.gather_shards, got[1])
        log(f"mesh steps (a) {STEPS_A_ARCH} {mode} ({n_params} params, fp32, "
            f"K={plan.n_clients} x {plan.per_client_batch} x {STEPS_SEQ}, "
            f"fsdp2d {plan.fsdp2d}) 1x1 NCCL, tensor-parallel path, vs "
            f"unsharded: "
            f"bit-equal {same}, max abs diff {diff}, finite {finite}; "
            f"{_median_range(times['meshed'])} vs unsharded "
            f"{_median_range(times['plain'])} ({STEPS_TIMED_CALLS} calls "
            f"each, interleaved), median ratio "
            f"{_median(times['meshed']) / _median(times['plain']):.4f}; "
            f"collectives {stats.row()}{remat_note} ({card})")
        if not (same and finite):
            raise AssertionError(f"mesh steps (a) {mode}: not bit-equal")
        del got, want, args, stacked
        torch.cuda.empty_cache()
    runs.append(_launches(counters))
    del init
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"mesh steps (a): {time.perf_counter() - t0:.1f} s ({card})")

    # (b) four gloo ranks sharing the card
    t_b = time.perf_counter()
    shutil.rmtree(STEPS_DIR, ignore_errors=True)
    os.makedirs(STEPS_DIR)
    store = os.path.join(STEPS_DIR, "store")
    procs = []
    for rank in range(STEPS_B_WORLD):
        err = open(os.path.join(STEPS_DIR, f"rank{rank}.err"), "w")
        outf = open(os.path.join(STEPS_DIR, f"rank{rank}.out"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--steps-child",
             str(rank), str(STEPS_B_WORLD), store, STEPS_DIR],
            stdout=outf, stderr=err, cwd=ROOT), err, outf))
    failed = _wait_children(procs, STEPS_CHILD_TIMEOUT_S)
    if failed:
        for rank, code in failed:
            with open(os.path.join(STEPS_DIR, f"rank{rank}.err")) as f:
                tail = f.read()[-3000:]
            log(f"mesh steps (b) rank {rank} exited {code}; stderr tail:\n"
                f"{tail}")
        raise AssertionError(f"mesh steps (b): ranks failed: {failed}")
    bad = []
    for rank in range(STEPS_B_WORLD):
        with open(os.path.join(STEPS_DIR, f"rank{rank}.json")) as f:
            r = json.load(f)
        runs.append(r["launches"])
        rc = r["remat"]
        full, none = (rc["axis_counts"]["full"], rc["axis_counts"]["none"])
        log(f"mesh steps (b) {rc['case']} rank {rank} under remat full: "
            f"bit-equal to remat=False {rc['bit_equal']}; collectives by "
            f"axis {full} against {none} ({card})")
        if not (rc["bit_equal"] and set(full) == set(none)
                and all(full[k] >= none[k] for k in none)
                and full.get("all-reduce/model", 0)
                > none.get("all-reduce/model", 0)):
            bad.append((rank, rc["case"] + " remat full"))
        for case, c in r["cases"].items():
            fsdp2d_train = case.startswith("2x2 jamba") and "train" in case
            ok = (c["max_abs"] <= STEPS_REL_TOL * max(1.0, c["scale"])
                  and c["finite"] and not c["weight_gathers"]
                  and not c["input_gathers"] and not c["whole"]
                  and c["model_counts"].get("all-reduce", 0) > 0
                  and (not fsdp2d_train
                       or c["axis_counts"].get("reduce-scatter/data", 0)))
            log(f"mesh steps (b) {case} rank {rank}: clients "
                f"{c['clients']}, max abs diff {c['max_abs']} (scale "
                f"{c['scale']}), finite {c['finite']}, "
                f"{_median_range(c['seconds']['meshed'])} vs unsharded "
                f"{_median_range(c['seconds']['plain'])}; collectives "
                f"{c['collectives']}, by axis {c['axis_counts']}, "
                f"'model'-sharded weights gathered whole: "
                f"{len(c['weight_gathers'])}, cache or batch shards "
                f"all-gathered: {len(c['input_gathers'])}, left replicated "
                f"{c['replicated']} ({card})")
            if not ok:
                bad.append((rank, case))
    if bad:
        raise AssertionError(f"mesh steps (b): outside fp32 rounding, a "
                             f"weight, cache or batch shard gathered, no "
                             f"all-reduce over 'model', an input named as "
                             f"gathered whole or no reduce-scatter over "
                             f"'data' in jamba's train step: {bad}")
    log(f"mesh steps (b): four gloo ranks sharing the card, "
        + ", ".join(f"{d}x{m} {' '.join(archs)}"
                    for (d, m), archs in STEPS_B_CASES)
        + f", seq_data decode 2x2 {' '.join(STEPS_B_SEQ_DATA)} at "
        f"{STEPS_B_SEQ_DATA_POS}, {time.perf_counter() - t_b:.1f} s "
        f"({card})")
    shutil.rmtree(STEPS_DIR, ignore_errors=True)

    # (c) the multi-pod dry run, traced beside phases 15 and 4-12; a train
    # record under remat "full" against its "none" twin, the others
    # against the parent trees' figures
    twins = {(r["arch"], r["shape"], r["gossip"]): r
             for r in sweep.mesh_records if r.get("remat") == "none"}
    for rec in sweep.mesh_records:
        key = (rec["arch"], rec["shape"], rec["gossip"])
        twin = twins.get(key) if rec.get("remat") == "full" else None
        parent, parent_coll = (None, None) if twin else \
            PARENT_WHOLE_INPUTS.get(key, (PARENT_TP_FALSE_FLOPS.get(key),
                                          None))
        flops = rec.get("cost", {}).get("flops")
        log(f"mesh steps (c) {rec['tag']}: {rec['status']}, chips "
            f"{rec.get('chips')}, K {rec.get('n_clients')} x "
            f"{rec.get('per_client_batch')}, tp {rec.get('tp')}, left "
            f"replicated {rec.get('replicated')}, rank 0's FLOPs {flops} "
            f"(the parent's record {parent}: "
            f"{flops / parent if flops and parent else None} of it), peak "
            f"{rec.get('peak_live_bytes')} bytes, fits {rec.get('fits')}, "
            f"trace {rec.get('trace_s')} s, coll "
            f"{rec.get('coll_bytes_per_device')} bytes/rank "
            f"{rec.get('collectives')}, roofline {rec.get('roofline')}")
        if (rec["status"] != "ok" or not rec["coll_bytes_per_device"] > 0
                or rec["tp"] is not True):
            raise AssertionError(f"mesh steps (c): {rec['tag']}")
        if twin:
            log(f"mesh steps (c) {rec['tag']} against remat none: FLOPs "
                f"{flops / twin['cost']['flops']:.6f}x, peak "
                f"{rec['peak_live_bytes'] / twin['peak_live_bytes']:.4f}x, "
                f"collective bytes "
                f"{rec['coll_bytes_per_device'] / twin['coll_bytes_per_device']:.4f}x")
            if not (flops > twin["cost"]["flops"] and rec[
                    "coll_bytes_per_device"] >= twin["coll_bytes_per_device"]):
                raise AssertionError(f"mesh steps (c): {rec['tag']}: remat "
                                     f"full not above its none twin's FLOPs "
                                     f"and collective bytes")
        share = TP_FLOPS_SHARE.get(rec["arch"], 1.25 / 16 if parent_coll
                                   else None)
        if parent_coll and not rec["coll_bytes_per_device"] < parent_coll:
            raise AssertionError(f"mesh steps (c): {rec['tag']}: "
                                 f"{rec['coll_bytes_per_device']} collective "
                                 f"bytes a rank, not below the parent's "
                                 f"{parent_coll}")
        if parent and share and flops > share * parent:
            raise AssertionError(f"mesh steps (c): {rec['tag']}: rank 0's "
                                 f"FLOPs {flops} above {share} of the "
                                 f"parent's {parent}")
        if rec["gossip"] == "ppermute" and not rec["collectives"][
                "counts"].get("collective-permute"):
            raise AssertionError(f"mesh steps (c): {rec['tag']}: no ring")
    log(f"mesh steps phase: {time.perf_counter() - t0:.1f} s ({card})")
    return _sum_launches(runs)


def _wait_children(procs, timeout_s):
    """Waits for the child processes ``(proc, err, out)`` until a shared
    deadline, kills any left, closes their files; returns the ranks that
    failed, with their exit codes."""
    failed = []
    deadline = time.time() + timeout_s
    try:
        for rank, (proc, err, outf) in enumerate(procs):
            try:
                code = proc.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                code = "timeout"
            if code != 0:
                failed.append((rank, code))
    finally:
        for proc, err, outf in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
            outf.close()
    return failed


def steps_child(argv):
    """One rank of phase 21 (b): a gloo world over a file store, each
    ``STEPS_B_CASES`` mesh and arch on the card; each step meshed and
    unsharded on the same inputs.  Writes ``rank<r>.json``."""
    import dataclasses
    import faulthandler
    import itertools
    faulthandler.enable()       # a crash in a collective prints its stack
    rank, world, store, out_dir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.join(ROOT, "src"))

    import torch
    import torch.distributed as dist

    from repro_torch.configs import INPUT_SHAPES, SMOKE_ARCHS
    from repro_torch.device import setup_device
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.kernels import masked_matmul as mmk
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.kernels import prune_regrow as pr
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import bind
    setup_device("cuda")
    torch.cuda.set_device(0)    # every rank shares the one card
    counters = (ga, pa, mmk, pr)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    # (label, plan, gossip, decode positions) of every case, in order
    runs = []
    for (data, model), archs in STEPS_B_CASES:
        mesh = make_test_mesh(data, model, device_type="cuda",
                              backend="gloo")
        for arch, (mode, name) in itertools.product(archs, (
                ("train", "train_4k"), ("prefill", "prefill_32k"),
                ("decode", "decode_32k"))):
            shape = dataclasses.replace(INPUT_SHAPES[name],
                                        seq_len=STEPS_B_SEQ,
                                        global_batch=STEPS_B_BATCH)
            plan = steps.plan_for(SMOKE_ARCHS[arch], shape, mesh,
                                  torch.float32)
            if arch in STEPS_B_FSDP2D:
                plan = dataclasses.replace(plan, n_clients=1,
                                           per_client_batch=STEPS_B_BATCH,
                                           fsdp2d=True)
            for gossip in (("einsum", "ppermute") if mode == "train" else
                           ("einsum",)):
                case = f"{mode}-{gossip}" if mode == "train" else mode
                runs.append((f"{data}x{model} {arch} {case}", plan, gossip,
                             None))
        if (data, model) == (2, 2):
            shape = dataclasses.replace(INPUT_SHAPES["long_500k"],
                                        seq_len=STEPS_B_SEQ, global_batch=1)
            for arch in STEPS_B_SEQ_DATA:
                plan = dataclasses.replace(steps.plan_for(
                    SMOKE_ARCHS[arch], shape, mesh, torch.float32),
                    seq_data=True)
                for pos in STEPS_B_SEQ_DATA_POS:
                    runs.append((f"2x2 {arch} seq_data decode pos {pos}",
                                 plan, "einsum", [pos]))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_mesh_steps_world import axis_counts, model_counts

    from repro_torch.utils.collectives import CollectiveCounter
    from repro_torch.utils.tree import tree_map
    cases = {}
    _zero(counters)
    for label, plan, gossip, pos in runs:
        api = bind(plan.arch, remat=False)
        gen = torch.Generator(device="cuda").manual_seed(len(cases))
        step = (steps.lower_train(api, plan, gossip)
                if plan.shape.mode == "train" else steps.lower_serve(api, plan))
        args = _steps_inputs(torch, step, gen, pos=pos)
        print(f"rank {rank}: {label}", flush=True)
        (got, want, times, stats, (k0, k1), gathers, inputs,
         replicated) = _steps_case(torch, steps, api, plan, gossip, args,
                                   STEPS_B_TIMED_CALLS)
        same, diff, scale, finite = _steps_cmp(torch, got, want)
        cases[label] = {
            "clients": f"{k0}:{k1} of {plan.n_clients} x "
                       f"{plan.per_client_batch}",
            "bit_equal": same, "max_abs": diff, "scale": scale,
            "finite": finite, "seconds": times,
            "collectives": stats.row(), "model_counts": model_counts(stats),
            "axis_counts": axis_counts(stats), "weight_gathers": gathers,
            "input_gathers": inputs, "replicated": replicated,
            # an input named as gathered whole (none is)
            "whole": sorted(set(replicated) & set(STEPS_B_WHOLE))}
        del got, want, args, step
    # one rank-case again, its models under remat "full" (the recompute in
    # the backward on autograd's device thread issues the blocks'
    # collectives again), against its remat=False twin on the same inputs
    (data, model), arch, gossip = STEPS_B_REMAT
    mesh = make_test_mesh(data, model, device_type="cuda", backend="gloo")
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=STEPS_B_SEQ,
                                global_batch=STEPS_B_BATCH)
    plan = steps.plan_for(SMOKE_ARCHS[arch], shape, mesh, torch.float32)
    outs, remat_counts = {}, {}
    for name, remat in (("none", False), ("full", True)):
        step = steps.lower_train(bind(plan.arch, remat=remat), plan, gossip)
        args = _steps_inputs(torch, step,
                             torch.Generator(device="cuda").manual_seed(99))
        counter = CollectiveCounter()
        with counter:
            outs[name] = step(*step.place(*args))
        remat_counts[name] = axis_counts(counter.stats)
    remat_case = {"case": f"{data}x{model} {arch} train-{gossip}",
                  "bit_equal": _steps_cmp(
                      torch, outs["full"],
                      tree_map(steps.gather_shards, outs["none"]))[0],
                  "axis_counts": remat_counts}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"cases": cases, "remat": remat_case,
                   "launches": _launches(counters)}, f)
    dist.destroy_process_group()
    return 0


def mesh_child(argv):
    """One rank of phase 20 (b): a gloo world over a file store, each
    ``MESH_B_SHAPES`` mesh through the CLI's entry functions from
    ``start``; rank 0 writes each mesh's final archive.  Writes its
    figures as ``rank<r>-<shape>.json``."""
    rank, world, store, start, out_dir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.device import setup_device
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.kernels import masked_matmul as mmk
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.kernels import prune_regrow as pr
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_leaves
    setup_device("cuda")
    counters = (ga, pa, mmk, pr)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    for shape in MESH_B_SHAPES:
        args = train.parse_args(MESH_B_ARGS + [
            "--mesh-shape", shape, "--resume", start])
        engine = train.build_engine(args)
        _zero(counters)
        out = train.run_engine(args, engine)
        launches = _launches(counters)
        engine.save(os.path.join(out_dir, f"b-{shape}.npz"))
        figs = {"k0": engine.shard.k0, "k1": engine.shard.k1,
                "capture": engine.capture,
                "step_compiles": engine.step_compiles,
                "round_wall_s": out["round_wall_s"],
                "phase_s": out["phase_s"],
                "acc_history": out["acc_history"], "comm": out["comm"],
                "gather_bytes": engine.gather_bytes,
                "gossip_avg_f32": launches["gossip_avg_f32"],
                "n_leaves": len(tree_leaves(engine.state["params"])),
                "launches": launches}
        with open(os.path.join(out_dir, f"rank{rank}-{shape}.json"),
                  "w") as f:
            json.dump(figs, f)
        for g in engine._round_step:
            g.release()
        del engine
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--steps-child"]:
        sys.exit(steps_child(sys.argv[2:]))
    sys.exit(main())
