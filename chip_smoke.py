#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on the GPU.

    python3 chip_smoke.py            # from the repo root, on a machine with one CUDA GPU

Phases, each failing hard (an exception means a non-zero exit and no final
line):

1. the card's name and power limit (``nvidia-smi``);
2. the CUDA kernels built from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel), with the build time;
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
   (``time.perf_counter`` over many calls with no synchronise), and for the
   masked matmul its library call's
   (``torch.bmm``, ``torch.mm``) device time beside that call's time;
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
   must launch the masked matmul 3 x (batches + 1 warmup) times, match
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
    to the loop engine's; params against the vmap ``RoundEngine`` run,
    whose local phase is the same: ``ordered`` bit-equal, ``einsum``
    within ``SCALE_EINSUM_ATOL``; against an ``--exec loop`` run within
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
    same width on the card, and within ``SERVE_CPU_TOL`` (max abs) of the
    same store served on the CPU; its service time, p50/p99 latency and
    ``bytes_at_rest``; (b) full published width: ``ArchModel(ARCHS[...],
    prompt_len=2048)`` for gemma3-1b and then mamba2-1.3b through
    ``ServeEngine`` (2 users drawn on a CUDA generator at density 0.5, 2
    slots, max batch 2, 8 requests, each model freed before the next) — the
    mixed batch bit-equal to each request served alone and finite; its
    parameter count, prefill ms per request and prompt tokens/s (CUDA
    events over the pool-wide forward), peak memory, ``bytes_at_rest``
    (equal to the frames' analytic size), and a profiled serving run's
    device busy share with its top three device kernels;
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
    steps' busy shares and top three kernels;
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
16. a ``{"kernels": [...]}`` line (``launches_strategies``: every kernel's
    launches summed over phase 12's ten runs, its async run and its two
    stacked runs; ``launches_serve_models``: over phase 13;
    ``launches_lm``: over phase 14 (a) and (b); ``launches_obs``: over
    phase 15's traced runs), then the last line
    ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, without a CUDA GPU or without the
repo's ``src/`` beside this file.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
BF16_REL_TOL = 2.0 ** -8        # one bf16 ulp, relative (expected: exact)
MM_TOL = dict(atol=1e-5, rtol=1e-5)   # masked matmul vs torch.matmul (fp32 order)
# vmap vs loop local phase on the card at ResNet18-GN width, where the loop
# on the card and on the CPU already differ by ~4.2e-4 (the CPU tests
# measure no gap at their width and hold vmap to the loop's bits)
VMAP_PARAM_ATOL = 1e-3
# Stacked dpsgd at ResNet18-GN, 2 rounds (H100 80GB HBM3, 700 W): the einsum
# mix against the vmap RoundEngine measured 1.12e-4; the stacked run against
# the card's loop 3.61e-3, 1.16 times the 3.11e-3 between the same loop run
# on the card and on the CPU.
SCALE_EINSUM_ATOL = 3e-4
LOOP_GAP_FACTOR = 2.0
SERVE_ARGS = ["--users", "1024", "--cache-size", "256", "--max-batch", "256",
              "--requests", "4096", "--rows", "4", "--density", "0.5"]
SERVE_MODEL_ARGS = ["--users", "4", "--density", "0.5", "--cache-size", "2",
                    "--max-batch", "4", "--requests", "16", "--rows", "1"]
# served outputs on the card against the same store served on the CPU, max
# abs difference (the tied-embedding logits reach ~190 at smoke width;
# H100 80GB HBM3, 700 W: 4.58e-5 at most)
SERVE_CPU_TOL = 1e-4
FULL_WIDTH_ARCHS = ("gemma3-1b", "mamba2-1.3b")
FULL_WIDTH_PROMPT = 2048
LM_ARGS = ["lm", "--clients", "2", "--rounds", "2", "--steps", "4", "--seq",
           "64", "--batch-size", "2", "--tokens-per-client", "4096"]
# the lm loop on the card against the same loop on the CPU from one state:
# relative loss difference (cuBLAS and MKL round each product differently)
LM_CPU_RTOL = 1e-4
LM_FULL_ARCH = "gemma3-1b"
LM_FULL_CLIENTS, LM_FULL_SEQ, LM_FULL_DECODE = 2, 1024, 16
# decoded logits against a teacher-forcing forward, relative to their scale
LM_DECODE_TOL = 1e-4
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


def device_ms(fn, iters=20):
    """Device time per call (the sum of every kernel the call launched),
    from a torch.profiler trace; None, with the reason printed, where the
    profiler records no device time.  ``cuda_ms`` above is the time per call
    as the caller sees it, host launch overhead included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if rows is None:
        return None
    total_us = sum(r[0] for r in rows)
    if total_us <= 0:
        log("  device time not measured: the profiler recorded no kernels")
        return None
    return total_us / 1e3 / iters


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


def bound(nbytes, nflops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nflops / FP32_FLOPS_PER_S * 1e3
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


def gossip_host(torch, ga, dev, j, n, gen):
    """Host microseconds per gossip call on J rows of a small leaf (where
    the device's share of a call is negligible, as on most of the main
    path's 62 leaves): the best of two timings."""
    m = (torch.rand((j, n), generator=gen, device=dev) < 0.5).float()
    ws, ms = list(torch.randn((j, n), generator=gen, device=dev) * m), list(m)
    runs = [host_us(lambda: ga.gossip_avg(ws, ms, ms[0])) for _ in range(2)]
    return {"J": j, "N": n, "host_us": min(runs), "runs": runs}


def prune_regrow_host(torch, pr, dev, k, n, gen):
    """Host microseconds per prune/regrow call on K rows of a small leaf
    (the device's share negligible, as on most of the LM mask update's
    leaves): the best of two timings."""
    m = (torch.rand((k, n), generator=gen, device=dev) < 0.5).float()
    w = torch.randn((k, n), generator=gen, device=dev) * m
    g = torch.randn((k, n), generator=gen, device=dev)
    th = pr.sort_thresholds(w, g, m, n // 4, n // 8)
    runs = [host_us(lambda: pr.prune_regrow_rows(w, g, m, th))
            for _ in range(2)]
    return {"K": k, "N": n, "host_us": min(runs), "runs": runs}


def check_fold(torch, pa, pack_bits, dev, n, alpha, gen):
    flags = torch.rand(n, generator=gen, device=dev) < 0.5
    words = pack_bits(flags)
    nnz = int(flags.sum())
    values = torch.randn(nnz, generator=gen, device=dev)
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
    b_ms, b_by = bound(16 * n + 4 * words.numel() + 4 * nnz, 3 * n)
    return {"N": n, "nnz": nnz, "alpha": alpha, "max_abs_err": err,
            "ms": ms_k, "device_ms": dev_k, "plain_ms": ms_p, "host_us": host,
            "bound_ms": b_ms, "bound_by": b_by}


def check_fold_rows(torch, pa, dev, k, n, alpha, gen):
    """The stacked fold of K payloads packed as the scale path packs them
    (``pack_stacked`` of masked rows at density 0.5), kernel vs plain, into
    non-zero accumulators."""
    from repro_torch.scale.stacked import pack_stacked
    m = (torch.rand((k, n), generator=gen, device=dev) < 0.5).float()
    w = torch.randn((k, n), generator=gen, device=dev) * m
    sp = pack_stacked({"w": w}, {"w": m})["w"]
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
    b_ms, b_by = bound(16 * k * n + 4 * sp.bitmap.numel() + 4 * nnz,
                       3 * k * n)
    return {"K": k, "N": n, "nnz": nnz, "alpha": alpha, "max_abs_err": err,
            "ms": ms_k, "device_ms": dev_k, "plain_ms": ms_p, "host_us": host,
            "bound_ms": b_ms, "bound_by": b_by}


def check_prune_regrow(torch, pr, dev, k, n, gen):
    """The prune/regrow apply on K rows at a round's counts (held density
    0.5, prune rate 0.25), thresholds by ``sort_thresholds``: kernel vs
    plain bit for bit, and the time of the two sorts beside it."""
    m = (torch.rand((k, n), generator=gen, device=dev) < 0.5).float()
    w = torch.randn((k, n), generator=gen, device=dev) * m
    g = torch.randn((k, n), generator=gen, device=dev)
    n_active = n // 2
    n_prune = math.ceil(0.25 * n_active)
    th = pr.sort_thresholds(w, g, m, n_active - n_prune, n_prune)
    got = pr.prune_regrow_rows(w, g, m, th)
    torch.cuda.synchronize()
    want = pr.prune_regrow_rows_plain(w, g, m, th)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not (torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32))):
        raise AssertionError(f"prune_regrow K={k} N={n}: kernel != plain "
                             f"(max abs err {err})")
    ms_k = cuda_ms(lambda: pr.prune_regrow_rows(w, g, m, th))
    dev_k = device_ms(lambda: pr.prune_regrow_rows(w, g, m, th))
    ms_p = cuda_ms(lambda: pr.prune_regrow_rows_plain(w, g, m, th))
    ms_sort = cuda_ms(lambda: pr.sort_thresholds(w, g, m, n_active - n_prune,
                                                 n_prune), iters=5)
    # w, g, m read once, new_m and new_w written once (the (K, 2)
    # thresholds are negligible); about eight comparisons a coordinate
    b_ms, b_by = bound(20 * k * n, 8 * k * n)
    return {"K": k, "N": n, "max_abs_err": err, "ms": ms_k,
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
            "plain_ms": cuda_ms(lambda: mmk.masked_matmul_plain(x, w, mask)),
            "host_us": host_us(lambda: mmk.masked_matmul(x, w, mask)),
            "library_ms": cuda_ms(lambda: torch.mm(x, wm)),
            "library_device_ms": device_ms(lambda: torch.mm(x, wm)),
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
        row["plain_ms"] = cuda_ms(
            lambda: mmk.batched_masked_matmul_plain(x, w, mask))
        row["host_us"] = host_us(lambda: mmk.batched_masked_matmul(x, w, mask))
        row["library_ms"] = cuda_ms(lambda: torch.bmm(x, wm))
        row["library_device_ms"] = device_ms(lambda: torch.bmm(x, wm))
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


def _ms(v):
    return "not measured" if v is None else f"{v} ms"


def _times(r):
    host = f", host {r['host_us']} us per call" if "host_us" in r else ""
    return (f"per call {r['ms']} ms, device {_ms(r['device_ms'])}, plain "
            f"{r['plain_ms']} ms, bound {r['bound_ms']} ms ({r['bound_by']})"
            f"{host}, max abs err {r['max_abs_err']}")


def _library(r, call):
    return (f", {call} per call {r['library_ms']} ms, device "
            f"{_ms(r['library_device_ms'])}")


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
            if "registers" in line or "spill" in line:
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
    for r in fold_rows:
        log(f"packed_accum N={r['N']} nnz={r['nnz']} alpha={r['alpha']}: "
            + _times(r))
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

    # 15. the observability plane, while no other engine is alive
    t_obs = time.perf_counter()
    obs_launches = obs_path(torch, train, counters)
    log(f"obs phase: {time.perf_counter() - t_obs:.1f} s; traced launches "
        f"{obs_launches}")

    # 4. the training path through the CLI's entry functions
    args = train.build_parser().parse_args([
        "simulate", "--model", "resnet18", "--hw", "32", "--clients", "4",
        "--rounds", "2", "--local-epochs", "1", "--samples-per-class", "20",
        "--exec", "loop"])
    engine = train.build_engine(args)
    budget_check = BudgetCheck()
    engine.callbacks.append(budget_check)
    for c in counters:
        c.LAUNCHES = 0
    out = train.run_engine(args, engine)
    launches = {"gossip_avg": ga.LAUNCHES, "packed_accum": pa.LAUNCHES,
                "masked_matmul": mmk.LAUNCHES}
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

    profile_round(torch, train, args)

    # 5. the stacked path through the CLI's entry functions, then both
    # stacked kernels on the engine's own state
    scale_runs = scale_path(torch, train, counters, out)
    scale_launches = scale_state_kernels(torch, scale_runs["ordered"][0])
    profile_round(torch, train, train.build_parser().parse_args(
        SCALE_ARGS + ["--scale-reduction", "ordered"]))

    # 6. a small round on the card against the same round on the CPU, on
    # the loop engine and on the stacked engine's ordered mix
    for engine_args in (["--exec", "loop"],
                        ["--scale", "--scale-reduction", "ordered"]):
        cross = cross_check(torch, train, engine_args)
        log(f"cuda vs cpu smallcnn round {' '.join(engine_args)}: {cross}")

    # 7. the serving path through the CLI's entry functions
    serve_launches = serve_path(torch, counters)
    profile_serve(torch)
    mm = mm_rows["serve"][1]          # the (128, 128) layer at serve shapes

    # 8.-11. the vmap local phase and the simulator, sync and async
    vmap_vs_loop(torch, train)
    sync_launches = sim_sync_path(torch, train, counters)
    async_launches, async_engine = sim_async_path(torch, train, counters)
    profile_async_round(torch, train)
    sim_checkpoint_path(torch, train, async_engine)

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

    # 13. the serving CLI's other families: smallcnn and the smoke archs,
    # then two archs at their published widths
    t_models = time.perf_counter()
    models_launches = serve_models_path(torch, counters)
    log(f"serve_models phase: {time.perf_counter() - t_models:.1f} s; "
        f"launches {models_launches}")

    # 14. LM training: the lm CLI on every decoder smoke arch, then the
    # step builders at gemma3-1b's published width
    t_lm = time.perf_counter()
    lm_launches = lm_path(torch, counters)
    log(f"lm phase: {time.perf_counter() - t_lm:.1f} s; launches "
        f"{lm_launches}")

    kernels = [
        {"name": "gossip_avg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gossip_avg.cu",
         "replaces": "src/repro/kernels/gossip_avg.py:37",
         "launches": launches["gossip_avg"],
         "launches_scale_ordered": scale_runs["ordered"][2]["gossip_avg"],
         "launches_sim_sync": sync_launches["gossip_avg"],
         "launches_sim_async": async_launches["gossip_avg"],
         "launches_strategies": strat_launches["gossip_avg"],
         "launches_serve_models": models_launches["gossip_avg"],
         "launches_lm": lm_launches["gossip_avg"],
         "launches_obs": obs_launches["gossip_avg"],
         "shape": f"J=4 N={n_leaf} float32",
         "max_abs_err": max(r["max_abs_err"] for r in gossip_rows),
         "ms": gossip_rows[0]["ms"], "device_ms": gossip_rows[0]["device_ms"],
         "plain_ms": gossip_rows[0]["plain_ms"],
         "bound_ms": gossip_rows[0]["bound_ms"],
         "host_us": g_host["host_us"],
         "bound_by": gossip_rows[0]["bound_by"], "library_ms": None},
        {"name": "packed_accum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/packed_accum.cu",
         "replaces": "src/repro/kernels/packed_accum.py:63",
         "launches": launches["packed_accum"],
         "launches_sim_sync": sync_launches["packed_accum"],
         "launches_sim_async": async_launches["packed_accum"],
         "launches_strategies": strat_launches["packed_accum"],
         "launches_serve_models": models_launches["packed_accum"],
         "launches_lm": lm_launches["packed_accum"],
         "launches_obs": obs_launches["packed_accum"],
         "shape": f"N={n_leaf} density 0.5 alpha 1",
         "max_abs_err": max(r["max_abs_err"] for r in fold_rows),
         "ms": fold_rows[0]["ms"], "device_ms": fold_rows[0]["device_ms"],
         "plain_ms": fold_rows[0]["plain_ms"],
         "host_us": fold_rows[0]["host_us"],
         "bound_ms": fold_rows[0]["bound_ms"],
         "bound_by": fold_rows[0]["bound_by"], "library_ms": None,
         "library_device_ms": None},
        {"name": "packed_accum_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/packed_accum.cu",
         "replaces": "src/repro/kernels/packed_accum.py:105",
         "launches": scale_launches["packed_accum_rows"],
         "launches_strategies": strat_launches["packed_accum_rows"],
         "launches_serve_models": models_launches["packed_accum_rows"],
         "launches_lm": lm_launches["packed_accum_rows"],
         "launches_obs": obs_launches["packed_accum_rows"],
         "shape": f"K=4 N={n_leaf} density 0.5 alpha 1",
         "max_abs_err": max(r["max_abs_err"] for r in rows_rows),
         "ms": rows_rows[0]["ms"], "device_ms": rows_rows[0]["device_ms"],
         "plain_ms": rows_rows[0]["plain_ms"],
         "host_us": rows_rows[0]["host_us"],
         "bound_ms": rows_rows[0]["bound_ms"],
         "bound_by": rows_rows[0]["bound_by"], "library_ms": None,
         "library_device_ms": None},
        {"name": "prune_regrow", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/prune_regrow.cu",
         "replaces": "src/repro/kernels/prune_regrow.py:44",
         "launches": scale_launches["prune_regrow"],
         "launches_strategies": strat_launches["prune_regrow"],
         "launches_serve_models": models_launches["prune_regrow"],
         "launches_lm": lm_launches["prune_regrow"],
         "launches_obs": obs_launches["prune_regrow"],
         "shape": f"K=4 N={n_leaf} float32",
         "max_abs_err": max(r["max_abs_err"] for r in pr_rows),
         "ms": pr_rows[0]["ms"], "device_ms": pr_rows[0]["device_ms"],
         "plain_ms": pr_rows[0]["plain_ms"], "sort_ms": pr_rows[0]["sort_ms"],
         "host_us": pr_host["host_us"],
         "bound_ms": pr_rows[0]["bound_ms"],
         "bound_by": pr_rows[0]["bound_by"], "library_ms": None},
        {"name": "masked_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul.py:131",
         "launches": serve_launches["masked_matmul"],
         "launches_strategies": strat_launches["masked_matmul"],
         "launches_serve_models": models_launches["masked_matmul"],
         "launches_lm": lm_launches["masked_matmul"],
         "launches_obs": obs_launches["masked_matmul"],
         "shape": f"U={mm['U']} M={mm['M']} K={mm['K']} N={mm['N']} "
                  f"density 0.5 float32",
         "max_abs_err": max(r["max_abs_err"] for rows in mm_rows.values()
                            for r in rows),
         "ms": mm["ms"], "device_ms": mm["device_ms"],
         "plain_ms": mm["plain_ms"], "host_us": mm["host_us"],
         "bound_ms": mm["bound_ms"], "bound_by": mm["bound_by"],
         "library_ms": mm["library_ms"],
         "library_device_ms": mm["library_device_ms"]},
        {"name": "masked_matmul_u1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul.py:64",
         "launches": serve_launches["masked_matmul_u1"],
         "launches_strategies": strat_launches["masked_matmul_u1"],
         "launches_serve_models": models_launches["masked_matmul_u1"],
         "launches_lm": lm_launches["masked_matmul_u1"],
         "launches_obs": obs_launches["masked_matmul_u1"],
         "shape": f"M={mm1['M']} K={mm1['K']} N={mm1['N']} density 0.2 "
                  f"float32",
         "max_abs_err": mm1["max_abs_err"],
         "ms": mm1["ms"], "device_ms": mm1["device_ms"],
         "plain_ms": mm1["plain_ms"], "host_us": mm1["host_us"],
         "bound_ms": mm1["bound_ms"], "bound_by": mm1["bound_by"],
         "library_ms": mm1["library_ms"],
         "library_device_ms": mm1["library_device_ms"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


SCALE_ARGS = ["simulate", "--scale", "--model", "resnet18", "--hw", "32",
              "--clients", "4", "--rounds", "2", "--local-epochs", "1",
              "--samples-per-class", "20"]


def scale_path(torch, train, counters, loop_out):
    """Phase 5: ``simulate --scale`` through the CLI's entry functions, once
    per reduction, launch counters zeroed just before each run and read
    just after; then both stacked kernels on the ordered run's own state.
    Returns the runs' summaries and launches and the kernels' rows."""
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.kernels import prune_regrow as pr
    runs = {}
    for reduction in ("ordered", "einsum"):
        args = train.build_parser().parse_args(
            SCALE_ARGS + ["--scale-reduction", reduction])
        engine = train.build_engine(args)
        budget_check = BudgetCheck()
        engine.callbacks.append(budget_check)
        for c in counters:
            c.LAUNCHES = 0
        pa.LAUNCHES_ROWS = 0
        out = train.run_engine(args, engine)
        launches = {"gossip_avg": ga.LAUNCHES, "packed_accum": pa.LAUNCHES,
                    "packed_accum_rows": pa.LAUNCHES_ROWS,
                    "prune_regrow": pr.LAUNCHES}
        log(f"scale --scale-reduction {reduction} launches: {launches}")
        want_gossip = (ga.LAUNCHES >= 1) if reduction == "ordered" else (
            ga.LAUNCHES == 0)
        if not want_gossip:
            raise AssertionError(f"{reduction}: gossip kernel launches "
                                 f"{ga.LAUNCHES}")
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
        runs[reduction] = (engine, out, launches)
    return runs


def scale_state_kernels(torch, engine):
    """Phase 5 (c): the stacked fold and the threshold prune/regrow on the
    engine's own state after its rounds, counters zeroed just before and
    read just after each; returns their launches."""
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.kernels import prune_regrow as pr
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
    pa.LAUNCHES_ROWS = 0
    num, den = fold_stacked(zeros(), zeros(), packed)
    torch.cuda.synchronize()
    fold_launches = pa.LAUNCHES_ROWS
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
    pr.LAUNCHES = 0
    new_m, new_w = stacked_prune_regrow_threshold(
        params, masks, grads, ctx.prune_rate, density)
    torch.cuda.synchronize()
    pr_launches = pr.LAUNCHES
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
    return {"packed_accum_rows": fold_launches, "prune_regrow": pr_launches}


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
    """Every launch count to 0, the stacked fold's ``LAUNCHES_ROWS`` and the
    U=1 masked matmul's ``LAUNCHES_U1`` too."""
    for c in counters:
        c.LAUNCHES = 0
        for extra in ("LAUNCHES_ROWS", "LAUNCHES_U1"):
            if hasattr(c, extra):
                setattr(c, extra, 0)


def _launches(counters):
    """Each kernel's launches since ``_zero``, the stacked fold's
    (``packed_accum_rows``) apart from the flat fold's."""
    out = {c.__name__.rsplit(".", 1)[-1]: c.LAUNCHES for c in counters}
    out.update({c.__name__.rsplit(".", 1)[-1] + "_rows": c.LAUNCHES_ROWS
                for c in counters if hasattr(c, "LAUNCHES_ROWS")})
    out.update({c.__name__.rsplit(".", 1)[-1] + "_u1": c.LAUNCHES_U1
                for c in counters if hasattr(c, "LAUNCHES_U1")})
    return out


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
    """One async run of one round under torch.profiler: the device's busy
    share of its wall time and the kernels that took the most device time
    (the path packs one payload per push, reading back per leaf)."""
    from torch.profiler import ProfilerActivity, profile
    args = train.parse_args(RESNET_ARGS + ASYNC_ARGS)
    args.rounds = 1
    engine = train.build_engine(args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
        want = {k: 0 for k in launches}
        if name == "subfedavg":
            want["gossip_avg"] = args.rounds * sel * n_leaves
        if launches != want:
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
    want = {**{k: 0 for k in launches}, "packed_accum": mixed * n_leaves}
    if not (launches == want and folds == mixed * n_leaves > 0):
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
    ordered sum), the comm and FLOP rows must equal the loop engine's, and
    the parameters are held against the ``RoundEngine`` run whose local
    phase is the same stacked one (``--exec auto``, vmap: ``vmap_run``):
    ``ordered`` adds the loop's terms in the loop's order, so it must be
    bit-equal; ``einsum`` sums in another order, a gap the two local
    phases amplify, so within ``SCALE_EINSUM_ATOL``.  Against an ``--exec
    loop`` run on the card the gap is the vmap-vs-loop gap compounded over
    two local phases: held within ``LOOP_GAP_FACTOR`` times what the same
    loop run differs by between the card and the CPU from one initial
    state.  Returns each reduction's launches."""
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
    runs = {}
    for reduction in ("einsum", "ordered"):
        args = train.parse_args(SCALE_ARGS + ["--strategy", "dpsgd",
                                              "--scale-reduction", reduction])
        engine = train.build_engine(args)
        _zero(counters)
        out = train.run_engine(args, engine)
        launches = _launches(counters)
        params = engine.adapter.unstack_state(engine.state)
        d_vmap = _max_state_diff(torch, params, vmap_engine.state)
        d_loop = _max_state_diff(torch, params, loop.state)
        log(f"scale dpsgd {reduction}: launches {launches}; params vs the "
            f"vmap RoundEngine {d_vmap}, vs the loop {d_loop} (the loop on "
            f"the CPU vs on the card {d_dev}); accs "
            f"{out['acc_history']} (vmap {vmap_out['acc_history']}, loop "
            f"{loop_out['acc_history']}); warm round wall "
            f"{out['round_wall_s'][-1]:.4f} s")
        if any(launches.values()):
            raise AssertionError(f"scale dpsgd launched kernels: {launches}")
        if (out["comm"], out["flops"]) != (loop_out["comm"],
                                           loop_out["flops"]):
            raise AssertionError("scale dpsgd rows != the loop engine's")
        if not d_vmap <= (0.0 if reduction == "ordered"
                          else SCALE_EINSUM_ATOL):
            raise AssertionError(f"scale dpsgd {reduction}: params differ "
                                 f"from the vmap RoundEngine's by {d_vmap}")
        if not d_loop <= LOOP_GAP_FACTOR * d_dev:
            raise AssertionError(f"scale dpsgd {reduction}: params differ "
                                 f"from the loop's by {d_loop}, over "
                                 f"{LOOP_GAP_FACTOR} x the card-vs-CPU gap "
                                 f"{d_dev}")
        runs[reduction] = launches
    return runs


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
    """Phase 6: the serving CLI's entry functions, untraced, in the order
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
    want = 3 * (res.summary["batches"] + 1)
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
    alone = ServeEngine(cli.build_store(args, model, dev), model,
                        backend="vmap", max_batch=args.max_batch)
    alone.warmup()
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
    """Phase 13 (b) for one full config: build the store on the card, serve,
    hold each request bit-equal to it served alone, time the pool-wide
    prefill with CUDA events, profile one serving run.  Frees its memory.
    Returns the launches of the first serving run."""
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.accounting import HEADER_NBYTES, bitmap_nbytes
    from repro_torch.core.masks import apply_mask, init_mask
    from repro_torch.serve import ArchModel, ModelStore, RequestStream
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()       # by earlier phases
    t0 = time.perf_counter()
    model = ArchModel(cfg, prompt_len=FULL_WIDTH_PROMPT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    store = ModelStore(model.init(gen), cache_size=2)
    n_params = sum(x.numel() for x in tree_leaves(store.base))
    for u in range(2):
        p = model.init(gen)
        m = init_mask(gen, p, 0.5)
        store.put(u, apply_mask(p, m), m)
        del p, m
    build_s = time.perf_counter() - t0
    at_rest = sum(HEADER_NBYTES + bitmap_nbytes(n_params) + 4 * store.nnz(u)
                  for u in store.users())
    if at_rest != store.total_bytes_at_rest():
        raise AssertionError(f"{cfg.name}: bytes_at_rest "
                             f"{store.total_bytes_at_rest()} != {at_rest}")
    # seed 2: three of the five batches hold both users
    reqs = RequestStream(n_users=2, n_requests=8, seed=2).requests()
    _zero(counters)
    res = ServeEngine(store, model, backend="vmap", max_batch=2).serve(reqs)
    launches = _launches(counters)
    if any(launches.values()):
        raise AssertionError(f"{cfg.name}: a kernel launched: {launches}")
    alone = ServeEngine(store, model, backend="vmap", max_batch=2)
    for r in reqs:
        y = res.outputs[r.rid]
        if y.shape != (1, cfg.vocab) or not bool(
                torch.isfinite(torch.from_numpy(y)).all()):
            raise AssertionError(f"{cfg.name}: request {r.rid} output "
                                 f"{y.shape} not finite")
        if not (alone.serve([r], warmup=False).outputs[r.rid] == y).all():
            raise AssertionError(f"{cfg.name}: request {r.rid} served in a "
                                 "mixed batch differs from it alone")
    xs = torch.from_numpy(np.stack([model.make_input(i)
                                    for i in range(2)])).cuda()
    ms = cuda_ms(lambda: model.batched_forward(store.pool_params,
                                               store.pool_masks, xs),
                 iters=3, warmup=1)
    profiled = ServeEngine(store, model, backend="vmap", max_batch=2)
    profiled.warmup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pres = profiled.serve(reqs, warmup=False)
    peak = torch.cuda.max_memory_allocated()
    miss = store.series.histogram("miss_decode_s")
    s = res.summary
    log(f"full width {cfg.name}: {n_params} parameters, store built in "
        f"{build_s:.2f} s, bytes_at_rest {store.total_bytes_at_rest()}; "
        f"service_s {s['service_s']}, p50 {s['p50_ms']} ms, p99 "
        f"{s['p99_ms']} ms, {s['requests']} requests in {s['batches']} "
        f"batches, hit rate {s['cache_hit_rate']} ({miss.count} misses, "
        f"decode and slot write {miss.mean:.3f} s each); {len(reqs)} "
        f"bit-equal "
        f"alone; pool-wide prefill of 2 x {FULL_WIDTH_PROMPT} tokens "
        f"{ms:.3f} ms: {ms / 2:.3f} ms per request, "
        f"{2 * FULL_WIDTH_PROMPT / (ms / 1e3):.1f} prompt tokens/s; peak "
        f"memory {peak} bytes ({peak / 2 ** 30:.2f} GiB; "
        f"{(peak - held) / 2 ** 30:.2f} GiB above the {held} bytes held "
        f"before the model)")
    rows = device_rows(prof)
    if rows is not None:
        busy_s = sum(r[0] for r in rows) / 1e6
        svc = pres.summary["service_s"]
        log(f"  profiled serving run: service_s {svc} (profiler on), device "
            f"busy {busy_s:.4f} s ({100 * busy_s / svc:.1f}%)")
        for us, count, key in sorted(rows, reverse=True)[:3]:
            log(f"  {us / 1e3:.3f} ms in {count} launches: {key[:90]}")
    del res, pres, alone, profiled, store, model, xs, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_models_path(torch, counters):
    """Phase 13: smallcnn and the ten smoke archs through the serving CLI,
    then two archs at full published width.  Returns every kernel's
    launches summed over the phase's counted runs (all must be 0)."""
    from repro_torch.configs import ARCHS, SMOKE_ARCHS

    runs = [serve_smoke_model(torch, counters, name)
            for name in ["smallcnn"] + sorted(SMOKE_ARCHS)]
    runs += [serve_full_width(torch, counters, ARCHS[name])
             for name in FULL_WIDTH_ARCHS]
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def profile_serve(torch):
    """One more kernel-backend serving run under torch.profiler: the
    device's busy share of the service time and the top device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import setup_device
    from repro_torch.launch import serve as cli
    args = cli.build_parser().parse_args(SERVE_ARGS + ["--backend", "kernel"])
    model = cli.build_model(args.model, args.rows)
    store = cli.build_store(args, model, setup_device(args.device))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = cli.run_serve(args, model, store)
    rows = device_rows(prof)
    if rows is None:
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    svc = res.summary["service_s"]
    log(f"profiled serve: service_s {svc} (profiler on), device busy "
        f"{busy_s:.4f} s ({100 * busy_s / svc:.1f}%)")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"  {us / 1e3:.3f} ms in {count} launches: {key[:90]}")


def profile_round(torch, train, args):
    """One more main-path round (same configuration, warm process) under
    torch.profiler: the device's busy share of the round's wall time and
    the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    engine = train.build_engine(args)
    engine.cfg.rounds = 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    if rows is None:
        return
    busy_s = sum(r[0] for r in rows) / 1e6
    what = (f"scale {args.scale_reduction} round" if args.scale
            else f"{args.strategy} round ({engine.local_exec})")
    log(f"profiled {what}: wall {wall:.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / wall:.1f}%), phases {engine.phase_s[0]}")
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
    """K clients' params drawn on the card, stacked, and int8 masks: each
    coordinate of a sparsifiable leaf held with probability 0.5 (the
    reference's step tests), the other leaves dense; params masked."""
    from repro_torch.scale.stacked import default_threshold_sparsifiable
    from repro_torch.utils.tree import tree_map

    clients = [api.init(gen) for _ in range(plan.n_clients)]
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


def lm_full_width(torch, counters, pr):
    """Phase 14 (b): the step builders at gemma3-1b's published width, K=2
    clients of one 1024-token row.  Returns the launches of the counted
    run (train step, mask update, prefill, 16 decode steps)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.scale.stacked as stacked
    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.models import lm as lm_mod
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = ARCHS[LM_FULL_ARCH]
    k, s, n_dec = LM_FULL_CLIENTS, LM_FULL_SEQ, LM_FULL_DECODE
    api = bind(cfg)
    plan = steps.ScalePlan(cfg, InputShape("lm_full", s, k, "train"), k, 1)
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
    log(f"lm full width {cfg.name}: {n_params} parameters a client, K={k}, "
        f"{sparse} sparsifiable leaves, state built in "
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
                       and torch.equal(new_w.view(torch.int32),
                                       want_w.view(torch.int32)),
                       int((new_m.sum(1) - n_active).abs().max())))
        del want_m, want_w
        return new_m, new_w

    stacked.prune_regrow_rows = checked
    try:
        params, masks = mask_update(params, masks, batch, 0.25)
    finally:
        stacked.prune_regrow_rows = orig
    bad = [c for c in checks if not c[1]]
    if bad or len(checks) != sparse:
        raise AssertionError(f"lm full width: prune_regrow {len(checks)} "
                             f"launches for {sparse} sparsifiable leaves; "
                             f"not bit-equal to plain: {bad}")
    excess = max(c[2] for c in checks)
    stage_peak("mask update (with the plain checks)")

    fresh_cache = lambda: tree_map(  # noqa: E731
        lambda t: torch.stack([t] * k),
        api.init_cache(1, s + n_dec, device="cuda"))
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
            v for key, v in launches.items() if key != "prune_regrow"):
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
            lambda p, t: lm_mod.forward_train(p, t, cfg)[0])(params, seq)
    want = full[:, :, s - 1:]
    got = torch.stack(dec_logits, 2)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    del full, want, got
    if err > LM_DECODE_TOL * scale:
        raise AssertionError(f"lm full width: decoded logits differ from "
                             f"teacher forcing by {err} (scale {scale})")
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
    log(f"lm full width {cfg.name}: train step {train_ms:.3f} ms warm "
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
    for what, p, w in (("train step", prof, wall),
                       ("decode step", dprof, dwall)):
        rows = device_rows(p)
        if rows is None:
            continue
        busy_s = sum(r[0] for r in rows) / 1e6
        log(f"  profiled {what}: wall {w:.4f} s (profiler on), device busy "
            f"{busy_s:.4f} s ({100 * busy_s / w:.1f}%), "
            f"{sum(r[1] for r in rows)} device events")
        for us, count, key in sorted(rows, reverse=True)[:3]:
            log(f"  {us / 1e3:.3f} ms in {count} launches: {key[:90]}")
    del params, masks, batch, prof, dprof, losses
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def lm_path(torch, counters):
    """Phase 14: ``train lm`` on every decoder smoke arch, then the step
    builders at full width.  Returns every kernel's launches summed over
    the counted runs."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.kernels import prune_regrow as pr

    runs = [lm_smoke_run(torch, counters, name)
            for name in sorted(SMOKE_ARCHS)
            if SMOKE_ARCHS[name].enc_layers == 0]
    runs.append(lm_full_width(torch, counters, pr))
    return {key: sum(r[key] for r in runs) for key in runs[0]}


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
    want = 3 * (s0["batches"] + 1)
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
    return {k: sum(t[k] for t in totals) for k in totals[0]}


if __name__ == "__main__":
    sys.exit(main())
