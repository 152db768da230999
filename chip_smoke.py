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
   matmul over the reference's kernel-test sweep, at the serving shapes
   (U = cache size, M = rows, the MLP's three layers) and on a mask with
   whole empty 128x128 tiles, each within 1e-5 of its plain version, and a
   user's rows in a mixed batch bit-equal to the same user served alone;
4. the training path through its CLI entry functions: ``simulate
   --model resnet18 --hw 32 --clients 4 --rounds 2`` on the default device
   (cuda), with launch counters zeroed just before and read just after —
   both kernels must have run, every mask must hold its ERK budget after
   each evolve, accuracy must be finite — then a shorter ``packed=False``
   round (the gossip kernel on the dense mix);
5. a small smallcnn round on the card against the same round on the CPU
   (the plain versions), from one state;
6. the serving path through its CLI entry functions (``launch/serve.py``:
   1024 users of the 64-128-128-32 MLP, a 256-slot pool, 4096 requests),
   counters zeroed just before and read just after: ``--backend kernel``
   must launch the masked matmul 3 x (batches + 1 warmup) times, match
   ``--backend vmap`` per request within 1e-5 with identical cache
   counters, and hold ``bytes_at_rest == sum of encoded_nbytes``, all
   untraced and in the order kernel, vmap, vmap, kernel; then a traced
   kernel run for the split of service time by span, and one under
   torch.profiler for the device's busy share;
7. a ``{"kernels": [...]}`` line, then the last line
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
SERVE_ARGS = ["--users", "1024", "--cache-size", "256", "--max-batch", "256",
              "--requests", "4096", "--rows", "4", "--density", "0.5"]


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
    # num, den read and written once, the bitmap and the nnz values read once
    b_ms, b_by = bound(16 * n + 4 * words.numel() + 4 * nnz, 3 * n)
    return {"N": n, "nnz": nnz, "alpha": alpha, "max_abs_err": err,
            "ms": ms_k, "device_ms": dev_k, "plain_ms": ms_p,
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
        row["library_ms"] = cuda_ms(lambda: torch.bmm(x, wm))
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


def _times(r):
    dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']} ms"
    return (f"per call {r['ms']} ms, device {dev}, plain {r['plain_ms']} ms, "
            f"bound {r['bound_ms']} ms ({r['bound_by']}), "
            f"max abs err {r['max_abs_err']}")


class BudgetCheck:
    """Engine callback: after each round's evolve, every client's mask holds
    exactly its ERK budget on every sparsifiable leaf."""

    def __init__(self):
        self.rounds_checked = 0

    def on_round_end(self, engine, metrics):
        from repro_torch.utils.tree import tree_leaves_with_path
        strat = engine.strategy
        for k, mask in enumerate(engine.state["masks"]):
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
    from repro_torch.launch import train
    from repro_torch.sparse.packed import pack_bits
    counters = (ga, pa, mmk)

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
    for r in fold_rows:
        log(f"packed_accum N={r['N']} nnz={r['nnz']} alpha={r['alpha']}: "
            + _times(r))
    mm_rows = mm_checks(torch, mmk, dev, gen)

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

    # 5. a small round on the card against the same round on the CPU
    cross = cross_check(torch, train)
    log(f"cuda vs cpu smallcnn round: {cross}")

    # 6. the serving path through the CLI's entry functions
    serve_launches = serve_path(torch, counters)
    profile_serve(torch)
    mm = mm_rows["serve"][1]          # the (128, 128) layer at serve shapes

    kernels = [
        {"name": "gossip_avg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gossip_avg.cu",
         "replaces": "src/repro/kernels/gossip_avg.py:37",
         "launches": launches["gossip_avg"],
         "shape": f"J=4 N={n_leaf} float32",
         "max_abs_err": max(r["max_abs_err"] for r in gossip_rows),
         "ms": gossip_rows[0]["ms"], "device_ms": gossip_rows[0]["device_ms"],
         "plain_ms": gossip_rows[0]["plain_ms"],
         "bound_ms": gossip_rows[0]["bound_ms"],
         "bound_by": gossip_rows[0]["bound_by"], "library_ms": None},
        {"name": "packed_accum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/packed_accum.cu",
         "replaces": "src/repro/kernels/packed_accum.py:63",
         "launches": launches["packed_accum"],
         "shape": f"N={n_leaf} density 0.5 alpha 1",
         "max_abs_err": max(r["max_abs_err"] for r in fold_rows),
         "ms": fold_rows[0]["ms"], "device_ms": fold_rows[0]["device_ms"],
         "plain_ms": fold_rows[0]["plain_ms"],
         "bound_ms": fold_rows[0]["bound_ms"],
         "bound_by": fold_rows[0]["bound_by"], "library_ms": None},
        {"name": "masked_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul.py:131",
         "launches": serve_launches,
         "shape": f"U={mm['U']} M={mm['M']} K={mm['K']} N={mm['N']} "
                  f"density 0.5 float32",
         "max_abs_err": max(r["max_abs_err"] for rows in mm_rows.values()
                            for r in rows),
         "ms": mm["ms"], "device_ms": mm["device_ms"],
         "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
         "bound_by": mm["bound_by"], "library_ms": mm["library_ms"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    # whole 128x128 tiles empty for about three users in four
    x, w, mask = mm_inputs(torch, dev, 64, 4, 512, 512, 0.5, gen)
    live = (torch.rand((64, 4, 4), generator=gen, device=dev) < 0.25).float()
    mask *= live.repeat_interleave(128, 1).repeat_interleave(128, 2)
    rows["blocks"].append(check_masked_matmul(torch, mmk, x, w, mask,
                                              timed=True))
    x, w, mask = mm_inputs(torch, dev, u, m, 128, 128, 0.5, gen)
    n_alone = check_mixed_vs_alone(torch, mmk, x, w, mask, (0, 1, u // 2, u - 1))
    log(f"masked_matmul sweep: {len(rows['sweep'])} shapes within 1e-5 of "
        f"plain (max abs err {max(r['max_abs_err'] for r in rows['sweep'])}); "
        f"{n_alone} users alone bit-equal to the mixed batch")
    for r in rows["serve"] + rows["blocks"]:
        log(f"masked_matmul U={r['U']} M={r['M']} K={r['K']} N={r['N']} "
            f"occupancy {r['occupancy']:.4f}: " + _times(r)
            + f", torch.bmm {r['library_ms']} ms")
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
    for c in counters:
        c.LAUNCHES = 0
    res = cli.run_serve(args, model, store)
    launches = {c.__name__.rsplit(".", 1)[-1]: c.LAUNCHES for c in counters}
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
    return launches["masked_matmul"]


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
    log(f"profiled round: wall {wall:.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / wall:.1f}%), phases {engine.phase_s[0]}")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3:.3f} ms in {count} launches: {key[:90]}")


def cross_check(torch, train):
    """One smallcnn round from one state on cuda (kernels) and on cpu
    (plain versions): the mix is exact on both; convolutions differ by fp32
    rounding, so masks must agree on all but a 1e-3 share of coordinates and
    parameters to 1e-3 where they agree."""
    from repro_torch.utils.tree import tree_leaves, tree_map
    argv = ["simulate", "--rounds", "1", "--clients", "4", "--hw", "8",
            "--width", "4", "--samples-per-class", "12", "--degree", "2",
            "--exec", "loop"]
    gpu = train.build_engine(train.build_parser().parse_args(argv))
    cpu = train.build_engine(train.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    cpu.state = tree_map(lambda x: x.detach().cpu().clone(), gpu.state)
    gpu.run(), cpu.run()
    n = mismatched = 0
    max_err = 0.0
    for key in ("masks", "params"):
        for a, b in zip(tree_leaves(gpu.state[key]), tree_leaves(cpu.state[key])):
            a = a.cpu()
            if key == "masks":
                n += a.numel()
                mismatched += int((a != b).sum())
            else:
                same = (a != 0) == (b != 0)
                max_err = max(max_err, float((a - b)[same].abs().max()))
    share = mismatched / n
    if share > 1e-3 or max_err > 1e-3:
        raise AssertionError(f"cuda and cpu rounds disagree: mask share "
                             f"{share}, param err {max_err}")
    return {"mask_mismatch_share": share, "param_max_abs_err": max_err,
            "acc_cuda": gpu._acc_history, "acc_cpu": cpu._acc_history}


if __name__ == "__main__":
    sys.exit(main())
