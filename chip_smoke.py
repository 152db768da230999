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
   time, the plain version's time and its HBM-bytes bound;
4. the port's main path through its CLI entry functions: ``simulate
   --model resnet18 --hw 32 --clients 4 --rounds 2`` on the default device
   (cuda), with launch counters zeroed just before and read just after —
   both kernels must have run, every mask must hold its ERK budget after
   each evolve, accuracy must be finite — then a shorter ``packed=False``
   round (the gossip kernel on the dense mix);
5. a small smallcnn round on the card against the same round on the CPU
   (the plain versions), from one state;
6. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, without a CUDA GPU or without the
repo's ``src/`` beside this file.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
BF16_REL_TOL = 2.0 ** -8        # one bf16 ulp, relative (expected: exact)


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
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "self_device_time_total", 0) or
                       getattr(e, "self_cuda_time_total", 0)
                       for e in prof.key_averages())
    except (RuntimeError, AttributeError) as e:
        log(f"  device time not measured: {e!r}")
        return None
    if total_us <= 0:
        log("  device time not measured: the profiler recorded no kernels")
        return None
    return total_us / 1e3 / iters


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
    from repro_torch.kernels import build
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.launch import train
    from repro_torch.sparse.packed import pack_bits

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

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

    # 4. the main path through the CLI's entry functions
    args = train.build_parser().parse_args([
        "simulate", "--model", "resnet18", "--hw", "32", "--clients", "4",
        "--rounds", "2", "--local-epochs", "1", "--samples-per-class", "20",
        "--exec", "loop"])
    engine = train.build_engine(args)
    budget_check = BudgetCheck()
    engine.callbacks.append(budget_check)
    ga.LAUNCHES = 0
    pa.LAUNCHES = 0
    out = train.run_engine(args, engine)
    launches = {"gossip_avg": ga.LAUNCHES, "packed_accum": pa.LAUNCHES}
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
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
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_round(torch, train, args):
    """One more main-path round (same configuration, warm process) under
    torch.profiler: the device's busy share of the round's wall time and
    the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    engine = train.build_engine(args)
    engine.cfg.rounds = 1
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(getattr(e, "self_device_time_total", 0) or
                 getattr(e, "self_cuda_time_total", 0), e.count, e.key)
                for e in prof.key_averages()]
    except (RuntimeError, AttributeError) as e:
        log(f"profiled round: device time not measured: {e!r}")
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
