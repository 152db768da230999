"""Serving launcher (reference ``repro.launch.serve``).

Builds a ``ModelStore`` (synthetic per-user sparse personalizations, or a
trained engine archive via ``--from-checkpoint``), replays a seed-derived
request stream through the micro-batcher, and streams p50/p99 latency,
requests/s and cache counters as JSON lines.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --users 64 --cache-size 16 --max-batch 8 --requests 256 \
        --backend kernel --metrics-jsonl serve_metrics.jsonl

Runs on CUDA unless ``--device cpu`` is given.  ``--model`` picks the
served family, as in the reference: ``mlp`` (the 64→128→128→32
masked-matmul pipeline; backends vmap, ref and kernel — the reference's
``pallas``), ``smallcnn`` (the FL task model at 16x16 inputs, vmap only)
or any registered smoke arch name (one-step scorer over an 8-token prompt,
vmap only).  ``--trace F`` writes the run's Perfetto trace and ``--run-dir
D`` a run archive that ``repro_torch.launch.dash`` renders, as in the
reference.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_model(name: str, rows: int):
    from repro_torch.serve.model import ArchModel, MLPModel, TaskModel

    if name == "mlp":
        return MLPModel(d_in=64, widths=(128, 128), n_out=32, rows=rows)
    if name == "smallcnn":
        from repro_torch.fl.base import make_cnn_task

        # the task's init draws on the CPU generator ``build_store`` hands
        # it; the store moves the users to the serving device
        return TaskModel(make_cnn_task("smallcnn", device="cpu"), hw=16,
                         rows=rows)
    from repro_torch.configs import SMOKE_ARCHS
    if name in SMOKE_ARCHS:
        return ArchModel(SMOKE_ARCHS[name], rows=rows)
    raise SystemExit(
        f"unknown --model {name!r}: expected mlp, smallcnn, or one of "
        f"{sorted(SMOKE_ARCHS)}")


def build_store(args, model, device):
    """The store the CLI serves from: synthetic users drawn from
    ``torch.Generator``s seeded with ``--seed`` (on the CPU, so a seed gives
    the same users on any device), or a trained engine archive."""
    import torch

    from repro_torch.core.masks import apply_mask, init_mask
    from repro_torch.serve.store import ModelStore

    if args.from_checkpoint:
        return ModelStore.from_checkpoint(
            args.from_checkpoint, cache_size=args.cache_size, device=device)
    base = model.init(torch.Generator().manual_seed(args.seed))
    store = ModelStore(base, cache_size=args.cache_size, device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    for u in range(args.users):
        p = model.init(gen)
        m = init_mask(gen, p, args.density)
        store.put(u, apply_mask(p, m), m)
    return store


def run_serve(args, model, store, stream=None):
    """Serve ``--requests`` seed-derived requests from ``store``; returns
    the ``ServeResult``."""
    from repro_torch.serve.batcher import RequestStream
    from repro_torch.serve.engine import ServeEngine

    n_users = len(store.users()) or args.users
    if stream is not None:
        stream.emit({"event": "store", **store.stats(),
                     "model": args.model, "backend": args.backend})
    engine = ServeEngine(store, model, backend=args.backend,
                         max_batch=args.max_batch, max_wait=args.max_wait,
                         metrics=stream, metrics_every=args.metrics_every)
    requests = RequestStream(n_users=n_users, n_requests=args.requests,
                             seed=args.seed, rate=args.rate)
    return engine.serve(requests)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__)
    ap.add_argument("--users", type=int, default=64)
    ap.add_argument("--cache-size", type=int, default=16, dest="cache_size")
    ap.add_argument("--max-batch", type=int, default=8, dest="max_batch")
    ap.add_argument("--max-wait", type=float, default=0.005, dest="max_wait",
                    help="virtual seconds a request may wait before flush")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--backend", default="vmap",
                    choices=("vmap", "ref", "kernel"))
    ap.add_argument("--model", default="mlp",
                    help="mlp | smallcnn | <smoke arch name>")
    ap.add_argument("--rows", type=int, default=4,
                    help="input rows per request (matmul M)")
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=1000.0,
                    help="virtual arrivals per second")
    ap.add_argument("--from-checkpoint", default=None, dest="from_checkpoint",
                    help="load users from a trained engine archive instead "
                         "of synthesizing them")
    ap.add_argument("--metrics-every", type=int, default=8,
                    dest="metrics_every")
    ap.add_argument("--metrics-jsonl", default="-", dest="metrics_jsonl",
                    help="stream JSON lines here ('-': stdout)")
    ap.add_argument("--trace", default="",
                    help="export a Perfetto-loadable trace_event JSON of "
                         "the run (repro_torch.obs) to this path")
    ap.add_argument("--trace-mode", default=None, dest="trace_mode",
                    choices=["ring", "full"],
                    help="span recorder: ring = bounded buffer (default), "
                         "full = keep every span")
    ap.add_argument("--run-dir", default="", dest="run_dir",
                    help="write a run archive (manifest, counters, series, "
                         "trace, health events) to this directory; implies "
                         "tracing.  Render with repro_torch.launch.dash")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the run's summary (also streamed last)."""
    from repro_torch.device import setup_device
    from repro_torch.sim.report import MetricsStream

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.trace_mode is not None and not (args.trace or args.run_dir):
        ap.error("--trace-mode requires --trace or --run-dir")
    device = setup_device(args.device)
    if args.trace or args.run_dir:
        from repro_torch.obs import get_tracer
        get_tracer().enable(mode=args.trace_mode or "ring")
    model = build_model(args.model, args.rows)
    store = build_store(args, model, device)
    with MetricsStream(args.metrics_jsonl) as stream:
        result = run_serve(args, model, store, stream)
    if args.trace:
        from repro_torch.obs import write_trace
        doc = write_trace(args.trace)
        print(f"wrote trace ({doc['otherData']['spans']} spans) to "
              f"{args.trace} — open at https://ui.perfetto.dev")
    if args.run_dir:
        from repro_torch.launch.train import save_run_archive
        save_run_archive(args, "serve", result.summary)
    return result.summary


if __name__ == "__main__":
    main()
