"""Training launcher (reference ``repro.launch.train``).  Two modes:

1. ``simulate`` — the paper's experiment on the port's loop engine, its
   stacked engine (``--scale``) or its network simulator (``--sim``).

       PYTHONPATH=src python -m repro_torch.launch.train simulate \
           --strategy dispfl --clients 16 --rounds 30 --partition dirichlet
       PYTHONPATH=src python -m repro_torch.launch.train simulate --scale \
           --scale-reduction ordered --strategy dispfl
       PYTHONPATH=src python -m repro_torch.launch.train simulate --sim \
           --async --staleness 2 --compute-hetero --bandwidth-skew 10
       torchrun --nproc_per_node 4 -m repro_torch.launch.train simulate \
           --scale --mesh-shape 4x1 --device cpu

   ``--mesh-shape DxM`` (or ``PxDxM``) shards ``--scale``'s stacked clients
   over a ``DeviceMesh`` of that shape (``launch.mesh``), one process per
   position, started by ``torchrun``: NCCL on the card, gloo on the CPU.
   Rank 0 prints what an unsharded run prints (its JSON gains a ``mesh``
   row: shape, world, backend, capture, clients per rank, gather bytes);
   the other ranks print nothing, and rank 0 alone writes checkpoints,
   traces and archives.

   Prints one line per evaluated round, then a JSON object with the run's
   results, per-round wall times and per-phase times (mix, local, evolve,
   eval; ``--scale`` adds the host inputs phase); ``--sim`` adds the
   simulator's ``"sim"`` report row.  ``--trace F`` writes the run's
   Perfetto trace; ``--run-dir D`` writes a run archive (manifest,
   counters, series, trace, health events) that ``launch.dash`` renders —
   the reference's files and keys, ``torch/*`` counters in place of its
   ``jax/*``:

       PYTHONPATH=src python -m repro_torch.launch.train simulate --sim \
           --loss-prob 0.1 --uplink-mode fair --run-dir runs/a \
           --trace-mode full
       PYTHONPATH=src python -m repro_torch.launch.dash render \
           --run-dir runs/a -o dash.html --check

2. ``lm`` — DisPFL on a reduced decoder LM (a smoke arch at ``--d-model``
   width, vocab 256) over synthetic Markov domains, one per client:
   stacked intersection gossip and masked SGD steps, then the exact Alg. 2
   mask evolution per client once a round.

       PYTHONPATH=src python -m repro_torch.launch.train lm \
           --arch qwen3-8b --steps 100 --clients 4

   Prints one line per round and a JSON object ``{"arch", "improved"}``.

Both run on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np


def build_engine(args):
    """The ``RoundEngine`` that ``simulate`` runs, from parsed arguments."""
    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import (
        Checkpointer,
        EarlyStopAtTarget,
        JsonlLogger,
        RoundEngine,
        make_strategy,
    )

    mesh = build_mesh(args) if args.scale else None
    task = make_cnn_task(args.model, n_classes=10, hw=args.hw,
                         width=args.width, device=args.device)
    clients, _ = build_federated_image_task(
        args.seed, n_clients=args.clients, partition=args.partition,
        alpha=args.alpha, classes_per_client=args.classes_per_client,
        n_train_per_class=args.samples_per_class, hw=args.hw)
    capacities = None
    if args.heterogeneous:
        levels = [0.2, 0.4, 0.6, 0.8, 1.0]
        capacities = [levels[k % 5] for k in range(args.clients)]
    cfg = FLConfig(
        n_clients=args.clients, rounds=args.rounds,
        local_epochs=args.local_epochs, batch_size=args.batch_size,
        lr0=args.lr, topology=args.topology, degree=args.degree,
        density=args.density, capacities=capacities, seed=args.seed,
        drop_prob=args.drop_prob, eval_every=args.eval_every)

    callbacks = []
    if args.log_jsonl and (mesh is None or mesh.get_rank() == 0):
        callbacks.append(JsonlLogger(args.log_jsonl))
    if args.checkpoint:
        callbacks.append(Checkpointer(args.checkpoint,
                                      every=args.checkpoint_every))
    if args.target > 0:
        callbacks.append(EarlyStopAtTarget(args.target))
    if args.scale:
        from repro_torch.scale import ScaleEngine

        engine = ScaleEngine(make_strategy(args.strategy), task, clients, cfg,
                             callbacks=callbacks, mesh=mesh,
                             reduction=args.scale_reduction)
    elif args.sim:
        from repro_torch.sim import (
            AlwaysUp,
            BandwidthTrace,
            BernoulliAvailability,
            LinkModel,
            LossModel,
            SimEngine,
            hetero_speeds,
        )
        trace = (BandwidthTrace.from_json(args.bandwidth_trace)
                 if args.bandwidth_trace else None)
        links = (LinkModel.skewed(args.clients, args.bandwidth_mbps,
                                  args.bandwidth_skew,
                                  latency_ms=args.latency_ms, seed=args.seed,
                                  trace=trace)
                 if args.bandwidth_skew > 1.0 else
                 LinkModel.uniform(args.clients, args.bandwidth_mbps,
                                   args.latency_ms, trace=trace))
        avail = (BernoulliAvailability(args.clients, args.drop_prob, args.seed)
                 if args.drop_prob > 0 else AlwaysUp(args.clients))
        speeds = (hetero_speeds(args.clients, seed=args.seed)
                  if args.compute_hetero else None)
        loss = (LossModel(args.loss_prob, args.retransmit_timeout,
                          seed=args.seed)
                if args.loss_prob > 0 else None)
        if args.sim_checkpoint:
            callbacks.append(Checkpointer(args.sim_checkpoint,
                                          every=args.checkpoint_every))
        engine = SimEngine(
            make_strategy(args.strategy), task, clients, cfg,
            callbacks=callbacks, local_exec=args.local_exec,
            mode="async" if args.sim_async else "sync",
            staleness=args.staleness, links=links, availability=avail,
            round_s=args.round_s, compute_speeds=speeds,
            uplink=args.uplink_mode, loss=loss)
    else:
        engine = RoundEngine(make_strategy(args.strategy), task, clients,
                             cfg, callbacks=callbacks,
                             local_exec=args.local_exec)
    if args.resume:
        engine.restore(args.resume)
        if _lead(engine):
            print(f"resumed from {args.resume} at round "
                  f"{engine._next_round}")
    return engine


def _mesh_dims(text: str) -> list[int]:
    try:
        dims = [int(x) for x in text.lower().split("x")]
    except ValueError:
        dims = []
    return dims if len(dims) in (2, 3) and min(dims) > 0 else []


def build_mesh(args):
    """``--mesh-shape``'s ``DeviceMesh`` on ``--device`` (None without
    it), as the reference's ``train.py`` builds its mesh; a world of
    another size exits with the ``torchrun`` line that fits it."""
    if not args.mesh_shape:
        return None
    from repro_torch.launch.mesh import make_test_mesh

    dims = _mesh_dims(args.mesh_shape)
    try:
        if len(dims) == 2:
            return make_test_mesh(data=dims[0], model=dims[1],
                                  device_type=args.device)
        return make_test_mesh(pods=dims[0], data=dims[1], model=dims[2],
                              device_type=args.device)
    except ValueError as e:
        raise SystemExit(f"cannot build mesh {args.mesh_shape}: {e}")


def _lead(engine) -> bool:
    """Whether this process prints and writes: always, but on a mesh
    global rank 0 only."""
    if getattr(engine, "mesh", None) is None:
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def run_engine(args, engine) -> dict:
    """Stream the rounds, print the summary JSON, return it; with
    ``--trace`` / ``--run-dir``, trace the run and write its trace and run
    archive."""
    from repro_torch.checkpoint.npz import save_clients

    if args.trace or args.run_dir:
        # --run-dir implies tracing: the archive's rollups and dashboard
        # are derived from spans, so an archive without them is near-empty
        from repro_torch.obs import get_tracer
        get_tracer().enable(mode=args.trace_mode or "ring")
    cfg = engine.cfg
    t0 = time.time()
    walls = []
    lead = _lead(engine)
    for m in engine.rounds():
        walls.append(m.wall_s)
        if m.acc_mean is not None and lead:
            sim_note = (f" t_sim={m.sim_time_s:.1f}s"
                        if hasattr(m, "sim_time_s") else "")
            print(f"[round {m.round + 1}/{cfg.rounds}] "
                  f"acc={m.acc_mean:.3f}±{m.acc_std:.3f} "
                  f"comm={m.comm_busiest_mb:.2f}MB lr={m.lr:.4f} "
                  f"({m.wall_s:.1f}s){sim_note}")
    res = engine.result()
    out = {
        "strategy": args.strategy, "partition": args.partition,
        "device": str(engine.device),
        "final_acc": res.final_acc, "acc_history": res.acc_history,
        "comm": res.comm_rows, "flops": res.flops_rows,
        "wall_s": round(time.time() - t0, 1),
        "round_wall_s": walls, "phase_s": engine.phase_s,
    }
    if args.sim:
        targets = (args.target,) if args.target > 0 else ()
        out["sim"] = engine.report(targets=targets).row()
    if getattr(engine, "mesh", None) is not None:
        out["mesh"] = mesh_row(args, engine)
    if not lead:
        return out
    print(json.dumps(out, indent=2))
    if args.trace:
        from repro_torch.obs import write_trace
        doc = write_trace(args.trace)
        print(f"wrote trace ({doc['otherData']['spans']} spans) to "
              f"{args.trace} — open at https://ui.perfetto.dev")
    if args.run_dir:
        kind = "scale" if args.scale else ("sim" if args.sim else "train")
        density = None
        dm = engine.series.series("density_measured")
        dt = engine.series.series("density_target")
        if dm.points() and dt.points():
            density = (dm, dt)
        save_run_archive(args, kind, out, density=density)
    if args.save:
        save_clients(args.save, [{"final_acc": np.asarray(a)}
                                 for a in res.final_accs])
        print(f"saved per-client results to {args.save}")
    return out


def mesh_row(args, engine) -> dict:
    """What a meshed run adds to the summary: the mesh, the world and its
    backend, how the round was compiled, this rank's clients and the
    bytes each round's gather brought it."""
    import torch.distributed as dist

    shard = engine.shard
    return {"shape": args.mesh_shape, "world": dist.get_world_size(),
            "backend": shard.backend, "capture": engine.capture,
            "clients_per_rank": shard.k_local,
            "gather_bytes": engine.gather_bytes}


def save_run_archive(args, kind: str, report: dict, density=None) -> None:
    """Write the run archive (manifest + counters + series + trace + report)
    and stream fleet-health events to ``<run_dir>/health.jsonl`` — the
    layout ``launch.dash`` renders and ``RunRegistry`` lists.  Counters are
    the process-wide snapshot, as in the reference's CLIs."""
    import os

    from repro_torch.obs import (
        RunManifest,
        emit_health,
        fleet_health,
        get_tracer,
        save_run,
        snapshot_counters,
    )
    from repro_torch.sim.report import MetricsStream

    config = {k: v for k, v in vars(args).items()
              if isinstance(v, (int, float, str, bool, type(None)))}
    manifest = RunManifest.build(kind, seed=args.seed, config=config)
    tracer = get_tracer()
    save_run(args.run_dir, manifest,
             tracer=tracer if tracer.enabled else None, report=report)
    _, events = fleet_health(
        tracer, counters=snapshot_counters(), density=density,
        dropped_spans=tracer.dropped)
    with MetricsStream(os.path.join(args.run_dir, "health.jsonl"),
                       header=True) as stream:
        emit_health(stream, events)
    for ev in events:
        print(f"[health] {ev.severity}: {ev.kind} — {ev.message}")
    print(f"saved run archive {manifest.run_id} to {args.run_dir} "
          f"({len(events)} health events)")


def run_simulate(args) -> dict:
    """``build_engine`` then ``run_engine``; a world that ``--mesh-shape``
    started here ends with the run."""
    if not args.mesh_shape:
        return run_engine(args, build_engine(args))
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        return run_engine(args, build_engine(args))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# lm
# ---------------------------------------------------------------------------


def lm_config(args):
    """The smoke arch ``--arch`` at ``--d-model`` width, at least
    ``--layers`` layers, vocab 256.  An unknown name raises ``KeyError``, as
    the reference's lookup does; the encoder-decoder is refused."""
    from repro_torch.configs import SMOKE_ARCHS

    base = SMOKE_ARCHS[args.arch]
    if base.enc_layers > 0:
        raise ValueError(
            f"--arch {args.arch} is an encoder-decoder: its train_loss reads "
            "batch['frames'], which the lm loop's token batches do not carry "
            "(the reference's run_lm fails on it with a KeyError)")
    return base.replace(d_model=args.d_model,
                        n_layers=max(base.n_layers, args.layers), vocab=256)


def init_lm_clients(args, cfg, device) -> tuple[list, list]:
    """Each client's float32 params, then each client's ERK mask at
    ``--density``, drawn from one ``torch.Generator`` seeded with
    ``--seed`` on ``device``.  The params are not yet masked."""
    import torch

    from repro_torch.core.masks import init_mask
    from repro_torch.models import bind

    api = bind(cfg, remat=False)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = [api.init(gen) for _ in range(args.clients)]
    masks = [init_mask(gen, p, args.density) for p in params]
    return params, masks


def lm_loop(args, cfg, params: list, masks: list,
            device) -> tuple[dict, dict]:
    """The ``lm`` run after initialisation, from each client's unmasked
    ``params`` and ``masks`` (trees on any device): ERK budgets from client
    0, masks applied, then per round ``steps // rounds`` stacked steps
    (gossip over the round's random topology, one masked SGD step at ``lr
    * 0.998**round``) and one exact mask evolution per client at the cosine
    prune rate.  Batches, topology and rates follow the reference's draws
    in its order.  The stacked step is compiled (``utils.graph.graphed``,
    the reference's ``jax.jit``, params and masks donated): captured once
    on the card and replayed with each round's adjacency and learning rate as
    device tensors; the mask evolution runs eagerly, as the reference's
    does.  Returns ``({"arch", "loss_history", "improved"},
    {"params", "masks"})``: the run's result and its final stacked
    state."""
    import torch

    from repro_torch.core.evolve import (
        cosine_prune_rate,
        evolve_masks,
        layer_nnz_budgets,
    )
    from repro_torch.core.gossip import gossip_average_stacked
    from repro_torch.core.masks import apply_mask, erk_densities_for_params
    from repro_torch.core.topology import make_adjacency
    from repro_torch.data.synthetic import make_lm_corpus
    from repro_torch.launch.steps import stacked_loss_grads
    from repro_torch.models import bind
    from repro_torch.utils.graph import graphed
    from repro_torch.utils.tree import (
        tree_map,
        tree_size,
        tree_stack,
        tree_unstack,
    )

    api = bind(cfg, remat=False)
    k_clients = args.clients
    seq, bs = args.seq, args.batch_size
    streams = make_lm_corpus(args.seed, vocab=256, n_domains=k_clients,
                             tokens_per_domain=args.tokens_per_client)
    to_dev = lambda t: t.to(device)  # noqa: E731
    params = [tree_map(to_dev, p) for p in params]
    masks = [tree_map(to_dev, m) for m in masks]
    densities = erk_densities_for_params(params[0], args.density)
    budgets = layer_nnz_budgets(params[0], densities)
    params = [apply_mask(p, m) for p, m in zip(params, masks)]
    print(f"[lm] arch={cfg.name} params/client="
          f"{tree_size(params[0]) / 1e6:.2f}M density={args.density}")

    rng = np.random.default_rng(args.seed)

    def batch_for(k):
        s = streams[k]
        starts = rng.integers(0, len(s) - seq - 1, size=bs)
        toks = np.stack([s[i: i + seq] for i in starts])
        labs = np.stack([s[i + 1: i + seq + 1] for i in starts])
        return {"tokens": torch.from_numpy(toks).to(device),
                "labels": torch.from_numpy(labs).to(device)}

    grads_fn = stacked_loss_grads(api)

    def step(sp, sm, batch, adjacency, lr):
        mixed = gossip_average_stacked(sp, sm, adjacency)
        grads, losses = grads_fn(mixed, batch)

        def upd(w, g, m):
            mw = m.to(w.dtype)
            return (w - lr * g * mw) * mw

        return tree_map(upd, mixed, grads, sm), losses

    step = graphed(step, donate=(0, 1))

    def client_grad(p, batch):
        return torch.func.grad(lambda q: api.train_loss(q, batch)[0])(p)

    sp, sm = tree_stack(params), tree_stack(masks)
    hist = []
    steps_per_round = max(1, args.steps // args.rounds)
    t0 = time.time()
    it = 0
    for r in range(args.rounds):
        adj = torch.as_tensor(
            make_adjacency("random", k_clients, r,
                           degree=min(3, k_clients - 1), seed=args.seed),
            dtype=torch.float32, device=device)
        lr = args.lr * (0.998 ** r)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
        for _ in range(steps_per_round):
            batch = tree_stack([batch_for(k) for k in range(k_clients)])
            sp, losses = step(sp, sm, batch, adj, lr_t)
            it += 1
        # mask evolution once per round
        alpha = cosine_prune_rate(0.5, r, args.rounds)
        ps, ms = tree_unstack(sp, k_clients), tree_unstack(sm, k_clients)
        for k in range(k_clients):
            g = client_grad(ps[k], batch_for(k))
            ms[k], ps[k] = evolve_masks(ps[k], ms[k], g, alpha, budgets)
        # the new masks into the step's own buffers: a donated argument
        # passed as the same tensors is read in place, never copied
        sp = tree_stack(ps)
        sm = tree_map(torch.Tensor.copy_, sm, tree_stack(ms))
        mean_loss = float(torch.mean(losses))
        hist.append(mean_loss)
        print(f"[lm] round {r + 1}/{args.rounds} step {it} "
              f"loss={mean_loss:.4f} lr={lr:.4f} ({time.time() - t0:.0f}s)")
    out = {"arch": cfg.name, "loss_history": hist,
           "improved": hist[-1] < hist[0]}
    print(json.dumps({k: v for k, v in out.items() if k != "loss_history"}))
    return out, {"params": sp, "masks": sm}


def run_lm(args) -> dict:
    """DisPFL over a reduced assigned-arch LM on synthetic non-IID corpora,
    on ``--device``, from a ``torch.Generator`` initialisation.  Returns
    ``{"arch", "loss_history", "improved"}``."""
    from repro_torch.device import setup_device

    cfg = lm_config(args)
    device = setup_device(args.device)
    params, masks = init_lm_clients(args, cfg, device)
    return lm_loop(args, cfg, params, masks, device)[0]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    sub = ap.add_subparsers(dest="mode", required=True)
    sim = sub.add_parser("simulate")
    sim.add_argument("--strategy", default="dispfl",
                     help="a registered strategy (repro_torch.fl.engine."
                          "strategy_names(); an unknown name raises KeyError)")
    sim.add_argument("--clients", type=int, default=16)
    sim.add_argument("--rounds", type=int, default=30)
    sim.add_argument("--local-epochs", type=int, default=5, dest="local_epochs")
    sim.add_argument("--batch-size", type=int, default=32, dest="batch_size")
    sim.add_argument("--lr", type=float, default=0.1)
    sim.add_argument("--partition", default="dirichlet",
                     choices=["dirichlet", "pathological"])
    sim.add_argument("--alpha", type=float, default=0.3)
    sim.add_argument("--classes-per-client", type=int, default=2,
                     dest="classes_per_client")
    sim.add_argument("--samples-per-class", type=int, default=100,
                     dest="samples_per_class")
    sim.add_argument("--topology", default="random",
                     choices=["random", "ring", "fc"])
    sim.add_argument("--degree", type=int, default=10)
    sim.add_argument("--density", type=float, default=0.5)
    sim.add_argument("--heterogeneous", action="store_true")
    sim.add_argument("--drop-prob", type=float, default=0.0, dest="drop_prob")
    sim.add_argument("--model", default="smallcnn",
                     choices=["smallcnn", "resnet18", "vgg11"])
    sim.add_argument("--width", type=int, default=16)
    sim.add_argument("--hw", type=int, default=16)
    sim.add_argument("--eval-every", type=int, default=1, dest="eval_every")
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--save", default="")
    sim.add_argument("--exec", default="auto", dest="local_exec",
                     choices=["auto", "loop", "vmap"],
                     help="local-phase execution: vmap = stacked fast path")
    sim.add_argument("--log-jsonl", default="", dest="log_jsonl",
                     help="stream per-round RoundMetrics to this JSONL file")
    sim.add_argument("--checkpoint", default="",
                     help="save engine state to this .npz after rounds")
    sim.add_argument("--checkpoint-every", type=int, default=1,
                     dest="checkpoint_every")
    sim.add_argument("--resume", default="",
                     help="restore engine state from this .npz (written by "
                          "either package) and continue")
    sim.add_argument("--target", type=float, default=0.0,
                     help="early-stop once mean personalized acc >= target")
    sim.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="cuda (default; raises without a GPU) or cpu")
    sim.add_argument("--trace", default="",
                     help="export a Perfetto-loadable trace_event JSON of "
                          "the run (repro_torch.obs) to this path")
    sim.add_argument("--trace-mode", default=None, dest="trace_mode",
                     choices=["ring", "full"],
                     help="span recorder: ring = bounded buffer (default), "
                          "full = keep every span")
    sim.add_argument("--run-dir", default="", dest="run_dir",
                     help="write a run archive (manifest, counters, series, "
                          "trace, health events) to this directory; implies "
                          "tracing.  Render with repro_torch.launch.dash")
    sim.add_argument("--scale", action="store_true",
                     help="run through ScaleEngine: every phase of the round "
                          "once over client-stacked state (dispfl, "
                          "dispfl_anneal, dpsgd)")
    sim.add_argument("--mesh-shape", default="", dest="mesh_shape",
                     help="DATAxMODEL or PODSxDATAxMODEL: shard --scale's "
                          "clients over a DeviceMesh of that shape, one "
                          "process per position (torchrun --nproc_per_node "
                          "<product>)")
    sim.add_argument("--scale-reduction", default="einsum",
                     dest="scale_reduction", choices=["einsum", "ordered"],
                     help="gossip fold: einsum = matmul (default), ordered = "
                          "the loop's accumulation order (gossip kernel)")
    # event-driven network simulation (repro_torch.sim)
    sim.add_argument("--sim", action="store_true",
                     help="run through the event-driven network simulator")
    sim.add_argument("--async", dest="sim_async", action="store_true",
                     help="asynchronous staleness-bounded gossip (default: "
                          "synchronous barrier, bit-identical to the engine)")
    sim.add_argument("--staleness", type=int, default=None,
                     help="max rounds any client may run ahead "
                          "(-1: unbounded; default 2)")
    sim.add_argument("--bandwidth-mbps", type=float, default=None,
                     dest="bandwidth_mbps", help="default 100")
    sim.add_argument("--bandwidth-skew", type=float, default=None,
                     dest="bandwidth_skew",
                     help=">1: half the clients sit behind skew-x slower links")
    sim.add_argument("--latency-ms", type=float, default=None,
                     dest="latency_ms", help="default 10")
    sim.add_argument("--compute-hetero", action="store_true",
                     dest="compute_hetero",
                     help="0.2x..1.0x per-client compute speed multipliers")
    sim.add_argument("--round-s", type=float, default=None, dest="round_s",
                     help="virtual seconds a full-speed client spends per "
                          "round (default 1.0)")
    sim.add_argument("--loss-prob", type=float, default=None,
                     dest="loss_prob",
                     help="per-link Bernoulli message drop probability "
                          "(retransmitted after --retransmit-timeout; every "
                          "attempt's bytes are counted on the wire)")
    sim.add_argument("--retransmit-timeout", type=float, default=None,
                     dest="retransmit_timeout",
                     help="virtual seconds the sender waits before resending "
                          "a dropped message (default 0.5)")
    sim.add_argument("--uplink-mode", default=None, dest="uplink_mode",
                     choices=["parallel", "fifo", "fair"],
                     help="shared-uplink discipline: parallel = idealized "
                          "per-edge links (default), fifo/fair serialize a "
                          "sender's concurrent transfers on one uplink")
    sim.add_argument("--bandwidth-trace", default=None,
                     dest="bandwidth_trace",
                     help='JSON file {"times": [...], "scale": [...]} of '
                          "time-varying bandwidth multipliers (scale rows "
                          "scalar or per-client)")
    sim.add_argument("--sim-checkpoint", default="", dest="sim_checkpoint",
                     help="save the full simulator state (virtual clock, "
                          "event queue, link stats) to this .npz every "
                          "--checkpoint-every rounds; resume with --resume")

    lm = sub.add_parser("lm")
    lm.add_argument("--arch", default="qwen3-8b",
                    help="a decoder smoke arch (repro_torch.configs."
                         "SMOKE_ARCHS; an unknown name raises KeyError)")
    lm.add_argument("--clients", type=int, default=4)
    lm.add_argument("--steps", type=int, default=100)
    lm.add_argument("--rounds", type=int, default=10)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--batch-size", type=int, default=8, dest="batch_size")
    lm.add_argument("--lr", type=float, default=0.05)
    lm.add_argument("--density", type=float, default=0.5)
    lm.add_argument("--d-model", type=int, default=256, dest="d_model")
    lm.add_argument("--layers", type=int, default=2)
    lm.add_argument("--tokens-per-client", type=int, default=32768,
                    dest="tokens_per_client")
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def check_args(ap: argparse.ArgumentParser, args) -> None:
    """The reference's refusals of flag combinations (``ap.error`` exits),
    then the simulator's defaults, resolved after the guards with ``is
    None`` so an explicit 0 reaches the models' own validation.  ``lm``
    refuses the encoder-decoder arch."""
    if args.mode == "lm":
        try:
            lm_config(args)
        except ValueError as e:
            ap.error(str(e))
        return
    if args.mesh_shape and not args.scale:
        ap.error("--mesh-shape require(s) --scale")
    if args.mesh_shape and not _mesh_dims(args.mesh_shape):
        ap.error(f"--mesh-shape wants DATAxMODEL or PODSxDATAxMODEL, got "
                 f"{args.mesh_shape!r}")
    if args.scale and args.sim:
        ap.error("--scale and --sim are mutually exclusive engines")
    if args.trace_mode is not None and not (args.trace or args.run_dir):
        ap.error("--trace-mode requires --trace or --run-dir")
    if not args.scale and args.scale_reduction != "einsum":
        ap.error("--scale-reduction require(s) --scale")
    if not args.sim:
        sim_only = {"--async": args.sim_async,
                    "--staleness": args.staleness is not None,
                    "--bandwidth-mbps": args.bandwidth_mbps is not None,
                    "--bandwidth-skew": args.bandwidth_skew is not None,
                    "--latency-ms": args.latency_ms is not None,
                    "--compute-hetero": args.compute_hetero,
                    "--round-s": args.round_s is not None,
                    "--loss-prob": args.loss_prob is not None,
                    "--retransmit-timeout":
                        args.retransmit_timeout is not None,
                    "--uplink-mode": args.uplink_mode is not None,
                    "--bandwidth-trace": args.bandwidth_trace is not None,
                    "--sim-checkpoint": bool(args.sim_checkpoint)}
        used = [f for f, on in sim_only.items() if on]
        if used:
            ap.error(f"{', '.join(used)} require(s) --sim")
    args.staleness = 2 if args.staleness is None else args.staleness
    args.bandwidth_mbps = (100.0 if args.bandwidth_mbps is None
                           else args.bandwidth_mbps)
    args.bandwidth_skew = (1.0 if args.bandwidth_skew is None
                           else args.bandwidth_skew)
    args.latency_ms = 10.0 if args.latency_ms is None else args.latency_ms
    args.round_s = 1.0 if args.round_s is None else args.round_s
    args.loss_prob = 0.0 if args.loss_prob is None else args.loss_prob
    args.retransmit_timeout = (0.5 if args.retransmit_timeout is None
                               else args.retransmit_timeout)
    args.uplink_mode = ("parallel" if args.uplink_mode is None
                        else args.uplink_mode)
    if args.sim and args.bandwidth_skew < 1.0:
        ap.error("--bandwidth-skew must be >= 1 (1 = uniform links)")


def parse_args(argv: Optional[Sequence[str]] = None):
    """Parsed and checked arguments, the simulator's defaults resolved."""
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.mode == "lm":
        return run_lm(args)
    return run_simulate(args)


if __name__ == "__main__":
    main()
