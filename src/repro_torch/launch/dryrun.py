"""Dry run: trace every (arch x input-shape) step on fake tensors and say
whether it fits, and what it costs (reference ``repro.launch.dryrun``,
which lowers and compiles each step on a 512-device host mesh).  Two
kinds of plan:

* one H100 (mesh ``h100x1``, the default): K clients on the card;
* the reference's meshes (``--multi-pod``: ``pod2x16x16``;
  ``--both-meshes``: ``pod16x16`` then ``pod2x16x16``), on a fake world
  of 256 or 512 ranks (``launch.mesh``, ``backend="fake"``):
  ``steps.lower_for``'s plan and meshed step, traced for rank 0 on fake
  ``DTensor`` shards.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --multi-pod \
        --device cpu

For each combination this script
  1. plans K = ``--clients`` clients of ``--per-client-batch`` rows each
     (the least K with a gossip by default, 2 x 1) at the shape's sequence
     length, in ``--dtype`` (bf16 by default, as the reference's plan);
  2. binds the models under ``--remat`` (``full`` by default, as the
     reference's: each block recomputed in the backward, ``models.remat``;
     ``dots`` keeps the matmul outputs too; ``none`` keeps every
     activation; a record of another value than ``full`` is tagged
     ``__remat_<p>``, as the reference's) and builds params, int8 masks,
     batch and cache as fake tensors (``FakeTensorMode``: shapes and
     dtypes, no storage) on ``--device``;
  3. runs the train (train shapes), prefill or decode step once under
     ``utils.trace_cost.step_cost``: FLOPs, bytes accessed, the arguments',
     outputs' and peak live bytes, the top aten ops;
  4. writes a JSON artifact (``experiments/torch_dryrun/`` by default) in
     the reference's fields where they mean the same thing, with the
     roofline of ``launch.roofline`` and ``fits``: the peak live bytes
     against the card's memory.

A step that does not fit is a result (``status: ok``, ``fits: false``).
A trace that fails is written ``status: failed`` and the run exits 1.
Nothing is compiled (the steps run eagerly), so ``compile_s`` is 0;
``trace_s`` is the trace's own time.  On one card there are no
collectives: ``collectives`` holds empty counts, and
``coll_bytes_per_device`` is 0.

A mesh record is the reference's: ``chips``, ``n_clients``,
``per_client_batch``, ``fsdp2d``, ``seq_data``, ``collectives`` (per kind,
``utils.collectives``' counts of the ops rank 0 dispatched) and
``coll_bytes_per_device``, whose roofline term is over
``roofline.LINK_BW``; FLOPs, bytes and the peak are rank 0's, ``fits``
against one card's memory, and ``analytic_state_bytes_per_device`` the
bytes of the arguments' local shards.  ``--smoke`` takes the reduced
archs, the reference's reduced shapes (``seq_len = max(64, seq_len //
4096)``, ``global_batch = min(gb, 8)``) and its 2x2(x2) test meshes
(``testpod16x16``, ``testpod2x16x16``).  A meshed step splits each of a
rank's clients over 'model' (``launch.steps``, ``sharding.tp``), as the
reference's GSPMD program does, so a mesh record says ``"tp": true``, its
FLOPs, bytes and peak are a rank's share, and ``launch.report`` tables it
beside the reference's record of the same mesh.  ``replicated`` names the
ops the models computed replicated over 'model' because |model| does not
divide the dim they would split (``sharding.tp.replicated``).  No input
is gathered whole: the batch and the cache reach the models at their
placements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_map_only

from repro_torch.configs import ARCHS, INPUT_SHAPES, SMOKE_ARCHS
from repro_torch.configs.base import InputShape
from repro_torch.device import setup_device
from repro_torch.launch import steps
from repro_torch.launch.roofline import build_report, total_params
from repro_torch.models import bind
from repro_torch.models.registry import meta_spec
from repro_torch.utils.trace_cost import FLOPS_COUNTED_BY, step_cost

# long_500k needs sub-quadratic attention / recurrent decode; only these
# archs run it (the reference's DESIGN.md §Arch-applicability) — pure
# full-attention archs skip with a recorded reason.
LONG_CONTEXT_OK = {"gemma3-1b", "mamba2-1.3b", "jamba-1.5-large-398b"}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "torch_dryrun")
MESH = "h100x1"
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
DEFAULT_CLIENTS, DEFAULT_ROWS = 2, 1
# the card's memory where no card is present: the H100 SXM data sheet's
# 80 GB, taken as 80 GiB
DATA_SHEET_MEMORY = 80 * 2 ** 30
# the reference's refusal: eager steps have no layer scan
REFUSED = {
    "--unroll": "the port's steps run eagerly: every layer's ops are "
                "dispatched and counted, so there is no layer scan to unroll",
}
#: ``--remat``'s values, the reference's: a ``models.remat`` policy, or
#: ``none`` (every activation kept); ``full`` is the default
REMAT = ("full", "dots", "none")


def remat_options(remat: str) -> dict:
    """``bind``'s ``remat`` and ``remat_policy`` for a ``--remat`` value,
    as the reference passes them."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    return {"remat": remat != "none",
            "remat_policy": "full" if remat == "none" else remat}


def should_skip(arch_name: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch_name not in LONG_CONTEXT_OK:
        return ("full-attention arch: 500k decode KV memory/latency is not "
                "servable without sliding-window/SSM; skipped per assignment")
    return None


def device_memory() -> tuple[int, str]:
    """The card's memory in bytes, and where the figure came from."""
    if torch.cuda.is_available():
        return (int(torch.cuda.get_device_properties(0).total_memory),
                f"torch.cuda.get_device_properties(0).total_memory "
                f"({torch.cuda.get_device_name(0)})")
    return DATA_SHEET_MEMORY, ("H100 SXM data sheet, 80 GB taken as 80 GiB "
                               "(no card present)")


def step_and_specs(api, plan: steps.ScalePlan, gossip: str = "einsum"):
    """The plan's step and its arguments as ``meta`` tensors: (params,
    masks, batch, adjacency, lr) for a train step, (params, batch, cache)
    for prefill and decode.  The learning rate is a float32 scalar tensor,
    as the reference lowers it."""
    params = steps.abstract_params(api, plan)
    batch = steps.input_specs(api, plan)
    if plan.shape.mode == "train":
        k = plan.n_clients
        return (steps.make_train_step(api, plan, gossip),
                (params, steps.abstract_masks(params), batch,
                 meta_spec((k, k), torch.float32),
                 meta_spec((), torch.float32)))
    build = (steps.make_prefill_step if plan.shape.mode == "prefill"
             else steps.make_decode_step)
    return build(api, plan), (params, batch, steps.abstract_cache(api, plan))


def materialize(specs, vocab: int, device, gen: torch.Generator):
    """Real tensors for ``step_and_specs``' train-step specs, drawn from
    ``gen`` on ``device``, so the traced step can be run and counted for
    real: floats ~ N(0, 1), int8 masks 0/1, int32 tokens and labels in
    [0, vocab)."""
    def draw(s):
        if s.dtype == torch.int8:
            return torch.randint(0, 2, s.shape, generator=gen, device=device,
                                 dtype=torch.int8)
        if s.dtype == torch.int32:
            return torch.randint(0, vocab, s.shape, generator=gen,
                                 device=device, dtype=torch.int32)
        return torch.randn(s.shape, generator=gen, device=device).to(s.dtype)

    return tree_map_only(torch.Tensor, draw, specs)


def trace_plan(plan: steps.ScalePlan, gossip: str = "einsum",
               device: str = "cuda", remat: str = "full"):
    """One step of ``plan`` on fake tensors of ``device``, the model bound
    under ``remat`` (``REMAT``); returns its ``StepCost`` and the trace's
    seconds."""
    api = bind(plan.arch, **remat_options(remat))
    step, specs = step_and_specs(api, plan, gossip)
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = tree_map_only(
            torch.Tensor,
            lambda s: torch.empty(s.shape, dtype=s.dtype, device=device),
            specs)
        _, cost = step_cost(step, *args)
    return cost, time.perf_counter() - t0


def make_plan(arch, shape: InputShape, n_clients: int, per_client_batch: int,
              dtype: str) -> steps.ScalePlan:
    """K clients of ``per_client_batch`` rows at ``shape``'s sequence
    length: the plan's global batch is K x rows, so ``model_flops`` prices
    the work the card does."""
    return steps.ScalePlan(
        arch, dataclasses.replace(shape,
                                  global_batch=n_clients * per_client_batch),
        n_clients, per_client_batch, DTYPES[dtype])


def _mesh_name(smoke: bool, multi_pod: bool | None) -> str:
    """``h100x1`` for one card (``multi_pod`` None), else the reference's
    mesh names; ``test`` before either under ``--smoke``."""
    return ("test" if smoke else "") + (
        MESH if multi_pod is None else
        "pod2x16x16" if multi_pod else "pod16x16")


def _tag(arch_name, shape_name, mesh, gossip, dtype, k=None,
         rows=None, remat: str = "full") -> str:
    """The artifact's name: the reference's (``__remat_<p>`` for a policy
    other than ``full``), then the dtype where not bf16 and a one-card
    plan's K x rows where they are not the default (a mesh's ``plan_for``
    sets them: ``k`` None)."""
    return (f"{arch_name}__{shape_name}__{mesh}"
            + (f"__{gossip}" if gossip != "einsum" else "")
            + (f"__remat_{remat}" if remat != "full" else "")
            + (f"__{dtype}" if dtype != "bf16" else "")
            + (f"__k{k}x{rows}" if k is not None and (k, rows) != (
                DEFAULT_CLIENTS, DEFAULT_ROWS) else ""))


def analytic_state_bytes_per_device(plan, args) -> int:
    """The bytes one rank holds of a meshed step's arguments: each
    ``DTensor``'s local shard (the reference's argument bytes of the
    partitioned program)."""
    del plan
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    return sum(t.to_local().numel() * t.element_size()
               for t in tree_flatten(args)[0] if isinstance(t, DTensor))


def trace_meshed(arch, shape, multi_pod: bool, gossip: str, smoke: bool,
                 dtype: str, device: str, remat: str = "full"):
    """``lower_for``'s plan on the fake world's mesh (the 2x2(x2) test
    mesh for ``smoke``) and one call of its ``MeshedStep`` for rank 0, on
    fake ``DTensor`` shards of ``device``.  Returns the plan, the mesh's
    size, the step's ``StepCost`` and ``CollectiveStats``, the state
    bytes a rank holds, the ops the models left replicated over 'model'
    and the trace's seconds."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.utils.collectives import collective_bytes

    if smoke:
        mesh = make_test_mesh(2, 2, pods=2 if multi_pod else 0,
                              device_type=device, backend="fake")
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device,
                                    backend="fake")
    from repro_torch.sharding.tp import record_replicated

    plan, step = steps.lower_for(arch, shape, mesh, gossip, DTYPES[dtype],
                                 **remat_options(remat))
    t0 = time.perf_counter()
    with FakeTensorMode(), record_replicated() as replicated:
        args = step.abstract_args(device)
        (_, cost), coll = collective_bytes(step_cost, step, *args)
    return (plan, mesh.size(), cost, coll,
            analytic_state_bytes_per_device(plan, args), sorted(replicated),
            time.perf_counter() - t0)


def run_one(arch_name: str, shape_name: str, gossip: str = "einsum",
            out_dir: str = OUT_DIR, verbose: bool = True, smoke: bool = False,
            n_clients: int = DEFAULT_CLIENTS,
            per_client_batch: int = DEFAULT_ROWS, dtype: str = "bf16",
            device: str = "cuda", multi_pod: bool | None = None,
            remat: str = "full") -> dict:
    """One combination's record.  ``multi_pod`` None plans one card (mesh
    ``h100x1``, K = ``n_clients``); False and True the reference's
    single-pod and multi-pod mesh on a fake world (``plan_for`` sets K).
    ``remat`` (``REMAT``) is the models' rematerialisation, as the
    reference's ``--remat``."""
    meshed = multi_pod is not None
    arch = ARCHS[arch_name]
    shape = INPUT_SHAPES[shape_name]
    if smoke:
        # reduced configs + tiny shapes (the reference's smoke reduction):
        # exercises the whole trace in seconds
        arch = SMOKE_ARCHS[arch_name]
        shape = dataclasses.replace(shape, seq_len=max(64,
                                                       shape.seq_len // 4096))
        if meshed:
            shape = dataclasses.replace(
                shape, global_batch=min(shape.global_batch, 8))
    mesh = _mesh_name(smoke, multi_pod)
    tag = _tag(arch_name, shape_name, mesh, gossip, dtype,
               *(() if meshed else (n_clients, per_client_batch)),
               remat=remat)
    record: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh,
                    "gossip": gossip, "tag": tag, "dtype": dtype,
                    "remat": remat, "smoke": smoke}
    if not meshed:
        record.update(n_clients=n_clients, per_client_batch=per_client_batch)
    skip = should_skip(arch_name, shape_name)
    if skip and not smoke:
        record.update(status="skipped", reason=skip)
        _write(out_dir, tag, record)
        if verbose:
            print(f"[dryrun] SKIP {tag}: {skip}")
        return record

    coll_row, coll_bytes, extra = {"total_GB": 0.0, "counts": {}}, 0.0, {}
    if meshed:
        plan, chips, cost, coll, state_bytes, repl, trace_s = trace_meshed(
            arch, shape, multi_pod, gossip, smoke, dtype, device, remat)
        coll_row, coll_bytes = coll.row(), coll.total_bytes
        extra = {"tp": True, "replicated": repl,
                 "n_clients": plan.n_clients,
                 "per_client_batch": plan.per_client_batch,
                 "fsdp2d": plan.fsdp2d, "seq_data": plan.seq_data,
                 "analytic_state_bytes_per_device": state_bytes}
    else:
        chips = 1
        plan = make_plan(arch, shape, n_clients, per_client_batch, dtype)
        cost, trace_s = trace_plan(plan, gossip, device, remat)
    mem_bytes, mem_source = device_memory()
    cost_row = {"flops": float(cost.flops),
                "bytes accessed": float(cost.bytes_accessed)}
    report = build_report(arch, plan.shape, mesh, chips, cost_row,
                          coll_bytes, dtype=dtype)
    record.update(
        status="ok",
        chips=chips,
        **extra,
        device=device,
        seq_len=plan.shape.seq_len,
        global_batch=plan.shape.global_batch,
        shape_global_batch=INPUT_SHAPES[shape_name].global_batch,
        trace_s=round(trace_s, 3),
        compile_s=0,
        memory={"argument_size_in_bytes": cost.argument_bytes,
                "output_size_in_bytes": cost.output_bytes,
                "temp_size_in_bytes": cost.temp_bytes},
        peak_live_bytes=cost.peak_live_bytes,
        device_memory_bytes=mem_bytes,
        device_memory_source=mem_source,
        fits=cost.peak_live_bytes <= mem_bytes,
        cost=cost_row,
        flops_counted_by=FLOPS_COUNTED_BY,
        collectives=coll_row,
        coll_bytes_per_device=coll_bytes,
        total_params=total_params(arch),
        roofline=report.row(),
        aten_ops=cost.aten_ops,
    )
    _write(out_dir, tag, record)
    if verbose:
        print(f"[dryrun] OK {tag}: K={plan.n_clients}x{plan.per_client_batch} "
              f"trace={trace_s:.1f}s peak={cost.peak_live_bytes / 2 ** 30:.2f}"
              f" GiB fits={record['fits']} bottleneck={report.bottleneck} "
              f"terms(ms)=({report.compute_s * 1e3:.2f}, "
              f"{report.memory_s * 1e3:.2f}, {report.collective_s * 1e3:.2f})"
              + (f" coll={coll_bytes / 1e9:.4f} GB/dev {coll_row['counts']}"
                 if meshed else ""))
    return record


def _write(out_dir: str, tag: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=2, default=str)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--gossip", default="einsum", choices=steps.GOSSIP_MODES)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced archs + tiny shapes")
    ap.add_argument("--clients", type=int, default=None,
                    help="K clients on the card (default 2: the least K "
                         "with a gossip; h100x1 only)")
    ap.add_argument("--per-client-batch", type=int, default=None,
                    dest="per_client_batch",
                    help="rows per client (default 1; h100x1 only)")
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device: cuda (default; raises "
                         "without a GPU) or cpu")
    ap.add_argument("--multi-pod", action="store_true", dest="multi_pod",
                    help="the reference's multi-pod mesh on a fake world")
    ap.add_argument("--both-meshes", action="store_true", dest="both_meshes",
                    help="the single-pod mesh, then the multi-pod one")
    ap.add_argument("--remat", default="full", choices=REMAT,
                    help="the models' rematerialisation (models.remat): "
                         "full (default, as the reference's), dots, or none")
    ap.add_argument("--unroll", action="store_true")
    return ap


def parse_args(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.unroll:
        ap.error(f"--unroll: {REFUSED['--unroll']}")
    args.meshes = ([False, True] if args.both_meshes else
                   [True] if args.multi_pod else [None])
    if args.meshes != [None] and (args.clients, args.per_client_batch) != (
            None, None):
        ap.error("--clients and --per-client-batch plan one card: on a "
                 "mesh plan_for sets K and the rows")
    args.clients = DEFAULT_CLIENTS if args.clients is None else args.clients
    args.per_client_batch = (DEFAULT_ROWS if args.per_client_batch is None
                             else args.per_client_batch)
    if args.clients < 1 or args.per_client_batch < 1:
        ap.error("--clients and --per-client-batch must be >= 1")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_device(args.device)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    failures = []
    for mp in args.meshes:
        mesh = _mesh_name(args.smoke, mp)
        for a in archs:
            for s in shapes:
                tag = _tag(a, s, mesh, args.gossip, args.dtype,
                           *(() if mp is not None else
                             (args.clients, args.per_client_batch)),
                           remat=args.remat)
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[dryrun] cached {tag}")
                            continue
                try:
                    run_one(a, s, gossip=args.gossip, out_dir=args.out,
                            smoke=args.smoke, n_clients=args.clients,
                            per_client_batch=args.per_client_batch,
                            dtype=args.dtype, device=args.device,
                            multi_pod=mp, remat=args.remat)
                except Exception:
                    traceback.print_exc()
                    failures.append(tag)
                    _write(args.out, tag,
                           {"arch": a, "shape": s, "mesh": mesh, "tag": tag,
                            "gossip": args.gossip, "remat": args.remat,
                            "status": "failed",
                            "error": traceback.format_exc()[-2000:]})
    if failures:
        print(f"[dryrun] FAILURES ({len(failures)}):")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("[dryrun] every combination traced or skipped")


if __name__ == "__main__":
    main()
