"""One rank of the gloo world ``test_torch_mesh_steps.py`` spawns on the CPU
(a module of its own, so a spawned rank imports torch and the port, not
jax).  ``run_rank`` runs every case and writes ``rank<r>.json``: per
meshed step its gap to the unsharded step on the same inputs and the
collectives it dispatched and the placements its state comes back at, the
sharded ring against the roll of the whole stack, and the client widths of
the ``ScaleEngine``'s vmapped calls."""
import dataclasses
import json
import os

import torch
import torch.distributed as dist

ARCH = "qwen3-8b"
SEQ, GLOBAL_BATCH = 64, 4
WORLD = 4
SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
          "decode": "decode_32k"}


def _plan(mesh, mode):
    from repro_torch.configs import INPUT_SHAPES, SMOKE_ARCHS
    from repro_torch.launch import steps

    shape = dataclasses.replace(INPUT_SHAPES[SHAPES[mode]], seq_len=SEQ,
                                global_batch=GLOBAL_BATCH)
    return steps.plan_for(SMOKE_ARCHS[ARCH], shape, mesh, torch.float32)


def _inputs(step, seed):
    """The step's arguments, the same global tensors on every rank: params
    ~ N(0, 0.05^2) and masked (DisPFL state is), masks 0/1, tokens in the
    vocabulary, an all-ones adjacency, lr 0.1, a zero cache, decode
    positions 3 and 5."""
    from repro_torch.launch.dryrun import materialize
    from repro_torch.utils.tree import tree_map

    gen = torch.Generator().manual_seed(seed)
    args = list(materialize(step.args, step.plan.arch.vocab, "cpu", gen))
    if step.mode == "train":
        args[0] = tree_map(lambda w, m: w * 0.05 * m.float(), args[0],
                           args[1])
        args[3] = torch.ones_like(args[3])
        args[4] = 0.1
    else:
        args[0] = tree_map(lambda w: w * 0.05, args[0])
        args[2] = tree_map(torch.zeros_like, args[2])
        if step.mode == "decode":
            args[1]["pos"] = torch.tensor([3, 5], dtype=torch.int32)
    return args


def _gap(got, want) -> dict:
    from repro_torch.utils.tree import tree_leaves
    a = [x.double() for x in tree_leaves(got)]
    b = [x.double() for x in tree_leaves(want)]
    return {"max_abs": max(float((x - y).abs().max()) for x, y in zip(a, b)),
            "scale": max(float(y.abs().max()) for y in b),
            "n_leaves": len(a)}


def _step_cases(mesh) -> dict:
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.utils.collectives import collective_bytes
    from repro_torch.utils.tree import tree_leaves, tree_map

    out = {}
    for mode in SHAPES:
        plan = _plan(mesh, mode)
        api = bind(plan.arch)
        single = dataclasses.replace(plan, mesh=None)
        for gossip in (("einsum", "ppermute") if mode == "train" else
                       ("",)):
            step = (steps.lower_train(api, plan, gossip) if gossip else
                    steps.lower_serve(api, plan))
            args = _inputs(step, seed=len(out))
            plain = (steps.make_train_step(api, single, gossip)
                     if gossip else steps.make_prefill_step(api, single)
                     if mode == "prefill" else
                     steps.make_decode_step(api, single))
            want = plain(*[tree_map(torch.clone, a)
                           if not isinstance(a, float) else a for a in args])
            placed = step.place(*args)
            got, stats = collective_bytes(step, *placed)
            # the state a step returns: train's params, serve's cache
            state_in, state_out = placed[0 if gossip else 2], got[
                0 if gossip else 1]
            kept = [[str(p) for p in x.placements]
                    for x in tree_leaves(state_out)]
            got = tree_map(lambda x: x.full_tensor(), got)
            out[f"{mode}-{gossip}" if gossip else mode] = {
                **_gap(got, want), "n_clients": plan.n_clients,
                "placements_in": [[str(p) for p in x.placements]
                                  for x in tree_leaves(state_in)],
                "placements_out": kept,
                "per_client_batch": plan.per_client_batch,
                "bytes": stats.bytes_by_kind, "counts": stats.count_by_kind}
    return out


def _bits(x) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else
                  torch.int32 if x.element_size() == 4 else torch.int8)


def _ring_case(mesh, k, degree, dtype) -> dict:
    """The sharded ring on ``k`` stacked smoke-arch clients placed at
    ``state_shardings``' placements, against ``ppermute_gossip`` on the
    whole stack: bits, collective bytes, and the boundary rows' bytes
    this rank's shards make (per hop h, min(h, n) rows each way a leaf,
    weight and int8 mask)."""
    from repro_torch.configs import INPUT_SHAPES, SMOKE_ARCHS
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import materialize
    from repro_torch.launch.gossip_opt import ppermute_gossip
    from repro_torch.models import bind
    from repro_torch.utils.collectives import collective_bytes
    from repro_torch.utils.tree import tree_leaves, tree_map

    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=k)
    plan = dataclasses.replace(
        steps.plan_for(SMOKE_ARCHS[ARCH], shape, mesh, dtype), n_clients=k,
        per_client_batch=1)
    api = bind(plan.arch)
    step = steps.lower_train(api, plan, "ppermute")
    params, masks = materialize(step.args[:2], plan.arch.vocab, "cpu",
                                torch.Generator().manual_seed(7))
    want = ppermute_gossip(params, masks, degree=degree)
    placed_p, placed_m = step.place(params, masks)
    got, stats = collective_bytes(ppermute_gossip, placed_p, placed_m,
                                  degree=degree)
    # the roll by ±h carries min(h, n) of a rank's n rows across its shard
    # boundary, each way
    n = tree_leaves(placed_p)[0].to_local().shape[0]
    rows = sum(2 * min(h, n) for h in range(1, max(1, degree // 2) + 1))
    boundary = sum(
        rows * (w.to_local()[0].numel() * w.element_size()
                + m.to_local()[0].numel())
        for w, m in zip(tree_leaves(placed_p), tree_leaves(placed_m)))
    got = tree_map(lambda x: x.full_tensor(), got)
    return {"bit_equal": all(torch.equal(_bits(a), _bits(b)) for a, b in
                             zip(tree_leaves(got), tree_leaves(want))),
            "bytes": stats.bytes_by_kind, "counts": stats.count_by_kind,
            "boundary_bytes": boundary,
            "placements": sorted({tuple(str(p) for p in x.placements)
                                  for x in tree_leaves(placed_p)})}


def call_widths(mesh=None) -> list:
    """The clients each vmapped call of one ``ScaleEngine`` round took
    (local phase, evolve gradients, eval), on ``mesh`` or unsharded."""
    import _torch_mesh_world as world

    from repro_torch.scale import engine as engine_mod

    eng = world.engine("ordered", mesh)
    saved = (engine_mod.stacked_local_phase, engine_mod.stacked_grads)
    seen = []

    def local(apply_fn, opt, p, *rest):
        seen.append(("local", int(rest[1].shape[0])))
        return saved[0](apply_fn, opt, p, *rest)

    def grads(apply_fn, p, x, y):
        seen.append(("evolve", int(x.shape[0])))
        return saved[1](apply_fn, p, x, y)

    acc = eng.task.accuracy_stacked

    def accuracy(p, x, *rest):
        seen.append(("eval", int(x.shape[0])))
        return acc(p, x, *rest)

    engine_mod.stacked_local_phase, engine_mod.stacked_grads = local, grads
    eng.task.accuracy_stacked = accuracy
    try:
        next(eng.rounds())
    finally:
        engine_mod.stacked_local_phase, engine_mod.stacked_grads = saved
        eng.task.accuracy_stacked = acc
    return seen


def run_rank(rank, world_size, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world_size), rank=rank,
        world_size=world_size)
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(2, 2, device_type="cpu")
    out = {"steps": _step_cases(mesh),
           "ring": {"2x2-k2-d2": _ring_case(mesh, 2, 2, torch.float32),
                    "2x2-k4-d4-bf16": _ring_case(mesh, 4, 4,
                                                 torch.bfloat16)},
           "widths": {"2x2": call_widths(mesh)}}
    mesh41 = make_test_mesh(4, 1, device_type="cpu")
    out["ring"]["4x1-k8-d4"] = _ring_case(mesh41, 8, 4, torch.float32)
    out["widths"]["4x1"] = call_widths(mesh41)
    if rank == 0:
        out["widths"]["unsharded"] = call_widths()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
