"""One rank of the gloo world ``test_torch_mesh_steps.py`` spawns on the CPU
(a module of its own, so a spawned rank imports torch and the port, not
jax).  ``run_rank`` runs every case and writes ``rank<r>.json``: on the
2x2 and 1x4 meshes, ``sharding.tp``'s ops under ``vmap(grad)`` and
``grad(vmap)`` against the one-process function, and per arch and meshed
step its gap to the unsharded step on the same inputs (a random cache),
the collectives it dispatched (by kind and by kind and axis, the 'model'
all-gathers that sent a shard of a 'model'-sharded weight leaf, and the
all-gathers that sent a shard of a cache leaf or of a batch leaf split
over 'data': ``SentSums``, ``weight_shard_gathers``,
``input_shard_gathers``, which ``chip_smoke.py`` imports too), the ops it
noted as computed replicated (``sharding.tp.record_replicated``) and the
placements its state comes back at; the long-context decode of one row
on a cache whose sequence is split over 'data' (``seq_data``); the
sharded ring against the roll of the whole stack; and the client widths
of the ``ScaleEngine``'s vmapped calls."""
import dataclasses
import json
import os

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch.utils.collectives import CollectiveCounter

ARCH = "qwen3-8b"
SEQ, GLOBAL_BATCH = 64, 4
WORLD = 4
SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
          "decode": "decode_32k"}
#: mesh -> (data, model) and the smoke archs whose steps run on it
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
MESH_ARCHS = {"2x2": ("qwen3-8b", "deepseek-moe-16b", "mamba2-1.3b",
                      "jamba-1.5-large-398b"),
              "1x4": ("qwen3-8b", "deepseek-moe-16b", "mamba2-1.3b")}
#: the smoke archs planned as ``plan_for`` plans the published one: one
#: client, weights 2-D sharded (FSDP over 'data' + 'model')
FSDP2D = ("jamba-1.5-large-398b",)
#: long-context decode at 2x2 (``plan.seq_data``: one client of one row,
#: the cache's 64 positions in two chunks of 32 over 'data'): the smoke
#: archs and the decode positions, one in each chunk; at 40 gemma3's
#: 16-wide window crosses the chunk edge at 32
SEQ_DATA_ARCHS = ("gemma3-1b", "jamba-1.5-large-398b")
SEQ_DATA_POS = (20, 40)


def _plan(mesh, mode, arch=ARCH):
    from repro_torch.configs import INPUT_SHAPES, SMOKE_ARCHS
    from repro_torch.launch import steps

    shape = dataclasses.replace(INPUT_SHAPES[SHAPES[mode]], seq_len=SEQ,
                                global_batch=GLOBAL_BATCH)
    plan = steps.plan_for(SMOKE_ARCHS[arch], shape, mesh, torch.float32)
    if arch in FSDP2D:
        plan = dataclasses.replace(plan, n_clients=1,
                                   per_client_batch=GLOBAL_BATCH, fsdp2d=True)
    return plan


def _inputs(step, seed, pos=None):
    """The step's arguments, the same global tensors on every rank: params
    ~ N(0, 0.05^2) and masked (DisPFL state is), masks 0/1, tokens in the
    vocabulary, an all-ones adjacency, lr 0.1, a cache ~ N(0, 1) (so the
    attention over cached positions counts), decode positions ``pos`` or
    3, 5, ... (one a client)."""
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
        if step.mode == "decode":
            args[1]["pos"] = (torch.tensor(pos) if pos is not None else
                              3 + 2 * torch.arange(step.plan.n_clients)).to(
                torch.int32).reshape(step.plan.n_clients)
    return args


def _gap(got, want) -> dict:
    from repro_torch.utils.tree import tree_leaves
    a = [x.double() for x in tree_leaves(got)]
    b = [x.double() for x in tree_leaves(want)]
    return {"max_abs": max(float((x - y).abs().max()) for x, y in zip(a, b)),
            "scale": max(float(y.abs().max()) for y in b),
            "n_leaves": len(a)}


class SentSums(CollectiveCounter):
    """``utils.collectives.CollectiveCounter`` that also keeps the shape
    and float64 sum of the tensor this rank sent in each all-gather: a
    fingerprint of what travelled (real tensors only; an output is not
    read, the op may still be filling it), in ``sent`` for the
    all-gathers over 'model' and in ``sent_all`` for every all-gather,
    beside its axis."""

    def __init__(self):
        super().__init__()
        self.sent, self.sent_all = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = len(self.stats.ops)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if len(self.stats.ops) > n and self.stats.ops[-1][0] == "all-gather":
            # c10d's all-gathers take (outputs, input), the functional
            # ones (input, ...)
            src = args[0] if func.namespace == "_c10d_functional" else args[1]
            t = next(t for t in tree_flatten(src)[0]
                     if isinstance(t, torch.Tensor))
            mark = (tuple(t.shape), float(t.double().sum()))
            self.sent_all.append((self.stats.ops[-1][1],) + mark)
            if self.stats.ops[-1][1] == "model":
                self.sent.append(mark)
        return out


def weight_shard_gathers(sent, params, *wholes) -> list:
    """The sends of ``sent`` (a ``SentSums``' fingerprints of the
    all-gathers over 'model') that carried this rank's shard of a
    'model'-sharded weight leaf: what gathering such a leaf whole over
    'model' sends.  ``params`` are the step's placed ``DTensor`` params,
    each of ``wholes`` global values they may hold (those placed, those a
    train step's gossip mixed).  A shard is matched by shape and by its
    values' sum (1e-6 relative): the shard of the rank's clients, or of
    one client, one block of a stacked leaf, or both; its 'model' dim
    leading, as c10d gathers along dim 0; its FSDP dim this rank's or
    whole.  Returns the matching ``(shape, sum)``s."""
    import itertools

    from torch.distributed.tensor import Shard

    from repro_torch.launch.steps import client_range

    def own(t, dim, sub):
        n = t.shape[dim] // sub.size()
        return t.narrow(dim, sub.get_local_rank() * n, n)

    shards = []
    for x, *ws in zip(tree_flatten(params)[0],
                      *[tree_flatten(w)[0] for w in wholes]):
        mesh = x.device_mesh
        dims = {name: p.dim for name, p in zip(mesh.mesh_dim_names,
                                               x.placements)
                if isinstance(p, Shard)}
        if "model" not in dims or mesh["model"].size() == 1:
            continue
        k0, k1 = client_range(x)
        dm = dims["model"]
        mine = [own(w[k0:k1], dm, mesh["model"]) for w in ws]
        if dims.get("data", 0) != 0:
            mine += [own(t, dims["data"], mesh["data"]) for t in mine]
        # the stacked dims (clients, blocks) each kept whole or indexed
        lead = range(min(dm, x.dim() - 2))
        for t in mine:
            for pick in itertools.product(*[[None] + list(range(t.shape[d]))
                                            for d in lead]):
                u, g = t, dm
                for d in reversed(lead):
                    if pick[d] is not None:
                        u, g = u.select(d, pick[d]), g - 1
                sh = list(u.shape)
                shards.append((tuple([sh[g]] + sh[:g] + sh[g + 1:]),
                               float(u.double().sum())))
    return [(shape, total) for shape, total in sent
            if any(shape == sh and abs(total - s) <= 1e-6 * max(1.0, abs(s))
                   for sh, s in shards)]


def input_shard_gathers(sent_all, *placed) -> list:
    """The sends of ``sent_all`` (a ``SentSums``' fingerprints of every
    all-gather) that carried this rank's shard of a leaf of ``placed``
    (``DTensor`` trees: a step's cache, its batch) sharded over a mesh
    dim of more than one rank: what gathering that input whole sends.  A
    shard is matched by shape and by its values' sum (1e-6 relative): the
    shard of the rank's clients or of one client, any one of its dims
    leading (c10d gathers along dim 0).  Returns the matching ``(axis,
    shape, sum)``s."""
    from torch.distributed.tensor import Shard

    shards = []
    for x in (leaf for tree in placed for leaf in tree_flatten(tree)[0]):
        mesh = x.device_mesh
        if not any(isinstance(p, Shard) and mesh.size(i) > 1
                   for i, p in enumerate(x.placements)):
            continue
        local = x.to_local()
        for t in [local] + list(local.unbind(0)):
            total = float(t.double().sum())
            for d in range(t.dim()):
                sh = list(t.shape)
                shards.append((tuple([sh[d]] + sh[:d] + sh[d + 1:]), total))
    return [(axis, shape, total) for axis, shape, total in sent_all
            if any(shape == sh and abs(total - s) <= 1e-6 * max(1.0, abs(s))
                   for sh, s in shards)]


def axis_counts(stats) -> dict:
    """The collectives in ``stats`` by ``"kind/axis"``."""
    counts = {}
    for kind, axis, _ in stats.ops:
        key = f"{kind}/{axis}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def model_counts(stats) -> dict:
    """The collectives over 'model' in ``stats``, by kind."""
    counts = {}
    for kind, axis, _ in stats.ops:
        if axis == "model":
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def _model_ops(counter, params, *wholes) -> dict:
    """The 'model'-axis collectives of one step by kind, and its 'model'
    all-gathers that sent a 'model'-sharded weight leaf's shard of any of
    ``wholes`` (``weight_shard_gathers``)."""
    return {"model_counts": model_counts(counter.stats),
            "whole_weight_gathers": weight_shard_gathers(counter.sent, params,
                                                         *wholes)}


def _mixed(gossip, args) -> list:
    """A train step's params after its gossip, on the whole stack (the
    values its meshed step's models read); none for serve steps."""
    from repro_torch.launch.gossip_opt import ppermute_gossip
    from repro_torch.scale.stacked import masked_gossip_stacked

    if gossip == "einsum":
        return [masked_gossip_stacked(args[0], args[1], args[3],
                                      reduction="einsum")]
    return [ppermute_gossip(args[0], args[1])] if gossip else []


def _one_step(plan, gossip, seed, pos=None) -> dict:
    """``plan``'s meshed step (train with ``gossip``, else serve) against
    its unsharded twin on the same inputs, and what it dispatched."""
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.sharding.tp import record_replicated
    from repro_torch.utils.tree import tree_leaves, tree_map

    mode = plan.shape.mode
    api = bind(plan.arch, remat=False)
    single = dataclasses.replace(plan, mesh=None)
    step = (steps.lower_train(api, plan, gossip) if gossip else
            steps.lower_serve(api, plan))
    args = _inputs(step, seed, pos)
    plain = (steps.make_train_step(api, single, gossip)
             if gossip else steps.make_prefill_step(api, single)
             if mode == "prefill" else steps.make_decode_step(api, single))
    want = plain(*[tree_map(torch.clone, a)
                   if not isinstance(a, float) else a for a in args])
    placed = step.place(*args)
    counter = SentSums()
    with counter, record_replicated() as rep:
        got = step(*placed)
    stats = counter.stats
    # the state a step returns: train's params, serve's cache
    state_in, state_out = placed[0 if gossip else 2], got[0 if gossip else 1]
    kept = [[str(p) for p in x.placements] for x in tree_leaves(state_out)]
    got = tree_map(lambda x: x.full_tensor(), got)
    return {
        **_gap(got, want),
        **_model_ops(counter, placed[0], args[0], *_mixed(gossip, args)),
        # the cache (serve) and the batch: no shard of either all-gathered
        "input_gathers": input_shard_gathers(
            counter.sent_all, *(placed[2:3] if gossip else placed[1:3])),
        "n_clients": plan.n_clients,
        "placements_in": [[str(p) for p in x.placements]
                          for x in tree_leaves(state_in)],
        "placements_out": kept,
        "per_client_batch": plan.per_client_batch,
        "replicated": sorted(rep),
        "bytes": stats.bytes_by_kind, "counts": stats.count_by_kind,
        "axis_counts": axis_counts(stats)}


def _step_cases(mesh, arch=ARCH) -> dict:
    out = {}
    for mode in SHAPES:
        plan = _plan(mesh, mode, arch)
        for gossip in (("einsum", "ppermute") if mode == "train" else
                       ("",)):
            out[f"{mode}-{gossip}" if gossip else mode] = _one_step(
                plan, gossip, seed=len(out))
    return out


#: the archs whose meshed train step runs under ``remat="full"`` beside
#: its ``remat=False`` twin at 2x2 (``_remat_case``)
REMAT_ARCHS = ("qwen3-8b", "jamba-1.5-large-398b")


def _remat_case(mesh, arch) -> dict:
    """``arch``'s meshed train step (einsum gossip) bound with
    ``remat=True`` (``"full"``) and with ``remat=False``, on the same
    inputs: whether the params and losses are bit-equal, and each one's
    collective counts by kind and axis (the recompute issues the blocks'
    collectives again)."""
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.utils.tree import tree_leaves, tree_map

    plan = _plan(mesh, "train", arch)
    out, got = {}, {}
    for name, remat in (("none", False), ("full", True)):
        step = steps.lower_train(bind(plan.arch, remat=remat), plan,
                                 "einsum")
        placed = step.place(*_inputs(step, seed=5))
        counter = CollectiveCounter()
        with counter:
            res = step(*placed)
        got[name] = tree_map(lambda x: x.full_tensor(), res)
        out[f"axis_counts_{name}"] = axis_counts(counter.stats)
    out["bit_equal"] = all(
        torch.equal(_bits(a), _bits(b)) for a, b in
        zip(tree_leaves(got["full"]), tree_leaves(got["none"])))
    out["n_leaves"] = len(tree_leaves(got["full"]))
    return out


def _remat_tp_case(mesh) -> dict:
    """A block of ``sharding.tp`` ops (a column weight split over 'model'
    and a row weight, K=2 clients vmapped) through ``models.remat.
    checkpoint`` under each policy, its forward under ``use_mesh_rules``
    and ``backward()`` called outside the context (where the GPU's
    autograd thread runs it): per policy, whether this rank's gradients
    are bit-equal to the block's without rematerialisation (the recompute
    must run under the forward's mesh, issuing its collectives again)."""
    from repro_torch.models import remat
    from repro_torch.sharding import tp
    from repro_torch.sharding.ctx import use_mesh_rules

    gen = torch.Generator().manual_seed(13)
    k, b, d, f = 2, 4, 8, 8
    x, w1, w2 = (torch.randn(k, b, d, generator=gen),
                 torch.randn(k, d, f, generator=gen),
                 torch.randn(k, f, d, generator=gen))
    with use_mesh_rules(mesh):
        n, r = tp.axis_size("model"), tp.axis_rank("model")
    cols = slice(r * f // n, (r + 1) * f // n)
    local = (x, w1[:, :, cols].contiguous(), w2[:, cols].contiguous())

    def block(x, w1, w2):
        h = torch.tanh(tp.copy_to(x) @ w1)
        return (tp.reduce_from(h @ w2),)

    grads = {}
    for policy in ("none",) + remat.POLICIES:
        fn = block if policy == "none" else (
            lambda *a, p=policy: remat.checkpoint(block, a, p))
        leaves = [t.clone().requires_grad_() for t in local]
        with use_mesh_rules(mesh):
            loss = torch.square(torch.func.vmap(fn)(*leaves)[0]).sum()
        loss.backward()
        grads[policy] = [t.grad for t in leaves]
    return {p: all(torch.equal(a, b) for a, b in
                   zip(grads[p], grads["none"])) for p in remat.POLICIES}


def _seq_data_cases(mesh) -> dict:
    """Each ``SEQ_DATA_ARCHS`` decode step of one client of one row, the
    cache's sequence split over 'data' (``seq_data``), at each
    ``SEQ_DATA_POS``."""
    from repro_torch.configs import INPUT_SHAPES, SMOKE_ARCHS
    from repro_torch.launch import steps

    shape = dataclasses.replace(INPUT_SHAPES["long_500k"], seq_len=SEQ,
                                global_batch=1)
    out = {}
    for arch in SEQ_DATA_ARCHS:
        plan = dataclasses.replace(steps.plan_for(
            SMOKE_ARCHS[arch], shape, mesh, torch.float32), seq_data=True)
        for pos in SEQ_DATA_POS:
            out[f"{arch}/seq_data-pos{pos}"] = _one_step(
                plan, "", seed=pos, pos=[pos])
    return out


def _tp_case(mesh) -> dict:
    """``sharding.tp``'s four ops and ``whole`` in one function of K=3
    clients' weights (a column weight, FSDP-sharded over 'data' on its
    rows and split over 'model' on its columns; a row weight split over
    'model') under
    ``vmap(grad)``, ``grad(vmap)`` and ``vmap`` with ``backward()`` called
    outside the mesh context, against the one-process function on the
    whole weights: the largest gap of the value and of each gradient
    (this rank's slice), relative to ``max(1, max|ref|)``."""
    from repro_torch.sharding import tp
    from repro_torch.sharding.ctx import use_mesh_rules

    gen = torch.Generator().manual_seed(11)
    k, b, d, f = 3, 4, 8, 8
    w1, w2 = torch.randn(k, d, f, generator=gen), torch.randn(
        k, f, d, generator=gen)
    x = torch.randn(k, b, d, generator=gen)
    m, r = mesh["model"].size(), mesh["model"].get_local_rank()
    nd, rd = mesh["data"].size(), mesh["data"].get_local_rank()
    cols, rows = slice(r * f // m, (r + 1) * f // m), slice(
        rd * d // nd, (rd + 1) * d // nd)

    def plain(w1, w2, x):
        h = torch.tanh(x @ w1)
        return (torch.square(h @ w2).sum() + (torch.sin(h) * h).sum())

    def split(w1, w2, x):
        h = torch.tanh(tp.copy_to(x) @ tp.whole(w1, 0, d))
        z = tp.split_to(torch.sin(tp.gather_from(h)))
        return (torch.square(tp.reduce_from(h @ w2)).sum()
                + tp.reduce_from((z * h).sum()))

    def total(fn):
        return lambda *a: torch.func.vmap(fn)(*a).sum()

    want_v = torch.func.vmap(plain)(w1, w2, x)
    want_g = torch.func.grad(total(plain), argnums=(0, 1, 2))(w1, w2, x)
    want_g = (want_g[0][:, rows, cols], want_g[1][:, cols], want_g[2])
    local = (w1[:, rows, cols].contiguous(), w2[:, cols].contiguous(), x)
    with use_mesh_rules(mesh):
        got_v = torch.func.vmap(split)(*local)
        grads = {"grad(vmap)": torch.func.grad(
                     total(split), argnums=(0, 1, 2))(*local),
                 "vmap(grad)": torch.func.vmap(torch.func.grad(
                     split, argnums=(0, 1, 2)))(*local)}
        leaves = [t.clone().requires_grad_() for t in local]
        loss = total(split)(*leaves)
    # the backward outside the context, as autograd's device thread runs
    # it on the GPU
    loss.backward()
    grads["backward()"] = [t.grad for t in leaves]

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    return {"value": rel(got_v, want_v),
            **{f"{order} d{name}": rel(g, w) for order, gs in grads.items()
               for name, g, w in zip(("w1", "w2", "x"), gs, want_g)}}


def _tp_rows_case(mesh) -> dict:
    """``sharding.tp.all_to_all`` over 'model' and ``whole``'s gather of
    an FSDP shard whose gradient is reduce-scattered over 'data', in one
    function of K=3 clients' rows split over 'data' (the rules map
    'batch' to 'data'): a column weight FSDP-sharded over 'data' on its
    rows and split over 'model' on its columns, a row weight held whole
    on every 'data' rank (``whole`` passes it through ``copy_to``), the
    loss's rows summed over 'data'; under ``vmap(grad)``, ``grad(vmap)``
    and a ``backward()`` outside the mesh context, against the
    one-process function: the largest gap of the value and of each
    gradient (this rank's slice), relative to ``max(1, max|ref|)``."""
    from repro_torch.sharding import tp
    from repro_torch.sharding.ctx import use_mesh_rules

    gen = torch.Generator().manual_seed(12)
    k, b, d, f = 3, 8, 8, 8
    w1, w2 = torch.randn(k, d, f, generator=gen), torch.randn(
        k, f, d, generator=gen)
    x = torch.randn(k, b, d, generator=gen)
    m, r = mesh["model"].size(), mesh["model"].get_local_rank()
    nd, rd = mesh["data"].size(), mesh["data"].get_local_rank()
    cols = slice(r * f // m, (r + 1) * f // m)
    rows = slice(rd * d // nd, (rd + 1) * d // nd)
    mine = slice(rd * b // nd, (rd + 1) * b // nd)

    def plain(w1, w2, x):
        h = torch.tanh(x @ w1)
        return (torch.square(h @ w2).sum() + (torch.sin(h) * h).sum())

    def split(w1, w2, x):
        h = torch.tanh(tp.copy_to(x) @ tp.whole(w1, 0, d))
        # this rank's rows of h and its columns -> a slice of the rows
        # and every column, and back
        z = tp.all_to_all(torch.sin(tp.all_to_all(h, split_dim=0,
                                                  cat_dim=1)),
                          split_dim=1, cat_dim=0)
        w2 = tp.whole(w2, 1, d)
        part = (torch.square(tp.reduce_from(h @ w2)).sum()
                + tp.reduce_from((z * h).sum()))
        return tp.reduce_from(part, "data")

    def total(fn):
        return lambda *a: torch.func.vmap(fn)(*a).sum()

    want_v = torch.func.vmap(plain)(w1, w2, x)
    want_g = torch.func.grad(total(plain), argnums=(0, 1, 2))(w1, w2, x)
    want_g = (want_g[0][:, rows, cols], want_g[1][:, cols], want_g[2][:, mine])
    local = (w1[:, rows, cols].contiguous(), w2[:, cols].contiguous(),
             x[:, mine].contiguous())
    with use_mesh_rules(mesh, {"batch": ("data",)}):
        got_v = torch.func.vmap(split)(*local)
        grads = {"grad(vmap)": torch.func.grad(
                     total(split), argnums=(0, 1, 2))(*local),
                 "vmap(grad)": torch.func.vmap(torch.func.grad(
                     split, argnums=(0, 1, 2)))(*local)}
        leaves = [t.clone().requires_grad_() for t in local]
        loss = total(split)(*leaves)
    loss.backward()
    grads["backward()"] = [t.grad for t in leaves]

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    return {"value": rel(got_v, want_v),
            **{f"{order} d{name}": rel(g, w) for order, gs in grads.items()
               for name, g, w in zip(("w1", "w2", "x"), gs, want_g)}}


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

    out = {"tp": {}, "tp_rows": {}, "steps": {}}
    for name, (data, model) in MESHES.items():
        mesh = make_test_mesh(data, model, device_type="cpu")
        out["tp"][name] = _tp_case(mesh)
        out["tp_rows"][name] = _tp_rows_case(mesh)
        for arch in MESH_ARCHS[name]:
            for case, got in _step_cases(mesh, arch).items():
                out["steps"][f"{name}/{arch}/{case}"] = got
    mesh = make_test_mesh(2, 2, device_type="cpu")
    for case, got in _seq_data_cases(mesh).items():
        out["steps"][f"2x2/{case}"] = got
    out["remat"] = {arch: _remat_case(mesh, arch) for arch in REMAT_ARCHS}
    out["remat_tp"] = _remat_tp_case(mesh)
    out["ring"] = {"2x2-k2-d2": _ring_case(mesh, 2, 2, torch.float32),
                   "2x2-k4-d4-bf16": _ring_case(mesh, 4, 4, torch.bfloat16)}
    out["widths"] = {"2x2": call_widths(mesh)}
    mesh41 = make_test_mesh(4, 1, device_type="cpu")
    out["ring"]["4x1-k8-d4"] = _ring_case(mesh41, 8, 4, torch.float32)
    out["widths"]["4x1"] = call_widths(mesh41)
    if rank == 0:
        out["widths"]["unsharded"] = call_widths()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
