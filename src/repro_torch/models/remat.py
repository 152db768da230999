"""Rematerialisation: the port's ``jax.checkpoint`` (reference
``repro.models.lm.forward_train`` and ``repro.models.encdec.decode_train``
under ``remat=True``).

``checkpoint(fn, args, policy)`` returns ``fn(*args)`` (a tuple of
tensors) computed so that its backward recomputes ``fn`` instead of
keeping its intermediates:

  ``"full"``  keeps the inputs only (``jax.checkpoint(fn)``);
  ``"dots"``  also keeps the output of every matmul ``fn`` dispatches
              (``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``: the
              reference's ``dots_saveable``), and the recompute takes them
              from the forward instead of multiplying again.

The numbers are the ones without rematerialisation, bit for bit: the
recompute runs the same ops on the same inputs.

It is a ``torch.autograd.Function`` in the ``setup_context`` style with a
generated ``vmap`` rule, so it runs inside the steps' ``torch.func.vmap``
over clients and ``torch.func.grad`` in either order (neither form of
``torch.utils.checkpoint`` does: the non-reentrant one rests on saved
tensor hooks, which ``torch.func`` refuses, and the reentrant one has no
``setup_context``).  Its backward recomputes ``fn`` under
``torch.func.vjp`` and applies the pullback to the output gradients.

Every tensor ``fn`` reads must come in through ``args``: a tensor that
``fn`` captures from outside is not seen at the Function's vmap level,
and the generated rule fails on it (``Interpreter.cpp`` "wrapper ==
nullptr").  Non-tensor values (configs, layer kinds) may be captured.
Integer and boolean inputs (positions) get no gradient.

``"dots"`` works at the dispatcher, below the ``torch.func`` layers: the
forward runs ``fn`` under ``_Record``, a ``TorchDispatchMode`` that keeps
each matmul's output on a tape, and the recompute under ``_Replay``,
which hands those outputs back in the same order instead of dispatching
the matmuls; a recompute that asks for another op or shape raises, and
the pullback runs outside ``_Replay``.  Outer modes (the dry run's
``TraceCost`` and ``FlopCounterMode``, ``utils.collectives``' counter)
see the recompute's other ops and not the replayed matmuls.

The recompute runs where autograd runs the backward, on the GPU its
device thread: the Function keeps the caller's mesh and rules
(``sharding.ctx.snapshot``) and runs the recompute under them, so a
block's ``sharding.tp`` collectives are issued again there.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.sharding import ctx as mesh_ctx

POLICIES = ("full", "dots")
_aten = torch.ops.aten
#: the ops whose outputs ``"dots"`` keeps
DOTS = (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm)


def check_policy(policy: str) -> None:
    """Raises ``ValueError`` unless ``policy`` is one of ``POLICIES``."""
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of {POLICIES}, got "
                         f"{policy!r}")


class _Tape:
    """The matmul outputs of one forward, in dispatch order, and the
    recompute's place in them."""

    def __init__(self):
        self.entries: list = []
        self.next = 0


class _Record(TorchDispatchMode):
    def __init__(self, tape: _Tape):
        super().__init__()
        self.tape = tape

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in DOTS:
            self.tape.entries.append((func, out))
        return out


class _Replay(TorchDispatchMode):
    def __init__(self, tape: _Tape):
        super().__init__()
        self.tape = tape

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket not in DOTS:
            return func(*args, **(kwargs or {}))
        tape = self.tape
        if tape.next == len(tape.entries):
            raise RuntimeError(f"remat 'dots': the recompute dispatched "
                               f"{func} beyond the forward's "
                               f"{len(tape.entries)} matmuls")
        want, out = tape.entries[tape.next]
        shape = _out_shape(args)
        if want != func or tuple(out.shape) != shape:
            raise RuntimeError(
                f"remat 'dots': matmul {tape.next} of the recompute is "
                f"{func} giving {shape}, the forward's {want} gave "
                f"{tuple(out.shape)}")
        tape.next += 1
        return out


def _out_shape(args) -> tuple:
    """The output shape of a ``DOTS`` op on ``args``, from its operands."""
    a, b = args[-2], args[-1]
    return tuple(a.shape[:-1]) + (b.shape[-1],)


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, spec, tape, *leaves):
        args = tree_unflatten(list(leaves), spec)
        if tape is None:
            return tuple(fn(*args))
        with _Record(tape):
            return tuple(fn(*args))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, spec, tape, *leaves = inputs
        ctx.fn, ctx.spec, ctx.tape = fn, spec, tape
        ctx.mesh_state = mesh_ctx.snapshot()
        ctx.save_for_backward(*leaves)

    @staticmethod
    def backward(ctx, *grads):
        # detached: the steps' ``torch.func.grad`` runs the backward with
        # create_graph, which would record the recompute at its level and
        # keep every intermediate to the end; ``vjp`` records at its own
        leaves = [t.detach() for t in ctx.saved_tensors]
        grads = tuple(g.detach() for g in grads)
        wrt = [i for i, t in enumerate(leaves)
               if t.is_floating_point() or t.is_complex()]

        def run(*diff):
            full = list(leaves)
            for i, t in zip(wrt, diff):
                full[i] = t
            return tuple(ctx.fn(*tree_unflatten(full, ctx.spec)))

        with mesh_ctx.restored(ctx.mesh_state):
            if ctx.tape is None:
                _, pullback = torch.func.vjp(run, *[leaves[i] for i in wrt])
            else:
                ctx.tape.next = 0
                with _Replay(ctx.tape):
                    _, pullback = torch.func.vjp(
                        run, *[leaves[i] for i in wrt])
                if ctx.tape.next != len(ctx.tape.entries):
                    raise RuntimeError(
                        f"remat 'dots': the recompute replayed "
                        f"{ctx.tape.next} of the forward's "
                        f"{len(ctx.tape.entries)} matmuls")
            got = pullback(grads)
        out: list = [None] * len(leaves)
        for i, g in zip(wrt, got):
            out[i] = g
        return (None, None, None, *out)


def checkpoint(fn: Callable, args: Sequence, policy: str = "full") -> tuple:
    """``fn(*args)``, a tuple of tensors, with its backward recomputing
    ``fn`` under ``policy`` (``POLICIES``; anything else raises).
    ``args`` is a sequence of pytrees (dicts, lists, tuples) of tensors,
    every tensor ``fn`` reads."""
    check_policy(policy)
    leaves, spec = tree_flatten(tuple(args))
    tape = _Tape() if policy == "dots" else None
    return _Checkpoint.apply(fn, spec, tape, *leaves)
