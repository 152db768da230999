"""Logical-axis sharding context (reference ``repro.sharding.ctx``).

Model code annotates activations with *logical* axis names
(``constrain(x, ("client", "batch", "seq", "embed"))``).  A context manager
installs a mesh + logical->mesh rules; outside any context the annotations
are no-ops, so the same model code runs on one device and over a
``DeviceMesh`` unchanged.  Inside a context ``constrain`` redistributes a
``DTensor`` to the placements of its names' spec (the reference's
``with_sharding_constraint``); a plain tensor is one process's own data
and passes through.

Default rules, the reference's:
  client -> ('pod','data')   stacked personalized models
  batch  -> 'data' (only when there is no client axis)
  expert -> 'model'
  heads/kv_heads/ffn/vocab -> 'model'
  kv_seq -> 'data' for long-context decode (context parallelism)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

from repro_torch.sharding.rules import PartitionSpec, axis_names, placements

_state = threading.local()


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


def axis_rules(mesh, overrides: dict | None = None) -> dict:
    names = set(axis_names(mesh))
    has_pod = "pod" in names
    client = ("pod", "data") if has_pod else ("data",)
    rules = {
        "client": client,
        "batch": (),                 # per-client batch: sharded via inputs
        "batch_noshard": (),
        "seq": (),
        "kv_seq": (),                # ('data',) override for long-context K=1
        "embed": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
        "ffn": ("model",),
        "expert": ("model",),
        "expert_cap": (),
        "vocab": ("model",),
        "conv": (),
        "fsdp": ("data",),           # 2-D weight sharding for K=1 giants
        "state": (),
        None: (),
    }
    if overrides:
        rules.update(overrides)
    return rules


def _spec_for(names: Sequence[Optional[str]], rules: dict) -> PartitionSpec:
    parts = []
    for n in names:
        mapped = rules.get(n, ())
        if not mapped:
            parts.append(None)
        elif len(mapped) == 1:
            parts.append(mapped[0])
        else:
            parts.append(tuple(mapped))
    return PartitionSpec(*parts)


def snapshot() -> tuple:
    """This thread's mesh and rules (both None outside a context), for
    ``restored``."""
    return current_mesh(), _rules()


@contextlib.contextmanager
def restored(state: tuple):
    """Within it, this thread's mesh and rules are ``state`` (a
    ``snapshot``, maybe taken on another thread); the previous ones come
    back on exit."""
    prev = snapshot()
    _state.mesh, _state.rules = state
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def use_mesh_rules(mesh, overrides: dict | None = None):
    """Within it, ``constrain`` maps logical names onto ``mesh`` by the
    default rules (updated by ``overrides``); the previous mesh and rules
    of this thread come back on exit."""
    return restored((mesh, axis_rules(mesh, overrides)))


def rule(name: str) -> tuple:
    """The mesh axes the context's rules map the logical ``name`` to; ()
    outside a context."""
    rules = _rules()
    return () if rules is None else tuple(rules.get(name, ()))


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    """A ``DTensor`` redistributed to the placements of ``names`` on the
    context's mesh; no-op without a context, and for a plain tensor."""
    rules = _rules()
    mesh = current_mesh()
    if rules is None or mesh is None:
        return x
    if x.dim() != len(names):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs {names}")
    target = placements(_spec_for(names, rules), mesh)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def logical_sharding(mesh, names: Sequence[Optional[str]],
                     overrides: dict | None = None) -> tuple:
    """The placements of ``names`` on ``mesh``, for inputs and outputs
    outside a context."""
    return placements(_spec_for(names, axis_rules(mesh, overrides)), mesh)
