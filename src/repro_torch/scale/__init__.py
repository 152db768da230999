"""repro_torch.scale — the stacked round engine (reference
``repro.scale``).

Where ``RoundEngine`` walks clients in Python, ``ScaleEngine`` runs each
phase of the round — gossip mix, local SGD, mask evolution, eval — once
over client-stacked state (every leaf with a leading K dim).  A strategy
joins by registering a ``StackedStrategyBase`` adapter over its ordinary
hooks; ``dispfl``, ``dispfl_anneal`` and ``dpsgd`` have one (``dpsgd_ft``
maps to the dpsgd adapter, which refuses it, as the reference does).

On the card, ``reduction="ordered"`` runs the gossip kernel once per
receiver and leaf.  The stacked packed fold (``fold_stacked``) and the
threshold prune/regrow (``stacked_prune_regrow_threshold``) run their CUDA
kernels once per leaf; as in the reference, no round of the engine calls
them (its evolve is ``stacked_evolve_exact``), so they are library
functions over the engine's state.  Checkpoints use the per-client list layout, so
archives move freely between this engine, ``RoundEngine`` and the
reference's engines.

``ScaleEngine(mesh=...)`` shards the stacked client dim over a
``torch.distributed`` ``DeviceMesh`` (``launch.mesh``): each rank holds
its ``ClientShard`` of the clients and the mix gathers the senders over
the client axes.

Entry points: ``ScaleEngine``; ``python -m repro_torch.launch.train
simulate --scale [--scale-reduction {einsum,ordered}]``, and under
``torchrun`` with ``--mesh-shape DxM``.
"""
from repro_torch.scale.engine import ClientShard, ScaleEngine  # noqa: F401
from repro_torch.scale.stacked import (  # noqa: F401
    StackedPacked,
    fold_stacked,
    masked_gossip_stacked,
    pack_stacked,
    plain_mix_stacked,
    split_stacked,
    stack_payloads,
    stacked_evolve_exact,
    stacked_local_phase,
    stacked_nnz_per_client,
    stacked_prune_regrow_threshold,
    stacked_state_from_numpy,
    unpack_stacked,
)
from repro_torch.scale.strategy import (  # noqa: F401
    StackedStrategyBase,
    make_stacked,
    register_stacked,
    stacked_strategy_names,
)
