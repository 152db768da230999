"""The federated strategy zoo on the round engine (reference ``repro.fl``).

``repro_torch.fl.engine`` owns the round loop; a strategy is a
``StrategyBase`` subclass registered by name (``@register``).  The zoo is
the reference's twelve: ``dispfl`` and ``dispfl_anneal`` (``fl.dispfl``),
``dpsgd`` and ``dpsgd_ft`` (``fl.decentralized``), ``local``, ``fedavg``,
``fedavg_ft``, ``ditto``, ``fomo`` and ``subfedavg`` (``fl.centralized``),
``dfedalt`` and ``dfedsam`` (``fl.partial``).  ``run_strategy`` and the
``run_*`` wrappers run one to an ``FLResult``.
"""
from repro_torch.fl.base import (  # noqa: F401
    FLConfig,
    FLResult,
    Task,
    make_cnn_task,
)
from repro_torch.fl.centralized import (  # noqa: F401
    run_ditto,
    run_fedavg,
    run_fomo,
    run_local,
    run_subfedavg,
)
from repro_torch.fl.decentralized import run_dpsgd  # noqa: F401
from repro_torch.fl.dispfl import run_dispfl  # noqa: F401
from repro_torch.fl.engine import (  # noqa: F401
    Callback,
    Checkpointer,
    EarlyStopAtTarget,
    JsonlLogger,
    RoundCtx,
    RoundEngine,
    RoundMetrics,
    StrategyBase,
    make_strategy,
    register,
    run_strategy,
    strategy_names,
)


def _runner(name: str):
    def _run(task, clients, cfg, **kw):
        return run_strategy(name, task, clients, cfg, **kw)

    _run.__name__ = f"run_{name}"
    return _run


#: the registry as name -> runner(task, clients, cfg, **kw)
STRATEGIES = {name: _runner(name) for name in strategy_names()}
