from repro_torch.sharding.ctx import (  # noqa: F401
    axis_rules,
    constrain,
    current_mesh,
    logical_sharding,
    use_mesh_rules,
)
from repro_torch.sharding.rules import PartitionSpec  # noqa: F401
