"""DisPFL core: topology, accounting, masks, gossip and mask evolution."""
from repro_torch.core import (  # noqa: F401
    accounting,
    evolve,
    gossip,
    masks,
    topology,
)
