"""DisPFL core: topology, accounting, masks, gossip and mask evolution."""
