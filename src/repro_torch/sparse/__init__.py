"""Packed sparse payloads (bitmap + nnz values) and the ops that fold them
(reference ``repro.sparse``): ``packed`` (``PackedSparse``, pack/unpack),
``codec`` (wire frames, ``encoded_nbytes`` equal to the analytic message
size) and ``ops`` (folds into (num, den) accumulators)."""
from repro_torch.sparse.codec import (  # noqa: F401
    TreeSpec,
    decode,
    decode_dense,
    encode,
    encoded_nbytes,
)
from repro_torch.sparse.ops import (  # noqa: F401
    packed_axpy,
    packed_gossip_one,
)
from repro_torch.sparse.packed import (  # noqa: F401
    PackedSparse,
    pack,
    pack_tree,
    tree_packed_coords,
    tree_packed_nnz,
    unpack,
    unpack_mask,
    unpack_mask_tree,
    unpack_tree,
)
