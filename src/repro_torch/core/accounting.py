"""Communication and computation accounting (paper Table 1/2/3 columns).

The paper reports, per communication round:
  * ``Comm (MB)`` — bytes moved through the *busiest* node.  Convention from
    the paper's released code: payload = 4 bytes per *transmitted value*
    (nnz of the sender's mask); the {0,1} mask bitmap itself is not counted
    in the headline number (we also expose it).  With ``with_bitmap=True``
    the quoted size is the *exact* wire frame of ``repro.sparse.codec``:
    8-byte header + word-aligned bitmap (4 bytes per 32 coordinates) +
    value bytes — analytic and measured reports agree bit for bit.
    Busiest node = max over
    nodes of (bytes uploaded + bytes downloaded)/2 matched to their table:
    for a server with C connections it is C * model_bytes (download == upload
    so a single direction is quoted); for decentralized nodes it is
    degree * payload.
  * ``FLOPS (1e12)`` — total training FLOPs per client per round, counting a
    multiply-add as 2 FLOPs, forward+backward = 3x forward, over
    (local_epochs * n_samples).  Sparse models scale each layer's forward
    FLOPs by its *layer density* (ERK is non-uniform, which is why the paper
    gets 7.0e12 rather than 4.15e12 at global density 0.5), plus one dense
    forward+backward batch per round for the mask-search gradient.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BYTES_PER_VALUE = 4  # fp32 on the wire, per the paper
HEADER_NBYTES = 8    # repro.sparse.codec frame header (magic/version/dtype/nnz)
BITMAP_WORD_NBYTES = 4   # the bitmap packs 32 coordinates per uint32 word


def bitmap_nbytes(n_coords: int) -> int:
    """Exact word-aligned bitmap size over ``n_coords`` coordinates."""
    return BITMAP_WORD_NBYTES * ((n_coords + 31) // 32)


@dataclass
class CommReport:
    busiest_mb: float
    avg_per_node_mb: float
    total_mb: float
    busiest_mb_with_bitmap: float

    def row(self) -> dict:
        return {
            "busiest_MB": round(self.busiest_mb, 1),
            "avg_node_MB": round(self.avg_per_node_mb, 1),
            "total_MB": round(self.total_mb, 1),
            "busiest_MB_with_bitmap": round(self.busiest_mb_with_bitmap, 1),
        }


def payload_bytes(n_values: int, n_coords: int = 0, with_bitmap: bool = False,
                  value_nbytes: int = BYTES_PER_VALUE) -> float:
    b = n_values * value_nbytes
    if with_bitmap:
        b += bitmap_nbytes(n_coords) + HEADER_NBYTES
    return b


def message_bytes(nnz: int, n_coords: int = 0, with_bitmap: bool = False,
                  value_nbytes: int = BYTES_PER_VALUE) -> float:
    """On-wire size of one model message whose sender mask holds ``nnz``
    values.  ``with_bitmap=True`` is the exact codec frame size
    (``repro.sparse.codec.encoded_nbytes``); the simulator stamps every
    transfer with it so measured totals and analytic reports agree."""
    return payload_bytes(nnz, n_coords, with_bitmap, value_nbytes)


def edge_message_bytes(
    adjacency: np.ndarray,
    nnz_per_client: list[int],
    n_coords: int = 0,
    with_bitmap: bool = False,
) -> np.ndarray:
    """Per-edge message sizes: ``E[i, j]`` = bytes of j's model on the j->i
    edge (0 off-edge and on the diagonal).  ``decentralized_comm`` and the
    event simulator both derive their byte counts from this matrix, which is
    what makes "simulated bytes-on-wire == accounting totals" testable."""
    a = adjacency.astype(float).copy()
    np.fill_diagonal(a, 0.0)
    per_sender = np.asarray(
        [message_bytes(v, n_coords, with_bitmap) for v in nnz_per_client])
    return (a > 0) * per_sender[None, :]


def measured_comm(adjacency: np.ndarray, value_nbytes_per_client: list[float],
                  wire_nbytes_per_client: list[int]) -> CommReport:
    """Measured mode: a ``CommReport`` from *real encoded* message sizes.

    ``wire_nbytes_per_client[j]`` is ``codec.encoded_nbytes`` of j's actual
    packed payload (bitmap + header included); ``value_nbytes_per_client``
    carries the paper's headline value-bytes.  Busiest-node convention is
    identical to ``decentralized_comm`` — for fp32 payloads the two reports
    are equal bit for bit, and they diverge exactly when the payload does
    (fp16 values, annealed densities, partial payloads)."""
    a = (np.asarray(adjacency, dtype=float) > 0).astype(float)
    np.fill_diagonal(a, 0.0)
    e = a * np.asarray(value_nbytes_per_client, dtype=float)[None, :]
    e_w = a * np.asarray(wire_nbytes_per_client, dtype=float)[None, :]
    per_node = np.maximum(e.sum(axis=0), e.sum(axis=1))
    per_node_w = np.maximum(e_w.sum(axis=0), e_w.sum(axis=1))
    mb = 1.0 / 1e6
    return CommReport(
        busiest_mb=float(per_node.max()) * mb,
        avg_per_node_mb=float(per_node.mean()) * mb,
        total_mb=float(e.sum()) * mb,
        busiest_mb_with_bitmap=float(per_node_w.max()) * mb,
    )


def decentralized_comm(
    adjacency: np.ndarray,
    nnz_per_client: list[int],
    n_coords: int,
) -> CommReport:
    """Per-round communication for a decentralized topology.

    adjacency[k, j] = 1 iff k receives j's model; sender j uploads its own
    nnz_j values once per receiving edge.
    """
    e = edge_message_bytes(adjacency, nnz_per_client)
    e_bm = edge_message_bytes(adjacency, nnz_per_client, n_coords, True)
    up = e.sum(axis=0)
    down = e.sum(axis=1)
    up_bm = e_bm.sum(axis=0)
    down_bm = e_bm.sum(axis=1)
    per_node = np.maximum(up, down)  # busiest direction, matching the paper
    per_node_bm = np.maximum(up_bm, down_bm)
    total = up.sum()
    mb = 1.0 / 1e6  # decimal MB, matching the paper's tables
    return CommReport(
        busiest_mb=float(per_node.max()) * mb,
        avg_per_node_mb=float(per_node.mean()) * mb,
        total_mb=float(total) * mb,
        busiest_mb_with_bitmap=float(per_node_bm.max()) * mb,
    )


def centralized_comm(
    n_connected: int, nnz_per_client: list[int], n_coords: int
) -> CommReport:
    """Server-centric: the server is the busiest node; it downloads and
    uploads ``n_connected`` models per round (a single direction is quoted,
    per the paper's table)."""
    sel = nnz_per_client[:n_connected]
    b = sum(payload_bytes(v) for v in sel)
    b_bm = sum(payload_bytes(v, n_coords, True) for v in sel)
    mb = 1.0 / 1e6
    return CommReport(
        busiest_mb=b * mb,
        avg_per_node_mb=b * mb / max(n_connected, 1),
        total_mb=2 * b * mb,
        busiest_mb_with_bitmap=b_bm * mb,
    )


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


@dataclass
class FlopsReport:
    per_round_flops: float          # per client, per communication round
    dense_per_round_flops: float
    fwd_flops_per_sample: float

    def row(self) -> dict:
        return {
            "FLOPS_1e12": round(self.per_round_flops / 1e12, 2),
            "dense_FLOPS_1e12": round(self.dense_per_round_flops / 1e12, 2),
        }


def sparse_training_flops(
    layer_fwd_flops: dict[str, float],
    layer_densities: dict[str, float],
    n_samples: int,
    local_epochs: int,
    mask_search_batches: int = 1,
    batch_size: int = 128,
    bwd_multiplier: float = 2.0,
) -> FlopsReport:
    """Per-round training FLOPs with layer-wise sparse scaling.

    fwd+bwd = (1 + bwd_multiplier) * fwd.  The mask search adds
    ``mask_search_batches`` dense forward+backward batches per round.
    """
    dense_fwd = sum(layer_fwd_flops.values())
    sparse_fwd = sum(
        f * layer_densities.get(k, 1.0) for k, f in layer_fwd_flops.items()
    )
    steps_samples = n_samples * local_epochs
    train = steps_samples * sparse_fwd * (1.0 + bwd_multiplier)
    mask_search = mask_search_batches * batch_size * dense_fwd * (1.0 + bwd_multiplier)
    dense_train = steps_samples * dense_fwd * (1.0 + bwd_multiplier)
    return FlopsReport(
        per_round_flops=train + mask_search,
        dense_per_round_flops=dense_train,
        fwd_flops_per_sample=dense_fwd,
    )
