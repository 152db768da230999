"""Multi-tenant personalized sparse serving (reference ``repro.serve``).

* ``store.ModelStore`` — each user's model at rest as its codec frame over
  a shared base (``bytes_at_rest == encoded_nbytes``), and a preallocated
  device slot pool as the LRU cache: a miss decodes straight into one
  slot, a hit moves no parameter bytes.
* ``batcher.RequestStream`` / ``batcher.MicroBatcher`` — seed-derived
  arrivals and deterministic micro-batches (numpy, as the reference's).
* ``engine.ServeEngine`` — one pool-wide batched forward per batch; for
  ``MLPModel`` the ``kernel`` backend runs the CUDA block-sparse masked
  matmul once per layer; ``TaskModel`` (CNNs) and ``ArchModel`` (the LM
  families) serve through ``torch.func.vmap`` only.  Each forward is a
  CUDA graph on the card (``utils.graph.graphed``), captured by
  ``ServeEngine.warmup()``.

CLI: ``python -m repro_torch.launch.serve --users 64 --cache-size 16
--max-batch 8 --requests 256 --backend kernel`` (CUDA; ``--device cpu``
runs the plain versions on the CPU).
"""
from repro_torch.serve.batcher import Batch, MicroBatcher, Request, RequestStream
from repro_torch.serve.engine import ServeEngine, ServeResult
from repro_torch.serve.model import ArchModel, MLPModel, TaskModel
from repro_torch.serve.store import ModelStore

__all__ = [
    "ArchModel",
    "Batch",
    "MLPModel",
    "MicroBatcher",
    "ModelStore",
    "Request",
    "RequestStream",
    "ServeEngine",
    "ServeResult",
    "TaskModel",
]
