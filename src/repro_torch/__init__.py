"""repro_torch — the PyTorch/CUDA port of ``repro`` (DisPFL), for H100s.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``utils/tree.py``, ``core/gossip.py``, ``fl/engine.py``, ...) so a
reader can find each counterpart.  State is nested dicts of tensors keyed by
the reference's '/'-joined leaf paths, conv weights stay HWIO and activations
NHWC, masks are float32 {0,1}.  The package imports torch and numpy only —
never jax and nothing of ``repro``.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``repro_torch.device.setup_device``).  The stacked engine also runs over
a ``torch.distributed`` ``DeviceMesh``, one process per position
(``launch.mesh``, ``sharding``, ``ScaleEngine(mesh=...)``).  The gossip mix runs through two
hand-written CUDA kernels (``repro_torch.kernels``); on CPU tensors their
plain PyTorch versions run instead.
"""
