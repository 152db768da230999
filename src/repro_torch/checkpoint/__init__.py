"""Archives in the reference's .npz format."""
from repro_torch.checkpoint.npz import (  # noqa: F401
    load_clients,
    load_pytree,
    save_clients,
    save_pytree,
)
from repro_torch.checkpoint.packed import (  # noqa: F401
    decode_packed,
    encode_packed,
)
