"""Tree helpers keyed by the reference's leaf paths."""
from repro_torch.utils import tree  # noqa: F401
