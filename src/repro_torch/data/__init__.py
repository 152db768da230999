"""Synthetic federated image data (numpy copies of ``repro.data``)."""
from repro_torch.data.loader import (  # noqa: F401
    ClientData,
    build_federated_image_task,
)
from repro_torch.data.synthetic import (  # noqa: F401
    Dataset,
    make_image_classification,
    make_lm_corpus,
)
