from vtm_torch.data.loader import (  # noqa: F401
    DATASET_REGISTRY,
    BatchLoader,
    build_dataset,
    construct_loader,
    register_dataset,
    shuffle_dataset,
)
from vtm_torch.data import synthetic  # noqa: F401
