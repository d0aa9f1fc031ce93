"""Data and tensor parallelism (port of ``vtm/parallel``): process groups
and the ('data', 'model') mesh (``mesh``), one process per device
(``launch``), the Megatron cuts and their collectives (``sharding``), and
the multi-device dry run (``dryrun``)."""

from vtm_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_width,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    process_allgather,
    replicate,
    shard_batch,
)
from vtm_torch.parallel.sharding import full_state_dict, shard_module  # noqa: F401
