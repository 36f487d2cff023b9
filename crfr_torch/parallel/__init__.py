"""More than one device: the (data, model) mesh over a ``torch.distributed``
process group, one process per device (crfr/parallel)."""

from crfr_torch.parallel.mesh import (  # noqa: F401
    MeshCfg,
    batch_sharding,
    class_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
