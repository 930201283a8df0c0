"""Multi-device training: the (data x model) layout over ``torch.distributed``
(``mesh``), the process group and the collectives (``distributed``), and the
sharded NAR steps (``sharded``).  Port of ``chameleon_recsys_tpu/parallel``."""
from .mesh import (
    MeshPlan,
    RowShard,
    batch_sharding,
    make_mesh,
    params_sharding,
)

__all__ = [
    "MeshPlan",
    "RowShard",
    "batch_sharding",
    "make_mesh",
    "params_sharding",
]
