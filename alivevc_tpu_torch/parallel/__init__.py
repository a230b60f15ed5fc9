"""Multi-process scale-out on ``torch.distributed``: the device mesh,
library-sharded kNN retrieval and batched conversion on a
``('data', 'library')`` mesh.  Time-axis halo sharding
(``alivevc_tpu/parallel/halo.py``) is not ported yet."""

from alivevc_tpu_torch.parallel.distributed_vc import convert_windows_distributed  # noqa: F401
from alivevc_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed,
    make_mesh,
    replicate,
    shard_along,
)
from alivevc_tpu_torch.parallel.sharded_knn import (  # noqa: F401
    local_topk_merge,
    pad_library_for_sharding,
    sharded_match_features,
)
