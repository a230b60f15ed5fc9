"""Multi-process scale-out on ``torch.distributed``: the device mesh,
library-sharded kNN retrieval, batched conversion on a ``('data',
'library')`` mesh, and the frame-rate models sharded along time with a halo
exchange at each depthwise conv."""

from alivevc_tpu_torch.parallel.distributed_vc import convert_windows_distributed  # noqa: F401
from alivevc_tpu_torch.parallel.halo import (  # noqa: F401
    adaptive_convnext1d_sharded,
    content_encoder_sharded,
    convnext1d_sharded,
    f0_estimator_sharded,
    feature_extractor_sharded,
    gather_time,
    halo_pad,
    sharded_frame_model,
)
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
