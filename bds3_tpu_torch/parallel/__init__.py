from bds3_tpu_torch.parallel.mesh import make_mesh, channel_sharding  # noqa: F401
from bds3_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_coarse_search,
    sharded_track_block,
)
