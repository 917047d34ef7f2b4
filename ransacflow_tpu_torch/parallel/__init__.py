"""Data parallelism across cards (port of `ransacflow_tpu/parallel`): the
process group and its cross-rank ops (`group`), the device lists and the
sharded serving paths (`mesh`)."""

from ransacflow_tpu_torch.parallel.group import (  # noqa: F401
    all_reduce_sum,
    broadcast_module,
    init_from_env,
    reduce_grads,
    spawn,
    world_size,
)
from ransacflow_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
    sharded_align_pairs,
    sharded_ransac,
)
