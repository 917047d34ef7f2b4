"""Host helpers of the port, under the names the JAX package's
`ransacflow_tpu.utils` exports."""

from ransacflow_tpu_torch.utils.image import (  # noqa: F401
    STRIDE_NET,
    resize_max_size,
    resize_min_size,
    resize_round_stride,
    scale_list,
    to_array,
)
from ransacflow_tpu_torch.utils.monitor import (  # noqa: F401
    MetricsLogger,
    StageTimer,
    profile_trace,
)
