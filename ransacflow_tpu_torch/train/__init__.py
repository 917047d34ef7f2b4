"""Training of the alignment networks on one device, with MegaDepth
validation (port of `ransacflow_tpu/train`, without data parallelism)."""

from ransacflow_tpu_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    resume_params,
    save_checkpoint,
)
from ransacflow_tpu_torch.train.data import PairFolder, prefetch, train_transform  # noqa: F401
from ransacflow_tpu_torch.train.losses import (  # noqa: F401
    TRAIN_MODULES,
    compute_losses,
    margin_mask,
)
from ransacflow_tpu_torch.train.loop import STAGES, fit  # noqa: F401
from ransacflow_tpu_torch.train.trainer import (  # noqa: F401
    local_index_roll,
    make_optimizer,
    split_trainable,
    train_step,
)
from ransacflow_tpu_torch.train.validation import PIXEL_GRID, validate  # noqa: F401
