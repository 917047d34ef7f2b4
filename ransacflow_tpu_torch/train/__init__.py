"""Training of the alignment networks on one device or data-parallel over
several, with MegaDepth validation (port of `ransacflow_tpu/train`)."""

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
from ransacflow_tpu_torch.train.loop import STAGES, fit, process_shard_layout  # noqa: F401
from ransacflow_tpu_torch.train.trainer import (  # noqa: F401
    local_index_roll,
    make_optimizer,
    split_trainable,
    train_grads,
    train_step,
)
from ransacflow_tpu_torch.train.validation import PIXEL_GRID, validate  # noqa: F401
