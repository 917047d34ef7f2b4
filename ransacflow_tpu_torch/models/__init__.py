"""Networks of the port: nn.Modules with the reference's state_dict names,
and the functions the JAX package's `ransacflow_tpu.models` exports, under
its names. Each function takes the module where JAX takes a parameter tree.

Not here, since a module holds what they hand around: JAX's `init_*` tree
builders (the port seeds modules with `convert.init_alignment_params`,
`init_resnet50_layer3` and `init_segnet`) and `merge_bn_stats` (a
train-mode module updates its own BatchNorm buffers).
"""

from ransacflow_tpu_torch.models.layers import cast_params, l2_normalize  # noqa: F401
from ransacflow_tpu_torch.models.feature_extractor import feature_extractor  # noqa: F401
from ransacflow_tpu_torch.models.heads import (  # noqa: F401
    flow_gradient_magnitude,
    flow_to_grid,
    net_flow_coarse,
    net_matchability,
    pred_flow_coarse,
    pred_flow_coarse_no_grad,
    pred_matchability,
)
from ransacflow_tpu_torch.models.resnet50 import (  # noqa: F401
    imagenet_preprocess,
    resnet50_layer3,
)
from ransacflow_tpu_torch.models.convert import (  # noqa: F401
    init_resnet50_layer3,
    load_alignment_checkpoint,
    load_params_npz,
    load_resnet50_trunk,
    load_torch_checkpoint,
    save_params_npz,
    state_dict_to_tree,
)
from ransacflow_tpu_torch.models.segnet import (  # noqa: F401
    SkySegmenter,
    segnet_decoder,
    segnet_encoder,
)
