"""The serving path: `fused.fused_align` and `fused.fused_align_batch`."""

from ransacflow_tpu_torch.models.convert import init_alignment_params  # noqa: F401
