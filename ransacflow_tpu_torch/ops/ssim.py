"""The masked SSIM reconstruction loss (the counterpart of
`ransacflow_tpu/ops/ssim.py`): kernel 10 and its plain version live in
`kernels/ssim.py`, and are named here where the JAX package has them."""

from ransacflow_tpu_torch.kernels.ssim import gaussian_window, masked_ssim_loss  # noqa: F401
