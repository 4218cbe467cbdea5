"""Hand-written CUDA kernels, their build, and host-side preprocessing."""

# Registers the page gather's, the flash kernels' and jpeg_idct's launch counts in
# kernels.KERNELS, so that kernels.launch_counts() covers every wrapper
# whichever module a caller imports first.
from dmlc_tpu_torch.ops import flash, jpeg, ragged_decode  # noqa: F401
