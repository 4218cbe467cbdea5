"""Hand-written CUDA kernels, their build, and host-side preprocessing."""

# Registers the page gather's and the flash kernels' launch counts in
# kernels.KERNELS, so that kernels.launch_counts() covers every wrapper
# whichever module a caller imports first.
from dmlc_tpu_torch.ops import flash, ragged_decode  # noqa: F401
