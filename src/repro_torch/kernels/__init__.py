# Hand-written CUDA kernels for Hopper (csrc/*.cu), each beside its plain
# PyTorch version (ref.py); ops.py dispatches on the tensor's device.
from repro_torch.kernels.ops import (  # noqa: F401
    LAUNCHES, decode_avg, quantize_mod, reset_launch_counts,
    sgd_fused_update,
)
