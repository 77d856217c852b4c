from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_reference, rmsnorm_reference

__all__ = ["rmsnorm", "rmsnorm_reference", "rmsnorm_backward_reference"]
