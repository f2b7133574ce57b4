from repro_torch.kernels.pim_mvm.ops import pim_mvm, quantize_weights  # noqa: F401
from repro_torch.kernels.pim_mvm.ref import pim_mvm_ref  # noqa: F401
