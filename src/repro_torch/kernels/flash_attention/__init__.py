from repro_torch.kernels.flash_attention.ops import attention  # noqa: F401
from repro_torch.kernels.flash_attention.decode import flash_decode_fwd  # noqa: F401
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: F401
