"""Architecture registry of the port — importing this package registers
every config the port can run."""
from repro_torch.configs import qwen2_5_3b  # noqa: F401
