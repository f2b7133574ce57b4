"""Architecture registry of the port — importing this package registers
every config the port can run."""
from repro_torch.configs import gemma2_9b, gemma3_27b, minitron_8b, qwen2_5_3b  # noqa: F401
