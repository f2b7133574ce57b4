"""Architecture registry of the port — importing this package registers
every config the port can run, and the paper's Table 3 (``paper_models``)."""
from repro_torch.configs import (gemma2_9b, gemma3_27b, minitron_8b,  # noqa: F401
                                 paper_models, qwen2_5_3b, qwen3_moe_30b_a3b)
