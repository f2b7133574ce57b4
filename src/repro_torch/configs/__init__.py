"""Architecture registry of the port — importing this package registers
every config the port can run, and the paper's Table 3 (``paper_models``)."""
from repro_torch.configs import (gemma2_9b, gemma3_27b, mamba2_130m,  # noqa: F401
                                 minitron_8b, paper_models, qwen2_5_3b,
                                 qwen3_moe_30b_a3b, recurrentgemma_9b)
