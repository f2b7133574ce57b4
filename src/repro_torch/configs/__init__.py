"""Architecture registry of the port — importing this package registers
every config the port can run, and the paper's Table 3 (``paper_models``)."""
from repro_torch.configs import (deepseek_v2_236b, gemma2_9b,  # noqa: F401
                                 gemma3_27b, llama3_2_vision_90b, mamba2_130m,
                                 minitron_8b, paper_models, qwen2_5_3b,
                                 qwen3_moe_30b_a3b, recurrentgemma_9b,
                                 whisper_large_v3)
