from repro_torch.kernels.grouped_matmul.ops import (  # noqa: F401
    combine, grouped_gate_up, grouped_matmul)
