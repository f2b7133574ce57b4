"""What the kernels' launches share on a card: its SM count, and the
tickets of the reductions that a launch finishes itself (the split-K of
``csrc/qmatmul.cu``, the split-KV of ``csrc/decode.cu`` and
``csrc/decode_quant.cu``)."""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_tickets: dict = {}


def split_tickets(device: torch.device, stream, n: int) -> torch.Tensor:
    """The split tickets of one stream: zeros, which every launch leaves at
    zero.  Launches on one stream run one after another, so they share
    them; launches on two streams may run at once, so each stream has its
    own.  A CUDA graph reads the buffer it was captured with, so under
    capture the buffer must be large enough already (a run of the same
    program on the capture stream sizes it)."""
    key = (device, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a new buffer would free the one that captured launches read
            raise RuntimeError(
                f"a launch under CUDA graph capture needs {n} split tickets, the "
                f"capture stream has {0 if t is None else t.numel()}: run the "
                f"program on that stream before capturing it")
        t = _tickets[key] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return t
