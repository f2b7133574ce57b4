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
    own."""
    key = (device, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return t
