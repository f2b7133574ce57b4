"""The executor's programs as CUDA graphs (the counterpart of the
reference's jitted programs: one device call each).

Eagerly, a fused decode step is thousands of launches, each a trip
through Python and the CUDA runtime, and the card idles between them.  A
:class:`ProgramGraphs` records each program once, when the engine is
built and every slot is dead (so the program changes nothing), and
replays it: one launch of the whole program from the host.

What capture relies on:

- **fixed shapes** per pool: ``(max_batch, kv_len, prefill_chunk,
  decode_chunk)``;
- **a pool left as it was**: a dead slot's attention writes are dropped,
  but the decode step advances every row's recurrent leaves (``conv``,
  ``state``, ``h``), as the reference does, so those are copied before the
  warm-up and written back after the capture;
- **no host read** inside a program (``executor.py``, ``attention.py``);
- **static tensors**: the pool's cache and state (and the draft model's
  pool, under speculative decoding) are written in place, so a graph
  reads what the host writes there; a program's host inputs
  are copied into buffers of this object before each replay, and its
  output is a tensor of the graph, read (fetched) before the next replay;
- **a warm-up on the capture stream**: it builds and binds the kernels,
  fills the dequant-matmul's plan cache and sizes the stream's split
  tickets (``kernels/scratch.py`` refuses to grow them under capture);
- **one memory pool** for the graphs, which never run at once: the
  workspaces allocated inside them come from it;
- **the sampling generator registered** with each graph, so every replay
  draws new numbers; after warm-up and capture its state is put back, so
  building an engine consumes no draws;
- **counted replays**: the wrappers count launches on the host, which a
  replay does not run, so what the capture counted is taken back out and
  added again at each replay (``kernels/launches.py``).

A capture that fails raises: the engine never carries on eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import launches
from repro_torch.serving.executor import pool_args


def program_inputs(ecfg, chunk: int) -> dict:
    """The host inputs of each program, after (cache, state): shape, dtype
    and the value that makes the program change nothing (no segment, no
    active slot, pads only)."""
    B, i32, b = ecfg.max_batch, torch.int32, torch.bool
    return {
        "fused_step": [],
        "spec_step": [],
        # tokens, positions, seg, gather_idx, seg_len, final, budget, active
        "packed_prefill": [((1, chunk), i32, 0), ((1, chunk), i32, 0),
                           ((1, chunk), i32, -1), ((B,), i32, 0), ((B,), i32, 0),
                           ((B,), b, False), ((B,), i32, 1), ((B,), b, False)],
        # tokens, pos, take_idx, final, budget
        "chunk_step": [((B, chunk), i32, 0), ((B, chunk), i32, -1), ((B,), i32, 0),
                       ((B,), b, False), ((B,), i32, 1)],
    }


class ProgramGraphs:
    def __init__(self, executor, pool, programs, chunk: int):
        dev = executor.device
        specs = program_inputs(executor.ecfg, chunk)
        self.inputs = {name: [torch.full(shape, fill, dtype=dtype, device=dev)
                              for shape, dtype, fill in specs[name]]
                       for name in programs}
        self.graphs, self.outputs, self.launches = {}, {}, {}
        self.stream = torch.cuda.Stream(dev)
        self.mempool = torch.cuda.graph_pool_handle()
        gen = executor.generator
        gen_state = gen.get_state()

        def call(name):
            return getattr(executor, name)(*pool_args(name, pool), *self.inputs[name])[2]

        recurrent = [leaf for group in pool.cache["stack"] for unit in group.values()
                     if "attn" not in unit for leaf in unit.values()]
        saved = [leaf.clone() for leaf in recurrent]

        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            for name in programs:
                call(name)
        for name in programs:
            g = torch.cuda.CUDAGraph()
            g.register_generator_state(gen)
            before = launches.snapshot()
            with torch.cuda.graph(g, pool=self.mempool, stream=self.stream):
                self.outputs[name] = call(name)
            self.launches[name] = launches.since(before)
            launches.restore(before)
            self.graphs[name] = g
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        for leaf, before in zip(recurrent, saved):
            leaf.copy_(before)
        gen.set_state(gen_state)

    def replay(self, name: str, host: tuple[np.ndarray, ...]) -> torch.Tensor:
        """Copy ``host`` into the program's input buffers, replay it, count
        its launches, and return its output (valid until the next replay
        of any program)."""
        for buf, arr in zip(self.inputs[name], host):
            buf.copy_(torch.from_numpy(arr), non_blocking=True)
        self.graphs[name].replay()
        launches.add(self.launches[name])
        return self.outputs[name]
