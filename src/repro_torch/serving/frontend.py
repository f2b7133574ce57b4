"""Request-level streaming front end over the serving engine (counterpart
of the reference's ``serving/frontend.py``).

The engine exposes batch mechanics (submit / step / drain); this layer
exposes *requests*: :meth:`ServingFrontend.submit` returns a
:class:`TokenStream` whose tokens can be consumed incrementally — by
iterating it (the iterator pumps the engine until the next token lands)
or through an ``on_token`` callback fired as each token is produced.
:meth:`ServingFrontend.play` replays a workload (``serving/workload.py``
arrivals) against the engine clock: requests are submitted when due and
the engine pumps between arrivals (open-loop load).

Cooperative, not threaded: the engine mutates device state and host
bookkeeping with no locking, so all progress happens on the caller's
thread inside :meth:`pump` — one engine iteration plus delivery of any new
tokens to their streams.  Callbacks fire synchronously in submission
order.  The reference's ``checkpointer=`` (crash safety) has no port yet.
"""
from __future__ import annotations

import time
from typing import Callable, Iterator, Optional, Sequence

from repro_torch.serving.engine import EngineStallError, Request, ServingEngine

OnToken = Callable[["TokenStream", int], None]


class TokenStream:
    """Handle on one streamed request: buffered tokens + liveness.

    ``for tok in stream`` yields every generated token, pumping the engine
    while the next one is in flight.  ``tokens`` is the list delivered so
    far; ``status``/``done`` mirror the underlying :class:`Request` (a
    rejected or failed request ends its stream early, its status says
    why)."""

    def __init__(self, frontend: "ServingFrontend", request: Request,
                 on_token: Optional[OnToken] = None):
        self._frontend = frontend
        self.request = request
        self.on_token = on_token
        self.tokens: list[int] = []

    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def done(self) -> bool:
        return self.request.terminal

    def __iter__(self) -> Iterator[int]:
        idx = 0
        while True:
            while idx < len(self.tokens):
                yield self.tokens[idx]
                idx += 1
            if self.done and idx >= len(self.tokens):
                return
            self._frontend.pump()

    def _deliver(self) -> None:
        """Forward the tokens the engine committed since the last delivery."""
        out = self.request.output
        while len(self.tokens) < len(out):
            tok = out[len(self.tokens)]
            self.tokens.append(tok)
            if self.on_token is not None:
                self.on_token(self, tok)


class ServingFrontend:
    def __init__(self, engine: ServingEngine, *, checkpointer=None,
                 sleep: Callable[[float], None] = time.sleep):
        if checkpointer is not None:
            raise NotImplementedError("a checkpointer (crash safety) has no port yet")
        self.engine = engine
        self._sleep = sleep
        self.streams: list[TokenStream] = []
        self._live: list[TokenStream] = []

    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: int = 0, on_token: Optional[OnToken] = None) -> TokenStream:
        """Enqueue one request and return its stream."""
        req = self.engine.submit(prompt, max_new_tokens, priority=priority)
        stream = TokenStream(self, req, on_token)
        self.streams.append(stream)
        if not req.terminal:             # REJECTED never enters the engine
            self._live.append(stream)
        return stream

    def idle(self) -> bool:
        """No queued and no in-slot work: pump() would be a no-op."""
        return not self.engine.queue and self.engine.pool.occupied() == 0

    def pump(self) -> int:
        """One engine iteration + delivery of every newly committed token to
        its stream (callbacks fire here, in submission order).  Returns the
        number of occupied slots."""
        occupied = self.engine.step()
        still = []
        for stream in self._live:
            stream._deliver()
            if not stream.done:
                still.append(stream)
        self._live = still
        return occupied

    def drain(self, max_iters: int = 10_000) -> list[TokenStream]:
        """Pump until every submitted stream is terminal."""
        it = 0
        while not self.idle():
            self.pump()
            it += 1
            if it > max_iters:
                raise EngineStallError(f"frontend did not drain in {max_iters} iterations")
        for stream in self._live:        # failed or evicted without a step
            stream._deliver()
        self._live = []
        return self.streams

    def play(self, arrivals: Sequence, *, max_iters: int = 1_000_000) -> list[TokenStream]:
        """Offer a workload open-loop: each arrival is submitted when the
        engine clock reaches its due time (``Arrival.t``, relative to the
        start of play), the engine pumps whenever work is in flight, and
        idle gaps are slept through.  Returns every stream after a full
        drain.  The clock is ``EngineConfig.clock`` and the sleeper is
        injectable, so tests replay workloads on a fake clock."""
        clock = self.engine.ecfg.clock
        t0 = clock()
        order = sorted(range(len(arrivals)), key=lambda i: arrivals[i].t)
        streams = []
        i = it = 0
        while i < len(order) or not self.idle():
            now = clock() - t0
            while i < len(order) and arrivals[order[i]].t <= now:
                a = arrivals[order[i]]
                streams.append(self.submit(a.prompt, a.max_new_tokens, priority=a.priority))
                i += 1
            if i < len(order) and self.idle():
                # nothing in flight: sleep to the next arrival
                self._sleep(max(arrivals[order[i]].t - (clock() - t0), 0.0))
            elif not self.idle():
                self.pump()
            it += 1
            if it > max_iters:
                raise EngineStallError(f"workload did not complete in {max_iters} iterations")
        return streams
