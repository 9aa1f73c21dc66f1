"""One CUDA graph of a function on tensors at fixed addresses.

The JAX agent dispatches a whole plan, its weight prep and each update
step as one jitted program each (tdmpc2_tpu/tdmpc2.py:140, 153-161). The
port's counterpart is a `torch.cuda.CUDAGraph`: `Graph(fn, counted, device)` runs `fn()` once
eagerly on a side stream (the warm-up a capture needs: libraries loaded,
cuBLAS's workspace made, the kernels' shared-memory attributes set), keeps
that run's result as `first`, then captures `fn()`; `replay()` runs the
captured work again and returns the tensors the capture made. Everything
`fn` reads and writes stays at the address it had at capture: the caller
refills inputs in place and keeps every tensor that `fn` reads alive and
where it is. A failed capture or replay raises; nothing runs `fn`
eagerly in its place. Where `fn` writes its inputs in place (an update
step), the eager run is a real call: the caller counts it as the first,
and the capture itself runs nothing. Each graph keeps its own memory pool,
whose bytes the capture reserved are `pool_bytes`.

Launch counts: the kernel wrappers in `counted` count their launches in a
`.launches` attribute. The capture launches nothing, so its counts are
taken back; each replay adds what the capture counted, so that a replay
counts as the eager run it repeats. `Graph.replays` and `Graph.captures`
count replays and captures by the `kind` each graph was given.
"""

from __future__ import annotations

import torch

from tdmpc2_tpu_torch.utils import tree


class Graph:
    """`fn`'s work on `device`, captured once, replayed on the current
    stream."""

    replays: dict = {}
    captures: dict = {}

    def __init__(self, fn, counted, device, kind: str):
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.first = fn()
        main.wait_stream(side)
        # `first` was made on the side stream and is read on the main one
        tree.map(lambda t: t.record_stream(main), self.first)
        before = [w.launches for w in counted]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            reserved = torch.cuda.memory_reserved(device)
            self.out = fn()
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.counted = counted
        self.deltas = [w.launches - b for w, b in zip(counted, before)]
        for w, b in zip(counted, before):
            w.launches = b
        self.kind = kind
        Graph.captures[kind] = Graph.captures.get(kind, 0) + 1

    def replay(self):
        """Replay the captured work; returns the capture's outputs, which
        the next replay overwrites."""
        self.graph.replay()
        for w, d in zip(self.counted, self.deltas):
            w.launches += d
        Graph.replays[self.kind] = Graph.replays.get(self.kind, 0) + 1
        return self.out
