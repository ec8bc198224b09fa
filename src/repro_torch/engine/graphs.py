"""Capture and replay of the executor's decode-only steps as CUDA graphs.

The reference compiles each decode-only step once with ``jax.jit`` (the
K-step horizon as ONE ``lax.scan``) and dispatches it as one call.  The
port's counterpart is a captured CUDA graph: a decode step of an eager
PyTorch model is hundreds of small launches a layer, and their host-side
enqueueing, not the device, bounds the step.  A replay enqueues them all
at once.

:class:`StepGraphs` holds one executor's graphs, keyed by the shapes the
step was packed to (the paged horizon by ``(B, NB, K)``, the dense steps
by K).  A key's first use runs the step eagerly on a side stream, which
is also the warm-up (cuBLAS workspaces, the kernel library's build and
load), returns that run's results, and then captures the step into a
graph whose inputs are static buffers.  Every later use copies the host
inputs into those buffers and replays; the results are the graph's
static output tensors, overwritten by the next replay of the same graph
(an executor has one step in flight, and it is read back before the
next is dispatched).

What makes capture possible: nothing on the decode path reads a device
value on the host (the kernels' split sizes and workspaces follow the
shapes alone, and their C launchers enqueue on the current stream), and
the pool or dense cache is updated in place at a fixed address.  An
executor that rebuilds its pool must :meth:`StepGraphs.clear` the graphs
that hold the old one.

The garbage collector is off while a graph is captured.  A collection
there may free an unreachable executor and so destroy its graphs and
release their memory pool: CUDA refuses those calls while a capture is
under way and invalidates the capture (``cudaErrorStreamCaptureInvalidated``,
then the next kernel launch in it fails).

All graphs of an executor share one memory pool: they replay in turn on
one stream, and each holds only its static outputs alive between
replays.  Non-greedy sampling draws from the executor's generator inside
the graphs; it is registered with each graph, so that every replay
draws new numbers.

The kernel wrappers count a launch in Python, which a replay does not
run: capture records how many launches of each kernel a graph holds (and
takes them back off the counters, since capture launches nothing), and
every replay adds them.  A capture or replay that fails raises; nothing
falls back to the eager step.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, List, Sequence

import numpy as np
import torch

from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention, paged_chunked_prefill_attention)
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention)
from repro_torch.kernels.ssd_scan.ops import ssd_scan

#: every kernel wrapper of the port (each keeps its launch count on itself)
COUNTED = (paged_decode_attention, paged_chunked_prefill_attention,
           decode_attention, chunked_prefill_attention, ssd_scan)


def _host_to_device(arrays: Sequence[np.ndarray], device):
    """Host arrays as new device tensors (copied first: the caller updates
    its host arrays right after the dispatch)."""
    return [torch.from_numpy(np.array(a)).to(device, non_blocking=True)
            for a in arrays]


class CapturedStep:
    """One captured graph: its static input buffers, its static outputs and
    the kernel launches one replay makes."""

    def __init__(self, graph, inputs: List[torch.Tensor],
                 outputs: Sequence[torch.Tensor], launches: Dict):
        self.graph = graph
        self.inputs = inputs
        self.outputs = tuple(outputs)
        self.launches = launches

    def replay(self, host_inputs: Sequence[np.ndarray]):
        for buf, a in zip(self.inputs, host_inputs):
            buf.copy_(torch.from_numpy(np.array(a)), non_blocking=True)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.outputs


class StepGraphs:
    """The captured decode-only steps of one executor on one CUDA device."""

    def __init__(self, device, generators: Sequence[torch.Generator] = ()):
        self.device = torch.device(device)
        self.generators = list(generators)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Hashable, CapturedStep] = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0

    def __len__(self) -> int:
        return len(self.graphs)

    def clear(self):
        """Drop every graph (they hold the addresses of tensors that are
        about to be replaced); later steps capture anew."""
        self.graphs.clear()
        self.pool = torch.cuda.graph_pool_handle()

    def run(self, key: Hashable, fn: Callable, host_inputs):
        """``fn(*device inputs)`` -> tuple of device tensors, for the
        bucket ``key``: a replay of its graph, or at the key's first use
        the eager run followed by the capture."""
        step = self.graphs.get(key)
        if step is not None:
            self.replays += 1
            return step.replay(host_inputs)
        main = torch.cuda.current_stream(self.device)
        inputs = _host_to_device(host_inputs, self.device)
        # the eager run is the warm-up; its results are this step's
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            outputs = fn(*inputs)
        main.wait_stream(self.stream)
        for t in inputs:
            t.record_stream(self.stream)
        for t in outputs:
            t.record_stream(main)
        self.graphs[key] = self._capture(fn, inputs)
        return outputs

    def _capture(self, fn: Callable, examples) -> CapturedStep:
        t0 = time.perf_counter()
        static = [torch.empty_like(t) for t in examples]
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = {k: k.launches for k in COUNTED}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = fn(*static)
        finally:
            if collecting:
                gc.enable()
            # capture launched nothing: the counts go back, and each
            # replay adds what the graph holds
            launches = {k: k.launches - n for k, n in before.items()
                        if k.launches != n}
            for k, n in before.items():
                k.launches = n
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return CapturedStep(graph, static, outputs, launches)
