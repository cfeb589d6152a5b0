"""One CUDA graph per warmed (batch bucket, text bucket) of the fused
text->wav dispatch: the port's counterpart of the JAX package's per-shape
executable (``fastspeech2_tpu/synthesis/pipeline.py:112-142``).

A :class:`GraphCache` wraps ``forward(speakers, texts, src_lens, p, e, d,
p_offset, e_offset) -> (wav, FastSpeech2Output)`` (a serving replica's
cache wraps its acoustic front, ``-> (mel, output)``: the pipeline's
docstring says why).  :meth:`capture` makes
the graph of one input shape: an eager warm-up run on a side stream first
(it builds the kernels, fills the wrappers' plan caches and weight packs,
the position tables and the iSTFT constants, and lets cuDNN choose its
algorithms), then the capture on that stream.  :meth:`run` copies a
request into the graph's static inputs, replays it and copies the outputs
out.  The five controls are 0-d float32 inputs, so one graph serves every
control value, as the JAX executable's traced scalars do.  A capture that
fails raises: there is no eager fallback.

Only the shapes a warmup asks for get a graph, and it stays: a capture
costs a warm-up run and the capture, which a replay earns back a few
milliseconds at a time (PERF.md), so the pipeline dispatches any other
shape eagerly, and the graphs are at most the warmup grid.

Replays must not overlap (the static buffers are shared, and a graph is
not reentrant the way an executable is), so one lock covers the copy in,
the replay and the copy out, and captures too.  Under that lock the graphs
share one memory pool: a graph's intermediates may reuse another's, which
is safe because no two of them run at once and each result is copied out
before the next replay.

A graph reads the cached constants of the forward (position tables, the
iSTFT's constants: ``ops/device_cache.py``) by address at every replay, so
it keeps every constant its capture was handed: a cache that evicts one
then frees nothing a graph still reads.

The kernel wrappers count their launches in Python, so inside a graph
they count once, at capture.  Each graph keeps the launches its capture
made, and counts its replays: :meth:`launches` is their product, summed.
``setup_launches`` sums what the wrappers counted while graphs were made
(the warm-up runs and the captures), so that a caller can tell them from
the launches of eager dispatches.
"""

import threading
import time

import torch

from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn, cuda_resblock
from fastspeech2_tpu_torch.ops.device_cache import keep_read

# the launch counters of the kernels a fused dispatch can run
KERNELS = ("K1", "K1_bf16", "K2", "K2_bf16", "K4")


def kernel_counts():
    """-> {kernel: its wrapper's launch count so far}."""
    return {"K1": cuda_attention.launches,
            "K1_bf16": cuda_attention.launches_bf16,
            "K2": cuda_ffn.launches, "K2_bf16": cuda_ffn.launches_bf16,
            "K4": cuda_resblock.launches}


class _Graph:
    """A captured graph, its static inputs and outputs, the cached constants
    it reads, the kernel launches of its capture and its replays."""

    def __init__(self, graph, inputs, outputs, constants, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.constants = constants
        self.launches = launches
        self.replays = 0


class GraphCache:
    def __init__(self, forward, device):
        self.forward = forward
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.pool = None
        # one side stream for every warm-up and capture: the caching
        # allocator reuses a freed block only on the stream it was made on,
        # so the graphs share the pool's memory only if they share this
        self.stream = None
        self.graphs = {}      # (batch, text) -> _Graph
        self.capture_seconds = 0.0
        self.setup_launches = dict.fromkeys(KERNELS, 0)

    def __contains__(self, shape):
        return tuple(shape) in self.graphs

    def capture(self, speakers, texts, src_lens):
        """Capture the graph of ``texts``' shape unless it exists."""
        with self.lock, torch.inference_mode():
            key = tuple(texts.shape)
            if key not in self.graphs:
                self.graphs[key] = self._capture(speakers, texts, src_lens)

    def run(self, speakers, texts, src_lens, controls):
        """Replay the graph of ``texts``' shape on these inputs and the five
        controls -> (wav, output), copies that no later replay touches."""
        with self.lock, torch.inference_mode():
            g = self.graphs[tuple(texts.shape)]
            for static, value in zip(g.inputs, (speakers, texts, src_lens)):
                static.copy_(value)
            for static, value in zip(g.inputs[3:], controls):
                static.fill_(float(value))
            g.graph.replay()
            g.replays += 1
            wav, out = g.outputs
            return wav.clone(), type(out)(*(None if t is None else t.clone()
                                            for t in out))

    def _capture(self, speakers, texts, src_lens):
        t0 = time.perf_counter()
        start = kernel_counts()
        dev = self.device
        inputs = [t.clone() for t in (speakers, texts, src_lens)]
        inputs += [torch.tensor(v, dtype=torch.float32, device=dev)
                   for v in (1.0, 1.0, 1.0, 0.0, 0.0)]
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.forward(*inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernel_counts()
        with keep_read() as constants, torch.cuda.graph(
                graph, pool=self.pool, stream=side,
                capture_error_mode="thread_local"):
            outputs = self.forward(*inputs)
        after = kernel_counts()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.capture_seconds += time.perf_counter() - t0
        for k in KERNELS:
            self.setup_launches[k] += after[k] - start[k]
        return _Graph(graph, inputs, outputs, constants,
                      {k: after[k] - before[k] for k in KERNELS})

    def launches(self):
        """-> {kernel: launches its graphs' replays made}: each graph's
        capture count times its replays."""
        with self.lock:
            return {k: sum(g.launches[k] * g.replays
                           for g in self.graphs.values()) for k in KERNELS}

    def replays(self):
        with self.lock:
            return sum(g.replays for g in self.graphs.values())

    def reset_replays(self):
        with self.lock:
            for g in self.graphs.values():
                g.replays = 0

    def pool_bytes(self):
        """Bytes the graphs' shared pool holds on the card, or None where
        this PyTorch's memory snapshot does not name pools."""
        if self.pool is None:
            return 0
        segments = torch.cuda.memory_snapshot()
        if not any("segment_pool_id" in s for s in segments):
            return None
        return sum(s["total_size"] for s in segments
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))
