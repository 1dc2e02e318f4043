"""CUDA graphs of the serving pipeline's forward, one per input layout.

The counterpart of ``JitPipeline``'s program cache in the JAX package (one
compiled program per packed layout, one per fleet size): on a CUDA device
``TorchPipeline`` keeps one :class:`ForwardGraphs` per shard, and each holds
one captured graph of the eager forward per key, so a request costs one
graph launch on the host instead of about a thousand eagerly issued ops.

Key: ``(layout, state)``. ``layout`` is each input's shape (batch rows
included) and dtype, None for an absent input (``host_bev`` shows there:
a uint8 count grid in place of an f16 cloud). ``state`` is what the
eager forward reads from process state that changes what it computes
(:func:`process_state`): TF32 in cuBLAS and cuDNN, autocast, the model's
train flag, each ``SelfAttention.attn_impl``, and the identity of the op
functions callers patch. A change in any of them captures anew, so a replay
never serves a forward that the eager call would not have run.

First call per key: the forward runs once eagerly on the shard's side
stream (cuDNN and cuBLAS set up, the CUDA kernels build, load and set
their attributes), and that warm-up's output is the call's reply. Then the
same forward is captured into the shard's memory pool; the capture runs
nothing on the card. Later calls with the key replay it on the caller's
stream and return a clone of its static output, so no later call overwrites
a reply a caller still holds.

Inputs: one static set per layout (:meth:`ForwardGraphs.inputs`), shared by
that layout's graphs; the pipeline's host-to-device copy writes into it on
the replaying stream, right before the replay.

Pool: every graph of a shard shares one pool (``torch.cuda.graph_pool_
handle``). PyTorch allows sharing when the graphs never run concurrently;
a later capture may then reuse memory an earlier graph's intermediates or
static output used, so an earlier graph's replay may overwrite a later
graph's static output. Here that is safe: a shard's graphs replay only on
its one stream, in turn, and each replay's static output is cloned on that
stream before the next replay is enqueued. Shards run concurrently, so each
has its own pool.

Launch counters: a kernel wrapper counts a launch in Python, which a replay
does not run. Each graph records how far each counter moved while it was
captured, the counters are put back, and every replay adds that amount, so
the counters still count what the card ran. On the CPU no graph exists:
the pipeline runs eagerly.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from mmfn_tpu_torch.ops import KERNELS

GRAPHS_PER_SHARD = 8    # a fleet of 8 shrinking to 1 keeps all its graphs

Layout = Tuple[Optional[Tuple[Tuple[int, ...], torch.dtype]], ...]


def layout_of(tensors: Sequence[Optional[torch.Tensor]]) -> Layout:
    """Each tensor's (shape, dtype), None kept."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in tensors)


def process_state(device_type: str, model: torch.nn.Module, attention: Sequence,
                  functions: tuple) -> tuple:
    """What the eager forward of ``model`` reads from process state that
    changes what it computes: TF32 in cuBLAS and cuDNN, autocast on
    ``device_type`` and its dtype, the train flag, each of ``attention``'s
    ``attn_impl`` and the identity of each of ``functions``."""
    autocast = torch.is_autocast_enabled(device_type)
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_autocast_dtype(device_type) if autocast else None,
            model.training, tuple(m.attn_impl for m in attention), functions)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _set_launch_counts(counts: Dict[str, int]) -> None:
    for name, k in KERNELS.items():
        k.launches = counts[name]


class _Graph:
    """A captured forward: ``replay()`` reruns it into ``output``;
    ``launches`` is each kernel's launches in one run."""

    def __init__(self, replay: Callable[[], None], output: torch.Tensor,
                 launches: Dict[str, int]):
        self.replay, self.output, self.launches = replay, output, launches


class ForwardGraphs:
    """One shard's graphs (module docstring), at most ``capacity`` of them
    (:data:`GRAPHS_PER_SHARD`): beyond that the least recently replayed one
    is dropped.

    ``make_inputs(layout)`` -> (backing byte buffer, the input tensors)
    allocates one static input set on ``device``. ``stream`` is the
    shard's own stream, on which its graphs are captured (and replayed, as
    the caller's current stream); None on a CUDA device gives a new side
    stream for the warm-up and the capture."""

    def __init__(self, device: torch.device, make_inputs: Callable,
                 stream: Optional[torch.cuda.Stream] = None):
        self.device, self.capacity = device, GRAPHS_PER_SHARD
        self._make_inputs = make_inputs
        cuda = device.type == "cuda"
        self.stream = stream if stream is not None or not cuda else torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self._inputs: Dict[Layout, tuple] = {}
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        self.captures = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def inputs(self, layout: Layout) -> tuple:
        """(backing byte buffer, static input tensors) of ``layout``."""
        static = self._inputs.get(layout)
        if static is None:
            with torch.inference_mode(False):     # copied into outside inference mode too
                static = self._make_inputs(layout)
            self._inputs[layout] = static
        return static

    def run(self, inputs: Sequence[Optional[torch.Tensor]], state: tuple,
            forward: Callable[..., torch.Tensor]) -> torch.Tensor:
        """``forward(*inputs)``: replayed from the graph of ``inputs``'
        layout and ``state``, captured first when there is none. Inputs
        that are not already the layout's static tensors are copied into
        them."""
        layout = layout_of(inputs)
        _, static = self.inputs(layout)
        for s, x in zip(static, inputs):
            if x is not None and x.data_ptr() != s.data_ptr():
                s.copy_(x)
        key = (layout, state)
        graph = self._graphs.get(key)
        if graph is None:
            return self._capture(key, static, forward)
        self._graphs.move_to_end(key)
        graph.replay()
        for name, n in graph.launches.items():
            KERNELS[name].launches += n
        return graph.output.clone()

    def pool_bytes(self) -> int:
        """Bytes the card holds for this shard's pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)              # a pool's id is unique across devices
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def _side_stream(self):
        return contextlib.nullcontext() if self.stream is None else torch.cuda.stream(self.stream)

    def _capture(self, key: tuple, static: list, forward: Callable) -> torch.Tensor:
        """Warm up (the call's reply), capture, then drop the least recently
        replayed graphs beyond ``capacity``."""
        current = None
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
        with self._side_stream():
            out = forward(*static)
        if current is not None:
            current.wait_stream(self.stream)
            out.record_stream(current)
        before = launch_counts()
        try:
            replay, output = self._record(forward, static)
        finally:
            after = launch_counts()
            _set_launch_counts(before)
        self._graphs[key] = _Graph(replay, output, {k: after[k] - before[k] for k in before})
        self.captures += 1
        # the capture synchronized the device, so no replay of a dropped
        # graph, and no copy into a dropped input set, is still in flight
        while len(self._graphs) > self.capacity:
            self._graphs.popitem(last=False)
        live = {layout for layout, _ in self._graphs}
        for layout in [k for k in self._inputs if k not in live]:
            del self._inputs[layout]
        return out

    def _record(self, forward: Callable, static: list) -> Tuple[Callable[[], None], torch.Tensor]:
        """Capture ``forward(*static)``; (replay, static output). A capture
        error raises: there is no eager fallback. ``thread_local``: only this
        thread is barred from calls a capture forbids, so another thread's
        fetch or event wait does not break it."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            output = forward(*static)
        return graph.replay, output
