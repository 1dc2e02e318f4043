"""Batch-1 and fleet inference pipeline serving the closed loop.

Each call covers LiDAR BEV binning (the CUDA kernel ``csrc/bev_hist.cu``),
the radar adjacency, image normalization (inside the model) and the MMFN
forward; the host only crops the camera frame, fits the radar set and crops
lanes. Shapes are static: the two LiDAR sweeps pad to ``points_per_sweep``
rows each, lanes to ``config.max_lanes``.

Transport per sample: the camera as uint8, the padded cloud as f16 (the BEV
kernel reads f16 and bins in f32), or with ``host_bev`` the uint8 BEV count
grid binned on the host. With ``packed`` (the default) every input of a call
is written into ONE pinned host buffer and crosses with one ``non_blocking``
copy; on the device each input is a byte view of its own contiguous,
16-byte-aligned range, so ``Tensor.view(dtype)`` applies. A CUDA event
recorded after the copy guards the reused pinned buffer: the next call waits
for it before writing.

``HostCopy`` fetches a dispatch without blocking the caller: the async agent
and the pipelined fleet steer from the previous tick's waypoints while this
tick's forward runs.

Fleet sharding (``device`` a list; the counterpart of the JAX package's
``shard_over_mesh`` and ``JitPipeline(mesh=)``). The pipeline holds one model
replica per entry (:class:`Replicas`). ``dispatch_fleet`` splits the rows
into contiguous shards of ceil(N / K), pads the last shard with zero rows
(``lane_num`` 1) and slices them off again; each shard is staged, copied and
run on its own CUDA stream, so both kernels, which launch on the current
stream, go with it. The shards' waypoints are joined into one (N, pred_len,
2) tensor on the first device: each shard's stream copies its rows in and
records an event, and the caller's stream waits on the events, never on a
device synchronise; ``HostCopy`` then fetches every shard's rows into one
pinned buffer. The same card may be named twice, as two shards on two
streams: that is how a one-card machine checks the split, not a way to go
faster. ``dispatch`` (one sample) runs on the first replica.

CUDA graphs (``harness/agents/graphs.py``). On a CUDA device ``dispatch``
and ``dispatch_fleet`` replay a captured graph of the forward (the BEV,
the radar adjacency, the image normalization and the MMFN forward), one per
shard, input layout and process state, in place of issuing it op by op;
the packed copy writes into the graph's static input buffer. A change of
TF32, autocast, ``attn_impl`` or a patched op function captures anew.
``cuda_graphs=False`` runs the forward eagerly on the card; a CPU pipeline
always runs it eagerly.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.harness.agents.graphs import ForwardGraphs, Layout, process_state
from mmfn_tpu_torch.models import gpt
from mmfn_tpu_torch.ops.lidar import (HIST_MAX_PER_PIXEL, bev_counts_np,
                                      lidar_to_histogram_features, pad_points)
from mmfn_tpu_torch.ops.radar import radar_adjacency

MAX_SWEEP_POINTS = 32768  # one 64-ch sweep at 600k pts/s / 20 Hz, padded
_ALIGN = 16
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32}


class HostCopy:
    """A dispatch's output on its way to the host.

    On the GPU the device-to-host copy is enqueued at once, ``non_blocking``,
    into fresh pinned memory, on the dispatching thread's current stream right
    behind the forward that writes the output; a CUDA event recorded after it
    marks the copy done. ``result()`` waits on that event, so the array it
    returns holds the dispatch's finished work, and the copy never queues
    behind a later forward. A CPU output is already on the host.
    (``np.asarray`` of a CUDA tensor raises, so callers fetch through this.)
    """

    def __init__(self, out: torch.Tensor):
        self._done = None
        if out.device.type == "cuda":
            with torch.inference_mode():
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
            out = host
        self._host = out

    def result(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


def packed_offsets(layout: Layout) -> Tuple[List[Optional[int]], int]:
    """Each input's byte offset in one packed buffer (None kept), each
    range 16-byte aligned, and the buffer's total bytes."""
    offsets, total = [], 0
    for item in layout:
        if item is None:
            offsets.append(None)
            continue
        shape, dtype = item
        offsets.append(total)
        total += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return offsets, total


def byte_views(buf: torch.Tensor, layout: Layout, offsets) -> List[Optional[torch.Tensor]]:
    """The inputs of ``layout`` as views of the packed byte buffer ``buf``."""
    out = []
    for item, off in zip(layout, offsets):
        if item is None:
            out.append(None)
            continue
        shape, dtype = item
        seg = buf[off:off + math.prod(shape) * dtype.itemsize]
        out.append(seg.view(dtype).view(shape))
    return out


def device_inputs(layout: Layout, device: torch.device) -> tuple:
    """A graph's static inputs of ``layout`` on ``device``: (one packed byte
    buffer, its views)."""
    offsets, total = packed_offsets(layout)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return buf, byte_views(buf, layout, offsets)


def _zero_row(row: tuple) -> tuple:
    """A padding sample shaped as ``row``: zeros, ``lane_num`` 1 (the lane
    attention wants one valid token)."""
    out = [None if a is None else np.zeros_like(a) for a in row]
    if out[3] is not None:
        out[3] = np.ones_like(out[3])
    return tuple(out)


def staging_buffer(cache: dict, nbytes: int, device: torch.device):
    """A reusable host buffer of ``nbytes`` (pinned for a CUDA ``device``)
    from ``cache``, once the previous copy out of it has finished; returns
    (uint8 buffer, event to record after the next copy, or None)."""
    buf = cache.get(nbytes)
    if buf is None:
        cuda = device.type == "cuda"
        buf = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda),
               torch.cuda.Event() if cuda else None)
        cache[nbytes] = buf
    host, done = buf
    if done is not None:
        done.synchronize()       # the previous copy out of this buffer
    return host, done


def resolve_devices(device) -> List[torch.device]:
    """``device`` (None, one device, or a list of them) -> the list of
    devices, None being the CUDA device (raises when there is none)."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    return [resolve_device(device)]


class Replicas:
    """One model replica and one stream per device entry (module docstring):
    the first entry holds ``model`` itself, the others copies of it.
    ``run(n, shard_fn)`` calls ``shard_fn`` for each shard of ``n`` rows
    under entry ``i``'s stream and joins the shards' outputs on the first
    device."""

    def __init__(self, model: torch.nn.Module, devices: Sequence[torch.device]):
        self.devices = list(devices)
        model = model.to(self.devices[0]).eval()
        self.models = [model] + [copy.deepcopy(model).to(d).eval() for d in self.devices[1:]]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" and len(self.devices) > 1
                        else None for d in self.devices]

    def __len__(self) -> int:
        return len(self.devices)

    def bounds(self, n: int) -> List[tuple]:
        """(lo, hi, rows) of each shard holding real rows: contiguous, ceil(n / K)
        rows each, the last one padded up to that."""
        per = -(-n // len(self.devices))
        return [(lo, min(n, lo + per), per) for lo in range(0, n, per)]

    @torch.inference_mode()
    def run(self, n: int, shard_fn: Callable[[int, int, int, int], torch.Tensor]
            ) -> torch.Tensor:
        """``shard_fn(i, lo, hi, rows)`` -> the first ``hi - lo`` output rows of
        shard ``i`` on its device; returns all ``n`` rows on the first
        device."""
        if len(self.devices) == 1:
            return shard_fn(0, 0, n, n)
        outs = []
        for i, (lo, hi, rows) in enumerate(self.bounds(n)):
            stream = self.streams[i]
            if stream is None:
                outs.append(shard_fn(i, lo, hi, rows))
                continue
            stream.wait_stream(torch.cuda.current_stream(self.devices[i]))
            with torch.cuda.stream(stream):
                outs.append(shard_fn(i, lo, hi, rows))
        main = self.devices[0]
        if main.type != "cuda":
            return torch.cat([o.to(main) for o in outs])
        joined = torch.empty((n,) + tuple(outs[0].shape[1:]), dtype=outs[0].dtype, device=main)
        current = torch.cuda.current_stream(main)
        for (lo, hi, _), out, stream in zip(self.bounds(n), outs, self.streams):
            if stream is None:
                joined[lo:hi].copy_(out)
                continue
            with torch.cuda.stream(stream):
                joined[lo:hi].copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            current.wait_event(done)
        return joined


class TorchPipeline:
    """Wraps an MMFN into one sensor -> waypoints call.

    Same public calls as the JAX package's ``JitPipeline``: ``dispatch``,
    ``__call__``, ``dispatch_fleet`` and ``zero_lanes``. ``dispatch`` and
    ``dispatch_fleet`` return the device tensor without waiting for it.
    ``device``: one device, or a list of them to split ``dispatch_fleet``
    over (module docstring; the JAX pipeline's ``mesh``). ``cuda_graphs``:
    replay captured CUDA graphs on a CUDA device (``graphs`` holds each
    shard's, None where the forward runs eagerly).
    """

    def __init__(self, model: torch.nn.Module, config: GlobalConfig,
                 points_per_sweep: int = MAX_SWEEP_POINTS, host_bev: bool = False,
                 packed: bool = True, device=None, cuda_graphs: bool = True):
        self.replicas = Replicas(model, resolve_devices(device))
        self.device = self.replicas.devices[0]
        self.model = self.replicas.models[0]
        self.config = config
        self.variant = model.variant
        self.points_per_sweep = points_per_sweep
        self.host_bev = host_bev
        self.packed = packed
        # a shard's total bytes -> (host buffer, copy-done event or None)
        self._staging = [{} for _ in self.replicas.devices]
        self.graphs = [ForwardGraphs(d, functools.partial(device_inputs, device=d), stream)
                       if cuda_graphs and d.type == "cuda" else None
                       for d, stream in zip(self.replicas.devices, self.replicas.streams)]
        self._attention = [[m for m in replica.modules() if isinstance(m, gpt.SelfAttention)]
                           for replica in self.replicas.models]

    # ---- host side ----

    def _host_args(self, image, points, lanes, lane_num, radar, map_img,
                   target_point, velocity):
        """Transport-dtype conversions for ONE sample (no batch dim)."""
        if self.host_bev:
            points4 = bev_counts_np(points)
        else:
            points4 = pad_points(points, 2 * self.points_per_sweep).astype(np.float16)
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = image.astype(np.uint8)   # exact: raw 0-255 camera values
        lanes_arr = lane_num_arr = None
        if lanes is not None:
            lanes_arr = np.asarray(lanes, dtype=np.float32)
            lane_num_arr = np.asarray(lane_num, dtype=np.int32)
        return (
            image,
            points4,
            lanes_arr,
            lane_num_arr,
            np.asarray(radar, dtype=np.float32),
            None if map_img is None else np.asarray(map_img).astype(np.uint8),
            np.asarray(target_point, dtype=np.float32),
            np.asarray(velocity, dtype=np.float32),
        )

    def _to_device(self, rows: Sequence[tuple], shard: int = 0) -> List[Optional[torch.Tensor]]:
        """Per-sample transport tuples -> batched tensors on shard
        ``shard``'s device (None kept). Packed, with graphs, the copy writes
        the static inputs of the shard's graphs; otherwise the tensors are
        fresh (unpacked, a graph's replay copies them in)."""
        n = len(rows)
        cols = list(zip(*rows))
        device = self.replicas.devices[shard]
        if not self.packed:
            return [None if col[0] is None else
                    torch.from_numpy(np.stack(col)).to(device) for col in cols]
        layout = tuple(None if col[0] is None else
                       ((n,) + col[0].shape, _TORCH_DTYPES[col[0].dtype]) for col in cols)
        offsets, total = packed_offsets(layout)
        host, done = staging_buffer(self._staging[shard], total, device)
        host_np = host.numpy()
        for col, off in zip(cols, offsets):
            if off is None:
                continue
            row_bytes = col[0].nbytes
            for i, a in enumerate(col):
                host_np[off + i * row_bytes:off + (i + 1) * row_bytes] = \
                    np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        graphs = self.graphs[shard]
        if graphs is None:
            out = byte_views(host.to(device, non_blocking=True), layout, offsets)
        else:
            buf, out = graphs.inputs(layout)
            buf.copy_(host, non_blocking=True)
        if done is not None:
            done.record()
        return list(out)

    # ---- device side ----

    @torch.inference_mode()
    def _apply_batched(self, image, points, lanes, lane_num, radar, map_img,
                       target_point, velocity, shard: int = 0) -> torch.Tensor:
        """The forward on shard ``shard``'s inputs: replayed from its graph
        on a CUDA device (module docstring), else run eagerly."""
        inputs = (image, points, lanes, lane_num, radar, map_img, target_point, velocity)
        graphs = self.graphs[shard]
        if graphs is None:
            return self._forward(shard, *inputs)
        model = self.replicas.models[shard]
        state = process_state(graphs.device.type, model, self._attention[shard],
                              (lidar_to_histogram_features, gpt.fused_attention))
        return graphs.run(inputs, state, functools.partial(self._forward, shard))

    def _forward(self, shard, image, points, lanes, lane_num, radar, map_img,
                 target_point, velocity) -> torch.Tensor:
        """The eager forward: what a graph captures."""
        if self.host_bev:
            bev = points.to(torch.float32) / HIST_MAX_PER_PIXEL
        else:
            bev = lidar_to_histogram_features(points)
        batch = Batch(
            image=image.to(torch.float32),
            lidar_bev=bev,
            map_img=None if map_img is None else map_img.to(torch.float32),
            lanes=lanes,
            lane_num=lane_num,
            radar=radar,
            radar_adj=radar_adjacency(radar),
            target_point=target_point,
            velocity=velocity,
        )
        return self.replicas.models[shard](batch)

    # ---- public calls ----

    def dispatch(self, image: np.ndarray, points: np.ndarray,
                 lanes: Optional[np.ndarray], lane_num: Optional[int],
                 radar: np.ndarray, map_img: Optional[np.ndarray],
                 target_point: np.ndarray, velocity: float) -> torch.Tensor:
        """Enqueue one forward; returns the (pred_len, 2) device tensor
        without waiting for it."""
        row = self._host_args(image, points, lanes, lane_num, radar, map_img,
                              target_point, velocity)
        return self._apply_batched(*self._to_device([row]))[0]

    def dispatch_fleet(self, payloads) -> torch.Tensor:
        """One batched forward over N agents' ``prepare_step`` payloads, split
        over the devices; returns the (N, pred_len, 2) tensor on the first
        device without waiting for it."""
        rows = [self._host_args(p["image"], p["points"], p["lanes"], p["lane_num"],
                                p["radar"], p["map_img"], p["target_point"], p["speed"])
                for p in payloads]

        def shard(i, lo, hi, size):
            part = rows[lo:hi] + [_zero_row(rows[0])] * (size - (hi - lo))
            return self._apply_batched(*self._to_device(part, i), shard=i)[:hi - lo]

        return self.replicas.run(len(rows), shard)

    def __call__(self, image: np.ndarray, points: np.ndarray,
                 lanes: Optional[np.ndarray], lane_num: Optional[int],
                 radar: np.ndarray, map_img: Optional[np.ndarray],
                 target_point: np.ndarray, velocity: float) -> np.ndarray:
        """Synchronous sensor -> waypoints call (dispatch + fetch)."""
        return self.dispatch(image, points, lanes, lane_num, radar, map_img,
                             target_point, velocity).cpu().numpy()

    @functools.cached_property
    def zero_lanes(self) -> np.ndarray:
        cfg = self.config
        return np.zeros((cfg.max_lanes, cfg.lane_node_num, cfg.feature_num), np.float32)
