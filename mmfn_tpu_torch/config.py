"""Global model/data configuration.

The port's own copy of the JAX package's ``GlobalConfig``: the same fields
with the same defaults, so a configuration carries across unchanged and a
converted checkpoint produces identical shapes. The training engine reads
``compute_dtype``, ``checkpoint_backend`` and (through the ResNets)
``remat``; fields that only the JAX package reads (``matmul_precision``,
``mesh_axes``) are kept for that reason.

``attn_impl`` keeps its two values: ``"xla"`` selects the plain
matmul-softmax attention, ``"pallas"`` the port's hand-written fused CUDA
kernel (``ops/attention.py``) for inference. Training always takes the plain
path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class GlobalConfig:
    # ---- data ----
    seq_len: int = 1            # input timesteps
    pred_len: int = 4           # future waypoints predicted
    n_views: int = 1            # number of camera views
    input_resolution: int = 256
    scale: int = 1
    crop: int = 256

    # ---- optimization ----
    lr: float = 1e-4
    weight_decay: float = 0.01  # torch.optim.AdamW default, applied to all params

    # ---- conv encoder / fusion anchors ----
    vert_anchors: int = 8
    horz_anchors: int = 8

    # ---- GPT fusion ----
    n_embd: int = 512
    block_exp: int = 4
    n_layer: int = 8
    n_head: int = 4
    n_scale: int = 4
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    attn_impl: str = "xla"      # "xla" plain attention | "pallas" fused kernel

    # ---- waypoint PID controller ----
    turn_KP: float = 1.0
    turn_KI: float = 0.65
    turn_KD: float = 0.2
    turn_n: int = 30
    speed_KP: float = 4.0
    speed_KI: float = 0.4
    speed_KD: float = 0.8
    speed_n: int = 30
    max_throttle: float = 0.75
    brake_speed: float = 0.1
    brake_ratio: float = 1.1
    clip_delta: float = 0.25

    # ---- radar GAT ----
    gat_hidden: int = 81
    gat_heads: int = 2
    gat_alpha: float = 0.2
    radar_points: int = 81
    radar_features: int = 5

    # ---- vector map ----
    lane_node_num: int = 10
    feature_num: int = 5
    up: float = 28.0
    down: float = 28.0
    left: float = 28.0
    right: float = 28.0

    # ---- static shapes and JAX-side knobs ----
    max_lanes: int = 64          # static padding for the ragged lane dimension
    compute_dtype: str = "float32"
    remat: bool = False
    checkpoint_backend: str = "msgpack"
    matmul_precision: str = "default"
    mesh_axes: Tuple[str, ...] = ("data",)

    @property
    def anchors(self) -> int:
        return self.vert_anchors * self.horz_anchors

    def replace(self, **kw) -> "GlobalConfig":
        return dataclasses.replace(self, **kw)
