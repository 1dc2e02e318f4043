"""The benchmark baselines: AIM, CILRS and TransFuser.

Strict subsets of the MMFN layer zoo, so they share its ResNets, fusion
transformer, join MLP and waypoint decoder:

- ``aim``: camera -> ResNet34 -> join MLP -> GRU decoder fed the
  concatenation of the position and the target point (``'cat'``).
- ``cilrs``: camera -> ResNet18, plus a velocity embedding; six
  command-selected control branches (sigmoid outputs mapped to steer,
  throttle and brake) and a velocity head.
- ``transfuser``: camera and LiDAR BEV streams fused by 4 interleaved
  transformers of ``n_views + 1`` token groups (T = 128) -> join MLP -> GRU
  decoder fed position + target point (``'add'``).

Parameter names are the reference checkpoint's keys, so a reference
``.pth`` loads strictly. As in the JAX package, the baselines ignore
``config.remat``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.models.common import init_weights, join_mlp
from mmfn_tpu_torch.models.decoder import decode_waypoints
from mmfn_tpu_torch.models.gpt import FusionTransformer
from mmfn_tpu_torch.models.mmfn import STAGE_EMBD, ImageCNN, LidarEncoder, _nchw
from mmfn_tpu_torch.models.resnet import resnet18
from mmfn_tpu_torch.ops.image import normalize_imagenet
from mmfn_tpu_torch.ops.pool import adaptive_avg_pool
from mmfn_tpu_torch.ops.resize import resize_bilinear_align_corners

BASELINES = ("aim", "cilrs", "transfuser")


class AIM(nn.Module):
    """Keys: ``image_encoder.features.*``, ``join.{0,2,4}``, ``decoder``
    (``GRUCell(4, 64)``), ``output``."""

    variant = "aim"

    def __init__(self, config: GlobalConfig):
        super().__init__()
        self.config = config
        self.image_encoder = ImageCNN()
        self.join = join_mlp()
        self.decoder = nn.GRUCell(4, 64)
        self.output = nn.Linear(64, 2)

    def forward(self, batch: Batch) -> torch.Tensor:
        feat = self.image_encoder.features(_nchw(normalize_imagenet(batch.image)))
        return decode_waypoints(self.decoder, self.output, self.join(feat),
                                batch.target_point, self.config.pred_len, "cat")


class CILRSEncoder(nn.Module):
    """Holder that gives the ResNet18 the key ``features``."""

    def __init__(self):
        super().__init__()
        self.features = resnet18(3)


class CILRSController(nn.Module):
    """Keys ``vel_in.{0,2}``, ``vel_out.{0,2,4}``, ``branches.{i}.{0,2,4}``."""

    def __init__(self, num_branch: int = 6, hidden: int = 256, channels: int = 512):
        super().__init__()
        h, c = hidden, channels
        self.vel_in = nn.Sequential(nn.Linear(1, h), nn.ReLU(), nn.Linear(h, c))
        self.vel_out = nn.Sequential(nn.Linear(c, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU(),
                                     nn.Linear(h, 1))
        self.branches = nn.ModuleList(
            nn.Sequential(nn.Linear(c, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU(),
                          nn.Linear(h, 3), nn.Sigmoid())
            for _ in range(num_branch))


class CILRS(nn.Module):
    """``forward(batch, command)`` -> ``(steer, throttle, brake,
    velocity_pred)``, each (B,) but ``velocity_pred`` (B, 1). ``command`` is
    the (B,) integer navigational command, 1-based: branch i serves command
    i + 1, and command 0 selects none (zero control: steer -1, throttle and
    brake 0)."""

    variant = "cilrs"

    def __init__(self, config: GlobalConfig, num_branch: int = 6):
        super().__init__()
        self.config = config
        self.encoder = CILRSEncoder()
        self.controller = CILRSController(num_branch)

    def forward(self, batch: Batch, command: torch.Tensor):
        c = self.encoder.features(_nchw(normalize_imagenet(batch.image)))
        ctl = self.controller
        encoding = c + ctl.vel_in(batch.velocity[:, None].to(c.dtype))
        control = 0.0
        for i, branch in enumerate(ctl.branches):
            control = control + branch(encoding) * (command == i + 1).to(c.dtype)[:, None]
        # the reference's in-place ``encoding += vel_in(...)`` also changes the
        # tensor its velocity head reads, so that head reads the augmented
        # encoding (benchmarks/cilrs/model.py:92-95,104)
        velocity_pred = ctl.vel_out(encoding)
        steer = control[:, 0] * 2.0 - 1.0
        throttle = control[:, 1] * self.config.max_throttle
        return steer, throttle, control[:, 2], velocity_pred


class TransFuserEncoder(nn.Module):
    def __init__(self, config: GlobalConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.image_encoder = ImageCNN()
        self.lidar_encoder = LidarEncoder()
        for i, n_embd in enumerate(STAGE_EMBD):
            self.add_module(f"transformer{i + 1}", FusionTransformer(
                n_embd=n_embd, n_head=cfg.n_head, block_exp=cfg.block_exp,
                n_layer=cfg.n_layer, n_groups=cfg.n_views + 1,
                vert_anchors=cfg.vert_anchors, horz_anchors=cfg.horz_anchors,
                seq_len=cfg.seq_len, embd_pdrop=cfg.embd_pdrop, attn_pdrop=cfg.attn_pdrop,
                resid_pdrop=cfg.resid_pdrop, attn_impl=cfg.attn_impl))

    def forward(self, batch: Batch) -> torch.Tensor:
        cfg = self.config
        anchors = (cfg.vert_anchors, cfg.horz_anchors)
        img_net, lidar_net = self.image_encoder.features, self.lidar_encoder._model
        image_f = img_net.stage(img_net.stem(_nchw(normalize_imagenet(batch.image))), 1)
        lidar_f = lidar_net.stage(lidar_net.stem(_nchw(batch.lidar_bev)), 1)
        for i in range(4):
            fused = getattr(self, f"transformer{i + 1}")(
                [adaptive_avg_pool(image_f, anchors), adaptive_avg_pool(lidar_f, anchors)],
                batch.velocity)
            image_f = image_f + resize_bilinear_align_corners(fused[0], image_f.shape[2:])
            lidar_f = lidar_f + resize_bilinear_align_corners(fused[1], lidar_f.shape[2:])
            if i < 3:
                image_f = img_net.stage(image_f, i + 2)
                lidar_f = lidar_net.stage(lidar_f, i + 2)
        return image_f.mean(dim=(2, 3)) + lidar_f.mean(dim=(2, 3))      # (B, 512)


class TransFuser(nn.Module):
    """Keys: ``encoder.image_encoder.features.*``,
    ``encoder.lidar_encoder._model.*``, ``encoder.transformer{1..4}.*``,
    ``join``, ``decoder`` (``GRUCell(2, 64)``), ``output``."""

    variant = "transfuser"

    def __init__(self, config: GlobalConfig):
        super().__init__()
        self.config = config
        self.encoder = TransFuserEncoder(config)
        self.join = join_mlp()
        self.decoder = nn.GRUCell(2, 64)
        self.output = nn.Linear(64, 2)

    def forward(self, batch: Batch) -> torch.Tensor:
        return decode_waypoints(self.decoder, self.output, self.join(self.encoder(batch)),
                                batch.target_point, self.config.pred_len, "add")


MODELS = {"aim": AIM, "cilrs": CILRS, "transfuser": TransFuser}


def build_baseline(name: str, config: GlobalConfig,
                   generator: Optional[torch.Generator] = None, device=None) -> nn.Module:
    """Baseline ``name`` (one of :data:`BASELINES`) in eval mode on
    ``device``, as ``build_model`` builds an MMFN: the CUDA device when None
    (raises when there is none), ``"cpu"`` on request; weights drawn on the
    CPU from ``generator`` (``torch.Generator().manual_seed(0)`` when None)."""
    if name not in MODELS:
        raise ValueError(f"baseline must be one of {BASELINES}, got {name!r}")
    device = resolve_device(device)
    model = MODELS[name](config)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval()
