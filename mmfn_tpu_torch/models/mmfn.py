"""The MMFN model family: one module, three variants.

- ``img``: image + LiDAR BEV + rasterized-map streams, each a ResNet, fused
  by 4 interleaved transformers.
- ``vec``: the map stream is seeded by a VectorNet lane encoder at
  (64, 64, 64) and runs the map ResNet's layer2-4 only.
- ``rad``: ``vec`` plus a radar GAT stream joining at the 4th fusion stage,
  which then fuses 4 token groups (T = 256).

Forward contract: Batch (NHWC images and BEV) -> (B, pred_len, 2) waypoints.
Stream order inside each fusion call is [image, lidar, map(, radar)]. Kept
on purpose from the reference: camera pixels are raw 0-255 through the
ImageNet affine, the map image is not normalized, and the fused feature is
the SUM of the per-modality 512-d means. Parameter names are the reference
checkpoint's keys.
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
from mmfn_tpu_torch.models.gat import RadarGAT
from mmfn_tpu_torch.models.gpt import FusionTransformer
from mmfn_tpu_torch.models.resnet import resnet18, resnet34
from mmfn_tpu_torch.models.vectornet import VectornetEncoder
from mmfn_tpu_torch.ops.image import normalize_imagenet
from mmfn_tpu_torch.ops.pool import adaptive_avg_pool
from mmfn_tpu_torch.ops.resize import resize_bilinear_align_corners

VARIANTS = ("img", "vec", "rad")
STAGE_EMBD = (64, 128, 256, 512)


class ImageCNN(nn.Module):
    """Holder that gives the camera and map ResNets the key ``features``."""

    def __init__(self, first_stage: int = 1):
        super().__init__()
        self.features = resnet34(3, first_stage)


class LidarEncoder(nn.Module):
    """Holder that gives the 2-channel BEV ResNet18 the key ``_model``."""

    def __init__(self):
        super().__init__()
        self._model = resnet18(2)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class MMFNEncoder(nn.Module):
    def __init__(self, config: GlobalConfig, variant: str):
        super().__init__()
        cfg = config
        self.config, self.variant = cfg, variant
        self.image_encoder = ImageCNN()
        # vec/rad seed the map stream at layer2: no stem or layer1 there
        self.img_map_encoder = ImageCNN(first_stage=1 if variant == "img" else 2)
        self.lidar_encoder = LidarEncoder()
        if variant in ("vec", "rad"):
            self.vectornet_encoder = VectornetEncoder()
        if variant == "rad":
            self.radar_encoder = RadarGAT(nfeat=cfg.radar_features, nhid=cfg.gat_hidden,
                                          dropout=cfg.attn_pdrop, alpha=cfg.gat_alpha,
                                          nheads=cfg.gat_heads)
        for i, n_embd in enumerate(STAGE_EMBD):
            n_groups = cfg.n_views + (3 if i == 3 and variant == "rad" else 2)
            self.add_module(f"transformer{i + 1}", FusionTransformer(
                n_embd=n_embd, n_head=cfg.n_head, block_exp=cfg.block_exp,
                n_layer=cfg.n_layer, n_groups=n_groups, vert_anchors=cfg.vert_anchors,
                horz_anchors=cfg.horz_anchors, seq_len=cfg.seq_len,
                embd_pdrop=cfg.embd_pdrop, attn_pdrop=cfg.attn_pdrop,
                resid_pdrop=cfg.resid_pdrop, attn_impl=cfg.attn_impl))

    def forward(self, batch: Batch) -> torch.Tensor:
        cfg = self.config
        anchors = (cfg.vert_anchors, cfg.horz_anchors)
        rad = self.variant == "rad"
        img_net = self.image_encoder.features
        map_net = self.img_map_encoder.features
        lidar_net = self.lidar_encoder._model

        image_f = img_net.stage(img_net.stem(_nchw(normalize_imagenet(batch.image))), 1)
        lidar_f = lidar_net.stage(lidar_net.stem(_nchw(batch.lidar_bev)), 1)
        if self.variant == "img":
            map_f = map_net.stage(map_net.stem(_nchw(batch.map_img)), 1)
        else:
            map_f = self.vectornet_encoder(batch.lanes, batch.lane_num)

        radar_f = None
        for i in range(4):
            grids = [adaptive_avg_pool(f, anchors) for f in (image_f, lidar_f, map_f)]
            if i == 3 and rad:
                radar_f = self.radar_encoder(batch.radar, batch.radar_adj)   # (B, 512, 8, 8)
                grids.append(radar_f)
            fused = getattr(self, f"transformer{i + 1}")(grids, batch.velocity)
            # each fused 8x8 grid goes back to its own stream's resolution
            image_f = image_f + resize_bilinear_align_corners(fused[0], image_f.shape[2:])
            lidar_f = lidar_f + resize_bilinear_align_corners(fused[1], lidar_f.shape[2:])
            map_f = map_f + resize_bilinear_align_corners(fused[2], map_f.shape[2:])
            if i == 3 and rad:
                radar_f = radar_f + fused[3]
            if i < 3:
                image_f = img_net.stage(image_f, i + 2)
                map_f = map_net.stage(map_f, i + 2)
                lidar_f = lidar_net.stage(lidar_f, i + 2)

        fused = image_f.mean(dim=(2, 3)) + lidar_f.mean(dim=(2, 3)) + map_f.mean(dim=(2, 3))
        if rad:
            fused = fused + radar_f.mean(dim=(2, 3))
        return fused                                                    # (B, 512)


class MMFN(nn.Module):
    """Encoder + join MLP + autoregressive GRU waypoint decoder."""

    def __init__(self, config: GlobalConfig, variant: str = "vec"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        self.config, self.variant = config, variant
        self.encoder = MMFNEncoder(config, variant)
        self.join = join_mlp()
        self.decoder = nn.GRUCell(2, 64)
        self.output = nn.Linear(64, 2)

    def forward(self, batch: Batch) -> torch.Tensor:
        z = self.join(self.encoder(batch))
        return decode_waypoints(self.decoder, self.output, z, batch.target_point,
                                self.config.pred_len)


def build_model(config: GlobalConfig, variant: str = "vec",
                generator: Optional[torch.Generator] = None, device=None) -> MMFN:
    """An MMFN in eval mode on ``device``: the CUDA device when None (raises
    when there is none), ``"cpu"`` on request. Its weights are drawn on the
    CPU from ``generator`` (``torch.Generator().manual_seed(0)`` when None),
    so they are the same on every device."""
    device = resolve_device(device)
    model = MMFN(config, variant)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval()
