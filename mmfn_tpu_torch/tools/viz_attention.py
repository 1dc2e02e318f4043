"""Render fusion-attention heatmaps for an MMFN variant.

The port of the JAX package's ``scripts/viz_attention.py`` (after the
reference's TransFuser attention-viz tooling,
team_code/benchmarks/transfuser/{model_viz.py,viz.py}): runs one forward
pass with attention capture (``utils/introspection.py``, on the plain
attention path: the fused kernel forms no maps) and writes, per fusion
stage, (a) the full token-to-token attention matrix and (b) cross-modality
8x8 spatial maps (e.g. how image tokens attend over the LiDAR BEV grid)
upsampled and overlaid on the input. Drawn with ``utils/image.py`` and
written with ``data/png.py`` (no cv2). The model runs on the CUDA device
unless ``--device cpu``.

Usage:
    python -m mmfn_tpu_torch.tools.viz_attention --variant rad --out /tmp/att \\
        [--checkpoint <logdir>/best_model.pth] [--seed N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

MODALITY_NAMES = {
    "img": ("image", "map", "lidar"),
    "vec": ("image", "vectormap", "lidar"),
    "rad": ("image", "vectormap", "lidar", "radar"),
}


def overlay(base_hw3: np.ndarray, heat: np.ndarray) -> np.ndarray:
    from mmfn_tpu_torch.utils.image import (COLORMAP_JET, INTER_LINEAR, add_weighted,
                                            apply_color_map, resize)

    h, w = base_hw3.shape[:2]
    heat = resize(heat.astype(np.float32), (w, h), interpolation=INTER_LINEAR)
    heat = (255 * (heat - heat.min()) / (np.ptp(heat) + 1e-9)).astype(np.uint8)
    heat = apply_color_map(heat, COLORMAP_JET)
    return add_weighted(base_hw3.astype(np.uint8), 0.5, heat, 0.5, 0)


def render(maps: dict, image: np.ndarray, variant: str, out: str) -> list:
    """Write the heatmaps of ``maps`` (module path -> (B, H, T, T)) over
    ``image`` (the input camera, (H, W, 3)) into ``out``; returns the paths.
    Images are composed in cv2's BGR order and written as the JAX script's
    ``cv2.imwrite`` writes them."""
    from mmfn_tpu_torch.data import png
    from mmfn_tpu_torch.utils.image import (COLORMAP_VIRIDIS, INTER_NEAREST, apply_color_map,
                                            resize)
    from mmfn_tpu_torch.utils.introspection import token_attention_image

    def write_bgr(path, bgr):
        png.write(path, np.ascontiguousarray(bgr[..., ::-1]))
        written.append(path)

    os.makedirs(out, exist_ok=True)
    names = MODALITY_NAMES[variant]
    image = (255 * (image - image.min()) / (np.ptp(image) + 1e-9)).astype(np.uint8)
    written = []
    for path, att in sorted(maps.items()):
        stage = path.replace("/", "_")
        full = att.mean(axis=(0, 1))
        full_img = (255 * full / (full.max() + 1e-9)).astype(np.uint8)
        write_bgr(os.path.join(out, f"{stage}_tokens.png"), apply_color_map(
            resize(full_img, (512, 512), interpolation=INTER_NEAREST), COLORMAP_VIRIDIS))
        n_groups = att.shape[-1] // 64
        for qg in range(min(n_groups, len(names))):
            for kg in range(min(n_groups, len(names))):
                if qg == kg:
                    continue
                heat = token_attention_image(att, qg, kg)
                write_bgr(os.path.join(out, f"{stage}_{names[qg]}_to_{names[kg]}.png"),
                          overlay(image, heat))
    return written


def main(argv=None, config=None) -> int:
    """``config``: the model's ``GlobalConfig`` (default: the full-width
    defaults, as the JAX script uses)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="rad", choices=("img", "vec", "rad"))
    ap.add_argument("--out", default="/tmp/mmfn_attention")
    ap.add_argument("--checkpoint", default=None,
                    help="the port's best_model.pth (default: random init)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default: the CUDA device")
    args = ap.parse_args(argv)

    import torch

    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.synthetic import synthetic_batch
    from mmfn_tpu_torch.device import resolve_device
    from mmfn_tpu_torch.models import build_model
    from mmfn_tpu_torch.utils.introspection import attention_weights, forward_with_intermediates
    from mmfn_tpu_torch.utils.weights import load_reference_state_dict, load_torch_state_dict

    cfg = config or GlobalConfig()
    device = resolve_device(args.device)
    model = build_model(cfg, args.variant, torch.Generator().manual_seed(0), device="cpu")
    if args.checkpoint:
        load_reference_state_dict(model, load_torch_state_dict(args.checkpoint))
    model = model.to(device).eval()
    batch = synthetic_batch(batch_size=1, max_lanes=cfg.max_lanes, seed=args.seed,
                            resolution=cfg.input_resolution, device=device)

    def keep(module, name):
        return type(module).__name__ == "SelfAttention"

    _, inter = forward_with_intermediates(model, batch, filter_fn=keep)
    maps = attention_weights(inter)
    if not maps:
        print("no attention maps captured", file=sys.stderr)
        return 1

    written = render(maps, batch.image[0].cpu().numpy(), args.variant, args.out)
    print(f"wrote {len(written)} heatmaps to {args.out} "
          f"({len(maps)} attention layers captured)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
