"""Render birdview mask/RGB samples for visual comparison with the
reference's carla_birdeye_view output.

The port of the JAX package's ``scripts/render_birdview_samples.py``. Writes
``birdview_{straight,loop,cross}.png`` into ``--out`` (default
``docs/img``): each a side-by-side of the RGB composite and the
ROAD/LANES/CENTERLINES static layers around a pose on (a) a straight
test road, (b) the shipped signalized loop town
(data/maps/fake_town_loop.xodr) and (c) the crossroads town, with vehicles,
a pedestrian, and a red light overlaid. Drawn by ``mapping/birdview.py``
and written by ``data/png.py`` (no cv2).

Usage:
    python -m mmfn_tpu_torch.tools.render_birdview_samples [--out DIR] [--rmap-tool PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# a 500 m one-lane straight road (the JAX package's tests/test_harness.py)
STRAIGHT_XODR = """<?xml version="1.0" standalone="yes"?>
<OpenDRIVE>
  <header revMajor="1" revMinor="4" name="line"/>
  <road name="R0" length="500.0" id="0" junction="-1">
    <planView>
      <geometry s="0.0" x="0.0" y="0.0" hdg="0.0" length="500.0"><line/></geometry>
    </planView>
    <lanes>
      <laneSection s="0.0">
        <center><lane id="0" type="none" level="false"/></center>
        <right>
          <lane id="-1" type="driving" level="false">
            <width sOffset="0.0" a="3.5" b="0.0" c="0.0" d="0.0"/>
          </lane>
        </right>
      </laneSection>
    </lanes>
  </road>
</OpenDRIVE>
"""


def render(xodr: str, pose, out_path: str, tool_path=None) -> np.ndarray:
    """Write one sample panel to ``out_path``; returns the (H, 4 W, 3) RGB panel."""
    from mmfn_tpu_torch.data import png
    from mmfn_tpu_torch.mapping import vectorize_xodr
    from mmfn_tpu_torch.mapping.birdview import BirdViewProducer, CENTERLINES, LANES, ROAD
    from mmfn_tpu_torch.utils.image import gray_to_bgr

    _, producer, _ = vectorize_xodr(xodr, tool_path=tool_path)
    x, y, yaw = pose
    masks = producer.produce(
        [x, y, yaw],
        actors=[(x + 13.0, y, yaw, 4.5, 2.0), (x - 8.0, y - 3.5, yaw, 4.5, 2.0)],
        walkers=[(x + 8.0, y + 4.0, yaw, 0.8, 0.8)],
        lights=[(x + 10.0, y + 2.0, "red")])
    rgb = BirdViewProducer.as_rgb(masks)
    layers = [rgb] + [gray_to_bgr(masks[..., i]) for i in (ROAD, LANES, CENTERLINES)]
    panel = np.concatenate(layers, axis=1)
    png.write(out_path, panel)
    print("wrote", out_path, panel.shape)
    return panel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "img"),
                    help="output directory (default: docs/img)")
    ap.add_argument("--rmap-tool", default=None,
                    help="the map tool (default: native/build/rough_map_node)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    render(STRAIGHT_XODR, (30.0, 1.75, 0.0),
           os.path.join(args.out, "birdview_straight.png"), args.rmap_tool)

    loop_path = os.path.join(ROOT, "data", "maps", "fake_town_loop.xodr")
    if os.path.exists(loop_path):
        with open(loop_path) as f:
            render(f.read(), (30.0, 1.75, 0.0),
                   os.path.join(args.out, "birdview_loop.png"), args.rmap_tool)

    # crossroads town: ego on the west approach looking into the junction
    cross_path = os.path.join(ROOT, "data", "maps", "fake_town_cross.xodr")
    if os.path.exists(cross_path):
        with open(cross_path) as f:
            render(f.read(), (-14.0, 1.75, 0.0),
                   os.path.join(args.out, "birdview_cross.png"), args.rmap_tool)
    return 0


if __name__ == "__main__":
    sys.exit(main())
