"""Export a trained checkpoint as a serving artifact (``torch.export``).

The port of ``scripts/export_model.py``: the inference forward of a phase 2
checkpoint as an ``ExportedProgram`` (``serving/export.py``), batch-polymorphic
unless ``--batch`` fixes it, with the weights in their own file next to it,
``<stem>.vars.pth`` (the parameters and buffers by name, CPU tensors).

The JAX script's ``--platforms`` has no counterpart and is refused: ATen IR
carries no per-backend lowering, and one artifact serves on the CPU and on
the card alike (``serving_call`` moves it to the weights' device). The
export runs on the CUDA device (and raises when there is none) unless
``--cpu`` asks for the CPU.

Usage:
  python -m mmfn_tpu_torch.serving.export_model --logdir runs/rad --variant rad \\
      --out serving/mmfn_rad.pt2 [--cpu]

The serving side needs only:
  exp = mmfn_tpu_torch.serving.load_exported("mmfn_rad.pt2")
  params = torch.load("mmfn_rad.vars.pth")            # to the serving device
  waypoints = mmfn_tpu_torch.serving.serving_call(exp)(params, batch)
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logdir", required=True,
                    help="training logdir holding best_model.pth / model.pth")
    ap.add_argument("--checkpoint", default="best_model.pth",
                    help="checkpoint file inside --logdir")
    ap.add_argument("--variant", default="rad",
                    choices=["img", "vec", "rad", "aim", "cilrs", "transfuser"])
    ap.add_argument("--out", required=True, help="artifact output path")
    ap.add_argument("--platforms", default="",
                    help="not supported: an ExportedProgram has no per-backend lowering")
    ap.add_argument("--batch", type=int, default=0,
                    help="concrete batch size (default 0 = symbolic, one "
                         "artifact for any batch)")
    ap.add_argument("--cpu", action="store_true",
                    help="export on the CPU (device=cpu) instead of the CUDA device")
    ap.add_argument("--n-layer", type=int, default=0,
                    help="override fusion depth (0 = config default); must "
                         "match the checkpoint's architecture")
    ap.add_argument("--max-lanes", type=int, default=0,
                    help="override the static lane pad (0 = config default)")
    ap.add_argument("--resolution", type=int, default=0,
                    help="override the input resolution (0 = config default)")
    args = ap.parse_args(argv)
    if args.platforms:
        ap.error("--platforms: torch.export writes ATen IR, which has no per-backend "
                 "lowering; the one artifact serves on the CPU and on the card")

    import torch

    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.synthetic import synthetic_batch
    from mmfn_tpu_torch.device import resolve_device
    from mmfn_tpu_torch.models.registry import get_entry_point
    from mmfn_tpu_torch.serving import export_forward, save_exported
    from mmfn_tpu_torch.serving.export import model_params
    from mmfn_tpu_torch.utils.weights import load_reference_state_dict, load_torch_state_dict

    device = resolve_device("cpu" if args.cpu else None)
    overrides = {}
    if args.n_layer:
        overrides["n_layer"] = args.n_layer
    if args.max_lanes:
        overrides["max_lanes"] = args.max_lanes
    cfg = GlobalConfig(**overrides)
    entry = args.variant if args.variant in ("aim", "cilrs", "transfuser") \
        else f"mmfn_{args.variant}"
    model = get_entry_point(entry)(cfg, device="cpu")
    ckpt = os.path.join(args.logdir, args.checkpoint)
    load_reference_state_dict(model, load_torch_state_dict(ckpt))
    model = model.to(device).eval()
    # a symbolic batch is traced at 2: a sample of 1 would specialize it
    sample = synthetic_batch(batch_size=args.batch or 2, max_lanes=cfg.max_lanes,
                             device=device,
                             **({"resolution": args.resolution} if args.resolution else {}))
    params = model_params(model)
    exported = export_forward(model, params, sample, symbolic_batch=args.batch == 0)
    save_exported(exported, args.out)

    vars_out = os.path.splitext(args.out)[0] + ".vars.pth"
    torch.save({k: v.detach().cpu() for k, v in params.items()}, vars_out)
    print(f"exported {args.variant} from {ckpt}:")
    print(f"  artifact   {args.out} ({os.path.getsize(args.out)} bytes, "
          f"traced on {device}, "
          f"batch={'symbolic' if args.batch == 0 else args.batch})")
    print(f"  variables  {vars_out} ({os.path.getsize(vars_out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
