"""The port's phase0 CLI on the carla mock.

Installs ``mmfn_tpu_torch.harness.fake_carla`` as ``carla`` with the given
towns registered, then runs ``mmfn_tpu_torch.harness.phase0`` with the
remaining arguments. The mock is a test double of the CARLA API; real
driving needs a CARLA server and the ``carla`` package, with phase0 run
directly.

Usage:
    python -m mmfn_tpu_torch.harness.fake_carla --town TownCross=data/maps/fake_town_cross.xodr \\
        --config run_steps/config/eval.yaml routes=data/routes/cross_straight.xml \\
        simulator=carla agent.type=expert resume=false checkpoint=/tmp/carla.json
"""

from __future__ import annotations

import argparse
import sys

from mmfn_tpu_torch.harness import fake_carla


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--town", action="append", required=True, metavar="NAME=XODR",
                    help="register the OpenDRIVE file XODR as the town NAME (repeatable)")
    args, rest = ap.parse_known_args(argv)
    towns = {}
    for spec in args.town:
        name, _, path = spec.partition("=")
        with open(path) as f:
            towns[name] = f.read()
    fake_carla.install(towns)
    try:
        from mmfn_tpu_torch.harness import phase0

        return phase0.main(rest)
    finally:
        fake_carla.uninstall()


if __name__ == "__main__":
    sys.exit(main())
