"""Scored multi-route benchmark: agents under scenarios + background traffic.

The port of ``run_steps/benchmark_run.py``. The reference never evaluates on
a bare road: RouteScenario spawns 120-300 background vehicles per town
(route_scenario.py:444-475) and samples adversarial sub-scenarios along the
route from leaderboard/data/all_towns_traffic_scenarios.json
(route_scenario.py:356-440), then scores through the criteria tree +
StatisticsManager. This runner runs the repo's analog of that standing
benchmark: every agent x town x weather leg is an evaluation by the port's
phase0 CLI (``python -m mmfn_tpu_torch.harness.phase0``) in its own process,
with ``scenarios=data/scenarios/fake_towns_scenarios.json`` and ambient NPC
traffic, and the per-leg checkpoint JSONs aggregate into one driving-score
table (statistics_manager.py:208-250 semantics per leg), written to
``<out>/TABLE.md`` as the JAX script writes it.

Usage:
    python -m mmfn_tpu_torch.harness.benchmark_run \\
        [--agents vec,rad,img,aim] [--weathers ClearNoon,HardRainNoon] \\
        [--traffic 24] [--out results/benchmark] [--model-root log] \\
        [--max-wall 900] [--aggregate-only] [--jobs 1] [--device cpu]

Each agent's checkpoint is expected at ``<model-root>/mmfn_<variant>/
best_model.pth`` (a baseline's at ``<model-root>/<name>/best_model.pth``),
the port's phase 2 layout; an agent with no checkpoint runs at random init
(phase0 says so in the leg's log). Legs run with resume, so an interrupted
benchmark continues where it stopped, and a complete leg is not run again.
The model legs serve with phase0's defaults (plain attention, ``host_bev``
off), so each forward tick launches the BEV kernel once. ``--jobs`` runs
that many legs at once, each its own process (and, on the card, its own
CUDA context). One flag the JAX script lacks: ``--device cpu`` passes
``device=cpu`` to every leg; without it the model legs run on the card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (town, map xodr, routes xml) legs of the benchmark
LEGS = [
    ("TownCross", "data/maps/fake_town_cross.xodr",
     "data/routes/benchmark_cross.xml"),
    ("TownLoop", "data/maps/fake_town_loop.xodr",
     "data/routes/fake_loop.xml"),
]
SCENARIOS = "data/scenarios/fake_towns_scenarios.json"


def agent_overrides(name: str, model_root: str):
    """phase0 override list + checkpoint dir for one benchmark agent."""
    if name == "expert":
        # rule-based MMFNPilot reference row (no checkpoint): shows the
        # criteria tree firing under load independent of any training run
        return ["agent.type=expert"], None
    if name in ("aim", "cilrs", "transfuser"):
        path = os.path.join(model_root, name)
        return [f"agent.type={name}", f"agent.model_path={path}"], path
    path = os.path.join(model_root, f"mmfn_{name}")
    return [f"agent.variant={name}", f"agent.model_path={path}"], path


def leg_command(agent: str, map_path: str, routes: str, weather: str, endpoint: str,
                args) -> list:
    """The phase0 command line of one leg."""
    overrides, _ = agent_overrides(agent, args.model_root)
    device = [f"device={args.device}"] if args.device else []
    return [sys.executable, "-m", "mmfn_tpu_torch.harness.phase0",
            "--config", os.path.join(REPO, "run_steps/config/eval.yaml"),
            f"routes={routes}", f"map={map_path}", f"scenarios={SCENARIOS}",
            f"background_traffic={args.traffic}", f"weather={weather}",
            f"checkpoint={endpoint}", "resume=true",
            f"max_wall_seconds={args.max_wall}", *device, *overrides]


def run_leg(agent: str, town: str, map_path: str, routes: str, weather: str,
            args) -> str:
    endpoint = os.path.join(args.out, f"{agent}_{town}_{weather}.json")
    cmd = leg_command(agent, map_path, routes, weather, endpoint, args)
    done = _leg_progress(endpoint)
    if done is not None and done[0] >= done[1]:
        print(f"[benchmark] {agent} {town} {weather}: already complete")
        return endpoint
    print(f"[benchmark] {agent} {town} {weather}: running "
          f"({' '.join(cmd[3:])})", flush=True)
    t0 = time.time()
    # per-leg output to a sidecar log so concurrent legs don't interleave
    with open(endpoint.replace(".json", ".log"), "w") as logf:
        r = subprocess.run(cmd, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)
    print(f"[benchmark] {agent} {town} {weather}: exit {r.returncode} "
          f"[{time.time() - t0:.0f}s]", flush=True)
    if r.returncode != 0:
        raise RuntimeError(f"benchmark leg failed: {agent} {town} {weather}")
    return endpoint


def _leg_progress(endpoint):
    try:
        with open(endpoint) as f:
            p = json.load(f)["_checkpoint"]["progress"]
        return (p[0], p[1]) if len(p) == 2 else None
    except (OSError, ValueError, KeyError, TypeError):
        return None


def aggregate(paths_by_key: dict) -> str:
    """One markdown table over all legs: driving score / completion /
    infractions-per-km from each leg's global record."""
    rows = []
    for (agent, town, weather), endpoint in sorted(paths_by_key.items()):
        try:
            with open(endpoint) as f:
                g = json.load(f)["_checkpoint"]["global_record"]
        except (OSError, ValueError, KeyError, TypeError):
            rows.append((agent, town, weather, None))
            continue
        rows.append((agent, town, weather, g))

    def infr_per_km(g):
        i = g["infractions"]
        return (sum(i[k] for k in ("collisions_pedestrian",
                                   "collisions_vehicle", "collisions_layout"))
                , i["red_light"] + i["stop_infraction"])

    lines = [
        "| agent | town | weather | driving score | route completion % | "
        "collisions/km | light+stop/km | blocked/timeouts |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for agent, town, weather, g in rows:
        if g is None or "scores" not in g:
            lines.append(f"| {agent} | {town} | {weather} | _no data_ | | | | |")
            continue
        coll, lights = infr_per_km(g)
        blocked = (g["infractions"]["vehicle_blocked"]
                   + g["infractions"]["route_timeout"])
        lines.append(
            f"| {agent} | {town} | {weather} "
            f"| {g['scores']['score_composed']:.1f} "
            f"| {g['scores']['score_route']:.1f} "
            f"| {coll:.2f} | {lights:.2f} | {blocked:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", default="vec,rad,img,aim")
    ap.add_argument("--weathers", default="ClearNoon,HardRainNoon")
    ap.add_argument("--traffic", type=int, default=24)
    ap.add_argument("--out", default="results/benchmark")
    ap.add_argument("--model-root", default="log")
    ap.add_argument("--max-wall", type=float, default=900.0)
    ap.add_argument("--aggregate-only", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="concurrent legs, each its own phase0 process")
    ap.add_argument("--device", default=None,
                    help="passed to every leg as device=<device> (cpu: no card); "
                         "default: the CUDA device")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    agents = [a for a in args.agents.split(",") if a]
    weathers = [w for w in args.weathers.split(",") if w]
    specs = [(agent, town, map_path, routes, weather)
             for agent in agents
             for town, map_path, routes in LEGS
             for weather in weathers]
    paths = {(a, t, w): os.path.join(args.out, f"{a}_{t}_{w}.json")
             for a, t, _, _, w in specs}
    if not args.aggregate_only:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
            futs = {pool.submit(run_leg, a, t, m, r, w, args): (a, t, w)
                    for a, t, m, r, w in specs}
            failed = [k for f, k in futs.items()
                      if f.exception() is not None]
        if failed:
            raise SystemExit(f"benchmark legs failed: {failed}")

    table = aggregate(paths)
    out_md = os.path.join(args.out, "TABLE.md")
    with open(out_md, "w") as f:
        f.write("# Benchmark: driving scores under scenarios + traffic\n\n"
                + table + "\n")
    print(table)
    print(f"[benchmark] table written to {out_md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
