"""Fleet evaluation: N routes driven in lockstep, ONE batched forward/tick.

The reference evaluates routes strictly sequentially — one CARLA world, one
agent, one GPU forward per 50 ms tick (leaderboard_evaluator.py:386-411).
A batched forward serves many simulated 20 Hz vehicles at once, so a fleet
of fake-world routes is a serving-scale extension: each route keeps its own
world, criteria, scenario manager, and agent host state, while every live
agent's ``prepare_step`` payload is stacked into a single
``TorchPipeline.dispatch_fleet`` call per tick (one transfer and one
forward for the whole fleet).

Mechanics: each route runs as a ``ClosedLoopRunner.drive`` generator (the
exact scoring loop ``run_route`` uses), so fleet records are identical in
kind to sequential ones. Finished routes free their batch slot; the batch
stays at the fleet's full width with zero-padded slots, so every forward
has one shape.

Agents must expose the ``prepare_step``/``finish_step`` split (the e2e
MMFNAgent) and share one TorchPipeline (same weights — fleet eval of a
single policy). Warm-up ticks (map build, sweep buffer) return their
controls host-side and simply skip the batch.

``pipelined=True`` overlaps host and device work: each tick dispatches the
batch without fetching and steers every vehicle from the PREVIOUS tick's
waypoints (one-tick actuation latency — the fleet analog of the
single-agent ``async_dispatch`` deviation in docs/PARITY.md).

The port's own copy of the JAX package's ``harness/fleet.py``. It fetches a
dispatch with ``HostCopy`` (``harness/agents/pipeline.py``), which the JAX
package's ``np.asarray`` cannot do for a CUDA tensor: the copy to pinned
memory is enqueued right behind the forward and waited for on the same
tick (lockstep) or the next (pipelined), so no fetcher thread is needed. A tick's host writes cannot overrun
the previous tick's transfer either: ``TorchPipeline`` waits for the copy
out of its pinned staging buffer before it writes the buffer again.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from mmfn_tpu_torch.harness.agents.pipeline import HostCopy
from mmfn_tpu_torch.harness.replay import ClosedLoopRunner, _AgentCrash
from mmfn_tpu_torch.harness.statistics import RouteRecord, StatisticsManager


class FleetRunner:
    """Drives N (agent, route) pairs in lockstep and scores each route.

    ``routes`` entries are dicts of :meth:`ClosedLoopRunner.drive` keyword
    arguments: ``config`` and ``opendrive_str`` required, plus any of
    ``max_ticks / triggers / rough_map / signals / world_kwargs``.
    """

    def __init__(self, statistics: Optional[StatisticsManager] = None,
                 max_wall_seconds: float = 600.0, pipelined: bool = False,
                 prep_workers: Optional[int] = None):
        self.statistics = statistics or StatisticsManager()
        self.max_wall_seconds = max_wall_seconds
        # pipelined: steer every vehicle from the PREVIOUS tick's batched
        # forward while this tick's is in flight — the fleet analog of the
        # single-agent async_dispatch (one-tick actuation latency; the
        # deliberate deviation documented in docs/PARITY.md). The first
        # forward tick (and any agent whose warmup ends later) primes
        # synchronously.
        self.pipelined = pipelined
        # per-vehicle host prep (sensor mux + crops + radar fit + SAT lane
        # crop) is ~1 ms of mostly GIL-releasing numpy per agent: serial it
        # caps the fleet at ~1000/N ticks/s regardless of the chip, so fan it
        # over a thread pool (0/None on a 1-core host degrades to serial).
        # The pool is created per run() and shut down in its finally — a
        # long eval constructs many FleetRunners and a pool per instance
        # would leak its idle workers for the life of the process.
        self._prep_workers = (prep_workers if prep_workers is not None
                              else min(8, os.cpu_count() or 1))
        self._pool = None

    def run(self, agents: list, routes: List[dict]) -> List[RouteRecord]:
        if self._prep_workers > 1:
            self._pool = ThreadPoolExecutor(self._prep_workers)
        try:
            return self._run(agents, routes)
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None

    def _run(self, agents: list, routes: List[dict]) -> List[RouteRecord]:
        if len(agents) != len(routes):
            raise ValueError("need one agent per route")
        n = len(agents)
        pipeline = agents[0].pipeline
        for a in agents:
            if a.pipeline is not pipeline:
                raise ValueError("fleet agents must share one TorchPipeline "
                                 "(one policy, one batched forward)")

        runner = ClosedLoopRunner(self.statistics,
                                  max_wall_seconds=self.max_wall_seconds)
        gens = []
        records: List[Optional[RouteRecord]] = [None] * n
        game_time = [0.0] * n
        live = set()
        for i, (agent, route) in enumerate(zip(agents, routes)):
            gen = runner.drive(agent, **route)
            gens.append(gen)
            try:
                game_time[i] = next(gen)
                live.add(i)
            except StopIteration as stop:  # zero-tick route
                records[i] = stop.value

        template = None      # zero payload filling freed batch slots
        pending = None   # pipelined: (un-fetched dispatch, {agent: row},
                         #             {agent: payload})
        while live:
            # (per-route wall timeouts are enforced inside each drive())
            controls = {}
            forwards = []    # (agent index, payload)

            def prep(i):
                agent = agents[i]
                return agent.prepare_step(agent.sensor_interface.get_data())

            order = sorted(live)
            if self._pool is not None and len(order) > 1:
                results = [(i, self._pool.submit(prep, i)) for i in order]
            else:
                results = [(i, None) for i in order]
            for i, fut in results:
                try:
                    kind, payload = fut.result() if fut is not None else prep(i)
                except Exception as e:      # agent crash -> scored failure
                    self._finish(gens[i], i, e, records, live)
                    continue
                if kind == "control":
                    controls[i] = payload
                else:
                    forwards.append((i, payload))

            if forwards:
                if template is None:
                    template = _zero_like_payload(forwards[0][1])
                batch = [p for _, p in forwards]
                batch += [template] * (n - len(batch))
                # the copy to the host is enqueued right behind the forward;
                # it runs while the world ticks and the next tick's prep run
                fut = HostCopy(pipeline.dispatch_fleet(batch))
                row_of = {i: r for r, (i, _) in enumerate(forwards)}
                pay_of = dict(forwards)
                if not self.pipelined or pending is None \
                        or any(i not in pending[1] for i in row_of):
                    # synchronous (or priming) fetch of THIS tick's result
                    wps = fut.result()
                    use = {i: (pay_of[i], wps[r]) for i, r in row_of.items()}
                else:
                    # previous tick's result finished while this tick's host
                    # work ran; this tick's dispatch is now in flight. Steer
                    # from the previous waypoints PAIRED with the payload of
                    # the tick whose sensors produced them (finish_step's
                    # contract — same pairing as single-agent async_dispatch)
                    prev_fut, prev_rows, prev_pays = pending
                    prev_wps = prev_fut.result()   # copied behind its forward
                    use = {i: (prev_pays[i], prev_wps[prev_rows[i]])
                           for i in row_of}
                pending = (fut, row_of, pay_of) if self.pipelined else None
                for i in sorted(row_of):
                    agent = agents[i]
                    try:
                        controls[i] = agent.finish_step(*use[i])
                    except Exception as e:
                        self._finish(gens[i], i, e, records, live)

            for i in sorted(set(controls) & live):
                try:
                    game_time[i] = gens[i].send(controls[i])
                except StopIteration as stop:
                    records[i] = stop.value
                    live.discard(i)
        return records

    @staticmethod
    def _finish(gen, i, exc, records, live):
        try:
            gen.throw(_AgentCrash(exc))
        except StopIteration as stop:
            records[i] = stop.value
        live.discard(i)


def _zero_like_payload(payload: dict) -> dict:
    def z(x):
        if x is None or isinstance(x, (bool, str)):
            return x        # flags (e.g. 'compact') pass through verbatim
        return np.zeros_like(np.asarray(x))

    out = {k: z(v) for k, v in payload.items()}
    out["speed"] = 0.0
    # one zero lane, not zero lanes: the masked lane attention expects >= 1
    # valid token (the reference's empty-crop fallback, mmfn_vectornet.py:179)
    out["lane_num"] = 1 if payload.get("lane_num") is not None else None
    return out
