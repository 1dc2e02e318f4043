"""OpenSCENARIO (.xosc) subset for the simulator-free harness.

The reference vendors scenario_runner's full OpenSCENARIO engine
(srunner/tools/openscenario_parser.py, srunner/scenarios/open_scenario.py,
srunner/scenarioconfigs/openscenario_configuration.py) although no mmfn entry
point reaches it (routes are XML waypoints + JSON placements). This module
closes that inventory row natively: it parses the constructs srunner's own
example scenarios exercise and runs them in the KinematicWorld through
``OpenScenarioManager``, which is interface-compatible with
``ScenarioManagerLite`` (``ClosedLoopRunner.run_route(scenario_manager=...)``).

Supported subset (OpenSCENARIO 1.0):

- ``ParameterDeclarations`` with ``$name`` substitution and OpenSCENARIO 1.1
  ``${...}`` arithmetic expressions over parameters (spec 10.8);
- ``CatalogLocations``/``CatalogReference`` for Vehicle/Pedestrian entries
  (directory scan of ``*.xosc`` catalogs, ``ParameterAssignments`` honored);
- ``Entities``: ``Vehicle`` (car/bicycle) and ``Pedestrian`` scenario objects,
  the ego identified by the ``type: ego_vehicle`` property or the name
  ``hero``/``ego_vehicle`` (openscenario_configuration.py semantics);
- ``Storyboard/Init``: per-entity ``TeleportAction`` (``WorldPosition`` or
  ``RelativeWorldPosition``), initial ``SpeedAction``, and the
  ``EnvironmentAction`` weather (mapped onto the expert's WEATHERS presets);
- ``Story/Act/ManeuverGroup/Maneuver/Event`` with start triggers covering
  ALL OpenSCENARIO 1.0 ByEntityCondition kinds —
  ``SimulationTimeCondition``, ``RelativeDistanceCondition``,
  ``TraveledDistanceCondition``, ``ReachPositionCondition``,
  ``StandStillCondition``, ``DistanceCondition`` (incl. ``alongRoute``),
  ``TimeToCollisionCondition``, ``TimeHeadwayCondition``,
  ``SpeedCondition``, ``AccelerationCondition``,
  ``RelativeSpeedCondition``, ``CollisionCondition`` (OBB contact, the
  kinematic analog of CARLA's collision sensor),
  ``OffroadCondition``/``EndOfRoadCondition`` (continuous-duration
  membership tests against the rmap lane ribbon / route end) —
  plus the ByValueCondition kinds ``SimulationTimeCondition``,
  ``TrafficSignalCondition``, ``TimeOfDayCondition``,
  ``ParameterCondition`` (folded to a constant at parse time — parameters
  are static in this engine) and ``StoryboardElementStateCondition``
  (start/stop/end transitions + completeState like srunner's
  OSCStartEndCondition, openscenario_parser.py:850-861, plus
  ``runningState``; maneuver CatalogReferences in a ManeuverGroup resolve
  through the same catalog machinery) — the only ByValue kinds outside the
  subset are ``UserDefinedValueCondition`` and
  ``TrafficSignalControllerCondition``, which the reference also refuses
  (ibid.:862-879) — and actions ``SpeedAction`` (absolute/relative
  target, step or linear-rate dynamics), ``LaneChangeAction`` (relative
  target lane, mapped to a 3.5 m/lane lateral shift), ``TeleportAction`` and
  ``AcquirePositionAction`` (re-aim at a world position);
- ``ControllerAction/AssignControllerAction`` (Init or story events): the
  ``module`` Property selects a controller from
  ``harness.actor_controls.CONTROL_REGISTRY`` — the same module names
  srunner resolves (openscenario_parser.py:get_controller:340-376), incl.
  via a Controller catalog; ``OverrideControllerValueAction`` is another
  EXTENSION (the reference raises on any active override, ibid.:371-374):
  Throttle/Brake/ParkingBrake/SteeringWheel preempt the controller with
  the ego's kinematic pedal model (Clutch/Gear ignored — no kinematic
  meaning); an inactive override (``active="false"``) releases it;
- ``ActivateControllerAction`` (autopilot on -> ``npc_vehicle_control``,
  off -> release + coast to stop; reference maps it to ChangeAutoPilot,
  openscenario_parser.py:1025-1028);
- ``RoutingAction/AssignRouteAction`` with an inline ``Route`` or a Route
  ``CatalogReference`` (waypoint list fed to the actor's controller —
  ChangeActorWaypoints semantics, openscenario_parser.py:1037-1042);
- ``RoutingAction/FollowTrajectoryAction`` with any OSC shape — Polyline,
  Clothoid, or Nurbs (inline ``Trajectory`` or a Trajectory
  ``CatalogReference``) — an EXTENSION beyond the reference, which raises
  NotImplementedError on it (openscenario_parser.py:1043-1044): a
  ``TimeReference/Timing`` replays the vertex schedule exactly
  (scale/offset honored); ``TimeReference`` ``None`` (or untimed vertices)
  degrades to waypoint following through the actor's controller at its
  current target speed; Clothoids integrate the analytic spiral heading
  and time along ``startTime``/``stopTime``; Nurbs evaluate the rational
  Cox-de Boor curve with control-point weights and times;
- ``SynchronizeAction`` — also an EXTENSION beyond the reference (which
  raises, openscenario_parser.py:1023-1024): the actor continuously
  retargets its speed so it reaches ``TargetPosition`` at the same moment
  the master entity reaches ``TargetPositionMaster`` (OSC spec 3.87),
  then adopts ``FinalSpeed`` (absolute or relative-to-master);
- ``Storyboard/StopTrigger``: ``SimulationTimeCondition`` and
  ``TraveledDistanceCondition`` end the episode; srunner's ``criteria_*``
  stop-trigger conditions are parsed and reported (the harness scores the
  same criteria natively through ``harness.criteria``);
- ``Act/StopTrigger``: once the act has started, a holding stop trigger
  cancels it — in-flight transitional actions halt where they are (speed
  pursuit freezes, lane shifts stop, timed trajectories release, syncs
  detach) and the act's remaining events stay gated (srunner terminates
  the act's parallel composite the same way, open_scenario.py:364-370);
- ``ManeuverGroup maximumExecutionCount``: the group's events re-fire once
  per iteration, a new iteration starting only after every event of the
  group fired and completed in the current one (srunner repeats the group
  subtree in sequence, open_scenario.py:271; a never-firing event stalls
  the group in both engines).

- ``VisibilityAction`` — another EXTENSION beyond the reference (which
  raises, openscenario_parser.py:1021-1022), with CARLA actor-visibility
  semantics: ``sensors=false`` removes the actor from the ego's lidar/radar
  synthesis, ``graphics=false`` from the camera/birdview render,
  ``traffic=false`` from other participants' obstacle awareness; physics
  (and thus collision scoring) always stays on.

Expressions cover the full OSC 1.1 spec 10.8 surface: arithmetic
operators plus the five defined functions (round/floor/ceil/sqrt/pow,
round-half-up); anything else in an expression is a hard parse error.

Positions: ``WorldPosition``, ``RelativeWorldPosition``,
``RelativeObjectPosition``, and — when ``parse_xosc(..., rough_map=...)``
is given a vectorized map — ``LanePosition`` / ``RelativeLanePosition``
(roadId/laneId/s/offset resolved through the native vectorizer's rmap v3
id/arclength columns, with relative or absolute ``Orientation``) plus
``RoadPosition`` / ``RelativeRoadPosition`` (road (s, t) against the
reference line reconstructed from the innermost lane's centerline + width
columns). That is every position kind the reference converts
(srunner/tools/openscenario_parser.py:548-550, via the CARLA map API).

Conventions: positions are CARLA world frame like the rest of the harness
(x east, y south in CARLA's left-handed frame — whatever the .xodr uses);
``h`` headings are radians; positive relative lane values shift left
(+90° from heading), matching OpenDRIVE lane ordering.

The port's own copy of the JAX package's ``harness/openscenario.py``: the
same parse, the same storyboard ticks and the same warnings, so a ``.xosc``
episode runs in the port as it runs there.
"""

from __future__ import annotations

import ast
import copy
import math
import os
import re
import warnings
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmfn_tpu_torch.harness.actor_controls import (BasicControl, Obstacle,
                                             make_controller)
from mmfn_tpu_torch.harness.scenarios import (ScenarioActor, actors_collide,
                                        check_collision)
from mmfn_tpu_torch.harness.weather import preset_family

LANE_WIDTH = 3.5


class UnsupportedOsc(UserWarning):
    """An OpenSCENARIO construct outside the engine's subset was parsed as
    never-holding. Filterable: ``warnings.filterwarnings('error',
    category=UnsupportedOsc)`` turns silent scenario truncation into a
    parse failure."""


# --------------------------------------------------------------------------- #
# parsed representation
# --------------------------------------------------------------------------- #

@dataclass
class EntitySpec:
    name: str
    kind: str = "vehicle"            # 'vehicle' | 'walker'
    model: str = ""
    is_hero: bool = False
    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0
    speed: float = 0.0
    extent: float = 2.2              # walker 0.5, bicycle 1.0, car 2.2
    # controller / route actions assigned in Storyboard/Init, applied at
    # actor construction (reference: init private actions are converted to
    # behaviours that run before the story — openscenario_parser.py)
    init_actions: List["XoscAction"] = field(default_factory=list)


@dataclass
class XoscCondition:
    # 'time' | 'reldist' | 'traveled' | 'reach' | 'standstill' | 'distance'
    # | 'ttc' | 'headway' | 'speed' | 'signal' | 'timeofday' | 'accel'
    # | 'relspeed' | 'parameter' | 'element_state' | 'unsupported'
    # ('parameter' is a ParameterCondition folded to a constant at parse
    # time — parameters are static in this engine; 'element_state' is a
    # StoryboardElementStateCondition: entity = storyboardElementRef,
    # rule = storyboardElementType, state = 'start'|'end'|'running')
    # ('unsupported' records a construct outside the subset; it never holds,
    # so a gated event stays gated instead of firing on the first tick — and
    # the parser warns loudly, once per construct kind, because a silently
    # never-holding condition means the scenario "passes" while never
    # exercising its maneuver)
    kind: str
    value: float = 0.0
    rule: str = "greaterThan"
    entity: str = ""                 # referenced entity (reldist/ttc/headway
    #                                  target; signal name for 'signal')
    triggering: Tuple[str, ...] = () # TriggeringEntities refs
    x: float = 0.0
    y: float = 0.0
    tolerance: float = 3.0
    name: str = ""
    along_route: bool = False        # 'distance': measure along the ego route
    #                                  (srunner InTriggerDistanceToLocationAlongRoute)
    state: str = ""                  # 'signal': required light state


@dataclass
class XoscAction:
    # 'speed' | 'lane_change' | 'teleport' | 'acquire' | 'controller'
    # | 'activate' | 'route' | 'trajectory' | 'sync' | 'visibility'
    # | 'weather' | 'signal_state' (story-level GlobalActions applied by the
    # manager to the world services, not to a scripted actor)
    kind: str
    state: str = ""                  # 'signal_state': forced light state
    target_speed: Optional[float] = None
    relative_to: str = ""            # entity name for relative target speed
    speed_delta: float = 0.0
    rate: Optional[float] = None     # m/s^2 for linear dynamics; None = step
    lane_offset: float = 0.0         # meters, +left
    shift_time: float = 2.0          # seconds to complete a lane change
    x: float = 0.0
    y: float = 0.0
    yaw: Optional[float] = None
    module: str = ""                 # controller module name ('controller')
    ctrl_args: Dict[str, str] = field(default_factory=dict)
    active: bool = True              # ActivateControllerAction longitudinal
    waypoints: Tuple[Tuple[float, float], ...] = ()   # 'route' | 'trajectory'
    times: Tuple[float, ...] = ()    # 'trajectory' vertex schedule (seconds
                                     # from action start; empty = untimed)
    # 'sync': relative_to = master entity, (x, y) = master's target position,
    # waypoints[0] = own target position, target_speed/speed_delta = FinalSpeed
    final_relative: bool = False     # FinalSpeed is RelativeSpeedToMaster
    # 'visibility': (graphics, traffic, sensors) flags
    visibility: Tuple[bool, bool, bool] = (True, True, True)
    # 'override' (or riding on 'controller'): pedal-level overrides,
    # name -> value for activations, name -> None for deactivations
    overrides: Dict[str, Optional[float]] = field(default_factory=dict)


# OpenSCENARIO Trigger = OR over ConditionGroups, AND within a group
Trigger = List[List[XoscCondition]]


@dataclass
class XoscEvent:
    name: str
    actors: Tuple[str, ...]
    trigger: Trigger                 # event StartTrigger; empty = fires at once
    actions: List[XoscAction]
    act_trigger: Trigger = field(default_factory=list)  # enclosing Act's gate
    # enclosing Maneuver / Act names, kept so a
    # StoryboardElementStateCondition can reference elements above the
    # event level (the parser otherwise flattens the storyboard to events)
    maneuver: str = ""
    act_name: str = ""
    # enclosing Act's StopTrigger: once it holds (for a started act), the
    # act is cancelled — in-flight transitional actions halt and its
    # remaining events never fire (srunner terminates the act's parallel
    # composite the same way, open_scenario.py:364-370 + the StopTrigger
    # END rule at :110-145)
    act_stop: Trigger = field(default_factory=list)
    # enclosing ManeuverGroup name + its maximumExecutionCount: the group's
    # events re-fire once per iteration, a new iteration starting only after
    # every event of the group fired and completed in the current one
    # (srunner repeats the group subtree in sequence, open_scenario.py:271)
    group: str = ""
    max_exec: int = 1


@dataclass
class OpenScenarioConfig:
    description: str = ""
    town: str = ""
    entities: Dict[str, EntitySpec] = field(default_factory=dict)
    weather: Optional[str] = None
    events: List[XoscEvent] = field(default_factory=list)
    stop_trigger: Trigger = field(default_factory=list)  # empty = never stops
    criteria: List[str] = field(default_factory=list)

    @property
    def hero(self) -> Optional[EntitySpec]:
        for e in self.entities.values():
            if e.is_hero:
                return e
        return None


# --------------------------------------------------------------------------- #
# parser
# --------------------------------------------------------------------------- #

_PARAM_TOKEN = re.compile(r"\$([A-Za-z_][A-Za-z0-9_]*)")
_ALLOWED_EXPR_NODES = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
                       ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod,
                       ast.FloorDiv, ast.Pow, ast.USub, ast.UAdd,
                       ast.Call, ast.Name, ast.Load)

# the functions OSC 1.1 spec 10.8 defines for expressions (round is the
# spec's round-half-up, not banker's rounding)
_EXPR_FUNCS = {
    "round": lambda x: math.floor(x + 0.5),
    "floor": math.floor,
    "ceil": math.ceil,
    "sqrt": math.sqrt,
    "pow": lambda x, y: x ** y,
}


def _eval_expr(expr: str, params: Dict[str, str]) -> str:
    """OpenSCENARIO 1.1 ``${...}`` expression: arithmetic over numbers and
    ``$parameter`` references, plus the spec's five math functions
    round/floor/ceil/sqrt/pow (openscenario spec 10.8; srunner resolves the
    same via its ParameterRef machinery)."""
    # parenthesize each substitution: a string parameter holding "1+2" used
    # in ${$a * 3} must evaluate as (1+2)*3 = 9, not 1+2*3 = 7 (parameters
    # are values, not textual macros)
    text = _PARAM_TOKEN.sub(
        lambda m: "(%s)" % params.get(m.group(1), "0"), expr)
    tree = ast.parse(text, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_EXPR_NODES):
            raise ValueError(f"unsupported expression element "
                             f"{type(node).__name__} in ${{{expr}}}")
        if isinstance(node, ast.Constant) and not isinstance(node.value, (int, float)):
            raise ValueError(f"non-numeric constant in ${{{expr}}}")
        if isinstance(node, ast.Call) and not (
                isinstance(node.func, ast.Name)
                and node.func.id in _EXPR_FUNCS and not node.keywords):
            raise ValueError(f"unsupported function call in ${{{expr}}} "
                             f"(spec 10.8 defines {sorted(_EXPR_FUNCS)})")
        if isinstance(node, ast.Name) and node.id not in _EXPR_FUNCS:
            raise ValueError(f"unknown name '{node.id}' in ${{{expr}}}")
    val = eval(compile(tree, "<xosc-expr>", "eval"),  # safe: whitelisted
               {"__builtins__": {}}, dict(_EXPR_FUNCS))
    if isinstance(val, float) and val.is_integer():
        return str(int(val))
    return str(val)


def _resolve(value: Optional[str], params: Dict[str, str]) -> Optional[str]:
    if value is None:
        return None
    if value.startswith("${") and value.endswith("}"):
        return _eval_expr(value[2:-1], params)
    if value.startswith("$"):
        return params.get(value[1:], value)
    return value


def _f(node: ET.Element, attr: str, params: Dict[str, str],
       default: float = 0.0) -> float:
    raw = _resolve(node.get(attr), params)
    return float(raw) if raw not in (None, "") else default


# parse-time map context for LanePosition resolution: set by parse_xosc
# (try/finally) when a vectorized map is supplied. Parsing happens once at
# CLI startup on one thread, so a module-level context keeps the ten
# _parse_position call sites signature-stable.
_PARSE_RMAP = None


def _parse_position(pos: ET.Element, params: Dict[str, str],
                    entities: Dict[str, EntitySpec]) -> Tuple[float, float, Optional[float]]:
    """WorldPosition / RelativeWorldPosition / LanePosition ->
    (x, y, yaw-or-None)."""
    world = pos.find("WorldPosition")
    if world is not None:
        yaw = world.get("h")
        return (_f(world, "x", params), _f(world, "y", params),
                float(_resolve(yaw, params)) if yaw is not None else None)
    rel = pos.find("RelativeWorldPosition")
    if rel is not None:
        ref = entities.get(rel.get("entityRef", ""), None)
        bx = ref.x if ref else 0.0
        by = ref.y if ref else 0.0
        return (bx + _f(rel, "dx", params), by + _f(rel, "dy", params), None)
    obj = pos.find("RelativeObjectPosition")
    if obj is not None:
        # dx forward / dy left in the referenced entity's INIT frame (the
        # parser resolves positions once, like srunner's static conversion)
        ref = entities.get(obj.get("entityRef", ""), None)
        bx, by = (ref.x, ref.y) if ref else (0.0, 0.0)
        ryaw = (ref.yaw or 0.0) if ref else 0.0
        dx, dy = _f(obj, "dx", params), _f(obj, "dy", params)
        c, sn = math.cos(ryaw), math.sin(ryaw)
        return (bx + dx * c - dy * sn, by + dx * sn + dy * c, None)
    def need_map(kind: str):
        # lane-relative kinds resolve through the native vectorizer's rmap
        # v3 ids/arclength (srunner resolves them through the CARLA map
        # API, openscenario_parser.py:get_position); they need
        # parse_xosc(..., rough_map=...) — phase0 passes its vectorized map
        if _PARSE_RMAP is None:
            raise ValueError(
                f"{kind} needs a vectorized map: pass rough_map= to "
                f"parse_xosc (phase0 does when `map:` is configured)")

    def oriented(el: ET.Element, x: float, y: float, yaw: float):
        h = el.find("Orientation")
        if h is not None:
            # relative orientation adds to the lane heading (OSC default);
            # absolute replaces it
            dh = _f(h, "h", params, 0.0)
            yaw = dh if h.get("type") == "absolute" else yaw + dh
        return x, y, yaw

    lane = pos.find("LanePosition")
    if lane is not None:
        need_map("LanePosition")
        from mmfn_tpu_torch.mapping.rough_map import resolve_lane_position

        x, y, yaw = resolve_lane_position(
            _PARSE_RMAP, _resolve(lane.get("roadId", "0"), params),
            int(_f(lane, "laneId", params)), _f(lane, "s", params),
            _f(lane, "offset", params, 0.0))
        return oriented(lane, x, y, yaw)
    rlane = pos.find("RelativeLanePosition")
    if rlane is not None:
        need_map("RelativeLanePosition")
        from mmfn_tpu_torch.mapping.rough_map import (locate_on_lane,
                                                resolve_lane_position)

        ref = entities.get(rlane.get("entityRef", ""), None)
        if ref is None:
            raise ValueError("RelativeLanePosition needs a known entityRef")
        road, lid, s, _ = locate_on_lane(_PARSE_RMAP, ref.x, ref.y)
        dlane = int(_f(rlane, "dLane", params))
        # srunner maps dLane=+1 to waypoint.get_right_lane() and dLane=-1 to
        # get_left_lane() (openscenario_parser.py:509-524): "right" is
        # relative to the entity's direction of travel. Negative-id lanes
        # travel with +s, so their right neighbour is MORE negative; the id
        # step therefore flips sign with the lane side.
        step = -dlane if lid < 0 else dlane
        new_lane = lid + step
        if step != 0 and lid * new_lane <= 0:
            new_lane += 1 if step > 0 else -1    # no lane 0 in OpenDRIVE
        # ds runs along the TARGET lane's direction of travel (srunner walks
        # wp.next(ds) on the resolved waypoint): +s for right-side lanes,
        # -s for left-side lanes
        s_new = s + _f(rlane, "ds", params) * (1.0 if new_lane < 0 else -1.0)
        x, y, yaw = resolve_lane_position(
            _PARSE_RMAP, road, new_lane, s_new,
            _f(rlane, "offset", params, 0.0))
        return oriented(rlane, x, y, yaw)
    road = pos.find("RoadPosition")
    if road is not None:
        need_map("RoadPosition")
        from mmfn_tpu_torch.mapping.rough_map import resolve_road_position

        x, y, yaw = resolve_road_position(
            _PARSE_RMAP, _resolve(road.get("roadId", "0"), params),
            _f(road, "s", params), _f(road, "t", params, 0.0))
        return oriented(road, x, y, yaw)
    rroad = pos.find("RelativeRoadPosition")
    if rroad is not None:
        need_map("RelativeRoadPosition")
        from mmfn_tpu_torch.mapping.rough_map import (resolve_road_position,
                                                road_position_of)

        ref = entities.get(rroad.get("entityRef", ""), None)
        if ref is None:
            raise ValueError("RelativeRoadPosition needs a known entityRef")
        road_id, s, t = road_position_of(_PARSE_RMAP, ref.x, ref.y)
        x, y, yaw = resolve_road_position(
            _PARSE_RMAP, road_id, s + _f(rroad, "ds", params),
            t + _f(rroad, "dt", params, 0.0))
        return oriented(rroad, x, y, yaw)
    raise ValueError(
        f"unsupported Position kind: {[c.tag for c in pos]} "
        "(subset supports WorldPosition / RelativeWorldPosition / "
        "RelativeObjectPosition / LanePosition / RelativeLanePosition / "
        "RoadPosition / RelativeRoadPosition)")


def _parse_speed_action(act: ET.Element, params: Dict[str, str]) -> XoscAction:
    dyn = act.find(".//SpeedActionDynamics")
    rate = None
    if dyn is not None and dyn.get("dynamicsShape") == "linear" \
            and dyn.get("dynamicsDimension") == "rate":
        # authors write decelerations as negative rates; the runtime steps
        # toward the target, so only the magnitude is meaningful
        rate = abs(_f(dyn, "value", params)) or None
    out = XoscAction("speed", rate=rate)
    absolute = act.find(".//AbsoluteTargetSpeed")
    relative = act.find(".//RelativeTargetSpeed")
    if absolute is not None:
        out.target_speed = _f(absolute, "value", params)
    elif relative is not None:
        out.relative_to = relative.get("entityRef", "")
        out.speed_delta = _f(relative, "value", params)
    return out


_TRUTHY = ("true", "1", "yes", "on")


def _parse_controller_action(ctrl: ET.Element, params: Dict[str, str],
                             catalogs: Dict[str, Dict[str, ET.Element]]
                             ) -> Optional[XoscAction]:
    """ControllerAction -> 'controller' XoscAction.

    Mirrors ``openscenario_parser.get_controller`` (340-376) for the
    Controller element's Properties (``module`` name plus free-form args,
    inline or through a Controller catalog). OverrideControllerValueAction
    is an EXTENSION beyond the reference (which raises on any *active*
    override, ibid.:371-374): Throttle/Brake/ParkingBrake/SteeringWheel
    map onto the kinematic model (see ``_ScriptedActor.step``); Clutch and
    Gear have no kinematic meaning here and are ignored."""
    # override scan first: an override-only ControllerAction is valid OSC
    overrides: Dict[str, Optional[float]] = {}
    override = ctrl.find("OverrideControllerValueAction")
    if override is not None:
        for child in override:
            name = child.tag.lower()
            if name in ("clutch", "gear"):
                continue
            if str(_resolve(child.get("active", "false"),
                            params)).lower() in _TRUTHY:
                overrides[name] = _f(child, "value", params, 0.0)
            else:
                overrides[name] = None          # deactivate
    if ctrl.find(".//AssignControllerAction") is None and overrides:
        return XoscAction("override", overrides=overrides)
    assign = ctrl.find(".//AssignControllerAction")
    if assign is None:
        # OSC 1.1 also nests ActivateControllerAction under ControllerAction
        activate = ctrl.find("ActivateControllerAction")
        if activate is not None:
            longitudinal = str(activate.get("longitudinal", "true")).lower()
            return XoscAction("activate", active=longitudinal in _TRUTHY)
        return None
    controller = assign.find("Controller")
    if controller is None and assign.find("CatalogReference") is not None:
        controller = _catalog_entry(assign, catalogs, params)
    props = controller.find("Properties") if controller is not None else None
    module, args = "", {}
    if props is not None:
        for prop in props.findall("Property"):
            name = prop.get("name", "")
            value = _resolve(prop.get("value", ""), params) or ""
            if name == "module":
                module = value
            else:
                args[name] = value
    if not module:
        return XoscAction("override", overrides=overrides) if overrides \
            else None
    return XoscAction("controller", module=module, ctrl_args=args,
                      overrides=overrides)


def _parse_route_action(routing: ET.Element, params: Dict[str, str],
                        entities: Dict[str, EntitySpec],
                        catalogs: Dict[str, Dict[str, ET.Element]]
                        ) -> Optional[XoscAction]:
    """RoutingAction/AssignRouteAction -> 'route' XoscAction.

    Waypoint extraction per ``openscenario_parser.get_route`` (378-410):
    an inline Route or a Route CatalogReference, each Waypoint's Position
    converted to a world point."""
    assign = routing.find("AssignRouteAction")
    if assign is None:
        return None
    route = assign.find("Route")
    if route is None and assign.find("CatalogReference") is not None:
        route = _catalog_entry(assign, catalogs, params)
    if route is None:
        raise ValueError("AssignRouteAction without Route or CatalogReference")
    waypoints = []
    for wp in route.iter("Waypoint"):
        pos = wp.find("Position")
        if pos is not None:
            x, y, _ = _parse_position(pos, params, entities)
            waypoints.append((x, y))
    return XoscAction("route", waypoints=tuple(waypoints))


def _parse_clothoid(clothoid: ET.Element, follow: ET.Element,
                    params: Dict[str, str],
                    entities: Dict[str, EntitySpec]) -> XoscAction:
    """Clothoid trajectory shape -> 'trajectory' XoscAction (EXTENSION —
    the reference raises on every FollowTrajectoryAction).

    OSC 1.0 Clothoid: start ``Position`` (pose incl. heading), ``curvature``
    κ0, ``curvatureDot`` dκ/ds (OSC 1.1 calls it ``curvaturePrime``),
    ``length``; heading along the spiral is the analytic
    θ(s) = h + κ0·s + ½·(dκ/ds)·s², positions integrate cos/sin θ
    (trapezoid at 0.5 m steps — the same discretization the native
    vectorizer uses for OpenDRIVE spirals, rough_map_node.cpp). With
    ``startTime``/``stopTime`` the arc is replayed on a uniform time grid
    (constant speed along s, the spec's natural parameterization);
    otherwise the sampled points degrade to controller waypoints like an
    untimed Polyline. ``TimeReference/None`` forces untimed; ``Timing``
    scale/offset apply to the schedule."""
    pos = clothoid.find("Position")
    if pos is None:
        raise ValueError("Clothoid needs a start Position")
    x0, y0, yaw = _parse_position(pos, params, entities)
    h = 0.0 if yaw is None else float(yaw)
    c0 = _f(clothoid, "curvature", params, 0.0)
    cdot = _f(clothoid, "curvatureDot", params,
              _f(clothoid, "curvaturePrime", params, 0.0))
    length = _f(clothoid, "length", params)
    if length <= 0:
        raise ValueError("Clothoid needs a positive length")
    # step count: 0.5 m spacing, refined so no step turns more than
    # ~0.02 rad (total heading change κ0·L + ½κ'·L²) — keeps the trapezoid
    # integral within ~1 cm of the analytic spiral even at tight ends
    turn = abs(c0) * length + 0.5 * abs(cdot) * length * length
    n = int(np.clip(max(math.ceil(length / 0.5), math.ceil(turn / 0.02)),
                    8, 1000))
    s = np.linspace(0.0, length, n + 1)
    theta = h + c0 * s + 0.5 * cdot * s * s
    dx = np.cos(theta)
    dy = np.sin(theta)
    ds = s[1] - s[0]
    # trapezoid cumulative integral, anchored at the start pose
    xs = x0 + np.concatenate([[0.0], np.cumsum((dx[1:] + dx[:-1]) * ds / 2)])
    ys = y0 + np.concatenate([[0.0], np.cumsum((dy[1:] + dy[:-1]) * ds / 2)])
    pts = tuple(zip(xs.tolist(), ys.tolist()))

    raw0 = _resolve(clothoid.get("startTime"), params)
    raw1 = _resolve(clothoid.get("stopTime"), params)
    timed = raw0 not in (None, "") and raw1 not in (None, "")
    t0, t1 = (float(raw0), float(raw1)) if timed else (0.0, 0.0)
    if timed and t1 <= t0:
        raise ValueError(f"Clothoid stopTime must exceed startTime "
                         f"({t0} .. {t1})")
    if follow.find(".//TimeReference/None") is not None:
        timed = False
    if not timed:
        return XoscAction("trajectory", waypoints=pts)
    scale, offset = 1.0, 0.0
    timing = follow.find(".//TimeReference/Timing")
    if timing is not None:
        scale = _f(timing, "scale", params, 1.0)
        offset = _f(timing, "offset", params, 0.0)
    schedule = tuple(offset + scale * t
                     for t in np.linspace(t0, t1, n + 1).tolist())
    return XoscAction("trajectory", waypoints=pts, times=schedule)


def _nurbs_basis(knots: np.ndarray, order: int, u: np.ndarray) -> np.ndarray:
    """Cox-de Boor basis functions N_{i,p}(u) for every control point.

    Returns [len(u), n_ctrl]. Degree p = order-1; the 0/0 convention is 0.
    Clamped evaluation: u == last domain knot is attributed to the final
    span so the curve endpoint is reproduced exactly."""
    p = order - 1
    n_ctrl = len(knots) - order
    # zeroth degree: indicator of the knot span (half-open; the single span
    # containing the domain end closes at it so the curve endpoint is
    # reproduced). Spans at/after the domain end stay zero — with a
    # non-clamped knot vector they would otherwise ALSO fire at
    # u == domain end and double the rational denominator there.
    N = np.zeros((len(u), len(knots) - 1))
    domain_end = knots[n_ctrl]                       # == knots[-order]
    for i in range(len(knots) - 1):
        if knots[i + 1] <= knots[i] or knots[i] >= domain_end:
            continue
        if domain_end <= knots[i + 1]:               # span holding the end
            inside = (u >= knots[i]) & (u <= domain_end)
        else:
            inside = (u >= knots[i]) & (u < knots[i + 1])
        N[:, i] = inside
    for d in range(1, p + 1):
        nxt = np.zeros((len(u), N.shape[1] - 1))
        for i in range(nxt.shape[1]):
            left_den = knots[i + d] - knots[i]
            right_den = knots[i + d + 1] - knots[i + 1]
            term = np.zeros(len(u))
            if left_den > 0:
                term = (u - knots[i]) / left_den * N[:, i]
            if right_den > 0:
                term = term + (knots[i + d + 1] - u) / right_den * N[:, i + 1]
            nxt[:, i] = term
        N = nxt
    return N[:, :n_ctrl]


def _parse_nurbs(nurbs: ET.Element, follow: ET.Element,
                 params: Dict[str, str],
                 entities: Dict[str, EntitySpec]) -> XoscAction:
    """Nurbs trajectory shape -> 'trajectory' XoscAction (EXTENSION — the
    reference raises on every FollowTrajectoryAction).

    OSC 1.0 Nurbs: ``order`` k (= degree+1), ``ControlPoint`` elements
    (Position + optional ``weight``/``time``) and a clamped ``Knot`` vector
    of len(ctrl)+order values. The rational curve
    C(u) = Σ N_{i,p}(u)·w_i·P_i / Σ N_{i,p}(u)·w_i is sampled at 100 points
    over the valid domain [u_{k-1}, u_{n+1}]; per the spec, control-point
    ``time`` values interpolate through the same rational basis, producing
    a timed replay schedule (``TimeReference/None`` forces untimed)."""
    order = int(_f(nurbs, "order", params))
    pts, weights, times = [], [], []
    for cp in nurbs.findall("ControlPoint"):
        pos = cp.find("Position")
        if pos is None:
            continue
        x, y, _ = _parse_position(pos, params, entities)
        pts.append((x, y))
        weights.append(_f(cp, "weight", params, 1.0))
        raw_t = _resolve(cp.get("time"), params)
        times.append(float(raw_t) if raw_t not in (None, "") else None)
    knots = np.array([_f(k, "value", params)
                      for k in nurbs.findall("Knot")], dtype=np.float64)
    if order < 2 or len(pts) < order:
        raise ValueError(f"Nurbs needs order >= 2 and at least `order` "
                         f"control points (order={order}, n={len(pts)})")
    if len(knots) != len(pts) + order:
        raise ValueError(f"Nurbs knot vector must have n_ctrl+order = "
                         f"{len(pts) + order} values (got {len(knots)})")
    if np.any(np.diff(knots) < 0):
        raise ValueError("Nurbs knot vector must be non-decreasing")
    u = np.linspace(knots[order - 1], knots[len(pts)], 100)
    basis = _nurbs_basis(knots, order, u)            # [100, n_ctrl]
    w = np.asarray(weights, dtype=np.float64)
    bw = basis * w                                   # rational weighting
    denom = bw.sum(axis=1, keepdims=True)
    denom[denom == 0.0] = 1.0
    xy = (bw @ np.asarray(pts, dtype=np.float64)) / denom
    waypoints = tuple(map(tuple, xy.tolist()))

    timed = all(t is not None for t in times) and len(times) > 0
    if follow.find(".//TimeReference/None") is not None:
        timed = False
    if not timed:
        return XoscAction("trajectory", waypoints=waypoints)
    scale, offset = 1.0, 0.0
    timing = follow.find(".//TimeReference/Timing")
    if timing is not None:
        scale = _f(timing, "scale", params, 1.0)
        offset = _f(timing, "offset", params, 0.0)
    sched = (bw @ np.asarray(times, dtype=np.float64)) / denom[:, 0]
    sched = offset + scale * sched
    if np.any(np.diff(sched) <= 0):
        raise ValueError("Nurbs control-point times must produce a strictly "
                         "increasing schedule")
    return XoscAction("trajectory", waypoints=waypoints,
                      times=tuple(sched.tolist()))


def _parse_follow_trajectory(follow: ET.Element, params: Dict[str, str],
                             entities: Dict[str, EntitySpec],
                             catalogs: Dict[str, Dict[str, ET.Element]]
                             ) -> XoscAction:
    """FollowTrajectoryAction -> 'trajectory' XoscAction.

    EXTENSION beyond the reference (srunner raises NotImplementedError —
    openscenario_parser.py:1043-1044). All three OSC shapes — Polyline,
    Clothoid, Nurbs — from an inline ``Trajectory``, an OSC 1.1
    ``TrajectoryRef``, or a Trajectory ``CatalogReference``. With a
    ``TimeReference/Timing`` (and per-vertex ``time`` attributes) the
    schedule is replayed exactly, ``scale``/``offset`` applied per the
    spec; with ``TimeReference/None`` or untimed vertices the polyline
    degrades to controller waypoint following.
    """
    traj = follow.find("Trajectory")
    if traj is None:
        holder = follow.find("TrajectoryRef")          # OSC 1.1 wrapper
        if holder is None:
            holder = follow
        if holder.find("CatalogReference") is not None:
            traj = _catalog_entry(holder, catalogs, params)
    if traj is None:
        raise ValueError(
            "FollowTrajectoryAction without Trajectory or CatalogReference")
    shape = traj.find("Shape")
    clothoid = shape.find("Clothoid") if shape is not None else None
    if clothoid is not None:
        return _parse_clothoid(clothoid, follow, params, entities)
    nurbs = shape.find("Nurbs") if shape is not None else None
    if nurbs is not None:
        return _parse_nurbs(nurbs, follow, params, entities)
    poly = shape.find("Polyline") if shape is not None else None
    if poly is None:
        kinds = [c.tag for c in shape] if shape is not None else []
        raise ValueError(
            f"Trajectory Shape needs Polyline, Clothoid, or Nurbs "
            f"(got {kinds})")
    pts: List[Tuple[float, float]] = []
    times: List[Optional[float]] = []
    for vertex in poly.findall("Vertex"):
        pos = vertex.find("Position")
        if pos is None:
            continue
        x, y, _ = _parse_position(pos, params, entities)
        pts.append((x, y))
        raw_t = _resolve(vertex.get("time"), params)
        times.append(float(raw_t) if raw_t not in (None, "") else None)
    if len(pts) < 2:
        raise ValueError("trajectory Polyline needs at least two vertices")
    timed = all(t is not None for t in times)
    scale, offset = 1.0, 0.0
    if follow.find(".//TimeReference/None") is not None:
        timed = False
    else:
        timing = follow.find(".//TimeReference/Timing")
        if timing is not None:
            scale = _f(timing, "scale", params, 1.0)
            offset = _f(timing, "offset", params, 0.0)
    if not timed:
        return XoscAction("trajectory", waypoints=tuple(pts))
    schedule = tuple(offset + scale * t for t in times)
    if any(b <= a for a, b in zip(schedule, schedule[1:])):
        raise ValueError(
            f"trajectory vertex times must be strictly increasing "
            f"after scale/offset: {schedule}")
    return XoscAction("trajectory", waypoints=tuple(pts), times=schedule)


def _parse_synchronize(sync: ET.Element, params: Dict[str, str],
                       entities: Dict[str, EntitySpec]) -> XoscAction:
    """SynchronizeAction -> 'sync' XoscAction.

    EXTENSION beyond the reference (srunner raises NotImplementedError —
    openscenario_parser.py:1023-1024). OSC spec 3.87: the actor adapts its
    speed so that it arrives at ``TargetPosition`` at the same moment the
    ``masterEntityRef`` arrives at ``TargetPositionMaster``, then adopts
    ``FinalSpeed`` (AbsoluteSpeed or RelativeSpeedToMaster).
    """
    master = sync.get("masterEntityRef", "")
    master_pos = sync.find("TargetPositionMaster")
    own_pos = sync.find("TargetPosition")
    if master_pos is None or own_pos is None:
        raise ValueError("SynchronizeAction needs TargetPositionMaster "
                         "and TargetPosition")

    def unwrap(el: ET.Element) -> ET.Element:
        # the XSD puts the position members directly under TargetPosition*;
        # accept an explicit <Position> wrapper too (common in the wild)
        inner = el.find("Position")
        return inner if inner is not None else el

    mx, my, _ = _parse_position(unwrap(master_pos), params, entities)
    x, y, _ = _parse_position(unwrap(own_pos), params, entities)
    out = XoscAction("sync", relative_to=master, x=mx, y=my,
                     waypoints=((x, y),))
    absolute = sync.find(".//FinalSpeed/AbsoluteSpeed")
    relative = sync.find(".//FinalSpeed/RelativeSpeedToMaster")
    if absolute is not None:
        out.target_speed = _f(absolute, "value", params)
    elif relative is not None:
        out.final_relative = True
        out.speed_delta = _f(relative, "value", params)
    return out


def _parse_private_action(act: ET.Element, params: Dict[str, str],
                          entities: Dict[str, EntitySpec],
                          catalogs: Optional[Dict[str, Dict[str, ET.Element]]] = None
                          ) -> Optional[XoscAction]:
    catalogs = catalogs or {}
    speed = act.find(".//SpeedAction")
    if speed is not None:
        return _parse_speed_action(speed, params)
    lane = act.find(".//LaneChangeAction")
    if lane is not None:
        target = lane.find(".//RelativeTargetLane")
        value = _f(target, "value", params) if target is not None else 0.0
        dyn = lane.find(".//LaneChangeActionDynamics")
        t = _f(dyn, "value", params, 2.0) if dyn is not None \
            and dyn.get("dynamicsDimension") == "time" else 2.0
        return XoscAction("lane_change", lane_offset=value * LANE_WIDTH,
                          shift_time=max(t, 0.1))
    teleport = act.find("TeleportAction")
    if teleport is not None:
        x, y, yaw = _parse_position(teleport.find("Position"), params, entities)
        return XoscAction("teleport", x=x, y=y, yaw=yaw)
    ctrl = act.find("ControllerAction")
    if ctrl is not None:
        return _parse_controller_action(ctrl, params, catalogs)
    activate = act.find("ActivateControllerAction")
    if activate is not None:
        longitudinal = str(activate.get("longitudinal", "true")).lower()
        return XoscAction("activate", active=longitudinal in _TRUTHY)
    vis = act.find("VisibilityAction")
    if vis is not None:
        # EXTENSION beyond the reference (srunner raises NotImplementedError
        # — openscenario_parser.py:1021-1022). CARLA actor-visibility
        # semantics: graphics = rendering (our birdview camera), sensors =
        # ego sensor returns (lidar/radar synthesis), traffic = other
        # participants' obstacle awareness. Physics/collisions stay on.
        def flag(attr):
            return str(_resolve(vis.get(attr, "true"), params)).lower() \
                in _TRUTHY
        return XoscAction("visibility", visibility=(
            flag("graphics"), flag("traffic"), flag("sensors")))
    sync = act.find("SynchronizeAction")
    if sync is not None:
        return _parse_synchronize(sync, params, entities)
    routing = act.find("RoutingAction")
    if routing is not None:
        follow = routing.find("FollowTrajectoryAction")
        if follow is not None:
            return _parse_follow_trajectory(follow, params, entities,
                                            catalogs)
        route = _parse_route_action(routing, params, entities, catalogs)
        if route is not None:
            return route
    acquire = act.find(".//AcquirePositionAction")
    if acquire is not None:
        x, y, _ = _parse_position(acquire.find("Position"), params, entities)
        return XoscAction("acquire", x=x, y=y)
    return None


def _unsupported_condition(name: str, container: Optional[ET.Element]) -> XoscCondition:
    """Record (and WARN about) a condition outside the subset. The warning is
    per construct kind: an unsupported condition parses as never-holding, so
    the event it gates silently never fires — scenario authors must hear
    about that at parse time, not discover it from a maneuver that never ran
    (the reference's srunner would instead raise at conversion,
    openscenario_parser.py convert_condition_to_atomic)."""
    tags = [c.tag for c in container] if container is not None else []
    construct = "/".join(tags) or (container.tag if container is not None
                                   else "<empty Condition>")
    warnings.warn(
        f"OpenSCENARIO condition construct '{construct}' is outside the "
        f"supported subset: it will NEVER hold, so any event it gates stays "
        f"gated forever (first seen at condition name={name!r})",
        UnsupportedOsc, stacklevel=3)
    return XoscCondition("unsupported", name=name)


def _parse_condition(cond: ET.Element, params: Dict[str, str],
                     entities: Dict[str, EntitySpec]) -> XoscCondition:
    """Parse one <Condition>. Constructs outside the subset yield an
    'unsupported' condition that never holds — the gated event then stays
    gated (firing it immediately would silently corrupt the story) — and a
    loud ``UnsupportedOsc`` warning at parse time."""
    name = cond.get("name", "")
    byval = cond.find("ByValueCondition")
    if byval is not None:
        sim = byval.find("SimulationTimeCondition")
        if sim is not None:
            return XoscCondition("time", value=_f(sim, "value", params),
                                 rule=sim.get("rule", "greaterThan"), name=name)
        sig = byval.find("TrafficSignalCondition")
        if sig is not None:
            # srunner WaitForTrafficLightState: holds while the named light
            # shows the required state (atomic_trigger_conditions.py)
            return XoscCondition(
                "signal", entity=_resolve(sig.get("name"), params) or "",
                state=(_resolve(sig.get("state"), params) or "green").lower(),
                name=name)
        tod = byval.find("TimeOfDayCondition")
        if tod is not None:
            # srunner TimeOfDayComparison: compares the weather-sim clock
            # (atomic_trigger_conditions.py:421); the dateTime's time-of-day
            # becomes an hour threshold against WeatherSim.clock_hour
            dt_str = _resolve(tod.get("dateTime"), params) or ""
            try:
                hh, mm, ss = dt_str.split("T")[1].split(":")[:3]
                hour = float(hh) + float(mm) / 60.0 + float(ss) / 3600.0
            except (IndexError, ValueError):
                hour = 12.0
            return XoscCondition("timeofday", value=hour,
                                 rule=tod.get("rule", "greaterThan"),
                                 name=name)
        par = byval.find("ParameterCondition")
        if par is not None:
            # OSC semantics: compare the parameter's value against 'value'
            # under 'rule'. Parameters are compile-time constants in this
            # engine (no ParameterSetAction in the subset), so the
            # comparison folds to a constant at parse time. srunner instead
            # repurposes ParameterCondition stop-trigger names as criterion
            # declarations (openscenario_parser.py:817-838) — that
            # convention is handled by _parse_trigger's criteria_ filter
            # before any condition reaches here.
            cur = params.get(par.get("parameterRef", "").lstrip("$"))
            want = _resolve(par.get("value"), params) or ""
            rule = par.get("rule", "equalTo")
            holds = False
            if cur is None:
                warnings.warn(
                    "OSC ParameterCondition references undeclared parameter "
                    f"'{par.get('parameterRef', '')}'; condition never holds")
            else:
                try:
                    fc, fw = float(cur), float(want)
                    # _cmp only knows lessThan/equalTo/greaterThan; handle
                    # notEqualTo explicitly (same epsilon as equalTo) so it
                    # does not silently fold to greaterThan
                    if rule == "notEqualTo":
                        holds = abs(fc - fw) >= 1e-6
                    else:
                        holds = OpenScenarioManager._cmp(fc, rule, fw)
                except ValueError:
                    # non-numeric parameters compare as strings
                    if rule == "equalTo":
                        holds = cur == want
                    elif rule == "notEqualTo":
                        holds = cur != want
            return XoscCondition("parameter", value=1.0 if holds else 0.0,
                                 name=name)
        sbe = byval.find("StoryboardElementStateCondition")
        if sbe is not None:
            # srunner OSCStartEndCondition: startTransition -> rule=START,
            # stop/end/completeState -> rule=END (openscenario_parser.py:
            # 850-861); runningState (started, not yet ended) is an
            # extension the dataclass engine gets for free.
            state = _resolve(sbe.get("state"), params) or ""
            mapped = {"startTransition": "start",
                      "stopTransition": "end",
                      "endTransition": "end",
                      "completeState": "end",
                      "runningState": "running"}.get(state)
            if mapped is None:
                return _unsupported_condition(name, byval)
            return XoscCondition(
                "element_state",
                entity=_resolve(sbe.get("storyboardElementRef"), params) or "",
                state=mapped,
                rule=(_resolve(sbe.get("storyboardElementType"), params)
                      or "event"),
                name=name)
        return _unsupported_condition(name, byval)
    byent = cond.find("ByEntityCondition")
    if byent is None:
        return _unsupported_condition(name, cond)
    triggering = tuple(
        ref.get("entityRef", "")
        for ref in byent.findall(".//TriggeringEntities/EntityRef"))
    ec = byent.find("EntityCondition")
    if ec is None:
        return _unsupported_condition(name, byent)
    rel = ec.find("RelativeDistanceCondition")
    if rel is not None:
        return XoscCondition("reldist", value=_f(rel, "value", params),
                             rule=rel.get("rule", "lessThan"),
                             entity=rel.get("entityRef", ""),
                             triggering=triggering, name=name)
    trav = ec.find("TraveledDistanceCondition")
    if trav is not None:
        return XoscCondition("traveled", value=_f(trav, "value", params),
                             triggering=triggering, name=name)
    reach = ec.find("ReachPositionCondition")
    if reach is not None:
        x, y, _ = _parse_position(reach.find("Position"), params, entities)
        return XoscCondition("reach", x=x, y=y,
                             tolerance=_f(reach, "tolerance", params, 3.0),
                             triggering=triggering, name=name)
    still = ec.find("StandStillCondition")
    if still is not None:
        return XoscCondition("standstill", value=_f(still, "duration", params),
                             triggering=triggering, name=name)
    dist = ec.find("DistanceCondition")
    if dist is not None:
        # srunner InTriggerDistanceToLocation(AlongRoute): with
        # alongRoute="true" the distance is measured along the ego's route
        # polyline, not as the crow flies (atomic_trigger_conditions.py
        # InTriggerDistanceToLocationAlongRoute)
        x, y, _ = _parse_position(dist.find("Position"), params, entities)
        return XoscCondition(
            "distance", value=_f(dist, "value", params),
            rule=dist.get("rule", "lessThan"), x=x, y=y,
            along_route=(_resolve(dist.get("alongRoute"), params)
                         or "false").lower() in ("true", "1"),
            triggering=triggering, name=name)
    ttc = ec.find("TimeToCollisionCondition")
    if ttc is not None:
        # srunner InTimeToArrivalToVehicle/ToLocation: time to close the gap
        # to a moving entity or a fixed point at the current closing speed
        target = ttc.find("TimeToCollisionConditionTarget")
        entity_ref = target.find("EntityRef") if target is not None else None
        x = y = 0.0
        ent = ""
        if entity_ref is not None:
            ent = entity_ref.get("entityRef", "")
        elif target is not None and target.find("Position") is not None:
            x, y, _ = _parse_position(target.find("Position"), params, entities)
        return XoscCondition("ttc", value=_f(ttc, "value", params),
                             rule=ttc.get("rule", "lessThan"),
                             entity=ent, x=x, y=y,
                             triggering=triggering, name=name)
    headway = ec.find("TimeHeadwayCondition")
    if headway is not None:
        return XoscCondition("headway", value=_f(headway, "value", params),
                             rule=headway.get("rule", "lessThan"),
                             entity=headway.get("entityRef", ""),
                             triggering=triggering, name=name)
    speed = ec.find("SpeedCondition")
    if speed is not None:
        return XoscCondition("speed", value=_f(speed, "value", params),
                             rule=speed.get("rule", "greaterThan"),
                             triggering=triggering, name=name)
    acc = ec.find("AccelerationCondition")
    if acc is not None:
        # srunner TriggerAcceleration (atomic_trigger_conditions.py:374):
        # the entity's linear acceleration magnitude against the threshold
        return XoscCondition("accel", value=_f(acc, "value", params),
                             rule=acc.get("rule", "greaterThan"),
                             triggering=triggering, name=name)
    relspeed = ec.find("RelativeSpeedCondition")
    if relspeed is not None:
        # srunner RelativeVelocityToOtherActor
        # (atomic_trigger_conditions.py:280): v_triggering - v_entityRef
        return XoscCondition("relspeed", value=_f(relspeed, "value", params),
                             rule=relspeed.get("rule", "greaterThan"),
                             entity=relspeed.get("entityRef", ""),
                             triggering=triggering, name=name)
    coll = ec.find("CollisionCondition")
    if coll is not None:
        # OBB contact between the triggering entity and the referenced one
        # (no EntityRef / ByType target = any scripted actor). The fake
        # world's kinematic analog of CARLA's physical collision sensor —
        # same geometry as scenarios.check_collision.
        ref = coll.find("EntityRef")
        return XoscCondition(
            "collision",
            entity=(_resolve(ref.get("entityRef"), params) or ""
                    ) if ref is not None else "",
            triggering=triggering, name=name)
    off = ec.find("OffroadCondition")
    if off is not None:
        # held continuously for `duration`: entity outside every drivable
        # lane ribbon (rmap centerline +- half width, the same membership
        # test as OutsideRouteLanesCriterion); without a wired map it falls
        # back to >3.5 m from the ego route polyline (docs/PARITY.md)
        return XoscCondition("offroad",
                             value=_f(off, "duration", params, 0.0),
                             triggering=triggering, name=name)
    eor = ec.find("EndOfRoadCondition")
    if eor is not None:
        # held continuously for `duration`: entity within 2 m of the end of
        # the ego route polyline (the fake world's road network IS the
        # route's lanes; docs/PARITY.md)
        return XoscCondition("end_of_road",
                             value=_f(eor, "duration", params, 0.0),
                             triggering=triggering, name=name)
    return _unsupported_condition(name, ec)


def _parse_global_action(glob: ET.Element, params: Dict[str, str]
                         ) -> Optional[XoscAction]:
    """Story-level <GlobalAction> subset: EnvironmentAction (mid-route
    weather change — srunner ChangeWeather, atomic_behaviors.py:190) and
    InfrastructureAction/TrafficSignalStateAction (forced light state —
    srunner TrafficLightStateSetter, atomic_behaviors.py:1902). The manager
    applies these to the route's world services, not to a scripted actor.
    Returns None for constructs outside the subset (caller warns)."""
    env = glob.find(".//EnvironmentAction/Environment")
    if env is None:
        env = glob.find(".//EnvironmentAction//Environment")  # catalog-style
    if env is not None:
        return XoscAction("weather", module=_weather_preset(env))
    sig = glob.find(".//TrafficSignalStateAction")
    if sig is not None:
        return XoscAction(
            "signal_state", module=_resolve(sig.get("name"), params) or "",
            state=(_resolve(sig.get("state"), params) or "green").lower())
    return None


def _parse_trigger(trigger_el: Optional[ET.Element], params: Dict[str, str],
                   entities: Dict[str, EntitySpec],
                   criteria_out: Optional[List[str]] = None) -> Trigger:
    """<StartTrigger>/<StopTrigger> -> OR-of-AND condition groups.

    srunner's ``criteria_*`` stop-trigger convention (openscenario_parser):
    those conditions are criteria declarations, not stop conditions — they are
    collected into ``criteria_out`` and removed; a group left empty by that
    removal is dropped (an empty group would otherwise hold vacuously)."""
    groups: Trigger = []
    if trigger_el is None:
        return groups
    for group_el in trigger_el.findall("ConditionGroup"):
        group: List[XoscCondition] = []
        for cond in group_el.findall("Condition"):
            cname = cond.get("name", "")
            if criteria_out is not None and cname.startswith("criteria_"):
                criteria_out.append(cname[len("criteria_"):])
                continue
            group.append(_parse_condition(cond, params, entities))
        if group:
            groups.append(group)
    return groups


def _weather_preset(env: ET.Element) -> str:
    """Map an Environment block onto the expert's WEATHERS preset names
    (harness/experts/agent.py); coarse on purpose — the fake world only
    records weather ids, CARLA glue applies the matching preset."""
    weather = env.find(".//Weather")
    sun = env.find(".//Sun")
    precip = env.find(".//Precipitation")
    raining = precip is not None and precip.get("precipitationType") == "rain"
    elevation = float(sun.get("elevation", "1.0")) if sun is not None else 1.0
    cloudy = weather is not None and weather.get("cloudState") in (
        "cloudy", "overcast", "rainy")
    if elevation < 0.2:
        return "HardRainSunset" if raining else \
            ("CloudySunset" if cloudy else "ClearSunset")
    if raining:
        return "HardRainNoon"
    if cloudy:
        return "CloudyNoon"
    return "ClearNoon"


def _load_catalogs(root: ET.Element, base_dir: str) -> Dict[str, Dict[str, ET.Element]]:
    """CatalogLocations -> {catalog name: {entry name: element}}.

    Scans every ``*.xosc`` under each location's Directory (relative paths
    resolve against the scenario file), collecting ``<Catalog name=...>``
    children — the subset srunner's example Vehicle/Pedestrian catalogs use
    (openscenario_parser.py get_catalog_entry semantics).
    """
    out: Dict[str, Dict[str, ET.Element]] = {}
    locs = root.find("CatalogLocations")
    if locs is None:
        return out
    for loc in locs:
        d = loc.find("Directory")
        if d is None:
            continue
        directory = d.get("path", "")
        if not os.path.isabs(directory):
            directory = os.path.join(base_dir, directory)
        if not os.path.isdir(directory):
            continue
        for fn in sorted(os.listdir(directory)):
            if not fn.endswith(".xosc"):
                continue
            croot = ET.parse(os.path.join(directory, fn)).getroot()
            for cat in croot.iter("Catalog"):
                entries = out.setdefault(cat.get("name", ""), {})
                for child in cat:
                    entries[child.get("name", "")] = child
    return out


def _catalog_entry(obj: ET.Element, catalogs: Dict[str, Dict[str, ET.Element]],
                   params: Dict[str, str]) -> Optional[ET.Element]:
    """Resolve a ScenarioObject's CatalogReference.

    Matches srunner's get_catalog_entry semantics: the entry is deep-copied
    and its ``$parameter`` attribute values are substituted from a LOCAL
    scope — the entry's own ParameterDeclarations defaults overridden by the
    reference's ParameterAssignments (themselves resolved in the caller's
    scope). The caller's ``params`` dict is never mutated, so an assignment
    cannot leak into later ``$param`` references elsewhere in the scenario.
    """
    ref = obj.find("CatalogReference")
    if ref is None:
        return None
    entry = catalogs.get(_resolve(ref.get("catalogName", ""), params) or "",
                         {}).get(_resolve(ref.get("entryName", ""), params) or "")
    if entry is None:
        raise ValueError(f"unresolved CatalogReference "
                         f"{ref.get('catalogName')}/{ref.get('entryName')}")
    local = dict(params)
    decls = entry.find("ParameterDeclarations")
    if decls is not None:
        for p in decls.findall("ParameterDeclaration"):
            local[p.get("name", "")] = _resolve(p.get("value", ""), local) or ""
    for assign in ref.findall(".//ParameterAssignment"):
        pname = assign.get("parameterRef", "").lstrip("$")
        local[pname] = _resolve(assign.get("value", ""), params) or ""
    entry = copy.deepcopy(entry)
    for el in entry.iter():
        for k, v in el.attrib.items():
            if "$" in v:
                el.attrib[k] = _resolve(v, local) or v
    return entry


def parse_xosc(path: str, rough_map=None) -> OpenScenarioConfig:
    """Parse an .xosc file. ``rough_map`` (a vectorized RoughMap with rmap
    v3 ids) enables LanePosition resolution; without it LanePosition raises
    at parse time."""
    global _PARSE_RMAP
    _PARSE_RMAP = rough_map
    try:
        return _parse_xosc_impl(path)
    finally:
        _PARSE_RMAP = None


def _parse_xosc_impl(path: str) -> OpenScenarioConfig:
    root = ET.parse(path).getroot()
    if root.tag != "OpenSCENARIO":
        raise ValueError(f"{path}: not an OpenSCENARIO file (root {root.tag})")
    cfg = OpenScenarioConfig()
    header = root.find("FileHeader")
    if header is not None:
        cfg.description = header.get("description", "")

    params: Dict[str, str] = {}
    decls = root.find("ParameterDeclarations")
    if decls is not None:
        for p in decls.findall("ParameterDeclaration"):
            params[p.get("name", "")] = _resolve(p.get("value", ""), params)

    logic = root.find(".//RoadNetwork/LogicFile")
    if logic is not None:
        cfg.town = logic.get("filepath", "")

    catalogs = _load_catalogs(root, os.path.dirname(os.path.abspath(path)))

    # ---- entities ---- #
    for obj in root.findall(".//Entities/ScenarioObject"):
        name = obj.get("name", "")
        spec = EntitySpec(name=name)
        veh = obj.find("Vehicle")
        ped = obj.find("Pedestrian")
        if veh is None and ped is None:
            entry = _catalog_entry(obj, catalogs, params)
            if entry is not None and entry.tag == "Vehicle":
                veh = entry
            elif entry is not None and entry.tag == "Pedestrian":
                ped = entry
        if ped is not None:
            spec.kind = "walker"
            spec.extent = 0.5
            spec.model = ped.get("name", "")
        elif veh is not None:
            spec.model = veh.get("name", "")
            if veh.get("vehicleCategory") == "bicycle":
                spec.extent = 1.0
        for src in {obj, veh, ped} - {None}:
            for prop in src.findall(".//Properties/Property"):
                if prop.get("name") == "type" and prop.get("value") == "ego_vehicle":
                    spec.is_hero = True
        if name in ("hero", "ego_vehicle"):
            spec.is_hero = True
        cfg.entities[name] = spec

    # ---- init ---- #
    init = root.find(".//Storyboard/Init")
    if init is not None:
        env = init.find(".//EnvironmentAction/Environment")
        if env is not None:
            cfg.weather = _weather_preset(env)
        for private in init.findall(".//Private"):
            spec = cfg.entities.get(private.get("entityRef", ""))
            if spec is None:
                continue
            for act in private.findall("PrivateAction"):
                teleport = act.find("TeleportAction")
                if teleport is not None:
                    spec.x, spec.y, yaw = _parse_position(
                        teleport.find("Position"), params, cfg.entities)
                    if yaw is not None:
                        spec.yaw = yaw
                    continue
                speed = act.find(".//SpeedAction")
                if speed is not None:
                    parsed = _parse_speed_action(speed, params)
                    if parsed.target_speed is not None:
                        spec.speed = parsed.target_speed
                    continue
                # controller / route / activate assignments in Init apply
                # at actor construction (srunner converts init private
                # actions to pre-story behaviours the same way)
                other = _parse_private_action(act, params, cfg.entities,
                                              catalogs)
                if other is not None and other.kind in (
                        "controller", "route", "activate"):
                    spec.init_actions.append(other)

    # ---- story events ---- #
    for act_el in root.findall(".//Storyboard/Story/Act"):
        act_trigger = _parse_trigger(act_el.find("StartTrigger"), params,
                                     cfg.entities)
        act_stop = _parse_trigger(act_el.find("StopTrigger"), params,
                                  cfg.entities)
        for group in act_el.findall("ManeuverGroup"):
            actors = tuple(
                ref.get("entityRef", "")
                for ref in group.findall("Actors/EntityRef"))
            try:
                max_exec = max(1, int(float(
                    _resolve(group.get("maximumExecutionCount"), params)
                    or "1")))
            except ValueError:
                max_exec = 1
            # a ManeuverGroup holds inline Maneuvers and/or a
            # CatalogReference to a maneuver catalog entry (resolved with
            # the same local-parameter scoping as entity catalogs)
            maneuvers = list(group.findall("Maneuver"))
            if group.find("CatalogReference") is not None:
                entry = _catalog_entry(group, catalogs, params)
                if entry is not None:
                    maneuvers.append(entry)
            for man_el, event_el in ((m, e) for m in maneuvers
                                     for e in m.findall("Event")):
                trigger = _parse_trigger(event_el.find("StartTrigger"),
                                         params, cfg.entities)
                actions: List[XoscAction] = []
                for action_el in event_el.findall("Action"):
                    private = action_el.find("PrivateAction")
                    if private is not None:
                        parsed_a = _parse_private_action(
                            private, params, cfg.entities, catalogs)
                        if parsed_a is not None:
                            actions.append(parsed_a)
                        continue
                    glob = action_el.find("GlobalAction")
                    if glob is not None:
                        parsed_g = _parse_global_action(glob, params)
                        if parsed_g is not None:
                            actions.append(parsed_g)
                        else:
                            warnings.warn(
                                "OpenSCENARIO GlobalAction construct "
                                f"'{'/'.join(c.tag for c in glob)}' is "
                                "outside the supported subset and is "
                                "dropped (event "
                                f"{event_el.get('name', '')!r})",
                                UnsupportedOsc, stacklevel=2)
                if actions:
                    cfg.events.append(XoscEvent(
                        name=event_el.get("name", ""), actors=actors,
                        trigger=trigger, actions=actions,
                        act_trigger=act_trigger,
                        maneuver=man_el.get("name", ""),
                        act_name=act_el.get("name", ""),
                        act_stop=act_stop,
                        group=group.get("name", ""),
                        max_exec=max_exec))

    # ---- storyboard stop trigger (+ srunner criteria_* convention) ---- #
    cfg.stop_trigger = _parse_trigger(root.find(".//Storyboard/StopTrigger"),
                                      params, cfg.entities,
                                      criteria_out=cfg.criteria)
    return cfg


# --------------------------------------------------------------------------- #
# runtime
# --------------------------------------------------------------------------- #

class _ScriptedActor:
    """A story-driven entity: drives along its heading at a controlled speed,
    optionally executing a lateral lane shift or re-aiming at a position."""

    def __init__(self, spec: EntitySpec, actor_id: int):
        self.name = spec.name
        self.actor = ScenarioActor(
            spec.kind, np.array([spec.x, spec.y], dtype=np.float64),
            np.zeros(2), yaw=spec.yaw, extent=spec.extent, actor_id=actor_id)
        self.speed = float(spec.speed)
        self.target_speed = float(spec.speed)
        self.rate: Optional[float] = None
        self._shift_left = 0.0        # remaining lateral shift, +left
        self._shift_rate = 0.0
        self.controller: Optional[BasicControl] = None
        self._resume_speed = 0.0      # target to restore on autopilot re-on
        # active timed trajectory: (points [N,2], schedule [N]) + own clock
        self._traj: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._traj_t = 0.0
        # active SynchronizeAction, retargeted every tick by the manager
        # (only the manager can see the master entity's live state)
        self._sync: Optional[XoscAction] = None
        # active pedal overrides (OverrideControllerValueAction):
        # name ('throttle'|'brake'|'parkingbrake'|'steeringwheel') -> value
        self._overrides: Dict[str, float] = {}
        for action in spec.init_actions:
            self.apply(action, lambda name: None)

    def _default_route_controller(self) -> BasicControl:
        """A route assigned to an uncontrolled actor gets the direct-velocity
        follower — srunner's ChangeActorWaypoints drives through the actor's
        registered control, defaulting to simple_vehicle_control."""
        kind = ("pedestrian_control" if self.actor.kind == "walker"
                else "simple_vehicle_control")
        return make_controller(kind)

    def apply(self, action: XoscAction, lookup) -> None:
        if action.kind == "speed":
            if action.relative_to:
                other = lookup(action.relative_to)
                base = other if other is not None else 0.0
                self.target_speed = max(0.0, base + action.speed_delta)
            elif action.target_speed is not None:
                self.target_speed = action.target_speed
            self.rate = action.rate
            if self.controller is not None:
                self.controller.update_target_speed(self.target_speed)
        elif action.kind == "controller":
            self.controller = make_controller(action.module, action.ctrl_args)
            self.controller.extent = self.actor.extent
            self.controller.update_target_speed(self.target_speed)
        elif action.kind == "route":
            if self.controller is None:
                self.controller = self._default_route_controller()
                self.controller.extent = self.actor.extent
                self.controller.update_target_speed(self.target_speed)
            self.controller.update_waypoints(action.waypoints)
        elif action.kind == "trajectory":
            if action.times:
                # timed: an exact pose schedule, preempting the controller
                # for its duration (OSC: the trajectory defines the motion)
                self._traj = (
                    np.asarray(action.waypoints, dtype=np.float64),
                    np.asarray(action.times, dtype=np.float64))
                self._traj_t = 0.0
            else:
                # untimed: the polyline is just waypoints for the controller
                if self.controller is None:
                    self.controller = self._default_route_controller()
                    self.controller.extent = self.actor.extent
                    self.controller.update_target_speed(self.target_speed)
                self.controller.update_waypoints(action.waypoints)
        elif action.kind == "activate":
            if action.active:
                # autopilot on == hand the actor to the NPC follower
                # (ChangeAutoPilot -> traffic-manager driving); a re-enable
                # after an off resumes the speed the story last set, like
                # the TM resuming its own cruise speed
                keep = self.controller.waypoints if self.controller else []
                if self.target_speed == 0.0 and self._resume_speed > 0.0:
                    self.target_speed = self._resume_speed
                self.controller = make_controller("npc_vehicle_control")
                self.controller.extent = self.actor.extent
                self.controller.update_target_speed(self.target_speed)
                if keep:
                    self.controller.update_waypoints(keep)
            else:
                # autopilot off: nothing applies throttle any more — the
                # kinematic analog of coasting is an immediate stop
                self.controller = None
                self._resume_speed = self.target_speed
                self.target_speed = 0.0
                self.rate = None
        elif action.kind == "sync":
            self._sync = action
            if self.controller is None:
                d = np.asarray(action.waypoints[0]) - self.actor.position
                if np.linalg.norm(d) > 1e-6:
                    self.actor.yaw = math.atan2(d[1], d[0])
        elif action.kind == "lane_change":
            self._shift_left = action.lane_offset
            self._shift_rate = action.lane_offset / action.shift_time
        elif action.kind == "teleport":
            self.actor.position = np.array([action.x, action.y], dtype=np.float64)
            if action.yaw is not None:
                self.actor.yaw = action.yaw
        elif action.kind == "acquire":
            d = np.array([action.x, action.y]) - self.actor.position
            if np.linalg.norm(d) > 1e-6:
                self.actor.yaw = math.atan2(d[1], d[0])
        elif action.kind == "visibility":
            (self.actor.visible_graphics, self.actor.visible_traffic,
             self.actor.visible_sensors) = action.visibility
        if action.kind in ("controller", "override"):
            for name, value in action.overrides.items():
                if value is None:
                    self._overrides.pop(name, None)
                else:
                    self._overrides[name] = value

    def cancel(self, action: XoscAction) -> None:
        """Halt an in-flight transitional action (Act StopTrigger fired):
        speed pursuit freezes at the current speed, a pending lane shift
        stops where it is, a timed trajectory releases the actor at its
        current pose, a synchronize stops retargeting. Instantaneous kinds
        have nothing to cancel. Matches srunner terminating the act's
        running atomics (open_scenario.py:364-370)."""
        if action.kind == "speed":
            self.target_speed = self.speed
            self.rate = None
            if self.controller is not None:
                self.controller.update_target_speed(self.target_speed)
        elif action.kind == "lane_change":
            self._shift_left = 0.0
        elif action.kind == "trajectory" and action.times:
            self._traj = None
        elif action.kind == "sync":
            self._sync = None

    def step(self, dt: float,
             obstacles: Sequence[Obstacle] = ()) -> None:
        if self._traj is not None:
            pts, sched = self._traj
            self._traj_t += dt
            t = min(self._traj_t, float(sched[-1]))
            # np.interp clamps before the first vertex, so an offset
            # schedule holds the actor at vertex 0 until its time comes
            target = np.array([np.interp(t, sched, pts[:, 0]),
                               np.interp(t, sched, pts[:, 1])])
            vel = ((target - self.actor.position) / dt if dt > 0
                   else np.zeros(2))
            self.speed = float(np.linalg.norm(vel))
            if self.speed > 1e-6:
                self.actor.yaw = math.atan2(vel[1], vel[0])
            self.actor.velocity = vel
            self.actor.position = target
            if self._traj_t >= float(sched[-1]):
                # schedule exhausted: resume ordinary scripted motion with
                # the story's current target speed from the final pose
                self._traj = None
                if self.controller is not None:
                    self.controller.update_target_speed(self.target_speed)
            return
        if self._overrides:
            # pedal-level overrides preempt the controller/story motion
            # (EXTENSION — the reference raises on active overrides,
            # openscenario_parser.py:371-374). Kinematics mirror the ego's
            # KinematicWorld: throttle*4 m/s^2, brake*8 m/s^2, bicycle-model
            # yaw from the steering angle (interpreted as road-wheel angle,
            # clipped to the same 35 deg), parking brake = immediate hold.
            if self._overrides.get("parkingbrake", 0.0) > 0.0:
                self.speed = 0.0
            else:
                accel = (self._overrides.get("throttle", 0.0) * 4.0
                         - self._overrides.get("brake", 0.0) * 8.0)
                self.speed = float(np.clip(self.speed + accel * dt, 0.0,
                                           30.0))
            steer = self._overrides.get("steeringwheel")
            if steer is not None and self.speed > 0.0:
                steer = float(np.clip(steer, -math.radians(35.0),
                                      math.radians(35.0)))
                self.actor.yaw += (self.speed / 2.9) * math.tan(steer) * dt
            heading = np.array([math.cos(self.actor.yaw),
                                math.sin(self.actor.yaw)])
            vel = heading * self.speed
            self.actor.velocity = vel
            self.actor.position = self.actor.position + vel * dt
            return
        if self.controller is not None:
            out = self.controller.run_step(
                self.actor.position, self.actor.yaw, self.speed, dt,
                obstacles)
            if out is not None:
                vel, yaw = out
                # longitudinal speed fed back to the controller next tick —
                # recorded before the shift so the lateral component doesn't
                # inflate it
                self.speed = float(np.linalg.norm(vel))
                # a pending LaneChangeAction shift rides on top of the
                # controller's longitudinal motion (srunner's lateral atom
                # overrides the controller for the duration of the shift)
                if self._shift_left:
                    left = np.array([-math.sin(yaw), math.cos(yaw)])
                    shift = self._shift_rate * dt
                    if abs(shift) >= abs(self._shift_left):
                        shift = self._shift_left
                    self._shift_left -= shift
                    vel = vel + left * (shift / dt if dt > 0 else 0.0)
                self.actor.velocity = vel
                self.actor.yaw = yaw
                self.actor.position = self.actor.position + vel * dt
                return
            # ExternalControl: fall through to the default scripted motion
        if self.rate is not None and self.speed != self.target_speed:
            delta = self.rate * dt
            if self.speed < self.target_speed:
                self.speed = min(self.target_speed, self.speed + delta)
            else:
                self.speed = max(self.target_speed, self.speed - delta)
        else:
            self.speed = self.target_speed
        heading = np.array([math.cos(self.actor.yaw), math.sin(self.actor.yaw)])
        left = np.array([-heading[1], heading[0]])
        vel = heading * self.speed
        if self._shift_left:
            shift = self._shift_rate * dt
            if abs(shift) >= abs(self._shift_left):
                shift = self._shift_left
            self._shift_left -= shift
            vel = vel + left * (shift / dt if dt > 0 else 0.0)
        self.actor.velocity = vel
        self.actor.position = self.actor.position + vel * dt


class OpenScenarioManager:
    """Steps a parsed OpenSCENARIO story in the fake world.

    Interface-compatible with ``ScenarioManagerLite`` (tick / steer_noise /
    remove_actors_near) plus ``stop_triggered`` consumed by
    ``ClosedLoopRunner.run_route``. The hero entity is NOT spawned — the
    KinematicWorld's ego plays that role; hero-referenced conditions evaluate
    against the live ego state.
    """

    def __init__(self, config: OpenScenarioConfig, actor_id_base: int = 2000,
                 signals=None, route_xy=None):
        self.config = config
        hero = config.hero
        self.hero_name = hero.name if hero else "hero"
        self.scripted: Dict[str, _ScriptedActor] = {}
        for i, (name, spec) in enumerate(config.entities.items()):
            if not spec.is_hero:
                self.scripted[name] = _ScriptedActor(spec, actor_id_base + i)
        self.time = 0.0
        self.ego_traveled = 0.0
        self._last_ego: Optional[np.ndarray] = None
        self._ego_speed = 0.0
        self._ego_vel = np.zeros(2)
        self._standstill_since: Dict[str, float] = {}
        self._stop = False
        # fired-state lives here, NOT on the (shareable) parsed config:
        # several managers can run the same OpenScenarioConfig independently
        self._fired: set = set()
        # event index -> (scripted actor, action) pairs applied when it
        # fired; consumed by the 'element_state' end/running semantics
        self._applied: Dict[int, List[Tuple["_ScriptedActor", XoscAction]]] = {}
        # acts whose StopTrigger fired: their in-flight actions were
        # cancelled and their remaining events stay gated forever
        self._stopped_acts: set = set()
        # ManeuverGroup repetition (maximumExecutionCount): per-event fire
        # counts and per-group current iteration; an event re-fires once per
        # iteration, the iteration advancing only when every event of the
        # group fired and completed in the current one
        self._count: Dict[int, int] = {}
        self._group_iter: Dict[tuple, int] = {}
        # events whose group iteration advanced but which have not re-fired
        # yet: their completeState from the PREVIOUS iteration must not leak
        # into element_state 'end' checks (srunner's OSCStartEndCondition
        # only fires on transitions observed after it started ticking)
        self._pending_refire: set = set()
        self._groups: Dict[tuple, List[int]] = {}
        for i, ev in enumerate(config.events):
            if ev.max_exec > 1:
                self._groups.setdefault((ev.act_name, ev.group), []).append(i)
        # world context for 'signal' and alongRoute 'distance' conditions;
        # ClosedLoopRunner.drive auto-wires both when left None, and likewise
        # the fake world + WeatherSim consumed by story-level GlobalActions
        # ('weather', 'signal_state') and the 'timeofday' condition
        self.signals = signals            # harness.traffic.SignalSet
        self.route_xy = route_xy          # [(x, y)] ego route polyline
        self.world = None                 # fake world (set_weather target)
        self.weather_sim = None           # harness.weather.WeatherSim
        # per-entity speed memory for the 'accel' condition (finite diff)
        self._prev_speed: Dict[str, float] = {}
        self._accel: Dict[str, float] = {}
        # drivable-lane ribbon for 'offroad' (points, half_widths) — wired
        # from the route's rough map by ClosedLoopRunner.drive when left None
        self.lane_ribbon = None
        self._ego_yaw = 0.0
        # (kind, entity) -> time the condition started holding continuously
        # ('offroad' / 'end_of_road' duration semantics)
        self._dur_since: Dict[tuple, float] = {}

    @property
    def fired_events(self) -> Tuple[str, ...]:
        return tuple(self.config.events[i].name for i in sorted(self._fired))

    # ---- condition evaluation ---- #

    def _entity_pos(self, name: str, ego_xy: np.ndarray) -> Optional[np.ndarray]:
        if name == self.hero_name:
            return ego_xy
        sa = self.scripted.get(name)
        return sa.actor.position if sa is not None else None

    def _entity_speed(self, name: str) -> Optional[float]:
        if name == self.hero_name:
            return self._ego_speed
        sa = self.scripted.get(name)
        return sa.speed if sa is not None else None

    def _entity_vel(self, name: str) -> Optional[np.ndarray]:
        if name == self.hero_name:
            return self._ego_vel
        sa = self.scripted.get(name)
        return sa.actor.velocity if sa is not None else None

    def _route_arclength(self, xy: np.ndarray) -> float:
        """Arclength of ``xy``'s projection onto the ego route polyline."""
        pts = np.asarray(self.route_xy, dtype=np.float64)
        a, b = pts[:-1], pts[1:]
        seg = b - a
        seg_len = np.linalg.norm(seg, axis=1)
        safe = np.where(seg_len > 1e-9, seg_len, 1.0)
        t = np.clip(np.einsum("ij,ij->i", xy - a, seg) / safe**2, 0.0, 1.0)
        proj = a + seg * t[:, None]
        i = int(np.argmin(np.linalg.norm(proj - xy, axis=1)))
        return float(np.sum(seg_len[:i]) + t[i] * seg_len[i])

    @staticmethod
    def _cmp(value: float, rule: str, threshold: float) -> bool:
        if rule == "lessThan":
            return value < threshold
        if rule == "equalTo":
            return abs(value - threshold) < 1e-6
        return value > threshold

    @staticmethod
    def _action_complete(scripted: "_ScriptedActor", action: XoscAction) -> bool:
        """Whether an applied action has finished executing on its actor —
        the OSC completeState/endTransition signal. Transitional kinds
        complete when their motion target is reached; everything else
        (teleport, controller swap, visibility, ...) is instantaneous.
        Untimed trajectories/routes hand waypoints to a controller and are
        treated as instantaneous (subset; the timed schedule is the
        completion-bearing form)."""
        if action.kind == "speed":
            return abs(scripted.speed - scripted.target_speed) < 0.05
        if action.kind == "lane_change":
            return scripted._shift_left == 0.0
        if action.kind == "trajectory" and action.times:
            return scripted._traj is None
        if action.kind == "sync":
            return scripted._sync is None
        return True

    def _event_ended(self, idx: int) -> bool:
        if idx in self._pending_refire:
            return False    # ended last iteration, not yet re-fired in this
        return idx in self._fired and all(
            self._action_complete(s, a) for s, a in self._applied.get(idx, ()))

    def _element_events(self, ref: str, etype: str) -> List[int]:
        """Event indices covered by a storyboardElementRef of the given
        type. 'action' refs resolve at event granularity (the parser keeps
        no per-action names); 'story' matches everything."""
        out = []
        for i, ev in enumerate(self.config.events):
            if etype == "story":
                out.append(i)
            elif etype == "act" and ev.act_name == ref:
                out.append(i)
            elif etype == "maneuverGroup" and ev.group == ref:
                out.append(i)
            elif etype == "maneuver" and ev.maneuver == ref:
                out.append(i)
            elif etype in ("event", "action") and ev.name == ref:
                out.append(i)
        return out

    def _holds(self, cond: XoscCondition, ego_xy: np.ndarray) -> bool:
        if cond.kind == "time":
            return self._cmp(self.time, cond.rule, cond.value)
        if cond.kind == "parameter":
            return cond.value > 0.5
        if cond.kind == "element_state":
            matches = self._element_events(cond.entity, cond.rule)
            if not matches:
                return False
            if cond.state == "start":
                return any(i in self._fired for i in matches)
            if cond.state == "end":
                return all(self._event_ended(i) for i in matches)
            # 'running': executing NOW — an event parked between group
            # iterations (ended last iteration, next trigger not yet held)
            # is standby, not running, even though _event_ended() reports
            # False for it to keep 'end' gates un-satisfied across the gap
            return any(i in self._fired and i not in self._pending_refire
                       and not self._event_ended(i) for i in matches)
        if cond.kind == "traveled":
            # subset: traveled distance is tracked for the ego; scripted
            # actors' odometers would need per-actor tracking nobody uses
            return self.ego_traveled > cond.value
        refs = cond.triggering or (self.hero_name,)
        if cond.kind == "reldist":
            target = self._entity_pos(cond.entity, ego_xy)
            if target is None:
                return False
            for ref in refs:
                pos = self._entity_pos(ref, ego_xy)
                if pos is not None and self._cmp(
                        float(np.linalg.norm(pos - target)), cond.rule, cond.value):
                    return True
            return False
        if cond.kind == "reach":
            goal = np.array([cond.x, cond.y])
            return any(
                pos is not None
                and float(np.linalg.norm(pos - goal)) < cond.tolerance
                for pos in (self._entity_pos(r, ego_xy) for r in refs))
        if cond.kind == "standstill":
            for ref in refs:
                speed = self._entity_speed(ref)
                if speed is None or speed > 0.05:
                    self._standstill_since.pop(ref, None)
                    continue
                since = self._standstill_since.setdefault(ref, self.time)
                if self.time - since >= cond.value:
                    return True
            return False
        if cond.kind == "speed":
            return any(s is not None and self._cmp(s, cond.rule, cond.value)
                       for s in (self._entity_speed(r) for r in refs))
        if cond.kind == "distance":
            goal = np.array([cond.x, cond.y])
            for ref in refs:
                pos = self._entity_pos(ref, ego_xy)
                if pos is None:
                    continue
                if cond.along_route and self.route_xy is not None \
                        and len(self.route_xy) >= 2:
                    d = abs(self._route_arclength(np.asarray(goal, float))
                            - self._route_arclength(np.asarray(pos, float)))
                else:   # no route known: fall back to euclidean
                    d = float(np.linalg.norm(pos - goal))
                if self._cmp(d, cond.rule, cond.value):
                    return True
            return False
        if cond.kind in ("ttc", "headway"):
            # closing-speed time-to-arrival: t = gap / (-d gap/dt); a gap
            # that is opening (closing <= 0) never arrives. For 'headway'
            # the denominator is the triggering entity's own speed
            # (srunner InTimeToArrivalToVehicle vs TimeHeadwayCondition).
            if cond.entity:
                target = self._entity_pos(cond.entity, ego_xy)
                target_vel = self._entity_vel(cond.entity)
            else:
                target = np.array([cond.x, cond.y])
                target_vel = np.zeros(2)
            if target is None or target_vel is None:
                return False
            for ref in refs:
                pos = self._entity_pos(ref, ego_xy)
                vel = self._entity_vel(ref)
                if pos is None or vel is None:
                    continue
                gap = target - pos
                dist = float(np.linalg.norm(gap))
                if dist < 1e-6:
                    t = 0.0
                elif cond.kind == "headway":
                    speed = self._entity_speed(ref) or 0.0
                    if speed <= 1e-6:
                        continue
                    t = dist / speed
                else:
                    closing = float((vel - target_vel) @ (gap / dist))
                    if closing <= 1e-6:
                        continue
                    t = dist / closing
                if self._cmp(t, cond.rule, cond.value):
                    return True
            return False
        if cond.kind == "signal":
            if self.signals is None:
                return False
            m = re.search(r"\d+", cond.entity)
            want_id = int(m.group()) if m else None
            for light in self.signals.lights:
                if want_id is not None and light.light_id != want_id:
                    continue
                if light.state(self.time) == cond.state:
                    return True
            return False
        if cond.kind == "timeofday":
            # compares the WeatherSim clock (runs even with animation off)
            ws = self.weather_sim
            return ws is not None and self._cmp(float(ws.clock_hour),
                                                cond.rule, cond.value)
        if cond.kind == "accel":
            return any(self._cmp(abs(self._accel.get(r, 0.0)),
                                 cond.rule, cond.value) for r in refs)
        if cond.kind == "relspeed":
            other = self._entity_speed(cond.entity)
            if other is None:
                return False
            return any(s is not None
                       and self._cmp(s - other, cond.rule, cond.value)
                       for s in (self._entity_speed(r) for r in refs))
        if cond.kind == "collision":
            if cond.entity and cond.entity != self.hero_name:
                sa = self.scripted.get(cond.entity)
                targets = [sa.actor] if sa is not None else []
            elif cond.entity == self.hero_name:
                targets = []            # handled as the symmetric ego test
            else:                       # no target named: any scripted actor
                targets = [s.actor for s in self.scripted.values()]
            for ref in refs:
                if ref == self.hero_name:
                    if targets and check_collision(
                            ego_xy, self._ego_yaw, targets) is not None:
                        return True
                    continue
                sa = self.scripted.get(ref)
                if sa is None:
                    continue
                if cond.entity == self.hero_name:
                    # scripted triggering entity vs the live ego footprint
                    if check_collision(ego_xy, self._ego_yaw,
                                       [sa.actor]) is not None:
                        return True
                elif any(t is not sa.actor and actors_collide(sa.actor, t)
                         for t in targets):
                    return True
            return False
        if cond.kind == "offroad":
            return self._any_held_for(
                "offroad", refs, ego_xy, cond.value,
                lambda pos: self._is_offroad(pos))
        if cond.kind == "end_of_road":
            if self.route_xy is None or len(self.route_xy) < 2:
                return False
            pts = np.asarray(self.route_xy, dtype=np.float64)
            total = float(np.sum(np.linalg.norm(pts[1:] - pts[:-1], axis=1)))
            return self._any_held_for(
                "end_of_road", refs, ego_xy, cond.value,
                lambda pos: total - self._route_arclength(
                    np.asarray(pos, float)) <= 2.0)
        return False   # 'unsupported' (and anything unknown) never holds

    def _any_held_for(self, kind: str, refs, ego_xy: np.ndarray,
                      duration: float, predicate) -> bool:
        """True when `predicate(position)` has held continuously for
        `duration` seconds for any triggering entity (OSC Offroad/EndOfRoad
        duration semantics)."""
        for ref in refs:
            pos = self._entity_pos(ref, ego_xy)
            key = (kind, ref)
            if pos is None or not predicate(pos):
                self._dur_since.pop(key, None)
                continue
            since = self._dur_since.setdefault(key, self.time)
            if self.time - since >= duration:
                return True
        return False

    # offroad fallback when no lane ribbon is wired: beyond the widest
    # plausible lane half-width from the ego route polyline
    OFFROAD_ROUTE_FALLBACK_M = 3.5
    OFFROAD_MARGIN = 0.6        # matches OutsideRouteLanesCriterion.MARGIN

    def _is_offroad(self, pos: np.ndarray) -> bool:
        pos = np.asarray(pos, dtype=np.float64)
        if self.lane_ribbon is not None and len(self.lane_ribbon[0]):
            points, halfw = self.lane_ribbon
            slack = np.linalg.norm(points - pos, axis=1) - halfw
            return float(np.min(slack)) > self.OFFROAD_MARGIN
        if self.route_xy is not None and len(self.route_xy) >= 1:
            pts = np.asarray(self.route_xy, dtype=np.float64)
            return float(np.min(np.linalg.norm(pts - pos, axis=1))) \
                > self.OFFROAD_ROUTE_FALLBACK_M
        return False

    def _trigger_holds(self, trigger: Trigger, ego_xy: np.ndarray) -> bool:
        """OR over condition groups, AND within a group; an empty trigger
        holds (OpenSCENARIO: no StartTrigger = start immediately)."""
        if not trigger:
            return True
        return any(all(self._holds(c, ego_xy) for c in group)
                   for group in trigger)

    # ---- ScenarioManagerLite-compatible interface ---- #

    def tick(self, ego_xy: np.ndarray, dt: float) -> List[ScenarioActor]:
        ego_xy = np.asarray(ego_xy, dtype=np.float64)
        ego_vel = np.zeros(2)
        if self._last_ego is not None:
            delta = ego_xy - self._last_ego
            step = float(np.linalg.norm(delta))
            self.ego_traveled += step
            self._ego_speed = step / dt if dt > 0 else 0.0
            ego_vel = delta / dt if dt > 0 else ego_vel
        self._ego_vel = ego_vel
        if float(np.linalg.norm(ego_vel)) > 0.1:   # heading only when moving
            self._ego_yaw = float(np.arctan2(ego_vel[1], ego_vel[0]))
        self._last_ego = ego_xy.copy()
        self.time += dt
        # finite-differenced per-entity acceleration ('accel' condition)
        cur_speed = {self.hero_name: self._ego_speed}
        for name, s in self.scripted.items():
            cur_speed[name] = float(np.linalg.norm(s.actor.velocity))
        self._accel = {n: ((v - self._prev_speed[n]) / dt
                           if n in self._prev_speed and dt > 0 else 0.0)
                       for n, v in cur_speed.items()}
        self._prev_speed = cur_speed

        def speed_lookup(name):
            return self._entity_speed(name)

        # Act StopTriggers: for each STARTED act (StartTrigger holding or an
        # event already fired), a holding StopTrigger cancels the act —
        # in-flight transitional actions halt where they are and the act's
        # remaining events stay gated (srunner terminates the act's parallel
        # composite, open_scenario.py:364-370; a stop trigger before the act
        # starts is inert there too, since the stop conditions only tick
        # inside the started act's composite)
        seen_acts: set = set()
        for idx, event in enumerate(self.config.events):
            act = event.act_name
            if not event.act_stop or act in self._stopped_acts \
                    or act in seen_acts:
                continue
            seen_acts.add(act)
            started = (self._trigger_holds(event.act_trigger, ego_xy)
                       or any(j in self._fired
                              for j, ev in enumerate(self.config.events)
                              if ev.act_name == act))
            if started and self._trigger_holds(event.act_stop, ego_xy):
                self._stopped_acts.add(act)
                for j, ev in enumerate(self.config.events):
                    if ev.act_name == act and j in self._fired:
                        for scripted, action in self._applied.get(j, ()):
                            scripted.cancel(action)

        # ManeuverGroup repetition: advance a group's iteration when every
        # one of its events fired in the current iteration and its applied
        # actions completed (sequence-of-iterations, open_scenario.py:271)
        for key, idxs in self._groups.items():
            it = self._group_iter.get(key, 0)
            if it + 1 < self.config.events[idxs[0]].max_exec and all(
                    self._count.get(i, 0) == it + 1 and self._event_ended(i)
                    for i in idxs):
                self._group_iter[key] = it + 1
                self._pending_refire.update(idxs)

        for idx, event in enumerate(self.config.events):
            fired_n = self._count.get(idx, 0)
            if fired_n >= event.max_exec \
                    or event.act_name in self._stopped_acts:
                continue
            if fired_n > self._group_iter.get((event.act_name, event.group),
                                              0):
                continue                 # already fired this iteration
            if self._trigger_holds(event.act_trigger, ego_xy) \
                    and self._trigger_holds(event.trigger, ego_xy):
                self._fired.add(idx)
                self._pending_refire.discard(idx)
                self._count[idx] = fired_n + 1
                world_actions = [a for a in event.actions
                                 if a.kind in ("weather", "signal_state")]
                entity_actions = [a for a in event.actions
                                  if a.kind not in ("weather", "signal_state")]
                for action in world_actions:
                    self._apply_global(action)
                applied = self._applied.setdefault(idx, [])
                for actor_name in (event.actors or tuple(self.scripted)):
                    scripted = self.scripted.get(actor_name)
                    if scripted is None:
                        continue
                    for action in entity_actions:
                        scripted.apply(action, speed_lookup)
                        applied.append((scripted, action))
        for scripted in self.scripted.values():
            self._drive_sync(scripted, ego_xy, dt)
        # obstacle snapshots for obstacle-aware controllers: every other
        # scripted actor plus the live ego (the reference's obstacle sensor
        # sees all dynamic actors — simple_vehicle_control.py:90-100)
        poses = {name: Obstacle(s.actor.position, s.actor.velocity,
                                extent=s.actor.extent)
                 for name, s in self.scripted.items()
                 if s.actor.visible_traffic}  # VisibilityAction traffic=false
        poses[self.hero_name] = Obstacle(ego_xy, ego_vel)
        for name, scripted in self.scripted.items():
            scripted.step(dt, [o for n, o in poses.items() if n != name])
        if self.config.stop_trigger \
                and self._trigger_holds(self.config.stop_trigger, ego_xy):
            self._stop = True
        return [s.actor for s in self.scripted.values()]

    # SynchronizeAction tuning: arrival tolerance and a sanity speed cap
    SYNC_REACH = 2.0
    SYNC_SPEED_CAP = 30.0

    def _drive_sync(self, scripted: _ScriptedActor, ego_xy: np.ndarray,
                    dt: float) -> None:
        """Retarget one actor's speed for an active SynchronizeAction
        (OSC spec 3.87): speed = own remaining distance / master's ETA to
        its own target, re-evaluated every tick so both arrive together;
        on arrival the FinalSpeed applies and the sync ends."""
        sync = scripted._sync
        if sync is None:
            return
        own_target = np.asarray(sync.waypoints[0], dtype=np.float64)
        d = own_target - scripted.actor.position
        d_own = float(np.linalg.norm(d))
        master_speed = self._entity_speed(sync.relative_to) or 0.0
        if d_own < self.SYNC_REACH:
            final = sync.target_speed
            if sync.final_relative:
                final = max(0.0, master_speed + sync.speed_delta)
            if final is not None:
                scripted.target_speed = final
                if scripted.controller is not None:
                    scripted.controller.update_target_speed(final)
            scripted.rate = None
            scripted._sync = None
            return
        master_pos = self._entity_pos(sync.relative_to, ego_xy)
        if master_pos is None:
            return            # master despawned: hold the last target speed
        d_master = float(np.linalg.norm(
            np.array([sync.x, sync.y]) - master_pos))
        # a parked master makes the ETA huge -> the actor waits (speed ~0),
        # which is the spec's intent: arrival is slaved to the master's
        eta = d_master / max(master_speed, 0.1)
        speed = float(np.clip(d_own / max(eta, dt), 0.0,
                              self.SYNC_SPEED_CAP))
        scripted.target_speed = speed
        scripted.rate = None
        if scripted.controller is not None:
            # a routed/controlled actor keeps its path; only the pace syncs
            scripted.controller.update_target_speed(speed)
        else:
            # free actor: head straight for the sync target
            scripted.actor.yaw = math.atan2(d[1], d[0])

    def _apply_global(self, action: XoscAction) -> None:
        """Apply a story-level GlobalAction to the world services (the
        behavior-atom ChangeWeather / TrafficLightStateSetter semantics)."""
        if action.kind == "weather":
            ws, world = self.weather_sim, self.world
            if ws is not None:
                ws.preset = action.module
                ws.family = preset_family(action.module)
            if world is not None:
                if ws is not None:
                    world.set_weather(ws.current_preset(),
                                      ws.sun_altitude_deg)
                else:
                    world.set_weather(action.module)
        elif action.kind == "signal_state" and self.signals is not None:
            # OSC TrafficSignalStateAction persists until overridden; hold
            # for the rest of the route (fault-removal force_green outranks)
            m = re.search(r"\d+", action.module)
            want_id = int(m.group()) if m else None
            for light in self.signals.lights:
                if want_id is None or light.light_id == want_id:
                    light.forced_state = action.state
                    light.forced_state_until = math.inf

    def steer_noise(self) -> float:
        return 0.0

    def remove_actors_near(self, xy: np.ndarray, radius: float = 15.0) -> int:
        xy = np.asarray(xy, dtype=np.float64)
        doomed = [n for n, s in self.scripted.items()
                  if np.linalg.norm(s.actor.position - xy) <= radius]
        for name in doomed:
            del self.scripted[name]
        return len(doomed)

    def stop_triggered(self) -> bool:
        return self._stop


# --------------------------------------------------------------------------- #
# hero route derivation
# --------------------------------------------------------------------------- #

def hero_trajectory(config: OpenScenarioConfig, rough_map=None,
                    distance: float = 200.0) -> List[Tuple[float, float]]:
    """Trajectory keypoints for the hero: OpenSCENARIO defines no route, so
    (like srunner's OpenScenario, which drives until the stop trigger) the
    hero just proceeds along its road. With a RoughMap we chain lane
    polylines from the init position; otherwise a straight segment.

    A TraveledDistanceCondition in the stop trigger bounds the distance: the
    route ends comfortably BEFORE the trigger would, so a successful episode
    finishes as a completed route rather than a stop-truncated one (the
    ego's odometer also counts lateral maneuvers, hence the wide margin).
    """
    hero = config.hero
    if hero is None:
        raise ValueError("scenario declares no ego_vehicle entity")
    for group in config.stop_trigger:
        for cond in group:
            if cond.kind == "traveled":
                distance = min(distance, max(cond.value - 20.0, 20.0))
    start = np.array([hero.x, hero.y])
    heading = np.array([math.cos(hero.yaw), math.sin(hero.yaw)])
    if rough_map is None or not getattr(rough_map, "lanes", None):
        mid = start + heading * (distance / 2)
        return [tuple(start), tuple(mid), tuple(start + heading * distance)]

    # greedy lane-polyline walk: attach at the nearest NODE of any lane that
    # points the hero's way (inits commonly land mid-polyline, not at a
    # chunk head), then keep appending the nearest onward lane
    points: List[np.ndarray] = [start]
    pos = start
    direction = heading
    remaining = distance
    used = set()
    while remaining > 0:
        best = None   # (distance, lane index, node index)
        for li, lane in enumerate(rough_map.lanes):
            if li in used or len(lane.nodes) < 2:
                continue
            for ni in range(len(lane.nodes) - 1):
                node = lane.nodes[ni, :2]
                seg = lane.nodes[ni + 1, :2] - node
                norm = float(np.linalg.norm(seg))
                if norm < 1e-6:
                    continue
                d = float(np.linalg.norm(node - pos))
                if d > 8.0 or float(seg @ direction) / norm < 0.3:
                    continue
                if best is None or d < best[0]:
                    best = (d, li, ni)
        if best is None:
            break
        used.add(best[1])
        lane = rough_map.lanes[best[1]]
        for node in lane.nodes[best[2]:]:
            nxt = np.asarray(node[:2], dtype=np.float64)
            step = float(np.linalg.norm(nxt - pos))
            if step < 0.5:
                continue
            points.append(nxt)
            remaining -= step
            if step > 1e-6:
                direction = (nxt - pos) / step
            pos = nxt
            if remaining <= 0:
                break
    if len(points) < 2:
        points.append(start + heading * distance)
    return [tuple(p) for p in points]
