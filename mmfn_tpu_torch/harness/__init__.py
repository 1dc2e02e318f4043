"""The closed loop: agents, the fake world, criteria, scoring, OpenSCENARIO
storyboards, episode recording and the phase0 CLI.

Every import here is torch-free (``harness.fleet`` and the model agents are
not imported here: they need torch), so that phase 1's workers, the remote
stack and the metrics CLI start without torch.
"""

from mmfn_tpu_torch.harness.events import RoadOption, TrafficEvent, TrafficEventType  # noqa: F401
from mmfn_tpu_torch.harness.statistics import RouteRecord, StatisticsManager  # noqa: F401
from mmfn_tpu_torch.harness.route import downsample_route, parse_routes_file, route_length  # noqa: F401
from mmfn_tpu_torch.harness.watchdog import Watchdog  # noqa: F401
from mmfn_tpu_torch.harness.sensor_interface import SensorInterface, SensorReceivedNoData  # noqa: F401
# registers the atom-composed scenario types into scenarios.SCENARIO_CLASSES
# (atoms imports scenarios, so the registration lives in atoms); loading it
# here makes the catalog complete for any mmfn_tpu_torch.harness.* import
from mmfn_tpu_torch.harness import atoms  # noqa: F401,E402  (registration side effect)
