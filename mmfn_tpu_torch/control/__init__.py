"""Host-side control: the waypoint PID controller and the route planner."""

from mmfn_tpu_torch.control.pid import PIDController, WaypointController  # noqa: F401
from mmfn_tpu_torch.control.planner import GPS_SCALE, RoutePlanner  # noqa: F401
