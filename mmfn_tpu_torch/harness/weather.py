"""The weather preset table (base_agent.py:14-36) and the simulated-over-time
weather (srunner weather_sim.py:33-108 analog).

The port's own copy of the JAX package's ``harness/weather.py``: the preset
names, the quantizer that maps a route file's ``<weather>`` parameters onto
them, and ``WeatherSim``, the sun over game time, whose preset the runner
feeds to the fake world each tick (``KinematicWorld.set_weather``); with
``animation=False`` the sun stands still while the clock runs on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

WEATHER_PRESETS = (
    "ClearNoon", "ClearSunset", "CloudyNoon", "CloudySunset", "WetNoon",
    "WetSunset", "MidRainyNoon", "MidRainSunset", "WetCloudyNoon",
    "WetCloudySunset", "HardRainNoon", "HardRainSunset", "SoftRainNoon",
    "SoftRainSunset",
)


# time-of-day suffixes the preset table factors over; everything before the
# suffix is the precipitation/cloud "family" (Clear, Cloudy, Wet, HardRain...)
_DAYTIME_SUFFIXES = ("Noon", "Sunset", "Night")


def preset_family(preset: str) -> str:
    for suffix in _DAYTIME_SUFFIXES:
        if preset.endswith(suffix):
            return preset[: -len(suffix)]
    return preset


def preset_from_params(cloudiness: float = 0.0, precipitation: float = 0.0,
                       precipitation_deposits: float = 0.0,
                       wetness: float = 0.0,
                       sun_altitude_angle: float = 70.0) -> str:
    """Nearest named preset for parametric weather — the leaderboard's
    per-route ``<weather>`` elements carry raw carla.WeatherParameters
    fields (route_parser.py:82-110); the fake world (and the recorded
    measurement ids) speak preset names, so the parameters coarse-quantize
    onto the table: precipitation binds the family hardest (CARLA's
    HardRain/MidRainy/SoftRain presets sit at ~100/~60/~30), then standing
    water/wetness (Wet/WetCloudy), then cloud cover; the sun altitude picks
    the time-of-day suffix (presets put noon at 75 deg, sunset at 15)."""
    suffix = "Noon" if sun_altitude_angle > 45.0 else "Sunset"
    if precipitation >= 80.0:
        family = "HardRain"
    elif precipitation >= 45.0:
        family = "MidRainy" if suffix == "Noon" else "MidRain"
    elif precipitation > 5.0:
        family = "SoftRain"
    elif max(precipitation_deposits, wetness) > 5.0:
        family = "WetCloudy" if cloudiness >= 50.0 else "Wet"
    elif cloudiness >= 50.0:
        family = "Cloudy"
    else:
        family = "Clear"
    name = family + suffix
    assert name in WEATHER_PRESETS, name
    return name


@dataclass
class WeatherSim:
    """Sun position simulated over game time (weather_sim.py:33-89 analog).

    The reference computes the sun's astronomic position with ``ephem`` for
    the map's geolocation and advances it by sim-time each tick
    (Weather.update, weather_sim.py:71-89; driven by WeatherBehavior,
    :91-152). ephem isn't available here, so the standard analytic solar
    approximation replaces it: declination from day-of-year, hour angle from
    local solar hour — within ~1 degree of the ephemeris, far below what the
    preset table resolves.

    ``update(game_time)`` advances the clock (1:1 with sim seconds like the
    reference; ``time_scale`` compresses it so a sunset fits inside a short
    route) and returns the CURRENT preset name: the starting preset's family
    with the time-of-day suffix re-derived from the live sun altitude. The
    closed-loop runner feeds that into the fake world, whose lidar/radar/
    camera synthesis respond (replay.py) — the sensor coupling the reference
    gets implicitly from CARLA's renderer.
    """

    preset: str = "ClearNoon"
    animation: bool = True           # False: the sun stands still (the
                                     # atoms' TimeOfDay animation="false")
    start_hour: float = 11.0         # local solar time at route start
    day_of_year: int = 172           # late June: long day
    latitude_deg: float = 40.0
    time_scale: float = 1.0          # weather-clock seconds per sim second
                                     # (>1 compresses: 60 -> a 1 h sunset
                                     # plays out in 1 sim minute)
    SUNSET_ALTITUDE_DEG: float = 15.0
    NIGHT_ALTITUDE_DEG: float = -6.0  # civil dusk
    sun_altitude_deg: float = field(init=False, default=90.0)
    sun_azimuth_deg: float = field(init=False, default=180.0)
    # live weather-clock hour [0, 24) — the srunner blackboard "Datetime"
    # analog read by the TimeOfDayComparison atom (and advanced even with
    # animation off, where only the sun position stays frozen)
    clock_hour: float = field(init=False, default=11.0)

    def __post_init__(self):
        self.family = preset_family(self.preset)
        self.update(0.0)

    def _solar_position(self, hour: float):
        """(altitude, azimuth) in degrees at local solar ``hour``."""
        decl = math.radians(-23.44) * math.cos(
            2.0 * math.pi * (self.day_of_year + 10) / 365.0)
        lat = math.radians(self.latitude_deg)
        ha = math.radians(15.0 * (hour - 12.0))
        sin_alt = (math.sin(lat) * math.sin(decl)
                   + math.cos(lat) * math.cos(decl) * math.cos(ha))
        alt = math.asin(max(-1.0, min(1.0, sin_alt)))
        cos_az = ((math.sin(decl) - math.sin(alt) * math.sin(lat))
                  / max(1e-9, math.cos(alt) * math.cos(lat)))
        az = math.acos(max(-1.0, min(1.0, cos_az)))
        if ha > 0:                   # afternoon: sun in the west
            az = 2.0 * math.pi - az
        return math.degrees(alt), math.degrees(az)

    def update(self, game_time: float) -> str:
        """Advance to ``game_time`` (seconds since route start) and return
        the preset name in effect."""
        self.clock_hour = (self.start_hour
                           + game_time * self.time_scale / 3600.0) % 24.0
        if self.animation:
            self.sun_altitude_deg, self.sun_azimuth_deg = \
                self._solar_position(self.clock_hour)
        return self.current_preset()

    def current_preset(self) -> str:
        if not self.animation:
            return self.preset
        if self.sun_altitude_deg > self.SUNSET_ALTITUDE_DEG:
            suffix = "Noon"
        elif self.sun_altitude_deg > self.NIGHT_ALTITUDE_DEG:
            suffix = "Sunset"
        else:
            # the preset table has no *Night entries (base_agent.py:14-36);
            # clamp to Sunset like CARLA's table-driven collectors do
            suffix = "Sunset"
        name = self.family + suffix
        if name not in WEATHER_PRESETS:
            # CARLA's table quirk: 'MidRainyNoon' but 'MidRainSunset'
            for alt in ("MidRainy", "MidRain"):
                if self.family in ("MidRainy", "MidRain") \
                        and alt + suffix in WEATHER_PRESETS:
                    return alt + suffix
            return self.preset
        return name
