"""The weather preset table (base_agent.py:14-36).

The port's own copy of the preset part of the JAX package's
``harness/weather.py``: the preset names and the quantizer that maps a
route file's ``<weather>`` parameters onto them. The fake world reads the
preset name (``KinematicWorld.weather``). ``WeatherSim``, the sun simulated
over game time, and ``preset_family``, which it uses, are not ported yet
(ROADMAP queue 1 item 2).
"""

from __future__ import annotations

WEATHER_PRESETS = (
    "ClearNoon", "ClearSunset", "CloudyNoon", "CloudySunset", "WetNoon",
    "WetSunset", "MidRainyNoon", "MidRainSunset", "WetCloudyNoon",
    "WetCloudySunset", "HardRainNoon", "HardRainSunset", "SoftRainNoon",
    "SoftRainSunset",
)


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
