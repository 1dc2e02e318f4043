"""Thread-safe sensor multiplexer.

The port's own copy of the JAX package's ``harness/sensor_interface.py``,
after leaderboard/leaderboard/envs/sensor_interface.py:198-240: sensor
callbacks (threads) enqueue (tag, frame, data); ``get_data`` blocks until
every registered sensor has delivered a reading for the current tick,
raising ``SensorReceivedNoData`` after a 10 s timeout. The opendrive
pseudo-sensor never gates a tick (it publishes at 1 Hz). Duplicate tags are
rejected at registration. Data enters as plain numpy.
"""

from __future__ import annotations

import queue
from typing import Dict, Tuple


class SensorConfigurationInvalid(Exception):
    pass


class SensorReceivedNoData(Exception):
    pass


class SensorInterface:
    def __init__(self, queue_timeout: float = 10.0):
        self._sensors: Dict[str, bool] = {}
        self._queue: "queue.Queue" = queue.Queue()
        self._queue_timeout = queue_timeout
        self._opendrive_tag = None

    # ---- registration ------------------------------------------------------ #

    def register_sensor(self, tag: str) -> None:
        if tag in self._sensors:
            raise SensorConfigurationInvalid(f"duplicated sensor tag [{tag}]")
        self._sensors[tag] = True

    def register_opendrive(self, tag: str) -> None:
        """Opendrive readings are consumed when present but never gate a tick."""
        self.register_sensor(tag)
        self._opendrive_tag = tag

    # ---- producer side ------------------------------------------------------ #

    def update_sensor(self, tag: str, data, frame: int) -> None:
        if tag not in self._sensors:
            raise SensorConfigurationInvalid(f"sensor [{tag}] not registered")
        self._queue.put((tag, frame, data))

    # ---- consumer side ------------------------------------------------------ #

    def get_data(self) -> Dict[str, Tuple[int, object]]:
        """Block until every gating sensor delivered one reading for the tick."""
        data_dict: Dict[str, Tuple[int, object]] = {}
        needed = set(self._sensors)
        try:
            while True:
                missing = needed - set(data_dict)
                if not missing:
                    break
                if self._opendrive_tag and missing == {self._opendrive_tag}:
                    break  # don't hold the tick for the 1 Hz map pseudo-sensor
                tag, frame, data = self._queue.get(True, self._queue_timeout)
                data_dict[tag] = (frame, data)
        except queue.Empty:
            missing = needed - set(data_dict)
            raise SensorReceivedNoData(
                f"sensor took too long to send data: missing {sorted(missing)}")
        return data_dict
