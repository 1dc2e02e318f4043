"""Hang detector (srunner/scenariomanager/watchdog.py:21-80 semantics):
a timer that must be petted via ``update()``; expiry marks failure and invokes
an optional callback (the reference interrupts the main thread).

The port's own copy of the JAX package's ``harness/watchdog.py``."""

from __future__ import annotations

import threading
from typing import Callable, Optional


class Watchdog:
    def __init__(self, timeout: float = 1.0,
                 on_timeout: Optional[Callable[[], None]] = None):
        self._timeout = timeout + 1.0  # detection headroom, like the reference
        self._on_timeout = on_timeout
        self._failed = False
        self._timer: Optional[threading.Timer] = None
        self._watching = False

    def start(self) -> None:
        self._watching = True
        self._failed = False
        self._arm()

    def update(self) -> None:
        if self._watching:
            self._disarm()
            self._arm()

    def stop(self) -> None:
        self._watching = False
        self._disarm()

    def get_status(self) -> bool:
        return not self._failed

    # ---- internals ----
    def _arm(self) -> None:
        self._timer = threading.Timer(self._timeout, self._expired)
        self._timer.daemon = True
        self._timer.start()

    def _disarm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _expired(self) -> None:
        self._failed = True
        self._watching = False
        if self._on_timeout is not None:
            self._on_timeout()
