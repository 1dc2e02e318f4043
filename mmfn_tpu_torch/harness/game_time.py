"""Simulation clock (srunner/scenariomanager/timer.py:17-158 semantics):
a process-wide clock advanced once per simulator tick from snapshot
timestamps; consumers read time/frame without touching the simulator. The
port's own copy of the JAX package's ``harness/game_time.py``."""

from __future__ import annotations


class GameTime:
    _current_game_time = 0.0
    _last_frame = 0
    _init = False

    @staticmethod
    def on_carla_tick(timestamp) -> None:
        """timestamp: object with .frame and .elapsed_seconds, or (frame, t)."""
        frame = getattr(timestamp, "frame", None)
        elapsed = getattr(timestamp, "elapsed_seconds", None)
        if frame is None:
            frame, elapsed = timestamp
        if GameTime._last_frame < frame:
            GameTime._init = True
            GameTime._last_frame = frame
            GameTime._current_game_time = elapsed

    @staticmethod
    def restart() -> None:
        GameTime._current_game_time = 0.0
        GameTime._last_frame = 0
        GameTime._init = False

    @staticmethod
    def get_time() -> float:
        return GameTime._current_game_time

    @staticmethod
    def get_frame() -> int:
        return GameTime._last_frame
