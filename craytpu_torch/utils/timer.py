"""Wall-clock timers (equivalent of utils/timer.c)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def get_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def get_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6


def sleep_msec(ms: float) -> None:
    time.sleep(ms / 1e3)
