"""A toy entry for the harness's tests: a request answers with a number
that follows from the seed and the request's count, and the entry's own
check works it out again. The traffic's `fault` is added to every answer
(0 by default)."""

from __future__ import annotations


def answer(seed: int, n: int) -> float:
    return float((seed * 31 + n) % 97)


def check(cell, text: str, adir: str, seed: int, outputs: list,
          device: str) -> list:
    return [{"err": abs(got - answer(seed, n))} for n, got in outputs]


class Entry:
    paths = 1

    def __init__(self, scene_text: str, asset_dir: str, traffic: dict,
                 seed: int, device: str = "cpu"):
        self.fault = float(traffic.get("fault", 0.0))
        self.seed = seed
        self.n = 0

    def setup(self, capture_timer) -> dict:
        return {}

    def request(self) -> tuple:
        self.n += 1
        return self.n, answer(self.seed, self.n) + self.fault

    def install_spans(self, spans) -> None:
        pass

    @staticmethod
    def lanes(spans) -> int:
        return 0

    @staticmethod
    def launches(spans) -> int:
        return 0

    def close(self) -> None:
        pass
