"""Helpers of the benchmark's CPU tests: a cell of the manifest cut to a
size a test run can hold (the CLI's resolution and passes, the checked
pixels, the warm-up), run on the CPU."""

from __future__ import annotations

import torch

from portbench import manifest
from portbench import run as bench


def tiny_cell(name: str, width: int = 40, height: int = 24, samples: int = 4,
              per_request: int = 2, pixels: int = 48) -> manifest.Cell:
    cell = manifest.Cell(name)
    cell.traffic["cli"].update(width=width, height=height, samples=samples)
    cell.traffic.update(passes_per_request=per_request, check_pixels=pixels,
                        warmup_requests=1, warmup_s=0.0, timed_requests=1,
                        traced_requests=1)
    return cell


def run_tiny(cell, seed: int = 2 ** 31 + 11) -> dict:
    """One untraced run of `cell` on the CPU: the harness's whole run but
    its look for a card."""
    torch.set_num_threads(2)
    return bench.run_cell(cell, seed, 0.0, False, "cpu")
