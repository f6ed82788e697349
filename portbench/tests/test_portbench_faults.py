"""The timed path broken underneath: a run (all but the look for a card)
must come out not correct for each fault a render cell can have. No
exchange between cards exists in a one-card cell."""

from __future__ import annotations

import pytest
import torch

from portbench_tiny import run_tiny, tiny_cell

CELLS = ["highpoly_render", "instances_render"]


def _scatter_patch(monkeypatch, fn):
    from craytpu_torch.models import wavefront_pt as wp
    orig = wp._scatter_add
    monkeypatch.setattr(wp, "_scatter_add",
                        lambda final, lane, delta: fn(orig, final, lane,
                                                      delta))


@pytest.mark.parametrize("cell", CELLS)
def test_step_returns_state_unchanged(cell, monkeypatch):
    """Each bounce hands back its rays, throughput and radiance as it got
    them (the paths then end)."""
    from craytpu_torch.models.wavefront_pt import WavefrontRenderer

    def step(self, o, d, weight, final, s, alive, rr_active, *a, **k):
        return o, d, weight, final, s, torch.zeros_like(alive)
    monkeypatch.setattr(WavefrontRenderer, "_step", step)
    assert run_tiny(tiny_cell(cell))["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    """Every other path's radiance dropped at the flush, the rest counted
    twice: the mean over the half that is left."""
    def half(orig, final, lane, delta):
        keep = torch.arange(delta.shape[0]) % 2 == 0
        orig(final, lane[keep], 2.0 * delta[keep])
    _scatter_patch(monkeypatch, half)
    assert run_tiny(tiny_cell(cell))["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    """Each path's radiance off by one part in 2^16 where it enters the
    framebuffer."""
    def nudge(orig, final, lane, delta):
        orig(final, lane, delta * (1.0 + 2.0 ** -16))
    _scatter_patch(monkeypatch, nudge)
    assert run_tiny(tiny_cell(cell))["correct"] is False
