"""Runs of the harness with the timed path broken underneath come out not
correct: a step that leaves the state unchanged, a step that sees half of
each batch, a BatchNorm that leaves its running moments alone, and a
propagation whose answer is altered where it is made
(half of the draws, or the draws' latents scaled).  One card runs the
cells, so no exchange between cards can be left out."""

from __future__ import annotations

import pytest

from portbench import calibrate
from portbench.families import cglow, denseed


def _plant(monkeypatch, cls, fault):
    init = cls.__init__

    def planted(self, *a, **k):
        init(self, *a, **k)
        fault(self)

    monkeypatch.setattr(cls, "__init__", planted)


def _half_draws(prog):
    prog.surrogate.n_samples //= 2


def _altered(prog):
    prog.surrogate.temperature = 0.95


@pytest.mark.parametrize("fault", [calibrate._unchanged,
                                   calibrate._half_batch,
                                   calibrate._frozen_moments])
@pytest.mark.parametrize("cell,family", [("codec-sobel-train", denseed),
                                         ("cglow-revkl-train", cglow)])
def test_training_fault_is_not_correct(tiny_run, no_forbidden, monkeypatch,
                                       cell, family, fault):
    _plant(monkeypatch, family.Train, fault)
    rc, out = tiny_run(cell)
    assert rc == 0 and out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [_half_draws, _altered])
def test_propagation_fault_is_not_correct(tiny_run, no_forbidden,
                                          monkeypatch, fault):
    _plant(monkeypatch, cglow.Propagate, fault)
    rc, out = tiny_run("cglow-uq-propagate")
    assert rc == 0 and out["correct"] is False, out["checks"]


def test_sound_run_is_correct(tiny_run, no_forbidden):
    rc, out = tiny_run("cglow-revkl-train")
    assert rc == 0 and out["correct"] is True
