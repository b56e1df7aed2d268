"""The output check against its control and against faults planted in
the program under a tiny cell on the CPU.

The control is the reference computed in bfloat16 in the program's
place: the check has to reject it. Each fault of ``faults.py`` breaks
the timed path underneath a run that skips the harness's look for a
card, and the run has to come out not correct: the pyramid step
returning its input; half of the views left out of a score's weighted
mean; one seeded patch's score altered where it is produced; a
propagation that leaves the patch table unchanged; half of a round's
hypotheses left out of the gauntlet. The exchange between cards has no
place in one-card cells.
"""

import time

import pytest
import torch

from mvsbench import control, faults, run
from mvsbench.tests.tiny import tiny_cell

SEED = 977


def test_control_is_rejected_and_program_passes():
    cell = tiny_cell("dino16.sphere2")
    r = control.readings(cell, SEED, torch.device("cpu"))
    lim = cell["limits"]
    assert all(run.passes(r["program"][k], lim[k]) for k in r["program"])
    assert not run.passes(r["control"]["pyramid_gap"], lim["pyramid_gap"])
    assert r["control"]["seed_ncc_gap"] > 3 * max(r["program"]["seed_ncc_gap"], 1e-6)
    assert not run.passes(r["control"]["seed_ncc_gap"], lim["seed_ncc_gap"])


@pytest.mark.cuda
def test_control_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    cell = tiny_cell()
    cell["config"]["engine"]["use_pallas"] = True
    r = control.readings(cell, SEED, torch.device("cuda", 0))
    assert run.passes(r["program"]["seed_ncc_gap"], cell["limits"]["seed_ncc_gap"])
    assert not run.passes(r["control"]["seed_ncc_gap"], cell["limits"]["seed_ncc_gap"])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(fault):
    cell = tiny_cell()
    with faults.planted(fault):
        res = run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if not run.passes(c["value"], cell["limits"][k])]
    assert failed, res["checks"]


def test_faults_restored():
    """A planted fault leaves the program as it was once its block ends."""
    from mvskit_tpu_torch.pipeline import propagate as ppr

    before = ppr.propagate_round
    with faults.planted("propagation_unchanged"):
        assert ppr.propagate_round is not before
    assert ppr.propagate_round is before


def test_control_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("the card is there: this case is for a machine without one")
    assert control.main(["--workload", "dino16.plane", "--seeds", "1"]) == 2
    assert capsys.readouterr().out == ""
