"""A run with the timed path broken underneath comes out not ``correct``:
the harness's whole run on the CPU (no look for a card), at the cell's own
clip, widths and capacities with a short window (the harness finishes the
cut session after it, so that its map is judged), once sound and once
under each fault of ``faults.py``.  ``ba_unchanged`` and ``semantic_off``
run on seed 1 (start 30 degrees), where the card's readings showed them
failing (on seed 0 no number separates either: PERF.md section 2);
``semantic_off`` runs in the flagship cell, the one with bundles.  The
control, TF32 in place of the configuration's float32, needs the card.

Slow on the CPU (about three minutes a run): ``python -m pytest
slambench/tests/test_slambench_faults.py -n 2``."""

import pytest

from slambench import cells, faults, run

CELL = "icl_mono_points.walk"
CASES = {"ba_unchanged": (CELL, 1), "semantic_off": ("icl_mono_flagship.walk", 1)}


def measure(device="cpu", seconds=30.0, precision="", cell=CELL, seed=7):
    import torch

    torch.set_num_threads(4)
    return run.measure(cells.find_cell(cells.load_benchmark(), cell), seed, seconds, False, device, precision,
                       setup={})


def test_sound_run_is_correct():
    result, earlier = measure()
    assert result["correct"], result["checks"]
    assert earlier["poses_in_window"] > 5


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    cell, seed = CASES.get(fault, (CELL, 7))
    with faults.FAULTS[fault]():
        result, _ = measure(cell=cell, seed=seed)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_control_tf32_is_not_correct(cuda_device):
    """The control on the card at the cell's own clip: one precision below
    the configuration's float32."""
    result, earlier = measure(device=cuda_device, seconds=20.0, precision="tf32")
    assert earlier["precision"] == "tf32"
    assert not result["correct"], result["checks"]
