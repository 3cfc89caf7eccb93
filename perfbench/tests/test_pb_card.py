"""On the card, at each one-card cell's own sizes with a short window: the
program's run is correct, and each control (the reference in the next
lower precision) comes out not correct.  Skipped without a card; run
them with

    python -m pytest -m cuda perfbench/tests/test_pb_card.py
"""

import pytest
import torch

from perfbench import harness

ONE_CARD = ["spalign-slic.mem", "segnet-basic.files"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_program_correct_and_control_not(card, workload):
    out = harness.run_cell(workload, 2 ** 32 + 11, 3.0, False,
                           readings=True)
    assert out["correct"] is True
    limits = harness.cell_spec(harness.benchmark(), workload)["limits"]
    reads = out["readings"]
    control = reads["tf32"] if "tf32" in reads else reads
    assert any(control[k] > limits[k] for k in limits if k in control)
