"""The comparison's control on the card, at each cell's own size: one
seed's short window, where the program's readings must pass the cell's
limits and the reference computed in fp8, put in the program's place,
must fail one of them. ``perfbench/control.py`` reads the same over a
dozen seeds (the readings ``perfbench/limits`` were set from).

Run on the card: ``python -m pytest -m gpu perfbench/tests`` (about 3 minutes;
the kernels build into ``build/kernels`` first)."""
from __future__ import annotations

import pytest

from perfbench import harness

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the cell at its "
                    "own size through the hand kernels")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    from perfbench.control import readings
    r = readings(cell, 2 ** 31 + 99, 1.0, True)
    limits = harness.load_cell(cell).limits
    assert r["correct"], r["program"]
    assert any(v is None or v > limits[k]["limit"]
               for k, v in r["control"].items()), (r["control"], limits)
