"""With the timed path broken underneath, a run's ``correct`` comes out
false: each fault a cell can have, planted in the port in every rank
process (``tests/faults.py``), through the launch, the loop, the check
and the line of a tiny CPU run."""

import pytest

from joinbench.tests import cpu_run

FAULTS = [
    ("tpch_sf12_5.q3", "query_half_lines"),
    ("tpch_sf12_5.q3", "query_altered_answer"),
    ("ref_synth_100m.k4", "join_half_probe"),
    ("ref_synth_100m.k4", "join_no_exchange"),
    ("ref_synth_100m.k4", "join_altered_answer"),
    ("ref_synth_100m.k4", "join_swapped_lanes"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_makes_the_run_incorrect(cell, fault):
    line = cpu_run.run_in_subprocess(cell, fault=fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", sorted({c for c, _ in FAULTS}))
def test_the_same_run_without_a_fault_is_correct(cell):
    assert cpu_run.run_in_subprocess(cell)["correct"] is True
