"""A run at a small size on the CPU: sound, it comes out correct; with the
timed path broken underneath, once for each fault a cell can have, it
comes out not correct. (The look for a card is skipped: these drive
``harness.run_cell`` on the CPU, where the port runs its plain versions.)
"""

import pytest

from portbench import faults
from portbench.core import spec
from portbench.tests.small import run_small, small_cell


@pytest.mark.parametrize("cell", ["rnn_fig5.train", "seq2seq_ref.train",
                                  "rnn_fig5.eval", "rnn_fig5.stream"])
def test_sound_small_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", ["rnn_fig5.train", "rnn_fig5.stream"])
def test_traced_small_run_is_correct(cell):
    out = run_small(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["breakdown"]["idle_gaps"]


CASES = [(cell, kind, fault)
         for cell, kind in (("rnn_fig5.train", "train"),
                            ("seq2seq_ref.train", "train"),
                            ("rnn_fig5.eval", "eval"),
                            ("rnn_fig5.stream", "stream"))
         for fault in faults.KINDS[kind]]


@pytest.mark.parametrize("cell,kind,fault", CASES)
def test_every_fault_fails(cell, kind, fault):
    fam = spec.family(small_cell(cell).config)
    with faults.planted(fam, kind, fault):
        out = run_small(cell)
    assert not out["correct"], out["checks"]
