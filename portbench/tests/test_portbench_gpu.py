"""On a CUDA card: each cell end to end through ``portbench/run.py``, and
the control (the reference one precision below, TF32, in the port's
place) failing a small cell's limits where the port passes them. Each
test decides inside itself whether there is a card and skips without one.

    python -m pytest portbench/tests -m gpu -q
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench.core import harness, spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.load_bench()["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 17), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    names = {m["name"] for m in spec.load_cell(cell).end_to_end}
    assert set(res["metrics"]) == names


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_port_passes(cell):
    from portbench.tests.small import small_cell

    dev = _card()
    c = small_cell(cell)
    run = harness.Run(c, 11, 0.3, dev)
    t0 = time.perf_counter()
    run.loop.setup(run)
    if c.traffic["loop"] != "train":
        run.loop.window(run, 0.3)
    run.loop.release(run)
    port = run.loop.numbers(run)
    ctl = run.loop.control_numbers(run)
    assert all(port[k] <= c.limits[k] for k in c.limits), port
    assert any(ctl[k] > c.limits[k] for k in c.limits), ctl
    assert time.perf_counter() - t0 < 300
