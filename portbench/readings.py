"""The readings a cell's limits are set from, many seeds in one process.

    python3 portbench/readings.py --workload rnn_fig5.train \
        --seeds 101,102,103 --control-seeds 101,102,103 --seconds 2

For each seed: the cell's set-up, a window of ``--seconds`` at the cell's
own load (none for a training cell, whose checked steps are taken in
set-up), then the numbers compared, program against reference; for each
control seed also the control's numbers (the reference one precision
below, TF32, in the program's place). With ``--fault``, the same with
that fault planted in the program (``portbench/faults.py``). One JSON
line a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.core.env import set_cache_env  # noqa: E402

set_cache_env(ROOT)


def main(argv) -> int:
    import torch

    from portbench import faults
    from portbench.core import harness, spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.load_cell(args.workload)
        run = harness.Run(cell, seed, args.seconds, dev)
        kind = cell.traffic["loop"]
        t0 = time.perf_counter()
        with (faults.planted(run.fam, kind, args.fault) if args.fault
              else contextlib.nullcontext()):
            run.loop.setup(run)
            if kind != "train":
                run.loop.window(run, args.seconds)
        run.loop.release(run)
        out = {"seed": seed, "fault": args.fault, "failed": run.failed,
               "program": run.loop.numbers(run)}
        if seed in ctl:
            out["control"] = run.loop.control_numbers(run)
        out["notes"] = run.notes
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(harness.finite(out)), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
