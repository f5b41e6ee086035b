"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload rnn_fig5.train --seed 7 \
        --seconds 20 --trace 0

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its limits are found by the names in ``BENCHMARK.json``; the last
line of standard output is the result as one JSON object, the last lines
of standard error each number compared beside its limit. Exits non-zero,
with no result, without enough CUDA cards, without the port, or when JAX
was loaded.
"""

import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.core.env import set_cache_env  # noqa: E402

set_cache_env(ROOT)

from portbench.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
