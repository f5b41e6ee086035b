"""The cells at sizes a CPU test run holds: every width cut, the traffic
cut to a few rows; the loops, the references and the limits as they are."""

from __future__ import annotations

import time

from portbench.core import harness, spec

CONFIG = {
    "rnn_fig5": {"in_channels": 6, "hidden": 16},
    "seq2seq_ref": {"in_channels": 5, "n_filters": 8, "hidden": 12,
                    "kernel_size": 4},
}
TRAFFIC = {
    "train": {"pool_rows": 40, "batch_rows": 16, "profile_steps": 2},
    "eval": {"pool_batches": 2, "batch_rows": 12, "profile_steps": 2},
    "stream": {"warm_bins": 20, "profile_bins": 20},
}
T = {"rnn_fig5": 60, "seq2seq_ref": 20}


# a cell whose loop, reference, limits and readers stand ready, but which
# BENCHMARK.json does not hold: its tail held no bound
WAITING = [{"name": "rnn_fig5.stream", "config": "rnn_fig5",
            "traffic": "stream_5ms", "chips": 1}]


def small_cell(name: str):
    bench = spec.load_bench()
    bench["workloads"] = bench["workloads"] + WAITING
    cell = spec.load_cell(name, bench=bench)
    cfg, tr = cell.config, cell.traffic
    cfg.update(CONFIG[cfg["name"]])
    tr.update(TRAFFIC[tr["loop"]])
    if "T" in tr:
        tr["T"] = T[cfg["name"]]
    if cfg["name"] == "seq2seq_ref":
        tr["batch_rows"] = tr["pool_rows"]
    return cell


def run_small(name: str, seed: int = 3, seconds: float = 0.3,
              trace: bool = False) -> dict:
    import torch

    return harness.run_cell(small_cell(name), seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter())
