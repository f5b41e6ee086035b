"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each configuration is ``portbench/configs/<config>.json`` with its
plain reference ``portbench/reference/<config>.py``; each mix is
``portbench/traffic/<traffic>.json``; each cell's limits are
``portbench/limits/<cell>.json``; each per-layer metric's reader is
``portbench/metrics/<metric>.py``. The configuration's ``family`` names
``portbench/families/<family>.py`` and the mix's ``loop`` names
``portbench/loops/<loop>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE_RE = re.compile(r"[^\n\r\t]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclass
class Cell:
    """One cell with everything found by its names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the entries of the metrics this cell reports
    per_layer: list


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``;
    an end-to-end metric without that key (``setup_s``) in every cell.
    Every per-layer metric lists its cells."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = load_bench(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = json.loads((Path(root) / entry["file"]).read_text())
    config["name"] = entry["name"]
    traffic = json.loads(
        (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["name"] = w["traffic"]
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def family(config: dict):
    return importlib.import_module(f"portbench.families.{config['family']}")


def loop(traffic: dict):
    return importlib.import_module(f"portbench.loops.{traffic['loop']}")


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config: dict):
    """The configuration's plain reference module."""
    name = config["name"]
    return _load_file(BENCH / "reference" / f"{name}.py",
                      "portbench.reference._" + name.replace(".", "_")
                      .replace("-", "_"))


def reader(metric: str):
    """The per-layer metric's reader: a module with ``read(record)``."""
    return _load_file(BENCH / "metrics" / f"{metric}.py",
                      "portbench.metrics._" + metric.replace(".", "_")
                      .replace("-", "_"))
