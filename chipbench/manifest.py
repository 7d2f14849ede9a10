"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness reads, relative to the checkout's root:

* the configuration's ``file`` (``chipbench/configs/<name>.json``), and
  the limits of its correctness check, ``chipbench/limits/<name>.json``;
* the mix, ``chipbench/traffic/<traffic>.json``;
* one reader for each metric the cell reports: an end-to-end metric's in
  ``chipbench/end_to_end/<name>.py``, a per-layer metric's in
  ``chipbench/metrics/<name before the first dot>.py``, so that a metric
  split by the end-to-end metric it moves (``glue_ms.cam30``,
  ``glue_ms.edge``) has one reader.  A reader is a module with
  ``read(ctx) -> float | None``.

So a cell, a mix, a configuration or a metric is added as new files and
entries; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from typing import Callable, Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its files read.  Raises ``KeyError`` for a
    cell the benchmark does not name and ``FileNotFoundError`` for a
    missing file."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = root / HERE.name
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((root / config["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((pkg / "limits" / f"{w['config']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader_path(kind: str, name: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    """The reader of metric ``name``; ``kind`` is ``end_to_end`` or
    ``per_layer``."""
    pkg = root / HERE.name
    if kind == "end_to_end":
        return pkg / "end_to_end" / f"{name}.py"
    return pkg / "metrics" / f"{name.split('.')[0]}.py"


def reader(kind: str, name: str, root: pathlib.Path = ROOT) -> Callable:
    path = reader_path(kind, name, root)
    if not path.exists():
        raise FileNotFoundError(f"no reader for the metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"chipbench_reader_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def problems(bench: dict) -> List[str]:
    """What in ``bench`` breaks the rules on names and units."""
    out = []
    named = ([("configs", c) for c in bench["configs"]]
             + [("workloads", w) for w in bench["workloads"]]
             + [(k, m) for k in ("end_to_end", "per_layer") for m in bench[k]])
    for kind, entry in named:
        if not NAME.fullmatch(entry["name"]):
            out.append(f"{kind}: name {entry['name']!r}")
        if "unit" in entry and not UNIT.fullmatch(entry["unit"]):
            out.append(f"{kind}: unit {entry['unit']!r} of {entry['name']!r}")
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.fullmatch(w[key]):
                out.append(f"workloads: {key} {w[key]!r} of {w['name']!r}")
    for c in bench["configs"]:
        out += [f"configs: reduced key {k!r}" for k in c["reduced"] if not NAME.fullmatch(k)]
    return out
