"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness reads, relative to the checkout's root:

* the configuration's ``file`` (``chipbench/configs/<name>.json``), and
  the limits of its correctness check, ``chipbench/limits/<name>.json``;
* the tracker model the configuration names by its ``"model"`` key,
  ``chipbench/models/<model>.py``: the benchmark's frozen yardstick for
  the program that ``"entry"`` names (see below);
* the mix, ``chipbench/traffic/<traffic>.json``;
* one reader for each metric the cell reports: an end-to-end metric's in
  ``chipbench/end_to_end/<name>.py``, a per-layer metric's in
  ``chipbench/metrics/<name before the first dot>.py``, so that a metric
  split by the end-to-end metric it moves (``glue_ms.cam30``,
  ``glue_ms.edge``) has one reader.  A reader is a module with
  ``read(ctx) -> float | None``.

So a cell, a mix, a configuration, a model or a metric is added as new
files and entries; no file that is there changes.

A model is a module that the harness, the check and the readers use
through these names only, so that nothing outside it knows the tracker's
parameters, spheres or mask:

* ``frame_config(config) -> cfg``: the frame's sizes from the
  configuration file; ``cfg.draws_shape`` is one frame's PSO draws,
  (1 + G, 2, N, P) for P parameters;
* ``make_clip(traffic, cfg, generator) -> (depth (T, H, W), truth (T, P))``:
  the clip every client sees, its noise drawn from ``generator``;
* ``kept_pixels(cfg, depth, h_prev)``: how many pixels the frame scores,
  for frames ``depth`` (B, H, W) and their previous poses (B, P);
* ``Reference(cfg, device, dtype)``, keeping ``cfg``: the plain frame,
  ``frame(h_prev, depth, draws) -> (h_next, score)``, and its objective,
  ``score(h, h_prev, depth)``;
* ``solution_of(cfg, h_next, h_prev)``: the swarm's best pose that the
  frame's last step turned into ``h_next``;
* ``k1_ops(cfg, kept)`` and ``frame_ops(cfg, kept)``: the fp32
  operations of a frame's population evaluations (K1) and of the whole
  frame, over ``kept`` pixels.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from types import ModuleType
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
    model: ModuleType  # chipbench/models/<the configuration's "model">.py
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load(path: pathlib.Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _model(config: dict, path: pathlib.Path, root: pathlib.Path) -> ModuleType:
    """The model that the configuration read from ``path`` names.  Raises
    ``ValueError`` where it names none, or no valid name, and
    ``FileNotFoundError`` where the model has no file."""
    name = config.get("model")
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"the configuration {path} names no model: its \"model\" key is "
                         f"{name!r}, and has to name a file chipbench/models/<model>.py")
    model_path = root / HERE.name / "models" / f"{name}.py"
    if not model_path.exists():
        raise FileNotFoundError(f"the configuration {path} names the model {name!r}, "
                                f"which has no file {model_path}")
    return _load(model_path, f"chipbench_model_{name}")


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its files read and its model loaded.  Raises
    ``KeyError`` for a cell the benchmark does not name,
    ``FileNotFoundError`` for a missing file and ``ValueError`` for a
    configuration that names no model."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = root / HERE.name
    path = root / entry["file"]
    config = json.loads(path.read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        model=_model(config, path, root), traffic_name=w["traffic"],
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
    return _load(path, f"chipbench_reader_{kind}_{name}").read


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
