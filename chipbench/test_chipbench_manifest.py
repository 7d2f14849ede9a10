"""``BENCHMARK.json`` against the rules it is held to, and the files it
names found by name; a cell, a mix or a metric is added as new files and
entries, with no file that is there edited."""

import hashlib
import json
import pathlib
import re
import shutil

import pytest

from chipbench import manifest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = manifest.load_benchmark(ROOT)
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
LINE = re.compile(r"[^\n\t]{1,200}")


def test_top_level_and_entry_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for kind, keys in KEYS.items():
        for entry in BENCH[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (kind, entry["name"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    assert manifest.problems(BENCH) == []
    for kind in KEYS:
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert LINE.fullmatch(entry["why"])
    for c in BENCH["configs"]:
        assert LINE.fullmatch(c["source"]) and len(c["reduced"]) <= 16
    for m in BENCH["per_layer"]:
        assert LINE.fullmatch(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert manifest.problems({**BENCH, "workloads": [{**BENCH["workloads"][0],
                                                      "name": "has space"}]})


def test_command_paths_run_seconds_and_bounds():
    assert BENCH["command"][:2] == ["python3", "chipbench/run.py"]
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
               for p in BENCH["paths"])
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    assert 24 * 2 * 90 + (2 + 14 * 24) * (seconds + 60) + 1200 <= 43200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = manifest.load_cell(w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported and m["moves"] in e2e, (w["name"], m["name"])
        assert w["chips"] == 1


def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        cell = manifest.load_cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) == {"score_gap", "optimum_gap", "optimum_gap_mean"}
        for kind, metrics in (("end_to_end", cell.end_to_end), ("per_layer", cell.per_layer)):
            for m in metrics:
                assert callable(manifest.reader(kind, m["name"], ROOT))
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    with pytest.raises(KeyError):
        manifest.load_cell("no.such.cell", ROOT)


def test_both_configurations_load_the_one_hand_model():
    for w in BENCH["workloads"]:
        cell = manifest.load_cell(w["name"], ROOT)
        assert cell.config["model"] == "one_hand", w["name"]
        assert pathlib.Path(cell.model.__file__) == ROOT / "chipbench/models/one_hand.py"
        assert callable(cell.model.frame_config) and callable(cell.model.Reference)


@pytest.mark.parametrize("model, error", [(None, ValueError), ("no_such_model", FileNotFoundError),
                                          ("../configs/x", ValueError)],
                         ids=["no_model_key", "missing_model_file", "not_a_name"])
def test_a_configuration_that_names_no_model_file_is_refused_at_load(tmp_path, model, error):
    config = json.loads((ROOT / "chipbench/configs/hand128-64x30.json").read_text())
    del config["model"]
    if model is not None:
        config["model"] = model
    path = tmp_path / "chipbench/configs/hand128-64x30.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(config))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    with pytest.raises(error) as raised:
        manifest.load_cell("hand128.cam30", tmp_path)
    message = str(raised.value)
    assert str(path) in message
    if error is ValueError:
        assert '"model"' in message
    else:
        assert str(tmp_path / "chipbench/models/no_such_model.py") in message


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_a_mix_and_a_metric_are_added_as_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    mix = json.loads((tmp_path / "chipbench/traffic/edge16.json").read_text())
    (tmp_path / "chipbench/traffic/edge64.json").write_text(json.dumps({**mix, "clients": 64}))
    (tmp_path / "chipbench/metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.frames))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "hand128.edge64", "config": "hand128-64x30",
                               "traffic": "edge64", "chips": 1, "why": "64 clients"})
    for m in bench["end_to_end"]:
        if m["name"] == "tracked_fps":
            m["workloads"].append("hand128.edge64")
    bench["per_layer"].append({"name": "frames_seen.edge64", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "graph replay", "moves": "tracked_fps",
                               "workloads": ["hand128.edge64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.load_cell("hand128.edge64", tmp_path)
    assert cell.traffic["clients"] == 64
    assert {m["name"] for m in cell.end_to_end} == {"tracked_fps", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.edge64"]
    assert manifest.reader("per_layer", "frames_seen.edge64", tmp_path)(
        type("Ctx", (), {"frames": [1, 2, 3]})) == 3.0
    after = _digest(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {pathlib.Path("BENCHMARK.json")}
