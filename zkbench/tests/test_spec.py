"""BENCHMARK.json against the benchmark's contract, and the harness
finding every file by name: also one added in a copy, with no edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from zkbench import core

SPEC = core.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(SPEC) == KEYS["top"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            extra = set(entry) - KEYS[group] - ({"workloads"} if group in (
                "end_to_end", "per_layer") else set())
            assert set(entry) >= KEYS[group] and not extra, (group, entry["name"])
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(set(names)) == len(names)
    for e in SPEC[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group in ("configs", "workloads", "per_layer"):
                assert line(e[key]), (e["name"], key)
    for e in SPEC["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert e["chips"] in (1, 4)


def test_metrics_and_cells_agree():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = {w["name"] for w in SPEC["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for cell in cells:
        mine = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in SPEC["per_layer"] if cell in m.get("workloads", [cell])]
        assert layer and all(cell in e2e[m["moves"]].get("workloads", [cell]) for m in layer)
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


def test_paths_and_command():
    assert SPEC["paths"] == ["zkbench"]
    assert SPEC["command"][0] == "python3" and len(SPEC["command"]) <= 32
    for word in SPEC["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("zkbench/")


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = json.loads((core.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("zkbench/configs/")
    assert data["source"] == conf["source"] and data["reduced"] == conf["reduced"] == []
    params = core.params_of(data).validate()
    assert params.q == params.modulus // 2
    assert data["N"] & (data["N"] - 1) == 0


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_found_by_name(cell):
    found = core.find_cell(SPEC, cell)
    assert found.chips == next(w["chips"] for w in SPEC["workloads"] if w["name"] == cell)
    drv = core.load_module(core.HERE / "drivers" / f"{found.traffic['driver']}.py",
                           f"drivers.{found.traffic['driver']}")
    for attr in ("PROTOCOL", "COMMIT_RANGE", "VERIFY_RANGES", "make_inputs", "call", "run"):
        assert hasattr(drv, attr)
    for sub in ("reference", "roofline"):
        assert (core.HERE / sub / f"{drv.PROTOCOL}.py").is_file()
    for m in found.per_layer + found.end_to_end:
        reader = core.load_module(core.HERE / "metrics" / f"{m['name']}.py",
                                  f"metrics.{m['name']}")
        assert callable(reader.read)


@pytest.mark.parametrize("path", sorted((core.HERE / "drivers").glob("*.py")), ids=lambda p: p.stem)
def test_every_driver_loads(path):
    drv = core.load_module(path, f"drivers.{path.stem}")
    for attr in ("PROTOCOL", "COMMIT_RANGE", "VERIFY_RANGES", "VERDICTS", "make_inputs",
                 "input_fields", "setup", "local", "install", "call", "verified",
                 "verdict_fields", "sync", "tampered", "extra_checks", "run"):
        assert hasattr(drv, attr), attr


def test_missing_file_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "zkbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "zkbench" / "workloads" / "open-b131072.json").unlink()
    with pytest.raises(core.CellError):
        core.find_cell(core.load_spec(root), "open-n512-b131072", root)
    with pytest.raises(core.CellError):
        core.find_cell(core.load_spec(root), "no-such-cell", root)


def test_only_a_closed_loop_is_run(tmp_path):
    """A traffic mix that asks for another loop than the closed one the
    harness runs is refused, not run as a closed one."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "zkbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "zkbench" / "workloads" / "open-b131072.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), loop="open")))
    with pytest.raises(core.CellError):
        core.find_cell(core.load_spec(root), "open-n512-b131072", root)


def test_added_files_are_found_without_an_edit(tmp_path):
    """A new configuration, traffic mix, driver and per-layer metric, each
    a file plus an entry in BENCHMARK.json, reach a cell by name."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "zkbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    here = root / "zkbench"
    cfg = json.loads((here / "configs" / "rzk-default-n512.json").read_text())
    (here / "configs" / "rzk-default-n2048.json").write_text(json.dumps(dict(cfg, N=2048)))
    traffic = json.loads((here / "workloads" / "open-b131072.json").read_text())
    (here / "workloads" / "open-b2048.json").write_text(
        json.dumps(dict(traffic, batch=2048, driver="open_copy")))
    (here / "drivers" / "open_copy.py").write_text(
        (here / "drivers" / "open.py").read_text())
    (here / "metrics" / "launches.py").write_text("def read(obs):\n    return 1.0\n")
    spec["configs"].append(dict(spec["configs"][0], name="rzk-default-n2048",
                                file="zkbench/configs/rzk-default-n2048.json"))
    spec["workloads"].append({"name": "open-n2048-b2048", "config": "rzk-default-n2048",
                              "traffic": "open-b2048", "chips": 1, "why": "an added cell"})
    spec["per_layer"].append({"name": "launches", "unit": "1", "better": "lower",
                              "source": "program_counter", "layer": "kernels",
                              "moves": "proofs_per_s", "workloads": ["open-n2048-b2048"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = core.find_cell(core.load_spec(root), "open-n2048-b2048", root)
    assert cell.cfg["N"] == 2048 and cell.traffic["batch"] == 2048
    assert cell.traffic["driver"] == "open_copy"
    assert [m["name"] for m in cell.per_layer][-1] == "launches"
    assert "launches" not in [m["name"] for m in core.find_cell(
        core.load_spec(root), "open-n512-b131072", root).per_layer]
