"""BENCHMARK.json against the contract, and every file it names."""

import re

import pytest

from benchmark.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
MAN = common.manifest()


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(MAN["command"]) <= 32
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_their_keys_and_names(section, keys):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_cells_configs_and_chips():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    for w in MAN["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        used.add(w["config"])
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith(MAN["paths"][0] + "/")
        assert len(c["reduced"]) <= 16


def test_metrics_cover_the_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells

    def reports(cell, metric):
        return cell in e2e[metric].get("workloads", cells)

    for cell in cells:
        assert sum(reports(cell, m) for m in e2e) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in MAN["per_layer"])
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(cell, m["moves"]), m["name"]
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_every_cell_resolves_from_its_files(workload):
    cell = common.resolve_cell(workload)
    assert cell["traffic"]["kind"] in ("train", "serve")
    for m in cell["per_layer"]:
        assert (cell["metrics_dir"] / f"{m['name']}.py").exists()
    assert cell["limits"]
    for k, v in cell["limits"].items():
        assert NAME.match(k) and v >= 0


def test_files_under_paths_are_named_from_name_characters():
    for p in (common.ROOT / MAN["paths"][0]).rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        rel = p.relative_to(common.ROOT).as_posix()
        assert PATH.match(rel), rel
