"""``BENCHMARK.json`` against the benchmark's contract, and the files each
of its names points to."""
import ast
import re
from pathlib import Path

import pytest

from gpubench.harness import HERE, find_cell, load_json

ROOT = HERE.parent
BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        lines = ("why", "layer", "source") if section == "configs" else ("why", "layer")
        for key in lines:
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_names_and_units_are_plain_ascii():
    text = (ROOT / "BENCHMARK.json").read_text(encoding="utf-8")
    for e in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert e["name"].isascii()
        assert e.get("unit", "").isascii()
    assert "\t" not in text


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for c in m.get("workloads", []):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", [c])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_configs():
    confs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        cell = find_cell(w["name"], False)
        mix = cell.mix
        assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
        assert (HERE / "checks" / f"{mix['check']}.py").is_file()
        assert cell.limits
        e2e = {m["name"] for m in find_cell(w["name"], False).metrics}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert find_cell(w["name"], True).metrics
    assert used == set(confs)
    files = [c["file"] for c in confs.values()]
    assert len(files) == len(set(files))
    for c in confs.values():
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).is_file()
        body = load_json(ROOT / c["file"])
        assert body["reduced"] == c["reduced"]
        assert c["source"].startswith("http")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_imports(path):
    """Top-level names compared whole: ``repro_torch`` is not ``repro``."""
    names = _imports(path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if "reference" in path.relative_to(HERE).parts:
        # plain torch and numpy, and nothing of the program or the harness
        assert names <= {"__future__", "numpy", "torch", "gpubench"}, names
        text = path.read_text(encoding="utf-8")
        assert set(re.findall(r"gpubench\.(\w+)", text)) <= {"reference"}
