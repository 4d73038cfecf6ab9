"""A configuration, a traffic mix, a check and a metric added as files,
with their entries in ``BENCHMARK.json``, are found by name."""
import json
import shutil

from gpubench.harness import HERE, find_cell, load_json, load_module


def test_added_files_are_found(tmp_path):
    base = tmp_path / "gpubench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load_json(HERE.parent / "BENCHMARK.json")
    (base / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "graph": {"generator": "road_lattice", "vertices": 100, "cols": 10,
                                   "arcs": 300, "weight_lo": 1, "weight_hi": 9},
         "algorithms": {"sssp": {}}, "deployment": {}, "reduced": []}))
    (base / "traffic" / "open-mix.json").write_text(json.dumps(
        {"driver": "new_driver", "algo": "sssp", "check": "new_check", "sources": "permutation"}))
    (base / "limits" / "tiny-open.json").write_text(json.dumps({"new_number": 0}))
    (base / "drivers" / "new_driver.py").write_text("def run(ctx):\n    return 'driven'\n")
    (base / "checks" / "new_check.py").write_text("NAME = 'new_number'\n")
    (base / "metrics" / "hops.tiny.py").write_text("def read(rec):\n    return rec['hops']\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "gpubench/configs/tiny.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-open", "config": "tiny", "traffic": "open-mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "hops.tiny", "unit": "hops", "better": "lower",
                               "source": "program_counter", "layer": "sweep engine",
                               "moves": "queries_per_s", "workloads": ["tiny-open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell("tiny-open", True, base=base)
    assert cell.config["name"] == "tiny" and cell.mix["driver"] == "new_driver"
    assert cell.limits == {"new_number": 0}
    assert [m["name"] for m in cell.metrics] == ["hops.tiny"]
    assert load_module("drivers", cell.mix["driver"], base).run(None) == "driven"
    assert load_module("checks", cell.mix["check"], base).NAME == "new_number"
    assert load_module("metrics", "hops.tiny", base).read({"hops": 3}) == 3
    # the cells that were there still resolve, with their own files
    old = find_cell("epinions-ppr-serve", False, base=base)
    assert old.mix["driver"] == "serve_closed_loop"
