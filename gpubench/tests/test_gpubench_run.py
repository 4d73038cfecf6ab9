"""The command line: no result without a card, without the program beside
it, or with the JAX package loaded; a short run of each cell on a card."""
import importlib.util
import json
import shutil
import subprocess
import sys

import pytest

from gpubench.harness import HERE, load_json

ROOT = HERE.parent
CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


def _run(cwd, workload="epinions-ppr-serve", seconds="2", extra=()):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", workload, "--seed", "4294967311",
         "--seconds", seconds, "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    spec = importlib.util.spec_from_file_location("gpubench_run", HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    monkeypatch.setitem(sys.modules, "repro.engine", object())
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def test_without_the_program_no_result(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(card, workload):
    p = _run(ROOT, workload, seconds="3")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "compared"
