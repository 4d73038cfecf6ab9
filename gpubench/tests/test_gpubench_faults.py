"""Whole runs on the CPU at a small size, through the harness below its
look for a card: a sound run is correct, and each fault the cells can have,
planted under the timed path, makes it incorrect. (One card holds every
cell, so no cell has an exchange between chips to leave out.)"""
import importlib

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.harness import load_json, HERE

CELLS = [w["name"] for w in load_json(HERE.parent / "BENCHMARK.json")["workloads"]]


def _run(cell, trace=False):
    return harness.run(cell, 2**32 + 17, 2.0, trace, t0=0.0, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    out = _run(small_cell(name))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_metrics(small_cell, name):
    out = _run(small_cell(name, trace=True), trace=True)
    assert out["correct"]
    assert "rounds_per_query" in out["metrics"] and "order_s" in out["metrics"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    # no card here: the device's readings are absent, never 0
    assert "sweep_roofline_pct" not in out["metrics"]
    assert "device_idle_pct" not in out["metrics"]


def _unchanged(real):
    def step(*a, **k):
        x, dirty = a[9], a[4]
        d = x.shape[1]
        return (x, torch.zeros((k["sweeps"], d)), torch.zeros((k["sweeps"], 1)),
                torch.as_tensor(dirty))
    return step


def _half(real):
    def step(*a, **k):
        before = a[9].clone()
        x, deltas, active, dirty = real(*a, **k)
        h = x.shape[1] // 2
        x[:, h:] = before[:, h:]
        deltas[:, h:] = 0.0
        return x, deltas, active, dirty
    return step


def _altered_answer(x: np.ndarray, check: str) -> None:
    """One entry of each answer moved by 1e-3: the largest score of a PPR
    answer, the source (distance 0) of an SSSP one."""
    cols = x.reshape(x.shape[0], -1)
    for j in range(cols.shape[1]):
        i = np.argmax(cols[:, j]) if check == "ppr" else np.argmin(cols[:, j])
        cols[i, j] += 1e-3


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_incorrect(small_cell, monkeypatch, name, fault):
    import repro_torch.engine.async_block as ab
    from repro_torch.serving.server import GraphServer

    # the package exports the entry point under the module's name
    gs = importlib.import_module("repro_torch.kernels.gs_sweep")

    cell = small_cell(name)
    if fault in ("unchanged", "half"):
        make = {"unchanged": _unchanged, "half": _half}[fault]
        monkeypatch.setattr(gs, "gs_multisweep", make(gs.gs_multisweep))
    elif cell.mix["driver"] == "serve_closed_loop":
        real = GraphServer._resolve

        def resolve(self, fam, j, t, converged):
            real(self, fam, j, t, converged)
            t.result = t.result.copy()
            _altered_answer(t.result, cell.mix["check"])

        monkeypatch.setattr(GraphServer, "_resolve", resolve)
    else:
        real = ab._solve

        def solve(algo, o):
            res = real(algo, o)
            _altered_answer(res.x, cell.mix["check"])
            return res

        monkeypatch.setattr(ab, "_solve", solve)
    out = _run(cell)
    assert not out["correct"], out["compared"]
