"""The port imports neither jax nor any module of the reference package."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_port_modules_listed():
    assert "repro_torch" in MODULES
    assert "repro_torch.kernels.gs_sweep" in MODULES
    assert "repro_torch.engine.api" in MODULES
    for name in ("engine.push", "engine.incremental", "graphs.delta",
                 "kernels.push_scatter", "kernels.bsr_spmm", "serving.server",
                 "serving.scheduler", "serving.cache", "serving.stats",
                 "obs.metrics", "engine.distributed", "graphs.io",
                 "kernels.budgets", "interop", "models", "models.layers",
                 "models.attention", "models.blocks", "models.transformer",
                 "models.model", "models.moe", "models.recurrent", "models.encdec",
                 "configs"):
        assert f"repro_torch.{name}" in MODULES
    for arch in ("olmo_1b", "deepseek_7b", "gemma_7b", "gemma3_4b", "internvl2_76b",
                 "qwen2_moe_a2_7b", "granite_moe_1b_a400m", "xlstm_350m",
                 "whisper_tiny", "recurrentgemma_2b"):
        assert f"repro_torch.configs.{arch}" in MODULES


def test_import_without_jax_loads_no_reference_module():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None        # any import of jax now fails
        sys.modules["jaxlib"] = None
        for name in {MODULES!r}:
            importlib.import_module(name)
        import repro_torch
        for name in repro_torch.__all__:
            getattr(repro_torch, name)
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("ok", len({MODULES!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_source_imports_no_jax_or_reference(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_chip_smoke_imports_no_jax_or_reference():
    roots = _imported_roots(SRC.parent / "chip_smoke.py")
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_lazy_surface_resolves():
    import repro_torch

    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None
    with pytest.raises(AttributeError):
        repro_torch.not_a_name  # noqa: B018


def test_kernel_build_dir(monkeypatch, tmp_path):
    """A checkout builds into its own ``build/repro_torch``; an installed
    package into a per-user cache, never beside ``site-packages``."""
    from repro_torch.kernels import _build

    assert _build.BUILD_DIR == SRC.parent / "build" / "repro_torch"
    monkeypatch.setattr(_build, "CSRC", tmp_path / "site-packages" / "repro_torch" / "csrc")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir() == tmp_path / "cache" / "repro_torch"
