"""The Hopper resource budgets of the port's CUDA kernels
(`repro_torch.kernels.budgets`), checked without a card: the table against
the ``__global__`` functions of ``csrc/*.cu`` in both directions (the
counterpart of the reference's PL002), every budget against what an H100
gives, the declared dynamic shared memory against the sources' formulas,
and the ptxas-report check on a fixed sample in ``nvcc -Xptxas -v`` form
(taken from an sm_90a build of these sources), over budget and spilling
variants included. The card side is ``chip_smoke.py``'s build phase."""
import dataclasses
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import budgets as B  # noqa: E402

CSRC = Path(B.__file__).resolve().parent.parent / "csrc"

SAMPLE = {
    "push_scatter.cu": """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z19push_scatter_kernelILi3EEv4Args' for 'sm_90a'
ptxas info    : Function properties for _Z19push_scatter_kernelILi3EEv4Args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 48128 bytes smem
ptxas info    : Compile time = 106.816 ms
ptxas info    : Compiling entry function '_Z19push_scatter_kernelILi0EEv4Args' for 'sm_90a'
ptxas info    : Function properties for _Z19push_scatter_kernelILi0EEv4Args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 48128 bytes smem
ptxas info    : Compile time = 102.477 ms
ptxas info    : Compiling entry function '_Z17push_waves_kernelPKiS0_iiPiS1_S1_' for 'sm_90a'
ptxas info    : Function properties for _Z17push_waves_kernelPKiS0_iiPiS1_S1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 0 barriers
ptxas info    : Compile time = 7.268 ms
""",
    "bsr_spmm.cu": """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15bsr_spmm_kernelILi3EEvPKiS1_PKfS3_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _Z15bsr_spmm_kernelILi3EEvPKiS1_PKfS3_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 208 registers, used 1 barriers, 41984 bytes smem
ptxas info    : Compiling entry function '_Z19bsr_spmm_kernel_b64ILi3EEvPKiS1_PKfS3_Pfii' for 'sm_90a'
ptxas info    : Function properties for _Z19bsr_spmm_kernel_b64ILi3EEvPKiS1_PKfS3_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 33792 bytes smem
ptxas info    : Compiling entry function '_Z18bsr_spmm_tc_kernel14CUtensorMap_stS_PKiS1_S1_PiPfiii' for 'sm_90a'
ptxas info    : Function properties for _Z18bsr_spmm_tc_kernel14CUtensorMap_stS_PKiS1_S1_PiPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 2 barriers
""",
    "gs_sweep.cu": """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z20gs_multisweep_kernelILi3ELi2EEv4Args' for 'sm_90a'
ptxas info    : Function properties for _Z20gs_multisweep_kernelILi3ELi2EEv4Args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 248 registers, used 1 barriers, 9232 bytes smem
ptxas info    : Compiling entry function '_Z20gs_multisweep_kernelILi0ELi0EEv4Args' for 'sm_90a'
ptxas info    : Function properties for _Z20gs_multisweep_kernelILi0ELi0EEv4Args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 252 registers, used 1 barriers, 9232 bytes smem
""",
}


def _defines(path: Path) -> dict[str, int]:
    """The integer #defines of a CUDA source, evaluated in order."""
    out: dict[str, int] = {}
    for m in re.finditer(r"^#define (\w+) ([^\n]*)$", path.read_text(), re.M):
        expr = m.group(2).split("//")[0].strip()
        expr = re.sub(r"\b([A-Z_][A-Z0-9_]*)\b", lambda v: str(out[v.group(1)]), expr)
        if re.fullmatch(r"[\d\s+\-*/()]+", expr):
            out[m.group(1)] = int(eval(expr.replace("/", "//")))
    return out


def test_table_covers_exactly_the_global_functions():
    found = B.scan_globals(CSRC)
    assert sorted(found) == sorted(B.KERNEL_BUDGETS)
    assert len(found) == 6
    for name, (source, _) in found.items():
        assert B.KERNEL_BUDGETS[name].source == source, name


def test_threads_and_blocks_per_sm_follow_the_launch_bounds():
    for name, (source, bounds) in B.scan_globals(CSRC).items():
        b = B.KERNEL_BUDGETS[name]
        defs = _defines(CSRC / source)
        args = [int(defs.get(a.strip(), a.strip())) for a in bounds.split(",")]
        assert b.threads == args[0], name
        assert b.ctas_per_sm >= (args[1] if len(args) > 1 else 1), name


@pytest.mark.parametrize("name", sorted(B.KERNEL_BUDGETS))
def test_budget_fits_hopper(name):
    assert B.hopper_problems(name, B.KERNEL_BUDGETS[name]) == []


def test_hopper_limits_are_enforced():
    b = B.KERNEL_BUDGETS["gs_multisweep_kernel"]
    assert B.hopper_problems("x", dataclasses.replace(b, registers=256))
    # a second resident block would not fit the cooperative sweep's registers
    assert B.hopper_problems("x", dataclasses.replace(b, ctas_per_sm=2))
    assert B.hopper_problems("x", dataclasses.replace(b, dynamic_smem=(230 * 1024, 0)))
    assert B.hopper_problems("x", dataclasses.replace(b, static_smem=49 * 1024))
    assert B.hopper_problems("x", dataclasses.replace(b, spill_bytes=8))


def _gs_dynamic(bs: int, d: int, defs: dict) -> int:
    """gs_sweep.cu's prepare(): the ring of staged tiles that fits beside
    the fixed buffers (ring_for), the region it needs (region_floats) and
    the fixed (GS_NE + GS_BLOCK) floats, for 16-byte aligned operands."""
    fixed = (defs["GS_NE"] + defs["GS_BLOCK"]) * 4
    static = (2 * defs["GS_META"] + defs["GS_BLOCK"] + 2) * 4
    budget = min(B.SMEM_PER_SM - 1024, B.MAX_SMEM_PER_BLOCK) - static
    staged = bs * (bs + 4) + bs * d
    ring = 0
    if bs % 4 == 0 and bs * d <= defs["GS_NE"]:
        r = (budget - fixed) // (4 * staged)
        ring = 0 if r < 2 else min(r, defs["GS_RING_MAX"])
    region = max(bs * defs["GS_KC"] + defs["GS_KC"] * d, ring * staged)
    return (region + 3) // 4 * 4 * 4 + fixed


def test_dynamic_shared_memory_follows_the_sources():
    gs = _defines(CSRC / "gs_sweep.cu")
    tc = _defines(CSRC / "bsr_spmm.cu")
    for k, point in enumerate(B.POINTS):
        assert B.KERNEL_BUDGETS["gs_multisweep_kernel"].dynamic_smem[k] == _gs_dynamic(
            point["bs"], point["d"], gs)
        assert B.KERNEL_BUDGETS["bsr_spmm_tc_kernel"].dynamic_smem[k] == tc["TC_SMEM"]
    # the static buffers ptxas reports fit their budgets
    assert (2 * gs["GS_META"] + gs["GS_BLOCK"] + 2) * 4 <= B.KERNEL_BUDGETS[
        "gs_multisweep_kernel"].static_smem


def test_kernel_name_demangles_the_length_prefix():
    assert B.kernel_name("_Z15bsr_spmm_kernelILi3EEvPKiS1_PKfS3_Pfiii") == "bsr_spmm_kernel"
    assert B.kernel_name("_Z19bsr_spmm_kernel_b64ILi1EEvPKiS1_PKfS3_Pfii") == "bsr_spmm_kernel_b64"
    assert B.kernel_name("_Z20gs_multisweep_kernelILi0ELi1EEv4Args") == "gs_multisweep_kernel"
    assert B.kernel_name("plain_c_name") == "plain_c_name"


def test_parse_ptxas_reads_every_entry():
    entries = B.parse_ptxas(SAMPLE["push_scatter.cu"])
    assert [e.kernel for e in entries] == ["push_scatter_kernel"] * 2 + ["push_waves_kernel"]
    assert [e.registers for e in entries] == [64, 64, 28]
    assert [e.smem for e in entries] == [48128, 48128, 0]
    assert all(e.spill_stores == e.spill_loads == 0 for e in entries)


@pytest.mark.parametrize("source", sorted(SAMPLE))
def test_sample_reports_meet_their_budgets(source):
    assert B.check_ptxas(SAMPLE[source], source) == []


def test_check_flags_excess_spills_and_gaps():
    text = SAMPLE["push_scatter.cu"]
    over = text.replace("Used 64 registers", "Used 100 registers", 1)
    assert any("100 registers > budget 96" in p for p in B.check_ptxas(over, "push_scatter.cu"))
    spill = text.replace("0 bytes spill stores, 0 bytes spill loads",
                         "16 bytes spill stores, 16 bytes spill loads", 1)
    assert any("spills 16" in p for p in B.check_ptxas(spill, "push_scatter.cu"))
    smem = text.replace("48128 bytes smem", "50000 bytes smem", 1)
    assert any("50000 static shared bytes" in p for p in B.check_ptxas(smem, "push_scatter.cu"))
    # a kernel of the source that the report lacks, and a report of another source
    only_waves = text[text.index("ptxas info    : Compiling entry function '_Z17"):]
    assert any("no ptxas entry for push_scatter_kernel" in p
               for p in B.check_ptxas(only_waves, "push_scatter.cu"))
    assert any("no budget" in p for p in B.check_ptxas(text, "bsr_spmm.cu"))
    # an empty or missing report fails, never passes
    assert B.check_ptxas("", "gs_sweep.cu") == ["gs_sweep.cu: no ptxas report to check"]
    assert B.check_ptxas(None, "gs_sweep.cu")


def test_build_keeps_the_report_for_a_cached_load(tmp_path, monkeypatch):
    """A compile writes the ptxas report beside the library; a cached load
    (no compile) reads it back."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    (tmp_path / "report.txt").write_text(SAMPLE["gs_sweep.cu"])
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    "echo built > \"$out\"\n"
                    f"cat {tmp_path / 'report.txt'} >&2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    _build.load("k")
    built = _build.BUILD_INFO["k"]
    assert built["seconds"] > 0 and built["ptxas"] == SAMPLE["gs_sweep.cu"]
    reports = list((tmp_path / "build").glob("libk_*.ptxas.txt"))
    assert len(reports) == 1 and reports[0].read_text() == SAMPLE["gs_sweep.cu"]
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("a cached load compiled"))
    _build.load("k")
    cached = _build.BUILD_INFO["k"]
    assert cached["seconds"] == 0.0 and cached["ptxas"] == SAMPLE["gs_sweep.cu"]
    assert B.check_ptxas(cached["ptxas"], "gs_sweep.cu") == []
    # without its report a cached build has nothing to check, and fails
    reports[0].unlink()
    monkeypatch.setattr(_build, "_LIBS", {})
    _build.load("k")
    assert B.check_ptxas(_build.BUILD_INFO["k"]["ptxas"], "gs_sweep.cu")
