"""Declared per-kernel resource budgets on Hopper: the port's counterpart of
``repro.kernels.budgets``.

The reference declares a VMEM/SMEM ceiling for each ``pallas_call`` and its
static checker holds every kernel to it. Here every ``__global__`` function
in ``csrc/*.cu`` has one :class:`KernelBudget`: registers per thread, static
shared bytes, dynamic shared bytes at representative points, and spill
bytes (none allowed). Every template instantiation is held to its kernel's
entry. A budget must fit what an H100 gives (:func:`hopper_problems`):
255 registers a thread, 64K registers and 228 KiB of shared memory an SM,
227 KiB of shared memory a block with opt-in (48 KiB of it static), 1 KiB
of it kept by the driver for each resident block. A kernel that needs
``ctas_per_sm`` blocks resident on each SM (the cooperative sweep needs its
whole grid of one block per SM resident, or its launch fails) must fit that
many at its ceiling.

Two checks hold the table:

* on the CPU, `tests/test_torch_budgets.py` holds it to the ``__global__``
  names that :func:`scan_globals` finds in the sources, in both directions,
  and to the sources' launch bounds and shared-memory formulas;
* on the card, ``chip_smoke.py``'s build phase parses each library's
  ``nvcc -Xptxas -v`` report (:func:`parse_ptxas`, kept beside the built
  library by `kernels._build`) and fails on any instantiation over its
  budget, any spill, and a missing report (:func:`check_ptxas`).

The points are the sweep's main path (bs 64, d 64) and the kernels'
benchmark shape (bs 128, d 128).
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

KiB = 1024

# One H100 SXM (sm_90): NVIDIA's Hopper tuning guide and data sheet.
MAX_REGISTERS_PER_THREAD = 255
REGISTERS_PER_SM = 65536
REGISTER_ALLOC_UNIT = 256         # registers are given to a warp in units of 256
MAX_SMEM_PER_BLOCK = 227 * KiB    # with cudaFuncAttributeMaxDynamicSharedMemorySize
MAX_STATIC_SMEM = 48 * KiB
SMEM_PER_SM = 228 * KiB
SMEM_RESERVED_PER_BLOCK = 1 * KiB

POINTS = ({"bs": 64, "d": 64}, {"bs": 128, "d": 128})


@dataclasses.dataclass(frozen=True)
class KernelBudget:
    """Declared resource ceiling for one ``__global__`` function."""

    source: str                # file under csrc/
    threads: int               # threads per block (its __launch_bounds__)
    ctas_per_sm: int           # blocks its launch needs resident on each SM
    registers: int             # per thread
    static_smem: int           # bytes of __shared__ arrays
    dynamic_smem: tuple[int, ...]  # bytes at each of POINTS
    spill_bytes: int = 0
    notes: str = ""


KERNEL_BUDGETS: dict[str, KernelBudget] = {
    "gs_multisweep_kernel": KernelBudget(
        source="gs_sweep.cu", threads=256, ctas_per_sm=1,
        # ptxas: 248-252 registers, 9,232 static bytes (PR 16's build)
        registers=255, static_smem=10 * KiB,
        # a ring of 4 staged (64, 68) tiles with their (64, 64) source
        # blocks at bs 64, d 64; the sliced path at bs 128, d 128; plus the
        # (GS_NE + GS_BLOCK) floats of deltas and reduction buffer
        dynamic_smem=(152_576, 33_792),
        notes="cooperative: one block per SM, all resident; 255 registers "
              "x 256 threads is the SM's 64K",
    ),
    "bsr_spmm_kernel": KernelBudget(
        source="bsr_spmm.cu", threads=256, ctas_per_sm=1,
        # ptxas: 208 registers, 41,984 static bytes (the tile and source
        # slices)
        registers=232, static_smem=42 * KiB, dynamic_smem=(0, 0),
    ),
    "bsr_spmm_kernel_b64": KernelBudget(
        source="bsr_spmm.cu", threads=256, ctas_per_sm=1,
        # ptxas: 80 registers, 33,792 static bytes
        registers=128, static_smem=34 * KiB, dynamic_smem=(0, 0),
    ),
    "bsr_spmm_tc_kernel": KernelBudget(
        source="bsr_spmm.cu", threads=160, ctas_per_sm=2,
        # ptxas: 167 registers, no static shared memory; TC_SMEM dynamic
        # bytes (3 stages of four 64 x 32 boxes, barriers, alignment) at
        # any point where bs and d are multiples of 64
        registers=200, static_smem=0, dynamic_smem=(99_456, 99_456),
        notes="__launch_bounds__(TC_THREADS, 2): two blocks per SM",
    ),
    "push_waves_kernel": KernelBudget(
        source="push_scatter.cu", threads=32, ctas_per_sm=1,
        # ptxas: 28 registers, no shared memory
        registers=64, static_smem=0, dynamic_smem=(0, 0),
    ),
    "push_scatter_kernel": KernelBudget(
        source="push_scatter.cu", threads=512, ctas_per_sm=1,
        # ptxas: 64 registers, 48,128 static bytes (three wave stages and
        # the wave's settled values)
        registers=96, static_smem=48 * KiB, dynamic_smem=(0, 0),
    ),
}


def hopper_problems(name: str, b: KernelBudget) -> list[str]:
    """What in budget ``b`` an H100 cannot give (empty when it fits)."""
    out = []
    if b.registers > MAX_REGISTERS_PER_THREAD:
        out.append(f"{name}: {b.registers} registers a thread > {MAX_REGISTERS_PER_THREAD}")
    warps = -(-b.threads // 32)
    per_warp = -(-b.registers * 32 // REGISTER_ALLOC_UNIT) * REGISTER_ALLOC_UNIT
    if per_warp * warps * b.ctas_per_sm > REGISTERS_PER_SM:
        out.append(f"{name}: {b.ctas_per_sm} blocks of {b.threads} threads at "
                   f"{b.registers} registers need {per_warp * warps * b.ctas_per_sm} "
                   f"> {REGISTERS_PER_SM} registers an SM")
    if b.static_smem > MAX_STATIC_SMEM:
        out.append(f"{name}: {b.static_smem} static shared bytes > {MAX_STATIC_SMEM}")
    if len(b.dynamic_smem) != len(POINTS):
        out.append(f"{name}: {len(b.dynamic_smem)} dynamic sizes for {len(POINTS)} points")
    for point, dyn in zip(POINTS, b.dynamic_smem):
        block = b.static_smem + dyn
        if block > MAX_SMEM_PER_BLOCK:
            out.append(f"{name} at {point}: {block} shared bytes a block > {MAX_SMEM_PER_BLOCK}")
        if b.ctas_per_sm * (block + SMEM_RESERVED_PER_BLOCK) > SMEM_PER_SM:
            out.append(f"{name} at {point}: {b.ctas_per_sm} blocks of {block} shared "
                       f"bytes do not fit an SM's {SMEM_PER_SM}")
    if b.spill_bytes != 0:
        out.append(f"{name}: a budget allows no spills, got {b.spill_bytes}")
    return out


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\(([^)]*)\)\s+)?(\w+)\s*\(")


def scan_globals(csrc: Path) -> dict[str, tuple[str, str]]:
    """``{kernel name: (source file, __launch_bounds__ arguments)}`` for
    every ``__global__`` function under ``csrc``."""
    found: dict[str, tuple[str, str]] = {}
    for path in sorted(Path(csrc).glob("*.cu")):
        for bounds, name in _GLOBAL.findall(path.read_text()):
            found[name] = (path.name, bounds.strip())
    return found


@dataclasses.dataclass(frozen=True)
class PtxasEntry:
    """One compiled entry function of a ptxas report."""

    function: str        # the mangled name
    kernel: str          # the __global__ function's own name
    registers: int
    smem: int            # static shared bytes
    spill_stores: int
    spill_loads: int


def kernel_name(mangled: str) -> str:
    """The function name inside an Itanium-mangled ``_Z<len><name>...``;
    an unmangled (``extern "C"``) name as it is."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    return mangled[start:start + int(m.group(1))]


def parse_ptxas(text: str) -> list[PtxasEntry]:
    """The entries of an ``nvcc -Xptxas -v`` report, in report order."""
    entries = []
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1), "spill_stores": 0, "spill_loads": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            entries.append(PtxasEntry(
                function=cur["function"], kernel=kernel_name(cur["function"]),
                registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0,
                spill_stores=cur["spill_stores"], spill_loads=cur["spill_loads"],
            ))
            cur = None
    return entries


def check_ptxas(text: str, source: str,
                budgets: dict[str, KernelBudget] = KERNEL_BUDGETS) -> list[str]:
    """Hold the ptxas report of ``source`` (a file under csrc/) to the
    budgets: every instantiation within its kernel's registers, static
    shared bytes and spills; every kernel of that source reported. A
    missing or empty report is a failure, never a pass."""
    entries = parse_ptxas(text or "")
    if not entries:
        return [f"{source}: no ptxas report to check"]
    out = []
    for e in entries:
        b = budgets.get(e.kernel)
        if b is None or b.source != source:
            out.append(f"{source}: {e.function} has no budget for this source")
            continue
        if e.registers > b.registers:
            out.append(f"{e.function}: {e.registers} registers > budget {b.registers}")
        if e.smem > b.static_smem:
            out.append(f"{e.function}: {e.smem} static shared bytes > budget {b.static_smem}")
        if e.spill_stores + e.spill_loads > b.spill_bytes:
            out.append(f"{e.function}: spills {e.spill_stores} bytes stored, "
                       f"{e.spill_loads} loaded")
    seen = {e.kernel for e in entries}
    for name, b in budgets.items():
        if b.source == source and name not in seen:
            out.append(f"{source}: no ptxas entry for {name}")
    return out
