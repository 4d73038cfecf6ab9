"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Each kernel module holds a wrapper (launches the kernel for CUDA tensors,
runs the plain version for CPU tensors), its plain PyTorch version and a
``launches`` counter; ``_build`` compiles ``csrc/<name>.cu`` at first use.

``gs_sweep``     — multi-sweep block Gauss–Seidel (``csrc/gs_sweep.cu``)
``push_scatter`` — bucketed residual-push round (``csrc/push_scatter.cu``)
``bsr_spmm``     — one synchronous flat-BSR round (``csrc/bsr_spmm.cu``)

As in the reference, the package exports the public entry points
``bsr_spmm`` and ``gs_sweep`` of `kernels.ops`; these names shadow the
submodules of the same name, so reach a kernel module with
``importlib.import_module("repro_torch.kernels.gs_sweep")`` or import names
from it (``from repro_torch.kernels.gs_sweep import gs_multisweep``).
"""
import importlib

# load the kernel modules first: once loaded, a later import of one does
# not rebind the package attribute that the entry point below takes over
for _name in ("bsr_spmm", "gs_sweep", "push_scatter"):
    importlib.import_module(f"{__name__}.{_name}")

from repro_torch.kernels.ops import bsr_spmm, gs_sweep  # noqa: E402

__all__ = ["bsr_spmm", "gs_sweep"]
