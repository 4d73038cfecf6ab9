"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``gs_sweep`` — the multi-sweep block Gauss–Seidel kernel
(``csrc/gs_sweep.cu``), built at first use by ``_build``.
"""
