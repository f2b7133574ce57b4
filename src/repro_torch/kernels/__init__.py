"""Hand-written Hopper (sm_90a) kernels of the port.

``csrc/*.cu`` hold the CUDA C++ sources, built on first use by
:mod:`.build` and bound with ``ctypes``.  Each kernel's Python module
holds its wrapper (the only caller of the C entry point), its launch
counter and its plain PyTorch version, which the wrapper runs for tensors
on the CPU and which the tests and ``chip_smoke.py`` hold the kernel
against.
"""
