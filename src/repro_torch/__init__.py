"""PyTorch/CUDA port of the DLRM training path of ``repro``.

The package mirrors ``repro``'s module layout (``configs``, ``data``,
``sharding``, ``kernels``, ``models``, ``train``, ``launch``) so each module
has one counterpart there. It imports ``torch`` and never JAX, and it keeps
its own copies of what it needs from ``repro``.

Kernels: the three Pallas kernels on the DLRM training step are hand-written
CUDA C++ for ``sm_90a`` under ``csrc/``, built on first use into ``build/``
at the repository root and bound through ``ctypes``
(``kernels/cuda_lib.py``). Every kernel has a plain PyTorch version in the
same module; a wrapper takes the plain version only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
with no GPU and no such request they raise.
"""
