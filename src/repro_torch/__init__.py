"""PyTorch/CUDA port of ``repro``: DLRM training with live re-planning,
flash checkpoints, elastic resume, self-healing and the resource manager,
and the LM zoo (every config of ``repro``: forward, loss, cached decoding
and serving).

The package mirrors ``repro``'s module layout (``configs``, ``core``,
``data``, ``sharding``, ``kernels``, ``models``, ``train``, ``serve``,
``launch``) so each module has one counterpart there. It imports ``torch`` and never JAX,
and it keeps its own copies of what it needs from ``repro``.

Kernels: the five Pallas kernels of ``repro`` (K1-K3 on the DLRM training
step, K4/K5 flash and decode attention on the LM path) are hand-written
CUDA C++ for ``sm_90a`` under ``csrc/``, built on first use into ``build/``
at the repository root and bound through ``ctypes``
(``kernels/cuda_lib.py``). Every kernel has a plain PyTorch version in the
same module; a wrapper takes the plain version only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
with no GPU and no such request they raise.
"""
