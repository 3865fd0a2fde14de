"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

The ``.cu`` sources under ``src/repro_torch/csrc/`` have a plain C interface.
On first use, ``load()`` compiles each source with its own ``nvcc`` process
(all started together) for ``sm_90a``, links the objects into one shared
library under ``build/`` at the repository root, and loads it with
``ctypes``. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built or imported while this module is imported, so the CPU tests
import it freely.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else; the segment sum's wrapper
adds one a call (two launches) under the route it took. ``ROW_COUNTS`` counts the
rows of the sparse backward and the row updates, on every device: the
distinct rows ``fused_embedding.dedupe_rows`` finds, and the entries the
row updates (K2/K3 or their plain versions) walk, padding included. Both
add host ints the callers already hold, so counting costs no device op
and no sync. ``reset_launches()`` sets every count of both to 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Devices whose tensors K1, K4 and K5's wrappers hand to the plain versions:
# the CPU, and ``meta`` (shapes without data, on which FLOPs are counted). A
# CUDA tensor launches its kernel; any other device raises. K2/K3's plain
# versions select the live rows by value, which a meta tensor has not: they
# take CPU tensors only.
PLAIN_DEVICES = ("cpu", "meta")

LAUNCHES: Dict[str, int] = {
    "fused_embedding_bag": 0,     # K1
    "adagrad_row_update": 0,      # K2
    "adam_row_update": 0,         # K3
    "flash_attention": 0,         # K4
    "decode_attention": 0,        # K5
    "segment_sum_bags": 0,        # the dedupe's segment sum, bags route
    "segment_sum_rows": 0,        # the dedupe's segment sum, rows route
}
ROW_COUNTS: Dict[str, int] = {
    "rows_deduped": 0,            # fused_embedding.dedupe_rows
    "row_update_entries": 0,      # fused_update.{adagrad,adam}_row_update
}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "repro_fused_embedding_bag_f32":
        [_VP, _LL, _VP, _VP, _VP, _LL, _VP, _LL, _I, _I, _I, _I, _I, _VP],
    "repro_adagrad_rows_f32":
        [_VP, _VP, _LL, _I, _VP, _VP, _LL, _F, _F, _I, _I, _VP],
    "repro_adam_rows_f32":
        [_VP, _VP, _VP, _LL, _I, _VP, _VP, _VP, _LL, _F, _F, _F, _F, _F, _F,
         _F, _I, _I, _VP],
    "repro_flash_attention":
        [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
         _VP],
    "repro_flash_attention_tc":
        [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
         _F, _I, _I, _VP],
    "repro_decode_attention":
        [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
         _I, _I, _F, _F, _I, _I, _VP],
    "repro_segment_sum_f32":
        [_VP, _VP, _VP, _LL, _I, _I, _VP, _VP, _VP, _I, _VP],
}

_loaded: List[ctypes.CDLL] = []


def reset_launches() -> None:
    """Set every launch count and row count to 0."""
    for counts in (LAUNCHES, ROW_COUNTS):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                           "CUDA kernels of repro_torch cannot be built")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.

    Each source gets its own ``nvcc`` process, all started together; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) goes to ``<library>.log``. Raises with the compiler's output if
    a source does not build.
    """
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log = []
    failed = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         str(tmp), *(str(obj) for _, obj, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== nvcc -shared (exit {link.returncode})\n{link.stdout}")
    for _, obj, _ in jobs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
    lib.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (raises on failure)."""
    if _loaded:
        return _loaded[0]
    lib = ctypes.CDLL(str(build()))
    for fn_name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded.append(lib)
    return lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {status}")


def build_log() -> Optional[str]:
    """The compiler output of the current library's build, if it exists."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else None
