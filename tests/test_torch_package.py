"""Guards of the PyTorch/CUDA port (``src/repro_torch``).

* nothing in the port, nor ``chip_smoke.py``, imports JAX or ``repro``;
* the port imports with JAX unavailable;
* entry points raise without CUDA unless asked for the CPU, and the kernel
  wrappers take no tensor that is not on a CUDA device;
* the kernel library refuses to build without ``nvcc`` instead of falling
  back.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_embedding as fe  # noqa: E402
from repro_torch.kernels import fused_update as fu  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro[. ])", text, re.M), path


def test_port_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for name in {PORT_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_launcher_raises_without_cuda_unless_cpu(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch.main(["--steps", "1"])
    args = launch.build_parser().parse_args(["--steps", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        launch.train_dlrm(args)
    run = launch.main(["--steps", "1", "--device", "cpu"])
    assert len(run.losses) == 1


def test_resolve_device_rejects_unknown_devices():
    with pytest.raises(ValueError):
        launch.resolve_device("meta")
    assert launch.resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    pool = torch.zeros((8, 4))
    enc = torch.zeros((2, 3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fe.embedding_bag_cuda(pool, enc, None, None, "sum")
    rows = torch.zeros((3,), dtype=torch.int32)
    vals = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        fu.adagrad_rows_cuda(pool, pool.clone(), rows, vals, lr=0.1, eps=1e-10)
    with pytest.raises(ValueError, match="CUDA"):
        fu.adam_rows_cuda(pool, pool.clone(), pool.clone(), rows, vals,
                          torch.ones(2), lr=0.1, b1=0.9, b2=0.999, eps=1e-8,
                          wd=0.0)


def test_attention_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 4, 2, 16))
    kv = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q[:, :1], kv, kv,
                                 torch.zeros((1, 4), dtype=torch.int32),
                                 torch.zeros((1,), dtype=torch.int32))


def test_cpu_dispatch_takes_the_plain_versions_and_counts_nothing():
    cuda_lib.reset_launches()
    pool = torch.randn((8, 4), generator=torch.Generator().manual_seed(0))
    enc = torch.tensor([[[0, 1], [2, -1]]], dtype=torch.int32)
    out = fe.embedding_bag_forward(pool, enc, None, pool[:1].clone(), "sum")
    assert out.shape == (1, 2, 4)
    rows = torch.tensor([1, 8], dtype=torch.int32)
    fu.adagrad_row_update(pool, torch.zeros_like(pool), rows,
                          torch.ones((2, 4)), lr=0.1)
    assert cuda_lib.LAUNCHES == {k: 0 for k in cuda_lib.LAUNCHES}


def test_kernel_library_refuses_to_build_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build()
    assert not list(tmp_path.iterdir())


def test_library_path_tracks_the_sources():
    path = cuda_lib.library_path()
    assert path.parent == cuda_lib.BUILD_DIR
    assert path.name.startswith("librepro_torch_kernels-")
    srcs = {p.name for p in cuda_lib.CSRC_DIR.glob("*.cu")}
    assert srcs == {"fused_embedding.cu", "fused_update.cu",
                    "flash_attention.cu", "flash_attention_tc.cu",
                    "decode_attention.cu"}
