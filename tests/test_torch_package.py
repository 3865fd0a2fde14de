"""Guards of the PyTorch/CUDA port (``src/repro_torch``).

* nothing in the port, nor ``chip_smoke.py`` or the port's examples
  (``examples/*_torch.py``), imports JAX or ``repro``;
* the port imports with JAX unavailable; the job master and the worker's
  entry module import with torch unavailable too (the master stays out of
  the accelerator stack's failure domain; a worker beats "boot" before it
  imports torch), and so do the brain and the simulator (host code);
* entry points raise without CUDA unless asked for the CPU, and the kernel
  wrappers take no tensor that is not on a CUDA device; the dispatching
  entries run the plain versions on CPU tensors, K1, K4 and K5's on meta
  tensors too, and count no launch;
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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("*_torch.py"))


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


def test_job_master_and_worker_entry_import_without_torch():
    code = ("import sys\n"
            "for name in ('torch', 'jax', 'numpy', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.train.job_master as jm\n"
            "import repro_torch.train.worker_main as wm\n"
            "import repro_torch.core.migration\n"
            "assert callable(jm.JobMaster) and callable(wm.main)\n"
            "print('stdlib only')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "stdlib only" in proc.stdout


def test_control_plane_and_simulator_import_without_torch():
    """The resource manager is host code: the brain, the auto-scaler and
    the simulator import (and replay) with torch unavailable."""
    code = ("import sys\n"
            "for name in ('torch', 'jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.core.brain, repro_torch.core.plugin\n"
            "from repro_torch.sim import replay, trace\n"
            "jobs = trace.trace_to_jobs(trace.load_trace(\n"
            "    trace.default_trace_path()), seed=3)[:4]\n"
            "res = replay.replay(jobs, 'static_user', total_cpu=2048.0,\n"
            "                    total_mem_gb=16384.0, horizon_s=3600.0,\n"
            "                    seed=3, failure_seed=77)\n"
            "print('host only', len(res.records))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "host only 4" in proc.stdout


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


@pytest.mark.parametrize("mode", [["--supervise"], ["--chaos", "oom@1"],
                                  ["--chaos-proc", "kill@1"]])
def test_self_healing_modes_raise_without_cuda_unless_cpu(monkeypatch,
                                                          tmp_path, mode):
    _no_cuda(monkeypatch)
    argv = ["--steps", "1", "--ckpt-dir", str(tmp_path / "ck"),
            "--workdir", str(tmp_path / "wd")] + mode
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch.main(argv)
    assert not (tmp_path / "wd").exists()       # no worker was spawned
    if mode[0] != "--chaos-proc":
        run = launch.main(argv + ["--device", "cpu"])
        assert run.report.completed and run.report.final_step == 1


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


def test_meta_dispatch_takes_the_plain_versions_and_counts_nothing():
    """Meta tensors (shapes without data, where ``launch/costs.py`` counts
    FLOPs) reach K1, K4 and K5's plain versions: no kernel can read them."""
    cuda_lib.reset_launches()
    meta = torch.device("meta")
    pool = torch.empty((8, 4), device=meta)
    enc = torch.empty((1, 2, 2), dtype=torch.int32, device=meta)
    assert fe.embedding_bag_forward(pool, enc, None, None, "sum").shape == \
        (1, 2, 4)
    # the row updates select live rows by value: no meta tensor
    rows = torch.empty((2,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.adagrad_row_update(pool, torch.empty_like(pool), rows,
                              torch.empty((2, 4), device=meta), lr=0.1)
    q = torch.empty((1, 4, 2, 16), device=meta)
    kv = torch.empty((1, 4, 1, 16), device=meta)
    assert fa.flash_attention(q, kv, kv).shape == q.shape
    pos = torch.empty((1, 4), dtype=torch.int32, device=meta)
    assert da.decode_attention(q[:, :1], kv, kv, pos,
                               torch.empty((1,), dtype=torch.int32,
                                           device=meta)).shape == (1, 1, 2, 16)
    assert cuda_lib.LAUNCHES == {k: 0 for k in cuda_lib.LAUNCHES}


def test_new_entry_points_default_to_the_card(monkeypatch):
    """The batched-serving example and the cost tool: the example raises
    without CUDA unless asked for the CPU; the cost tool allocates nothing
    on any device (it counts on meta tensors)."""
    import importlib.util
    path = ROOT / "examples" / "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batched_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ex.main(["--requests", "1"])
    from repro_torch.launch import costs
    api = costs.build_model(costs.get_arch("llama3.2-3b"))
    assert {t.device.type for t in costs.optim_mod.tree_leaves(
        costs.meta_params(api))} == {"meta"}


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
                    "decode_attention.cu", "segment_sum.cu",
                    "multi_tensor.cu", "cin.cu"}
