"""Shared helpers of the ``test_torch_*`` parity tests.

The same numpy inputs go through the JAX reference (CPU, ``impl="xla"`` or
``repro.kernels.ref``) and through ``repro_torch`` on the CPU; results come
back as numpy arrays and are compared here.
"""
import numpy as np
import torch

torch.set_num_threads(1)


def to_np(x):
    """Tensor / jax array / SparseRowGrad-free value → numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ulp_distance(a, b) -> int:
    """Largest distance in float32 units in the last place between a and b."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:
        return 0
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    # fold the sign-magnitude encoding onto a monotone integer line
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return int(np.max(np.abs(ai - bi)))


def assert_ulp_close(a, b, max_ulp: int, msg: str = "") -> None:
    d = ulp_distance(a, b)
    assert d <= max_ulp, f"{msg}: {d} ULP apart (bound {max_ulp})"


def jax_tree_to_np(tree):
    """Nested dict of jax arrays → nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def flatten_jax_tree(tree, prefix=""):
    """Nested dict → ``{"a.b": leaf}`` (the port's parameter names)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_jax_tree(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def plain(x):
    """Dataclasses, arrays and containers of either package → plain data
    that compares with ``==`` across the packages (NaN as the string
    ``"nan"``, so an undefined percentile compares equal to itself)."""
    import dataclasses
    import math
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x
