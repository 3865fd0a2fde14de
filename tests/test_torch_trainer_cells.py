"""Port parity: the remaining 20-step DLRM trajectory cells.

The cells ``tests/test_torch_trainer.py`` does not run, on its helpers and
its tolerances (every step's loss within 2e-5 of the reference, the final
pooled stores within 1e-4):

* Wide&Deep with the hot-row cache off (``hot_rows_k=0``, K1's no-cache
  path) over {adagrad, adam} × {dense, fused sparse} × {flat, padded};
* DCN and xDeepFM over {adagrad, adam} × {dense, fused sparse}, with 64 hot
  rows, DCN padded and xDeepFM flat as in that file, minus its two cells.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import test_torch_trainer as base  # noqa: E402
from repro.configs import dlrm_models as jcfg  # noqa: E402
from repro_torch.configs import dlrm_models as tcfg  # noqa: E402
from repro_torch.configs.registry import get_dlrm  # noqa: E402


def _cfgs(kind, hot_rows_k):
    j = {"wide_deep": jcfg.WIDE_DEEP, "xdeepfm": jcfg.XDEEPFM,
         "dcn": jcfg.DCN}[kind]
    kw = dict(zipf_alpha=1.05, hot_rows_k=hot_rows_k)
    return (dataclasses.replace(jcfg.reduced_dlrm(j), **kw),
            dataclasses.replace(tcfg.reduced_dlrm(get_dlrm(kind)), **kw))


def _cell(kind, hot_rows_k, opt_name, sparse, padded):
    jc, tc = _cfgs(kind, hot_rows_k)
    assert (tc.table_hot is None or sum(tc.table_hot) == 0) == \
        (hot_rows_k == 0)
    jl, tl = base._layouts(tc, padded)
    batches = base._batches(jc)
    init, jlosses, jparams = base._jax_run(jc, jl, opt_name, sparse, batches)
    tlosses, tstate = base._torch_run(tc, tl, init, opt_name, sparse, batches)
    base._assert_trajectory(tlosses, jlosses, tstate, jparams)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("opt_name", ["adagrad", "adam"])
def test_wide_deep_hot_off_trajectory(opt_name, sparse, padded):
    _cell("wide_deep", 0, opt_name, sparse, padded)


@pytest.mark.parametrize("kind,opt_name,sparse,padded", [
    ("dcn", "adagrad", False, True),
    ("dcn", "adam", False, True),
    ("dcn", "adam", True, True),
    ("xdeepfm", "adagrad", False, False),
    ("xdeepfm", "adagrad", True, False),
    ("xdeepfm", "adam", False, False),
])
def test_other_kinds_remaining_trajectory(kind, opt_name, sparse, padded):
    _cell(kind, 64, opt_name, sparse, padded)
