"""Port parity: the one-device cost tool ``repro_torch.launch.costs``.

* ``shape_applicable``, ``model_flops`` and ``analytic_hbm_bytes`` of all
  ten archs at the four reference shapes are ``==`` to the reference's
  (``repro.launch.dryrun.model_flops``, ``repro.launch.costs.
  analytic_hbm_bytes`` under a mesh-free ``ShardingPolicy``, where every
  axis size is 1).
* ``flops_of`` (``FlopCounterMode`` on meta tensors) against the
  reference's jaxpr walker on ``tests/test_costs.py``'s micro cases: a
  matmul, a loop of 8 layers, and remat counting the recompute, exactly.
* the counted train step (adam, remat) of every reduced arch against the
  reference's ``flops_of(make_train_step(remat=True))``: equal up to the
  two stated causes, each pinned exactly: the port's chunked attention
  recomputes each block's scores in the backward (one more q·kᵀ product
  per block pair), and the SSD block's three-operand einsums contract in
  another pairwise order (the reference counts a product with no
  contracted index as a ``dot_general``; torch forms it elementwise).
  Then llama3.2-3b at full width, B=1, S=128, on meta tensors.
* prefill (counted on the chunked route, as the reference's) and decode of
  every arch but mamba2 (whose SSD einsums pair as above), with the RG-LRU
  decode conv pinned: a ``dot_general`` in the reference, a multiply-add
  sum in the port.
* the CLI's one-device record.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import reduce_config as jreduce  # noqa: E402
from repro.configs.base import shape_applicable as japplicable  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.launch import costs as jcosts  # noqa: E402
from repro.launch.dryrun import model_flops as jmodel_flops  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig, reduce_config  # noqa: E402
from repro_torch.configs.base import shape_applicable  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import costs  # noqa: E402
from repro_torch.models.transformer import TRAIN_CHUNK  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH_IDS = list(JARCHS)
B, S = 2, 64
# the SSD block's pairwise einsum order at B=2, S=64 (reduced mamba2: 4
# heads of 16, state 16, chunk 16): what the reference's walker counts in
# products with no contracted index over the forward, its recomputation and
# the backward, per SSM layer
SSD_PAIRING_FLOPS_PER_LAYER = 262_144


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def _spec(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# ---------------------------------------------------------------------------
# config-only bookkeeping, all ten archs x four shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape_name", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_hbm_bytes_equal_the_reference(arch, shape_name):
    jcfg, jshape = JARCHS[arch], JSHAPES[shape_name]
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    assert shape_applicable(cfg, shape) == japplicable(jcfg, jshape)
    if not shape_applicable(cfg, shape)[0]:
        rec = costs.cost_cell(arch, shape_name)
        assert rec == {"arch": arch, "shape": shape_name, "n_devices": 1,
                       "skipped": japplicable(jcfg, jshape)[1]}
        return
    assert costs.model_flops(cfg, shape) == jmodel_flops(jcfg, jshape)
    pbytes = costs.param_bytes(cfg)
    assert pbytes == jcfg.param_count() * (
        2.0 if jcfg.param_dtype == "bfloat16" else 4.0)
    flops = costs.model_flops(cfg, shape)
    want = jcosts.analytic_hbm_bytes(jcfg, jshape, ShardingPolicy(mesh=None),
                                     pbytes, flops)
    assert costs.analytic_hbm_bytes(cfg, shape, pbytes, flops) == want


# ---------------------------------------------------------------------------
# flops_of against the jaxpr walker: tests/test_costs.py's micro cases
# ---------------------------------------------------------------------------
def test_flops_of_matmul_exact():
    want = jcosts.flops_of(lambda a, b: a @ b, _spec(64, 128), _spec(128, 32))
    got = costs.flops_of(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    assert got == want == 2 * 64 * 128 * 32


def test_flops_of_counts_every_layer_of_a_loop():
    def jf(w, x):
        def body(x, wi):
            return x @ wi, None
        x, _ = jax.lax.scan(body, x, w)
        return x

    def tf(w, x):
        for wi in w:
            x = x @ wi
        return x

    want = jcosts.flops_of(jf, _spec(8, 16, 16), _spec(4, 16))
    got = costs.flops_of(tf, _meta(8, 16, 16), _meta(4, 16))
    assert got == want == 8 * 2 * 4 * 16 * 16


def test_flops_of_counts_the_remat_recompute():
    def jloss(w, x, remat):
        f = lambda x: jnp.tanh(x @ w) @ w
        return jnp.sum((jax.checkpoint(f) if remat else f)(x))

    def tgrad(w, x, remat):
        f = lambda x: torch.tanh(x @ w) @ w
        y = torch.utils.checkpoint.checkpoint(f, x, use_reentrant=False) \
            if remat else f(x)
        return torch.autograd.grad(y.sum(), w)

    counts = {}
    for remat in (True, False):
        want = jcosts.flops_of(jax.grad(lambda w, x: jloss(w, x, remat)),
                               _spec(16, 16), _spec(4, 16))
        got = costs.flops_of(tgrad, _meta(16, 16, grad=True), _meta(4, 16),
                             remat)
        assert got == want
        counts[remat] = got
    assert counts[True] > counts[False]           # the recomputed product


# ---------------------------------------------------------------------------
# the counted train step of every reduced arch
# ---------------------------------------------------------------------------
def _score_products(cfg, batch, seq):
    """FLOPs of one q·kᵀ product per (q block x k block) of every attention
    call of a forward on the port's chunked route: what its backward
    recomputes."""
    def one(sq, skv, window=None):
        keys = skv
        if window is not None and skv > window + min(TRAIN_CHUNK, sq):
            keys = window + min(TRAIN_CHUNK, sq)         # the local band
        return 2 * batch * cfg.n_heads * sq * keys * cfg.head_dim

    if cfg.family == "encdec":
        F = cfg.n_frames
        return (cfg.encoder_layers * one(F, F)
                + cfg.num_layers * (one(seq, seq) + one(seq, F)))
    return sum(one(seq, seq, cfg.local_window if kind == "local" else None)
               for kind in cfg.layer_kinds if kind in ("global", "local"))


def _reference_step_flops(jcfg, jshape):
    api = jbuild(jcfg)
    opt = joptim.adam(1e-3, master_weights=jcfg.param_dtype == "bfloat16")
    state = jax.eval_shape(lambda k: jtrainer.make_train_state(api, opt, k),
                           jax.random.PRNGKey(0))
    return jcosts.flops_of(jtrainer.make_train_step(api, opt, remat=True),
                           state, api.input_specs(jshape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_flops_against_reference(arch):
    jcfg, cfg = jreduce(JARCHS[arch]), reduce_config(get_arch(arch))
    want = _reference_step_flops(jcfg, JShape("t", S, B, "train"))
    got = costs.step_flops(cfg, ShapeConfig("t", S, B, "train"))
    recompute = _score_products(cfg, B, S)
    ssd = SSD_PAIRING_FLOPS_PER_LAYER * sum(
        kind == "ssm" for kind in cfg.layer_kinds)
    assert got == want + recompute - ssd, (got, want, got / want)
    if arch in ("llama3.2-3b", "mamba2-2.7b"):
        # llama: 49/48 (two attention layers, 1,048,576 recomputed FLOPs
        # each on 100,663,296); mamba2: no attention
        assert (recompute > 0) == (arch == "llama3.2-3b")
        assert (ssd > 0) == (arch == "mamba2-2.7b")


def test_full_width_llama_train_step_counted_on_meta():
    """llama3.2-3b at its published width and depth, one sequence of 128
    tokens: the counter runs on meta tensors (no memory), the walker on
    abstract values."""
    jcfg, cfg = JARCHS["llama3.2-3b"], get_arch("llama3.2-3b")
    want = _reference_step_flops(jcfg, JShape("t", 128, 1, "train"))
    got = costs.step_flops(cfg, ShapeConfig("t", 128, 1, "train"))
    assert got == want + _score_products(cfg, 1, 128)
    # the counted step carries the remat recompute: above 6·N·tokens' 3
    # passes, below 4 (the logits are not recomputed)
    mflops = costs.model_flops(cfg, ShapeConfig("t", 128, 1, "train"))
    assert mflops < got < 4 / 3 * mflops


# ---------------------------------------------------------------------------
# prefill and decode where the two run the same algorithm
# ---------------------------------------------------------------------------
def _reference_serve_flops(jcfg, jshape):
    api = jbuild(jcfg)
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    specs = api.input_specs(jshape)
    if jshape.kind == "prefill":
        return jcosts.flops_of(api.prefill, params, specs)
    cache = jax.eval_shape(lambda: api.init_cache(
        jshape.global_batch, jshape.seq_len, jnp.bfloat16))
    return jcosts.flops_of(lambda p, c, b: api.decode_step(p, c, b["tokens"]),
                           params, cache, specs)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "mamba2-2.7b"])
def test_prefill_and_decode_flops_against_reference(arch, kind):
    jcfg, cfg = jreduce(JARCHS[arch]), reduce_config(get_arch(arch))
    want = _reference_serve_flops(jcfg, JShape("s", S, B, kind))
    got = costs.step_flops(cfg, ShapeConfig("s", S, B, kind))
    # the reference's RG-LRU conv step is an einsum over the conv width
    conv = 0
    if kind == "decode":
        conv = sum(2 * B * 4 * cfg.lru_width for kind_ in cfg.layer_kinds
                   if kind_ == "recurrent")
    assert got == want - conv, (got, want)


def test_cli_writes_the_one_device_record(tmp_path):
    """``--arch/--shape --out`` writes ``lower_cell``'s one-device keys; a
    skipped cell records why."""
    import json
    costs.main(["--arch", "mamba2-2.7b", "--shape", "long_500k", "--out",
                str(tmp_path)])
    costs.main(["--arch", "llama3.2-3b", "--shape", "long_500k", "--out",
                str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-2.7b_long_500k.json").read_text())
    assert set(rec) == {"arch", "shape", "n_devices", "step_flops",
                        "count_s", "model_flops", "analytic_hbm", "params",
                        "params_active"}
    jcfg, jshape = JARCHS["mamba2-2.7b"], JSHAPES["long_500k"]
    assert rec["model_flops"] == jmodel_flops(jcfg, jshape)
    assert rec["params"] == jcfg.param_count()
    assert rec["step_flops"] > 0 and rec["n_devices"] == 1
    skipped = json.loads(
        (tmp_path / "llama3.2-3b_long_500k.json").read_text())
    assert skipped["skipped"] == japplicable(JARCHS["llama3.2-3b"],
                                             jshape)[1]
    with pytest.raises(SystemExit):
        costs.main(["--arch", "llama3.2-3b"])
