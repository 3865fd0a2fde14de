"""The LM training machinery of the port, on the CPU.

``lm_batch`` equals the reference's (``==``); the optimizer functions take
nested trees of dicts and lists as the reference's do; adam's leaf-by-leaf
``apply`` (with or without donation) equals the whole-tree formula bit for
bit; a donated step equals an undonated one and consumes its state;
``with_step_hooks`` wraps the LM step; ``grad_compress`` steps match the
reference's; under grad, full-sequence attention (``attn_apply`` and the
enc-dec cross-attention) reaches ``models/attention.chunked_attention``,
and without grad it does not; K4's and K5's CUDA entries refuse inputs that
require grad under grad mode; at a length that is no multiple of its
chunk, the training route's shorter last chunk gives the reference's
halved-chunk result within f32 rounding.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_train as lmt  # noqa: E402
import _torch_zoo as zoo  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.data.synthetic import lm_batch as tlm_batch  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402


@pytest.mark.parametrize("seed,start,seq,vocab", [
    (0, 0, 64, 128256), (0, 37, 16, 512), (3, 1000, 7, 51865)])
def test_lm_batch_matches_reference(seed, start, seq, vocab):
    idx = np.arange(start, start + 5)
    want, got = jlm_batch(seed, idx, seq, vocab), tlm_batch(seed, idx, seq,
                                                           vocab)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def _nested(rng, dtype=np.float32):
    """A nested tree of dicts and lists, the LM params' shape of tree."""
    def a(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(dtype)
    return {"embed": a(12, 4), "final_norm": a(4),
            "layers": [{"attn": {"wq": a(4, 2, 3)}, "ln1": a(4)},
                       {"attn": {"wq": a(4, 2, 3)}, "ln1": a(4)}]}


def _to_t(tree):
    return toptim.tree_map(torch.from_numpy, tree)


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adamw", {}), ("adagrad", {"clip_norm": 0.5}),
    ("sgd", {"momentum": 0.9}), ("sgd", {})])
def test_optimizers_take_nested_trees_as_the_reference(name, kw):
    rng = np.random.default_rng(5)
    params, grads = _nested(rng), _nested(rng)
    topt, jopt = toptim.make(name, 0.01, **kw), joptim.make(name, 0.01, **kw)
    tstate, jstate = topt.init(_to_t(params)), jopt.init(_to_j(params))
    tp, jp = _to_t(params), _to_j(params)
    for _ in range(2):
        tu, tstate = topt.update(_to_t(grads), tstate, tp)
        ju, jstate = jopt.update(_to_j(grads), jstate, jp)
        tp, jp = toptim.apply_updates(tp, tu), joptim.apply_updates(jp, ju)
    got, want = zoo._flatten(tp), zoo._flatten(jax.tree.map(np.asarray, jp))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    tleaves = list(toptim.tree_leaves(tstate))
    jleaves = jax.tree.leaves(jstate)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


def test_norm_clip_compress_on_nested_trees_match_reference():
    rng = np.random.default_rng(6)
    grads = _nested(rng)
    tg, jg = _to_t(grads), _to_j(grads)
    np.testing.assert_allclose(float(toptim.global_norm(tg)),
                               float(joptim.global_norm(jg)), rtol=1e-6)
    tc, tn = toptim.clip_by_global_norm(tg, 0.5)
    jc, jn = joptim.clip_by_global_norm(jg, 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in ((tc, jc), (toptim.compress_grads(tg),
                                 joptim.compress_grads(jg))):
        got = zoo._flatten(got)
        want = zoo._flatten(jax.tree.map(np.asarray, want))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                       atol=1e-8, err_msg=k)


def _whole_tree_adam(grads, state, params, *, lr, b1, b2, eps, wd, clip,
                     master):
    """The whole-tree adam of the reference's formula (``m``, ``v``,
    ``mh``, ``vh`` and the updates as whole trees), over flat name dicts."""
    if clip is not None:
        grads, _ = toptim.clip_by_global_norm(grads, clip)
    count = state["count"] + 1
    tc = count.float()
    m = {k: b1 * state["m"][k] + (1 - b1) * g.float()
         for k, g in grads.items()}
    v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(g.float())
         for k, g in grads.items()}
    mh = {k: x / (1 - b1 ** tc) for k, x in m.items()}
    vh = {k: x / (1 - b2 ** tc) for k, x in v.items()}
    if master:
        nm = {k: w - lr * (mh[k] / (torch.sqrt(vh[k]) + eps) + wd * w)
              for k, w in state["master"].items()}
        upd = {k: nm[k].to(p.dtype) - p for k, p in params.items()}
    else:
        nm = None
        upd = {k: (-lr * (mh[k] / (torch.sqrt(vh[k]) + eps)
                          + wd * p.float())).to(p.dtype)
               for k, p in params.items()}
    return {k: p + upd[k] for k, p in params.items()}, m, v, nm


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("donate", [False, True])
def test_leaf_by_leaf_adam_is_the_whole_tree_formula(master, clip, donate):
    rng = np.random.default_rng(7)
    params = _to_t(_nested(rng))
    params["layers"][1]["attn"]["wq"] = \
        params["layers"][1]["attn"]["wq"].to(torch.bfloat16)
    params["embed"] = params["embed"].to(torch.bfloat16)
    hyper = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    opt = toptim.adam(hyper["lr"], weight_decay=hyper["wd"], clip_norm=clip,
                      master_weights=master)
    state = opt.init(params)
    for i in range(3):
        grads = toptim.tree_map(
            lambda p: torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)).to(p.dtype), params)
        flat = {k: zoo._flatten(x) for k, x in (("p", params), ("g", grads))}
        fstate = {"count": state["count"],
                  **{k: zoo._flatten(state[k]) for k in
                     (("m", "v", "master") if master else ("m", "v"))}}
        want_p, want_m, want_v, want_master = _whole_tree_adam(
            flat["g"], fstate, flat["p"], clip=clip, master=master, **hyper)
        # update + apply_updates, then the fused apply on copies
        upd, s1 = opt.update(grads, state, params)
        got_p = zoo._flatten(toptim.apply_updates(params, upd))
        copy = functools.partial(toptim.tree_map, torch.clone)
        new_params, new_state = toptim.update_and_apply(
            opt, copy(grads), copy(state), copy(params), donate=donate)
        for got_tree in (got_p, zoo._flatten(new_params)):
            for k, want in want_p.items():
                assert got_tree[k].dtype == want.dtype
                assert torch.equal(got_tree[k], want), (i, k)
        for st in (s1, new_state):
            for name, want in (("m", want_m), ("v", want_v)) + (
                    (("master", want_master),) if master else ()):
                got = zoo._flatten(st[name])
                for k in want:
                    assert torch.equal(got[k], want[k]), (i, name, k)
            assert int(st["count"]) == i + 1
        params, state = new_params, new_state


def test_donated_step_equals_undonated_and_consumes_state():
    _, cfg, _, tparams, inputs = zoo.setup("llama3.2-3b")
    api = treg.build_model(cfg)
    opt = toptim.adamw(lmt.LR)
    _, tbatch = zoo.batch_of(inputs, with_targets=True)
    copy = functools.partial(toptim.tree_map, torch.clone)
    state = {"params": copy(tparams), "opt": opt.init(tparams), "step": 0}
    want, wm = ttrainer.make_train_step(api, opt)(state, tbatch)
    donated = {"params": copy(tparams), "opt": opt.init(tparams), "step": 0}
    got, gm = ttrainer.make_train_step(api, opt, donate=True)(donated,
                                                              tbatch)
    assert donated == {}
    assert got["step"] == want["step"] == 1
    for key in ("loss", "grad_norm"):
        assert torch.equal(gm[key], wm[key])
    g, w = zoo._flatten(got), zoo._flatten(want)
    assert set(g) == set(w)
    for k in w:
        if torch.is_tensor(w[k]):
            assert torch.equal(g[k], w[k]), k


def test_step_hooks_wrap_the_lm_step():
    _, cfg, _, tparams, inputs = zoo.setup("granite-moe-1b-a400m")
    api = treg.build_model(cfg)
    opt = toptim.adamw(lmt.LR)
    batches = [tb for _, tb in lmt.step_batches(cfg, inputs)]
    calls = []

    def before(state, batch):
        calls.append(("before", state["step"]))
        if state["step"] == 1 and len(calls) == 3:
            raise RuntimeError("injected fault")

    def after(state, metrics):
        calls.append(("after", state["step"], float(metrics["loss"])))

    step = ttrainer.with_step_hooks(
        ttrainer.make_train_step(api, opt, donate=True), before=before,
        after=after)
    plain = ttrainer.make_train_step(api, opt)
    params = toptim.tree_map(torch.clone, tparams)   # the step donates them
    state = {"params": params, "opt": opt.init(params), "step": 0}
    want_state, want = plain(state, batches[0])
    state, m = step(state, batches[0])
    assert torch.equal(m["loss"], want["loss"])
    kept = zoo._flatten(state)
    with pytest.raises(RuntimeError, match="injected fault"):
        step(state, batches[1])           # the fault leaves the state alone
    assert all(v is kept[k] for k, v in zoo._flatten(state).items())
    state, m = step(state, batches[1])
    _, want = plain(want_state, batches[1])
    assert torch.equal(m["loss"], want["loss"])
    assert [c[:2] for c in calls] == [("before", 0), ("after", 1),
                                      ("before", 1), ("before", 1),
                                      ("after", 2)]


def test_grad_compress_steps_match_reference():
    lmt.check_train_steps("llama3.2-3b", grad_compress=True)


@pytest.mark.parametrize("arch,n_chunked", [
    ("llama3.2-3b", lambda cfg: cfg.num_layers),
    ("gemma3-27b", lambda cfg: cfg.num_layers),
    ("whisper-medium", lambda cfg: cfg.encoder_layers + 2 * cfg.num_layers)])
def test_attention_takes_the_chunked_route_under_grad_only(arch, n_chunked,
                                                           monkeypatch):
    _, cfg, _, tparams, inputs = zoo.setup(arch)
    api = treg.build_model(cfg)
    _, tbatch = zoo.batch_of(inputs, with_targets=True)
    seen = []
    real = tattn.chunked_attention

    def spy(*args, **kw):
        seen.append((kw["q_chunk"], kw["k_chunk"]))
        return real(*args, **kw)

    monkeypatch.setattr(tattn, "chunked_attention", spy)
    ttrainer.loss_and_grads(api, tparams, tbatch, remat=False)
    assert seen == [(1024, 1024)] * n_chunked(cfg)
    seen.clear()
    ttrainer.make_eval_step(api)({"params": tparams}, tbatch)
    api.loss(tparams, tbatch)             # grad mode on, nothing requires it
    api.prefill(tparams, tbatch)
    assert seen == []


def test_cuda_entries_refuse_inputs_that_require_grad():
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    k = torch.zeros((1, 4, 1, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_cuda(q, k, k)
    cache_pos = torch.zeros((1, 4), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention_cuda(q[:, :1], k, k, cache_pos, pos)
    with torch.no_grad():                 # past the rule: CUDA tensors only
        with pytest.raises(ValueError, match="CUDA tensor"):
            fa.flash_attention_cuda(q, k, k)


@pytest.mark.parametrize("Sq,Skv,causal,window,chunk", [
    (100, 100, True, None, 32), (100, 100, True, 16, 32),
    (20, 75, False, None, 16), (130, 130, True, 24, 64)])
def test_chunked_attention_at_ragged_lengths_matches_reference(
        Sq, Skv, causal, window, chunk):
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((2, Sq, 6, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_chunk=chunk, k_chunk=chunk)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jax.jit(functools.partial(jattn.chunked_attention, **kw))(
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
    oracle = tref.attention_ref(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=2e-6,
                               rtol=2e-6)
