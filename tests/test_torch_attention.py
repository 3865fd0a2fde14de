"""K4/K5 plain versions and the chunked attention path against the reference.

The same numpy inputs go through the reference (the Pallas kernels with an
explicit ``interpret=True``, the ``xla`` path of ``repro.models.attention``
and the ``repro.kernels.ref`` oracles, all on the CPU) and through
``repro_torch`` on the CPU. Shapes follow the sweeps of
``tests/test_kernels.py``.

Tolerances: f32 results within 2e-5 (absolute and relative) of the Pallas
kernels, whose steps the plain versions repeat; the oracles, which
normalise once instead of rescaling per block, within the reference's own
4 x 2e-5 (3e-5 for the cache path). bf16 outputs within 1.6e-2, two bf16
steps at the outputs' magnitude: both sides compute in f32 and round once,
and a last-place difference in f32 can move that rounding by one step.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (sets torch threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

jax.config.update("jax_platform_name", "cpu")



def _jit(fn):
    """``fn`` of the reference, traced and compiled once per call as one
    program (much cheaper on the CPU than running it op by op)."""
    def call(*args, **kw):
        return jax.jit(functools.partial(fn, **kw))(*args)
    return call


# the Pallas kernels, run by the interpreter on the CPU
pallas_flash = _jit(functools.partial(jfa.flash_attention, interpret=True))
pallas_decode = _jit(functools.partial(jda.decode_attention, interpret=True))
attention_ref = _jit(jref.attention_ref)
decode_attention_ref = _jit(jref.decode_attention_ref)
chunked_attention = _jit(jattn.chunked_attention)
xla_decode_attention = _jit(jattn.decode_attention)

F32_TOL = 2e-5
BF16_TOL = 1.6e-2


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _qkv(seed, B, Sq, Skv, Hkv, G, D, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


# ---------------------------------------------------------------------------
# K4: flash attention (plain version)
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # B, S, Hkv, G, D, causal, window, dtype
    (1, 8, 1, 1, 16, True, None, "float32"),
    (2, 24, 2, 2, 32, True, 8, "float32"),
    (3, 64, 1, 4, 64, False, None, "float32"),
    (2, 24, 1, 2, 64, False, 8, "float32"),
    (2, 8, 2, 4, 16, True, 8, "bfloat16"),
    (1, 64, 1, 2, 32, True, None, "bfloat16"),
    # recurrentgemma's local layers: head dim 256, 10 q-heads over one kv
    (1, 40, 1, 10, 256, True, 16, "float32"),
    (1, 24, 1, 10, 256, False, None, "bfloat16"),
    (2, 40, 1, 10, 256, True, None, "bfloat16"),
    # the edges of the tensor-core tile at head dim 256 (128 queries x 64
    # keys): S=130 is ragged against both, window 64 is one key tile
    (1, 130, 1, 10, 256, True, None, "bfloat16"),
    (1, 130, 1, 10, 256, False, None, "float32"),
    (1, 136, 1, 10, 256, True, 64, "bfloat16"),
    (1, 136, 1, 10, 256, True, 64, "float32"),
]


@pytest.mark.parametrize("B,S,Hkv,G,D,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_pallas_and_oracle(B, S, Hkv, G, D, causal,
                                               window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(S * 10 + Hkv, B, S, S, Hkv, G, D,
                                        dtype)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                    block_q=16, block_k=16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kernel = pallas_flash(jq, jk, jv, causal=causal, window=window,
                          block_q=16, block_k=16)
    _close(got, kernel, _tol(dtype), "vs the Pallas kernel")
    oracle = attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(got, oracle, _tol(dtype) * 4 if dtype == "float32" else BF16_TOL,
           "vs ref.attention_ref")
    # the port's own block size gives the same function
    _close(tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window), got, _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,q_offset,window", [
    (40, 104, 64, 24),     # queries after a 64-token prefix, a window
    (1, 72, 71, None),     # one query at the last position
])
def test_flash_plain_q_offset_at_head_dim_256(Sq, Skv, q_offset, window,
                                              dtype):
    """recurrentgemma's local shape (10 q-heads over one kv-head, D=256)
    with Sq != Skv: the plain version against the oracle, which takes
    ``q_offset`` (the Pallas wrapper does not), at the SIMT tile and at the
    tensor-core kernel's 128 x 64 tile."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(Sq + Skv, 1, Sq, Skv, 1, 10, 256,
                                        dtype)
    kw = dict(causal=True, window=window)
    got = tfa.flash_attention_plain(tq, tk, tv, q_offset=q_offset, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    oracle = attention_ref(jq, jk, jv, q_offset=q_offset, **kw)
    _close(got, oracle, F32_TOL * 4 if dtype == "float32" else BF16_TOL,
           "vs ref.attention_ref")
    _close(tfa.flash_attention_plain(tq, tk, tv, q_offset=q_offset,
                                     block_q=128, block_k=64, **kw),
           got, _tol(dtype), "128 x 64 tiles")


def test_flash_plain_softcap():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(7, 2, 32, 32, 2, 2, 32, "float32")
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True, softcap=20.0,
                                    block_q=8, block_k=8)
    kernel = pallas_flash(jq, jk, jv, causal=True, softcap=20.0, block_q=8,
                          block_k=8)
    _close(got, kernel, F32_TOL)
    _close(got, attention_ref(jq, jk, jv, causal=True, softcap=20.0),
           F32_TOL)


def test_flash_plain_nonmultiple_blocks():
    """A sequence that is not a multiple of the block: the Pallas kernel pads
    and masks ``kpos < kv_len``; the plain version has no padded keys."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 1, 35, 35, 2, 1, 16, "float32")
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True, block_q=16,
                                    block_k=16)
    kernel = pallas_flash(jq, jk, jv, causal=True, block_q=16, block_k=16)
    _close(got, kernel, F32_TOL)
    _close(got, attention_ref(jq, jk, jv, causal=True), F32_TOL)


@pytest.mark.parametrize("q_offset,window", [(16, None), (24, None),
                                             (24, 8)])
def test_flash_plain_q_offset_matches_chunked(q_offset, window):
    """``q_offset > 0`` (queries after a cached prefix). The reference's
    Pallas route drops it, so the plain K4 is held to the oracle and, without
    a window, to the chunked path. With a window the reference's chunked
    path takes its band route, whose band start ignores ``q_offset``; the
    port's chunked path repeats that faithfully and is held to it, not to
    the oracle."""
    Sq, Skv = 16, q_offset + 16
    (jq, tq), (jk, tk), (jv, tv) = _qkv(q_offset, 2, Sq, Skv, 2, 2, 16,
                                        "float32")
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True, window=window,
                                    q_offset=q_offset, block_q=8, block_k=8)
    _close(got, attention_ref(jq, jk, jv, causal=True, window=window,
                                   q_offset=q_offset), F32_TOL, "vs oracle")
    kw = dict(causal=True, window=window, q_chunk=8, k_chunk=8,
              q_offset=q_offset)
    chunked = chunked_attention(jq, jk, jv, **kw)
    if window is None:
        _close(got, chunked, F32_TOL, "vs repro chunked_attention")
    _close(tattn.chunked_attention(tq, tk, tv, **kw), chunked, F32_TOL,
           "port chunked_attention")


def test_flash_plain_fully_masked_rows_are_zero():
    """Queries past the keys' window see no key: 0, as the Pallas kernel
    and the chunked path give (the naive oracle averages instead)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(5, 1, 32, 8, 1, 2, 16, "float32")
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True, window=4,
                                    block_q=8, block_k=8)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, 11:], torch.zeros_like(got[:, 11:]))
    kernel = pallas_flash(jq, jk, jv, causal=True, window=4, block_q=8,
                          block_k=8)
    _close(got, kernel, F32_TOL)
    _close(got, chunked_attention(jq, jk, jv, causal=True, window=4,
                                        q_chunk=8, k_chunk=8), F32_TOL)


# ---------------------------------------------------------------------------
# K4 split over the keys (split_plan and the plain version's combine)
# ---------------------------------------------------------------------------
def _split_for(B, Sq, Hq, Skv, D):
    """The split the plan gives these shapes on the tensor-core route (bf16),
    forced on f32 inputs too so that the f32 cases run the same ranges."""
    return tfa.split_plan(torch.bfloat16, B, Sq, Hq, Skv, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", [(64, 1), (64, 10), (256, 1), (256, 10)])
@pytest.mark.parametrize("Sq,Skv", [(1, 300), (1, 700), (16, 300),
                                    (16, 700)])
def test_flash_plain_split_matches_pallas_and_oracle(Sq, Skv, D, G, dtype):
    """Few queries against many keys, non-causal (Whisper's
    cross-attention, reduced): the plain K4 cut into ``split_plan``'s key
    ranges and combined still matches the unsplit Pallas kernel and the
    oracle."""
    Hkv = 2 if G == 1 else 1
    n_split = _split_for(1, Sq, Hkv * G, Skv, D)
    assert n_split > 1
    (jq, tq), (jk, tk), (jv, tv) = _qkv(Sq + Skv + D + G, 1, Sq, Skv, Hkv,
                                        G, D, dtype)
    got = tfa.flash_attention_plain(tq, tk, tv, causal=False,
                                    n_split=n_split)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kernel = pallas_flash(jq, jk, jv, causal=False, block_q=16, block_k=128)
    _close(got, kernel, _tol(dtype), "vs the Pallas kernel")
    oracle = attention_ref(jq, jk, jv, causal=False)
    _close(got, oracle, _tol(dtype) * 4 if dtype == "float32" else BF16_TOL,
           "vs ref.attention_ref")


SPLIT_MASK_CASES = [
    # Sq, Skv, Hkv, G, D, causal, window, softcap, q_offset
    (16, 700, 1, 10, 256, True, None, 0.0, 200),   # ranges past 215 dead
    (16, 700, 1, 10, 64, True, 40, 0.0, 684),      # only the last range live
    (16, 700, 2, 1, 64, False, None, 20.0, 0),     # softcap
    (16, 300, 1, 10, 256, True, 8, 0.0, 296),      # rows 11.. see no key
    (1, 300, 2, 1, 64, True, 8, 0.0, 400),         # the one row sees none
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,Hkv,G,D,causal,window,softcap,q_offset",
                         SPLIT_MASK_CASES)
def test_flash_plain_split_masks_dead_ranges_and_empty_rows(
        Sq, Skv, Hkv, G, D, causal, window, softcap, q_offset, dtype):
    """Causal with ``q_offset``, a window and the softcap under the split:
    ranges that no query reaches contribute nothing, and a row with no
    valid key in any range is exactly 0 (the oracle averages such a row
    instead, so it is held to the rows that have a key)."""
    n_split = _split_for(1, Sq, Hkv * G, Skv, D)
    assert n_split > 1
    (jq, tq), (jk, tk), (jv, tv) = _qkv(Skv + q_offset + D, 1, Sq, Skv, Hkv,
                                        G, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    got = tfa.flash_attention_plain(tq, tk, tv, n_split=n_split, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    qpos = q_offset + np.arange(Sq)
    has_key = np.minimum(qpos, Skv - 1) > (
        qpos - window if window is not None else -1) if causal \
        else np.ones(Sq, bool)
    empty = ~has_key
    assert torch.equal(got[:, empty], torch.zeros_like(got[:, empty]))
    oracle = np.asarray(attention_ref(jq, jk, jv, **kw), np.float32)
    _close(got[:, has_key], oracle[:, has_key],
           F32_TOL * 4 if dtype == "float32" else BF16_TOL,
           "vs ref.attention_ref")
    if q_offset == 0:                # the Pallas wrapper drops q_offset
        _close(got, pallas_flash(jq, jk, jv, causal=causal, window=window,
                                 softcap=softcap, block_q=16, block_k=128),
               _tol(dtype), "vs the Pallas kernel")


@pytest.mark.parametrize("Sq,Skv,Hkv,G,D,causal,window,softcap,q_offset", [
    (1, 1500, 4, 1, 64, False, None, 0.0, 0),     # cross-attention, reduced
    (16, 700, 1, 10, 256, True, 300, 30.0, 600),
    (40, 300, 2, 2, 128, True, None, 0.0, 260),
])
def test_flash_plain_split_equals_unsplit_to_f32_rounding(
        Sq, Skv, Hkv, G, D, causal, window, softcap, q_offset):
    """On f32 inputs the plan's split and one range differ only by f32
    rounding: the same sums taken in another grouping."""
    n_split = _split_for(2, Sq, Hkv * G, Skv, D)
    assert n_split > 1
    (_, tq), (_, tk), (_, tv) = _qkv(Sq + Skv, 2, Sq, Skv, Hkv, G, D,
                                     "float32")
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    one = tfa.flash_attention_plain(tq, tk, tv, n_split=1, **kw)
    split = tfa.flash_attention_plain(tq, tk, tv, n_split=n_split, **kw)
    assert float((split - one).abs().max() / one.abs().max()) <= 1e-6
    assert torch.equal(tfa.flash_attention_plain(tq, tk, tv, **kw), one)


def test_k4_split_plan_follows_the_shape_alone():
    """K4's split count is a function of dtype and shape: 1 off the
    tensor-core route and where the unsplit grid fills the card; more at
    Whisper's cross-attention; within one wave and one cluster of at most
    ``SPLIT_MAX`` CTAs, and no range empty."""
    plan, keys = tfa.split_plan, tfa.split_keys
    bf16, f32 = torch.bfloat16, torch.float32
    # off the tensor-core route: f32, or a head dim it does not take
    assert plan(f32, 1, 1, 16, 1500, 64) == 1
    for D in (16, 32, 96, 192):
        assert plan(bf16, 1, 1, 16, 1500, D) == 1
    # the unsplit grid already fills the card: llama3.2-3b (384 CTAs),
    # recurrentgemma's local layers (160), Whisper's encoder (192)
    assert plan(bf16, 1, 2048, 24, 2048, 128) == 1
    assert plan(bf16, 1, 2048, 10, 2048, 256) == 1
    assert plan(bf16, 1, 1500, 16, 1500, 64) == 1
    # Whisper's cross-attention, one decode step and teacher-forced: 6
    # ranges of 256 keys, 96 CTAs
    for Sq in (1, 16):
        assert plan(bf16, 1, Sq, 16, 1500, 64) == 6
    assert keys(1500, 6) == 256
    assert plan(bf16, 1, 1, 10, 2048, 256) == 8   # recurrentgemma, Sq=1
    for B in (1, 2, 3, 8):
        for Sq in (1, 16, 128, 129, 300):
            for Hq in (1, 4, 10, 16, 24):
                for Skv in (1, 100, 128, 129, 300, 1500, 4096, 32768):
                    for D in (64, 256):
                        n = plan(bf16, B, Sq, Hq, Skv, D)
                        base = B * Hq * -(-Sq // 128)
                        assert 1 <= n <= tfa.SPLIT_MAX
                        assert n == 1 or n * base <= tfa.SPLIT_SMS
                        if base >= tfa.SPLIT_SMS:
                            assert n == 1
                        span = keys(Skv, n)
                        assert span % 128 == 0
                        # n ranges of `span` keys, the last one shorter at
                        # most, none empty
                        assert (n - 1) * span < Skv <= n * span or n == 1
                        assert plan(f32, B, Sq, Hq, Skv, D) == 1


# ---------------------------------------------------------------------------
# the xla path: chunked attention
# ---------------------------------------------------------------------------
CHUNKED_CASES = [
    # S, G, causal, window, q_chunk, dtype
    (16, 1, True, None, 8, "float32"),
    (48, 3, False, None, 16, "float32"),
    (128, 1, True, 16, 16, "float32"),      # local band path
    (48, 3, True, 16, 64, "float32"),       # short-enough local: global path
    (128, 3, True, 16, 16, "bfloat16"),
    (48, 1, True, None, 16, "bfloat16"),
]


@pytest.mark.parametrize("S,G,causal,window,q_chunk,dtype", CHUNKED_CASES)
def test_chunked_attention_matches_reference(S, G, causal, window, q_chunk,
                                             dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(S + G, 2, S, S, 2, G, 16, dtype)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk, k_chunk=q_chunk)
    got = tattn.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    # at bf16 both cast p to the value dtype before the PV product
    _close(got, chunked_attention(jq, jk, jv, **kw), _tol(dtype))
    if dtype == "float32":
        _close(got, tref.attention_ref(tq, tk, tv, causal=causal,
                                       window=window), 3e-5)


# ---------------------------------------------------------------------------
# K5: decode attention (plain version)
# ---------------------------------------------------------------------------
def _cache(seed, B, L, Hkv, G, D, valid_frac, q_dtype, c_dtype):
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    n_valid = max(1, int(L * valid_frac))
    cache_pos = np.broadcast_to(np.arange(L), (B, L))
    cache_pos = np.where(cache_pos < n_valid, cache_pos, -1).astype(np.int32)
    pos = np.full((B,), n_valid - 1, np.int32)
    return (_pair(q, q_dtype), _pair(kc, c_dtype), _pair(vc, c_dtype),
            _pair(cache_pos, "int32"), _pair(pos, "int32"))


DECODE_CASES = [
    # B, L, Hkv, G, window, valid_frac, q dtype, cache dtype
    (1, 16, 1, 1, None, 1.0, "float32", "float32"),
    (2, 48, 2, 4, None, 0.5, "float32", "float32"),
    (3, 100, 1, 4, 8, 0.7, "float32", "float32"),
    (2, 48, 2, 4, None, 0.6, "bfloat16", "float32"),   # the engine's pair
    (1, 100, 1, 4, 8, 0.9, "bfloat16", "bfloat16"),
]


@pytest.mark.parametrize("B,L,Hkv,G,window,valid_frac,q_dtype,c_dtype",
                         DECODE_CASES)
def test_decode_plain_matches_pallas_and_oracle(B, L, Hkv, G, window,
                                                valid_frac, q_dtype, c_dtype):
    (jq, tq), (jk, tk), (jv, tv), (jcp, tcp), (jpos, tpos) = _cache(
        L + Hkv, B, L, Hkv, G, 32, valid_frac, q_dtype, c_dtype)
    got = tda.decode_attention_plain(tq, tk, tv, tcp, tpos, window=window,
                                     block_k=16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kernel = pallas_decode(jq, jk, jv, jcp, jpos, window=window, block_k=16)
    _close(got, kernel, _tol(q_dtype), "vs the Pallas kernel")
    oracle = decode_attention_ref(jq, jk, jv, jcp, jpos, window=window)
    _close(got, oracle, 3e-5 if q_dtype == "float32" else BF16_TOL,
           "vs ref.decode_attention_ref")
    _close(tda.decode_attention_plain(tq, tk, tv, tcp, tpos, window=window),
           got, _tol(q_dtype), "default block")


WIDE_DECODE_CASES = [
    # B, L, Hkv, G, D, window, valid_frac, q dtype, cache dtype: head dim 256
    # and 10 q-heads per kv-head (recurrentgemma's local layers)
    (1, 40, 1, 10, 256, 16, 0.8, "bfloat16", "float32"),   # the engine's pair
    (2, 48, 1, 10, 256, None, 1.0, "float32", "float32"),
    (1, 40, 1, 10, 256, 16, 0.9, "bfloat16", "bfloat16"),
    (1, 400, 1, 10, 256, 150, 0.9, "float32", "float32"),  # split
]


@pytest.mark.parametrize("B,L,Hkv,G,D,window,valid_frac,q_dtype,c_dtype",
                         WIDE_DECODE_CASES)
def test_decode_plain_wide_heads_match_pallas_and_oracle(
        B, L, Hkv, G, D, window, valid_frac, q_dtype, c_dtype):
    (jq, tq), (jk, tk), (jv, tv), (jcp, tcp), (jpos, tpos) = _cache(
        L + G, B, L, Hkv, G, D, valid_frac, q_dtype, c_dtype)
    got = tda.decode_attention_plain(tq, tk, tv, tcp, tpos, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kernel = pallas_decode(jq, jk, jv, jcp, jpos, window=window, block_k=16)
    _close(got, kernel, _tol(q_dtype), "vs the Pallas kernel")
    oracle = decode_attention_ref(jq, jk, jv, jcp, jpos, window=window)
    _close(got, oracle, 3e-5 if q_dtype == "float32" else BF16_TOL,
           "vs ref.decode_attention_ref")


def _split_cache_pos(layout, B, L):
    """cache_pos (B, L) and pos (B,) for the split cases."""
    slots = np.arange(L)
    if layout == "prefix":             # 80 written slots: later splits empty
        cp, pos = np.where(slots < 80, slots, -1), np.full((B,), 79)
    elif layout == "ring":             # slots 0-99 hold the newest positions
        cp, pos = np.where(slots < 100, slots + L, slots), np.full((B,), L + 99)
    else:                              # "empty-row": row 1 holds nothing
        cp, pos = slots, np.full((B,), L - 1)
    cp = np.broadcast_to(cp, (B, L)).astype(np.int32).copy()
    if layout == "empty-row":
        cp[1] = -1
    return cp, pos.astype(np.int32)


SPLIT_CASES = [
    # B, L, Hkv, G, window, layout, q dtype, cache dtype
    (1, 400, 1, 4, None, "prefix", "float32", "float32"),      # 3 empty splits
    (2, 300, 2, 2, None, "empty-row", "float32", "float32"),  # a row with none
    (2, 384, 1, 3, 150, "ring", "float32", "float32"),         # wrapped ring
    (2, 300, 2, 2, None, "empty-row", "bfloat16", "float32"),  # engine dtypes
]


@pytest.mark.parametrize("B,L,Hkv,G,window,layout,q_dtype,c_dtype",
                         SPLIT_CASES)
def test_decode_plain_split_matches_pallas_and_oracle(B, L, Hkv, G, window,
                                                      layout, q_dtype,
                                                      c_dtype):
    """Caches long enough that ``split_plan`` splits them: the plain K5 runs
    each split's running softmax and the combine pass, and still matches the
    unsplit Pallas kernel and the oracle; a row with no valid slot anywhere
    gives exactly 0."""
    assert tda.split_plan(B, Hkv, L) > 1
    rng = np.random.default_rng(L + G)
    D = 32
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
              for _ in range(2))
    cp, pos = _split_cache_pos(layout, B, L)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(q, q_dtype), _pair(kc, c_dtype),
                                    _pair(vc, c_dtype))
    (jcp, tcp), (jpos, tpos) = _pair(cp, "int32"), _pair(pos, "int32")
    got = tda.decode_attention_plain(tq, tk, tv, tcp, tpos, window=window,
                                     block_k=64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kernel = pallas_decode(jq, jk, jv, jcp, jpos, window=window, block_k=128)
    _close(got, kernel, _tol(q_dtype), "vs the Pallas kernel")
    oracle = decode_attention_ref(jq, jk, jv, jcp, jpos, window=window)
    if layout == "empty-row":          # the oracle averages an empty row
        oracle, got_valid = np.asarray(oracle)[:1], got[:1]
        assert torch.equal(got[1], torch.zeros_like(got[1]))
    else:
        got_valid = got
    _close(got_valid, oracle, 3e-5 if q_dtype == "float32" else BF16_TOL,
           "vs ref.decode_attention_ref")


def test_split_plan_and_k4_route_follow_the_shape_alone():
    """K5's split count and K4's route are functions of dtype and shape."""
    plan = tda.split_plan
    assert plan(1, 8, 2048) == 16          # 128 blocks of 128 slots
    assert plan(8, 8, 4096) == 2           # 128 blocks of 2048 slots
    assert plan(16, 8, 4096) == 1          # B x Hkv fills the card alone
    assert plan(1, 1, 300) == 3 and plan(2, 8, 256) == 2
    for B in (1, 2, 4, 8, 64):
        assert plan(B, 8, 128) == 1        # the engine's cache: one launch
    for B in (1, 3, 8):
        for Hkv in (1, 2, 8):
            for L in (1, 129, 1000, 4096, 32768):
                n = plan(B, Hkv, L)
                assert 1 <= n <= max(1, tda.SPLIT_SMS // (B * Hkv))
                assert n == 1 or L / n >= 64

    def meta(dtype, S, H, D):
        return torch.empty((2, S, H, D), dtype=dtype, device="meta")

    bf16, f32 = torch.bfloat16, torch.float32
    for D in (64, 128, 256):
        assert tfa.tc_route(meta(bf16, 100, 4, D), meta(bf16, 7, 2, D))
        assert not tfa.tc_route(meta(f32, 100, 4, D), meta(f32, 7, 2, D))
        assert not tfa.tc_route(meta(bf16, 100, 4, D), meta(bf16, 0, 2, D))
    for D in (16, 32, 48, 96, 192):
        assert not tfa.tc_route(meta(bf16, 100, 4, D), meta(bf16, 7, 2, D))


def test_decode_plain_ring_wrap_and_softcap():
    """A wrapped ring (slots 0-7 hold the newest positions) with a window,
    and the softcap."""
    rng = np.random.default_rng(9)
    B, L, Hkv, G, D = 2, 24, 2, 2, 16
    kc, vc = (rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    base = np.arange(L)
    cache_pos = np.stack([np.where(base < 8, base + L, base)] * B
                         ).astype(np.int32)
    pos = np.full((B,), L + 7, np.int32)
    args_j = [jnp.asarray(a) for a in (q, kc, vc, cache_pos, pos)]
    args_t = [torch.from_numpy(a) for a in (q, kc, vc, cache_pos, pos)]
    for softcap in (0.0, 5.0):
        got = tda.decode_attention_plain(*args_t, window=12, softcap=softcap,
                                         block_k=8)
        kernel = pallas_decode(*args_j, window=12, softcap=softcap,
                               block_k=8)
        _close(got, kernel, F32_TOL)
        _close(got, decode_attention_ref(*args_j, window=12,
                                              softcap=softcap), 3e-5)


def test_decode_plain_no_valid_slot_gives_zero():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    cache_pos = torch.full((2, 8), -1, dtype=torch.int32)
    cache_pos[1, :3] = torch.arange(3, dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    got = tda.decode_attention_plain(q, kc, kc, cache_pos, pos, block_k=4)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.isfinite(got).all() and got[1].abs().sum() > 0


@pytest.mark.parametrize("q_dtype,c_dtype", [("float32", "float32"),
                                             ("bfloat16", "float32"),
                                             ("bfloat16", "bfloat16")])
def test_decode_xla_path_matches_reference(q_dtype, c_dtype):
    (jq, tq), (jk, tk), (jv, tv), (jcp, tcp), (jpos, tpos) = _cache(
        11, 2, 40, 2, 3, 16, 0.6, q_dtype, c_dtype)
    for window in (None, 8):
        got = tattn.decode_attention(tq, tk, tv, tcp, tpos, window=window,
                                     softcap=3.0)
        want = xla_decode_attention(jq, jk, jv, jcp, jpos, window=window,
                                      softcap=3.0)
        assert got.dtype == tq.dtype
        _close(got, want, _tol(q_dtype))


def test_oracles_match_reference_oracles():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 2, 12, 20, 2, 3, 16, "float32")
    kw = dict(causal=True, window=6, softcap=4.0, q_offset=8)
    _close(tref.attention_ref(tq, tk, tv, **kw),
           attention_ref(jq, jk, jv, **kw), 1e-5)
    (jq, tq), (jk, tk), (jv, tv), (jcp, tcp), (jpos, tpos) = _cache(
        3, 2, 30, 2, 2, 16, 0.5, "float32", "float32")
    _close(tref.decode_attention_ref(tq, tk, tv, tcp, tpos, window=5,
                                     softcap=4.0),
           decode_attention_ref(jq, jk, jv, jcp, jpos, window=5,
                                     softcap=4.0), 1e-5)


def test_cpu_dispatch_takes_the_plain_versions_and_counts_nothing():
    cuda_lib.reset_launches()
    (_, tq), (_, tk), (_, tv) = _qkv(1, 1, 12, 12, 1, 2, 16, "float32")
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert torch.equal(out, tfa.flash_attention_plain(tq, tk, tv,
                                                      causal=True))
    _, (_, kc), (_, vc), (_, cp), (_, pos) = _cache(
        1, 1, 12, 1, 2, 16, 1.0, "float32", "float32")
    q1 = tq[:, :1]
    out = ops.decode_attention(q1, kc, vc, cp, pos)
    assert torch.equal(out, tda.decode_attention_plain(q1, kc, vc, cp, pos))
    assert cuda_lib.LAUNCHES["flash_attention"] == 0
    assert cuda_lib.LAUNCHES["decode_attention"] == 0
