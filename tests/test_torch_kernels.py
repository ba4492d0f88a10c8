"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper in `hitadv_torch.ops.kernels` runs its plain
PyTorch version; the JAX side runs the Pallas kernel in interpret mode,
as `tests/test_pallas_kernels.py` does. Inputs come from numpy seeds.
The CUDA kernels themselves are held against their plain versions on a
card by `tests/test_torch_cuda.py` and by `chip_smoke.py`.
"""

import ast
import pathlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.nn import functional as nnF
from hitadv_tpu.ops import pallas_kernels as PK
from hitadv_torch.ops import kernels as K

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every CPU `test_torch_*.py` file imports this fixture by name.

    The suite runs in several worker processes beside JAX's own thread
    pools; torch's default of one thread per core oversubscribes the
    machine, and these small ops then run many times slower. One thread
    also fixes torch's reduction order, which follows its thread count,
    so the trajectory comparisons round alike on every machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """Round to bf16 (through JAX) and widen back: the same values on
    both sides."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _torch(x: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,Kc,C", [(2, 100, 16, 40), (1, 130, 8, 136)])
@pytest.mark.parametrize("bf16", [False, True])
def test_max_linear_matches_pallas(B, N, Kc, C, bf16):
    rng = np.random.RandomState(0)
    h = rng.randn(B, N, Kc).astype(np.float32)
    w = (rng.randn(Kc, C) / np.sqrt(Kc)).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    if bf16:
        h, w = _bf16_values(h), _bf16_values(w)
    mx8, row8 = PK.max_linear_pallas(jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                                     jnp.asarray(b))
    want_v, want_r = nnF._max_linear_combine(mx8, row8)
    got_v, got_r = K.max_linear(_torch(h, tdt), _torch(w, tdt), _torch(b))
    # f32 sums of K products in another order: ~1e-6 relative
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("bf16", [False, True])
def test_max_linear_exact_ties_take_lowest_row(bf16):
    # small integers: every sum exact, and many columns tie across rows
    rng = np.random.RandomState(1)
    h = rng.randint(-2, 3, (2, 48, 8)).astype(np.float32)
    h[:, 40] = h[:, 5]                     # a duplicated row ties everywhere
    w = rng.randint(-2, 3, (8, 24)).astype(np.float32)
    b = np.zeros(24, np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want_v, want_r = nnF._max_linear_combine(*PK.max_linear_pallas(
        jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(b)))
    got_v, got_r = K.max_linear(_torch(h, tdt), _torch(w, tdt), _torch(b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    z = h @ w
    assert (np.sum(z == z.max(axis=1, keepdims=True), axis=1) > 1).any()


@pytest.mark.parametrize("N", [100, 130])
def test_max_linear_dh_matches_pallas_f32(N):
    rng = np.random.RandomState(2)
    B, Kc, C = 2, 16, 72
    row = rng.randint(0, N, (B, C)).astype(np.int32)
    row[:, 1] = row[:, 0]                  # two columns on one row
    g = rng.randn(B, C).astype(np.float32)
    w = rng.randn(Kc, C).astype(np.float32)
    want = PK.max_linear_dh_pallas(jnp.asarray(row), jnp.asarray(g),
                                   jnp.asarray(w), N)
    got = K.max_linear_dh(_torch(row), _torch(g), _torch(w), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    hit = np.zeros((B, N), bool)
    for bb in range(B):
        hit[bb, row[bb]] = True
    assert (got.numpy()[~hit] == 0).all()      # rows winning nothing


def test_max_linear_dh_matches_pallas_bf16():
    # integer-valued g and W: the bf16 results are exact on both sides
    rng = np.random.RandomState(3)
    B, N, Kc, C = 2, 100, 16, 72
    row = rng.randint(0, 20, (B, C)).astype(np.int32)   # crowded rows
    g = rng.randint(-8, 9, (B, C)).astype(np.float32)
    w = rng.randint(-4, 5, (Kc, C)).astype(np.float32)
    want = PK.max_linear_dh_pallas(jnp.asarray(row), jnp.asarray(g),
                                   jnp.asarray(w, jnp.bfloat16), N)
    got = K.max_linear_dh(_torch(row), _torch(g), _torch(w, torch.bfloat16),
                          N)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bf16", [False, True])
def test_max_linear_dh_past_the_old_width_cap_matches_pallas(bf16):
    """`max_linear_dh` at C = 57824 columns, well past the width whose hit
    list a block's shared memory holds on the card (28767; there the list
    now lives in a global scratch, held to the plain version by
    tests/test_torch_cuda.py::test_max_linear_dh_width_cap): against the
    Pallas kernel in interpret mode, as the JAX package's tests run it.
    Integer data: exact sums on both sides."""
    rng = np.random.RandomState(34)
    B, N, Kc, C = 1, 16, 4, 57824
    row = rng.randint(0, N, (B, C)).astype(np.int32)
    row[0, :C // 2] = 5                     # a row winning half the columns
    g = rng.randint(-8, 9, (B, C)).astype(np.float32)
    w = rng.randint(-4, 5, (Kc, C)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want = PK.max_linear_dh_pallas(jnp.asarray(row), jnp.asarray(g),
                                   jnp.asarray(w, jdt), N)
    got = K.max_linear_dh(_torch(row), _torch(g), _torch(w, tdt), N)
    assert got.shape == (B, N, Kc) and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape,M,bf16", [((2, 100, 3), 300, False),
                                          ((2, 130, 8), 64, True)])
def test_gather_rows_bitwise(shape, M, bf16):
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32) * 3
    if bf16:
        x = _bf16_values(x)
    idx = rng.randint(0, shape[1], (shape[0], M)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want = np.asarray(PK.gather_rows_pallas(jnp.asarray(x, jdt),
                                            jnp.asarray(idx)
                                            ).astype(jnp.float32))
    for it in (torch.int32, torch.int64):
        got = K.gather_rows(_torch(x, tdt), _torch(idx).to(it))
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("C,S,ns", [(73, 16, 8), (137, 8, 16)])
def test_gather_rows_field_widths_match_pallas(C, S, ns):
    """PointConv's field gathers: bf16 rows 64 + 8 + 1 and 128 + 8 + 1
    wide (146 and 274 bytes) by S-major kNN indices [B, S * ns]."""
    rng = np.random.RandomState(19)
    N = 64
    x = _bf16_values(rng.randn(2, N, C).astype(np.float32))
    idx = np.stack([np.stack([rng.choice(N, ns, replace=False)
                              for _ in range(S)]) for _ in range(2)])
    idx = idx.reshape(2, S * ns).astype(np.int32)
    want = np.asarray(PK.gather_rows_pallas(jnp.asarray(x, jnp.bfloat16),
                                            jnp.asarray(idx)
                                            ).astype(jnp.float32))
    got = K.gather_rows(_torch(x, torch.bfloat16), _torch(idx))
    assert got.dtype == torch.bfloat16 and got.shape == (2, S * ns, C)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("Nq,N,k", [(100, 130, 8), (130, 100, 5)])
def test_knn_indices_match_pallas(Nq, N, k):
    rng = np.random.RandomState(5)
    q = rng.randn(2, Nq, 3).astype(np.float32)
    p = rng.randn(2, N, 3).astype(np.float32)
    want_d, want_i = PK.knn_pallas(jnp.asarray(q), jnp.asarray(p), k)
    got_d, got_i = K.knn(_torch(q), _torch(p), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-5)


def test_knn_duplicate_points_tie_to_lowest_index():
    rng = np.random.RandomState(6)
    base = rng.randn(2, 50, 3).astype(np.float32)
    p = np.concatenate([base, base[:, ::-1]], axis=1)   # every point twice
    want_d, want_i = PK.knn_pallas(jnp.asarray(base), jnp.asarray(p), 6)
    got_d, got_i = K.knn(_torch(base), _torch(p), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # each point finds itself twice, the lower index first
    assert (got_i[..., 0] < got_i[..., 1]).all()
    assert torch.equal(got_d[..., 0], got_d[..., 1])


def test_knn_refuses_feature_space():
    """The CPU path takes any k <= N and any C, as the reference's
    `knn_idx` does (the caps are the CUDA kernel's, ROADMAP §3 fault 1):
    k = 65 in coordinates and C = 257 features give JAX `knn_idx`'s
    indices. Mixed dtypes, and k past N, are refused on every device."""
    from hitadv_tpu.ops import geometry as JG

    rng = np.random.RandomState(7)
    z = rng.randn(1, 100, 3).astype(np.float32)
    f = rng.randn(1, 40, 257).astype(np.float32)
    for x, k in ((z, 65), (f, 4)):
        _, got = K.knn(_torch(x), _torch(x), k)
        want = np.asarray(JG.knn_idx(jnp.asarray(x), jnp.asarray(x), k))
        assert got.shape == want.shape == (1, x.shape[1], k)
        np.testing.assert_array_equal(got.numpy(), want)
    y = torch.zeros(1, 16, 8)
    with pytest.raises(TypeError):
        K.knn(y, y.to(torch.bfloat16), 4)
    with pytest.raises(ValueError, match="k=17"):
        K.knn(y, y, 17)


@pytest.mark.parametrize("C,k", [(64, 20), (13, 7)])
def test_knn_feature_space_matches_pallas(C, k):
    rng = np.random.RandomState(12)
    q = rng.randn(2, 100, C).astype(np.float32)
    p = rng.randn(2, 130, C).astype(np.float32)
    p[:, 70] = p[:, 3]                     # a duplicate: an exact tie
    want_d, want_i = PK.knn_pallas(jnp.asarray(q), jnp.asarray(p), k)
    got_d, got_i = K.knn(_torch(q), _torch(p), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # the Pallas kernel takes the matmul form of the distance, the port
    # the left-to-right elementwise form: f32 rounding of C-term sums
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-4)


def test_knn_bf16_features_widen_exactly():
    """bf16 features give the distances and indices of their exactly
    widened f32 values."""
    rng = np.random.RandomState(13)
    x = _bf16_values(rng.randn(2, 90, 64).astype(np.float32))
    d16, i16 = K.knn(_torch(x, torch.bfloat16), _torch(x, torch.bfloat16),
                     20)
    d32, i32 = K.knn(_torch(x), _torch(x), 20)
    assert d16.dtype == torch.float32
    assert torch.equal(i16, i32) and torch.equal(d16, d32)


@pytest.mark.parametrize("N,C,k", [(64, 3, 20), (100, 3, 64),
                                   (40, 128, 20)])
def test_knn_all_equal_points_take_the_first_k(N, C, k):
    """Every distance ties: the plain kNN and the JAX package's (Pallas
    in interpret mode, and its XLA `knn_idx`) return indices 0..k-1 and
    equal distances. The card's warp selection is held to this."""
    from hitadv_tpu.ops import geometry as JG

    rng = np.random.RandomState(21)
    x = np.repeat(rng.randn(2, 1, C).astype(np.float32), N, axis=1)
    got_d, got_i = K.knn(_torch(x), _torch(x), k)
    np.testing.assert_array_equal(
        got_i.numpy(), np.broadcast_to(np.arange(k, dtype=np.int32),
                                       (2, N, k)))
    assert (got_d == got_d[..., :1]).all()
    want_d, want_i = PK.knn_pallas(jnp.asarray(x), jnp.asarray(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(
        got_i.numpy(), np.asarray(JG.knn_idx(jnp.asarray(x), jnp.asarray(x),
                                             k)))


@pytest.mark.parametrize("N", [16, 24, 33, 49])
def test_knn_in_eval_disks_matches_pallas(N):
    """The evaluation's uniformity disks: the 6 nearest among 16-49
    points of a disk, each disk its own batch."""
    rng = np.random.RandomState(22)
    x = (0.2 * rng.randn(12, N, 3)).astype(np.float32)
    x[:, N - 1] = x[:, 2]                  # a duplicate: an exact tie
    got_d, got_i = K.knn(_torch(x), _torch(x), 6)
    want_d, want_i = PK.knn_pallas(jnp.asarray(x), jnp.asarray(x), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_max_linear_dh_one_row_wins_every_column(bf16):
    """A row that wins every column (a cloud of identical points): on
    integer-valued g and W every sum is exact in any order, so the plain
    version and the Pallas kernel (interpret mode) agree exactly, and
    every other row is zero."""
    rng = np.random.RandomState(23)
    B, N, Kc, C = 2, 100, 16, 256
    row = np.repeat(rng.randint(0, N, (B, 1)), C, axis=1).astype(np.int32)
    g = rng.randint(-8, 9, (B, C)).astype(np.float32)
    w = rng.randint(-4, 5, (Kc, C)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want = PK.max_linear_dh_pallas(jnp.asarray(row), jnp.asarray(g),
                                   jnp.asarray(w, jdt), N)
    got = K.max_linear_dh(_torch(row), _torch(g), _torch(w, tdt), N)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    for bb in range(B):
        rest = np.delete(got[bb].float().numpy(), row[bb, 0], axis=0)
        assert (rest == 0).all()
        exact = _torch(g[bb] @ w.T).to(tdt).float().numpy()
        assert (got[bb, row[bb, 0]].float().numpy() == exact).all()


@pytest.mark.parametrize("N,M,C", [(100, 300, 3), (130, 64, 8)])
def test_scatter_add_rows_matches_index_points_vjp(N, M, C):
    from hitadv_tpu.ops import geometry as JG
    import jax

    rng = np.random.RandomState(14)
    idx = rng.randint(0, N, (2, M)).astype(np.int32)
    idx[:, :5] = 7                          # a crowded row
    g = rng.randn(2, M, C).astype(np.float32)
    x = jnp.zeros((2, N, C), jnp.float32)
    _, vjp = jax.vjp(lambda p: JG.index_points(p, jnp.asarray(idx)), x)
    (want,) = vjp(jnp.asarray(g))
    for it in (torch.int32, torch.int64):
        got = K.scatter_add_rows(_torch(idx).to(it), _torch(g), N)
        # XLA's scatter-add and the port's ascending sum: f32 rounding
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # the Pallas kernel splits f32 into hi|lo bf16 halves (2^-17 relative
    # per term); on integer-valued data both sides are exact
    gi = rng.randint(-8, 9, (2, M, C)).astype(np.float32)
    want_p = PK.scatter_add_rows_pallas(jnp.asarray(idx), jnp.asarray(gi), N)
    got = K.scatter_add_rows(_torch(idx), _torch(gi), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    got16 = K.scatter_add_rows(_torch(idx), _torch(gi, torch.bfloat16), N)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), np.asarray(want_p))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("N,k,C", [(100, 20, 64), (130, 5, 7)])
def test_graph_max_pool_matches_pallas(N, k, C, bf16):
    rng = np.random.RandomState(15)
    y = rng.randn(2, N, C).astype(np.float32)
    y[:, 9] = y[:, 4]                       # equal rows: ties across slots
    if bf16:
        y = _bf16_values(y)
    idx = rng.randint(0, N, (2, N, k)).astype(np.int32)
    idx[:, :, 1] = 4
    idx[:, :, 2] = 9
    idx[:, 0, 3] = idx[:, 0, 0]             # a repeated neighbour
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want_mx, want_slot = PK.graph_max_pool_pallas(jnp.asarray(y, jdt),
                                                  jnp.asarray(idx))
    got_mx, got_slot = K.graph_max_pool(_torch(y, tdt), _torch(idx))
    assert got_mx.dtype == tdt and got_slot.dtype == torch.int32
    np.testing.assert_array_equal(got_mx.float().numpy(),
                                  np.asarray(want_mx.astype(jnp.float32)))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want_slot))
    # the backward on integer-valued g: exact on both sides
    g = rng.randint(-8, 9, (2, N, C)).astype(np.float32)
    want_g = PK.graph_max_pool_bwd_pallas(jnp.asarray(idx), want_slot,
                                          jnp.asarray(g, jdt), N)
    got_g = K.graph_max_pool_bwd(_torch(idx), got_slot, _torch(g, tdt), N)
    assert got_g.dtype == tdt
    np.testing.assert_array_equal(got_g.float().numpy(),
                                  np.asarray(want_g.astype(jnp.float32)))


@pytest.mark.parametrize("bf16", [False, True])
def test_graph_max_pool_all_inf_neighbourhood_matches_pallas(bf16):
    """k = 20, C = 64: in the second cloud the first 8 channels are -inf
    at every point, so every neighbourhood there is all -inf and the
    strict `>` fold from -inf keeps slot 0 and -inf on both sides. (The
    Pallas kernel gathers by a one-hot product, in which a -inf anywhere
    in a cloud's channel turns that whole channel into NaN, which never
    wins either; so only whole -inf channels are comparable.)"""
    rng = np.random.RandomState(20)
    N, k, C = 100, 20, 64
    y = rng.randn(2, N, C).astype(np.float32)
    y[1, :, :8] = -np.inf
    if bf16:
        y = _bf16_values(y)
    idx = rng.randint(0, N, (2, N, k)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want_mx, want_slot = PK.graph_max_pool_pallas(jnp.asarray(y, jdt),
                                                  jnp.asarray(idx))
    got_mx, got_slot = K.graph_max_pool(_torch(y, tdt), _torch(idx))
    np.testing.assert_array_equal(got_mx.float().numpy(),
                                  np.asarray(want_mx.astype(jnp.float32)))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want_slot))
    assert np.all(got_mx[1, :, :8].float().numpy() == -np.inf)
    assert np.all(got_slot[1, :, :8].numpy() == 0)
    assert np.all(np.isfinite(got_mx[:, :, 8:].float().numpy()))


def test_graph_max_pool_vjp_matches_jax_custom_vjp():
    """Values and the gradient of `geometry.graph_max_pool` against the
    JAX custom VJP (XLA path) on generic f32 data, idx given."""
    from hitadv_tpu.ops import geometry as JG
    from hitadv_torch.ops import geometry as G
    import jax

    rng = np.random.RandomState(16)
    y = rng.randn(2, 90, 24).astype(np.float32)
    idx = rng.randint(0, 90, (2, 90, 20)).astype(np.int32)
    w = rng.randn(2, 90, 24).astype(np.float32)
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        want, vjp = jax.vjp(lambda v: JG.graph_max_pool(v, jnp.asarray(idx)),
                            jnp.asarray(y))
        (want_g,) = vjp(jnp.asarray(w))
    finally:
        JG.set_backend(prev)
    yt = _torch(y).requires_grad_(True)
    got = G.graph_max_pool(yt, _torch(idx))
    (got * _torch(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # XLA's scatter-add and the port's ascending f32 sum: rounding apart
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("N,npoint,same", [
    (130, 32, False), (100, 40, False), (33, 33, False), (1000, 40, False),
    (64, 20, True)], ids=["130-32", "100-40", "33-33", "1000-40",
                          "64-20-all-equal"])
def test_fps_matches_pallas_from_start(N, npoint, same):
    """The contract the card's FPS keeps (`csrc/fps.cu`), on the plain
    version against the JAX package: duplicated points, a start at N - 1,
    N no multiple of 32, npoint = N, and a cloud whose points are all
    equal (every step ties, so every step after the first takes index
    0, the lowest)."""
    rng = np.random.RandomState(7)
    if same:
        xyz = np.repeat(rng.randn(2, 1, 3).astype(np.float32), N, axis=1)
    else:
        xyz = rng.randn(2, N, 3).astype(np.float32)
    xyz[:, -5:] = xyz[:, :5]               # duplicates: equal distances
    start = np.array([5, N - 1], np.int32)
    want = PK.fps_pallas_from_start(jnp.asarray(xyz), npoint,
                                    jnp.asarray(start))
    got = K.fps(_torch(xyz), npoint, _torch(start)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, 0] == start).all()
    if same:
        assert (got[:, 1:] == 0).all()
    elif npoint == N:
        # N - 5 distinct points are taken once each; then every field is
        # 0 and each step takes index 0
        for row in got:
            assert len(set(row[:N - 5].tolist())) == N - 5
            assert (row[N - 5:] == 0).all()


def _nn_plain_order(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """``(|q|^2 - 2 q.p) + |p|^2`` [B, Nq, N] in numpy f32, every sum left
    to right and every operation rounded on its own: the order the 1-NN
    kernel (`csrc/nn.cu`) and the plain version keep."""
    C = q.shape[-1]
    qn, pn = q[..., 0] * q[..., 0], p[..., 0] * p[..., 0]
    cross = q[:, :, None, 0] * p[:, None, :, 0]
    for c in range(1, C):
        qn = qn + q[..., c] * q[..., c]
        pn = pn + p[..., c] * p[..., c]
        cross = cross + q[:, :, None, c] * p[:, None, :, c]
    return (qn[:, :, None] - np.float32(2.0) * cross) + pn[:, None, :]


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_nn_duplicates_and_queries_on_points_match_pallas(C):
    """The 1-NN at k = 1 for C = 1..4 with every point twice and queries
    placed on points (d = 0): indices equal the JAX package's (Pallas in
    interpret mode) and the first minimum of the plain-order distances,
    which the port's distances equal bit for bit; against the JAX
    package's distances within 1e-5."""
    rng = np.random.RandomState(24)
    base = rng.randn(2, 60, C).astype(np.float32)
    p = np.concatenate([base, base], axis=1)          # every point twice
    q = rng.randn(2, 90, C).astype(np.float32)
    q[:, :30] = base[:, 10:40]                        # queries on points
    got_d, got_i = K.knn(_torch(q), _torch(p), 1)
    want_d, want_i = PK.knn_pallas(jnp.asarray(q), jnp.asarray(p), 1)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    d = _nn_plain_order(q, p)
    first = d.argmin(axis=-1)
    np.testing.assert_array_equal(got_i.numpy()[..., 0], first)
    np.testing.assert_array_equal(got_i.numpy()[:, :30, 0],
                                  np.broadcast_to(np.arange(10, 40), (2, 30)))
    np.testing.assert_array_equal(
        got_d.numpy()[..., 0].view(np.uint32),
        np.take_along_axis(d, first[..., None], -1)[..., 0].view(np.uint32))
    assert (got_d.numpy()[:, :30] == 0).all()
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_plain_versions_without_launching():
    K.reset_launches()
    x = torch.randn(2, 40, 3)
    K.knn(x, x, 4)
    K.knn(x, x, 40)
    f = torch.randn(2, 40, 64, dtype=torch.bfloat16)
    K.knn(f, f, 4)
    K.fps(x, 8, torch.zeros(2, dtype=torch.int32))
    K.gather_rows(x, torch.zeros(2, 5, dtype=torch.int32))
    idx = torch.zeros(2, 40, 3, dtype=torch.int32)
    K.scatter_add_rows(idx.reshape(2, -1), torch.randn(2, 120, 3), 40)
    mx, slot = K.graph_max_pool(f, idx)
    K.graph_max_pool_bwd(idx, slot, mx, 40)
    ball = K.ball_query(x, x[:, :7].contiguous(), 0.5, 4)
    grouped = K.gather_group(f, ball)
    K.scatter_add_group(ball, grouped, 40)
    dens = K.kde_density(x, 0.3)
    K.kde_density_bwd(x, 0.3, dens)
    negdt, delta, pert = -torch.rand(2, 40, 5), torch.rand(2, 5) + 0.1, x[:, :5]
    num, deno = K.gaussian_blend_negdt(negdt, delta, pert)
    K.gaussian_blend_negdt_bwd(negdt, delta, pert, num, deno)
    central = x[:, :5].contiguous()
    num, deno = K.gaussian_blend_fused(central, x, delta, pert)
    K.gaussian_blend_fused_bwd(central, x, delta, pert, num, deno)
    assert len(K.LAUNCHES) == 18
    assert all(v == 0 for v in K.LAUNCHES.values())


def test_chip_smoke_counts_launches_by_call_shape():
    """`chip_smoke.KernelRecord` on a stand-in for the kernels module:
    the paths' launches are counted by call shape, a kernel's row is
    weighted by them, and a path shape no kernel phase checked fails."""
    import types

    import chip_smoke as S

    launches = dict.fromkeys(S.WRAPPERS, 0)

    def wrapper(name):
        def launch(*args):
            launches[name] += 1
            return args[0]
        return launch

    fake = types.SimpleNamespace(
        LAUNCHES=launches,
        reset_launches=lambda: launches.update(dict.fromkeys(launches, 0)),
        **{n: wrapper(n) for n in S.WRAPPERS})
    no_sync = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None))
    rec = S.KernelRecord(fake, no_sync)
    a, b = torch.zeros(2, 5, 3), torch.zeros(4, 5, 3)
    ia, ib = torch.zeros(2, 7, dtype=torch.int32), torch.zeros(
        4, 9, dtype=torch.int64)

    def path():
        fake.gather_rows(a, ia)
        fake.gather_rows(a, ia)
        fake.gather_rows(b, ib)

    _, _, counts = rec.counted(path)
    sa, sb = S.shape_of((a, ia)), S.shape_of((b, ib))
    assert sa == "float32[2, 5, 3] int32[2, 7]"
    assert counts["gather_rows"] == 3
    assert rec.path_shapes["gather_rows"] == {sa: 2, sb: 1}

    def timed(ms, graphed=True):
        return dict(max_abs_err=0.0, ms=ms, eager_ms=3 * ms, graphed=graphed,
                    plain_ms=2 * ms, library_ms=None, library_graphed=True,
                    bound_ms=ms / 10, bound_by="bytes")

    rec.cases["gather_rows"] = {sa: timed(1.0)}
    with pytest.raises(AssertionError, match="unchecked"):
        rec.row("gather_rows")
    rec.cases["gather_rows"][sb] = timed(4.0, graphed=False)
    row = rec.row("gather_rows")
    assert row["launches"] == 3 and row["library_ms"] is None
    assert row["ms"] == pytest.approx((2 * 1.0 + 4.0) / 3)
    assert row["eager_ms"] == pytest.approx(3 * (2 * 1.0 + 4.0) / 3)
    assert not row["graphed"] and row["library_graphed"]
    assert row["bound_ms"] == pytest.approx(0.2) and row["bound_by"] == "bytes"
    with pytest.raises(AssertionError, match="never launched"):
        rec.row("fps")


def test_chip_smoke_kde_bound_counts_each_pair_once():
    """`chip_smoke.kde_ops`: the KDE function's work over the B N (N + 1)
    / 2 unordered pairs of its clouds, whatever the kernel issues; at
    N = 1024 the forward is bound by issue, the backward by its
    conversions, and both stay above the bytes."""
    import chip_smoke as S

    x = torch.zeros(16, 1024, 3)
    pairs, adds = 16 * 1024 * 1025 / 2, 16 * 1024 * 1023
    assert S.kde_ops(x, False) == 11 * pairs + adds
    assert S.kde_ops(x, True) == 8 * 3 * pairs
    assert S.kde_ops(torch.zeros(2, 1, 3), False) == 11 * 2   # no adds
    ms, by = S.bound(S.kde_ops(x, True), S.PEAK_INSTR, 16 * 1024 * 28)
    assert by == "operations"
    assert ms == pytest.approx(3 * pairs / S.PEAK_SFU * 1e3)


def _disk_cases():
    """The evaluation's five uniformity disks on clouds of 1024 points:
    (N, S, ns, radius, scale) with S the 51 FPS centres and ns, r from
    `uniform_disks(1024)`; the cloud shrunk so that the disks hold full,
    short and empty balls alike."""
    from hitadv_torch.losses.geoa3 import uniform_disks

    return [(1024, 51, ns, r, 0.3) for _, ns, r, _ in uniform_disks(1024)]


@pytest.mark.parametrize("N,S,ns,radius,scale",
                         [(130, 40, 8, 1.0, 1.0), (100, 30, 16, 0.9, 1.0)]
                         + _disk_cases())
def test_ball_query_matches_pallas(N, S, ns, radius, scale):
    rng = np.random.RandomState(17)
    xyz = (rng.randn(2, N, 3) * scale).astype(np.float32)
    centres = xyz[:, rng.choice(N, S, replace=False)].copy()
    centres[:, -3:] += 10.0                # far from every point: empty
    want = np.asarray(PK.ball_query_pallas(radius, ns, jnp.asarray(xyz),
                                           jnp.asarray(centres)))
    got = K.ball_query(_torch(xyz), _torch(centres), radius, ns)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cases are there: full, short (padded with the first) and empty
    # (all N - 1) balls
    distinct = np.array([[len(set(r)) for r in c] for c in want])
    assert (distinct == ns).any() and ((distinct > 1) & (distinct < ns)).any()
    assert (want[:, -3:] == N - 1).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_group_bitwise(bf16):
    rng = np.random.RandomState(18)
    x = rng.randn(2, 130, 24).astype(np.float32) * 3
    if bf16:
        x = _bf16_values(x)
    idx = rng.randint(0, 130, (2, 40, 8)).astype(np.int32)
    idx[:, :, 5:] = idx[:, :, :1]          # a short ball's padding
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    want = np.asarray(PK.gather_group_pallas(jnp.asarray(x, jdt),
                                             jnp.asarray(idx)
                                             ).astype(jnp.float32))
    assert want.shape == (2, 8, 40, 24)
    for it in (torch.int32, torch.int64):
        got = K.gather_group(_torch(x, tdt), _torch(idx).to(it))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_scatter_add_group_matches_pallas():
    rng = np.random.RandomState(19)
    N, S, ns, C = 130, 40, 8, 24
    idx = rng.randint(0, N, (2, S, ns)).astype(np.int32)
    idx[:, :, 5:] = idx[:, :, :1]          # repeated sources per row
    idx[:, :6, 0] = 11                     # a crowded row
    # integer-valued cotangents: exact on both sides, f32 and bf16
    gi = rng.randint(-8, 9, (2, ns, S, C)).astype(np.float32)
    want = np.asarray(PK.scatter_add_group_pallas(jnp.asarray(idx),
                                                  jnp.asarray(gi), N))
    for it in (torch.int32, torch.int64):
        got = K.scatter_add_group(_torch(idx).to(it), _torch(gi), N)
        np.testing.assert_array_equal(got.numpy(), want)
    got16 = K.scatter_add_group(_torch(idx), _torch(gi, torch.bfloat16), N)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), want)
    # generic f32: the Pallas kernel splits each term into hi|lo bf16
    # halves (2^-17 relative per term); the port sums true f32
    g = rng.randn(2, ns, S, C).astype(np.float32)
    want = np.asarray(PK.scatter_add_group_pallas(jnp.asarray(idx),
                                                  jnp.asarray(g), N))
    got = K.scatter_add_group(_torch(idx), _torch(g), N).numpy()
    mass = K.scatter_add_group(_torch(idx), _torch(np.abs(g)), N).numpy()
    assert (np.abs(got - want) <= 2.0 ** -17 * mass + 1e-6 * mass).all()


@pytest.mark.parametrize("k", [64, 65, 128])
@pytest.mark.parametrize("Nq,N,C", [(128, 512, 3), (100, 130, 13)])
def test_knn_at_k64_matches_jax(Nq, N, C, k):
    """PointConv's second stage groups by 64 neighbours, and `--k` may
    ask for more (the card then selects in passes of 64): the plain kNN
    at k = 64, 65 and 128 against the JAX package's `knn_idx` (XLA) and
    `knn_pallas`."""
    from hitadv_tpu.ops import geometry as JG

    rng = np.random.RandomState(20)
    q = rng.randn(2, Nq, C).astype(np.float32)
    p = rng.randn(2, N, C).astype(np.float32)
    p[:, 90] = p[:, 4]                     # a duplicate: an exact tie
    got_d, got_i = K.knn(_torch(q), _torch(p), k)
    assert got_i.shape == (2, Nq, k)
    want_i = np.asarray(JG.knn_idx(jnp.asarray(q), jnp.asarray(p), k))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    want_d, want_i = PK.knn_pallas(jnp.asarray(q), jnp.asarray(p), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # the Pallas kernel's matmul form of the distance against the port's
    # left-to-right elementwise form: f32 rounding of C-term sums
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,N,bw", [(2, 200, 0.1), (1, 512, 0.2),
                                    (3, 100, 0.4)])
def test_kde_density_pair_matches_pallas(B, N, bw):
    """The KDE pair's plain versions against the Pallas kernels (the
    shapes of `tests/test_pallas_kernels.py::TestKDEDensity`)."""
    rng = np.random.RandomState(21)
    x = rng.randn(B, N, 3).astype(np.float32)
    g = rng.randn(B, N).astype(np.float32)
    want = np.asarray(PK.kde_density_pallas(jnp.asarray(x), bw))
    got = K.kde_density(_torch(x), bw)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    # both take the subtract form of the distance; the port sums in f64,
    # the Pallas kernel in f32 lanes: a few f32 ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    want_g = np.asarray(PK.kde_density_bwd_pallas(jnp.asarray(x), bw,
                                                  jnp.asarray(g)))
    got_g = K.kde_density_bwd(_torch(x), bw, _torch(g)).numpy()
    # the Pallas kernel's expanded form x_p (...) - (...) cancels (up to
    # ~1e-5 relative at bandwidth 0.1); the port sums the product form
    assert np.linalg.norm(got_g - want_g) <= 3e-5 * np.linalg.norm(want_g)
    # bf16 coordinates are widened exactly
    xb = _bf16_values(x)
    np.testing.assert_array_equal(
        K.kde_density(_torch(xb, torch.bfloat16), bw).numpy(),
        K.kde_density(_torch(xb), bw).numpy())


# csrc/kde_density.cu's WARPS: the strided partials of a row's sum
_KDE_WARPS = int(re.search(
    r"constexpr int WARPS = (\d+);",
    (pathlib.Path(__file__).parent.parent / "hitadv_torch" / "ops" / "csrc"
     / "kde_density.cu").read_text()).group(1))


def _split_sum(terms: torch.Tensor) -> torch.Tensor:
    """Row sums of f32 ``terms`` [B, N, N] in the KDE kernels' order: the
    terms widened to f64; partial w the terms of j = w (mod WARPS) added
    in ascending j from 0.0 (a sequential cumulative sum); the partials
    added in warp order; rounded once to f32."""
    B, N, _ = terms.shape
    t = terms.double().numpy().reshape(B, N, N // _KDE_WARPS, _KDE_WARPS)
    part = np.cumsum(t, axis=2)[:, :, -1, :]
    total = part[..., 0]
    for w in range(1, _KDE_WARPS):
        total = total + part[..., w]
    return torch.from_numpy(total).float()


@pytest.mark.parametrize("bw", [0.1, 0.2, 0.4])
def test_kde_split_order_stays_within_sum_tol(bw):
    """A numpy model of the KDE kernels' summation order (strided
    partials over a block's warps, added in warp order) against the plain
    versions' f64 sums, at PointConv's stage bandwidths: within
    `chip_smoke.SUM_TOL`, and equal in at least 99.9% of the entries in
    each direction (measured: all 2048 forward and 6144 backward entries
    at each bandwidth)."""
    from chip_smoke import SUM_TOL, within

    rng = np.random.RandomState(22)
    B, N = 2, 1024
    x = _torch(rng.randn(B, N, 3).astype(np.float32) * 0.5)
    g = _torch(rng.randn(B, N).astype(np.float32))
    inv2bw2, scale = K._kde_constants(N, bw)
    d, w = K._kde_terms(x, inv2bw2)
    dens = _split_sum(w) * scale
    want = K.kde_density_plain(x, bw)
    within(SUM_TOL, "max")(dens, want, "split forward")
    assert (dens == want).float().mean().item() >= 0.999
    t = w * (g[:, :, None] + g[:, None, :])
    c0 = -2.0 * scale * inv2bw2
    gx = torch.stack([_split_sum(t * dc) for dc in d], dim=-1) * c0
    want = K.kde_density_bwd_plain(x, bw, g)
    within(SUM_TOL, "l2")(gx, want, "split backward")
    assert (gx == want).float().mean().item() >= 0.999


def _blend_inputs(rng, B, Cn, N):
    """The blend tests' inputs of the JAX package (`tests/
    test_pallas_kernels.py`, `_inputs`): centres on cloud points (the
    d = 0 corner), the transposed field [B, N, Cn]."""
    from hitadv_tpu.ops import geometry as JG

    ori = rng.randn(B, N, 3).astype(np.float32)
    sel = rng.randint(0, N, size=(B, Cn))
    central = np.stack([ori[b, sel[b]] for b in range(B)])
    delta = (0.1 + rng.rand(B, Cn) * 1.1).astype(np.float32)
    pert = (rng.randn(B, Cn, 3) * 0.1).astype(np.float32)
    negdt = np.asarray(jnp.swapaxes(JG.neg_gaussian_field(
        jnp.asarray(central), jnp.asarray(ori)), 1, 2))
    return negdt, delta, pert


@pytest.mark.parametrize("B,Cn,N", [(2, 12, 200), (1, 192, 512),
                                    (3, 8, 100), (2, 15, 130)])
def test_gaussian_blend_negdt_pair_matches_pallas(B, Cn, N):
    rng = np.random.RandomState(22)
    negdt, delta, pert = _blend_inputs(rng, B, Cn, N)
    g_num = rng.randn(B, N, 3).astype(np.float32)
    g_deno = rng.randn(B, N).astype(np.float32)
    args = [jnp.asarray(a) for a in (negdt, delta, pert)]
    want_num, want_deno = PK.gaussian_blend_negdt_pallas(*args)
    num, deno = K.gaussian_blend_negdt(*(_torch(a) for a in (negdt, delta,
                                                             pert)))
    # the same f32 ker on both sides; the Pallas dot sums in f32, the
    # port in f64: f32 rounding of Cn-term sums
    np.testing.assert_allclose(num.numpy(), np.asarray(want_num), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(deno.numpy(), np.asarray(want_deno),
                               rtol=1e-5, atol=1e-6)
    want_gd, want_gp = PK.gaussian_blend_negdt_bwd_pallas(
        *args, jnp.asarray(g_num), jnp.asarray(g_deno))
    gd, gp = K.gaussian_blend_negdt_bwd(*(_torch(a) for a in (
        negdt, delta, pert, g_num, g_deno)))
    assert gd.shape == (B, Cn) and gp.shape == (B, Cn, 3)
    # N-term sums over the cloud, f32 on the TPU side and f64 here
    for got, want in ((gd, want_gd), (gp, want_gp)):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(
            want)


# csrc/gaussian_blend.cu's tile constants: the order of its f64 sums
_BLEND = {name: int(v) for name, v in re.findall(
    r"constexpr int (\w+) = (\d+);",
    (ROOT / "hitadv_torch" / "ops" / "csrc" / "gaussian_blend.cu"
     ).read_text())}


def _in_order(terms: np.ndarray, seq) -> np.ndarray:
    """``0.0 + t[seq[0]] + t[seq[1]] + ...`` along axis 1 of ``terms``, one
    add at a time (a sequential cumulative sum)."""
    if len(seq) == 0:
        return np.zeros(terms.shape[:1] + terms.shape[2:])
    return np.cumsum(terms[:, seq], axis=1)[:, -1]


def _blend_fwd_order(t: np.ndarray) -> np.ndarray:
    """Row sums of f64 ``t`` [B, N, Cn, 4] in the forward kernel's order:
    part h (of FWD_PARTS) of a row adds, chunk of CCH centres by chunk,
    the chunk's groups of 4 centres h, h + PARTS, ... in ascending order;
    the parts are added pairwise, ((p0 + p1) + (p2 + p3)) + ..."""
    B, N, Cn, _ = t.shape
    parts, cch = _BLEND["FWD_PARTS"], _BLEND["CCH"]
    acc = []
    for h in range(parts):
        seq = []
        for c0 in range(0, Cn, cch):
            cc = min(cch, Cn - c0)
            seq += [c0 + j for j in range(cc) if j // 4 % parts == h]
        acc.append(_in_order(t.transpose(0, 2, 1, 3), seq))
    o = 1
    while o < parts:
        acc = [acc[h] + acc[h ^ o] for h in range(parts)]
        o *= 2
    return acc[0]


def _blend_bwd_order(t: np.ndarray) -> np.ndarray:
    """Column sums of f64 ``t`` [B, N, Cn, 4] in the backward kernel's
    order: the cluster's tiles (BWD_CLUSTER at most, of about
    BWD_BLOCK_ROWS rows) each add their row phases' sums (phase p the
    rows r0 + p, r0 + p + phases, ...) in phase order; the tiles' sums
    are added in rank order."""
    B, N, Cn, _ = t.shape
    tiles = min(_BLEND["BWD_CLUSTER"], -(-N // _BLEND["BWD_BLOCK_ROWS"]))
    RB = -(-N // tiles)
    CB = (-(-Cn // 32) * 32 if Cn <= _BLEND["BWD_STAGED_MAX_CN"]
          else _BLEND["BWD_WIDE_CB"])
    phases = _BLEND["BWD_THREADS"] // CB
    total = None
    for r in range(tiles):
        r0, r1 = min(N, r * RB), min(N, r * RB + RB)
        block = None
        for p in range(phases):
            s = _in_order(t, list(range(r0 + p, r1, phases)))
            block = s if block is None else block + s
        total = block if total is None else total + block
    return total


@pytest.mark.parametrize("B,Cn,N", [(2, 192, 1024), (1, 3100, 300)])
def test_blend_kernel_order_stays_within_sum_tol(B, Cn, N):
    """A numpy model of the negdt blend kernels' summation order (a row's
    interleaved parts added pairwise forward; row phases, then a
    cluster's tiles, in order backward), read from the source's constants,
    against the
    plain versions' f64 sums on the plain versions' f32 terms: within
    `chip_smoke.SUM_TOL`, and equal in at least 99% of the entries,
    at HiT-ADV's Cn = 192 and at a Cn past the old cap of 3072 (more
    than one chunk of centres)."""
    from chip_smoke import SUM_TOL, within

    rng = np.random.RandomState(25)
    negdt, delta, pert = (_torch(a) for a in _blend_inputs(rng, B, Cn, N))
    g_num = _torch(rng.randn(B, N, 3).astype(np.float32))
    g_deno = _torch(rng.randn(B, N).astype(np.float32))
    ker = K._blend_ker(negdt, delta)                          # f32
    kd = ker.double().numpy()
    pd = pert.double().numpy()
    t = np.stack([kd * pd[:, None, :, 0], kd * pd[:, None, :, 1],
                  kd * pd[:, None, :, 2], kd], axis=-1)
    fwd = torch.from_numpy(_blend_fwd_order(t)).float()
    num, deno = K.gaussian_blend_negdt_plain(negdt, delta, pert)
    within(SUM_TOL, "max")((fwd[..., :3], fwd[..., 3]), (num, deno),
                           "forward order")
    gker = ((g_num[..., 0:1] * pert[:, None, :, 0]
             + g_num[..., 1:2] * pert[:, None, :, 1])
            + g_num[..., 2:3] * pert[:, None, :, 2]) + g_deno[..., None]
    gd = g_num.double().numpy()
    t = np.stack([kd * gd[..., 0:1], kd * gd[..., 1:2], kd * gd[..., 2:3],
                  (gker * ker).double().numpy()
                  * (-negdt).double().numpy()], axis=-1)
    sums = torch.from_numpy(_blend_bwd_order(t))             # [B, Cn, 4]
    dinv = 1.0 / delta
    bwd = (sums[..., 3].float() * (dinv * dinv * dinv),
           sums[..., :3].float())
    want = K.gaussian_blend_negdt_bwd_plain(negdt, delta, pert, g_num,
                                            g_deno)
    within(SUM_TOL, "l2")(bwd, want, "backward order")
    for got, ref in ((fwd[..., :3], num), (fwd[..., 3], deno)) + tuple(
            zip(bwd, want)):
        assert (got == ref).float().mean().item() >= 0.99


def test_blend_quotient_from_f64_reciprocal_is_ieee_division():
    """`csrc/gaussian_blend.cu`'s `quot`: the f32 quotient a / b as
    RN32(RN64(a RN64(1 / b))), one f64 division a divisor. numpy rounds
    each f64 operation and the f32 cast as the card does, so this checks
    the scheme itself: bit for bit the IEEE f32 quotient (the plain
    version's division) over random bit patterns of every exponent,
    subnormals, zeros, infinities and NaNs, and HiT-ADV's own range."""
    rng = np.random.RandomState(27)
    n = 1 << 22
    a = rng.randint(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    a, b = a.view(np.float32), b.view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1.17549435e-38, 3.4028235e38, 1.0, -1.0, 3.0],
                       np.float32)
    grid_a, grid_b = np.meshgrid(special, special)
    negdt = -(rng.rand(n) * 3).astype(np.float32)       # the field's range
    den = (2 * (0.1 + rng.rand(n) * 1.1) ** 2).astype(np.float32)
    a = np.concatenate([a, grid_a.ravel(), negdt])
    b = np.concatenate([b, grid_b.ravel(), den])
    with np.errstate(all="ignore"):
        want = a / b
        got = (a.astype(np.float64)
               * (1.0 / b.astype(np.float64))).astype(np.float32)
    same = (want.view(np.uint32) == got.view(np.uint32)) | (
        np.isnan(want) & np.isnan(got))
    assert same.all(), (a[~same][:4], b[~same][:4])


def test_cpu_paths_take_sizes_past_the_card_caps():
    """The sizes past the CUDA kernels' former caps (ROADMAP §3 fault 1,
    closed: the card's instances for them are held against these plain
    versions by tests/test_torch_cuda.py) run on the CPU too: FPS past
    8192 points, the three scatters past 49152 rows, the fused blend past
    1536 centres and the negdt blend past the old 3072."""
    rng = np.random.RandomState(26)
    x = _torch(rng.randn(1, 8193, 3).astype(np.float32))
    out = K.fps(x, 4, torch.tensor([8192], dtype=torch.int32))
    assert out.shape == (1, 4) and out[0, 0].item() == 8192
    n = 49153
    idx = torch.tensor([[0, n - 1, n - 1]], dtype=torch.int32)
    g = torch.ones(1, 3, 2)
    want = torch.zeros(1, n, 2)
    want[0, 0], want[0, n - 1] = 1.0, 2.0
    assert torch.equal(K.scatter_add_rows(idx, g, n), want)
    assert torch.equal(K.scatter_add_group(idx[:, :, None],
                                           g[:, None], n), want)
    slot = torch.zeros(1, 3, 2, dtype=torch.int32)
    assert torch.equal(K.graph_max_pool_bwd(idx[..., None], slot, g, n),
                       want)
    ori = _torch(rng.randn(1, 40, 3).astype(np.float32))
    for Cn in (1537, 3073):
        central = ori[:, rng.randint(0, 40, Cn)].contiguous()
        delta = _torch((0.1 + rng.rand(1, Cn)).astype(np.float32))
        pert = _torch(rng.randn(1, Cn, 3).astype(np.float32) * 0.1)
        num, deno = K.gaussian_blend_fused(central, ori, delta, pert)
        negdt = -torch.cdist(ori, central)
        num2, deno2 = K.gaussian_blend_negdt(negdt, delta, pert)
        assert num.shape == num2.shape == (1, 40, 3)
        assert bool(torch.isfinite(deno).all() & torch.isfinite(deno2).all())


# csrc/gaussian_blend_fused.cu's constants: its backward's layout and the
# order of its f64 sums
_FUSED = {name: int(v) for name, v in re.findall(
    r"constexpr int (\w+) = (\d+);",
    (ROOT / "hitadv_torch" / "ops" / "csrc" / "gaussian_blend_fused.cu"
     ).read_text())}


def test_fps_scratch_threshold_mirrors_the_source():
    """`kernels.fps` allocates the global-memory kernel's distance scratch
    past the staged kernels' size, as `csrc/fps.cu` chooses it."""
    src = (ROOT / "hitadv_torch" / "ops" / "csrc" / "fps.cu").read_text()
    staged = int(re.search(r"constexpr int STAGED_MAX = (\d+);",
                           src).group(1))
    assert K._FPS_STAGED_MAX == staged


def _fused_bwd_layout(B: int, N: int, Cn: int):
    """(G, splits, tiles) as the fused backward's `bwd_layout` chooses
    them from the shape and the source's constants: G point groups of 32
    a warp, the centres in ``splits`` ranges of whole groups of 32, and
    ``tiles`` tiles of 32 BWD_WARPS G points a cloud."""
    W, target = _FUSED["BWD_WARPS"], _FUSED["BWD_TARGET_BLOCKS"]
    blocks1 = B * -(-N // (32 * W))
    groups = -(-Cn // 32)
    if blocks1 >= target:
        G = min(_FUSED["BWD_MAX_GROUPS"], blocks1 // target)
        splits = 1
    else:
        G = 1
        splits = min(groups, -(-target // blocks1))
    per_split = -(-groups // splits)
    return G, -(-groups // per_split), -(-N // (32 * W * G))


def test_fused_bwd_layout_from_the_source_constants():
    """The model of the fused backward's layout gives the layouts the
    source's header names: six centre ranges at the flagship shape, two
    point groups a warp at `chip_smoke.FUSED_LARGE`, whose f64 sums
    (part [B, tiles, Cn, 7], 176 MB) stay under 1/8 of its 3.2 GB
    field. tests/test_torch_cuda.py holds the library's scratch size to
    the same layouts on the card."""
    from chip_smoke import FUSED_LARGE

    assert _fused_bwd_layout(64, 1024, 192) == (1, 6, 8)
    B, N, Cn = FUSED_LARGE
    G, splits, tiles = _fused_bwd_layout(B, N, Cn)
    assert (G, splits, tiles) == (2, 1, 1024)
    assert B * tiles * Cn * 7 * 8 <= 4 * B * N * Cn / 8


def _fused_bwd_order(tc: np.ndarray, N: int, Cn: int, G: int,
                     splits: int):
    """The fused backward kernel's sums of the f64 terms ``tc`` [B, N, Cn,
    7] (w dx, w dy, w dz, gkk d, k g_x, k g_y, k g_z), in its order:
    -> (the points' g_ori sums [B, N, 3], the centres' sums [B, Cn, 7]).

    A point's sums (the first three terms): each centre range in order,
    each from 0; in a range the chunks of BWD_CCH centres and their groups
    of 32 in order, and in a group, for the point's lane l = n mod 32,
    the centres l, l - 1, ... (mod 32); the ranges' sums added in order.
    A centre's sums: each tile of 32 BWD_WARPS G points in order; in a
    tile each warp's from 0 (its G groups of 32 points in order, in a
    group the points l, l + 1, ... (mod 32) for the centre's lane l = j
    mod 32), the warps' added in order, from 0."""
    W, cch = _FUSED["BWD_WARPS"], _FUSED["BWD_CCH"]
    groups = -(-Cn // 32)
    gps = -(-groups // splits)
    B = tc.shape[0]
    gori = np.zeros((B, N, 3))
    for sp in range(splits):
        jb, je = sp * gps * 32, min(Cn, (sp + 1) * gps * 32)
        part = np.zeros((B, N, 3))
        for l in range(32):
            seq = []
            for c0 in range(jb, je, cch):
                cn = min(cch, je - c0)
                for g0 in range(0, cn, 32):
                    seq += [c0 + g0 + (l - i) % 32 for i in range(32)
                            if g0 + (l - i) % 32 < cn]
            pts = np.arange(l, N, 32)
            if len(pts) and seq:
                part[:, pts] = np.cumsum(tc[:, pts][:, :, seq, :3],
                                         axis=2)[:, :, -1]
        gori = part if splits == 1 else gori + part
    tp = 32 * W * G
    cent = np.zeros((B, Cn, 7))
    for t0 in range(0, N, tp):
        block = np.zeros((B, Cn, 7))
        for w in range(W):
            warp = np.zeros((B, Cn, 7))
            for l in range(32):
                seq = [t0 + (w * G + g) * 32 + (l + i) % 32
                       for g in range(G) for i in range(32)]
                seq = [n for n in seq if n < N]
                js = np.arange(l, Cn, 32)
                if seq and len(js):
                    warp[:, js] = np.cumsum(tc[:, seq][:, :, js], axis=1)[
                        :, -1]
            block = block + warp
        cent = cent + block
    return gori, cent


@pytest.mark.parametrize("B,Cn,N,layout_of", [
    (2, 192, 1024, (64, 1024, 192)), (2, 192, 2048, (16, 262144, 192)),
    (1, 1600, 300, (1, 300, 1600))])
def test_fused_bwd_kernel_order_stays_within_sum_tol(B, Cn, N, layout_of):
    """A numpy model of the fused backward kernel's summation order
    (`_fused_bwd_order`, read from the source's constants, at the layout
    the card takes for ``layout_of``: the flagship's six centre ranges,
    `FUSED_LARGE`'s two point groups a warp, a Cn past the old cap of
    1536 in 50 ranges) against the plain version's f64 sums of
    the same f32 terms: within `chip_smoke.SUM_TOL`, and equal in at
    least 99% of the entries."""
    from chip_smoke import SUM_TOL, within

    rng = np.random.RandomState(28)
    ori = (rng.randn(B, N, 3) * 0.5).astype(np.float32)
    sel = rng.randint(0, N, size=(B, Cn))
    central = np.stack([ori[b, sel[b]] for b in range(B)])
    delta = (0.1 + rng.rand(B, Cn) * 1.1).astype(np.float32)
    pert = ((rng.rand(B, Cn, 3) * 2 - 1) * 0.55).astype(np.float32)
    g_num = rng.randn(B, N, 3).astype(np.float32)
    g_deno = rng.randn(B, N).astype(np.float32)
    args = [_torch(a) for a in (central, ori, delta, pert, g_num, g_deno)]
    central_t, ori_t, delta_t, pert_t, gn, gd = args
    diffs, d, ker = K._fused_terms(central_t, ori_t, delta_t)
    gker = ((gn[..., 0:1] * pert_t[:, None, :, 0]
             + gn[..., 1:2] * pert_t[:, None, :, 1])
            + gn[..., 2:3] * pert_t[:, None, :, 2]) + gd[..., None]
    gkk = gker * ker
    w = ((gkk / (2.0 * delta_t * delta_t)[:, None, :]) / d).double()
    kd = ker.double()
    gnd = gn.double()
    tc = torch.stack([w * diffs[0].double(), w * diffs[1].double(),
                      w * diffs[2].double(), gkk.double() * d.double(),
                      kd * gnd[..., 0:1], kd * gnd[..., 1:2],
                      kd * gnd[..., 2:3]], dim=-1).numpy()
    G, splits, _ = _fused_bwd_layout(*layout_of)
    gori, cent = _fused_bwd_order(tc, N, Cn, G, splits)
    cent = torch.from_numpy(cent)
    dinv = 1.0 / delta_t
    got = (cent[..., 0:3].float(), -torch.from_numpy(gori).float(),
           cent[..., 3].float() * (dinv * dinv * dinv),
           cent[..., 4:7].float())
    want = K.gaussian_blend_fused_bwd_plain(*args)
    within(SUM_TOL, "l2")(got, want, "fused backward order")
    for a, b in zip(got, want):
        assert (a == b).float().mean().item() >= 0.99


def _fma32(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """The f32 fused multiply-add RN32(x y + z), exactly: x y is exact in
    f64; the f64 sum with z is taken with its rounding error (TwoSum) and
    rounded to odd, which then rounds to f32 as the exact value does (53
    bits >= 24 + 2). Finite, non-overflowing operands."""
    p = x.astype(np.float64) * y.astype(np.float64)
    z = z.astype(np.float64)
    s = p + z
    bp = s - z
    e = (p - bp) + (z - (s - bp))
    odd = (s.view(np.uint64) & 1) == 1
    to_odd = np.nextafter(s, np.where(e > 0, np.inf, -np.inf))
    return np.where((e == 0) | odd, s, to_odd).astype(np.float32)


def _fwd_quotient(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`csrc/gaussian_blend_fused.cu`'s forward quotient a / b: y = RN(1 /
    b) once a centre, q0 = RN(a y), q = fma(fma(-q0, b, a), y, q0)."""
    y = np.float32(1) / b
    q0 = a * y
    return _fma32(_fma32(-q0, b, a), y, q0)


def test_fused_fwd_fma_model_rounds_once():
    """`_fma32` against exact rational arithmetic, where products and sums
    cancel and where the sum falls near an f32 midpoint."""
    from fractions import Fraction

    rng = np.random.RandomState(31)
    n = 3000
    x = (rng.randn(n) * 2.0 ** rng.randint(-10, 10, n)).astype(np.float32)
    y = (rng.randn(n) * 2.0 ** rng.randint(-10, 10, n)).astype(np.float32)
    z = np.where(rng.rand(n) < 0.5, -(x.astype(np.float64) * y),
                 rng.randn(n) * 2.0 ** rng.randint(-30, 10, n)
                 ).astype(np.float32)
    half = (2.0 ** -24 * (1 + rng.randint(0, 1 << 12, n) / 4096.0)
            ).astype(np.float32)                     # near half an ulp of z
    z2 = (1 + rng.rand(n)).astype(np.float32)
    for xs, ys, zs in ((x, y, z), (half, np.ones(n, np.float32), z2)):
        got = _fma32(xs, ys, zs)
        for i in range(n):
            v = Fraction(float(xs[i])) * Fraction(float(ys[i])) + Fraction(
                float(zs[i]))
            c = np.float32(float(v))
            near = [np.nextafter(c, np.float32(-np.inf)), c,
                    np.nextafter(c, np.float32(np.inf))]
            want = min(near, key=lambda f: (abs(Fraction(float(f)) - v),
                                            int(f.view(np.uint32)) & 1))
            assert got[i] == want, (xs[i], ys[i], zs[i])


def test_fused_fwd_quotient_from_f32_reciprocal_is_ieee_division():
    """The fused forward's quotient -d / (2 delta^2) from the centre's
    correctly rounded f32 reciprocal (Markstein's correction, two FMAs),
    modelled with exact FMAs (`_fma32`): bit for bit the IEEE f32
    quotient (the plain version's division) wherever the kernel takes it,
    i.e. |a| in [2^-E, 2^(E+2)] and b in [2^-E, 2^E] for the source's
    E = FWD_TAME_EXP: over random significands at every exponent of that
    range, HiT-ADV's own range, and every significand of b against
    chosen ones of a (and the reverse)."""
    E = _FUSED["FWD_TAME_EXP"]
    rng = np.random.RandomState(32)

    def floats(n, lo, hi, sign=True):
        bits = (rng.randint(lo + 127, hi + 128, n).astype(np.uint32) << 23
                | rng.randint(0, 1 << 23, n).astype(np.uint32))
        if sign:
            bits |= rng.randint(0, 2, n).astype(np.uint32) << 31
        return bits.view(np.float32)

    n = 1 << 21
    pairs = [(floats(n, -E, E + 1), floats(n, -E, E - 1, sign=False)),
             (-(np.sqrt(rng.rand(n) * 12) + 1e-12).astype(np.float32),
              (2 * (0.1 + rng.rand(n) * 1.1) ** 2).astype(np.float32))]
    every = ((127 << 23) | np.arange(1 << 23, dtype=np.uint32)).view(
        np.float32)

    def sig(m):
        return np.full(1 << 23, (127 << 23) | m, np.uint32).view(np.float32)
    pairs += [(sig(0), every), (sig((1 << 23) - 1), every),
              (every, sig((1 << 23) - 1)), (every, sig(0x555555))]
    for a, b in pairs:
        same = (a / b).view(np.uint32) == _fwd_quotient(a, b).view(
            np.uint32)
        assert same.all(), (a[~same][:4], b[~same][:4])
    # the tame inputs' range: d = sqrt(s + 1e-24) >= 2^-E, and |dx| < 2^(E+1)
    # keeps d < 2^(E+2)
    assert np.sqrt(np.float32(1e-24)) >= np.float32(2.0 ** -E)
    big = np.float32(2.0 ** (E + 1))
    assert np.sqrt(np.float32(3) * big * big) < 2.0 ** (E + 2)


def _fused_fwd_order(t: np.ndarray) -> np.ndarray:
    """The fused forward kernel's sums of the f64 terms ``t`` [B, N, Cn, 4]
    (k px, k py, k pz, k) in its order -> [B, N, 4]: split s's sums, from
    0, over the s-th of S = FWD_S ranges of ceil(cc / S) centres of each
    chunk of FWD_CCH, chunks and centres in ascending order; then the
    splits' sums added in split order (split 0's first)."""
    cch, S = _FUSED["FWD_CCH"], _FUSED["FWD_S"]
    Cn = t.shape[2]
    parts = np.zeros((S,) + t.shape[:2] + (4,))
    for j0 in range(0, Cn, cch):
        cc = min(cch, Cn - j0)
        per = -(-cc // S)
        for s in range(S):
            for j in range(min(cc, s * per), min(cc, s * per + per)):
                parts[s] += t[:, :, j0 + j]
    total = parts[0]
    for s in range(1, S):
        total = total + parts[s]
    return total


@pytest.mark.parametrize("B,Cn,N", [(2, 192, 1024), (1, 1600, 300),
                                    (2, 45, 1000), (3, 7, 130)])
def test_fused_fwd_kernel_order_stays_within_sum_tol(B, Cn, N):
    """A numpy model of the fused forward kernel's summation order
    (`_fused_fwd_order`, read from the source's constants) against the
    plain version's f64 sums of the same f32 terms, at the flagship's
    Cn, a Cn past a staged chunk, and short last split ranges: within
    `chip_smoke.SUM_TOL`, and equal in at least 99% of the entries."""
    from chip_smoke import SUM_TOL, within

    rng = np.random.RandomState(33)
    ori = (rng.randn(B, N, 3) * 0.5).astype(np.float32)
    sel = rng.randint(0, N, size=(B, Cn))
    central = np.stack([ori[b, sel[b]] for b in range(B)])
    delta = (0.1 + rng.rand(B, Cn) * 1.1).astype(np.float32)
    pert = ((rng.rand(B, Cn, 3) * 2 - 1) * 0.55).astype(np.float32)
    args = [_torch(a) for a in (central, ori, delta, pert)]
    kd = K._fused_terms(*args[:3])[2].double().numpy()
    pd = args[3].double().numpy()
    t = np.stack([kd * pd[:, None, :, 0], kd * pd[:, None, :, 1],
                  kd * pd[:, None, :, 2], kd], axis=-1)
    sums = torch.from_numpy(_fused_fwd_order(t)).float()
    got = (sums[..., :3], sums[..., 3])
    want = K.gaussian_blend_fused_plain(*args)
    within(SUM_TOL, "max")(got, want, "fused forward order")
    for a, b in zip(got, want):
        assert (a == b).float().mean().item() >= 0.99


@pytest.mark.parametrize("B,Cn,N", [(2, 12, 200), (1, 192, 512),
                                    (2, 15, 130)])
def test_gaussian_blend_fused_pair_matches_pallas(B, Cn, N):
    """The fused pair's plain versions against the Pallas kernels, at
    shapes that pad Cn to 8 and N to 128 on the TPU side; centres on cloud
    points (the d = 0 corner)."""
    rng = np.random.RandomState(23)
    ori = rng.randn(B, N, 3).astype(np.float32)
    sel = rng.randint(0, N, size=(B, Cn))
    central = np.stack([ori[b, sel[b]] for b in range(B)])
    delta = (0.1 + rng.rand(B, Cn) * 1.1).astype(np.float32)
    pert = (rng.randn(B, Cn, 3) * 0.1).astype(np.float32)
    g_num = rng.randn(B, N, 3).astype(np.float32)
    g_deno = rng.randn(B, N).astype(np.float32)
    args = (central, ori, delta, pert)
    want_num, want_deno = PK.gaussian_blend_pallas(
        *(jnp.asarray(a) for a in args))
    num, deno = K.gaussian_blend_fused(*(_torch(a) for a in args))
    assert num.shape == (B, N, 3) and deno.shape == (B, N)
    # the same f32 terms on both sides; the Pallas dot sums in f32, the
    # port exact f64 products in f64: f32 rounding of Cn-term sums
    np.testing.assert_allclose(num.numpy(), np.asarray(want_num), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(deno.numpy(), np.asarray(want_deno),
                               rtol=1e-5, atol=1e-6)
    want = PK.gaussian_blend_bwd_pallas(
        *(jnp.asarray(a) for a in args + (g_num, g_deno)))
    got = K.gaussian_blend_fused_bwd(*(_torch(a) for a in args
                                       + (g_num, g_deno)))
    # sums over Cn (g_ori) and over the cloud (the rest), f32 on the TPU
    # side and f64 here; the TPU backward also forms ker by a reciprocal
    # multiply where the port divides (one f32 rounding of the exponent)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)


def test_gaussian_blend_fused_plain_chunks_sum_alike():
    """The plain versions walk N in chunks (so that they run where the
    field would not fit); any chunking gives the same bits here."""
    rng = np.random.RandomState(24)
    ori = _torch(rng.randn(2, 300, 3).astype(np.float32))
    args = (ori[:, ::25].contiguous(), ori,
            _torch((0.1 + rng.rand(2, 12)).astype(np.float32)),
            _torch(rng.randn(2, 12, 3).astype(np.float32) * 0.1))
    gs = (_torch(rng.randn(2, 300, 3).astype(np.float32)),
          _torch(rng.randn(2, 300).astype(np.float32)))
    whole = (K.gaussian_blend_fused_plain(*args)
             + K.gaussian_blend_fused_bwd_plain(*args, *gs))
    real = K._fused_chunks
    K._fused_chunks = lambda B, N, Cn: [slice(n0, min(N, n0 + 37))
                                        for n0 in range(0, N, 37)]
    try:
        chunked = (K.gaussian_blend_fused_plain(*args)
                   + K.gaussian_blend_fused_bwd_plain(*args, *gs))
    finally:
        K._fused_chunks = real
    assert len(real(2, 300, 12)) == 1
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def _port_files():
    return sorted((ROOT / "hitadv_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_profile_turns.py",
        ROOT / "scripts" / "torch_sass_loops.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    banned = ("jax", "jaxlib", "hitadv_tpu")
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")
