"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper in `hitadv_torch.ops.kernels` runs its plain
PyTorch version; the JAX side runs the Pallas kernel in interpret mode,
as `tests/test_pallas_kernels.py` does. Inputs come from numpy seeds.
The CUDA kernels themselves are held against their plain versions on a
card by `tests/test_torch_cuda.py` and by `chip_smoke.py`.
"""

import ast
import pathlib

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
    """Feature space is ported up to the kernel's 256 staged channels;
    wider features, and mixed dtypes, are refused on every device; so is
    k beyond the kernel's longest top-k list (64)."""
    x = torch.zeros(1, 16, 257)
    with pytest.raises(ValueError, match="C=257"):
        K.knn(x, x, 4)
    z = torch.zeros(1, 100, 3)
    with pytest.raises(ValueError, match="k=65"):
        K.knn(z, z, 65)
    y = torch.zeros(1, 16, 8)
    with pytest.raises(TypeError):
        K.knn(y, y.to(torch.bfloat16), 4)


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


@pytest.mark.parametrize("N,npoint", [(130, 32), (100, 40)])
def test_fps_matches_pallas_from_start(N, npoint):
    rng = np.random.RandomState(7)
    xyz = rng.randn(2, N, 3).astype(np.float32)
    xyz[:, -5:] = xyz[:, :5]               # duplicates: equal distances
    start = np.array([5, N - 1], np.int32)
    want = PK.fps_pallas_from_start(jnp.asarray(xyz), npoint,
                                    jnp.asarray(start))
    got = K.fps(_torch(xyz), npoint, _torch(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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

    def timed(ms):
        return dict(max_abs_err=0.0, ms=ms, plain_ms=2 * ms, library_ms=None,
                    bound_ms=ms / 10, bound_by="bytes")

    rec.cases["gather_rows"] = {sa: timed(1.0)}
    with pytest.raises(AssertionError, match="unchecked"):
        rec.row("gather_rows")
    rec.cases["gather_rows"][sb] = timed(4.0)
    row = rec.row("gather_rows")
    assert row["launches"] == 3 and row["library_ms"] is None
    assert row["ms"] == pytest.approx((2 * 1.0 + 4.0) / 3)
    assert row["bound_ms"] == pytest.approx(0.2) and row["bound_by"] == "bytes"
    with pytest.raises(AssertionError, match="never launched"):
        rec.row("fps")


@pytest.mark.parametrize("N,S,ns,radius", [(130, 40, 8, 1.0),
                                            (100, 30, 16, 0.9)])
def test_ball_query_matches_pallas(N, S, ns, radius):
    rng = np.random.RandomState(17)
    xyz = rng.randn(2, N, 3).astype(np.float32)
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


@pytest.mark.parametrize("Nq,N,C", [(128, 512, 3), (100, 130, 13)])
def test_knn_at_k64_matches_jax(Nq, N, C):
    """PointConv's second stage groups by 64 neighbours: the plain kNN at
    k=64 against the JAX package's `knn_idx` (XLA) and `knn_pallas`."""
    from hitadv_tpu.ops import geometry as JG

    rng = np.random.RandomState(20)
    q = rng.randn(2, Nq, C).astype(np.float32)
    p = rng.randn(2, N, C).astype(np.float32)
    p[:, 90] = p[:, 4]                     # a duplicate: an exact tie
    got_d, got_i = K.knn(_torch(q), _torch(p), 64)
    assert got_i.shape == (2, Nq, 64)
    want_i = np.asarray(JG.knn_idx(jnp.asarray(q), jnp.asarray(p), 64))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    want_d, want_i = PK.knn_pallas(jnp.asarray(q), jnp.asarray(p), 64)
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
        ROOT / "chip_smoke.py"]


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
