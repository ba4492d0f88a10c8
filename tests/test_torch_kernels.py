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
    x = torch.zeros(1, 16, 8)
    with pytest.raises(NotImplementedError):
        K.knn(x, x, 4)


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
    K.fps(x, 8, torch.zeros(2, dtype=torch.int32))
    K.gather_rows(x, torch.zeros(2, 5, dtype=torch.int32))
    assert all(v == 0 for v in K.LAUNCHES.values())


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
