"""The training path's kernels in mogptk_tpu_torch against the JAX package:
the band-lower MOSM Gram (K-gram-lower, TPU kernel A1), the fused two-sweep
Cholesky solve (K-solve, A4) and the low-rank MOSM VJP (K-lowrank-vjp, A5).
On CPU tensors the port runs each kernel's plain twin; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do on the CPU. float64,
rtol 1e-7 (XLA-CPU's exp is only ~1e-8 accurate even in float64), each atol
stated relative to the output's scale."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import torch

import mogptk_tpu.ops.block_mosm as jbm
from mogptk_tpu.ops.blocked_trisolve import blocked_cho_solve as jax_blocked_cho_solve
from mogptk_tpu.ops.pallas_solve import fused_cho_solve as jax_fused_cho_solve
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import fused_solve as tfs
from mogptk_tpu_torch.ops import mosm_gram as tmg

import jax_reference

RTOL = 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: one torch thread (the suite runs files in parallel
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _setup(counts, Q, D, seed):
    """Channel-sorted x and MOSM parameters, as tests/test_block_mosm.py."""
    O = len(counts)
    rng = np.random.RandomState(seed)
    x = np.sort(rng.rand(sum(counts), D) * 5, axis=0)
    params = (0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
              0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))
    return x, params, float((2 * np.pi) ** (D / 2))


@pytest.mark.parametrize("band", [512, 1024])
def test_lower_gram_matches_jax_on_written_tiles(band):
    """Counts (512, 512): the JAX kernel writes tiles (ti ≥ tj) or the same
    band; the twin's other tiles are NaN. atol 1e-12·max|K|."""
    counts = (512, 512)
    x, params, twopi = _setup(counts, 2, 1, seed=4)
    ref = np.asarray(jax_reference.jit(lambda x, *p: jbm.mosm_gram_sorted_lower(
        x, counts, *p, twopi, band=band))(jnp.asarray(x), *map(jnp.asarray, params)))
    st3, st2 = tbm.mosm_pair_stats(*map(_t, params), twopi)
    launches = tbm.mosm_gram_sorted_lower.launches
    got = tbm.mosm_gram_sorted_lower(_t(x), counts, st3, st2, band=band).numpy()
    assert tbm.mosm_gram_sorted_lower.launches == launches    # CPU: the plain twin
    T, bandT = tbm.TILE, band // tbm.TILE
    scale = np.abs(np.nan_to_num(got)).max()
    for ti in range(2):
        for tj in range(2):
            sl = (slice(ti * T, (ti + 1) * T), slice(tj * T, (tj + 1) * T))
            if ti >= tj or ti // bandT == tj // bandT:
                np.testing.assert_allclose(got[sl], ref[sl], rtol=RTOL, atol=1e-12 * scale)
            else:
                assert np.all(np.isnan(got[sl]))


def test_lower_gram_gate():
    x, params, twopi = _setup((512, 500), 1, 1, seed=5)
    st3, st2 = tbm.mosm_pair_stats(*map(_t, params), twopi)
    assert tbm.mosm_gram_sorted_lower(_t(x), (512, 500), st3, st2, band=512) is None
    assert tbm.mosm_gram_sorted_lower(_t(x)[:1024], (512, 512), st3, st2, band=1536) is None


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n) / np.sqrt(n)
    return A @ A.T + 2.0 * np.eye(n)


@pytest.mark.parametrize("n,Bs,r", [(128, 128, 3), (512, 128, 17), (384, 128, 1)])
@pytest.mark.parametrize("nan_upper", [False, True], ids=["zero_upper", "nan_upper"])
def test_fused_solve_twin_matches_jax(n, Bs, r, nan_upper):
    """The K-solve twin against the JAX package's fused_cho_solve (interpret
    mode; a float32 kernel with bf16x3 products: atol 3e-5·scale, as
    tests/test_linalg.py holds it against cho_solve) and against its float64
    blocked substitution (rtol 1e-7, atol 1e-12·scale). With nan_upper, L's
    strict upper triangle is NaN: neither solve may read it."""
    seed = {128: 21, 512: 22, 384: 23}[n]
    L = np.linalg.cholesky(_spd(n, seed))
    B = np.random.RandomState(seed + 1).randn(n, r)
    invs = np.stack([np.linalg.inv(L[i * Bs:(i + 1) * Bs, i * Bs:(i + 1) * Bs])
                     for i in range(n // Bs)])
    Lin = L + np.triu(np.full((n, n), np.nan), 1) if nan_upper else L
    got = tfs.fused_cho_solve(_t(Lin), _t(invs), _t(B)).numpy()
    jinvs = [jnp.asarray(v) for v in invs]
    X_ref, ref_f32, ref_f64 = map(np.asarray, jax_reference.jit(lambda L_, Lin_, B_, invs_: (
        jsl.cho_solve((L_, True), B_),
        jax_fused_cho_solve(Lin_.astype(jnp.float32), [v.astype(jnp.float32) for v in invs_],
                            B_.astype(jnp.float32), block_size=Bs),
        jax_blocked_cho_solve(Lin_, B_, invs=invs_, block_size=Bs)))(
            jnp.asarray(L), jnp.asarray(Lin), jnp.asarray(B), jinvs))
    scale = np.abs(X_ref).max()
    np.testing.assert_allclose(got, ref_f32, rtol=0, atol=3e-5 * max(scale, 1.0))
    np.testing.assert_allclose(got, ref_f64, rtol=RTOL, atol=1e-12 * scale)
    np.testing.assert_allclose(got, X_ref, rtol=RTOL, atol=1e-10 * scale)


def test_fused_solve_twin_matches_jax_at_the_widest_rhs():
    """As test_fused_solve_twin_matches_jax, at the kernel's widest right-hand
    side (MAX_RHS = 64 columns) and its narrowest panel (Bs = 64, four
    panels), L's strict upper triangle NaN."""
    n, Bs, r = 256, 64, tfs.MAX_RHS
    L = np.linalg.cholesky(_spd(n, 24))
    B = np.random.RandomState(25).randn(n, r)
    invs = np.stack([np.linalg.inv(L[i * Bs:(i + 1) * Bs, i * Bs:(i + 1) * Bs])
                     for i in range(n // Bs)])
    Lin = L + np.triu(np.full((n, n), np.nan), 1)
    got = tfs.fused_cho_solve(_t(Lin), _t(invs), _t(B)).numpy()
    ref_f32, ref_f64 = map(np.asarray, jax_reference.jit(lambda Lin_, B_, invs_: (
        jax_fused_cho_solve(Lin_.astype(jnp.float32), invs_.astype(jnp.float32),
                            B_.astype(jnp.float32), block_size=Bs),
        jax_blocked_cho_solve(Lin_, B_, invs=list(invs_), block_size=Bs)))(
            jnp.asarray(Lin), jnp.asarray(B), jnp.asarray(invs)))
    scale = np.abs(ref_f64).max()
    np.testing.assert_allclose(got, ref_f32, rtol=0, atol=3e-5 * max(scale, 1.0))
    np.testing.assert_allclose(got, ref_f64, rtol=RTOL, atol=1e-12 * scale)


def test_fused_solve_identity_launches_nothing_on_cpu():
    L = torch.eye(256, dtype=torch.float64)
    invs = torch.eye(128, dtype=torch.float64).expand(2, 128, 128)
    B = torch.arange(768, dtype=torch.float64).reshape(256, 3)
    launches = tfs.fused_cho_solve.launches
    torch.testing.assert_close(tfs.fused_cho_solve(L, invs, B), B, rtol=0, atol=0)
    assert tfs.fused_cho_solve.launches == launches


@pytest.mark.parametrize("counts,Q,D", [((40, 33), 2, 2), ((40, 37, 50), 2, 1)])
def test_lowrank_vjp_matches_jax_and_autograd(counts, Q, D):
    """Ragged channels (padded to the 256-row tiles with zero rows on both
    sides). The port's rows follow the upper-pair convention, so the check is
    on parameter cotangents after the chain through mosm_pair_stats: against
    the JAX kernel (interpret mode) and against torch autograd of
    Σ K∘(A Bᵀ) over the plain full Gram. rtol 1e-7, atol 1e-12·scale."""
    x, params, twopi = _setup(counts, Q, D, seed=9)
    N = sum(counts)
    rng = np.random.RandomState(10)
    A, B = rng.randn(N, 17), rng.randn(N, 17)
    ref_jax = jax_reference.jit(lambda x, p, A, B: jbm.mosm_lowrank_vjp_sorted(
        x, counts, p, twopi, A, B))(
        jnp.asarray(x), tuple(map(jnp.asarray, params)), jnp.asarray(A), jnp.asarray(B))
    tp = list(map(_t, params))
    st3, st2 = tbm.mosm_pair_stats(*tp, twopi)
    launches = tbm.mosm_lowrank_vjp_sorted.launches
    dst3, dst2 = tbm.mosm_lowrank_vjp_sorted(_t(x), counts, st3, st2, _t(A), _t(B))
    assert tbm.mosm_lowrank_vjp_sorted.launches == launches    # CPU: the plain twin
    got = tbm.pair_stats_vjp(tp, twopi, dst3, dst2)

    ps = [p.clone().requires_grad_() for p in tp]
    c = tbm.channel_ids(counts, "cpu")
    K = tmg.mosm_gram_pairstats_plain(_t(x), c, _t(x), c, *tbm.mosm_pair_stats(*ps, twopi))
    ref_ag = torch.autograd.grad(torch.sum(K * (_t(A) @ _t(B).T)), ps)
    for name, g, rj, ra in zip(["w", "mu", "var", "theta", "phi"], got, ref_jax, ref_ag):
        scale = float(ra.abs().max())
        np.testing.assert_allclose(g.numpy(), np.asarray(rj), rtol=RTOL, atol=1e-12 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), ra.numpy(), rtol=RTOL, atol=1e-12 * scale,
                                   err_msg=name)


def test_pair_layout():
    """Upper tiles of upper pairs, grouped by pair, empty channels skipped;
    four partial rows (quarter-tile blocks) per tile."""
    idx, pairs = tbm._pair_layout((300, 0, 256), 256)
    # channel 0: tiles 0-1, channel 2: tile 2
    assert idx.tolist() == [[0, 0, 0], [0, 1, 0], [1, 1, 0], [0, 2, 2], [1, 2, 2], [2, 2, 8]]
    assert pairs.tolist() == [[0, 0, 12], [2, 12, 8], [8, 20, 4]]
