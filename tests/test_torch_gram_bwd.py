"""The MOSM Gram's backward in mogptk_tpu_torch against the JAX package: the
plain twin of K-gram-bwd (TPU kernels B2 and C1b), the MosmGram autograd
Function, and K⁻¹ from the Cholesky factor (blocked_tri_inverse,
spd_inverse_from_factor). On CPU tensors the port runs the plain twins; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do on the
CPU. float64, rtol 1e-7 (XLA-CPU's exp is only ~1e-8 accurate even in
float64), each atol stated relative to the output's scale."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

import mogptk_tpu.ops.block_mosm as jbm
import mogptk_tpu.ops.pallas_mosm as jpm
import mogptk_tpu.ops.blocked_trisolve as jbt
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import blocked_trisolve as tbt
from mogptk_tpu_torch.ops import mosm_gram as tmg

import jax_reference

RTOL = 1e-7
NAMES = ["w", "mu", "var", "theta", "phi"]


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


def _setup(counts, Q, D, seed, shuffle):
    """Channel-sorted (or shuffled) x with ragged channels, MOSM parameters
    and a dense cotangent g, as tests/test_block_mosm.py."""
    O = len(counts)
    rng = np.random.RandomState(seed)
    N = sum(counts)
    x = np.sort(rng.rand(N, D) * 5, axis=0)
    c = np.repeat(np.arange(O), counts).astype(np.int32)
    if shuffle:
        perm = rng.permutation(N)
        x, c = x[perm], c[perm]
    params = (0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
              0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))
    g = rng.randn(N, N)
    return x, c, params, float((2 * np.pi) ** (D / 2)), g


# three non-empty channels (every off-diagonal pair of the layout), and
# three channels of which one is empty (its parameters' cotangents are 0 on
# both sides; two channels' blocks to compile in interpret mode)
CASES = [((40, 33, 50), 2, 1), ((64, 37, 0), 2, 2)]


def _jax_vjp(x, c, params, twopi, g, counts, shuffle):
    """Parameter cotangents of Σ K∘g through the JAX package's Gram: the
    Pallas mosm_gram (C1b's backward, any channel IDs) when shuffled, the
    sorted block Gram (B2's backward) otherwise."""
    xj, cj, gj = jnp.asarray(x), jnp.asarray(c), jnp.asarray(g)
    if shuffle:
        def gram(*p):
            return jpm.mosm_gram(xj, cj, xj, cj, *p, twopi, True)
    else:
        def gram(*p):
            return jbm.mosm_gram_sorted(xj, counts, *p, twopi)

    def vjp(gj, *p):
        return jax.vjp(gram, *p)[1](gj)

    return [np.asarray(a) for a in jax_reference.jit(vjp)(gj, *map(jnp.asarray, params))]


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX package's Pallas Gram kernels in interpret mode at 64-row
    tiles, as tests/test_pallas.py runs them."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpm.pl, "pallas_call", interp)
    monkeypatch.setattr(jpm, "TILE", 64)


@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted_B2", "shuffled_C1b"])
@pytest.mark.parametrize("counts,Q,D", CASES)
def test_gram_bwd_twin_matches_jax_and_autograd(counts, Q, D, shuffle, interpret_pallas):
    """mosm_gram_bwd's plain twin, chained through mosm_pair_stats, against
    the JAX Gram's VJP and against torch autograd of Σ K∘g through
    mosm_gram_pairstats_plain. rtol 1e-7, atol 1e-12·scale."""
    x, c, params, twopi, g = _setup(counts, Q, D, seed=3 + D, shuffle=shuffle)
    ref_jax = _jax_vjp(x, c, params, twopi, g, counts, shuffle)
    tp = list(map(_t, params))
    st3, st2 = tbm.mosm_pair_stats(*tp, twopi)
    ct = torch.as_tensor(c)
    launches = tmg.mosm_gram_bwd.launches
    dst = tmg.mosm_gram_bwd(_t(x), ct, _t(x), ct, st3, st2, _t(g))
    assert tmg.mosm_gram_bwd.launches == launches    # CPU: the plain twin
    got = tbm.pair_stats_vjp(tp, twopi, *dst)
    ps = [p.clone().requires_grad_() for p in tp]
    K = tmg.mosm_gram_pairstats_plain(_t(x), ct, _t(x), ct, *tbm.mosm_pair_stats(*ps, twopi))
    ref_ag = torch.autograd.grad(torch.sum(K * _t(g)), ps)
    for name, a, rj, ra in zip(NAMES, got, ref_jax, ref_ag):
        scale = float(ra.abs().max())
        np.testing.assert_allclose(a.numpy(), rj, rtol=RTOL, atol=1e-12 * scale, err_msg=name)
        np.testing.assert_allclose(a.numpy(), ra.numpy(), rtol=RTOL, atol=1e-12 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted", "shuffled"])
def test_kernel_gram_is_a_mosm_gram_function(shuffle):
    """kernel.K(X) (unsorted) and kernel.K_sorted(X, counts) carry
    MosmGram's backward on the CPU as on the card, and their parameter
    gradients match autograd through mosm_gram_pairstats_plain (float64,
    rtol 1e-12: the same formula, summed in another order)."""
    counts = (30, 25, 20)
    x, c, params, twopi, g = _setup(counts, 2, 1, seed=11, shuffle=shuffle)
    saved = (tgpr.config.device, tgpr.config._dtype)
    tgpr.config.device, tgpr.config._dtype = "cpu", torch.float64
    try:
        k = tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
        for p, v in zip(k.gp_parameters(), params):
            p[1].assign(v)
        X = torch.as_tensor(np.concatenate([c[:, None].astype(np.float64), x], axis=1))
        K = k.K_sorted(X, counts) if not shuffle else k.K(X)
        assert type(K.grad_fn).__name__ == "MosmGramBackward"
        raws = k.trainable_raws()
        got = torch.autograd.grad(torch.sum(K * _t(g)), raws)
        ct, xt = k._split(X)
        st3, st2 = tbm.mosm_pair_stats(*k._params(), k.twopi)
        ref = torch.autograd.grad(
            torch.sum(tmg.mosm_gram_pairstats_plain(xt, ct, xt, ct, st3, st2) * _t(g)), raws)
    finally:
        tgpr.config.device, tgpr.config._dtype = saved
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))


def test_gram_inputs_that_need_a_gradient_raise():
    x = torch.zeros((4, 1), dtype=torch.float64, requires_grad=True)
    c = torch.zeros(4, dtype=torch.int32)
    st3, st2 = torch.ones((1, 1, 1, 1, 3)), torch.ones((1, 1, 1, 2))
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        tmg.mosm_gram(x, c, x.detach(), c, st3, st2)


def test_gram_layout():
    """Every tile of every present pair (a, b), grouped by pair, channels
    padded to the tile; four partial rows per tile."""
    idx, pairs = tmg._gram_layout((300, 0, 256), (10, 20, 0), 256)
    # rows: channel 0 tiles 0-1, channel 2 tile 2; columns: channel 0 tile 0, channel 1 tile 1
    assert idx.tolist() == [[0, 0, 0], [1, 0, 0], [0, 1, 1], [1, 1, 1], [2, 0, 6], [2, 1, 7]]
    assert pairs.tolist() == [[0, 0, 8], [1, 8, 8], [6, 16, 4], [7, 20, 4]]
    c = torch.as_tensor([2, 0, 2, 0, 0], dtype=torch.int32)
    counts = tmg.channel_counts(c, 3)
    assert counts == (3, 0, 2)
    assert tmg.channel_map(c, counts, T=4).tolist() == [1, 3, 4, -1, 0, 2, -1, -1]


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n) / np.sqrt(n)
    return A @ A.T + 2.0 * np.eye(n)


@pytest.mark.parametrize("with_invs", [False, True], ids=["own_invs", "given_invs"])
def test_tri_inverse_and_spd_inverse_match_jax(with_invs):
    """n = 256, block 64: W = L⁻¹ and K⁻¹ = WᵀW against the JAX package's
    blocked_tri_inverse and spd_inverse_from_factor (float64, its GEMMs at
    "highest"), and K⁻¹ against numpy's inverse. L's strict upper holds NaN:
    neither may read it. rtol 1e-7, atol 1e-12·scale."""
    n, Bs = 256, 64
    K = _spd(n, 31)
    L = np.linalg.cholesky(K)
    Lnan = L + np.triu(np.full((n, n), np.nan), 1)
    invs = [np.linalg.inv(L[i:i + Bs, i:i + Bs]) for i in range(0, n, Bs)]
    jinvs = [jnp.asarray(v) for v in invs] if with_invs else None
    tinvs = _t(np.stack(invs)) if with_invs else None
    W_ref, Ki_ref = map(np.asarray, jax_reference.jit(lambda L_, invs_: (
        jbt.blocked_tri_inverse(L_, block_size=Bs, invs=invs_, update_precision="highest"),
        jbt.spd_inverse_from_factor(L_, block_size=Bs, invs=invs_,
                                    update_precision="highest")))(jnp.asarray(L), jinvs))
    W = tbt.blocked_tri_inverse(_t(Lnan), block_size=Bs, invs=tinvs).numpy()
    Ki = tbt.spd_inverse_from_factor(_t(Lnan), block_size=Bs, invs=tinvs).numpy()
    np.testing.assert_allclose(W, W_ref, rtol=RTOL, atol=1e-12 * np.abs(W_ref).max())
    assert np.all(np.triu(W, 1) == 0)
    np.testing.assert_allclose(Ki, Ki_ref, rtol=RTOL, atol=1e-12 * np.abs(Ki_ref).max())
    np.testing.assert_allclose(Ki, np.linalg.inv(K), rtol=RTOL, atol=1e-12 * np.abs(Ki).max())
