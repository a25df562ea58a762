"""The MOSM Gram's backward in mogptk_tpu_torch against the JAX package: the
plain twin of K-gram-bwd (TPU kernels B2 and C1b) with its parameter and
input halves, the MosmGram autograd Function, the choice of kernel
instance, and K⁻¹ from the Cholesky factor (blocked_tri_inverse,
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
    """Inputs that need a gradient get one through MosmGram (trained
    inducing points), where the Gram raised before the input half was
    ported; only the input that asks gets a cotangent."""
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.rand(4, 1), dtype=torch.float64).requires_grad_()
    x2 = torch.as_tensor(rng.rand(3, 1), dtype=torch.float64)
    c, c2 = torch.zeros(4, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    st3 = torch.as_tensor([[[[[0.5, 0.3, 0.1]]]]], dtype=torch.float64)
    st2 = torch.as_tensor([[[[1.2, 0.05]]]], dtype=torch.float64)
    K = tmg.mosm_gram(x, c, x2, c2, st3, st2)
    K.sum().backward()
    xr = x.detach().clone().requires_grad_()
    tmg.mosm_gram_pairstats_plain(xr, c, x2, c2, st3, st2).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-12, atol=0)
    assert x2.grad is None


# (row counts of x1, column counts of x2, Q, D, layout): inducing-point
# shapes against data channel-sorted, permuted and square (x1 is x2), and a
# D = 2 case with one channel empty on the column side
INPUT_CASES = [((6, 5, 7), (40, 33, 50), 2, 1, "sorted"),
               ((6, 5, 7), (40, 33, 50), 2, 1, "permuted"),
               ((6, 5, 7), (40, 33, 50), 2, 1, "square"),
               ((5, 6, 4), (30, 0, 26), 2, 2, "permuted")]


def _input_setup(c1s, c2s, Q, D, seed, layout):
    """x1 (Z-like), x2 (X-like) with their channels, parameters and a dense
    cotangent g; layout "sorted", "permuted" (both sides shuffled) or
    "square" (x1 is x2, g (M, M))."""
    rng = np.random.RandomState(seed)
    O = len(c1s)

    def side(counts):
        n = sum(counts)
        x = np.sort(rng.rand(n, D) * 5, axis=0)
        c = np.repeat(np.arange(O), counts).astype(np.int32)
        if layout == "permuted":
            perm = rng.permutation(n)
            x, c = x[perm], c[perm]
        return x, c

    x1, c1 = side(c1s)
    x2, c2 = (x1, c1) if layout == "square" else side(c2s)
    params = (0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
              0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))
    g = rng.randn(x1.shape[0], x2.shape[0])
    return x1, c1, x2, c2, params, float((2 * np.pi) ** (D / 2)), g


def _jax_input_vjp(x1, c1, x2, c2, params, twopi, g, square):
    """(dx1, dx2, dparams) of Σ K∘g through the JAX package's Pallas
    mosm_gram with input_grads=True (C1b's backward with its input half,
    interpret mode); square: one x for both sides, its two cotangents
    summed by jax.vjp."""
    c1j, c2j, gj = jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(g)

    def vjp(gj, a, b, *p):
        if square:
            out = jax.vjp(lambda x, *q: jpm.mosm_gram(x, c1j, x, c1j, *q, twopi, True, True),
                          a, *p)[1](gj)
            return (out[0], out[0] * 0) + tuple(out[1:])
        return jax.vjp(lambda x, y, *q: jpm.mosm_gram(x, c1j, y, c2j, *q, twopi, True, True),
                       a, b, *p)[1](gj)

    return [np.asarray(a) for a in jax_reference.jit(vjp)(
        gj, jnp.asarray(x1), jnp.asarray(x2), *map(jnp.asarray, params))]


@pytest.mark.parametrize("c1s,c2s,Q,D,layout", INPUT_CASES)
def test_gram_bwd_input_half_matches_jax_and_autograd(c1s, c2s, Q, D, layout, interpret_pallas):
    """mosm_gram_bwd's plain twin with inputs=3: dx1 (row sums) and dx2
    (column sums, negated) beside the unchanged parameter half, against the
    JAX Pallas backward with input_grads=True and against torch autograd of
    Σ K∘g through mosm_gram_pairstats_plain; for x1 is x2, the MosmGram
    Function's gradient of its one input (dx1 + dx2) too. rtol 1e-7, atol
    1e-12 of each output's scale."""
    square = layout == "square"
    x1, c1, x2, c2, params, twopi, g = _input_setup(c1s, c2s, Q, D, 17 + D, layout)
    ref_jax = _jax_input_vjp(x1, c1, x2, c2, params, twopi, g, square)
    tp = list(map(_t, params))
    st3, st2 = tbm.mosm_pair_stats(*tp, twopi)
    c1t, c2t = torch.as_tensor(c1), torch.as_tensor(c2)
    dst3, dst2, dx1, dx2 = tmg.mosm_gram_bwd(_t(x1), c1t, _t(x2), c2t, st3, st2, _t(g),
                                             inputs=3)
    a1, a2 = _t(x1).requires_grad_(), _t(x2).requires_grad_()
    K = tmg.mosm_gram_pairstats_plain(a1, c1t, a2, c2t, st3, st2)
    ref_ag = torch.autograd.grad(torch.sum(K * _t(g)), (a1, a2))
    got_p = tbm.pair_stats_vjp(tp, twopi, dst3, dst2)
    if square:
        xs = _t(x1).requires_grad_()
        ps = [p.clone().requires_grad_() for p in tp]
        Ks = tmg.mosm_gram(xs, c1t, xs, c1t, *tbm.mosm_pair_stats(*ps, twopi))
        fn = torch.autograd.grad(torch.sum(Ks * _t(g)), [xs] + ps)
        scale = float(np.abs(ref_jax[0]).max())
        np.testing.assert_allclose(fn[0].numpy(), ref_jax[0], rtol=RTOL, atol=1e-12 * scale,
                                   err_msg="dx of x1 is x2")
        np.testing.assert_allclose((dx1 + dx2).numpy(), ref_jax[0], rtol=RTOL,
                                   atol=1e-12 * scale, err_msg="dx1 + dx2")
        for name, a, rj in zip(NAMES, fn[1:], ref_jax[2:]):
            np.testing.assert_allclose(a.numpy(), rj, rtol=RTOL,
                                       atol=1e-12 * float(np.abs(rj).max()), err_msg=name)
    else:
        for name, a, rj, ra in (("dx1", dx1, ref_jax[0], ref_ag[0]),
                                ("dx2", dx2, ref_jax[1], ref_ag[1])):
            scale = float(np.abs(rj).max())
            np.testing.assert_allclose(a.numpy(), rj, rtol=RTOL, atol=1e-12 * scale, err_msg=name)
            np.testing.assert_allclose(a.numpy(), ra.numpy(), rtol=RTOL, atol=1e-12 * scale,
                                       err_msg=name)
        for name, a, rj in zip(NAMES, got_p, ref_jax[2:]):
            np.testing.assert_allclose(a.numpy(), rj, rtol=RTOL,
                                       atol=1e-12 * float(np.abs(rj).max()), err_msg=name)
    for name, a, ra in (("dx1", dx1, ref_ag[0]), ("dx2", dx2, ref_ag[1])):
        torch.testing.assert_close(a, ra, rtol=RTOL, atol=1e-12 * float(ra.abs().max()),
                                   msg=name)


def test_kernel_instance_choice():
    """Which compiled instance takes a shape, decided on the host: the
    forward kernels' unrolled instance needs D <= 8 and the O²·(3QD + 2Q)
    float32 pair table within 48 KB of shared memory, else the generic one
    (runtime D, the table read from global memory); the backward kernels'
    unrolled instance needs Q <= 4 and D <= 2."""
    assert tmg.kernel_instance("forward", 4, 2, 1) == "unrolled"
    assert tmg.kernel_instance("forward", 4, 2, 8) == "unrolled"
    assert tmg.kernel_instance("forward", 1, 1, 9) == "generic"
    # O = 20, Q = 4, D = 2: 400 pairs of 32 floats, 51,200 bytes
    assert tmg.kernel_instance("forward", 20, 4, 2) == "generic"
    assert tmg.kernel_instance("forward", 19, 4, 2) == "unrolled"
    assert tmg.kernel_instance("backward", 20, 4, 2) == "unrolled"
    assert tmg.kernel_instance("backward", 3, 5, 3) == "generic"
    assert tmg.kernel_instance("backward", 3, 4, 3) == "generic"
    assert tmg.kernel_instance("backward", 3, 5, 1) == "generic"
    st3 = torch.zeros((3, 3, 5, 3, 3))
    assert tmg.generic_flag("backward", st3) == 1 and tmg.generic_flag("forward", st3) == 0
    with pytest.raises(ValueError):
        tmg.kernel_instance("sideways", 1, 1, 1)


def test_input_half_tile_table():
    """The input half's reduction order: the work-list index of every tile
    (ti, tj), rows and columns over the present channels' tiles."""
    counts1, counts2 = (300, 0, 256), (10, 20, 0)
    idx, _ = tmg._gram_layout(counts1, counts2, 256)
    tab = tmg._tile_table(idx, counts1, counts2, 256)
    assert tab.shape == (3, 2) and (tab >= 0).all()
    for s, (ti, tj, _) in enumerate(idx.tolist()):
        assert tab[ti, tj] == s


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
