"""The iterative exact-GP engine of mogptk_tpu_torch (ops/iterative.py,
ops/mosm_matvec.py, gpr/iterative.py, the Iterative selector) against
mogptk_tpu's, on the CPU in float64.

Both packages get the same numpy data; the JAX model's raws are carried
across with load_raw_state and its random draws (the Rademacher probes from
PRNGKey(seed + 1), the preconditioner probes' normals from
split(PRNGKey(seed)), the readout's probes from PRNGKey(seed + 1 + 7919·s))
are handed to the port. The JAX ExactIterative runs its dense route
(use_pallas(False), as tests/test_iterative.py runs it); the K-matvec twin
is held against the JAX Pallas matvecs in interpret mode, one call each.
The JAX answers are computed once per test run, however many xdist workers
run the module (tests/jax_reference.py). rtol 1e-7 (XLA-CPU's exp is
only ~1e-8 accurate even in float64); each atol is stated against the
output's scale. The reference computations are compiled without XLA's
backend optimizations (tests/jax_reference.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import optax
import torch

import mogptk_tpu as J
import mogptk_tpu.gpr as jgpr
import mogptk_tpu.gpr.iterative as jiter
import mogptk_tpu.ops.iterative as jit_ops
import mogptk_tpu.ops.block_mosm as jbm
import mogptk_tpu.ops.pallas_mosm as jpm
import mogptk_tpu.ops.fused as jfused
import mogptk_tpu_torch as T
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.ops import iterative as tit
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import mosm_matvec as tmv

import jax_reference

RTOL = 1e-7
PROBES, RANK, MAX_CG, CG_TOL, LANCZOS, LR, STEPS = 4, 24, 40, 1e-10, 8, 0.01, 3
READOUT = dict(max_cg_iters=60, num_probes=6, lanczos_iters=10, precond_rank=12, seeds=2)


@pytest.fixture(scope="module", autouse=True)
def cpu_float64():
    """The port runs on the card unless asked: these tests ask for the CPU,
    in float64, on one thread (the suite runs files in parallel processes)."""
    cfg = tgpr.config
    saved = (cfg.device, cfg._dtype, torch.get_num_threads())
    cfg.device = "cpu"
    tgpr.use_double_precision()
    torch.set_num_threads(1)
    yield
    cfg.device, cfg._dtype, threads = saved
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, what, atol_rel=1e-12):
    """rtol 1e-7, atol `atol_rel` of the reference's largest entry."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=atol_rel * scale,
                               err_msg=what)


# -- (a) the linear-algebra building blocks ------------------------------------

def _spd(n, eigs, seed):
    Q, _ = np.linalg.qr(np.random.RandomState(seed).randn(n, n))
    return (Q * eigs) @ Q.T, Q


def _cg_cases():
    """name -> (A, B, max_iters, tol, Jacobi preconditioner?, X0)."""
    rng = np.random.RandomState(0)
    A, _ = _spd(60, np.linspace(0.5, 40.0, 60), 1)
    B = rng.randn(60, 3)
    # κ = 1e6: the residual's 2-norm climbs and no column improves its best
    # by 0.2% for 24 iterations, so the stall latch freezes both columns
    A_ill, _ = _spd(200, np.linspace(1.0, 1e6, 200), 2)
    # one negative eigenvalue; column 1 starts on its eigenvector: pAp < 0
    A_ind, Qi = _spd(40, np.concatenate([[-0.5], np.linspace(1.0, 9.0, 39)]), 3)
    B_ind = np.stack([rng.randn(40), Qi[:, 0]], axis=1)
    return {
        "plain": (A, B, 40, 1e-9, False, None),
        "preconditioned_warm_start": (A, B, 40, 1e-9, True, 0.1 * rng.randn(60, 3)),
        "stall_latch": (A_ill, rng.randn(200, 2), 60, 0.0, False, None),
        "breakdown": (A_ind, B_ind, 30, 1e-9, False, None),
    }


@pytest.fixture(scope="module")
def jax_cg(tmp_path_factory):
    """Every case's cg_solve and quadrature under one jit, once per test
    run (jax_reference.once_per_run)."""
    return jax_reference.once_per_run(tmp_path_factory, "iterative_jax_cg", _jax_cg_answers)


def _jax_cg_answers():
    cases = _cg_cases()

    def run(arrays):
        out = {}
        for name, (A, B, X0) in arrays.items():
            _, _, m, tol, pre, _ = cases[name]
            M_inv = (lambda V, A=A: V / jnp.diagonal(A)[:, None]) if pre else None
            X, res, coeffs = jit_ops.cg_solve(lambda V, A=A: A @ V, B, max_iters=m, tol=tol,
                                              M_inv=M_inv, track_coeffs=True, X0=X0)
            out[name] = (X, res, coeffs, jit_ops.cg_logdet_quadrature(coeffs))
        return out

    arrays = {name: (jnp.asarray(A), jnp.asarray(B), None if X0 is None else jnp.asarray(X0))
              for name, (A, B, _, _, _, X0) in cases.items()}
    return jax.tree_util.tree_map(np.asarray, jax_reference.jit(run)(arrays))


@pytest.mark.parametrize("name", list(_cg_cases()))
def test_cg_solve_and_quadrature_match_jax(jax_cg, name):
    """cg_solve with track_coeffs: X, residuals, (alphas, betas, actives,
    rz0) and the per-probe cg_logdet_quadrature; atol 1e-12 of each
    output's scale."""
    A, B, m, tol, pre, X0 = _cg_cases()[name]
    At = _t(A)
    M_inv = (lambda V: V / torch.diagonal(At)[:, None]) if pre else None
    X, res, coeffs = tit.cg_solve(lambda V: At @ V, _t(B), max_iters=m, tol=tol, M_inv=M_inv,
                                  track_coeffs=True, X0=None if X0 is None else _t(X0))
    quad = tit.cg_logdet_quadrature(coeffs)
    jX, jres, (ja, jb, jact, jrz0), jquad = jax_cg[name]
    np.testing.assert_array_equal(coeffs[2].numpy(), jact)
    for what, got, want in (("X", X, jX), ("res", res, jres), ("alphas", coeffs[0], ja),
                            ("betas", coeffs[1], jb), ("rz0", coeffs[3], jrz0),
                            ("quadrature", quad, jquad)):
        _close(got, want, what)
    if name == "stall_latch":
        # a column froze before converging and without breaking down
        assert np.any(~jact[-1] & (jres > 32 * np.finfo(np.float64).eps))
    if name == "breakdown":
        assert not jact[0, 1] and jact[0, 0]


def _ops_inputs():
    rng = np.random.RandomState(4)
    n = 60
    A, _ = _spd(n, np.linspace(0.3, 25.0, n), 5)
    return dict(A=A, L=rng.randn(n, 5), sigma2=0.37, V=rng.randn(n, 3),
                Z=np.asarray(jax.random.rademacher(jax.random.PRNGKey(7), (n, 4),
                                                   dtype=jnp.float64)))


@pytest.fixture(scope="module")
def jax_ops(tmp_path_factory):
    return jax_reference.once_per_run(tmp_path_factory, "iterative_jax_ops", _jax_ops_answers)


def _jax_ops_answers():
    d = _ops_inputs()
    n = d["A"].shape[0]

    def run(A, L, V, Z):
        mv = lambda W: A @ W
        M_inv, Linner = jit_ops.woodbury_m_inv(L, d["sigma2"])
        half, neg_half, logdetP = jit_ops.woodbury_half_powers(L, d["sigma2"])
        return dict(
            lanczos=jit_ops.lanczos(mv, Z, 12),
            lanczos_reorth=jit_ops.lanczos_reorth(mv, Z, 12),
            m_inv=M_inv(V), Linner=Linner, half=half(V), neg_half=neg_half(V), logdetP=logdetP,
            pslq=jit_ops.preconditioned_slq_logdet(mv, L, d["sigma2"], n, num_probes=4,
                                                   lanczos_iters=12, key=jax.random.PRNGKey(7),
                                                   dtype=jnp.float64),
            slq=jit_ops.slq_logdet(mv, n, num_probes=4, lanczos_iters=12,
                                   key=jax.random.PRNGKey(7), dtype=jnp.float64),
            pivots=jit_ops.pivoted_cholesky(jnp.diagonal(A), lambda i: A[i, :], n, 10))

    args = (jnp.asarray(d["A"]), jnp.asarray(d["L"]), jnp.asarray(d["V"]), jnp.asarray(d["Z"]))
    return jax.tree_util.tree_map(np.asarray, jax_reference.jit(run)(*args))


@pytest.mark.parametrize("name", ["lanczos", "lanczos_reorth"])
def test_lanczos_matches_jax(jax_ops, name):
    d = _ops_inputs()
    At = _t(d["A"])
    alphas, betas = getattr(tit, name)(lambda W: At @ W, _t(d["Z"]), 12)
    _close(alphas, jax_ops[name][0], "alphas")
    _close(betas, jax_ops[name][1], "betas")


def test_woodbury_m_inv_matches_jax(jax_ops):
    d = _ops_inputs()
    M_inv, Linner = tit.woodbury_m_inv(_t(d["L"]), d["sigma2"])
    _close(M_inv(_t(d["V"])), jax_ops["m_inv"], "M_inv V")
    _close(Linner, jax_ops["Linner"], "Linner")


def test_woodbury_half_powers_match_jax(jax_ops):
    d = _ops_inputs()
    half, neg_half, logdetP = tit.woodbury_half_powers(_t(d["L"]), d["sigma2"])
    _close(half(_t(d["V"])), jax_ops["half"], "P^1/2 V")
    _close(neg_half(_t(d["V"])), jax_ops["neg_half"], "P^-1/2 V")
    _close(logdetP, jax_ops["logdetP"], "logdetP")


@pytest.mark.parametrize("name", ["pslq", "slq"])
def test_slq_logdet_with_given_probes_matches_jax(jax_ops, name):
    """preconditioned_slq_logdet and slq_logdet with the JAX package's
    probes rademacher(PRNGKey(7), (60, 4))."""
    d = _ops_inputs()
    At = _t(d["A"])
    if name == "pslq":
        got = tit.preconditioned_slq_logdet(lambda W: At @ W, _t(d["L"]), d["sigma2"], _t(d["Z"]),
                                            lanczos_iters=12)
    else:
        got = tit.slq_logdet(lambda W: At @ W, _t(d["Z"]), lanczos_iters=12)
    _close(got, jax_ops[name], name)


def test_pivoted_cholesky_matches_jax(jax_ops):
    d = _ops_inputs()
    At = _t(d["A"])
    L = tit.pivoted_cholesky(torch.diagonal(At), lambda i: At[i], At.shape[0], 10)
    _close(L, jax_ops["pivots"], "L")


# -- (b) the K-matvec twin -------------------------------------------------------

COUNTS = (50, 37, 61)


def _matvec_inputs():
    rng = np.random.RandomState(8)
    n, O, Q = sum(COUNTS), len(COUNTS), 2
    x = np.concatenate([np.sort(rng.rand(k, 1) * 6, axis=0) for k in COUNTS])
    c = np.repeat(np.arange(O), COUNTS)
    params = (0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, 1), 0.2 + rng.rand(O, Q, 1),
              0.1 * rng.randn(O, Q, 1), 0.1 * rng.randn(O, Q))
    return x, c, params, rng.randn(n, 5), rng.permutation(n)


@pytest.fixture(scope="module")
def jax_matvec(tmp_path_factory):
    """One interpret-mode call each of the sorted Pallas matvec (D1) and the
    generic one (C3, on the permuted points), tiles of 32, once per test
    run."""
    return jax_reference.once_per_run(tmp_path_factory, "iterative_jax_matvec",
                                      _jax_matvec_answers)


def _jax_matvec_answers():
    x, c, params, V, perm = _matvec_inputs()
    twopi = float(np.sqrt(2 * np.pi))
    orig, tiles = pl.pallas_call, (jbm.TILE, jpm.TILE)

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    pl.pallas_call = interp
    jbm.TILE = jpm.TILE = 32
    try:
        p = tuple(map(jnp.asarray, params))
        sorted_ = jax_reference.jit(lambda x_, V_, *p_: jbm.mosm_matvec_sorted(
            x_, COUNTS, *p_, twopi, V_, phase_inside=True))(jnp.asarray(x), jnp.asarray(V), *p)
        cp = jnp.asarray(c[perm], jnp.int32)
        xp = jnp.asarray(x[perm])
        shuffled = jax_reference.jit(lambda x_, c_, V_, *p_: jfused.fused_gram_matvec(
            ("mosm", (twopi, True)), len(COUNTS), x_, c_, x_, c_, p_, V_))(
            xp, cp, jnp.asarray(V[perm]), *p)
    finally:
        pl.pallas_call = orig
        jbm.TILE, jpm.TILE = tiles
    return np.asarray(sorted_), np.asarray(shuffled)


@pytest.mark.parametrize("R", [1, 5])
@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
def test_matvec_twin_matches_jax_pallas(jax_matvec, layout, R):
    """mosm_matvec on CPU tensors (the plain twin) against mosm_matvec_sorted
    (channel-sorted) and fused_gram_matvec (permuted points), the first R
    columns; atol 1e-12 of the output's scale. No kernel launch on the CPU."""
    x, c, params, V, perm = _matvec_inputs()
    if layout == "shuffled":
        x, c, V = x[perm], c[perm], V[perm]
    st3, st2 = tbm.mosm_pair_stats(*map(_t, params), float(np.sqrt(2 * np.pi)))
    launches = tmv.mosm_matvec.launches
    got = tmv.mosm_matvec(_t(x), torch.as_tensor(c, dtype=torch.int32), st3, st2, _t(V[:, :R]))
    want = jax_matvec[0 if layout == "sorted" else 1][:, :R]
    _close(got, want, "K V")
    assert tmv.mosm_matvec.launches == launches


# -- (c)-(g) ExactIterative --------------------------------------------------------

def _data():
    """3 channels x 40 points, as tests/test_torch_training.py's dense data."""
    rng = np.random.RandomState(0)
    xs = [np.sort(rng.rand(40, 1) * 10, axis=0) for _ in range(3)]
    ys = [np.sin(1.3 * x + i) + 0.05 * rng.randn(40, 1) for i, x in enumerate(xs)]
    rk = np.random.RandomState(1)
    return xs, ys, 0.05 + 0.3 * rk.rand(3, 2, 1), 0.2 + 0.3 * rk.rand(3, 2, 1)


# the Iterative selector's settings (its models have seed 0); rank 24 of 120
# points lets every CG column converge to cg_tol inside the budget, where two
# implementations' float64 iterates agree (an unconverged CG's last digits
# follow its rounding)
SETTINGS = dict(variance=0.1, max_cg_iters=MAX_CG, cg_tol=CG_TOL, num_probes=PROBES,
                lanczos_iters=LANCZOS, precond_rank=RANK)


def _draws(n):
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.rademacher(jax.random.PRNGKey(1), (n, PROBES),
                                             dtype=jnp.float64)),
            (np.asarray(jax.random.normal(k0, (n, PROBES), dtype=jnp.float64)),
             np.asarray(jax.random.normal(k1, (RANK, PROBES), dtype=jnp.float64))))


def _readout_probes(n):
    return [np.asarray(jax.random.rademacher(jax.random.PRNGKey(1 + 7919 * s),
                                             (n, READOUT["num_probes"]), dtype=jnp.float64))
            for s in range(READOUT["seeds"])]


def _top(pkg):
    """MOSM(DataSet, Q=2, inference=Iterative(...)) of the data, its initial
    parameters drawn from the package's seeded numpy Generator."""
    xs, ys, _, _ = _data()
    pkg.set_seed(5)
    ds = pkg.DataSet([x[:, 0] for x in xs], [y[:, 0] for y in ys])
    return pkg.MOSM(ds, Q=2, inference=pkg.Iterative(**SETTINGS))


def _shuffled_jax():
    xs, ys, mean, var = _data()
    _, X, Y = jgpr.merge_data(xs, ys)
    perm = np.random.RandomState(2).permutation(X.shape[0])
    k = jgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    k.mean.assign(mean)
    k.variance.assign(var)
    return jgpr.ExactIterative(k, np.asarray(X)[perm], np.asarray(Y)[perm], **SETTINGS)


def _port_gpr(jm, kernel=None):
    """The port's ExactIterative on the JAX model's data with its raws and
    draws (jm: the `model` entry of _jax_run; kernel: the port's own, e.g. a
    top-level model's, else a fresh MOSM)."""
    Z, normals = _draws(jm["X"].shape[0])
    if kernel is None:
        kernel = tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    tm = tgpr.ExactIterative(kernel, jm["X"], jm["y"], probes=Z, p_normals=normals, **SETTINGS)
    tgpr.load_raw_state(tm, jm["raws"], names=jm["names"])
    return tm


def _port_top(jm):
    """The port's MOSM with the Iterative selector, its gpr model given the
    JAX model's raws and draws."""
    top = _top(T)
    assert isinstance(top.gpr, tgpr.ExactIterative)
    np.testing.assert_array_equal(top.gpr.X.numpy(), jm["X"])
    top.gpr = _port_gpr(jm, top.gpr.kernel)
    return top


def _model_answers(jm):
    """The JAX model as its data, raws and parameter names: numpy only, so
    one worker's answers serve every worker (jax_reference.once_per_run)."""
    return dict(X=np.asarray(jm.X), y=np.asarray(jm.y),
                raws=[np.asarray(r) for r in jm.raw_state()],
                names=[p.name for p in jm.parameters()])


def _jax_extras(jm):
    """The readout's terms, predict_f over every fifth training point in
    blocks of 7, and cg_diagnostics at a 6-iteration budget."""
    out = {"model": _model_answers(jm)}
    jgpr.use_pallas(False)
    try:
        out["readout"] = _jax_readout(jm)
        out["Xq"] = np.asarray(jm.X)[::5]
        out["predict"], out["predict_full"] = (
            tuple(np.asarray(a) for a in pair) for pair in jax_reference.jit(
                lambda q: (jm.predict_f(q, block_size=7),
                           jm.predict_f(q, full=True, block_size=7)))(out["Xq"]))
        out["diag"] = _jax_diagnostics(jm, 6)
    finally:
        jgpr.use_pallas(None)
    return out


def _jax_run(jm, steps):
    """Loss and gradient at the start, then after each of `steps` optax Adam
    steps (one jitted value-and-grad, the update of gpr/training.py)."""
    out = {"model": _model_answers(jm)}
    jgpr.use_pallas(False)
    try:
        train, fixed = jm._split_raws()
        vg = jax_reference.jit(jax.value_and_grad(jm.make_loss_fn()))
        opt = optax.adam(LR)
        state = opt.init(train)
        out["losses"], out["grads"], out["raws"] = [], [], []
        for i in range(steps + 1):
            v, g = vg(train, fixed)
            out["losses"].append(float(v))
            out["grads"].append([np.asarray(a) for a in g])
            if i == steps:
                break
            upd, state = opt.update(g, state, train)
            train = optax.apply_updates(train, upd)
            out["raws"].append([np.asarray(a) for a in train])
    finally:
        jgpr.use_pallas(None)
    return out


def _jax_diagnostics(jm, iters):
    """The JAX package's ExactIterative.cg_diagnostics (gpr/iterative.py:
    428-445) at `iters` iterations, its body under one jit: residuals far
    above round-off, where two implementations' sums agree."""
    c = jm.X[:, 0].astype(jnp.int32)
    x = jm.X[:, 1:]
    static = jm._static()

    def run(nd, y, params):
        matvec = jiter._make_matvec(static, x, c, nd, params)
        M_inv = jiter._make_preconditioner(static, x, c, nd, params)
        Z = jax.random.rademacher(jax.random.PRNGKey(jm.seed + 1), (x.shape[0], jm.num_probes),
                                  dtype=y.dtype)
        return jiter.cg_solve(matvec, jnp.concatenate([y, Z], axis=1), max_iters=iters,
                              tol=jm.cg_tol, M_inv=M_inv)[1]

    res = np.asarray(jax_reference.jit(run)(jm._noise_diag(), jm._residual_y(),
                                            jm._kernel_params()))
    return float(res[0]), float(res[1:].max())


class _UnoptimizedJax:
    """The jax module, with jit compiling through jax_reference: stands in
    for the name `jax` in mogptk_tpu/gpr/iterative.py while its readout
    builds its four executables."""
    jit = staticmethod(jax_reference.jit)

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_readout(jm):
    """The JAX readout's value and its halves: log det P and the Lanczos
    quadrature of tr log(P⁻¹K) recorded from inside its log-det executable,
    the quadratic term −½yᵀα as the rest."""
    parts = []
    orig = jiter.preconditioned_slq_logdet

    def recording(matvec, L, sigma2, n, **kw):
        total = orig(matvec, L, sigma2, n, **kw)
        logdetP = jit_ops.woodbury_half_powers(L.astype(kw["dtype"]),
                                               jnp.asarray(sigma2, kw["dtype"]))[2]
        jax.debug.callback(lambda a, b: parts.append((float(a), float(b))), logdetP, total)
        return total

    jiter.preconditioned_slq_logdet, jiter.jax = recording, _UnoptimizedJax()
    try:
        value = float(jm.log_marginal_likelihood_readout(**READOUT))
    finally:
        jiter.preconditioned_slq_logdet, jiter.jax = orig, jax
    logdetP = parts[0][0]
    lds = np.array([total for _, total in parts])
    quad = value + jm.log_marginal_likelihood_constant + 0.5 * np.mean(lds)
    return dict(value=value, logdetP=logdetP, trlog=np.mean(lds - logdetP), quad=quad)


@pytest.fixture(scope="module")
def jax_sorted(tmp_path_factory):
    """The JAX MOSM with the Iterative selector: its gpr model's training
    answers."""
    return jax_reference.once_per_run(tmp_path_factory, "iterative_jax_sorted",
                                      lambda: _jax_run(_top(J).gpr, STEPS))


@pytest.fixture(scope="module")
def jax_sorted_extras(tmp_path_factory):
    """The same model's readout, predict and diagnostics, apart from the
    training answers so that parallel workers compute the two side by
    side."""
    return jax_reference.once_per_run(tmp_path_factory, "iterative_jax_sorted_extras",
                                      lambda: _jax_extras(_top(J).gpr))


@pytest.fixture(scope="module")
def jax_shuffled(tmp_path_factory):
    return jax_reference.once_per_run(tmp_path_factory, "iterative_jax_shuffled",
                                      lambda: _jax_run(_shuffled_jax(), 0))


def _check_loss_and_grads(tm, loss, grads):
    """loss(): rtol 1e-7; each raw's .grad: rtol 1e-7, atol 1e-9 of the
    largest gradient entry (entries that cancel to ~0 carry the summation
    noise of the largest)."""
    raws = tm.trainable_raws()
    for r in raws:
        r.grad = None
    val = tm.loss()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), loss, rtol=RTOL)
    scale = max(np.abs(g).max() for g in grads)
    assert len(raws) == len(grads)
    for name, r, g in zip(tgpr.parameter_names(tm), raws, grads):
        np.testing.assert_allclose(r.grad.numpy(), g, rtol=RTOL, atol=1e-9 * scale, err_msg=name)


@pytest.mark.parametrize("shuffled", [False, True], ids=["sorted", "shuffled"])
def test_loss_and_gradients_match_jax(jax_sorted, jax_shuffled, shuffled):
    """The training-path estimate (pivoted preconditioner, one CG on
    [y, Z, z], the CG-coefficient quadrature) and the probe-trace gradient
    through the low-rank VJP twin, channel-sorted and on shuffled rows
    (sorted inside the port; the JAX package's generic route)."""
    out = jax_shuffled if shuffled else jax_sorted
    jm = out["model"]
    tm = _port_gpr(jm) if shuffled else _port_gpr(jm, _top(T).gpr.kernel)
    assert (tm._layout["perm"] is None) != shuffled
    _check_loss_and_grads(tm, out["losses"][0], out["grads"][0])


def _check_steps(losses, raws, out, what):
    """Three Adam steps: the losses (rtol 1e-7) and the trainable raws after
    the last len(raws) steps (atol 1e-9 of each raw's scale)."""
    np.testing.assert_allclose(losses, out["losses"][:STEPS], rtol=RTOL, err_msg=what)
    for step, (got, want) in enumerate(zip(raws, out["raws"][-len(raws):])):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "%s: step %d raw %d" % (what, step, i), atol_rel=1e-9)


def _trained_raws(gpr):
    return [r.detach().numpy().copy() for r in gpr.trainable_raws()]


def test_three_adam_steps_match_jax(jax_sorted):
    """gpr.train(Adam, lr=0.01, iters=3) against optax Adam."""
    out = jax_sorted
    jm = out["model"]
    tm = _port_gpr(jm, _top(T).gpr.kernel)
    raws = []
    losses, _ = tgpr.train(tm, method="Adam", lr=LR, iters=STEPS,
                           callback=lambda i, v: raws.append(_trained_raws(tm)))
    _check_steps(losses, raws, out, "gpr.train")


def test_mosm_with_the_iterative_selector_trains_like_jax(jax_sorted):
    """mogptk_tpu_torch.MOSM(DataSet, Q=2, inference=Iterative(...)) with the
    JAX model's raws and draws trains three Adam steps as the JAX package's
    gpr.train does, then predicts, scores itself and reads its LML."""
    out = jax_sorted
    jm = out["model"]
    top = _port_top(jm)
    losses, _ = top.train(method="Adam", lr=LR, iters=STEPS)
    assert losses[0] == losses[1]          # the loss before training, then each step's
    _check_steps(losses[1:], [_trained_raws(top.gpr)], out, "MOSM.train")
    Xp, Mu, Lo, Up = top.predict()
    for j in range(3):
        assert np.all(np.isfinite(Mu[j])) and np.all(Lo[j] < Mu[j]) and np.all(Mu[j] < Up[j])
    assert np.isfinite(top.error("MAE"))
    assert np.isfinite(top.log_marginal_likelihood())
    assert np.isfinite(top.log_marginal_likelihood(readout=False))


@pytest.fixture(scope="module")
def port_readout(jax_sorted_extras):
    jm = jax_sorted_extras["model"]
    tm = _port_gpr(jm, _top(T).gpr.kernel)
    kw = dict(READOUT, probes=_readout_probes(tm.X.shape[0]))
    return tm.readout_terms(**kw), float(tm.log_marginal_likelihood_readout(**kw))


@pytest.mark.parametrize("term", ["logdetP", "trlog", "quad", "value"])
def test_readout_terms_match_jax(jax_sorted_extras, port_readout, term):
    """log_marginal_likelihood_readout (rank-12 pivots, two seeds of six
    probes, restarted CG): the exact log det P, the Lanczos quadrature of
    tr log(P⁻¹K), the quadratic term and the value, each held separately so
    a mismatch names its half; atol 1e-10 of |value|."""
    out = jax_sorted_extras
    terms, value = port_readout
    np.testing.assert_allclose(float(terms[term]), out["readout"][term], rtol=RTOL,
                               atol=1e-10 * abs(out["readout"]["value"]))
    if term == "value":
        assert value == float(terms["value"])


def test_readout_per_probe_quadratures_and_alpha(jax_sorted_extras, port_readout):
    """The readout's `trlog_probes` (seeds × probes) average, seed by seed,
    to its `trlog`; its `alpha` solves (K + σ²)α = y to the CG's stopping
    residual (60 iterations, tol 1e-10: relative residual under 1e-8) and
    gives its `quad`."""
    terms, _ = port_readout
    P, S = READOUT["num_probes"], READOUT["seeds"]
    per = terms["trlog_probes"].numpy()
    assert per.shape == (S * P,)
    np.testing.assert_allclose(per.reshape(S, P).mean(axis=1).mean(), float(terms["trlog"]),
                               rtol=1e-12)
    jm = jax_sorted_extras["model"]
    tm = _port_gpr(jm, _top(T).gpr.kernel)
    y = tm._residual_y()
    with torch.no_grad():
        Kt = tm.kernel.K(tm.X) + torch.diag(tm._noise_diag())
    alpha = terms["alpha"]
    assert alpha.shape == y.shape
    rel = float(torch.linalg.norm(y - Kt @ alpha) / torch.linalg.norm(y))
    assert rel < 1e-8, rel
    np.testing.assert_allclose(float(-0.5 * torch.sum(y * alpha)), float(terms["quad"]),
                               rtol=1e-12)


def test_predict_f_in_blocks_matches_jax(jax_sorted_extras):
    """predict_f over 24 query points in blocks of 7: mean and variance,
    atol 1e-10 of each output's scale."""
    out = jax_sorted_extras
    jm = out["model"]
    tm = _port_gpr(jm, _top(T).gpr.kernel)
    mu, var = tm.predict_f(out["Xq"], block_size=7)
    _close(mu, out["predict"][0], "mean", atol_rel=1e-10)
    _close(var, out["predict"][1], "variance", atol_rel=1e-10)


def test_predict_f_full_matches_jax(jax_sorted_extras):
    """predict_f(full=True) over the same 24 query points: the mean and the
    (24, 24) posterior covariance, atol 1e-10 of the mean's scale and 1e-9
    of the covariance's (Kss − Kfsᵀ·CG(Kfs): the rounding of the two CG
    runs, 24 columns wide, differs by ~2e-10 of the scale in entries near
    0); its diagonal is the blocked variance."""
    out = jax_sorted_extras
    tm = _port_gpr(out["model"], _top(T).gpr.kernel)
    mu, cov = tm.predict_f(out["Xq"], full=True, block_size=7)
    assert cov.shape == (24, 24)
    _close(mu, out["predict_full"][0], "mean", atol_rel=1e-10)
    _close(cov, out["predict_full"][1], "covariance", atol_rel=1e-9)
    _close(torch.diagonal(cov), out["predict"][1][:, 0], "diagonal", atol_rel=1e-9)


def test_cg_diagnostics_match_jax(jax_sorted_extras):
    """The residuals after 6 CG iterations, rtol 1e-7."""
    out = jax_sorted_extras
    jm = out["model"]
    tm = _port_gpr(jm, _top(T).gpr.kernel)
    tm.max_cg_iters = 6
    np.testing.assert_allclose(tm.cg_diagnostics(), out["diag"], rtol=RTOL)


# -- (h) what still raises ------------------------------------------------------------

def test_unported_configurations_raise():
    xs, ys, _, _ = _data()
    _, X, Y = tgpr.merge_data(xs, ys)
    k = tgpr.MultiOutputSpectralMixtureKernel(2, output_dims=3)
    with pytest.raises(ValueError, match="use Exact for other kernels"):
        tgpr.ExactIterative(tgpr.SpectralKernel(), X[:, 1:], Y)
    m = tgpr.ExactIterative(k, X, Y, **SETTINGS)
    with pytest.raises(NotImplementedError, match="item 10"):
        m.use_ring(object())
    m._row_mask = torch.ones(X.shape[0], dtype=torch.float64)
    for call in (m.loss, m.cg_diagnostics, m.log_marginal_likelihood_readout,
                 lambda: m.predict_f(X[:3])):
        with pytest.raises(NotImplementedError, match="item 10"):
            call()
    saved = tgpr.config._dtype
    tgpr.config.dtype = torch.bfloat16
    try:
        with pytest.raises(NotImplementedError, match="sub-float32"):
            tgpr.ExactIterative(k, X, Y, **SETTINGS)
    finally:
        tgpr.config._dtype = saved
