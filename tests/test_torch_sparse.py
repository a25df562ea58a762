"""The sparse and variational models in mogptk_tpu_torch against mogptk_tpu:
Titsias, Snelson, SparseHensman, Hensman and OpperArchambeau with the MOSM
kernel and the Gaussian likelihood; the objective, every raw parameter's
gradient (the inducing points' included), one Adam step and predict_f with
and without `full`; the inducing-point initializations, the user-API
selectors and the jitter ladder.

Both packages build each model on the same numpy data in float64 on the CPU;
the inducing points come from "grid" or as explicit arrays, and the JAX
model's raws are carried across with load_raw_state. The JAX side runs its
Grams through the plain jnp reference (the Pallas backward's input half is
held against the port in tests/test_torch_gram_bwd.py); the port runs its
kernels' plain twins on CPU tensors. rtol 1e-7 (XLA-CPU's exp is only ~1e-8
accurate even in float64); each atol is stated relative to the output's
scale. The JAX answers are computed once per run.
"""
import numpy as np
import pytest
import jax
import optax
import torch

import mogptk_tpu as jmogptk
import mogptk_tpu.gpr as jgpr
import mogptk_tpu.ops.linalg as jla
import mogptk_tpu_torch as tmogptk
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.ops import linalg as tla

import jax_reference

RTOL = 1e-7
LR = 0.01


@pytest.fixture(scope="module", autouse=True)
def cpu_float64():
    """The port runs on the card unless asked: these tests ask for the CPU,
    in float64, on one thread."""
    cfg = tgpr.config
    saved = (cfg.device, cfg._dtype, cfg.jitter_ladder, torch.get_num_threads())
    cfg.device = "cpu"
    tgpr.use_double_precision()
    torch.set_num_threads(1)
    yield
    cfg.device, cfg._dtype, cfg.jitter_ladder, threads = saved
    torch.set_num_threads(threads)


def _data(D=1, counts=(30, 25, 20)):
    """Channel-sorted X (channel ID in column 0), Y, and MOSM means and
    variances, from a seed."""
    rng = np.random.RandomState(2 + D)
    O = len(counts)
    xs = [np.sort(rng.rand(n, D) * 6, axis=0) for n in counts]
    ys = [np.sin(1.3 * x[:, :1] + i) + 0.1 * x[:, -1:] + 0.05 * rng.randn(len(x), 1)
          for i, x in enumerate(xs)]
    X = np.concatenate([np.concatenate([np.full((len(x), 1), float(i)), x], axis=1)
                        for i, x in enumerate(xs)])
    rk = np.random.RandomState(1)
    return X, np.concatenate(ys), 0.05 + 0.3 * rk.rand(O, 2, D), 0.2 + 0.3 * rk.rand(O, 2, D)


def _explicit_Z():
    """5 inducing points per channel, off the data's grid."""
    rng = np.random.RandomState(9)
    return np.concatenate([np.concatenate([np.full((5, 1), float(i)),
                                           np.sort(rng.rand(5, 1) * 6, axis=0)], axis=1)
                           for i in range(3)])


# name: (D, channel counts, constructor(gpr, kernel, X, Y)); Snelson is the
# D = 2 case (a 2 x 2 grid of inducing points per channel)
MODELS = {
    "titsias": (1, (30, 25, 20),
                lambda g, k, X, Y: g.Titsias(k, X, Y, Z=6, Z_init="grid", variance=0.1)),
    "snelson_d2": (2, (24, 20),
                   lambda g, k, X, Y: g.Snelson(k, X, Y, Z=[4, 4], variance=[0.1, 0.2])),
    "sparse_hensman": (1, (30, 25, 20),
                       lambda g, k, X, Y: g.SparseHensman(k, X, Y, Z=_explicit_Z())),
    "hensman": (1, (20, 16, 12), lambda g, k, X, Y: g.Hensman(k, X, Y)),
    "opper_archambeau": (1, (20, 16, 12), lambda g, k, X, Y: g.OpperArchambeau(k, X, Y)),
}


def _build(gpr, name):
    """The model, with variational parameters away from their initial
    values (where q(u) = p(u), the inducing points' gradient vanishes)."""
    D, counts, make = MODELS[name]
    X, Y, mean, var = _data(D, counts)
    k = gpr.MultiOutputSpectralMixtureKernel(2, output_dims=len(counts), input_dims=D)
    k.mean.assign(mean)
    k.variance.assign(var)
    m = make(gpr, k, X, Y)
    rng = np.random.RandomState(6)
    if hasattr(m, "q_sqrt"):
        n = m.q_mu.shape[0]
        m.q_mu.assign(0.3 * rng.randn(n, 1))
        m.q_sqrt.assign(np.eye(n) + 0.1 * np.tril(rng.randn(n, n), -1))
    if hasattr(m, "q_lambda"):
        n = m.q_nu.shape[0]
        m.q_nu.assign(0.1 * rng.randn(n, 1))
        m.q_lambda.assign(0.5 + rng.rand(n, 1))
    return m, X


def _jax_answers(name):
    """The objective and gradient, the raws after one optax Adam step (the
    update of gpr/training.py), and predict_f at every third training point
    with and without full: numpy only (jax_reference.once_per_run)."""
    jm, X = _build(jgpr, name)
    train, fixed = jm._split_raws()
    value_and_grad = jax.value_and_grad(jm.make_loss_fn())
    opt = optax.adam(LR)

    def answers(train, fixed, Xq):
        loss, grads = value_and_grad(train, fixed)
        upd, _ = opt.update(grads, opt.init(train), train)
        with jm.bind(jm._merge_raws(train, fixed)):
            pred = jm.predict_f(Xq) + jm.predict_f(Xq, full=True)
        return loss, grads, optax.apply_updates(train, upd), pred

    Xq = X[::3]
    loss, grads, stepped, pred = jax_reference.jit(answers)(train, fixed, Xq)
    return dict(model=jax_reference.raws_and_names(jm), Xq=Xq, loss=float(loss),
                grads=[np.asarray(a) for a in grads], stepped=[np.asarray(a) for a in stepped],
                pred=[np.asarray(a) for a in pred])


@pytest.fixture(scope="module", params=list(MODELS))
def sparse(request, tmp_path_factory):
    """(name, the JAX answers, the port's model with the JAX raws)."""
    name = request.param
    ans = jax_reference.once_per_run(tmp_path_factory, "sparse_jax_" + name,
                                     lambda: _jax_answers(name))
    return name, ans


def _port(name, ans):
    tm, _ = _build(tgpr, name)
    tgpr.load_raw_state(tm, ans["model"]["raws"], names=ans["model"]["names"])
    return tm


def _close(got, ref, what, atol_rel=1e-10):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol_rel * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def test_loss_and_gradients_match_jax(sparse):
    """loss() and every trainable raw's .grad, the inducing points'
    included: rtol 1e-7, atol 1e-9 of the largest gradient entry (entries
    that cancel to ~0 carry the summation noise of the largest)."""
    name, ans = sparse
    tm = _port(name, ans)
    loss = tm.loss()
    loss.backward()
    _close(loss, ans["loss"], "loss")
    raws = tm.trainable_raws()
    assert len(raws) == len(ans["grads"])
    scale = max(float(np.abs(g).max()) for g in ans["grads"])
    for pname, r, g in zip(tgpr.parameter_names(tm), raws, ans["grads"]):
        np.testing.assert_allclose(r.grad.numpy(), g, rtol=RTOL, atol=1e-9 * scale,
                                   err_msg=pname)
    if hasattr(tm, "Z") and tm.Z.train:
        assert float(tm.Z.raw.grad[:, 1:].abs().max()) > 0
        assert float(tm.Z.raw.grad[:, 0].abs().max()) == 0.0


def test_one_adam_step_matches_jax(sparse):
    """One gpr.train Adam step against optax.adam on the same gradient: every
    trainable raw, rtol 1e-7, atol 1e-9 of its scale; the inducing points'
    channel column is left exactly as it was."""
    name, ans = sparse
    tm = _port(name, ans)
    Z0 = tm.Z.raw.detach().clone() if hasattr(tm, "Z") else None
    tgpr.train(tm, method="Adam", lr=LR, iters=1)
    for pname, r, ref in zip(tgpr.parameter_names(tm), tm.trainable_raws(), ans["stepped"]):
        _close(r, ref, pname, atol_rel=1e-9)
    if Z0 is not None:
        assert torch.equal(tm.Z.raw[:, 0], Z0[:, 0])


def test_predict_f_matches_jax(sparse):
    """predict_f's mean and variance, and with full=True the mean and the
    (M, M) covariance: atol 1e-9 of each output's scale (Hensman's Kuu is
    the Gram of the data points themselves, conditioned ~1e6, so its solves
    carry κ·eps ~ 1e-10 of the scale); the covariance's diagonal is the
    variance."""
    name, ans = sparse
    tm = _port(name, ans)
    mu, var = tm.predict_f(ans["Xq"])
    mu_f, cov = tm.predict_f(ans["Xq"], full=True)
    for got, ref, what in zip((mu, var, mu_f, cov), ans["pred"], ("mu", "var", "mu full", "cov")):
        assert got.shape == ref.shape, what
        _close(got, ref, what, atol_rel=1e-9)
    torch.testing.assert_close(torch.diagonal(cov), var[:, 0], rtol=1e-10, atol=1e-12)


def test_inducing_point_initializations():
    """'grid' is the JAX package's grid; 'random' (Halton) and 'density'
    (KDE) draw from the package's numpy generator, so a seed reproduces
    them; channel IDs in column 0; explicit points pass through."""
    X, _, _, _ = _data(1)
    grid = tgpr.init_inducing_points([3, 4, 5], X, method="grid", output_dims=3)
    ref = np.asarray(jgpr.model.init_inducing_points([3, 4, 5], X, method="grid", output_dims=3))
    np.testing.assert_array_equal(grid, ref)
    for method in ("random", "density"):
        draws = []
        for _ in range(2):
            tgpr.set_seed(5)
            draws.append(tgpr.init_inducing_points(4, X, method=method, output_dims=3))
        np.testing.assert_array_equal(draws[0], draws[1])
        assert draws[0].shape == (12, 2)
        np.testing.assert_array_equal(draws[0][:, 0], np.repeat(np.arange(3.0), 4))
    Z = _explicit_Z()
    np.testing.assert_array_equal(tgpr.init_inducing_points(Z, X, output_dims=3), Z)
    with pytest.raises(ValueError, match="n\\^2"):
        tgpr.init_inducing_points(5, np.random.rand(10, 2), method="grid")


SELECTORS = {
    "Titsias": dict(inducing_points=4, init_inducing_points="grid"),
    "Snelson": dict(inducing_points=[3, 4, 5]),
    "Hensman": dict(inducing_points=4),
    "Hensman (no points)": dict(),
    "OpperArchambeau": dict(),
}


@pytest.mark.parametrize("selector", list(SELECTORS))
def test_user_api_selectors_build_the_jax_models(selector):
    """mogptk.MOSM(dataset, inference=<selector>) builds the gpr model the
    JAX package's selector builds: the same class, parameter names and raw
    values (inducing points included, rtol 1e-12), noise, jitter and counts
    of free parameters; and the same loss and gradients (rtol 1e-7, atol
    1e-9 of the largest gradient entry)."""
    X, Y, _, _ = _data(1, (20, 16, 12))
    xs = [X[X[:, 0] == i, 1] for i in range(3)]
    ys = [Y[X[:, 0] == i, 0] for i in range(3)]
    cls = selector.split()[0]
    models = []
    for pkg in (jmogptk, tmogptk):
        pkg.gpr.set_seed(3)      # the initial parameters are drawn from it
        ds = pkg.DataSet(xs, ys)
        models.append(pkg.MOSM(ds, Q=2, inference=getattr(pkg, cls)(**SELECTORS[selector])).gpr)
    jm, tm = models
    assert type(tm).__name__ == type(jm).__name__
    assert tgpr.parameter_names(tm) == [p.name for p in jm.parameters()]
    for name, r, ref in zip(tgpr.parameter_names(tm), tm.raw_state(),
                            (np.asarray(r) for r in jm.raw_state())):
        np.testing.assert_allclose(r.numpy(), ref, rtol=1e-12, atol=1e-300, err_msg=name)
    assert tm.jitter == jm.jitter
    assert ([p.num_parameters for _, p in tm.gp_parameters()]
            == [p.num_parameters for p in jm.parameters()])
    loss, grads = jax_reference.jit(jax.value_and_grad(jm.make_loss_fn()))(*jm._split_raws())
    tl = tm.loss()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(loss), rtol=RTOL)
    scale = max(float(np.abs(g).max()) for g in grads)
    for r, g in zip(tm.trainable_raws(), grads):
        np.testing.assert_allclose(r.grad.numpy(), np.asarray(g), rtol=RTOL, atol=1e-9 * scale)


def test_jitter_ladder_matches_jax():
    """A matrix whose smallest eigenvalue is −2e-6 of its mean diagonal: the
    plain factor is NaN, rungs 1 and 2 (1e-7 and 1e-6 of the mean diagonal)
    fail too, rung 3 (1e-5) succeeds; the factor and the gradient of Σ L∘G
    through it (from the final factor only) match the JAX package's
    _ladder_cholesky: rtol 1e-7, atol 1e-10 of each scale. With the ladder
    off the factor is NaN."""
    rng = np.random.RandomState(4)
    B = rng.randn(12, 3)
    K = B @ B.T
    K -= 2e-6 * np.mean(np.diag(K)) * np.eye(12)
    G = rng.randn(12, 12)

    def jax_fn(K, G):
        L = jla.jittered_cholesky(K, None, ladder=4)
        return L, jax.grad(lambda k: (jla.jittered_cholesky(k, None, ladder=4) * G).sum())(K)

    L_ref, dK_ref = map(np.asarray, jax_reference.jit(jax_fn)(K, G))
    Kt = torch.as_tensor(K).requires_grad_()
    before = tla.jittered_cholesky.rungs
    L = tla.jittered_cholesky(Kt, None, ladder=4)
    assert tla.jittered_cholesky.rungs - before == 3
    (dK,) = torch.autograd.grad((L * torch.as_tensor(G)).sum(), Kt)
    assert bool(torch.isfinite(L).all())
    _close(L, L_ref, "factor")
    _close(dK, dK_ref, "dK")
    assert bool(torch.isnan(tla.jittered_cholesky(torch.as_tensor(K), None, ladder=0)).any())
    tgpr.use_jitter_ladder(2)
    assert tgpr.config.jitter_ladder == 2
