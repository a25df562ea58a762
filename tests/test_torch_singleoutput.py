"""The single-output kernels, the compositors ARD and ChangePoints, the mean
functions, the SM model and init_parameters('SM') of mogptk_tpu_torch
against mogptk_tpu, on the CPU in float64.

Both packages build each kernel, mean and model on the same numpy data; the
JAX side's raw parameters are carried across with load_raw_state, which
checks the parameter names, so a Parameter registered out of the JAX
package's order fails here. Each test loops over its cases and names the
failing one. The JAX answers are computed once per test run
(tests/jax_reference.py), the optax steps under one jit without XLA's
backend optimizations. rtol 1e-7 (XLA-CPU's exp is only ~1e-8 accurate even
in float64); each atol is 1e-12 of the output's scale.
"""
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import mogptk_tpu as J
import mogptk_tpu.gpr as jgpr
import mogptk_tpu.model as jmodel
import mogptk_tpu_torch as T
import mogptk_tpu_torch.gpr as tgpr

import jax_reference

RTOL = 1e-7
LR, STEPS = 0.01, 2


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


def _mismatches(label, got, want, out):
    """Append to `out` the label of each array of `got` off its twin in
    `want` (rtol 1e-7, atol 1e-12 of the array's scale)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        if a.shape != b.shape:
            out.append("%s[%d]: shape %s != %s" % (label, i, a.shape, b.shape))
        elif not np.allclose(a, b, rtol=RTOL, atol=1e-12 * max(np.abs(b).max(initial=0.0), 1.0)):
            out.append("%s[%d]: max|diff| %.3e" % (label, i, np.abs(a - b).max()))
    if len(got) != len(want):
        out.append("%s: %d arrays != %d" % (label, len(got), len(want)))


# -- 1. every single-output kernel and compositor ------------------------------

def _kernels(g):
    """(label, kernel, D): tests/test_kernels.py's single-output list, ARD,
    and D = 2 cases of the GEMM quadratic form with cross-lengthscales, the
    unrolled one, the rank-1 contractions and the mixture's sum, in package
    g (jgpr or tgpr)."""
    if g is jgpr:
        phi = lambda x: jnp.concatenate([x, x ** 2], axis=1)
    else:
        phi = lambda x: torch.cat([x, x ** 2], dim=1)
    cases = [
        ("White", g.WhiteKernel(), 1),
        ("Constant", g.ConstantKernel(), 1),
        ("Linear", g.LinearKernel(), 1),
        ("Polynomial", g.PolynomialKernel(2), 1),
        ("Function", g.FunctionKernel(phi), 1),
        ("Exponential", g.ExponentialKernel(), 1),
        ("SE", g.SquaredExponentialKernel(), 1),
        ("SE order=-1", g.SquaredExponentialKernel(order=-1), 1),
        ("SE order=2", g.SquaredExponentialKernel(order=2), 1),
        ("RQ", g.RationalQuadraticKernel(alpha=2.0), 1),
        ("Periodic", g.PeriodicKernel(), 1),
        ("LocallyPeriodic", g.LocallyPeriodicKernel(), 1),
        ("Cosine", g.CosineKernel(), 1),
        ("Sinc", g.SincKernel(), 1),
        ("Spectral", g.SpectralKernel(), 1),
        ("SpectralMixture", g.SpectralMixtureKernel(Q=3), 1),
        ("Matern 0.5", g.MaternKernel(nu=0.5), 1),
        ("Matern 1.5", g.MaternKernel(nu=1.5), 1),
        ("Matern 2.5", g.MaternKernel(nu=2.5), 1),
        ("SE + Cosine", g.SquaredExponentialKernel() + g.CosineKernel(), 1),
        ("SE * Cosine", g.SquaredExponentialKernel() * g.CosineKernel(), 1),
        ("Mixture", g.MixtureKernel(g.SpectralKernel(), 3), 1),
        ("ChangePoints", g.ChangePointsKernel([0.5], 1.0, g.SquaredExponentialKernel(),
                                              g.CosineKernel()), 1),
        ("ARD", g.AutomaticRelevanceDeterminationKernel(g.SquaredExponentialKernel(), 2), 2),
        ("SE order=1 D=2", g.SquaredExponentialKernel(order=1, input_dims=2), 2),
        ("LocallyPeriodic order=1 D=2", g.LocallyPeriodicKernel(order=1, input_dims=2), 2),
        ("Sinc D=2", g.SincKernel(input_dims=2), 2),
        ("SpectralMixture D=2", g.SpectralMixtureKernel(Q=2, input_dims=2), 2),
    ]
    return cases


def _kernel_data():
    rng = np.random.RandomState(3)
    X1, X2 = rng.rand(9, 2) * 2.0, rng.rand(5, 2) * 2.0
    X1[4] = X1[1]          # a repeated point: τ = 0 off the diagonal too
    return X1, X2, rng.randn(9, 9), rng.randn(9, 5), rng.randn(9)


def _jax_kernels():
    """Each case's K(X1), K(X1, X2), K_diag(X1) and the gradient of
    Σ K⊙G1 + Σ K12⊙G2 + Σ Kdiag·g3 with respect to the raws, at constrained
    values drawn in (0.5, 1.5) (the change points inside the data), every
    case under one jit."""
    X1, X2, G1, G2, g3 = _kernel_data()
    rng = np.random.RandomState(4)
    cases = _kernels(jgpr)
    for _, k, _ in cases:
        for p in k.parameters():
            shape = np.shape(p())
            if p.name.endswith("locations"):
                p.assign(np.sort(0.5 + rng.rand(*shape)))
            else:
                p.assign(0.5 + rng.rand(*shape))

    def one(k, D, raws):
        x1, x2 = X1[:, :D], X2[:, :D]

        def f(raws):
            with k.bind(raws):
                K, K12, Kd = k.K(x1), k.K(x1, x2), k.K_diag(x1)
            return jnp.sum(K * G1) + jnp.sum(K12 * G2) + jnp.sum(Kd * g3), (K, K12, Kd)

        (_, vals), grads = jax.value_and_grad(f, has_aux=True)(raws)
        return vals, grads

    every = jax_reference.jit(lambda raws: [one(k, D, r) for (_, k, D), r in zip(cases, raws)])
    answers = every([[jnp.asarray(r) for r in k.raw_state()] for _, k, _ in cases])
    return {label: dict(vals=[np.asarray(v) for v in vals], grads=[np.asarray(v) for v in grads],
                        **jax_reference.raws_and_names(k))
            for (label, k, _), (vals, grads) in zip(cases, answers)}


def test_kernels_match_jax(tmp_path_factory):
    """K(X), K(X1, X2), K_diag and the raws' gradient of Σ K⊙G for every
    kernel of tests/test_kernels.py's list, ARD and the D = 2 cases."""
    j = jax_reference.once_per_run(tmp_path_factory, "singleoutput_jax_kernels", _jax_kernels)
    X1, X2, G1, G2, g3 = (torch.as_tensor(a) for a in _kernel_data())
    bad = []
    for label, k, D in _kernels(tgpr):
        ref = j[label]
        try:
            tgpr.load_raw_state(k, ref["raws"], names=ref["names"])
        except ValueError as e:
            bad.append("%s: %s" % (label, e))
            continue
        raws = [p.raw for _, p in k.gp_parameters()]
        x1, x2 = X1[:, :D], X2[:, :D]
        K, K12, Kd = k.K(x1), k.K(x1, x2), k.K_diag(x1)
        loss = torch.sum(K * G1) + torch.sum(K12 * G2) + torch.sum(Kd * g3)
        grads = torch.autograd.grad(loss, raws, allow_unused=True)
        grads = [torch.zeros_like(r) if g is None else g for r, g in zip(raws, grads)]
        _mismatches(label + " values", [v.detach() for v in (K, K12, Kd)], ref["vals"], bad)
        _mismatches(label + " gradient", grads, ref["grads"], bad)
    assert not bad, "\n".join(bad)


# -- 2. the mean functions -------------------------------------------------------

def _log_mean(g):
    """A mean not finite off its channel's domain: m(x) = b·log(x)."""
    lib = jnp if g is jgpr else torch

    class LogMean(g.Mean):
        def __init__(self):
            super().__init__()
            self.bias = g.Parameter(1.3)

        def mean(self, X):
            return self.bias() * lib.log(X[:, :1])

    return LogMean()


def _means(g):
    """(label, mean, X): ConstantMean, LinearMean on two input dims, and a
    MultiOutputMean whose channel-1 sub-mean is NaN on channel 0's inputs."""
    rng = np.random.RandomState(6)
    X = rng.randn(7, 2)
    Xmo = np.array([[0, -1.0], [1, 0.5], [0, -2.0], [1, 2.0], [0, -0.5], [1, 1.5]])
    lin = g.LinearMean(input_dims=2)
    lin.slope.assign([0.7, -0.4])
    lin.bias.assign(0.2)
    mo = g.MultiOutputMean(g.LinearMean(), _log_mean(g))
    mo.means[0].slope.assign([0.3])
    return [("Constant", g.ConstantMean(), X), ("Linear", lin, X), ("MultiOutput", mo, Xmo)]


def _jax_means():
    out = {}
    for label, m, X in _means(jgpr):
        G = np.random.RandomState(7).randn(X.shape[0], 1)
        raws = [jnp.asarray(r) for r in m.raw_state()]

        def f(raws):
            with m.bind(raws):
                mu = m(X)
            return jnp.sum(mu * G), mu

        (_, mu), grads = jax.value_and_grad(f, has_aux=True)(raws)
        out[label] = dict(vals=[np.asarray(mu)], grads=[np.asarray(v) for v in grads],
                          **jax_reference.raws_and_names(m))
    return out


def test_means_match_jax(tmp_path_factory):
    """Each mean's value and the raws' gradient of Σ m(X)⊙G; the
    MultiOutputMean's are finite though its log sub-mean is NaN on the
    other channel's inputs (the safe-input one-hot sum)."""
    j = jax_reference.once_per_run(tmp_path_factory, "singleoutput_jax_means", _jax_means)
    bad = []
    for label, m, X in _means(tgpr):
        ref = j[label]
        tgpr.load_raw_state(m, ref["raws"], names=ref["names"])
        G = torch.as_tensor(np.random.RandomState(7).randn(X.shape[0], 1))
        raws = [p.raw for _, p in m.gp_parameters()]
        mu = m(X)
        grads = torch.autograd.grad(torch.sum(mu * G), raws)
        if not (bool(torch.isfinite(mu).all()) and all(bool(torch.isfinite(g).all())
                                                       for g in grads)):
            bad.append("%s: not finite" % label)
        _mismatches(label + " value", [mu.detach()], ref["vals"], bad)
        _mismatches(label + " gradient", grads, ref["grads"], bad)
    with pytest.raises(ValueError, match="must derive"):
        tgpr.Exact(tgpr.SquaredExponentialKernel(), np.ones((3, 1)), np.ones(3), mean=object())
    assert not bad, "\n".join(bad)


# -- 3. the models with a mean -----------------------------------------------------

def _mean_data():
    """2 channels, 14 and 9 points, channel-sorted (merge_data's layout)."""
    rng = np.random.RandomState(8)
    xs = [np.sort(rng.rand(n, 1) * 4, axis=0) for n in (14, 9)]
    ys = [1.5 + 0.8 * x + np.sin(2 * x + i) + 0.05 * rng.randn(*x.shape) for i, x in enumerate(xs)]
    X = np.concatenate([np.hstack([np.full((len(x), 1), i), x]) for i, x in enumerate(xs)])
    Y = np.concatenate(ys)[:, 0]
    Xq = np.array([[0, 0.3], [0, 2.2], [1, 1.1], [1, 4.5], [0, 5.0]])
    return X, Y, Xq


def _mean_models(g):
    """(label, model): Exact, Titsias and OpperArchambeau over an
    independent SE/Periodic kernel with a MultiOutputMean of two linear
    means."""
    X, Y, _ = _mean_data()

    def parts():
        k = g.IndependentMultiOutputKernel(g.SquaredExponentialKernel(), g.PeriodicKernel(),
                                           output_dims=2)
        return k, g.MultiOutputMean(g.LinearMean(), g.LinearMean())

    kw = {} if g is jgpr else dict(device="cpu")
    k, m = parts()
    exact = g.Exact(k, X, Y, variance=[0.1, 0.2], mean=m, **kw)
    k, m = parts()
    tits = g.Titsias(k, X, Y, Z=4, variance=0.1, mean=m, **kw)
    k, m = parts()
    oa = g.OpperArchambeau(k, X, Y, mean=m, **kw)
    return [("Exact", exact), ("Titsias", tits), ("OpperArchambeau", oa)]


def _perturbed(model):
    """The model's raws plus seeded noise of 0.2 (the channel column of the
    inducing points left as it is)."""
    rng = np.random.RandomState(9)
    out = []
    for p, r in zip(model.parameters(), model.raw_state()):
        r = np.array(r, dtype=np.float64)
        noise = 0.2 * rng.randn(*r.shape)
        if p.name == "induction_points":
            noise[:, 0] = 0.0
        out.append(r + noise)
    return out


def _jax_mean_models():
    """Each model's predict_f at the perturbed raws, and the Exact model's
    loss and gradient, under one jit."""
    _, _, Xq = _mean_data()
    models = _mean_models(jgpr)
    raws = [_perturbed(jm) for _, jm in models]

    def every(raws):
        out = []
        for (label, jm), r in zip(models, raws):
            with jm.bind(r):
                out.append(jm.predict_f(Xq))
        jm = models[0][1]
        train = [a for a, m in zip(raws[0], jm.train_mask()) if m]
        fixed = [a for a, m in zip(raws[0], jm.train_mask()) if not m]
        return out, jax.value_and_grad(jm.make_loss_fn())(train, fixed)

    predicts, (loss, grads) = jax_reference.jit(every)([[jnp.asarray(a) for a in r] for r in raws])
    out = {label: dict(raws=r, names=[p.name for p in jm.parameters()],
                       predict=[np.asarray(a) for a in p])
           for (label, jm), r, p in zip(models, raws, predicts)}
    out["Exact"].update(loss=float(loss), grads=[np.asarray(a) for a in grads])
    return out


def test_models_with_a_mean_match_jax(tmp_path_factory):
    """gpr.Exact with a mean: the loss −LML, its gradient (the mean's raws
    included) and predict_f; Titsias and OpperArchambeau with a mean:
    predict_f (OpperArchambeau's qf_mu is the zero-mean part's, the JAX
    package's repair of the reference)."""
    j = jax_reference.once_per_run(tmp_path_factory, "singleoutput_jax_mean_models",
                                   _jax_mean_models)
    _, _, Xq = _mean_data()
    bad = []
    for label, tm in _mean_models(tgpr):
        ref = j[label]
        tgpr.load_raw_state(tm, ref["raws"], names=ref["names"])
        mu, var = tm.predict_f(Xq)
        _mismatches(label + " predict_f", [mu, var], ref["predict"], bad)
        if label == "Exact":
            loss = tm.loss()
            grads = torch.autograd.grad(loss, tm.trainable_raws())
            _mismatches("Exact loss", [loss.detach()], [ref["loss"]], bad)
            _mismatches("Exact gradient", grads, ref["grads"], bad)
            if not all(bool(g.abs().max() > 0) for g in grads[-4:]):
                bad.append("Exact: a mean raw got no gradient")
    assert not bad, "\n".join(bad)


# -- 4. the SM model -----------------------------------------------------------------

def _dataset(pkg, channels=2):
    """`channels` channels of 30 points, 20% removed by the package's seeded
    Generator after set_seed(5)."""
    pkg.set_seed(5)
    rng = np.random.RandomState(0)
    t = np.linspace(0.0, 10.0, 30)
    ds = pkg.DataSet([t] * channels,
                     [np.sin(1.3 * t + i) + 0.3 * np.sin(3.1 * t) + 0.1 * rng.randn(30)
                      for i in range(channels)], names=["ch%d" % i for i in range(channels)])
    for ch in ds:
        ch.remove_randomly(pct=0.2)
    return ds


def _params(pkg, model):
    if pkg is J:
        return [np.asarray(p()) for p in model.gpr.parameters()]
    return [p.numpy() for p in model.parameters()]


def _sm_flow(pkg):
    """SM(ds, Q=2): its parameters after construction and after
    init_parameters('LS'), then, on a second model built after set_seed
    again, after init_parameters('IPS')."""
    model = pkg.SM(_dataset(pkg), Q=2)
    out = dict(init=_params(pkg, model))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.init_parameters("LS")
    out["ls"] = _params(pkg, model)
    ips = pkg.SM(_dataset(pkg), Q=2)
    ips.init_parameters("IPS")
    out["ips"] = _params(pkg, ips)
    return out, model


def _jax_sm():
    """The JAX SM flow, its loss and gradient at the LS initialization, two
    optax Adam steps under one jit, and predict after them."""
    out, model = _sm_flow(J)
    jm = model.gpr
    out.update(jax_reference.raws_and_names(jm))
    train, fixed = jm._split_raws()
    vg = jax_reference.jit(jax.value_and_grad(jm.make_loss_fn()))
    out["loss"], out["grads"] = (lambda v, g: (float(v), [np.asarray(a) for a in g]))(
        *vg(train, fixed))
    opt = optax.adam(LR)
    state = opt.init(train)
    out["losses"] = []
    for _ in range(STEPS):
        v, g = vg(train, fixed)
        out["losses"].append(float(v))
        upd, state = opt.update(g, state, train)
        train = optax.apply_updates(train, upd)
    out["trained"] = [np.asarray(a) for a in train]
    jm.set_train_raws(train)
    _, mu, lo, up = model.predict()
    out["predict"] = [np.asarray(a) for a in mu + lo + up]
    return out


def test_sm_model_matches_jax(tmp_path_factory):
    """mogptk.SM(ds, Q=2): the constructor's draws and Nyquist bound, the
    LS and IPS initializations, the loss and gradient at LS, two Adam steps
    through Model.train and predict, as the JAX package's; then the quick
    start's error, save and LoadModel."""
    j = jax_reference.once_per_run(tmp_path_factory, "singleoutput_jax_sm", _jax_sm)
    t, model = _sm_flow(T)
    bad = []
    for stage in ("init", "ls", "ips"):
        _mismatches("SM " + stage, t[stage], j[stage], bad)
    tgpr.load_raw_state(model, j["raws"], names=j["names"])
    loss = model.gpr.loss()
    _mismatches("SM loss", [loss.detach()], [j["loss"]], bad)
    _mismatches("SM gradient", torch.autograd.grad(loss, model.gpr.trainable_raws()),
                j["grads"], bad)
    losses, _ = model.train(method="Adam", lr=LR, iters=STEPS)
    _mismatches("SM Adam losses", [losses[1:]], [j["losses"]], bad)
    _mismatches("SM trained raws", [r.detach() for r in model.gpr.trainable_raws()],
                j["trained"], bad)
    _, mu, lo, up = model.predict()
    _mismatches("SM predict", mu + lo + up, j["predict"], bad)
    assert not bad, "\n".join(bad)
    assert np.isfinite(model.error("MAE"))
    path = str(tmp_path_factory.mktemp("sm") / "m")
    model.save(path)
    again = T.LoadModel(path, device="cpu")
    np.testing.assert_array_equal(again.predict()[1][0], mu[0])


# -- 5. init_parameters('SM') of the multi-output models ---------------------------

def _sm_init(pkg):
    """MOSM(ds, Q=2).init_parameters('SM', iters=3) and CONV(ds, Q=2)'s
    default method ('SM') with iters=3, on one channel (each channel costs
    the JAX package a BNSE and an SM fit, each compiled anew): their
    parameters after."""
    out = {}
    for name, build in (("MOSM", lambda ds: pkg.MOSM(ds, Q=2)),
                        ("CONV", lambda ds: pkg.CONV(ds, Q=2))):
        model = build(_dataset(pkg, channels=1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if name == "MOSM":
                model.init_parameters("SM", iters=3)
            else:
                model.init_parameters(iters=3)
        out[name] = _params(pkg, model)
    return out


def test_sm_initialization_matches_jax(tmp_path_factory):
    """Data.get_sm_estimation (an SM model pre-fitted by BNSE and Adam on
    each channel) behind MOSM's init_parameters('SM') and CONV's default
    init_parameters(): the same parameters as the JAX package's, finite."""
    j = jax_reference.once_per_run(tmp_path_factory, "singleoutput_jax_sm_init",
                                   lambda: _sm_init(J))
    t = _sm_init(T)
    bad = []
    for name in ("MOSM", "CONV"):
        if not all(np.all(np.isfinite(p)) for p in t[name]):
            bad.append("%s: not finite" % name)
        _mismatches(name + " after init_parameters('SM')", t[name], j[name], bad)
    assert not bad, "\n".join(bad)


# -- 6. the independent kernel's block-diagonal Gram ---------------------------------

def test_independent_k_sorted_equals_masked_k_mo():
    """IndependentMultiOutputKernel.K_sorted on channel-sorted X equals the
    masked K_mo over the whole N × N, with exact zeros off the blocks, and so
    does its gradient, on ragged, single-point and empty channels; a
    WhiteKernel subkernel keeps its noise block."""
    rng = np.random.RandomState(10)
    bad = []
    for counts in ((5, 1, 7), (1, 1, 3), (4, 0, 2)):
        k = tgpr.IndependentMultiOutputKernel(
            tgpr.SpectralMixtureKernel(Q=2), tgpr.WhiteKernel(), tgpr.MaternKernel(nu=1.5),
            output_dims=3)
        with torch.no_grad():
            for r in k.trainable_raws():
                r.add_(0.3 * torch.as_tensor(rng.randn(*r.shape)))
        c = np.repeat(np.arange(3), counts)
        X = torch.as_tensor(np.stack([c, rng.rand(len(c)) * 3], axis=1))
        G = torch.as_tensor(rng.randn(len(c), len(c)))
        Ks = k.K_sorted(X, counts)
        Km = k.K(X)
        raws = k.trainable_raws()
        gs = torch.autograd.grad(torch.sum(Ks * G), raws, allow_unused=True)
        gm = torch.autograd.grad(torch.sum(Km * G), raws, allow_unused=True)
        same = torch.as_tensor(c[:, None] == c[None, :])
        if not torch.equal(Ks[~same], torch.zeros_like(Ks[~same])):
            bad.append("%s: nonzero off the blocks" % (counts,))
        _mismatches("%s K" % (counts,), [Ks.detach()], [Km.detach()], bad)
        # an empty channel's subkernel is not evaluated: no gradient, i.e. 0
        _mismatches("%s gradient" % (counts,),
                    [torch.zeros_like(r) if g is None else g for r, g in zip(raws, gs)],
                    [torch.zeros_like(r) if g is None else g for r, g in zip(raws, gm)], bad)
    assert not bad, "\n".join(bad)


# -- 7. the kernels registry and the exports -------------------------------------------

def test_registry_and_exports_name_the_jax_classes():
    """Every name of the JAX package's `kernels` registry resolves to the
    port's class of the same name; gpr exports every kernel, compositor and
    mean the JAX gpr does, and the top level the same kernels, SM and
    kernels."""
    bad = ["registry %s: %s != %s" % (name, T.kernels.get(name), cls.__name__)
           for name, cls in jmodel.kernels.items()
           if T.kernels.get(name) is None or T.kernels[name].__name__ != cls.__name__]
    for name in dir(jgpr):
        obj = getattr(jgpr, name)
        if isinstance(obj, type) and issubclass(obj, (jgpr.Kernel, jgpr.Mean)):
            if getattr(tgpr, name, None) is None:
                bad.append("gpr.%s missing" % name)
    for name in dir(J):
        obj = getattr(J, name)
        if isinstance(obj, type) and issubclass(obj, jgpr.Kernel):
            if getattr(T, name, None) is None:
                bad.append("top-level %s missing" % name)
    if T.kernels.SE is not tgpr.SquaredExponentialKernel or T.SM.__name__ != "SM":
        bad.append("kernels.SE or SM")
    assert not bad, "\n".join(bad)
